"""Autoregressive generation with a static-shape KV cache.

Counterpart of ``tpu_network_operator/models/generate.py``, on one
device or over a mesh of data x fsdp x tensor ranks (``mesh=``): each rank
then serves its rows of the batch with its shards of the parameters
(:class:`.llama.Layout`, the train step's sharded layer without the
backward), and its KV cache holds its rows and its kv-heads, as the
reference's ``cache_specs`` lays the cache out.  The seq, expert and pipe
axes replicate, as under the reference's generate.

* The KV cache is one buffer pair ``[L, B, max_len, Hkv, D]`` allocated
  once per :func:`generate` call.  Each step writes its fresh K/V rows
  into it **in place** (the reference's stated intent for its scan carry);
  :func:`forward_with_cache` returns the same dict it was given.
* Prefill (position 0, queries covering the whole filled prefix, a shape
  the flash gate takes) runs the flash kernel.  A decode step over a
  native-dtype cache at head_dim 64 or 128 runs the decode-attention
  kernel (:mod:`..ops.decode_attention`), which reads exactly the filled
  prefix of the un-sliced cache in place; its position is a device
  tensor (the cache row written by index), its length an int or, in a
  captured step, a device tensor too.  Every other step (an int8
  cache, another head_dim, several new tokens past position 0) runs the
  plain grouped-einsum attention over the static ``attn_len`` prefix.
* The eager decode loop is split into ``decode_block`` segments, each
  attending over one prefix length (the filled length rounded up to the
  block), so per-token attention work on the plain route tracks the
  generated length.
* On one CUDA device, greedy, over a native cache on the decode kernel's
  route, the decode steps after the first run as one CUDA graph replay
  each (:func:`_graph_ok`): the position and the token live in device
  buffers that the captured step reads and advances itself
  (:class:`_DecodeStep`) and kernel 7 reads its length from device
  memory, so the host launches one graph
  a token and never waits.  The graph is captured once per call, on the
  call's own cache and weights.  Every other call runs the eager loop.
* Otherwise PyTorch runs eagerly: the RoPE tables and the layers' slices
  are made once per :func:`generate` call and handed to every step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from .. import resolve_device, tracing
from ..ops import _kernels
from ..ops.attention import causal_attention
from ..ops.decode_attention import decode_attention
from ..ops.flash_attention import KERNEL_HEAD_DIMS, flash_attention
from ..ops.flash_attention import use_flash
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope_at
from ..parallel import comm
from .llama import (Layout, LlamaConfig, Params, check_no_window,
                    ffn_half, rope_tables, unbind_layers)


def _prefill_flash_ok(cfg: LlamaConfig, pos, s: int, attn_len: int) -> bool:
    """Flash for the prefill pass: only when the query block IS the whole
    filled prefix (pos 0, s == view length) and :func:`use_flash` routes
    the shape to the kernel.  On a mesh the kernel runs on this rank's
    rows and heads, so the reference's single-device rule (a Pallas call
    is opaque to its partitioner) has nothing to guard here."""
    if not (isinstance(pos, int) and pos == 0 and s == attn_len):
        return False
    return use_flash(s, s, cfg.head_dim)


def _decode_kernel_ok(cfg: LlamaConfig, s: int, quantized: bool) -> bool:
    """The decode-attention route: one new token over a native-dtype
    cache at a head_dim the kernel is built for; the same on the CPU (its
    plain version) and the card."""
    return s == 1 and not quantized and cfg.head_dim in KERNEL_HEAD_DIMS


def init_cache(cfg: LlamaConfig, batch: int, max_len: int,
               kv_dtype: str = "native", device=None,
               kv_heads: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Zeroed KV cache: k/v of [L, B, max_len, Hkv, D] on ``device``
    (``kv_heads``: this rank's kv-heads on a mesh, else ``cfg.kv_heads``).

    ``kv_dtype="int8"``: int8 values plus an f32 scale per (layer, batch,
    position, kv-head), quantized over the head dim; zeroed scales make
    unfilled rows dequantize to exact zeros."""
    dev = resolve_device(device)
    shape = (cfg.layers, batch, max_len, kv_heads or cfg.kv_heads,
             cfg.head_dim)
    if kv_dtype == "int8":
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=dev),
            "v": torch.zeros(shape, dtype=torch.int8, device=dev),
            "k_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=dev),
            "v_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=dev),
        }
    if kv_dtype != "native":
        raise ValueError(
            f"kv_dtype must be 'native' or 'int8', got {kv_dtype!r}"
        )
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
    }


def _quant_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, s, Hkv, D] -> (int8 values, f32 scale over D per row-head)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dequant(q: torch.Tensor, scale: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def _attend(cfg: LlamaConfig, pos: int, q, k, v, ck, cv,
            attn_len: Optional[int], cks, cvs):
    """Off the decode kernel's route: the new rows k/v [B, s, Hkv, D]
    written into the cache at host position ``pos``, then the attention of
    q [B, s, H, D] over it (flash for a prefill, else the grouped einsum)."""
    s = q.shape[1]
    if cks is not None:
        kq, k_sc = _quant_rows(k)
        vq, v_sc = _quant_rows(v)
        ck[:, pos:pos + s] = kq
        cv[:, pos:pos + s] = vq
        cks[:, pos:pos + s] = k_sc
        cvs[:, pos:pos + s] = v_sc
    else:
        ck[:, pos:pos + s] = k
        cv[:, pos:pos + s] = v

    # query i attends cache slots <= pos + i; slots past the filled
    # prefix are masked by exactly that, so reading only attn_len rows
    # is a pure work reduction
    lim = ck.shape[1] if attn_len is None else min(attn_len, ck.shape[1])
    if _prefill_flash_ok(cfg, pos, s, lim):
        return flash_attention(q, k, v)
    ckv, cvv = ck[:, :lim], cv[:, :lim]
    if cks is not None:
        ckv = _dequant(ckv, cks[:, :lim], cfg.dtype)
        cvv = _dequant(cvv, cvs[:, :lim], cfg.dtype)
    return causal_attention(q, ckv, cvv, q_offset=pos)


def _block_with_cache(lay: Layout, cos, sin, pos, x, lp, ck, cv,
                      attn_len: Optional[int] = None, cks=None, cvs=None,
                      length=None):
    """One block over cached keys/values; returns the new x.  Its FFN
    half is the training layer's (:func:`.llama.ffn_half`).

    x: [B, s, H] new tokens at absolute positions [pos, pos + s);
    ck/cv: [B, max_len, Hkv, D] this layer's cache, written in place.
    ``pos``: an int, or on the decode kernel's route (``length`` given,
    see :func:`forward_with_cache`) a [1] int64 device tensor: the cache
    row is then written by index and the kernel reads ``length`` = pos + 1,
    an int or a device tensor.
    ``attn_len`` bounds the filled prefix the plain route reads; the
    decode kernel reads the ``pos + 1`` filled slots of the whole cache.
    ``cks``/``cvs``: per-row-head f32 scales when the cache is int8; fresh
    rows are quantized on insert and the causal path dequantizes the
    attended view.  The flash prefill attends over the exact fresh k/v
    instead, as in the reference."""
    cfg = lay.cfg
    b, s, _ = x.shape
    y = rms_norm(x, lp["ln_attn"], cfg.rms_eps)
    q = (y @ lay.w(lp["wq"], 0)).reshape(b, s, lay.heads, cfg.head_dim)
    k = lay.kv(y @ lay.w(lp["wk"], 0), b, s)
    v = lay.kv(y @ lay.w(lp["wv"], 0), b, s)
    positions = pos if length is not None else torch.arange(
        pos, pos + s, device=x.device)
    q = apply_rope_at(q, cos, sin, positions)
    k = apply_rope_at(k, cos, sin, positions)

    with tracing.span("generate.attention"):
        if length is not None:
            ck.index_copy_(1, pos, k)
            cv.index_copy_(1, pos, v)
            a = decode_attention(q, ck, cv, length)
        else:
            a = _attend(cfg, pos, q, k, v, ck, cv, attn_len, cks, cvs)
    x = x + comm.reduce_from(a.reshape(b, s, -1) @ lay.w(lp["wo"], 1),
                             lay.tp)
    return ffn_half(lay, x, lp)


def forward_with_cache(
    params: Params,
    tokens: torch.Tensor,              # [B, s] int
    cache: Dict[str, torch.Tensor],
    pos: Union[int, torch.Tensor],
    cfg: LlamaConfig,
    attn_len: Optional[int] = None,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    layout: Optional[Layout] = None,
    layers: Optional[List[Dict[str, torch.Tensor]]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(logits [B, s, vocab] f32, cache updated in place).  Serves both
    prefill (s = prompt length, pos = 0) and decode (s = 1).

    ``pos``: the first new token's position, an int or, for one new token
    over a native cache on the decode kernel's route, a [1] int64 tensor
    on the cache's device (read there, so that a captured step serves
    every position).  That route reads the filled prefix of the whole
    cache, and ``attn_len`` is unused there.
    ``attn_len``: upper bound on the filled prefix (pos + s <= attn_len);
    None = the whole buffer.  ``rope``: the (cos, sin) tables over the
    cache length, computed here when not given.  ``layout``: this rank's
    part of a sharded model (None: the whole model).  ``layers``:
    :func:`.llama.unbind_layers` of ``params``, made here when not
    given."""
    lay = layout or Layout(cfg)
    max_len = cache["k"].shape[2]
    quant = "k_scale" in cache
    length = None
    if _decode_kernel_ok(cfg, tokens.shape[1], quant):
        # by value where the host knows it: the kernel's split then fits
        # the filled prefix, not the cache's slots
        length = pos + 1
        if not isinstance(pos, torch.Tensor):
            pos = torch.full((1,), pos, dtype=torch.int64,
                             device=cache["k"].device)
    elif isinstance(pos, torch.Tensor):
        raise ValueError(
            "a device position takes one new token over a native cache "
            f"at head_dim {KERNEL_HEAD_DIMS}, got {tokens.shape[1]} "
            f"tokens, head_dim {cfg.head_dim}, int8 cache {quant}"
        )
    x = lay.whole(params["embed"])[tokens].to(cfg.dtype)
    if rope is None:
        rope = rope_tables(cfg, max_len, x.device)[0]
    cos, sin = rope
    for i, lp in enumerate(layers or unbind_layers(params)):
        scales = (cache["k_scale"][i], cache["v_scale"][i]) if quant \
            else (None, None)
        x = _block_with_cache(
            lay, cos, sin, pos, x, lp,
            cache["k"][i], cache["v"][i], attn_len, *scales, length=length,
        )
    x = rms_norm(x, params["ln_final"], cfg.rms_eps)
    logits = (x @ lay.whole(params["lm_head"])).float()
    return logits, cache


def _truncate(logits: torch.Tensor, top_k: int = 0,
              top_p: float = 1.0) -> torch.Tensor:
    """Temperature-scaled logits [B, V] with the ids outside the top-k
    and/or the top-p (nucleus) mass set to -inf."""
    if 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, -torch.inf)
    if 0.0 < top_p < 1.0:
        # keep the smallest prefix of descending-prob ids whose mass
        # reaches top_p (the id crossing the threshold stays included)
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        csum = torch.cumsum(probs, dim=-1)
        keep = csum - probs < top_p
        count = keep.sum(dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, count - 1)
        logits = logits.masked_fill(logits < cutoff, -torch.inf)
    return logits


def _sample(
    logits: torch.Tensor,
    temperature: float,
    generator: Optional[torch.Generator],
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """logits [B, V] -> tokens [B] int32.  Greedy at temperature 0;
    otherwise a categorical draw (from ``generator``) over the truncated
    temperature-scaled logits."""
    if top_p <= 0.0:
        raise ValueError(
            f"top_p must be in (0, 1] (got {top_p}); use top_k=1 or "
            "temperature=0 for greedy decoding"
        )
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(_truncate(logits / temperature, top_k, top_p), -1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32
    )


@torch.inference_mode()
def generate(
    params: Params,
    prompt: torch.Tensor,              # [B, S] int
    cfg: LlamaConfig,
    max_new_tokens: int,
    *,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    generator: Optional[torch.Generator] = None,
    max_len: Optional[int] = None,
    decode_block: int = 256,
    kv_dtype: str = "native",
    mesh=None,
) -> torch.Tensor:
    """Prompt + continuation, [B, S + max_new_tokens] int32, on the
    params' device.  On a ``mesh``, ``params`` are this rank's shards
    (:func:`.llama.shard_params`) and ``prompt`` / the result its rows of
    the batch (its coordinate along data x fsdp); sampling draws alike on
    the ranks of one batch shard given generators seeded alike.  Greedy when ``temperature == 0`` (then ``generator``,
    ``top_k`` and ``top_p`` are unused).  ``kv_dtype="int8"`` block-
    quantizes the KV cache (see :func:`init_cache`).

    ``decode_block``: effective-length decode granularity of the eager
    loop; 0 attends over the full buffer every step.  The CUDA graph route
    (:func:`_graph_ok`) reads the filled prefix of the whole buffer at
    every step, as the eager loop's decode kernel does."""
    device = params["embed"].device
    prompt = prompt.to(device=device, dtype=torch.int64)
    b, s = prompt.shape
    max_len = max_len if max_len is not None else s + max_new_tokens
    if max_len < s + max_new_tokens:
        raise ValueError(
            f"max_len {max_len} < prompt {s} + new {max_new_tokens}"
        )
    check_no_window(cfg, "serving (the KV cache keeps no window)")
    # serving runs no ring: a seq axis replicates
    lay = Layout(dataclasses.replace(cfg, seq_parallel=False), mesh,
                 serving=True)
    cache = init_cache(cfg, b, max_len, kv_dtype, device=device,
                       kv_heads=lay.kv_heads)
    rope = rope_tables(cfg, max_len, device)[0]
    layers = unbind_layers(params)

    def forward(tokens, pos, attn_len=None):
        return forward_with_cache(params, tokens, cache, pos, cfg, attn_len,
                                  rope, lay, layers)[0]

    # prefill attends over its own keys only, not the whole buffer
    with tracing.span("generate.prefill"):
        tok = _sample(forward(prompt, 0, s)[:, -1], temperature, generator,
                      top_k, top_p)

    out = torch.empty((b, s + max_new_tokens), dtype=torch.int32,
                      device=device)
    out[:, :s] = prompt
    out[:, s] = tok
    steps = max_new_tokens - 1
    if _graph_ok(cfg, device, mesh, kv_dtype, temperature) and steps:
        _decode_as_graph(forward, out, s, steps)
        eager = 1
    else:
        blk = decode_block if decode_block > 0 else max_len
        done = 0
        while done < steps:
            # the segment's first step writes position s + done, so it
            # needs attn_len >= s + done + 1; round up to the block grid,
            # cap at the buffer, and run until the prefix would overflow
            # that bound
            attn_len = min(-(-(s + done + 1) // blk) * blk, max_len)
            n = min(steps - done, attn_len - (s + done))
            for _ in range(n):
                with tracing.span("generate.decode_step"):
                    logits = forward(tok[:, None].long(), s + done, attn_len)
                    tok = _sample(logits[:, -1], temperature, generator,
                                  top_k, top_p)
                done += 1
                out[:, s + done] = tok
        eager = steps
    tracing.count("generate.eager_steps", lambda: torch.tensor(eager))
    tracing.count("generate.graph_steps", lambda: torch.tensor(steps - eager))
    return out


def _graph_ok(cfg: LlamaConfig, device: torch.device, mesh, kv_dtype: str,
              temperature: float) -> bool:
    """Whether the decode steps run as CUDA graph replays: only where
    every op of a step can be captured and the tokens are the eager loop's.
    One CUDA device (a mesh's collectives stay eager), a native cache on
    the decode kernel's route (the others read a view cut at a host
    position), greedy decoding (sampling draws from a host generator)."""
    return (device.type == "cuda" and mesh is None and kv_dtype == "native"
            and temperature == 0.0 and _decode_kernel_ok(cfg, 1, False))


class _DecodeStep:
    """One greedy decode step on static buffers: a call runs ``forward``
    (tokens [B, 1], position [1] int64 -> logits [B, 1, V]) on the token
    buffer at the position buffer, writes the argmax into the token buffer
    and into ``out`` at the column after the position, and advances the
    position.  No host value enters a call, so a CUDA graph that captured
    one replays every later step.  Starts at ``pos``, whose token ``out``
    holds."""

    def __init__(self, forward: Callable, out: torch.Tensor, pos: int):
        self.forward = forward
        self.made = out[:, 1:]             # column p: the token slot p makes
        self.tok = out[:, pos:pos + 1].long()
        self.pos = torch.full((1,), pos, dtype=torch.int64,
                              device=out.device)

    def __call__(self) -> None:
        tok = _sample(self.forward(self.tok, self.pos)[:, -1], 0.0, None)
        self.tok.copy_(tok[:, None])
        self.made.index_copy_(1, self.pos, tok[:, None])
        self.pos.add_(1)


def _decode_as_graph(forward: Callable, out: torch.Tensor, s: int,
                     steps: int) -> None:
    """``steps`` greedy decode steps from position ``s`` into ``out``:
    the first eagerly, on the side stream a CUDA graph of the step is then
    captured on (real work, and it warms cuBLAS and the kernels there),
    every later one as a replay of that capture.  The host never waits on
    the device.  The hand-written kernels' counts
    (:data:`..ops._kernels.LAUNCHES`) stay the eager steps': the capture
    counts none, and each replay the capture's."""
    step = _DecodeStep(forward, out, s)
    main = torch.cuda.current_stream(out.device)
    side = torch.cuda.Stream(out.device)
    side.wait_stream(main)
    graph, launches = torch.cuda.CUDAGraph(), {}

    def capture():
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            step()
        finally:
            graph.capture_end()

    with torch.cuda.stream(side):
        with tracing.span("generate.decode_step"):
            step()
        if steps > 1:
            launches = _kernels.captured(capture)
    main.wait_stream(side)
    for _ in range(steps - 1):
        with tracing.span("generate.decode_step"):
            graph.replay()
        _kernels.replayed(launches)


def make_generate_fn(
    cfg: LlamaConfig,
    max_new_tokens: int,
    *,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    decode_block: int = 256,
    kv_dtype: str = "native",
    mesh=None,
):
    """``fn(params, prompt, generator=None)`` with the decode settings
    bound (no compilation step: PyTorch runs eagerly, under
    ``torch.inference_mode``); on a ``mesh``, this rank's shards and rows
    (see :func:`generate`)."""

    def fn(params: Params, prompt: torch.Tensor,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return generate(
            params, prompt, cfg, max_new_tokens, temperature=temperature,
            top_k=top_k, top_p=top_p, generator=generator,
            decode_block=decode_block, kv_dtype=kv_dtype, mesh=mesh,
        )

    return fn
