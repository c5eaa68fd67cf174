"""The port's measuring helpers: peaks, residency, FLOPs and one timed rung,
and the two measuring tools built on them.

Counterpart of what ``tools/perf_decomp.py`` and ``tools/remat_search.py``
take from ``bench.py`` (``bench.py:209-403``), not a port of its ladder:

* :data:`PEAKS` by SKU and :func:`peak_flops` (which raises on a card it
  has no figures for, where the reference's ``0.0`` would give an MFU of
  0); :func:`device_bytes`, the card's memory;
* :func:`train_flops_per_token` and :func:`train_mem_estimate`, the
  reference's formulas;
* :func:`measure`, one ladder rung: a first step, two warm steps, then
  ``iters`` timed steps ending in ``loss.item()``, the loss guard, and
  tokens/s and MFU;
* :func:`decompose`, ``tools/perf_decomp_torch.py``'s stages (forward,
  forward plus backward, the train step, a matmul ceiling probe) and its
  JSON line;
* :func:`remat_search`, ``tools/remat_search_torch.py``'s sweep of remat
  policy x optimizer x batch.

Everything runs on CUDA unless the caller passes ``device="cpu"``.  A CPU
run is a rehearsal: its MFU and peak fractions are None, since no peak is
known there, and its times are the CPU's.
"""

from __future__ import annotations

import gc
import json
import subprocess
import time
from typing import Callable, Dict, Iterable, List, Optional

import torch

from . import resolve_device

# published dense peaks per SKU: (device memory B/s, bf16 tensor FLOP/s,
# f32 non-tensor FLOP/s) -- NVIDIA data sheets.  A name is matched by the
# first key it contains, so "H100 PCIe" is tried before "H100".
PEAKS = {
    "H100 PCIe": (2.0e12, 756e12, 51e12),
    "H100": (3.35e12, 989e12, 67e12),          # SXM5 80GB HBM3
}

# the remat policies the sweep covers, in the reference's order
POLICIES = ("dots", "ffn", "ffn_offload", "ffn_lite", "full")
# --opts names -> the train step's optimizer argument
OPTIMIZERS = {"adam8": "adam8bit", "adamw": None}


def peaks(name: str):
    """(bytes/s, bf16 FLOP/s, f32 FLOP/s) of the card ``name``
    (``torch.cuda.get_device_name``); raises on a name with no entry."""
    for key, val in PEAKS.items():
        if key in name:
            return val
    raise ValueError(f"no published peaks for {name!r}; known: "
                     f"{sorted(PEAKS)}")


def peak_flops(name: str) -> float:
    """The dense bf16 peak FLOP/s of the card ``name``."""
    return peaks(name)[1]


def device_bytes(device) -> Optional[int]:
    """The card's memory in bytes; None for the CPU, where no budget
    applies."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return torch.cuda.get_device_properties(dev).total_memory


def power_limit_w(device) -> Optional[float]:
    """The card's power limit in W from ``nvidia-smi``; None for the
    CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    lines = out.stdout.strip().splitlines()
    return float(lines[dev.index or 0])


def device_kind(device) -> str:
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _peak_of(dev: torch.device) -> Optional[float]:
    return peak_flops(device_kind(dev)) if dev.type == "cuda" else None


def train_flops_per_token(cfg, seq: int) -> float:
    """Model FLOPs per trained token: 6x matmul params (fwd 2 + bwd 4; the
    embedding gather is not a matmul) + causal attention scores (QK^T and
    AV, fwd+bwd, average context seq/2)."""
    n_matmul = cfg.num_params() - cfg.vocab_size * cfg.hidden
    attn = 6 * cfg.layers * cfg.hidden * seq
    return 6 * n_matmul + attn


def train_mem_estimate(cfg, batch: int, seq: int, opt8: bool = False) -> int:
    """bf16 params+grads + adam moments (bf16, or int8/f8 when ``opt8``),
    logits (chunked when cfg.xent_chunk), remat residuals (policy-aware),
    the reference's formula.  "ffn_offload" keeps its saved set in pinned
    host memory on CUDA (``models/training.py`` ``HostStash``), so only the
    layer carry stays on the card: ``hidden`` per token, as the reference
    charges the TPU."""
    p = cfg.num_params()
    if cfg.xent_chunk:
        # the reference's calibration: a quarter f32 copy of a chunk's
        # logits covers the tiled transients
        logits = batch * cfg.xent_chunk * cfg.vocab_size * 4 // 4
    else:
        logits = batch * seq * cfg.vocab_size * 4 * 2     # fwd + bwd copies
    policy = getattr(cfg, "remat_policy", "dots")
    per_tok = {
        # bytes/2 per token of saved activations per layer
        "dots": (cfg.heads + 2 * cfg.kv_heads) * cfg.head_dim
                + 2 * cfg.hidden + 2 * cfg.ffn,
        "ffn": cfg.hidden + 2 * cfg.ffn,     # resid_mid + gate + up
        "ffn_lite": cfg.hidden + cfg.ffn,    # resid_mid + gate
        "ffn_offload": cfg.hidden,           # the carry; the set on the host
        "full": cfg.hidden,                  # scan carry only
    }.get(policy, cfg.hidden)
    resid = batch * seq * per_tok * cfg.layers * 2
    param_bytes = p * (6 if opt8 else 8)   # 2+2+1+1 vs 2+2+2+2
    return param_bytes + logits + resid


def _tokens(cfg, batch: int, seq: int, dev: torch.device,
            seed: int) -> torch.Tensor:
    gen = torch.Generator(dev).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (batch, seq + 1), device=dev,
                         generator=gen)


def measure(name: str, cfg, batch: int, seq: int, device=None,
            optimizer=None, iters: int = 10, log: Callable = print) -> Dict:
    """One ladder rung of the Llama train step (``bench.py:338-403``):
    the row ``{config, tokens_per_sec_per_chip, mfu, batch, seq, loss}``.
    ``optimizer``: None (AdamW 3e-4, wd 0.1) or ``"adam8bit"``.  A first
    step (its set-up included), two warm steps, then ``iters`` timed steps
    on one fixed batch of random tokens, the last ending in
    ``loss.item()``.  Raises where the loss is not in (0, 20): a rung
    whose training is broken is rejected, not ranked on speed."""
    from .models import llama

    dev = resolve_device(device)
    peak = _peak_of(dev)
    step, init_all, _ = llama.make_train_step(cfg, optimizer=optimizer,
                                              device=dev)
    params, opt_state = init_all(torch.Generator(dev).manual_seed(0))
    tokens = _tokens(cfg, batch, seq, dev, 1)
    t0 = time.perf_counter()
    params, opt_state, loss = step(params, opt_state, tokens)
    loss.item()
    log(f"[{name}] first step (incl. set-up): "
        f"{time.perf_counter() - t0:.1f}s")
    for _ in range(2):
        params, opt_state, loss = step(params, opt_state, tokens)
    loss.item()
    t0 = time.perf_counter()
    for _ in range(iters):
        params, opt_state, loss = step(params, opt_state, tokens)
    loss_val = loss.item()
    dt = time.perf_counter() - t0
    if not 0.0 < loss_val < 20.0:
        raise RuntimeError(f"implausible loss {loss_val}: rung rejected")
    tok_per_s = batch * seq * iters / dt
    mfu = (tok_per_s * train_flops_per_token(cfg, seq) / peak
           if peak else None)
    log(f"[{name}] {iters} steps in {dt:.2f}s, loss {loss_val:.3f}, "
        f"{tok_per_s:.0f} tok/s" + (f", MFU {mfu:.1%}" if peak else ""))
    del params, opt_state, step, init_all, tokens
    gc.collect()
    return {"config": name, "tokens_per_sec_per_chip": tok_per_s,
            "mfu": mfu, "batch": batch, "seq": seq, "loss": loss_val}


# -- the perf decomposition ------------------------------------------------


def _timeit(fn: Callable, iters: int) -> float:
    """Seconds a call: one warm call, then ``iters`` calls, each result
    fetched as a scalar (the fence the reference's ``fence_scalar`` is)."""
    fn().item()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    out.item()
    return (time.perf_counter() - t0) / iters


def decompose(cfg, batch: int, seq: int, iters: int = 10, device=None,
              name: str = "llama") -> Dict:
    """The Llama train step's time split into stages, and its JSON line
    (``tools/perf_decomp.py:151-190``'s keys, its ``mxu_probe`` named
    ``matmul_probe``):

    * ``fwd``: ``loss_fn`` under ``torch.no_grad``.  No graph is built, so
      ``torch.utils.checkpoint`` stores nothing and reruns nothing: no
      remat, as the reference's jitted loss (no autodiff) has none;
    * ``grad``: the loss and its backward over every leaf, remat reruns
      included (under "full" the ideal is 4x ``fwd``);
    * ``step``: :func:`.models.llama.make_train_step`'s step (AdamW 3e-4,
      wd 0.1), the optimizer added;
    * a bf16 matmul ceiling probe: 64 chained ``[b*s, hidden] @ [hidden,
      hidden]`` products summed to one f32 scalar, the rate a plain
      ``torch.matmul`` reaches at the model's width.

    Each stage: one warm call, then ``iters`` calls ending in a scalar
    fetch.  ``seconds`` are unrounded; ``optimizer`` is ``step - grad``;
    ``loss`` is the last timed step's.  MFU and the probe's fraction of
    peak are None on the CPU."""
    from .models import llama, training

    dev = resolve_device(device)
    kind = device_kind(dev)
    peak = _peak_of(dev)
    b, s = batch, seq
    tokens = _tokens(cfg, b, s, dev, 1)

    params = llama.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    leaves = [p.requires_grad_() for p in training.tree_leaves(params)]

    def fwd():
        with torch.no_grad():
            return llama.loss_fn(params, tokens, cfg)

    def grad():
        loss = llama.loss_fn(params, tokens, cfg)
        torch.autograd.grad(loss, leaves)
        return loss.detach()

    t_fwd = _timeit(fwd, iters)
    t_grad = _timeit(grad, iters)
    del params, leaves

    step, init_all, _ = llama.make_train_step(cfg, device=dev)
    state = [*init_all(torch.Generator(dev).manual_seed(0)), None]

    def train_step():
        state[0], state[1], state[2] = step(state[0], state[1], tokens)
        return state[2]

    t_step = _timeit(train_step, iters)
    loss = state[2].item()
    del state, step, init_all

    m, k, reps = b * s, cfg.hidden, 64
    gen = torch.Generator(dev).manual_seed(2)
    a = torch.randn((m, k), device=dev, generator=gen).to(torch.bfloat16)
    # 1/sqrt(k) keeps the chain's magnitudes (the reference's 1/k
    # underflows to zeros after a few products; the time is the same)
    w = (torch.randn((k, k), device=dev, generator=gen)
         / k ** 0.5).to(torch.bfloat16)

    def chain():
        x = a
        for _ in range(reps):
            x = x @ w
        return x.float().sum()

    t_chain = _timeit(chain, iters)
    mm_flops = reps * 2 * m * k * k / t_chain
    del a, w
    gc.collect()

    toks = b * s
    f_train = train_flops_per_token(cfg, s) * toks     # 6N + attn
    f_fwd = f_train / 3.0                              # 2N + attn/3

    def mfu(flops, t):
        return flops / (t * peak) if peak else None

    return {
        "metric": f"{name} perf decomposition",
        "value": toks / t_step,
        "unit": "tokens/sec/chip",
        "vs_baseline": 1.0,
        "device_kind": kind,
        "power_limit_w": power_limit_w(dev),
        "batch": b, "seq": s, "remat_policy": cfg.remat_policy,
        # the last timed step's loss: a decomposition of a broken step
        # means nothing
        "loss": loss,
        "seconds": {
            "fwd": t_fwd,
            "grad": t_grad,
            "step": t_step,
            "optimizer": t_step - t_grad,
            "bwd_plus_remat": t_grad - t_fwd,
        },
        "mfu": {
            "fwd_only": mfu(f_fwd, t_fwd),
            "grad": mfu(f_train, t_grad),
            "full_step": mfu(f_train, t_step),
        },
        "multipliers": {
            # ideal 4.0 under full remat (recompute + 2x-fwd backward)
            "grad_over_fwd": t_grad / t_fwd,
            "step_over_grad": t_step / t_grad,
        },
        "matmul_probe": {
            "shape": [m, k, k],
            "tflops": mm_flops / 1e12,
            "fraction_of_peak": mm_flops / peak if peak else None,
        },
    }


# -- the remat policy search ---------------------------------------------


def remat_search(base, config: str, batches: Iterable[int],
                 opts: Iterable[str], seq: int, xent_chunk: int,
                 device=None, out_path: Optional[str] = None,
                 iters: int = 10, log: Callable = print) -> Dict:
    """Every remat policy x optimizer x batch of ``base`` (a Llama
    config) at ``seq`` with cross entropy in chunks of ``xent_chunk``,
    each through :func:`measure` (``tools/remat_search.py``'s sweep).

    A combination whose :func:`train_mem_estimate` exceeds 0.95 of the
    card's bytes is skipped.  A rung that raises
    ``torch.cuda.OutOfMemoryError`` is logged as ``fail`` and the sweep
    goes on after ``torch.cuda.empty_cache()``; any other error
    propagates, so a kernel fault cannot pass as an OOM.  Each row that
    ran is appended to ``out_path`` as a JSON line.  Returns ``{"best":
    the reference's best-row line, "rows", "skipped", "failed"}``; raises
    where no combination ran."""
    import dataclasses

    dev = resolve_device(device)
    opts = [o.strip() for o in opts if o.strip()]
    bad = set(opts) - set(OPTIMIZERS)
    if bad:
        raise ValueError(f"opts must be adam8/adamw, got {sorted(bad)}")
    budget = device_bytes(dev)
    rows: List[Dict] = []
    skipped: List[str] = []
    failed: List[Dict] = []
    out = open(out_path, "a") if out_path else None
    try:
        for policy in POLICIES:
            for opt in opts:
                for batch in batches:
                    cfg = dataclasses.replace(
                        base, xent_chunk=xent_chunk, remat_policy=policy)
                    name = f"{config}/{policy}/{opt}/b{batch}"
                    est = train_mem_estimate(cfg, batch, seq,
                                             opt8=opt == "adam8")
                    if budget is not None and est > 0.95 * budget:
                        log(f"skip {name}: est {est / 2**30:.1f} GiB "
                            f"> budget")
                        skipped.append(name)
                        continue
                    try:
                        row = measure(name, cfg, batch, seq, dev,
                                      OPTIMIZERS[opt], iters, log)
                    except torch.cuda.OutOfMemoryError as e:
                        log(f"fail {name}: OutOfMemoryError: "
                            f"{str(e)[:120]}")
                        failed.append({"config": name,
                                       "error": "OutOfMemoryError"})
                        row = None
                    if row is None:
                        gc.collect()
                        torch.cuda.empty_cache()
                        continue
                    rows.append(row)
                    if out is not None:
                        out.write(json.dumps(row) + "\n")
                        out.flush()
                    log(f"done {name}: {row['tokens_per_sec_per_chip']:.1f} "
                        f"tok/s/chip (mfu {row['mfu']})")
    finally:
        if out is not None:
            out.close()
    if not rows:
        raise RuntimeError("no policy/batch combination ran to completion")
    best = max(rows, key=lambda r: r["tokens_per_sec_per_chip"])
    return {
        "best": {"metric": f"{best['config']} remat-search best",
                 "value": best["tokens_per_sec_per_chip"],
                 "unit": "tokens/sec/chip", "mfu": best["mfu"],
                 "rows": sorted(rows,
                                key=lambda r: -r["tokens_per_sec_per_chip"])},
        "rows": rows, "skipped": skipped, "failed": failed,
    }
