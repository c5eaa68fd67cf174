"""The plain reference of a hybrid-attention dropless MoE decoder
(Mellum2-12B-A2.5B's block), in float32, and its first train steps.

Plain PyTorch operations, written from the published config
(``configs/mellum2-l16.json``, JetBrains/Mellum2-12B-A2.5B-Instruct):

* RMSNorm, then grouped-query attention with an explicit head dim (32
  query and 4 key/value heads of 128 over a hidden size of 2,304), no
  bias and no norm on q or k;
* per layer type (``layer_types``): "full_attention" layers are causal and
  take YaRN RoPE (``rope_parameters``' "yarn": the inverse frequencies
  blended by a ramp over the dimensions between ``beta_fast`` and
  ``beta_slow`` rotations of the original context, truncated to whole
  dimensions, and cos and sin times ``attention_factor``, as transformers'
  ``_compute_yarn_parameters`` defines them); "sliding_attention" layers
  see the keys j with i - window < j <= i (transformers' sliding mask,
  ``kv_idx > q_idx - sliding_window``) and take plain RoPE;
* every layer sparse: an f32 router softmax over all experts, the top-k
  (ties to the lower index), the k probabilities renormalised
  (``norm_topk_prob``), and the output the sum over the k of gate x
  SwiGLU expert, every assignment kept (the config has no capacity key:
  dropless), no shared expert; the Switch load-balancing loss
  ``E * sum(frac * mean_probs)`` with ``frac`` each expert's share of the
  tokens routed to it;
* the untied head and the mean next-token cross entropy plus the aux
  loss's coefficient times the layers' mean aux loss.

Departures from the published model, each under ``assumed`` in the
configuration: the MTP head is left out (``described_as`` names one, the
config carries no key for it); the aux coefficient is assumed (the config
names none); the experts are computed on the gathered rows they take, not
sorted.  Attention runs in blocks of query rows (each recomputed in the
backward) so that 32k positions fit, over only the keys a block can see.

It imports nothing of the program: the weights are the benchmark's seeded
draws (``weights.draw_leaf`` of :func:`leaf_view`), the optimizers
``optim``'s, and ``prec="fp8"`` the float8 control of ``model``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from portbench import weights
from portbench.reference import model, optim
from portbench.reference.train import _slices, params_f32, strict_f32

SLIDING = "sliding_attention"
ATTN_BLOCK = 512


def leaf_view(cfg: Dict) -> Dict:
    """The configuration under the keys ``weights.leaf_specs`` reads for a
    MoE tree: the expert width and count of this config's own keys."""
    return {**cfg, "family": "moe",
            "intermediate_size": cfg["moe_intermediate_size"],
            "num_local_experts": cfg["num_experts"]}


def aux_coef(cfg: Dict) -> float:
    return cfg["assumed"]["router_aux_loss_coef"]


def yarn(dim: int, spec: Dict, max_positions: int):
    """(inverse frequencies [dim / 2] float64, attention factor) of YaRN."""
    theta, factor = float(spec["rope_theta"]), float(spec["factor"])
    original = spec.get("original_max_position_embeddings") or max_positions
    attn = spec.get("attention_factor")
    if attn is None:
        attn = 0.1 * math.log(factor) + 1.0 if factor > 1 else 1.0

    def dim_of(rot):
        return dim * math.log(original / (rot * 2 * math.pi)) / (
            2 * math.log(theta))

    low = max(math.floor(dim_of(spec.get("beta_fast") or 32)), 0)
    high = min(math.ceil(dim_of(spec.get("beta_slow") or 1)), dim - 1)
    if low == high:
        high += 0.001
    base = theta ** (torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    ramp = ((torch.arange(dim // 2, dtype=torch.float64) - low)
            / (high - low)).clamp(0, 1)
    inv = (1.0 / (factor * base)) * ramp + (1.0 / base) * (1 - ramp)
    return inv, attn


def rope_tables(cfg: Dict, layer_type: str, n: int, device):
    """(cos, sin) [n, head_dim / 2] float32 of a layer type."""
    spec = cfg["rope_parameters"][layer_type]
    d = cfg["head_dim"]
    if spec.get("rope_type", "default") == "yarn":
        inv, gain = yarn(d, spec, cfg["max_position_embeddings"])
    elif spec.get("rope_type", "default") == "default":
        inv = 1.0 / (float(spec["rope_theta"])
                     ** (torch.arange(0, d, 2, dtype=torch.float64) / d))
        gain = 1.0
    else:
        raise ValueError(f"no rope_type {spec['rope_type']!r} here")
    ang = torch.outer(torch.arange(n, dtype=torch.float64), inv)
    return ((torch.cos(ang) * gain).float().to(device),
            (torch.sin(ang) * gain).float().to(device))


def _attn_rows(q, k, v, q0: int, prec: str, window: int):
    """Queries at positions [q0, q0 + len(q)) over the keys they can see:
    causal, and above ``q - window`` where ``window`` > 0.  q [B, s, H, D];
    k, v [B, S, H, D]."""
    s = q.shape[1]
    end = q0 + s
    lo = max(q0 - window + 1, 0) if window else 0
    k, v = k[:, lo:end], v[:, lo:end]
    scores = torch.einsum("bqhd,bkhd->bhqk", model.operand(q, prec),
                          model.operand(k, prec)) / math.sqrt(q.shape[-1])
    qpos = torch.arange(q0, end, device=q.device)[:, None]
    kpos = torch.arange(lo, end, device=q.device)[None, :]
    hidden = kpos > qpos
    if window:
        hidden = hidden | (qpos - kpos >= window)
    p = torch.softmax(scores.masked_fill(hidden, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", model.operand(p, prec),
                        model.operand(v, prec))


def attention(q, k, v, prec: str, window: int, grad: bool):
    rep = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    outs = []
    for q0 in range(0, q.shape[1], ATTN_BLOCK):
        args = (q[:, q0:q0 + ATTN_BLOCK], k, v, q0, prec, window)
        outs.append(checkpoint(_attn_rows, *args, use_reentrant=False)
                    if grad else _attn_rows(*args))
    return torch.cat(outs, dim=1)


def experts_of(probs: torch.Tensor, k: int) -> torch.Tensor:
    """Each token's k most probable experts [B, S, k], ties to the lower
    index (a stable descending sort)."""
    return torch.sort(probs, dim=-1, descending=True,
                      stable=True).indices[..., :k]


def moe_ffn(cfg: Dict, lp: Dict, y: torch.Tensor, prec: str):
    """(out [B, S, h], aux loss) of the dropless sparse FFN."""
    b, s, h = y.shape
    e, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    probs = torch.softmax(y @ lp["router"], dim=-1)          # router in f32
    idx = experts_of(probs.detach(), k)
    gate = probs.gather(-1, idx)
    gate = gate / gate.sum(-1, keepdim=True)
    routed = torch.zeros(b, s, e, dtype=torch.bool, device=y.device)
    routed.scatter_(-1, idx, True)
    aux = e * (routed.float().mean((0, 1)) * probs.mean((0, 1))).sum()
    flat = y.reshape(b * s, h)
    out = torch.zeros_like(flat)
    token = torch.arange(b * s, device=y.device)
    for ex in range(e):
        sel = idx == ex                                        # [B, S, k]
        rows = sel.any(-1).reshape(-1)
        if not bool(rows.any()):
            continue
        t = token[rows]
        w = (gate * sel).sum(-1).reshape(-1)[rows]
        xe = flat[t]
        hid = torch.nn.functional.silu(model.mm(xe, lp["w_gate"][ex], prec)) \
            * model.mm(xe, lp["w_up"][ex], prec)
        out = out.index_add(0, t, model.mm(hid, lp["w_down"][ex], prec)
                            * w[:, None])
    return out.reshape(b, s, h), aux


def block(cfg: Dict, lp: Dict, x: torch.Tensor, cos, sin, window: int,
          prec: str, grad: bool):
    b, s, _ = x.shape
    hq, hkv, d = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    eps = cfg["rms_norm_eps"]
    y = model.rms_norm(x, lp["ln_attn"], eps)
    q = model.rope(model.mm(y, lp["wq"], prec).reshape(b, s, hq, d), cos, sin)
    k = model.rope(model.mm(y, lp["wk"], prec).reshape(b, s, hkv, d), cos,
                   sin)
    v = model.mm(y, lp["wv"], prec).reshape(b, s, hkv, d)
    a = attention(q, k, v, prec, window, grad)
    x = x + model.mm(a.reshape(b, s, hq * d), lp["wo"], prec)
    f, aux = moe_ffn(cfg, lp, model.rms_norm(x, lp["ln_mlp"], eps), prec)
    return x + f, aux


def hidden(cfg: Dict, params: Dict, tokens: torch.Tensor, prec: str,
           grad: bool):
    """(final-norm hidden states [B, S, h], the layers' mean aux loss)."""
    x = params["embed"][tokens]
    s = tokens.shape[1]
    tables = {t: rope_tables(cfg, t, s, x.device)
              for t in set(cfg["layer_types"])}
    auxes = []
    for lp, kind in zip(params["layers"], cfg["layer_types"]):
        window = cfg["sliding_window"] if kind == SLIDING else 0
        args = (cfg, lp, x, *tables[kind], window, prec, grad)
        x, aux = (checkpoint(block, *args, use_reentrant=False) if grad
                  else block(*args))
        auxes.append(aux)
    return (model.rms_norm(x, params["ln_final"], cfg["rms_norm_eps"]),
            torch.stack(auxes).mean())


def loss(cfg: Dict, params: Dict, tokens: torch.Tensor, prec: str = "f32",
         chunk: int = 1024) -> torch.Tensor:
    """Mean next-token cross entropy of tokens [B, S + 1] plus the aux
    coefficient times the mean aux loss; each layer and each chunk of the
    vocabulary projection recomputed in the backward."""
    inp, targets = tokens[:, :-1], tokens[:, 1:]
    x, aux = hidden(cfg, params, inp, prec, True)
    b, s = inp.shape
    total = x.new_zeros(())
    for c0 in range(0, s, chunk):
        total = total + checkpoint(model._xent_sum, x[:, c0:c0 + chunk],
                                   params["lm_head"],
                                   targets[:, c0:c0 + chunk], prec,
                                   use_reentrant=False)
    return total / (b * s) + aux_coef(cfg) * aux


def follow(cfg: Dict, seed: int, batches: torch.Tensor, optimizer: str,
           lr: float, weight_decay: float, device, steps: int = 3,
           prec: str = "f32", chunk: int = 1024, keep_first: bool = False,
           against: Sequence[Dict] = ()) -> Dict:
    """``reference.train.follow``'s readings (losses, first gradient norms
    from the optimizer's first moment, change norms, "first" and
    "grad_diffs") of ``steps`` steps of this model, each layer tensor
    stepped as soon as its gradient is whole and rounded to its stored
    dtype."""
    if torch.device(device).type == "cuda":
        strict_f32()
    view = leaf_view(cfg)
    params = params_f32(view, seed, device, True)
    groups = model.leaf_groups(params)
    name_of = {id(t): n for n, ts in groups.items() for t in ts}
    slot = {id(t): (n, i) for n, ts in groups.items() for i, t in enumerate(ts)}
    stored = {path: dtype for path, _, _, dtype in weights.leaf_specs(view)}
    opt = optim.make(optimizer, lr, weight_decay)
    count = [0]
    gsq: Dict[str, float] = {n: 0.0 for n in groups}
    first: Dict = {}
    dsq: List[Dict[str, float]] = [{n: 0.0 for n in groups} for _ in against]
    stepped = set()

    def update(p: torch.Tensor) -> None:
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        opt.step(p, g, count[0])
        if count[0] == 1:
            g = opt.first_moment(p) / (1 - opt.b1)
            key = slot[id(p)]
            gsq[key[0]] += float(g.double().pow(2).sum())
            if keep_first:
                first[key] = g.to(torch.bfloat16).cpu()
            for acc, other in zip(dsq, against):
                theirs = other[key].to(g.device).float()
                acc[key[0]] += float((g - theirs).double().pow(2).sum())
        with torch.no_grad():
            p.copy_(p.to(stored[name_of[id(p)]]))
        p.grad = None
        stepped.add(id(p))

    for n, ts in groups.items():
        if n.startswith("layers."):
            for t in ts:
                t.register_post_accumulate_grad_hook(update)
    losses = []
    for i in range(steps):
        count[0] = i + 1
        stepped.clear()
        value = loss(cfg, params, batches[i], prec, chunk)
        value.backward()
        losses.append(float(value.detach()))
        del value
        for ts in groups.values():
            for t in ts:
                if id(t) not in stepped:
                    update(t)
    change: Dict[str, float] = {}
    with torch.no_grad():
        for path, *_ in weights.leaf_specs(view):
            start = weights.draw_leaf(view, seed, path, device)
            total = 0.0
            for t, s in zip(groups[path], _slices(path, start)):
                total += float((t - s.float()).double().pow(2).sum())
            change[path] = math.sqrt(total)
            del start
    return {"losses": losses,
            "grad_norms": {n: math.sqrt(v) for n, v in gsq.items()},
            "change_norms": change, "first": first,
            "grad_diffs": [{n: math.sqrt(acc[n] / gsq[n]) if gsq[n] else 0.0
                            for n in acc} for acc in dsq]}
