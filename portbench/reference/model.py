"""The plain reference of both model families, in float32.

Plain PyTorch operations, written from the published descriptions of
Mistral-7B (a dense decoder: RMSNorm, rotary embeddings over split
halves, grouped-query causal attention, SwiGLU) and Mixtral-8x7B (the
same block with a sparse FFN: an f32 router, top-2 of 8 experts, the two
gate values renormalised).  The capacity routing is the benchmark's
deployment choice, written here from its definition: each batch row is a
routing group, an expert takes at most ``C = ceil(k * S / E * cf)``
tokens, assigned in order of (top-k slot, position), and a token past
capacity adds nothing for that expert.  The experts run on the gathered
tokens they hold, not as one-hot einsums; the Switch load-balancing loss
is ``E * sum(frac * mean_probs)`` with ``frac`` the share of tokens kept
by each expert.

It imports nothing of the program.  Weights come in as a dict of
per-layer float32 tensors (:func:`from_leaves`), made from the same seeded
draws the program is given.  ``prec="fp8"`` rounds both operands of every
matrix product but the router's to float8 e4m3 with a per-tensor scale
(and the incoming gradient to e5m2 in the backward): the lower-precision
control that the comparison has to reject.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch.utils.checkpoint import checkpoint

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Fp8(torch.autograd.Function):
    """Round to e4m3 forward, the gradient to e5m2 backward."""

    @staticmethod
    def forward(ctx, x):
        return _round8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2, E5M2_MAX)


def operand(x: torch.Tensor, prec: str) -> torch.Tensor:
    """A matrix product's operand in the precision ``prec`` computes."""
    if prec == "f32":
        return x
    if prec == "fp8":
        return _Fp8.apply(x)
    raise ValueError(f"unknown precision {prec!r}")


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    return operand(a, prec) @ operand(b, prec)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope_tables(n: int, dim: int, theta: float, device):
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float64,
                                        device=device) / dim))
    ang = torch.outer(torch.arange(n, dtype=torch.float64, device=device), inv)
    return torch.cos(ang).float(), torch.sin(ang).float()


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, D], rotated over split halves by the tables of its
    positions ([S, D/2])."""
    half = x.shape[-1] // 2
    c, s = cos[:, None, :], sin[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def _attn_rows(q, k, v, q0: int, prec: str):
    """Causal attention of the queries at positions [q0, q0 + len(q)) over
    the keys [0, q0 + len(q)).  q [B, s, H, D]; k, v [B, K, H, D]."""
    s = q.shape[1]
    end = q0 + s
    k, v = k[:, :end], v[:, :end]
    scores = torch.einsum("bqhd,bkhd->bhqk", operand(q, prec),
                          operand(k, prec)) / math.sqrt(q.shape[-1])
    qpos = torch.arange(q0, end, device=q.device)[:, None]
    kpos = torch.arange(end, device=q.device)[None, :]
    scores = scores.masked_fill(kpos > qpos, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", operand(p, prec), operand(v, prec))


def attention(q, k, v, prec: str, chunk: int, grad: bool):
    """Causal GQA attention in query chunks; with ``grad``, each chunk is
    recomputed in the backward, so no [S, S] probabilities are kept."""
    rep = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    outs = []
    for q0 in range(0, q.shape[1], chunk):
        qc = q[:, q0:q0 + chunk]
        if grad:
            outs.append(checkpoint(_attn_rows, qc, k, v, q0, prec,
                                   use_reentrant=False))
        else:
            outs.append(_attn_rows(qc, k, v, q0, prec))
    return torch.cat(outs, dim=1)


def capacity(cfg: Dict, seq: int) -> int:
    k, e = cfg["num_experts_per_tok"], cfg["num_local_experts"]
    return max(math.ceil(k * seq / e * cfg["assumed"]["capacity_factor"]), 1)


def route(probs: torch.Tensor, k: int, cap: int):
    """(expert [B, S, k], gate [B, S, k], kept [B, S, k] bool): the top-k
    experts (ties to the lower index), their renormalised probabilities,
    and whether each (token, slot) found room under the capacity, slot 0
    of every token before slot 1, earlier positions first."""
    e = probs.shape[-1]
    idx = torch.sort(probs.detach(), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    gate = probs.gather(-1, idx)
    gate = gate / gate.sum(-1, keepdim=True)
    counts = torch.zeros(probs.shape[0], 1, e, dtype=torch.int64,
                         device=probs.device)
    kept = []
    for slot in range(k):
        onehot = torch.nn.functional.one_hot(idx[..., slot], e)   # [B,S,E]
        before = torch.cumsum(onehot, dim=1) - onehot + counts
        pos = (before * onehot).sum(-1)
        kept.append(pos < cap)
        counts = counts + onehot.sum(1, keepdim=True)
    return idx, gate, torch.stack(kept, dim=-1)


def moe_ffn(cfg: Dict, lp: Dict, y: torch.Tensor, prec: str):
    """(out [B, S, h], aux loss) of the sparse FFN."""
    b, s, h = y.shape
    e, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    probs = torch.softmax(y @ lp["router"], dim=-1)           # router in f32
    idx, gate, kept = route(probs, k, capacity(cfg, s))
    dispatched = torch.zeros(b, s, e, dtype=torch.bool, device=y.device)
    dispatched.scatter_(-1, idx, kept)
    frac = dispatched.float().mean((0, 1))
    aux = e * (frac * probs.mean((0, 1))).sum()
    flat = y.reshape(b * s, h)
    out = torch.zeros_like(flat)
    token = torch.arange(b * s, device=y.device)
    for ex in range(e):
        sel = (idx == ex) & kept                               # [B,S,k]
        rows = sel.any(-1).reshape(-1)
        if not bool(rows.any()):
            continue
        t = token[rows]
        w = (gate * sel).sum(-1).reshape(-1)[rows]
        xe = flat[t]
        hid = torch.nn.functional.silu(mm(xe, lp["w_gate"][ex], prec)) \
            * mm(xe, lp["w_up"][ex], prec)
        out = out.index_add(0, t, mm(hid, lp["w_down"][ex], prec) * w[:, None])
    return out.reshape(b, s, h), aux


def dense_ffn(lp: Dict, y: torch.Tensor, prec: str) -> torch.Tensor:
    return mm(torch.nn.functional.silu(mm(y, lp["w_gate"], prec))
              * mm(y, lp["w_up"], prec), lp["w_down"], prec)


def block(cfg: Dict, lp: Dict, x: torch.Tensor, cos, sin, prec: str,
          grad: bool, chunk: int):
    """One decoder block over positions [0, S): (x', aux or None)."""
    b, s, h = x.shape
    hq, hkv, d = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    eps = cfg["rms_norm_eps"]
    y = rms_norm(x, lp["ln_attn"], eps)
    q = rope(mm(y, lp["wq"], prec).reshape(b, s, hq, d), cos, sin)
    k = rope(mm(y, lp["wk"], prec).reshape(b, s, hkv, d), cos, sin)
    v = mm(y, lp["wv"], prec).reshape(b, s, hkv, d)
    a = attention(q, k, v, prec, chunk, grad)
    x = x + mm(a.reshape(b, s, hq * d), lp["wo"], prec)
    y = rms_norm(x, lp["ln_mlp"], eps)
    if "router" in lp:
        f, aux = moe_ffn(cfg, lp, y, prec)
        return x + f, aux
    return x + dense_ffn(lp, y, prec), None


def hidden(cfg: Dict, params: Dict, tokens: torch.Tensor, prec: str,
           grad: bool, chunk: int = 1024):
    """(final-norm hidden states [B, S, h], mean aux loss or None)."""
    x = params["embed"][tokens]
    cos, sin = rope_tables(tokens.shape[1], cfg["head_dim"],
                           cfg["rope_theta"], x.device)
    auxes = []
    for lp in params["layers"]:
        if grad:
            x, aux = checkpoint(block, cfg, lp, x, cos, sin, prec, grad,
                                chunk, use_reentrant=False)
        else:
            x, aux = block(cfg, lp, x, cos, sin, prec, grad, chunk)
        if aux is not None:
            auxes.append(aux)
    x = rms_norm(x, params["ln_final"], cfg["rms_norm_eps"])
    return x, (torch.stack(auxes).mean() if auxes else None)


def _xent_sum(x, head, targets, prec):
    logits = mm(x, head, prec)
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, targets[..., None])[..., 0]).sum()


def loss(cfg: Dict, params: Dict, tokens: torch.Tensor, prec: str = "f32",
         chunk: int = 1024) -> torch.Tensor:
    """Mean next-token cross entropy of tokens [B, S + 1] (plus the
    router's aux loss times its coefficient), with every layer and each
    chunk of the vocabulary projection recomputed in the backward."""
    inp, targets = tokens[:, :-1], tokens[:, 1:]
    x, aux = hidden(cfg, params, inp, prec, True, chunk)
    b, s = inp.shape
    total = x.new_zeros(())
    for c0 in range(0, s, chunk):
        total = total + checkpoint(_xent_sum, x[:, c0:c0 + chunk],
                                   params["lm_head"], targets[:, c0:c0 + chunk],
                                   prec, use_reentrant=False)
    out = total / (b * s)
    if aux is not None:
        out = out + cfg["router_aux_loss_coef"] * aux
    return out


@torch.no_grad()
def logits_at(cfg: Dict, params: Dict, tokens: torch.Tensor,
              positions: slice, prec: str = "f32",
              chunk: int = 1024) -> torch.Tensor:
    """f32 logits [B, n, V] at ``positions`` of one full forward pass over
    tokens [B, S]."""
    x, _ = hidden(cfg, params, tokens, prec, False, chunk)
    return mm(x[:, positions], params["lm_head"], prec)


def from_leaves(leaves: Dict[str, torch.Tensor],
                requires_grad: bool = False) -> Dict:
    """The reference's parameters from the stacked ``[L, ...]`` tensors of
    the benchmark's draws (``weights.draw``), each layer's slice widened to
    float32."""
    def f32(t):
        t = t.detach().float().contiguous()
        return t.requires_grad_(requires_grad)

    n = leaves["layers"]["wq"].shape[0]
    layers: List[Dict[str, torch.Tensor]] = []
    for i in range(n):
        lp = {}
        for name, t in leaves["layers"].items():
            if t.dim() == 4:      # experts [L, E, in, out]
                lp[name] = [f32(t[i, e]) for e in range(t.shape[1])]
            else:
                lp[name] = f32(t[i])
        layers.append(lp)
    return {"embed": f32(leaves["embed"]), "layers": layers,
            "ln_final": f32(leaves["ln_final"]),
            "lm_head": f32(leaves["lm_head"])}


def leaf_groups(params: Dict) -> Dict[str, List[torch.Tensor]]:
    """Every reference tensor under the name of the program's stacked leaf
    it is a slice of ("layers.wq", "embed", ...)."""
    out: Dict[str, List[torch.Tensor]] = {
        "embed": [params["embed"]], "ln_final": [params["ln_final"]],
        "lm_head": [params["lm_head"]]}
    for lp in params["layers"]:
        for name, t in lp.items():
            out.setdefault(f"layers.{name}", []).extend(
                t if isinstance(t, list) else [t])
    return out

