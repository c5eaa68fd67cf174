"""The reference's first train steps, and the numbers the comparison
reads from them: each step's loss, each leaf's first gradient norm and
the norm of each leaf's change over the steps, as far as the parameters'
stored dtype keeps it (the configuration stores them in bfloat16, the
router in float32: each update is computed in float32 and the sum rounded
to that dtype, as the configuration's optimizer does).

The parameters are float32 copies of the seeded draws, held per layer;
every layer and every chunk of the vocabulary projection is recomputed in
the backward, and each layer tensor is stepped by the optimizer as soon
as its gradient is whole, so the reference of a 7B model fits one card
beside nothing else.  Leaves are named as the program's stacked leaves
("layers.wq" is every layer's wq), and a norm of such a leaf is taken over
all of its slices.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from portbench import weights
from portbench.reference import model, optim


def strict_f32() -> None:
    """float32 products in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def params_f32(cfg: Dict, seed: int, device, requires_grad: bool) -> Dict:
    """The seeded draws as the reference's per-layer float32 tensors,
    drawn one stacked leaf at a time."""
    layers: List[Dict] = [dict() for _ in range(cfg["num_hidden_layers"])]
    out: Dict = {"layers": layers}
    for path, *_ in weights.leaf_specs(cfg):
        leaf = weights.draw_leaf(cfg, seed, path, device)

        def f32(t):
            return t.float().contiguous().requires_grad_(requires_grad)

        if path.startswith("layers."):
            name = path.split(".", 1)[1]
            for i, lp in enumerate(layers):
                lp[name] = ([f32(t) for t in leaf[i]] if leaf.dim() == 4
                            else f32(leaf[i]))
        else:
            out[path] = f32(leaf)
        del leaf
    return out


def _slices(path: str, leaf: torch.Tensor) -> List[torch.Tensor]:
    """A stacked leaf's slices in :func:`model.leaf_groups` order."""
    if not path.startswith("layers."):
        return [leaf]
    if leaf.dim() == 4:
        return [t for per_layer in leaf for t in per_layer]
    return list(leaf)


def slices(path: str, leaf: torch.Tensor) -> List[torch.Tensor]:
    """Public name of :func:`_slices`, for the other side's copy of the
    first gradients."""
    return _slices(path, leaf)


def follow(cfg: Dict, seed: int, batches: torch.Tensor, optimizer: str,
           lr: float, weight_decay: float, device, steps: int = 3,
           prec: str = "f32", chunk: int = 1024, keep_first: bool = False,
           against: Sequence[Dict] = ()) -> Dict:
    """{"losses": [...], "grad_norms": {leaf: float}, "change_norms":
    {leaf: float}} of ``steps`` reference steps on ``batches[i]``.

    The first gradient is read from the optimizer's first moment after
    step 1, as the program's is.  ``keep_first``: also "first", every
    slice's such gradient in host memory (bfloat16), keyed (leaf, slice
    index).  ``against``: other
    sides' such copies; "grad_diffs" then holds, for each, every leaf's
    norm of the difference of the first gradients over this one's norm."""
    if torch.device(device).type == "cuda":
        strict_f32()
    params = params_f32(cfg, seed, device, True)
    groups = model.leaf_groups(params)
    name_of = {id(t): n for n, ts in groups.items() for t in ts}
    # the parameters are kept in the dtype the configuration stores them
    # in: an update is computed in float32 and the sum rounded to it
    stored = {path: dtype for path, _, _, dtype in weights.leaf_specs(cfg)}
    opt = optim.make(optimizer, lr, weight_decay)
    count = [0]
    gsq: Dict[str, float] = {n: 0.0 for n in groups}
    slot = {id(t): (n, k) for n, ts in groups.items() for k, t in enumerate(ts)}
    first: Dict = {}
    dsq = [{n: 0.0 for n in groups} for _ in against]
    stepped = set()

    def update(p: torch.Tensor) -> None:
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        opt.step(p, g, count[0])
        if count[0] == 1:
            # the first gradient as the optimizer holds it, (1 - b1) g in
            # its first moment's storage, divided back: the program's is
            # read the same way
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

    layer_tensors = [t for n, ts in groups.items() if n.startswith("layers.")
                     for t in ts]
    for t in layer_tensors:
        t.register_post_accumulate_grad_hook(update)
    losses = []
    for i in range(steps):
        count[0] = i + 1
        stepped.clear()
        loss = model.loss(cfg, params, batches[i], prec, chunk)
        loss.backward()
        losses.append(float(loss.detach()))
        del loss
        for ts in groups.values():
            for t in ts:
                if id(t) not in stepped:
                    update(t)
    change: Dict[str, float] = {}
    with torch.no_grad():
        for path, *_ in weights.leaf_specs(cfg):
            start = weights.draw_leaf(cfg, seed, path, device)
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
