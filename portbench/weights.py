"""Seeded inputs shared by the program and the reference: the weights in
the port's layout (stacked ``[L, ...]`` layer leaves, ``x @ W``, expert
leaves ``[L, E, in, out]``) and the token rows.

Each leaf is one ``randn`` on the device in the dtype it is served in,
from a generator seeded by the run's seed and the leaf's index, scaled
by 1/sqrt(fan_in); norm weights are ones.  So any leaf can be drawn again
alone, bit for bit, on the same kind of device: the reference and the
check of the parameters' change draw the starting weights that way.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

MASK = (1 << 63) - 1


def mix(seed: int, *salt: int) -> int:
    """A generator seed from the run's seed (any size) and small salts."""
    x = int(seed) & MASK
    for s in salt:
        x = (x * 0x9E3779B97F4A7C15 + 0x632BE59BD9B4E019 * (s + 1)) & MASK
    return x


def generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def leaf_specs(cfg: Dict) -> List[Tuple[str, tuple, Optional[int], torch.dtype]]:
    """(path, shape, fan_in or None for ones, dtype) of every leaf, in the
    port's tree order."""
    h, f, n = cfg["hidden_size"], cfg["intermediate_size"], \
        cfg["num_hidden_layers"]
    hq, hkv, d = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    v = cfg["vocab_size"]
    bf = torch.bfloat16
    layers = [("wq", (n, h, hq * d), h, bf), ("wk", (n, h, hkv * d), h, bf),
              ("wv", (n, h, hkv * d), h, bf), ("wo", (n, hq * d, h), hq * d, bf)]
    if cfg["family"] == "moe":
        e = cfg["num_local_experts"]
        layers += [("router", (n, h, e), h, torch.float32),
                   ("w_gate", (n, e, h, f), h, bf), ("w_up", (n, e, h, f), h, bf),
                   ("w_down", (n, e, f, h), f, bf)]
    else:
        layers += [("w_gate", (n, h, f), h, bf), ("w_up", (n, h, f), h, bf),
                   ("w_down", (n, f, h), f, bf)]
    layers += [("ln_attn", (n, h), None, bf), ("ln_mlp", (n, h), None, bf)]
    return ([("embed", (v, h), h, bf)]
            + [(f"layers.{name}", *rest) for name, *rest in layers]
            + [("ln_final", (h,), None, bf), ("lm_head", (h, v), h, bf)])


def draw_leaf(cfg: Dict, seed: int, path: str, device) -> torch.Tensor:
    """The starting value of one leaf."""
    for i, (p, shape, fan_in, dtype) in enumerate(leaf_specs(cfg)):
        if p == path:
            if fan_in is None:
                return torch.ones(shape, dtype=dtype, device=device)
            w = torch.randn(shape, generator=generator(device, mix(seed, i)),
                            dtype=dtype, device=device)
            return w.mul_(1.0 / math.sqrt(fan_in))
    raise KeyError(path)


def draw(cfg: Dict, seed: int, device) -> Dict:
    """Every leaf, as the port's nested tree."""
    tree: Dict = {}
    for path, *_ in leaf_specs(cfg):
        node = tree
        *outer, last = path.split(".")
        for key in outer:
            node = node.setdefault(key, {})
        node[last] = draw_leaf(cfg, seed, path, device)
    return tree


def flat(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A nested tree's leaves by dotted path, in tree order."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def token_rows(seed: int, n: int, rows: int, length: int, vocab: int,
               device, salt: int = 1) -> torch.Tensor:
    """[n, rows, length] int64 token ids, uniform over the vocabulary."""
    g = generator(device, mix(seed, 1 << 20, salt))
    return torch.randint(0, vocab, (n, rows, length), generator=g,
                         device=device)
