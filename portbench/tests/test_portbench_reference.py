"""The plain reference against the port at a tiny size, both in float32
on the same seeded draws: the loss and every leaf's gradient of a train
step (capacity routing with and without dropped tokens), and the logits
of a forward pass."""

from __future__ import annotations

import copy

import pytest
import torch

from portbench import weights
from portbench.drivers.train import port_config
from portbench.reference import model
from portbench.tests import tiny


def _port(cfg, family):
    from tpu_network_operator_torch.models import llama, moe

    pcfg = port_config(cfg, {"remat_policy": "full", "xent_chunk": 0})
    import dataclasses
    return (moe if family == "moe" else llama), dataclasses.replace(
        pcfg, dtype=torch.float32, remat=False)


def _stack(ts, shape):
    return torch.stack([t.grad for t in ts]).reshape(shape)


@pytest.mark.parametrize("name,cf", [("mixtral-8x7b-l4.train-8k", 1.25),
                                     ("mixtral-8x7b-l4.train-8k", 0.5),
                                     ("mistral-7b-l24.train-4k", None)])
def test_train_loss_and_grads(name, cf):
    _, cfg = tiny.cell(name)
    if cf is not None:
        cfg = copy.deepcopy(cfg)
        cfg["assumed"]["capacity_factor"] = cf
    fam, pcfg = _port(cfg, cfg["family"])
    draws = weights.draw(cfg, tiny.SEED, "cpu")
    tokens = weights.token_rows(tiny.SEED, 1, 2, 33, cfg["vocab_size"],
                                "cpu")[0]
    pp = {k: ({n: t.float().requires_grad_() for n, t in v.items()}
              if isinstance(v, dict) else v.float().requires_grad_())
          for k, v in draws.items()}
    loss = fam.loss_fn(pp, tokens, pcfg)
    loss.backward()
    ref = model.from_leaves(draws, requires_grad=True)
    rloss = model.loss(cfg, ref, tokens, chunk=16)
    rloss.backward()
    assert float(rloss) == pytest.approx(float(loss), rel=1e-5)
    groups = model.leaf_groups(ref)
    for path, p in weights.flat(pp).items():
        rg = _stack(groups[path], p.shape)
        err = float((rg - p.grad).norm() / p.grad.norm().clamp_min(1e-30))
        assert err < 1e-4, (path, err)


def test_decode_logits():
    _, cfg = tiny.cell("mistral-7b.decode-b128")
    fam, pcfg = _port(cfg, "dense")
    draws = weights.draw(cfg, tiny.SEED, "cpu")
    pp = {k: ({n: t.float() for n, t in v.items()} if isinstance(v, dict)
              else v.float()) for k, v in draws.items()}
    tokens = weights.token_rows(tiny.SEED, 1, 3, 24, cfg["vocab_size"],
                                "cpu")[0]
    with torch.no_grad():
        want = fam.forward(pp, tokens, pcfg)[:, 5:]
    got = model.logits_at(cfg, model.from_leaves(draws), tokens, slice(5, 24))
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-4)


def test_capacity_drops_tokens():
    """At capacity factor 0.5 the routing leaves tokens out, as the cut
    test above needs."""
    _, cfg = tiny.cell("mixtral-8x7b-l4.train-8k")
    probs = torch.softmax(torch.randn(2, 64, 4, generator=torch.Generator()
                                      .manual_seed(0)), -1)
    _, _, kept = model.route(probs, 2, 16)
    assert not bool(kept.all())
    assert int(kept.sum()) <= 2 * 4 * 16
