"""The port's model families behind one decoder skeleton, on the CPU.

The config's type picks the family (``convert.model``): its ``Layout``
supplies the block, the mesh draw and the specs, and the skeleton on
``llama.Layout`` does the rest for both.  Over a dense config, a MoE of
capacity routing, a hybrid MoE of dropless routing with sliding windows
and a hybrid dense config with sliding windows:

* the chooser returns each config's family;
* the one ``make_train_step`` takes every case and trains it (a finite
  loss, the family's ``loss_fn`` of the same tree, every leaf updated);
* the one ``make_pipeline_train_step``, 2 stages held in one process,
  draws the plain step's tree and gives the plain step's loss and
  gradients within 1e-5 in f32 (one microbatch, so the MoE's
  microbatched aux estimator is the plain step's aux);
* the windowed cases meet the pipeline's named refusal
  (``llama.check_no_window``).
"""

import dataclasses

import pytest
import torch

from tpu_network_operator_torch.models import convert, llama, moe, training
from tpu_network_operator_torch.parallel import pipeline

WINDOWS = dict(layer_types=(llama.SLIDING, llama.FULL), sliding_window=4)


def _case(name):
    """(config, its family's module), f32 at tiny size."""
    if name == "dense":
        cfg, mod = llama.LlamaConfig.tiny(), llama
    elif name == "moe_capacity":
        cfg, mod = moe.MoEConfig.tiny(), moe
    elif name == "hybrid_moe_dropless":
        cfg = moe.HybridMoEConfig(**dataclasses.asdict(moe.MoEConfig.tiny()),
                                  routing="dropless", **WINDOWS)
        mod = moe
    else:
        cfg = llama.HybridLlamaConfig(
            **dataclasses.asdict(llama.LlamaConfig.tiny()), **WINDOWS)
        mod = llama
    return dataclasses.replace(cfg, dtype=torch.float32), mod


CASES = ["dense", "moe_capacity", "hybrid_moe_dropless", "hybrid_dense"]
WINDOWED = ["hybrid_moe_dropless", "hybrid_dense"]


class _Recorder:
    """AdamW that keeps the gradients each step hands it."""

    def __init__(self):
        self.inner, self.grads = training.adamw(), []

    def init(self, params):
        return self.inner.init(params)

    def apply(self, params, grads, state):
        self.grads.append([g.detach().clone() for g in grads])
        return self.inner.apply(params, grads, state)


def _tokens(cfg, batch=4, seq=16):
    return torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                         generator=torch.Generator().manual_seed(1))


@pytest.mark.parametrize("name", CASES)
def test_the_config_type_picks_the_family(name):
    cfg, mod = _case(name)
    assert convert.model(cfg) is mod
    assert convert.family(cfg) == mod.__name__.rsplit(".", 1)[1]
    assert isinstance(mod.Layout(cfg), mod.Layout)
    assert convert.param_specs(cfg) == mod.param_specs(cfg)


@pytest.mark.parametrize("name", CASES)
def test_one_train_step_takes_every_family(name):
    cfg, mod = _case(name)
    assert mod.make_train_step is llama.make_train_step
    step, init_all, _ = llama.make_train_step(cfg, device="cpu")
    params, state = init_all(torch.Generator().manual_seed(0))
    before = [p.detach().clone() for p in training.tree_leaves(params)]
    with torch.no_grad():
        want = mod.loss_fn(params, _tokens(cfg), cfg)
    params, state, loss = step(params, state, _tokens(cfg))
    assert torch.isfinite(loss) and loss.item() == want.item()
    for old, new in zip(before, training.tree_leaves(params)):
        assert not torch.equal(old, new)


@pytest.mark.parametrize("name", ["dense", "moe_capacity"])
def test_one_pipeline_step_gives_the_plain_step(name):
    cfg, _ = _case(name)
    cfg = dataclasses.replace(cfg, remat=True)
    tokens = _tokens(cfg)
    rec = _Recorder()
    plain, plain_init, _ = llama.make_train_step(cfg, optimizer=rec,
                                                 device="cpu")
    params, state = plain_init(torch.Generator().manual_seed(0))
    step, init_all, _ = pipeline.make_pipeline_train_step(
        cfg, None, 1, schedule="1f1b", device="cpu", stages_in_process=2)
    staged, _ = init_all(torch.Generator().manual_seed(0))
    for a, b in zip(training.tree_leaves(staged),
                    training.tree_leaves(params)):
        assert torch.equal(a, b)
    loss, grads = step.grads_fn(staged, tokens)
    _, _, want = plain(params, state, tokens)
    assert abs(loss.item() - want.item()) <= 1e-5 * abs(want.item())
    for got, ref in zip(training.tree_leaves(grads), rec.grads[0]):
        big = ref.abs().max().item()
        assert (got - ref).abs().max().item() <= 1e-5 * big


@pytest.mark.parametrize("name", WINDOWED)
def test_the_pipeline_refuses_windowed_configs(name):
    cfg, _ = _case(name)
    llama.make_train_step(cfg, device="cpu")      # the plain step takes it
    with pytest.raises(ValueError, match="sliding-window.*pipeline stage"):
        pipeline.make_pipeline_train_step(cfg, None, 2, device="cpu",
                                          stages_in_process=2)
