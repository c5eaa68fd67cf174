"""The port's mirror of ``__graft_entry__.py`` (``graft.py``): the dry
run's mesh plans, ``entry()`` against the reference's, the dry run whole
on 4 gloo ranks, and the launcher's refusals.

The sections' losses are held to the reference's steps in
``test_torch_graft_sections.py`` (1 and 1b) and
``test_torch_graft_pipeline.py`` (2, 2b and 3).

``entry()``'s forward at 2 layers in f32 is held to the reference's with
its Pallas kernels in interpret mode (head_dim 64 at 128 positions passes
the flash gate on both sides; routed as ``test_torch_llama.py`` routes
them): both round q * scale and p to bf16 where the flash kernel does, so
the tolerance is that file's f32 flash budget, 6e-3 absolute (a 1-ulp flip
of one bf16 p between two f32 summation orders carries through the second
layer), and 1e-5 on the rows whose attention reads one key (the first
position of each row, where p is exactly 1).
"""

import dataclasses
import functools
import multiprocessing

import numpy as np
import pytest
import torch

# n -> section -> the plan's axis sizes, derived by hand from
# __graft_entry__.py's arithmetic (section 1 and 1b share their mesh)
PLANS = {
    1: {"1": dict(data=1, fsdp=1, seq=1, tensor=1),
        "2": dict(pipe=1, seq=1, tensor=1, data=1, fsdp=1),
        "2b": None,
        "3": dict(expert=1, seq=1, data=1, fsdp=1)},
    2: {"1": dict(data=1, fsdp=1, seq=1, tensor=2),
        "2": dict(pipe=2, seq=1, tensor=1, data=1, fsdp=1),
        "2b": dict(pipe=2, seq=1, tensor=1, data=1, fsdp=1),
        "3": dict(expert=2, seq=1, data=1, fsdp=1)},
    4: {"1": dict(data=1, fsdp=1, seq=2, tensor=2),
        "2": dict(pipe=2, seq=2, tensor=1, data=1, fsdp=1),
        "2b": dict(pipe=2, seq=2, tensor=1, data=1, fsdp=1),
        "3": dict(expert=4, seq=1, data=1, fsdp=1)},
    8: {"1": dict(data=1, fsdp=2, seq=2, tensor=2),
        "2": dict(pipe=2, seq=2, tensor=2, data=1, fsdp=1),
        "2b": dict(pipe=2, seq=2, tensor=2, data=1, fsdp=1),
        "3": dict(expert=4, seq=2, data=1, fsdp=1)},
}
ALL_AXES = dict(data=1, fsdp=1, pipe=1, expert=1, seq=1, tensor=1)


@pytest.mark.parametrize("n", sorted(PLANS))
def test_dryrun_plans_are_the_reference_arithmetic(n):
    from tpu_network_operator_torch import graft

    plans = graft.dryrun_plans(n)
    assert set(plans) == set(graft.SECTIONS)
    want = {**PLANS[n], "1b": PLANS[n]["1"]}
    for section, sizes in want.items():
        plan = plans[section]
        if sizes is None:
            assert plan is None, section
            continue
        assert plan.axis_sizes == {**ALL_AXES, **sizes}, (n, section)
        assert plan.size() == n


def _reference_entry_cfg(monkeypatch):
    """The config inside the reference's ``entry()`` (its ``fn`` closes
    over it), with its parameter draw stubbed out (the config is what is
    compared; the draw takes seconds)."""
    import __graft_entry__
    from tpu_network_operator import models

    monkeypatch.setattr(models, "init_params", lambda key, cfg: None)
    fn, _ = __graft_entry__.entry()
    cells = dict(zip(fn.__code__.co_freevars,
                     (c.cell_contents for c in fn.__closure__)))
    return cells["cfg"]


def test_entry_config_is_the_reference_config(monkeypatch):
    from tpu_network_operator_torch import graft

    ref = _reference_entry_cfg(monkeypatch)
    cfg = graft.entry_config()
    names = [f.name for f in dataclasses.fields(ref)]
    assert names == [f.name for f in dataclasses.fields(cfg)]
    for name in names:
        if name == "dtype":
            assert str(np.dtype(getattr(ref, name))) == "bfloat16"
            assert cfg.dtype == torch.bfloat16
        else:
            assert getattr(cfg, name) == getattr(ref, name), name
    assert cfg.head_dim == 64


def test_entry_returns_the_flagship_forward_and_its_arguments(monkeypatch):
    """``entry()``'s forward, tokens and parameters, seeded."""
    from tpu_network_operator_torch import graft
    from tpu_network_operator_torch.models import llama

    # the full tree takes seconds to draw on the CPU: one layer and a
    # smaller vocabulary draw the same way
    cfg = dataclasses.replace(graft.entry_config(), layers=1,
                              vocab_size=1024)
    monkeypatch.setattr(graft, "entry_config", lambda: cfg)
    fn, (params, tokens) = graft.entry(device="cpu")
    assert fn.keywords["cfg"] == cfg and fn.func is llama.forward
    assert tokens.shape == (2, 128) and bool((tokens == 1).all())
    want = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for name, leaf in llama.unbind_layers(want)[0].items():
        assert torch.equal(params["layers"][name][0], leaf), name
    assert torch.equal(params["lm_head"], want["lm_head"])


@pytest.fixture(scope="module")
def entry_weights():
    """f32 parameters of ``entry()``'s config cut to 2 layers, numpy in
    the reference's layout: normal / sqrt(fan in), norm scales around 1."""
    from tpu_network_operator_torch import graft

    cfg = graft.entry_config()
    rng = np.random.default_rng(4)
    h, f, n, q = cfg.hidden, cfg.ffn, 2, cfg.heads * cfg.head_dim
    kv = cfg.kv_heads * cfg.head_dim

    def w(shape, fan_in):
        return (rng.standard_normal(shape, dtype=np.float32)
                / np.float32(np.sqrt(fan_in)))

    def scale(shape):
        return 1.0 + 0.1 * rng.standard_normal(shape, dtype=np.float32)

    return {
        "embed": w((cfg.vocab_size, h), h),
        "layers": {
            "wq": w((n, h, q), h), "wk": w((n, h, kv), h),
            "wv": w((n, h, kv), h), "wo": w((n, q, h), q),
            "w_gate": w((n, h, f), h), "w_up": w((n, h, f), h),
            "w_down": w((n, f, h), f),
            "ln_attn": scale((n, h)), "ln_mlp": scale((n, h)),
        },
        "ln_final": scale((h,)),
        "lm_head": w((h, cfg.vocab_size), h),
    }


@pytest.fixture
def jax_kernels(monkeypatch):
    """Route the JAX model through its Pallas kernels (interpret mode)."""
    from tpu_network_operator.models import llama as jllama

    monkeypatch.setattr(jllama, "_backend", lambda: "tpu", raising=True)
    monkeypatch.setenv("TPUNET_RMS_FUSED", "1")


@pytest.mark.parametrize("tokens", ["ones", "random"])
def test_entry_forward_matches_reference(jax_kernels, entry_weights,
                                         tokens):
    import jax
    import jax.numpy as jnp

    from tpu_network_operator.models import llama as jllama
    from tpu_network_operator_torch import graft
    from tpu_network_operator_torch.models import llama

    cfg = dataclasses.replace(graft.entry_config(), layers=2,
                              dtype=torch.float32)
    jcfg = dataclasses.replace(_reference_cfg_of(cfg), dtype=jnp.float32)
    toks = (np.ones((2, 128), np.int32) if tokens == "ones" else
            np.random.default_rng(5).integers(0, 32_000, (2, 128),
                                              dtype=np.int32))
    # one compile for both token sets: the config is a static argument
    want = np.asarray(_reference_forward()(
        jax.tree.map(jnp.asarray, entry_weights), jnp.asarray(toks), jcfg))
    # entry()'s fn is llama.forward with its config bound (held above)
    got = llama.forward(llama.params_from_jax(entry_weights, "cpu"),
                        torch.from_numpy(toks).long(), cfg).numpy()
    assert got.shape == (2, 128, 32_000)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=6e-3)


@functools.lru_cache(maxsize=None)
def _reference_forward():
    import jax

    from tpu_network_operator.models import llama as jllama

    return jax.jit(jllama.forward, static_argnums=2)


def _reference_cfg_of(cfg):
    from tpu_network_operator.models import llama as jllama

    return jllama.LlamaConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
        if f.name != "dtype"})


def test_dryrun_multichip_on_4_gloo_ranks(capsys):
    """The whole dry run on 4 gloo ranks: every section's line, the OK
    line last, and the launcher leaves no process behind."""
    from tpu_network_operator_torch import graft

    result = graft.dryrun_multichip(4, device="cpu", timeout=240)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == graft.OK_LINE
    assert lines == result["lines"]
    assert [ln.split(":")[0] for ln in lines[:-1]] == [
        "dryrun dense dp/fsdp/sp/tp (chunked xent, adam8bit)",
        "dryrun fused-kernel mesh (rmsnorm+flash+adam8 kernels)",
        "dryrun pipeline pp/sp/tp/dp",
        "dryrun pipeline 1f1b+interleaved (sp=2)",
        "dryrun moe ep/sp/dp"]
    sections = result["sections"]
    assert list(sections) == list(graft.SECTIONS)
    for section, res in sections.items():
        for key in ("loss", "next_loss"):
            assert np.isfinite(res[key]) and 0 < res[key] < 20, section
        assert res["plan"] == {**ALL_AXES, **PLANS[4][section if section
                                                      != "1b" else "1"]}
        assert all(v == 0 for v in res["launches"].values()), section
    for key in ("losses", "next_losses"):
        assert set(sections["2b"][key]) == set(graft.SCHEDULES)
    assert not multiprocessing.active_children()


def test_dryrun_multichip_refuses_without_enough_cards(monkeypatch):
    from tpu_network_operator_torch import graft

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft.dryrun_multichip(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft.entry()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError,
                       match=r"dryrun_multichip\(2\) needs 2 CUDA devices"):
        graft.dryrun_multichip(2)
