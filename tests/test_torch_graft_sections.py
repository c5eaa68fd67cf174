"""The dry run's sections 1 and 1b (``graft.dryrun_rank``) on one world of
4 gloo ranks against the reference's ``make_train_step`` on the 4-device
CPU mesh, with the same plans (``graft.dryrun_plans(4)``), the same
constant tokens and the same parameters, in f32.

Section 1 is the tiny Llama with chunked cross entropy (16), optimizer
"adam8bit" and ring attention over seq 2 x tensor 2; section 1b the fused
geometry (hidden 512, 8/8 heads of 64, vocab 512) on that mesh at 128
positions, where the port's CPU attention is the flash kernel's blockwise
plain version.  The reference's side runs its jnp paths (no Pallas on the
CPU mesh); its attention for 1b is plain XLA attention.

Each section takes two steps on both sides: the first loss is computed
before any update, the second after the first step's gradient, ring
attention's backward and the 8-bit AdamW update on the shards.

Tolerance: each section's two losses (the global token mean) to 1e-5
relative (f32 summation order), as the sharded step is held in
``test_torch_dist_train.py``.  Section 1b holds there too: its tokens are
constant, so the values a query reads are one vector, and the flash plain
version's bf16 rounding of p only scales it by the rounded weights' sum
over their exact sum.

``test_torch_graft_pipeline.py`` holds sections 2, 2b and 3 and imports
this module's helpers; under ``--dist loadfile`` each file is one
worker's share.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_dist_attention import run_ranks

N = 4
HERE = ("1", "1b")


def section_trees(sections):
    """Section -> f32 parameters of its config in the reference's layout
    (numpy): the port's seeded init, the norm scales drawn around 1."""
    from tpu_network_operator_torch import graft
    from tpu_network_operator_torch.models import llama, moe

    cfgs = graft.section_configs(torch.float32)
    rng = np.random.default_rng(11)
    trees = {}
    for i, section in enumerate(sections):
        model = moe if section == "3" else llama
        tree = model.init_params(cfgs[section],
                                 torch.Generator().manual_seed(20 + i),
                                 "cpu")

        def leaf(name, t):
            if name.startswith("ln"):
                return (1.0 + 0.1 * rng.standard_normal(t.shape)).astype(
                    np.float32)
            return t.numpy()

        trees[section] = {
            k: ({n: leaf(n, t) for n, t in v.items()}
                if isinstance(v, dict) else leaf(k, v))
            for k, v in tree.items()}
    return trees


def sections_rank(rank, world, trees, sections):
    from tpu_network_operator_torch import graft

    return graft.dryrun_rank(world, "cpu", trees, torch.float32, sections)


def run_sections(sections):
    trees = section_trees(sections)
    results = run_ranks(N, sections_rank, trees, sections)
    return trees, results


def reference_cfg(section):
    """The reference's config of ``section``, in f32."""
    import jax.numpy as jnp

    from tpu_network_operator.models import llama as jllama
    from tpu_network_operator.models import moe as jmoe

    tiny = jllama.LlamaConfig.tiny()
    cfg = {
        "1": dataclasses.replace(tiny, xent_chunk=16),
        "1b": jllama.LlamaConfig(vocab_size=512, hidden=512, layers=2,
                                 heads=8, kv_heads=8, ffn=1024, max_seq=128,
                                 remat=False),
        "2": tiny,
        "2b": dataclasses.replace(tiny, layers=4),
        "3": jmoe.MoEConfig.tiny(),
    }[section]
    return dataclasses.replace(cfg, dtype=jnp.float32)


def reference_mesh(section):
    import jax

    from tpu_network_operator.parallel import make_mesh, plan_axes
    from tpu_network_operator_torch import graft

    sizes = graft.dryrun_plans(N)[section].axis_sizes
    return make_mesh(plan_axes(N, **sizes), devices=jax.devices()[:N])


def reference_inputs(section, tree):
    import jax
    import jax.numpy as jnp

    from tpu_network_operator_torch import graft

    tokens = graft.section_tokens(section, graft.dryrun_plans(N)[section])
    return (jax.tree.map(jnp.asarray, tree),
            jnp.asarray(tokens.numpy().astype(np.int32)))


def reference_two_steps(step, opt, section, tree):
    """The losses of the reference's ``step`` taken twice from ``tree`` on
    the section's tokens."""
    params, tokens = reference_inputs(section, tree)
    state, losses = opt.init(params), []
    for _ in range(2):
        params, state, loss = step(params, state, tokens)
        losses.append(float(loss))
    return losses


def reference_dense_losses(section, tree):
    """The reference's two losses of section 1 or 1b:
    ``make_train_step(cfg, mesh, optimizer="adam8bit", attn_fn=ring)``."""
    from tpu_network_operator.models import make_train_step
    from tpu_network_operator.parallel.ring import make_ring_attn_fn

    mesh = reference_mesh(section)
    seq = dict(zip(mesh.axis_names, mesh.devices.shape))["seq"]
    step, _, opt = make_train_step(
        reference_cfg(section), mesh, optimizer="adam8bit",
        attn_fn=make_ring_attn_fn(mesh) if seq > 1 else None)
    return reference_two_steps(step, opt, section, tree)


def hold(got, want):
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def hold_steps(res, want):
    """A section's (first, second) losses held to the reference's two."""
    hold(res["loss"], want[0])
    hold(res["next_loss"], want[1])


@pytest.fixture(scope="module")
def world():
    return run_sections(HERE)


def test_every_rank_reports_the_same_sections(world):
    from tpu_network_operator_torch import graft

    _, results = world
    for r in results:
        assert list(r["sections"]) == list(HERE)
        assert r["lines"][-1] == graft.OK_LINE
        for section in HERE:
            for key in ("loss", "next_loss"):
                assert r["sections"][section][key] == \
                    results[0]["sections"][section][key]
            assert r["sections"][section]["plan"] == \
                graft.dryrun_plans(N)[section].axis_sizes


@pytest.mark.parametrize("section", HERE)
def test_dense_section_matches_reference(world, section):
    trees, results = world
    hold_steps(results[0]["sections"][section],
               reference_dense_losses(section, trees[section]))
