"""The port's MoE pipeline (``make_pipeline_train_step`` given a MoE
config) on gloo ranks against the reference's
``make_moe_pipeline_train_step`` on the same number of CPU devices, from
the same f32 parameters and tokens, as ``test_torch_pipeline_dense.py``
holds the dense pipeline: the loss to 1e-5 relative, the gathered
gradients to 1e-5 of each leaf's largest value and of its norm, the
leaves after one AdamW step to 2 * lr + 1e-6.

Both sides compute the reference's microbatched estimator of the router
aux loss: each (layer, microbatch) unit's aux on that microbatch's rows
(and, with ``seq_axis``, on one seq shard's positions, routed as groups
of their own), averaged over layers, microbatches and seq shards, on
every schedule (GPipe's over its valid ticks only).  The meshes: gpipe
and 1f1b at pipe 2 x expert 2, and 1f1b at pipe 2 x seq 2 with ring
attention and seq-local routing inside the stage, held to the
reference's GPipe step there (its 1F1B under a seq axis deadlocks now
and then on XLA's CPU backend; ``test_torch_pipeline_dense.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_dist_attention import run_ranks
from test_torch_pipeline_dense import _flat, hold, reference_step

LAYERS, BATCH, SEQ, MICRO = 4, 8, 32, 4
# name -> (mesh axes over 4 ranks, schedule, seq_axis)
CASES = {
    "gpipe_pipe2_expert2": (dict(pipe=2, expert=2, fsdp=1), "gpipe", None),
    "1f1b_pipe2_expert2": (dict(pipe=2, expert=2, fsdp=1), "1f1b", None),
    "1f1b_pipe2_seq2_ring": (dict(pipe=2, seq=2, fsdp=1), "1f1b", "seq"),
}


def _rank(rank, world, tree, tokens):
    from tpu_network_operator_torch.models import llama as tllama
    from tpu_network_operator_torch.models import moe as tmoe
    from tpu_network_operator_torch.parallel import make_mesh, plan_axes
    from tpu_network_operator_torch.parallel import pipeline as tpipe

    cfg = dataclasses.replace(tmoe.MoEConfig.tiny(), layers=LAYERS,
                              dtype=torch.float32)
    out = {}
    for name, (axes, schedule, seq_axis) in CASES.items():
        mesh = make_mesh(plan_axes(world, **axes), "cpu")
        step, _, opt = tpipe.make_pipeline_train_step(
            cfg, mesh, MICRO, seq_axis=seq_axis, schedule=schedule)
        params = tllama.shard_tree(tmoe.params_from_jax(tree, "cpu"),
                                   step.specs, mesh)
        rows = tpipe.microbatch_rows(torch.from_numpy(tokens), mesh, MICRO)
        _, grads = step.grads_fn(params, rows)
        grads = tllama.gather_tree(grads, step.specs, mesh)
        params, _, loss = step(params, opt.init(params), rows)
        new = tllama.gather_tree(params, step.specs, mesh)
        out[name] = dict(loss=loss.item(), params=None if rank else {
            k: v.numpy() for k, v in _flat(new).items()},
            grads=None if rank else {
                k: v.numpy() for k, v in _flat(grads).items()})
    return out


@pytest.fixture(scope="module")
def reference_params():
    """f32 tiny MoE parameters in the reference's layout, as numpy:
    normal / sqrt(fan in) from a seed (the router's f32 included), norm
    scales around 1."""
    rng = np.random.default_rng(17)
    h, f, n, e, vocab = 64, 128, LAYERS, 4, 256
    q, kv = 64, 32

    def w(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    def scale(shape):
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)

    return {
        "embed": w((vocab, h), h),
        "layers": {
            "wq": w((n, h, q), h), "wk": w((n, h, kv), h),
            "wv": w((n, h, kv), h), "wo": w((n, q, h), q),
            "router": w((n, h, e), h),
            "w_gate": w((n, e, h, f), h), "w_up": w((n, e, h, f), h),
            "w_down": w((n, e, f, h), f),
            "ln_attn": scale((n, h)), "ln_mlp": scale((n, h)),
        },
        "ln_final": scale((h,)),
        "lm_head": w((h, vocab), h),
    }


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(18).integers(0, 256, (BATCH, SEQ + 1),
                                              dtype=np.int32)


@pytest.fixture(scope="module")
def world4(reference_params, tokens):
    return run_ranks(4, _rank, reference_params, tokens)


def _jcfg():
    import jax.numpy as jnp

    from tpu_network_operator.models import moe as jmoe

    return dataclasses.replace(jmoe.MoEConfig.tiny(), layers=LAYERS,
                               dtype=jnp.float32)


@pytest.mark.parametrize("name", list(CASES))
def test_moe_pipeline_step_matches_reference(world4, reference_params,
                                             tokens, name):
    from tpu_network_operator.parallel import make_moe_pipeline_train_step

    axes, schedule, seq_axis = CASES[name]
    # the reference's 1F1B under a seq axis can deadlock on XLA's CPU
    # backend (the module's docstring); its GPipe computes the same loss
    # and gradients
    ref_schedule = "gpipe" if seq_axis else schedule
    ref = reference_step(make_moe_pipeline_train_step, _jcfg(), axes,
                         ref_schedule, seq_axis, reference_params, tokens)
    hold(world4[0][name], *ref, [r[name]["loss"] for r in world4])


def test_schedules_agree_and_the_aux_is_the_microbatched_estimator(
        world4, reference_params, tokens):
    """gpipe and 1f1b on one mesh give one loss (the same estimator), and
    it is not the batch aux of the plain MoE loss on the whole batch."""
    import jax
    import jax.numpy as jnp

    from tpu_network_operator.models import moe as jmoe

    gpipe = world4[0]["gpipe_pipe2_expert2"]["loss"]
    f1b = world4[0]["1f1b_pipe2_expert2"]["loss"]
    assert abs(gpipe - f1b) <= 1e-5 * abs(gpipe)
    params = jax.tree.map(jnp.asarray, reference_params)
    plain = float(jmoe.loss_fn(params, jnp.asarray(tokens), _jcfg()))
    assert abs(plain - gpipe) > 1e-5 * abs(gpipe)
