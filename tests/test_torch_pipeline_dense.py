"""The port's Llama pipeline on gloo ranks against the reference's
``make_pipeline_train_step`` on the same number of CPU devices, from the
same f32 parameters and tokens.

One world of 4 ranks runs every case: each rank builds the mesh, keeps
its shards of the reference's parameters by the pipeline's specs (layer
leaves over ``pipe``: axis 0, or axis 1 of the interleaved ``[v, L/v,
...]`` layout), takes its rows of every microbatch and makes one step of
each schedule.  The parent holds the port to the reference:

* the loss, to 1e-5 relative;
* the gradients, gathered whole, to 1e-5 of each leaf's largest value
  and of its norm.  The reference's gradients are read from an optimizer
  chain whose first link keeps them in its state and passes them on
  unchanged (Adam's first step moves a weight by about ``lr * sign(g)``,
  so the updated leaves alone would hide a gradient summed twice);
* the leaves after one AdamW step, to 2 * lr absolute plus 1e-6, as the
  sharded step is held (``test_torch_dist_train.py``).

The meshes: gpipe at pipe 2 x fsdp 2, 1f1b at pipe 2 x tensor 2,
interleaved (v 2) at pipe 2 x fsdp 2, 1f1b at pipe 2 x seq 2 with ring
attention inside the stage, gpipe at pipe 4.

The port's 1f1b over pipe 2 x seq 2 is held to the reference's GPipe step
on that mesh, which computes the same loss and gradients (the
reference's own tests hold its two schedules together there).  The
reference's 1F1B under a seq axis deadlocks now and then on XLA's CPU
backend: two devices wait in an all-reduce and two in a collective
permute until the rendezvous aborts the process, in 1 of 3 dense and 2
of 3 MoE runs of its step here, where its GPipe ran 6 of 6.  Its
refusal of a sequence the seq axis does not divide is raised while
tracing, before any collective, and is held as it is.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_dist_attention import run_ranks

LR = 3e-4
LAYERS, BATCH, SEQ, MICRO = 4, 8, 32, 4
# name -> (mesh axes over 4 ranks, schedule, seq_axis)
CASES = {
    "gpipe_pipe2_fsdp2": (dict(pipe=2, fsdp=2), "gpipe", None),
    "1f1b_pipe2_tensor2": (dict(pipe=2, tensor=2, fsdp=1), "1f1b", None),
    "interleaved_pipe2_fsdp2": (dict(pipe=2, fsdp=2), "interleaved", None),
    "1f1b_pipe2_seq2_ring": (dict(pipe=2, seq=2, fsdp=1), "1f1b", "seq"),
    "gpipe_pipe4": (dict(pipe=4, fsdp=1), "gpipe", None),
}


def _flat(tree, prefix=""):
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(_flat(v, f"{prefix}{k}/"))
        else:
            flat[prefix + k] = v
    return flat


def _stored(tree, schedule):
    """The reference tree in the schedule's stored layout (numpy)."""
    if schedule != "interleaved":
        return tree
    return {**tree, "layers": {k: a.reshape((2, a.shape[0] // 2)
                                            + a.shape[1:])
                               for k, a in tree["layers"].items()}}


def _rank(rank, world, tree, tokens):
    from tpu_network_operator_torch.models import llama as tllama
    from tpu_network_operator_torch.parallel import make_mesh, plan_axes
    from tpu_network_operator_torch.parallel import pipeline as tpipe

    cfg = dataclasses.replace(tllama.LlamaConfig.tiny(), layers=LAYERS,
                              dtype=torch.float32)
    out = {}
    for name, (axes, schedule, seq_axis) in CASES.items():
        mesh = make_mesh(plan_axes(world, **axes), "cpu")
        step, _, opt = tpipe.make_pipeline_train_step(
            cfg, mesh, MICRO, seq_axis=seq_axis, schedule=schedule,
            virtual_stages=2)
        whole = tllama.params_from_jax(_stored(tree, schedule), "cpu")
        params = tllama.shard_tree(whole, step.specs, mesh)
        rows = tpipe.microbatch_rows(torch.from_numpy(tokens), mesh, MICRO)
        _, grads = step.grads_fn(params, rows)
        grads = tllama.gather_tree(grads, step.specs, mesh)
        params, _, loss = step(params, opt.init(params), rows)
        new = tllama.gather_tree(params, step.specs, mesh)
        out[name] = dict(loss=loss.item(), params=None if rank else {
            k: v.numpy() for k, v in _flat(new).items()},
            grads=None if rank else {
                k: v.numpy() for k, v in _flat(grads).items()})
        if seq_axis:
            try:
                step.grads_fn(params, rows[:, :-1])
            except ValueError as e:
                out[name]["seq_refusal"] = str(e)
    return out


@pytest.fixture(scope="module")
def reference_params():
    """f32 tiny Llama parameters in the reference's layout, as numpy,
    which both packages take: normal / sqrt(fan in) from a seed, norm
    scales around 1."""
    rng = np.random.default_rng(7)
    h, f, n, vocab = 64, 128, LAYERS, 256
    q, kv = 64, 32                      # 4 heads, 2 kv heads of 16

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
            "w_gate": w((n, h, f), h), "w_up": w((n, h, f), h),
            "w_down": w((n, f, h), f),
            "ln_attn": scale((n, h)), "ln_mlp": scale((n, h)),
        },
        "ln_final": scale((h,)),
        "lm_head": w((h, vocab), h),
    }


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(8).integers(0, 256, (BATCH, SEQ + 1),
                                             dtype=np.int32)


@pytest.fixture(scope="module")
def world4(reference_params, tokens, tmp_path_factory):
    return run_ranks(4, _rank, reference_params, tokens,
                     store_dir=tmp_path_factory.mktemp("store"))


def _jcfg():
    import jax.numpy as jnp

    from tpu_network_operator.models import llama as jllama

    return dataclasses.replace(jllama.LlamaConfig.tiny(), layers=LAYERS,
                               dtype=jnp.float32)


def keep_grads():
    """An optax link that keeps the gradients it is given in its state
    and passes them on unchanged."""
    import jax
    import jax.numpy as jnp
    import optax

    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))


def reference_step(make, cfg, axes, schedule, seq_axis, tree, tokens):
    """(loss, grads, updated leaves) of one reference pipeline step with
    AdamW(3e-4, wd 0.1), numpy and flat."""
    import jax
    import jax.numpy as jnp
    import optax

    from tpu_network_operator.parallel import make_mesh, plan_axes

    mesh = make_mesh(plan_axes(4, **axes), devices=jax.devices()[:4])
    step, _, opt = make(
        cfg, mesh, n_microbatches=MICRO,
        optimizer=optax.chain(keep_grads(), optax.adamw(
            LR, weight_decay=0.1)),
        seq_axis=seq_axis, schedule=schedule, virtual_stages=2)
    params = jax.tree.map(jnp.asarray, _stored(tree, schedule))
    new, state, loss = step(params, opt.init(params), jnp.asarray(tokens))
    as_np = lambda t: {k: np.asarray(v)           # noqa: E731
                       for k, v in _flat(jax.tree.map(np.asarray,
                                                      t)).items()}
    return float(loss), as_np(state[0]), as_np(new)


def hold(port, ref_loss, ref_grads, ref_new, losses):
    """The port's case result against the reference's."""
    for loss in losses:
        assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss), (loss, ref_loss)
    for key, g in port["grads"].items():
        r = ref_grads[key]
        assert g.shape == r.shape, key
        assert np.abs(g - r).max() <= 1e-5 * np.abs(r).max(), key
        assert np.linalg.norm(g - r) <= 1e-5 * np.linalg.norm(r), key
    for key, p in port["params"].items():
        np.testing.assert_allclose(p, ref_new[key], rtol=0,
                                   atol=2 * LR + 1e-6, err_msg=key)


@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_step_matches_reference(world4, reference_params, tokens,
                                         name):
    from tpu_network_operator.parallel import make_pipeline_train_step

    axes, schedule, seq_axis = CASES[name]
    # the reference's 1F1B under a seq axis can deadlock on XLA's CPU
    # backend (see the module's docstring); its GPipe computes the same
    # loss and gradients
    ref_schedule = "gpipe" if seq_axis else schedule
    ref = reference_step(make_pipeline_train_step, _jcfg(), axes,
                         ref_schedule, seq_axis, reference_params, tokens)
    hold(world4[0][name], *ref, [r[name]["loss"] for r in world4])


def test_seq_refusal_is_the_reference_message(world4, reference_params,
                                              tokens):
    """A sequence the seq axis does not divide: the 1F1B grads_fn's
    message (traced, not compiled, on the reference's side)."""
    import jax
    import jax.numpy as jnp

    from tpu_network_operator.parallel import (make_mesh,
                                               make_pipeline_train_step,
                                               plan_axes)

    axes, schedule, seq_axis = CASES["1f1b_pipe2_seq2_ring"]
    mesh = make_mesh(plan_axes(4, **axes), devices=jax.devices()[:4])
    step, _, opt = make_pipeline_train_step(
        _jcfg(), mesh, n_microbatches=MICRO, seq_axis=seq_axis,
        schedule=schedule)
    params = jax.tree.map(jnp.asarray, reference_params)
    with pytest.raises(ValueError) as e:
        step(params, opt.init(params), jnp.asarray(tokens[:, :-1]))
    for r in world4:
        assert r["1f1b_pipe2_seq2_ring"]["seq_refusal"] == str(e.value)
