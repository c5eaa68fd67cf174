"""The pipeline's train state on gloo ranks: the 8-bit AdamW on
pipe-sharded leaves, and checkpoints of the pipeline's stored layouts.

One world of 4 ranks.  The state is a tiny 4-layer Llama's in f32 after
two updates from numpy gradients, on its shards of the pipeline's specs
(layer leaves over ``pipe`` on axis 0, or on axis 1 of the interleaved
``[v, L/v, ...]`` layout):

* ``adamw8bit`` built with the pipeline's specs steps every leaf as it
  steps it without the pipe axis (pipe never cuts the last dim, so
  ``mesh_leaf_plan`` is unchanged), and each rank's parameters, codes
  and scales are its slice of the single-device state's bits, at pipe 2
  x tensor 2 (flat layers) and pipe 2 x fsdp 2 (interleaved), as the
  reference's own test holds its pipeline with ``"adam8bit"``;
* a gpipe checkpoint at pipe 2 x fsdp 2 restores under the 1f1b
  builder's specs (the same flat layout) with the same bits, resumes
  there with the loss gpipe gives from the saved state, and restores on
  one device as the single-device bits; an interleaved checkpoint
  round-trips at its own layout, on the mesh and on one device.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_dist_adam8 import assert_same_bits
from test_torch_dist_attention import run_ranks
from test_torch_dist_checkpoint import whole_bits

LAYERS, STEPS, MICRO = 4, 2, 4
MESHES = {"pipe2_tensor2": dict(pipe=2, tensor=2, fsdp=1),
          "pipe2_fsdp2": dict(pipe=2, fsdp=2)}
# name -> (mesh, schedule)
ADAM8_CASES = {"1f1b_pipe2_tensor2": ("pipe2_tensor2", "1f1b"),
               "interleaved_pipe2_fsdp2": ("pipe2_fsdp2", "interleaved")}


def tcfg():
    from tpu_network_operator_torch.models import llama

    return dataclasses.replace(llama.LlamaConfig.tiny(), layers=LAYERS,
                               dtype=torch.float32)


def make_inputs():
    """f32 parameters and STEPS gradients (normal * 1e-2), numpy, in the
    reference's flat layout, and a batch of tokens."""
    from tpu_network_operator_torch.models import llama, training

    cfg = tcfg()
    whole = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(9)

    def tree(fn):
        return training.tree_map(lambda p: fn(tuple(p.shape)), whole)

    def param(shape):
        if len(shape) == 2 and shape[-1] == cfg.hidden and \
                shape[0] == LAYERS or len(shape) == 1:
            # the norm scales, [L, h] and [h]: around 1
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(
                np.float32)
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(
            np.float32)

    params = tree(param)
    grads = [tree(lambda s: (1e-2 * rng.standard_normal(s)).astype(
        np.float32)) for _ in range(STEPS)]
    tokens = rng.integers(0, cfg.vocab_size, (8, 17), dtype=np.int32)
    return params, grads, tokens


def _v(schedule):
    return 2 if schedule == "interleaved" else 1


def trained(name, params, grads, schedule, mesh=None):
    """(params, opt_state, specs pair): the tree in ``schedule``'s stored
    layout, or this rank's shards of it on ``mesh``, after one update per
    gradient of the ``name`` optimizer ("adam8bit" or "adamw")."""
    from tpu_network_operator_torch.models import llama, optim8bit, training
    from tpu_network_operator_torch.parallel import pipeline as tpipe

    cfg, v = tcfg(), _v(schedule)
    specs = tpipe.pipeline_specs(llama.param_specs(cfg), v)

    def tree(t):
        t = tpipe.chunked_layers(llama.params_from_jax(t, "cpu"), v)
        return t if mesh is None else llama.shard_tree(t, specs, mesh)

    opt = (optim8bit.adamw8bit(mesh=mesh, param_specs=specs if mesh else
                               None) if name == "adam8bit"
           else training.adamw(3e-4, weight_decay=0.1))
    p = tree(params)
    state = opt.init(p)
    for g in grads:
        opt.apply(p, list(training.tree_leaves(tree(g))), state)
    return p, state, (specs, opt.state_specs(p, specs)), opt


def _rank(rank, world, inputs, dirs):
    import torch.distributed as dist

    from tpu_network_operator_torch.models import training
    from tpu_network_operator_torch.models.checkpoint import TrainCheckpointer
    from tpu_network_operator_torch.models.optim8bit import mesh_leaf_plan
    from tpu_network_operator_torch.parallel import make_mesh, plan_axes
    from tpu_network_operator_torch.parallel import pipeline as tpipe
    from tpu_network_operator_torch.parallel.mesh import global_shape

    params, grads, tokens = inputs
    meshes = {n: make_mesh(plan_axes(world, **axes), "cpu")
              for n, axes in MESHES.items()}
    cfg = tcfg()
    out = {}
    for case, (mesh_name, schedule) in ADAM8_CASES.items():
        mesh = meshes[mesh_name]
        p, state, specs, opt = trained("adam8bit", params, grads, schedule,
                                       mesh)
        step, _, step_opt = tpipe.make_pipeline_train_step(
            cfg, mesh, MICRO, optimizer="adam8bit", schedule=schedule)
        bits = whole_bits(p, state, specs, mesh)    # every rank gathers
        out[case] = dict(
            bits=bits if rank == 0 else None,
            plans=opt.plans(p),
            # each leaf's plan with the pipe axis left out of its spec
            plain_plans=training.map_by_name(
                p, specs[0], lambda leaf, spec: mesh_leaf_plan(
                    mesh, tuple(None if a == "pipe" else a for a in spec),
                    global_shape(leaf.shape, spec, mesh.plan))),
            step_opt=(step_opt.mesh is mesh,
                      step_opt.param_specs == step.specs))

    mesh = meshes["pipe2_fsdp2"]
    for name in ("adam8bit", "adamw"):
        # gpipe's state saved; restored with the 1f1b builder's specs; one
        # step of each schedule from it
        p, state, specs, _ = trained(name, params, grads, "gpipe", mesh)
        saved = whole_bits(p, state, specs, mesh)
        with TrainCheckpointer(dirs[name]["flat"], mesh=mesh,
                               specs=specs) as ckpt:
            ckpt.save(STEPS, p, state)
        rows = tpipe.microbatch_rows(torch.from_numpy(tokens), mesh, MICRO)
        gstep, _, _ = tpipe.make_pipeline_train_step(
            cfg, mesh, MICRO, optimizer="adam8bit" if name == "adam8bit"
            else None, schedule="gpipe")
        fstep, finit, fopt = tpipe.make_pipeline_train_step(
            cfg, mesh, MICRO, optimizer="adam8bit" if name == "adam8bit"
            else None, schedule="1f1b")
        fp, fstate = finit(torch.Generator().manual_seed(5))
        with TrainCheckpointer(dirs[name]["flat"], mesh=mesh,
                               specs=(fstep.specs, fopt.state_specs(
                                   fp, fstep.specs))) as ckpt:
            at, fp, fstate = ckpt.restore((fp, fstate))
        restored = whole_bits(fp, fstate, specs, mesh)
        _, _, floss = fstep(fp, fstate, rows)
        _, _, gloss = gstep(p, state, rows)
        # the interleaved layout round-trips at its own layout
        ip, istate, ispecs, _ = trained(name, params, grads, "interleaved",
                                        mesh)
        isaved = whole_bits(ip, istate, ispecs, mesh)
        with TrainCheckpointer(dirs[name]["interleaved"], mesh=mesh,
                               specs=ispecs) as ckpt:
            ckpt.save(STEPS, ip, istate)
        tp, tstate, _, _ = trained(name, params, [], "interleaved", mesh)
        with TrainCheckpointer(dirs[name]["interleaved"], mesh=mesh,
                               specs=ispecs) as ckpt:
            iat, tp, tstate = ckpt.restore((tp, tstate))
        irestored = whole_bits(tp, tstate, ispecs, mesh)
        out[name] = dict(at=(at, iat), losses=(floss.item(), gloss.item()),
                         **{k: v if rank == 0 else None for k, v in dict(
                             saved=saved, restored=restored, isaved=isaved,
                             irestored=irestored).items()})
    dist.barrier()
    return out


@pytest.fixture(scope="module")
def inputs():
    return make_inputs()


@pytest.fixture(scope="module")
def single(inputs):
    """Per (optimizer, layout): the single-device state's bits after the
    two updates."""
    params, grads, _ = inputs
    return {(name, layout): whole_bits(*trained(name, params, grads,
                                                layout)[:2])
            for name in ("adam8bit", "adamw")
            for layout in ("gpipe", "interleaved")}


@pytest.fixture(scope="module")
def world4(inputs, tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    dirs = {name: {kind: str(root / name / kind)
                   for kind in ("flat", "interleaved")}
            for name in ("adam8bit", "adamw")}
    results = run_ranks(4, _rank, inputs, dirs,
                        store_dir=tmp_path_factory.mktemp("store"))
    return results, dirs


@pytest.mark.parametrize("case", list(ADAM8_CASES))
def test_adamw8bit_on_pipe_shards_is_the_single_device_bits(world4, single,
                                                            case):
    results, _ = world4
    layout = "interleaved" if case.startswith("interleaved") else "gpipe"
    assert_same_bits(results[0][case]["bits"], single[("adam8bit", layout)],
                     case)
    for r in results:
        got = r[case]
        # the pipe axis moves no leaf off its per-shard path
        assert got["plans"] == got["plain_plans"], case
        # the builder's "adam8bit" is built with the mesh and its specs
        assert got["step_opt"] == (True, True)


@pytest.mark.parametrize("name", ["adam8bit", "adamw"])
def test_gpipe_checkpoint_resumes_under_1f1b_with_the_same_bits(world4,
                                                                single,
                                                                name):
    results, _ = world4
    got = results[0][name]
    assert_same_bits(got["saved"], single[(name, "gpipe")], f"{name} saved")
    assert_same_bits(got["restored"], got["saved"], f"{name} under 1f1b")
    for r in results:
        assert r[name]["at"] == (STEPS, STEPS)
        floss, gloss = r[name]["losses"]
        assert abs(floss - gloss) <= 1e-6 * abs(gloss)


@pytest.mark.parametrize("name", ["adam8bit", "adamw"])
def test_pipeline_checkpoints_restore_on_one_device(world4, single, inputs,
                                                    name):
    from tpu_network_operator_torch.models.checkpoint import TrainCheckpointer

    _, dirs = world4
    params, _, _ = inputs
    for layout, kind in (("gpipe", "flat"), ("interleaved", "interleaved")):
        p, state, _, _ = trained(name, params, [], layout)
        with TrainCheckpointer(dirs[name][kind]) as ckpt:
            assert ckpt.all_steps() == [STEPS]
            at, p, state = ckpt.restore((p, state))
        assert at == STEPS
        assert_same_bits(whole_bits(p, state), single[(name, layout)],
                         f"{name} {layout} on one device")


@pytest.mark.parametrize("name", ["adam8bit", "adamw"])
def test_interleaved_checkpoint_round_trips_at_its_layout(world4, single,
                                                          name):
    results, _ = world4
    got = results[0][name]
    assert_same_bits(got["isaved"], single[(name, "interleaved")],
                     f"{name} interleaved saved")
    assert_same_bits(got["irestored"], got["isaved"],
                     f"{name} interleaved restored")
