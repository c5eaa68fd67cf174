"""The port's train checkpoints on a mesh, on gloo ranks: each rank's
shards saved as DTensors through ``torch.distributed.checkpoint`` and
restored onto another mesh shape of the same world, onto one device, and
from one device, for the 8-bit AdamW and the AdamW states, bit for bit; a
save that fails on one rank.  ``test_torch_dist_resume.py`` drives the
same through the workload CLI.

The state is ``LlamaConfig.tiny(vocab=512)``'s in f32 after two updates
from numpy gradients (``test_torch_dist_adam8.py``'s inputs), so the
moments and scales are not the init's.  The single-device port's state of
the same two updates is the reference every gathered state is held to:
the sharded updates give its bits (``test_torch_dist_adam8.py``), so any
bit a save or a restore moved shows.  Between ``fsdp4`` and
``tensor2_fsdp2`` the 8-bit state's embed and attention leaves change
path (per shard at ``fsdp4``, global blocks cut by tensor at
``tensor2_fsdp2``), so their scales restore from a split tensor into a
replicated one and back.
"""

import os

import pytest
import torch

from test_torch_dist_adam8 import (MESHES, assert_same_bits, bits,
                                   make_inputs, tcfg)
from test_torch_dist_attention import run_ranks

OPTIMIZERS = ("adam8bit", "adamw")


def optimizer(name, mesh=None, specs=None):
    from tpu_network_operator_torch.models import optim8bit, training

    if name == "adam8bit":
        return optim8bit.adamw8bit(mesh=mesh, param_specs=specs)
    return training.adamw(3e-4, weight_decay=0.1)


def trained(name, params, grads, mesh=None):
    """(params, opt_state, opt, specs): the tiny tree, or this rank's
    shards of it on ``mesh``, after one update per gradient."""
    from tpu_network_operator_torch.models import llama, training

    cfg = tcfg("llama")
    specs = llama.param_specs(cfg)
    opt = optimizer(name, mesh, specs if mesh is not None else None)

    def tree(t):
        t = llama.params_from_jax(t, "cpu")
        return t if mesh is None else llama.shard_params(t, cfg, mesh)

    p = tree(params)
    state = opt.init(p)
    for g in grads:
        opt.apply(p, list(training.tree_leaves(tree(g))), state)
    return p, state, opt, specs


def state_specs(opt, p, specs):
    return specs, opt.state_specs(p, specs)


def whole_bits(params, opt_state, specs=None, mesh=None) -> dict:
    """Key path -> raw bits of every tensor of the train state, gathered
    whole from every rank's shards on ``mesh`` (``specs``: the
    (params, opt_state) spec trees)."""
    from tpu_network_operator_torch.models.checkpoint import (
        _flatten_specs, flat_state)
    from tpu_network_operator_torch.parallel import comm

    state = flat_state(params, opt_state)
    if mesh is None:
        return {k: bits(t) for k, t in state.items()}
    spec_of = {}
    for prefix, tree in zip(("params", "opt_state"), specs):
        _flatten_specs(tree, prefix, spec_of)
    out = {}
    for k, t in state.items():
        if spec_of[k] is not None:
            raw = t.view(torch.uint8) if t.element_size() == 1 else t
            for dim, axis in enumerate(spec_of[k]):
                if axis is not None:
                    raw = comm.all_gather(raw, mesh.group(axis), dim)
            t = raw.view(t.dtype)
        out[k] = bits(t)
    return out


def reshard_rank(rank, world, inputs, dirs):
    """Per optimizer: save on fsdp4, restore on tensor2_fsdp2 and save
    again, restore that on fsdp4; restore the single-device checkpoint on
    tensor2_fsdp2.  Each restore's gathered state (rank 0); then a save
    that fails on rank 1."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.api import CheckpointException

    from tpu_network_operator_torch.models.checkpoint import TrainCheckpointer
    from tpu_network_operator_torch.parallel import make_mesh, plan_axes

    meshes = {n: make_mesh(plan_axes(world, **MESHES[n]), "cpu")
              for n in ("fsdp4", "tensor2_fsdp2")}
    params, grads = inputs
    out = {}

    def fresh(name, mesh_name):
        """Templates for a restore: this rank's shards, the fresh init."""
        mesh = meshes[mesh_name]
        p, state, opt, specs = trained(name, params, [], mesh)
        return p, state, state_specs(opt, p, specs), mesh

    def restored(name, directory, mesh_name, step):
        p, state, specs, mesh = fresh(name, mesh_name)
        with TrainCheckpointer(directory, mesh=mesh, specs=specs) as ckpt:
            at, p, state = ckpt.restore((p, state))
        assert at == step and state["count"] == len(grads)
        return (p, state, specs, mesh), whole_bits(p, state, specs, mesh)

    for name in OPTIMIZERS:
        mesh = meshes["fsdp4"]
        p, state, opt, specs = trained(name, params, grads, mesh)
        specs = state_specs(opt, p, specs)
        saved = whole_bits(p, state, specs, mesh)
        with TrainCheckpointer(dirs[name]["mesh"], mesh=mesh,
                               specs=specs) as ckpt:
            ckpt.save(2, p, state)
        (p2, s2, specs2, mesh2), on_t2f2 = restored(
            name, dirs[name]["mesh"], "tensor2_fsdp2", 2)
        with TrainCheckpointer(dirs[name]["back"], mesh=mesh2,
                               specs=specs2, async_save=False) as ckpt:
            ckpt.save(3, p2, s2)
        _, back = restored(name, dirs[name]["back"], "fsdp4", 3)
        _, from_one = restored(name, dirs[name]["single"], "tensor2_fsdp2",
                               2)
        out[name] = {k: v if rank == 0 else None for k, v in dict(
            saved=saved, on_tensor2_fsdp2=on_t2f2, back_on_fsdp4=back,
            from_one_device=from_one).items()}

    # a save that fails on one rank mid-write is never a step
    p, state, opt, specs = trained("adam8bit", params, grads,
                                   meshes["fsdp4"])
    specs = state_specs(opt, p, specs)
    with TrainCheckpointer(dirs["failed"], mesh=meshes["fsdp4"],
                           specs=specs) as ckpt:
        ckpt.save(1, p, state)
        ckpt.wait()
        if rank == 1:
            def fail(self, plan, planner):
                raise OSError("the disk filled")

            dcp.FileSystemWriter.write_data = fail
        ckpt.save(2, p, state)
        try:
            ckpt.wait()
            error = None
        except CheckpointException as e:
            error = type(e).__name__
        template, tstate, _, _ = fresh("adam8bit", "fsdp4")
        at, _, tstate = ckpt.restore((template, tstate))
        out["failed"] = dict(error=error, steps=ckpt.all_steps(), at=at,
                             count=tstate["count"],
                             tmp=os.path.isdir(os.path.join(dirs["failed"],
                                                            ".tmp-2")))
    dist.barrier()
    return out


@pytest.fixture(scope="module")
def inputs():
    return make_inputs("llama")


@pytest.fixture(scope="module")
def single(inputs):
    """The single-device state of the two updates, per optimizer, and its
    checkpoint directory (one device's format)."""
    return {name: trained(name, *inputs) for name in OPTIMIZERS}


@pytest.fixture(scope="module")
def world4(inputs, single, tmp_path_factory):
    from tpu_network_operator_torch.models.checkpoint import TrainCheckpointer

    root = tmp_path_factory.mktemp("ckpt")
    dirs = {name: {kind: str(root / name / kind)
                   for kind in ("mesh", "back", "single")}
            for name in OPTIMIZERS}
    dirs["failed"] = str(root / "failed")
    for name, (p, state, _, _) in single.items():
        with TrainCheckpointer(dirs[name]["single"]) as ckpt:
            ckpt.save(2, p, state)
    results = run_ranks(4, reshard_rank, inputs, dirs)
    return results, dirs


@pytest.mark.parametrize("name", OPTIMIZERS)
@pytest.mark.parametrize("where", ["saved", "on_tensor2_fsdp2",
                                   "back_on_fsdp4", "from_one_device"])
def test_restores_onto_another_mesh_shape_are_the_same_bits(
        world4, single, name, where):
    """fsdp4's save, restored on tensor2_fsdp2; that state saved and
    restored on fsdp4; the single-device checkpoint restored on
    tensor2_fsdp2: each gathered state the single-device bits."""
    got = world4[0][0][name][where]
    assert_same_bits(got, whole_bits(*single[name][:2]), f"{name} {where}")


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_a_mesh_checkpoint_restores_on_one_device(world4, single, inputs,
                                                  name):
    from tpu_network_operator_torch.models.checkpoint import TrainCheckpointer

    _, dirs = world4
    p, state, _, _ = trained(name, inputs[0], [])
    with TrainCheckpointer(dirs[name]["mesh"]) as ckpt:
        assert ckpt.all_steps() == [2]
        at, p, state = ckpt.restore((p, state))
    assert at == 2 and state["count"] == 2
    assert_same_bits(whole_bits(p, state), whole_bits(*single[name][:2]),
                     f"{name} on one device")


def test_a_save_that_fails_on_one_rank_is_never_a_step(world4):
    """Rank 1's write raises mid-save: every rank sees the save fail, the
    temporary directory is left, and the latest step is still the last
    complete one, which restores."""
    for r in world4[0]:
        got = r["failed"]
        assert got["error"] is not None
        assert got["steps"] == [1] and got["at"] == 1
        assert got["count"] == 2 and got["tmp"]
