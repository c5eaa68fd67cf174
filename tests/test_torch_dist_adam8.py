"""The port's 8-bit AdamW on shards: gloo ranks against the single-device
port and the reference's ``adamw8bit(mesh=, param_specs=)`` on the virtual
CPU mesh, in f32, at ``LlamaConfig.tiny(vocab=512)`` and
``MoEConfig.tiny(vocab=512)``.

Parameters and two steps' global gradients are drawn with numpy from a
seed in the reference's layout and are the same on every mesh.  One world
of 4 ranks runs every mesh of both trees: each rank keeps its shards,
steps them twice through ``adamw8bit(mesh=, param_specs=)`` and the state
is gathered.  The parent holds the gathered parameters, codes, scales and
``count`` to the single-device port's, bit for bit: a rank's state is its
slice of the single-device state of the global tree, on the per-shard and
on the global-block path alike (``optim8bit.mesh_leaf_plan``).

The reference's side is held in ``test_torch_dist_adam8_ref.py`` (its jnp
path on the virtual mesh, bit for bit, and its per-shard Pallas path) and
``test_torch_dist_adam8_step.py`` (its sharded adam8 train step, and the
virtual ranks of ``optim8bit.update_virtual_ranks``): each file is one
worker's share, since every eager JAX operation compiles for its
shardings and every gloo world spawns its ranks.  Jitted, the
reference's update differs from its own eager one by XLA's fused
multiply-adds (up to 128 f32 ulps in a small parameter over two steps,
measured on the tiny dense tree), mesh or not: the jitted GSPMD update is the same
bits as the jitted single-device one, so the mesh moves nothing there
either; the port matches the eager path, operation for operation.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_dist_attention import run_ranks

VOCAB, STEPS = 512, 2
# name -> mesh axes over 4 ranks, per tree
MESHES = {
    "fsdp4": dict(fsdp=4),
    "tensor2_fsdp2": dict(tensor=2, fsdp=2),
    "tensor4": dict(tensor=4, fsdp=1),
    "data2_tensor2": dict(data=2, tensor=2, fsdp=1),
    "expert2_tensor2": dict(expert=2, tensor=2, fsdp=1),
}
TREE_MESHES = {
    "llama": ("fsdp4", "tensor2_fsdp2", "tensor4", "data2_tensor2"),
    "moe": ("fsdp4", "tensor2_fsdp2", "tensor4", "expert2_tensor2",
            "data2_tensor2"),
}
CASES = [(tree, mesh) for tree, meshes in TREE_MESHES.items()
         for mesh in meshes]
# the leaves each mesh steps on gathered rows (the global-block path), by
# the axis that cuts their blocks; every other leaf steps per shard.  The
# MoE's are the dense model's: its expert w_gate / w_up are whole-row
# blocks of 128 cut by tensor, its expert w_down of 64 cut by fsdp, and
# its router is whole
_TENSOR_CUT = {"embed": "tensor", "layers/wq": "tensor",
               "layers/wk": "tensor", "layers/wv": "tensor",
               "layers/w_gate": "tensor", "layers/w_up": "tensor"}
_FSDP_CUT = {"layers/wo": "fsdp", "layers/w_down": "fsdp"}
GATHERED = {
    "fsdp4": _FSDP_CUT,
    "tensor2_fsdp2": {**_TENSOR_CUT, **_FSDP_CUT},
    # lm_head [64, 512] at tensor 4: 128-wide shards straddle 256-blocks
    # (at tensor 2 its 256-wide shards are whole blocks)
    "tensor4": {**_TENSOR_CUT, "lm_head": "tensor"},
    "data2_tensor2": _TENSOR_CUT,
    "expert2_tensor2": _TENSOR_CUT,
}


def tcfg(tree):
    from tpu_network_operator_torch.models import llama, moe

    base = (llama.LlamaConfig if tree == "llama" else moe.MoEConfig).tiny(
        vocab=VOCAB)
    return dataclasses.replace(base, dtype=torch.float32)


def jcfg(tree):
    import jax.numpy as jnp

    from tpu_network_operator.models import llama, moe

    base = (llama.LlamaConfig if tree == "llama" else moe.MoEConfig).tiny(
        vocab=VOCAB)
    return dataclasses.replace(base, dtype=jnp.float32)


def tmodel(tree):
    from tpu_network_operator_torch.models import llama, moe

    return llama if tree == "llama" else moe


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def make_inputs(tree, seed=7):
    """f32 parameters (normal / sqrt(fan in), norm scales around 1) and
    STEPS global gradients (normal * 1e-2; in the second, each leaf's
    first row zero), numpy, in the reference's layout."""
    cfg = tcfg(tree)
    whole = tmodel(tree).init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
    shapes = {k: tuple(v.shape) for k, v in flat(whole).items()}
    rng = np.random.default_rng(seed)

    def param(name, shape):
        if name.rsplit("/", 1)[-1].startswith("ln_"):
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(
            np.float32)

    def grad(step, shape):
        g = (rng.standard_normal(shape) * 1e-2).astype(np.float32)
        if step == 1:
            g.reshape(-1, shape[-1])[0] = 0.0
        return g

    params = nest({k: param(k, s) for k, s in shapes.items()})
    grads = [nest({k: grad(i, s) for k, s in shapes.items()})
             for i in range(STEPS)]
    return params, grads


def nest(flat_tree: dict) -> dict:
    """:func:`flat`'s inverse."""
    out = {}
    for key, v in flat_tree.items():
        *path, leaf = key.split("/")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def bits(t: torch.Tensor) -> np.ndarray:
    """t's raw bits, as unsigned integers of its width."""
    t = t.detach()
    width = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.view(width[t.element_size()]).numpy().copy().view(
        {1: np.uint8, 2: np.uint16, 4: np.uint32,
         8: np.uint64}[t.element_size()])


def np_bits(a) -> np.ndarray:
    """:func:`bits` of a numpy array (ml_dtypes' bf16 and float8 too)."""
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def state_bits(params, state) -> dict:
    """name -> raw bits of every leaf of the train state, and count."""
    out = {f"p/{k}": bits(v) for k, v in flat(params).items()}
    for side in ("m", "v"):
        for k, qt in flat(state[side]).items():
            out[f"{side}/{k}/q"] = bits(qt.q)
            out[f"{side}/{k}/scale"] = bits(qt.scale)
    out["count"] = np.asarray(state["count"])
    return out


def single_device(tree, params, grads):
    """The single-device port's two steps: the state's bits."""
    from tpu_network_operator_torch.models import optim8bit, training

    model = tmodel(tree)
    p = model.params_from_jax(params, "cpu")
    opt = optim8bit.adamw8bit()
    state = opt.init(p)
    for g in grads:
        opt.apply(p, list(training.tree_leaves(
            model.params_from_jax(g, "cpu"))), state)
    return state_bits(p, state)


def gather_state(params, state, opt, specs, mesh) -> dict:
    """The whole state from every rank's shards, as :func:`state_bits`."""
    from tpu_network_operator_torch.models import llama, training

    sspecs = opt.state_specs(params, specs)
    whole_p = llama.gather_tree(params, specs, mesh)
    out = {f"p/{k}": bits(v) for k, v in flat(whole_p).items()}
    for side in ("m", "v"):
        codes = training.map_by_name(
            state[side], specs, lambda qt, _: qt.q.view(torch.uint8))
        scales = training.map_by_name(state[side], specs,
                                      lambda qt, _: qt.scale)
        scale_specs = training.map_by_name(sspecs[side], specs,
                                           lambda s, _: s.scale)
        for k, v in flat(llama.gather_tree(codes, specs, mesh)).items():
            out[f"{side}/{k}/q"] = bits(v)
        for k, v in flat(llama.gather_tree(scales, scale_specs,
                                           mesh)).items():
            out[f"{side}/{k}/scale"] = bits(v)
    out["count"] = np.asarray(state["count"])
    return out


def adam8_rank(rank, world, inputs, cases):
    """Every (tree, mesh) case: this rank's shards stepped twice, the
    state gathered (kept on rank 0) and the leaves' plans."""
    import torch.distributed as dist

    from tpu_network_operator_torch.models import optim8bit, training
    from tpu_network_operator_torch.parallel import make_mesh, plan_axes

    out = {}
    for tree, name in cases:
        model = tmodel(tree)
        cfg = tcfg(tree)
        specs = model.param_specs(cfg)
        mesh = make_mesh(plan_axes(world, **MESHES[name]), "cpu")
        params, grads = inputs[tree]
        p = model.shard_params(model.params_from_jax(params, "cpu"), cfg,
                               mesh)
        opt = optim8bit.adamw8bit(mesh=mesh, param_specs=specs)
        state = opt.init(p)
        for g in grads:
            g = model.shard_params(model.params_from_jax(g, "cpu"), cfg,
                                   mesh)
            opt.apply(p, list(training.tree_leaves(g)), state)
        got = gather_state(p, state, opt, specs, mesh)
        out[(tree, name)] = dict(
            state=got if rank == 0 else None,
            plans={k: v for k, v in flat(opt.plans(p)).items()
                   if v is not None})
    dist.barrier()
    return out


@pytest.fixture(scope="module")
def inputs():
    return {tree: make_inputs(tree) for tree in TREE_MESHES}


@pytest.fixture(scope="module")
def single(inputs):
    return {tree: single_device(tree, *inputs[tree])
            for tree in TREE_MESHES}


@pytest.fixture(scope="module")
def world4(inputs, tmp_path_factory):
    return run_ranks(4, adam8_rank, inputs, CASES,
                     store_dir=tmp_path_factory.mktemp("store"))


def assert_same_bits(got: dict, want: dict, what: str) -> None:
    assert got.keys() == want.keys(), what
    differ = {k: int(np.count_nonzero(got[k] != want[k])) for k in want
              if got[k].shape != want[k].shape
              or not np.array_equal(got[k], want[k])}
    assert not differ, f"{what}: {differ}"


@pytest.mark.parametrize("tree,mesh", CASES)
def test_sharded_update_is_the_single_device_bits(world4, single, tree,
                                                  mesh):
    """Two steps on shards, gathered: p, codes, scales and count are the
    single-device port's bits."""
    got = world4[0][(tree, mesh)]["state"]
    assert int(got["count"]) == STEPS
    assert_same_bits(got, single[tree], f"{tree} at {mesh}")


@pytest.mark.parametrize("tree,mesh", CASES)
def test_which_leaves_take_the_global_block_path(world4, inputs, tree,
                                                 mesh):
    """The global-block leaves of every mesh (:data:`GATHERED`), the same
    on every rank and from a :class:`MeshCoord` with no process group;
    the rest of the leaves step per shard, so every mesh runs both
    paths."""
    from tpu_network_operator_torch.models import optim8bit
    from tpu_network_operator_torch.parallel import MeshCoord, plan_axes

    want = GATHERED[mesh]
    assert all(r[(tree, mesh)]["plans"] == want for r in world4)
    model, cfg = tmodel(tree), tcfg(tree)
    coord = MeshCoord(plan_axes(4, **MESHES[mesh]), {})
    shards = model.shard_params(model.params_from_jax(inputs[tree][0],
                                                      "cpu"), cfg, coord)
    opt = optim8bit.adamw8bit(mesh=coord, param_specs=model.param_specs(cfg))
    plans = flat(opt.plans(shards))
    assert {k: v for k, v in plans.items() if v is not None} == want
    assert any(v is None for v in plans.values())


def like(specs: dict, tree: dict) -> dict:
    """The entries of ``specs`` at ``tree``'s keys (a subtree's specs)."""
    return {k: like(specs[k], v) if isinstance(v, dict) else specs[k]
            for k, v in tree.items()}


def reference_update(tree, params, grads, mesh_name=None):
    """The reference's ``adamw8bit`` update, eager, a step a gradient: on
    one device, or on the virtual mesh with the family's specs (of
    ``params``' leaves, which may be a subtree)."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding

    from tpu_network_operator.models import llama, moe, optim8bit
    from tpu_network_operator.parallel import make_mesh, plan_axes

    model = llama if tree == "llama" else moe
    mesh = specs = None
    put = jax.tree.map
    if mesh_name is not None:
        mesh = make_mesh(plan_axes(4, **MESHES[mesh_name]),
                         devices=jax.devices()[:4])
        specs = like(model.param_specs(jcfg(tree)), params)
        shardings = jax.tree.map(lambda s: NamedSharding(mesh, s), specs)

        def put(fn, t):
            return jax.device_put(jax.tree.map(fn, t), shardings)

    opt = optim8bit.adamw8bit(mesh=mesh, param_specs=specs)
    p = put(jnp.asarray, params)
    state = opt.init(p)
    for g in grads:
        upd, state = opt.update(put(jnp.asarray, g), state, p)
        p = optax.apply_updates(p, upd)
    p, state = jax.tree.map(np.asarray, (p, state))
    out = {f"p/{k}": np_bits(v) for k, v in flat(p).items()}
    for side in ("m", "v"):
        for k, qt in flat(getattr(state, side)).items():
            out[f"{side}/{k}/q"] = np_bits(qt.q)
            out[f"{side}/{k}/scale"] = np_bits(qt.scale)
    out["count"] = np.asarray(state.count)
    return out
