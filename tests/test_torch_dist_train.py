"""The port's sharded Llama train step on gloo ranks against the
reference's ``make_train_step(cfg, mesh)`` on the same number of CPU
devices, from the same parameters and tokens, in f32.

One world of 4 ranks is spawned for every mesh; each rank builds the mesh,
shards the reference's parameters (``shard_params``), takes its rows of
the batch and makes one step.  The parent holds the loss and the gathered
updated leaves to the reference's.  Tolerances, as the single-device step
is held (``test_torch_training.py``): the loss to 1e-5 relative
(summation order), each leaf to 2 * lr absolute (Adam's first step moves
a weight by about lr * sign(g), and a gradient near zero may flip sign
between the two) plus 1e-6 for the f32 rounding of the moved weight.
Adam's first step is blind to a gradient's scale, so the summed gradients
the update sees are also gathered and held to the reference's
``jax.grad`` of its loss: 1e-5 of each leaf's largest value and of its
norm (f32 summation order; the runs agree to about 1e-6).  A world of one rank must give the single-device step's
bits under every remat policy.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_dist_attention import run_ranks

LR = 3e-4
# name -> (mesh axes over 4 ranks, sequence-parallel attention, config)
MESHES = {
    "fsdp2_tensor2": (dict(fsdp=2, tensor=2), None, {}),
    "data2_seq2_ring": (dict(data=2, seq=2, fsdp=1), "ring", {}),
    "seq2_tensor2_ulysses": (dict(seq=2, tensor=2, fsdp=1), "ulysses", {}),
    "data2_tensor2_ffn_remat": (
        dict(data=2, tensor=2, fsdp=1), None,
        dict(remat=True, remat_policy="ffn")),
    "data2_seq2_seq_parallel": (
        dict(data=2, seq=2, fsdp=1), None, dict(seq_parallel=True)),
    # kv_heads 2 over 4 tensor ranks: gathered, repeated and re-split
    "tensor4_kv_repeat": (dict(tensor=4, fsdp=1), None, {}),
}
BATCH, SEQ = 4, 32


def _tcfg(kw):
    from tpu_network_operator_torch.models import llama as tllama

    return dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.float32,
                               **kw)


def _attn_fn(impl, mesh):
    from tpu_network_operator_torch.parallel.ring import make_ring_attn_fn
    from tpu_network_operator_torch.parallel.ulysses import (
        make_ulysses_attn_fn)

    return {"ring": make_ring_attn_fn,
            "ulysses": make_ulysses_attn_fn}[impl](mesh)


def _train_rank(rank, world, tree, tokens, source_seed):
    from tpu_network_operator_torch.data import (DataConfig, SyntheticTokens,
                                                 sharded_batches)
    from tpu_network_operator_torch.models import llama as tllama
    from tpu_network_operator_torch.models import training as ttraining
    from tpu_network_operator_torch.parallel import make_mesh, plan_axes

    out = {}
    for name, (axes, impl, kw) in MESHES.items():
        mesh = make_mesh(plan_axes(world, **axes), "cpu")
        cfg = _tcfg(kw)
        step, init_all, opt = tllama.make_train_step(
            cfg, device="cpu", mesh=mesh,
            attn_fn=_attn_fn(impl, mesh) if impl else None)
        params = tllama.shard_params(tllama.params_from_jax(tree, "cpu"),
                                     cfg, mesh)
        rows = torch.from_numpy(tokens).chunk(mesh.size("data", "fsdp"))[
            mesh.index("data", "fsdp")]
        # the summed gradients the update sees, gathered whole
        lay = tllama.Layout(cfg, mesh,
                            _attn_fn(impl, mesh) if impl else None)
        leaves = [p.requires_grad_() for p in ttraining.tree_leaves(params)]
        grads = iter(lay.reduce_grads(params, torch.autograd.grad(
            tllama.loss_fn(params, rows, cfg, lay), leaves)))
        full_grads = tllama.gather_params(
            ttraining.tree_map(lambda _: next(grads), params), cfg, mesh)
        params, _, loss = step(params, opt.init(params), rows)
        full = tllama.gather_params(params, cfg, mesh)
        out[name] = dict(loss=loss.item(), params=None if rank else {
            k: v.numpy() for k, v in _flat(full).items()},
            grads=None if rank else {
                k: v.numpy() for k, v in _flat(full_grads).items()})
        if name == "fsdp2_tensor2":
            # a seed gives the same parameters at every world size
            gen = torch.Generator().manual_seed(11)
            sharded, _ = init_all(gen)
            whole = tllama.init_params(cfg, torch.Generator().manual_seed(11),
                                       "cpu")
            gathered = _flat(tllama.gather_params(sharded, cfg, mesh))
            out["init_same_bits"] = all(
                torch.equal(gathered[k], v) for k, v in _flat(whole).items())
    # each rank's rows of two batches of a token stream, per mesh
    dcfg = DataConfig(batch=8, seq_len=16)
    source = SyntheticTokens(256, seed=source_seed)
    for axes in (dict(data=2, fsdp=2), dict(fsdp=2, tensor=2)):
        mesh = make_mesh(plan_axes(world, **axes), "cpu")
        it = sharded_batches(source, dcfg, mesh, start_step=3)
        out[f"batches_{mesh.size('data', 'fsdp')}"] = dict(
            index=mesh.index("data", "fsdp"),
            rows=[next(it).numpy() for _ in range(2)])
    return out


def _flat(tree, prefix=""):
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(_flat(v, f"{prefix}{k}/"))
        else:
            flat[prefix + k] = v
    return flat


@pytest.fixture(scope="module")
def reference_params():
    import jax

    from tpu_network_operator.models import llama as jllama

    jcfg = _jcfg({})
    params = jllama.init_params(jax.random.key(7), jcfg)
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(8).integers(0, 256, (BATCH, SEQ + 1),
                                             dtype=np.int32)


@pytest.fixture(scope="module")
def world4(reference_params, tokens):
    return run_ranks(4, _train_rank, reference_params, tokens, 5)


def _jcfg(kw):
    import jax.numpy as jnp

    from tpu_network_operator.models import llama as jllama

    return dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32,
                               **kw)


def _reference_step(name, tree, tokens):
    import jax
    import jax.numpy as jnp

    from tpu_network_operator.models import llama as jllama
    from tpu_network_operator.parallel import make_mesh, plan_axes
    from tpu_network_operator.parallel.ring import make_ring_attn_fn
    from tpu_network_operator.parallel.ulysses import make_ulysses_attn_fn

    axes, impl, kw = MESHES[name]
    mesh = make_mesh(plan_axes(4, **axes), devices=jax.devices()[:4])
    attn = {None: None, "ring": make_ring_attn_fn,
            "ulysses": make_ulysses_attn_fn}[impl]
    step, _, opt = jllama.make_train_step(
        _jcfg(kw), mesh, attn_fn=attn(mesh) if attn else None)
    params = jax.tree.map(jnp.asarray, tree)
    new, _, loss = step(params, opt.init(params), jnp.asarray(tokens))
    return float(loss), {k: np.asarray(v) for k, v in
                         _flat(jax.tree.map(np.asarray, new)).items()}


@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_gradients_match_reference(world4, reference_params, tokens,
                                           name):
    import jax
    import jax.numpy as jnp

    from tpu_network_operator.models import llama as jllama

    _, _, kw = MESHES[name]
    params = jax.tree.map(jnp.asarray, reference_params)
    ref = _flat(jax.tree.map(np.asarray, jax.grad(jllama.loss_fn)(
        params, jnp.asarray(tokens), _jcfg(kw))))
    for key, g in world4[0][name]["grads"].items():
        big = np.abs(ref[key]).max()
        assert np.abs(g - ref[key]).max() <= 1e-5 * big, key
        assert np.linalg.norm(g - ref[key]) <= 1e-5 * np.linalg.norm(
            ref[key]), key


@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_step_matches_reference(world4, reference_params, tokens,
                                        name):
    loss_j, params_j = _reference_step(name, reference_params, tokens)
    losses = [r[name]["loss"] for r in world4]
    assert len(set(losses)) == 1, f"ranks disagree on the loss: {losses}"
    assert abs(losses[0] - loss_j) < 1e-5 * loss_j, (losses[0], loss_j)
    before = _flat(reference_params)
    for key, leaf in world4[0][name]["params"].items():
        np.testing.assert_allclose(leaf, params_j[key], rtol=0,
                                   atol=2 * LR + 1e-6, err_msg=key)
        assert not np.array_equal(leaf, before[key]), key    # it moved


def test_init_all_draws_the_whole_tree_at_every_world_size(world4):
    assert all(r["init_same_bits"] for r in world4)


@pytest.mark.parametrize("shards", [4, 2])
def test_sharded_batches_are_the_reference_local_batches(world4, shards):
    from tpu_network_operator.data import (DataConfig, SyntheticTokens,
                                           local_batches)

    dcfg = DataConfig(batch=8, seq_len=16)
    for r in world4:
        got = r[f"batches_{shards}"]
        it = local_batches(SyntheticTokens(256, seed=5), dcfg, start_step=3,
                           process_index=got["index"], process_count=shards)
        for rows in got["rows"]:
            np.testing.assert_array_equal(rows, next(it))


POLICIES = ("dots", "ffn", "ffn_lite", "ffn_offload", "full")


def _world1_rank(rank, world, tree, tokens):
    """Two steps of every remat policy through a world-1 mesh and through
    the single-device step, from the same parameters: same bits?"""
    from tpu_network_operator_torch.models import llama as tllama
    from tpu_network_operator_torch.parallel import make_mesh, plan_axes

    mesh = make_mesh(plan_axes(1), "cpu")
    same = {}
    for policy in POLICIES:
        cfg = _tcfg(dict(remat=True, remat_policy=policy, xent_chunk=16))
        runs = []
        for m in (None, mesh):
            step, _, opt = tllama.make_train_step(cfg, device="cpu", mesh=m)
            params = tllama.params_from_jax(tree, "cpu")
            state = opt.init(params)
            losses = []
            for _ in range(2):
                params, state, loss = step(params, state,
                                           torch.from_numpy(tokens))
                losses.append(loss)
            runs.append((losses, _flat(params)))
        (la, pa), (lb, pb) = runs
        same[policy] = (all(torch.equal(a, b) for a, b in zip(la, lb))
                        and all(torch.equal(pa[k], pb[k]) for k in pa))
    return same


@pytest.fixture(scope="module")
def world1(reference_params, tokens):
    return run_ranks(1, _world1_rank, reference_params, tokens)[0]


@pytest.mark.parametrize("policy", POLICIES)
def test_world1_mesh_step_is_the_single_device_step(world1, policy):
    assert world1[policy]
