"""The port's 8-bit AdamW on shards inside the train step, and over virtual
ranks in one process (``test_torch_dist_adam8.py`` has the inputs and the
update's cases; this file is one worker's share apart).

``make_train_step(optimizer="adam8bit", mesh=)`` on a 2-rank gloo world
against the reference's sharded adam8 step on the virtual CPU mesh, in f32
at ``LlamaConfig.tiny(vocab=512)``; and every rank of a mesh stepped by
``optim8bit.update_virtual_ranks`` (the seam the card's check drives)
against the single-device update, bit for bit.
"""

import numpy as np
import pytest
import torch

from test_torch_dist_adam8 import (MESHES, VOCAB, assert_same_bits, bits,
                                   flat, jcfg, make_inputs, state_bits, tcfg,
                                   tmodel)
from test_torch_dist_attention import run_ranks

# on 2 ranks: embed, wq, wk, wv, w_gate and w_up step on gathered rows,
# the rest per shard (the fsdp-cut leaves are test_torch_dist_adam8.py's)
STEP_AXES = dict(tensor=2, fsdp=1)
LR = 3e-4


def step_rank(rank, world, params, tokens):
    """One train step with optimizer "adam8bit" on the mesh: the loss, the
    count and (rank 0) the gathered leaves."""
    import torch.distributed as dist

    from tpu_network_operator_torch.parallel import make_mesh, plan_axes

    model, cfg = tmodel("llama"), tcfg("llama")
    mesh = make_mesh(plan_axes(world, **STEP_AXES), "cpu")
    step, _, opt = model.make_train_step(cfg, optimizer="adam8bit",
                                         device="cpu", mesh=mesh)
    p = model.shard_params(model.params_from_jax(params, "cpu"), cfg, mesh)
    rows = torch.from_numpy(tokens).chunk(mesh.size("data", "fsdp"))[
        mesh.index("data", "fsdp")]
    p, state, loss = step(p, opt.init(p), rows)
    whole = model.gather_params(p, cfg, mesh)
    out = dict(loss=loss.item(), count=state["count"],
               params={k: v.numpy() for k, v in flat(whole).items()}
               if rank == 0 else None)
    dist.barrier()
    return out


@pytest.fixture(scope="module")
def inputs():
    return {**{tree: make_inputs(tree) for tree in ("llama", "moe")},
            "tokens": np.random.default_rng(8).integers(
                0, VOCAB, (4, 33), dtype=np.int32)}


@pytest.fixture(scope="module")
def world2(inputs):
    return run_ranks(2, step_rank, inputs["llama"][0], inputs["tokens"])


def test_adam8_train_step_on_the_mesh_matches_reference(world2, inputs):
    """``make_train_step(optimizer="adam8bit", mesh=)`` for one step at
    ``tensor2`` (2 ranks) against the reference's sharded adam8 step, held as
    the dense mesh step is (``test_torch_dist_train.py``): the loss to
    1e-5 relative, every leaf to 2 * lr + 1e-6."""
    import jax
    import jax.numpy as jnp

    from tpu_network_operator.models import llama
    from tpu_network_operator.parallel import make_mesh, plan_axes

    mesh = make_mesh(plan_axes(2, **STEP_AXES), devices=jax.devices()[:2])
    step, _, opt = llama.make_train_step(jcfg("llama"), mesh,
                                         optimizer="adam8bit")
    params = jax.tree.map(jnp.asarray, inputs["llama"][0])
    new, state, loss = step(params, opt.init(params),
                            jnp.asarray(inputs["tokens"]))
    want = flat(jax.tree.map(np.asarray, new))
    losses = [r["loss"] for r in world2]
    assert len(set(losses)) == 1, losses
    assert abs(losses[0] - float(loss)) < 1e-5 * float(loss)
    assert all(r["count"] == 1 for r in world2)
    before = flat(inputs["llama"][0])
    for key, leaf in world2[0]["params"].items():
        np.testing.assert_allclose(leaf, want[key], rtol=0,
                                   atol=2 * LR + 1e-6, err_msg=key)
        assert not np.array_equal(leaf, before[key]), key


@pytest.mark.parametrize("tree,mesh", [("llama", "tensor4"),
                                       ("moe", "expert2_tensor2")])
def test_virtual_ranks_in_one_process_are_slices_of_one_device(inputs, tree,
                                                               mesh):
    """Every rank of a mesh stepped in one process with no process group
    (``optim8bit.update_virtual_ranks``, the seam the card's check
    drives), two steps: each rank's parameters, codes and scales are the
    same bits as its slice of the single-device state."""
    import itertools

    from tpu_network_operator_torch.models import optim8bit, training
    from tpu_network_operator_torch.models.llama import shard_leaf
    from tpu_network_operator_torch.parallel import MeshCoord, plan_axes

    model, cfg = tmodel(tree), tcfg(tree)
    specs = model.param_specs(cfg)
    params, grads = inputs[tree]
    plan = plan_axes(4, **MESHES[mesh])
    ranks = []
    for idx in itertools.product(*(range(n) for n in plan.shape)):
        coord = MeshCoord(plan, dict(zip(plan.names, idx)))
        p = training.tree_map(torch.clone, model.shard_params(
            model.params_from_jax(params, "cpu"), cfg, coord))
        opt = optim8bit.adamw8bit(mesh=coord, param_specs=specs)
        ranks.append((coord, p, opt, opt.init(p)))
    for step, g in enumerate(grads, start=1):
        g = model.params_from_jax(g, "cpu")
        optim8bit.update_virtual_ranks([
            (coord, list(zip(training.tree_leaves(p), training.tree_leaves(
                model.shard_params(g, cfg, coord)),
                training.tree_leaves(state["m"]),
                training.tree_leaves(state["v"]))),
             list(training.tree_leaves(opt.plans(p))))
            for coord, p, opt, state in ranks], ranks[0][2].consts(step))
    whole = model.params_from_jax(params, "cpu")
    opt = optim8bit.adamw8bit()
    whole_state = opt.init(whole)
    for g in grads:
        opt.apply(whole, list(training.tree_leaves(
            model.params_from_jax(g, "cpu"))), whole_state)
    for coord, p, opt, state in ranks:
        sspecs = opt.state_specs(p, specs)
        spec_of = flat(specs)
        want = {f"p/{k}": bits(shard_leaf(v, spec_of[k], coord))
                for k, v in flat(whole).items()}
        for side in ("m", "v"):
            spec_of = flat(sspecs[side])
            for k, qt in flat(whole_state[side]).items():
                sq = spec_of[k]
                want[f"{side}/{k}/q"] = bits(shard_leaf(qt.q, sq.q, coord))
                want[f"{side}/{k}/scale"] = bits(
                    shard_leaf(qt.scale, sq.scale, coord))
        got = state_bits(p, {**state, "count": len(grads)})
        del got["count"]
        assert_same_bits(got, want, f"{tree} {mesh} rank {coord.coord}")
