"""The port's expert-parallel MoE train step on gloo ranks against the
reference's ``moe.make_train_step(cfg, mesh)`` on the same number of CPU
devices, from the same parameters and tokens, in f32 at
``MoEConfig.tiny`` (4 experts, top-2), batch 4, seq 32.

One world of 4 ranks is spawned per module; each rank builds every mesh
of the module, shards the parameters (``moe.shard_params``), takes its
rows of the batch and makes one step, keeping the summed gradients its
update sees.  The parameters are drawn with numpy from a seed in the
reference's layout, so no JAX init is compiled for them.  Tolerances, as the dense mesh step is held
(``test_torch_dist_train.py``): the loss to 1e-5 relative (summation
order), each leaf to 2 * lr + 1e-6 (Adam's first step moves a weight by
about lr * sign(g), which may flip for a gradient near zero), and the
summed gradients, which Adam's first step cannot see the scale of, to
1e-5 of each leaf's largest value and of its norm against ``jax.grad`` of
the reference's loss.

The meshes hold each trap of the design: ``data2_expert2`` the aux loss's
global statistics (a mean of per-rank products moves the router's
gradient), ``fsdp2_expert2`` the router's gradient (summed over
``expert`` it would count the aux part twice), ``tensor2_expert2`` the
column/row split within each expert, and the two seq meshes that a
routing group stays a whole row under ring and Ulysses.  The ``tied``
case zeroes the router: every token ties, experts 0 and 1 (both on the
first expert rank) overflow their capacity and drop tokens, and the
second expert rank receives no token at all.  The seq meshes and the
tied case run in ``test_torch_dist_moe_seq.py``, which imports this
module's helpers: under ``--dist loadfile`` each file is one worker's
share, and each stays well under a minute.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_dist_attention import run_ranks

LR = 3e-4
BATCH, SEQ = 4, 32
# name -> (mesh axes over 4 ranks, sequence-parallel attention, params)
MESHES = {
    "expert4": (dict(expert=4, fsdp=1), None, "random"),
    "fsdp2_expert2": (dict(fsdp=2, expert=2), None, "random"),
    "data2_expert2": (dict(data=2, expert=2, fsdp=1), None, "random"),
    "tensor2_expert2": (dict(tensor=2, expert=2, fsdp=1), None, "random"),
    "expert2_seq2_ring": (dict(expert=2, seq=2, fsdp=1), "ring", "random"),
    "expert2_seq2_ulysses": (dict(expert=2, seq=2, fsdp=1), "ulysses",
                             "random"),
    "fsdp2_expert2_tied": (dict(fsdp=2, expert=2), None, "tied"),
}
# this module's meshes; the rest are test_torch_dist_moe_seq.py's
HERE = ("expert4", "fsdp2_expert2", "data2_expert2", "tensor2_expert2")
# the shard-wise init, gathered at these meshes, against one device's
INIT_MESHES = ("fsdp2_expert2", "tensor2_expert2")


def _tcfg():
    from tpu_network_operator_torch.models import moe as tmoe

    return dataclasses.replace(tmoe.MoEConfig.tiny(), dtype=torch.float32)


def _jcfg():
    import jax.numpy as jnp

    from tpu_network_operator.models import moe as jmoe

    return dataclasses.replace(jmoe.MoEConfig.tiny(), dtype=jnp.float32)


def _flat(tree, prefix=""):
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(_flat(v, f"{prefix}{k}/"))
        else:
            flat[prefix + k] = v
    return flat


def _attn_fn(impl, mesh):
    from tpu_network_operator_torch.parallel.ring import make_ring_attn_fn
    from tpu_network_operator_torch.parallel.ulysses import (
        make_ulysses_attn_fn)

    if impl is None:
        return None
    return {"ring": make_ring_attn_fn,
            "ulysses": make_ulysses_attn_fn}[impl](mesh)


class _Seen:
    """An optimizer that keeps a copy of the summed gradients it is
    given before stepping as ``opt`` does."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def init(self, params):
        return self.opt.init(params)

    def apply(self, params, grads, state):
        self.grads = [g.detach().clone() for g in grads]
        return self.opt.apply(params, grads, state)


def moe_rank(rank, world, trees, tokens, names):
    import torch.distributed as dist

    from tpu_network_operator_torch.models import moe as tmoe
    from tpu_network_operator_torch.models import training as ttraining
    from tpu_network_operator_torch.parallel import make_mesh, plan_axes

    cfg = _tcfg()
    out = {}
    for name in names:
        axes, impl, which = MESHES[name]
        mesh = make_mesh(plan_axes(world, **axes), "cpu")
        seen = _Seen(ttraining.adamw(LR, weight_decay=0.1))
        step, init_all, opt = tmoe.make_train_step(
            cfg, seen, device="cpu", mesh=mesh,
            attn_fn=_attn_fn(impl, mesh))
        params = tmoe.shard_params(tmoe.params_from_jax(trees[which], "cpu"),
                                   cfg, mesh)
        rows = torch.from_numpy(tokens).chunk(mesh.size("data", "fsdp"))[
            mesh.index("data", "fsdp")]
        params, _, loss = step(params, opt.init(params), rows)
        # the summed gradients the update saw, gathered whole
        grads = iter(seen.grads)
        full_grads = tmoe.gather_params(
            ttraining.tree_map(lambda _: next(grads), params), cfg, mesh)
        full = tmoe.gather_params(params, cfg, mesh)
        out[name] = dict(loss=loss.item(), params=None if rank else {
            k: v.numpy() for k, v in _flat(full).items()},
            grads=None if rank else {
                k: v.numpy() for k, v in _flat(full_grads).items()})
        if name in INIT_MESHES:
            # a seed gives the same parameters at every world size
            sharded, _ = init_all(torch.Generator().manual_seed(11))
            whole = tmoe.init_params(cfg, torch.Generator().manual_seed(11),
                                     "cpu")
            gathered = _flat(tmoe.gather_params(sharded, cfg, mesh))
            out[f"init_same_bits_{name}"] = all(
                torch.equal(gathered[k], v) for k, v in _flat(whole).items())
    dist.barrier()
    return out


def make_trees(which):
    """f32 tiny MoE parameters in the reference's layout, as numpy, by
    name: ``random`` (normal / sqrt(fan in) from a seed, norm scales
    around 1), ``tied`` (the same with a zero router)."""
    cfg = _tcfg()
    rng = np.random.default_rng(7)
    h, f, n, e = cfg.hidden, cfg.ffn, cfg.layers, cfg.experts
    q, kv = cfg.heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim

    def w(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    def scale(shape):
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)

    params = {
        "embed": w((cfg.vocab_size, h), h),
        "layers": {
            "wq": w((n, h, q), h), "wk": w((n, h, kv), h),
            "wv": w((n, h, kv), h), "wo": w((n, q, h), q),
            "router": w((n, h, e), h),
            "w_gate": w((n, e, h, f), h), "w_up": w((n, e, h, f), h),
            "w_down": w((n, e, f, h), f),
            "ln_attn": scale((n, h)), "ln_mlp": scale((n, h)),
        },
        "ln_final": scale((h,)),
        "lm_head": w((h, cfg.vocab_size), h),
    }
    trees = {"random": params}
    if "tied" in which:
        tied = {**params, "layers": dict(params["layers"])}
        tied["layers"]["router"] = np.zeros_like(params["layers"]["router"])
        trees["tied"] = tied
    return trees


def make_tokens():
    return np.random.default_rng(8).integers(0, 256, (BATCH, SEQ + 1),
                                             dtype=np.int32)


def grads_of(trees, tokens):
    """``jax.grad`` of the reference's loss on one device, per tree."""
    import jax
    import jax.numpy as jnp

    from tpu_network_operator.models import moe as jmoe

    grad = jax.jit(jax.grad(lambda p, t: jmoe.loss_fn(p, t, _jcfg())))
    return {which: _flat(jax.tree.map(np.asarray, grad(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(tokens))))
        for which, tree in trees.items()}


@pytest.fixture(scope="module")
def trees():
    return make_trees(("random",))


@pytest.fixture(scope="module")
def tokens():
    return make_tokens()


@pytest.fixture(scope="module")
def world4(trees, tokens):
    return run_ranks(4, moe_rank, trees, tokens, HERE)


@pytest.fixture(scope="module")
def reference_grads(trees, tokens):
    return grads_of(trees, tokens)


def reference_step(name, tree, tokens):
    import jax
    import jax.numpy as jnp

    from tpu_network_operator.models import moe as jmoe
    from tpu_network_operator.parallel import make_mesh, plan_axes
    from tpu_network_operator.parallel.ring import make_ring_attn_fn
    from tpu_network_operator.parallel.ulysses import make_ulysses_attn_fn

    axes, impl, _ = MESHES[name]
    mesh = make_mesh(plan_axes(4, **axes), devices=jax.devices()[:4])
    attn = {None: None, "ring": make_ring_attn_fn,
            "ulysses": make_ulysses_attn_fn}[impl]
    step, _, opt = jmoe.make_train_step(
        _jcfg(), mesh, attn_fn=attn(mesh) if attn else None)
    params = jax.tree.map(jnp.asarray, tree)
    new, _, loss = step(params, opt.init(params), jnp.asarray(tokens))
    return float(loss), _flat(jax.tree.map(np.asarray, new))


def check_gradients(world, reference_grads, name):
    """The gathered summed gradients against ``jax.grad``."""
    ref = reference_grads[MESHES[name][2]]
    for key, g in world[0][name]["grads"].items():
        big = np.abs(ref[key]).max()
        assert np.abs(g - ref[key]).max() <= 1e-5 * big, key
        assert np.linalg.norm(g - ref[key]) <= 1e-5 * np.linalg.norm(
            ref[key]), key


def check_step(world, trees, tokens, name):
    """The loss and the gathered leaves after one step against the
    reference's mesh step."""
    tree = trees[MESHES[name][2]]
    loss_j, params_j = reference_step(name, tree, tokens)
    losses = [r[name]["loss"] for r in world]
    assert len(set(losses)) == 1, f"ranks disagree on the loss: {losses}"
    assert abs(losses[0] - loss_j) < 1e-5 * loss_j, (losses[0], loss_j)
    before = _flat(tree)
    for key, leaf in world[0][name]["params"].items():
        np.testing.assert_allclose(leaf, params_j[key], rtol=0,
                                   atol=2 * LR + 1e-6, err_msg=key)
        assert not np.array_equal(leaf, before[key]), key    # it moved


@pytest.mark.parametrize("name", HERE)
def test_expert_sharded_gradients_match_reference(world4, reference_grads,
                                                  name):
    check_gradients(world4, reference_grads, name)


@pytest.mark.parametrize("name", HERE)
def test_expert_sharded_step_matches_reference(world4, trees, tokens, name):
    check_step(world4, trees, tokens, name)


@pytest.mark.parametrize("name", INIT_MESHES)
def test_shard_wise_init_is_the_single_device_tree(world4, name):
    assert all(r[f"init_same_bits_{name}"] for r in world4)


def test_tied_router_drops_tokens_and_starves_an_expert_rank(trees, tokens):
    """The ``tied`` case's routing, as the port computes it on each
    expert rank's rows: the first rank's experts overflow and drop, the
    second rank's receive nothing."""
    from tpu_network_operator_torch.models import moe as tmoe

    cfg = _tcfg()
    probs = torch.full((BATCH, SEQ, cfg.experts), 1.0 / cfg.experts)
    dispatch, _ = tmoe.route(probs, cfg.experts_per_token,
                             cfg.capacity(SEQ))
    per_expert = dispatch.sum((0, 1, 3))
    assert per_expert.tolist() == [BATCH * cfg.capacity(SEQ)] * 2 + [0, 0]
    assert cfg.capacity(SEQ) < SEQ          # each of experts 0, 1 drops


def test_experts_that_do_not_divide_are_refused_as_the_reference_refuses():
    """3 experts over 2 expert ranks.  The reference refuses the mesh too:
    its step pins the expert leaves to ``P(None, "expert", ...)``, and JAX
    refuses a sharding whose dim does not divide the axis.  The port
    names the experts and the axis."""
    import jax

    from tpu_network_operator.models import moe as jmoe
    from tpu_network_operator.parallel import make_mesh, plan_axes
    from tpu_network_operator_torch.models import moe as tmoe
    from tpu_network_operator_torch.parallel import MeshCoord
    from tpu_network_operator_torch.parallel import plan_axes as tplan

    jcfg = dataclasses.replace(_jcfg(), experts=3)
    mesh = make_mesh(plan_axes(2, expert=2), devices=jax.devices()[:2])
    _, init_all, _ = jmoe.make_train_step(jcfg, mesh)
    with pytest.raises(ValueError, match="divisible by 2"):
        init_all(jax.random.key(0))
    cfg = dataclasses.replace(_tcfg(), experts=3)
    coord = MeshCoord(tplan(2, expert=2), {"expert": 1})
    with pytest.raises(ValueError, match=r"expert parallelism over 2 ranks "
                                         r"needs the experts \(3\) "
                                         "divisible by 2"):
        tmoe.Layout(cfg, coord)
    with pytest.raises(ValueError, match="needs the experts"):
        tmoe.init_params(cfg, torch.Generator(), "cpu", coord)


def test_one_virtual_rank_draws_its_own_shards():
    """A :class:`MeshCoord` stands for a rank with no process group: each
    expert rank's draw is its slice of the single-device tree, and the
    replicated leaves are the same bits on every rank."""
    from tpu_network_operator_torch.models import moe as tmoe
    from tpu_network_operator_torch.models import training as ttraining
    from tpu_network_operator_torch.parallel import MeshCoord, plan_axes

    cfg = _tcfg()
    whole = tmoe.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    plan = plan_axes(4, expert=2, tensor=2, fsdp=1)
    for e in range(2):
        for t in range(2):
            coord = MeshCoord(plan, {"expert": e, "tensor": t})
            got = tmoe.init_params(cfg, torch.Generator().manual_seed(5),
                                   "cpu", coord)
            want = tmoe.shard_params(whole, cfg, coord)
            assert all(torch.equal(a, b) for a, b in zip(
                ttraining.tree_leaves(got), ttraining.tree_leaves(want)))


@pytest.mark.parametrize("shards", [2, 4])
def test_virtual_expert_shards_sum_to_the_unsplit_ffn(shards):
    """The mesh's per-rank body over virtual expert shards in one process
    (``ffn_over_expert_shards``, the seam the card's ``expert_virtual``
    phase drives), in f32 at the tiny widths: the summed partial outputs,
    the aux loss and every gradient are the unsplit FFN's up to summation
    order (1e-6 absolute out, 1e-5 relative norm)."""
    from tpu_network_operator_torch.models import moe as tmoe

    cfg = _tcfg()
    params = tmoe.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    lp = {k: params["layers"][k][1].clone().requires_grad_()
          for k in ("router", "w_gate", "w_up", "w_down")}
    y = torch.randn(2, 24, cfg.hidden,
                    generator=torch.Generator().manual_seed(3))
    y.requires_grad_()
    ref, aux_ref = tmoe._moe_ffn(cfg, lp, y)
    want = torch.autograd.grad((ref ** 2).sum() + aux_ref, [y, *lp.values()])
    out, aux = tmoe.ffn_over_expert_shards(cfg, lp, y, shards)
    got = torch.autograd.grad((out ** 2).sum() + aux, [y, *lp.values()])
    assert (out - ref).abs().max() <= 1e-6
    assert torch.equal(aux, aux_ref)
    for name, g, w in zip(("y", *lp), got, want):
        assert (g - w).norm() <= 1e-5 * w.norm(), name
