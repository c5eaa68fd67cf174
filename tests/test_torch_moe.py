"""The port's MoE model held against the JAX package's, on the CPU.

Parameters are made by the JAX package and moved across with
``params_from_jax`` (the f32 router leaf and the ``[L, E, ...]`` expert
leaves by name); tokens and activations are made with numpy.  The flash
case runs the JAX model through its Pallas flash kernel and fused RMSNorm
in interpret mode, routed there as ``test_torch_llama.py`` routes the dense
model.  Each tolerance is stated beside its reason.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tpu_network_operator.models import moe as jmoe
from tpu_network_operator.models import optim8bit as jopt
from tpu_network_operator.ops import pallas_attention as jpa
from tpu_network_operator_torch.models import moe as tmoe
from tpu_network_operator_torch.models import optim8bit as topt
from tpu_network_operator_torch.models import training as ttraining
from tpu_network_operator_torch.models.checkpoint import TrainCheckpointer

TDT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
LR = 3e-4


def torch_cfg(jcfg, **kw):
    """The port's config with the reference config's fields."""
    fields = {f.name for f in dataclasses.fields(tmoe.MoEConfig)}
    vals = {k: v for k, v in dataclasses.asdict(jcfg).items()
            if k in fields and k != "dtype"}
    return tmoe.MoEConfig(**{**vals, **kw}, dtype=TDT[jcfg.dtype])


def tiny(dtype=jnp.float32, **kw):
    """MoEConfig.tiny: head_dim 16, so plain attention on both sides."""
    return dataclasses.replace(jmoe.MoEConfig.tiny(), dtype=dtype, **kw)


def flash_cfg(dtype=jnp.float32, **kw):
    """head_dim 64 and 128-token sequences: the flash gate passes on both
    sides, and 256 rows x hidden 128 pass the fused-RMSNorm gate."""
    return jmoe.MoEConfig(
        vocab_size=256, hidden=128, layers=2, heads=2, kv_heads=1, ffn=256,
        experts=4, max_seq=256, remat=False, dtype=dtype, **kw)


def jax_tree(jcfg, seed):
    return jax.tree.map(np.asarray, jmoe.init_params(jax.random.key(seed),
                                                     jcfg))


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _rel(a, ref):
    a, ref = _np(a), _np(ref)
    return float(np.linalg.norm(a - ref) / max(np.linalg.norm(ref), 1e-12))


def _leaf(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


@pytest.fixture
def jax_kernels(monkeypatch):
    """The JAX RMSNorm through its Pallas kernel (interpret mode); the JAX
    flash kernel is passed as ``attn_fn``."""
    monkeypatch.setenv("TPUNET_RMS_FUSED", "1")


# -- config -------------------------------------------------------------------


@pytest.mark.parametrize("name", ["tiny", "small", "mixtral_8x7b"])
def test_presets_match(name):
    jcfg = getattr(jmoe.MoEConfig, name)()
    tcfg = getattr(tmoe.MoEConfig, name)()
    assert tcfg == torch_cfg(jcfg)
    assert tcfg.num_params() == jcfg.num_params()
    assert tcfg.head_dim == jcfg.head_dim
    for tokens in (1, 12, 256, 2048):
        assert tcfg.capacity(tokens) == jcfg.capacity(tokens)


def test_small_geometry():
    cfg = tmoe.MoEConfig.small()
    assert cfg.num_params() == 4_761_913_344
    assert (cfg.head_dim, cfg.capacity(2048)) == (128, 640)
    assert cfg.layers * cfg.experts * cfg.hidden * cfg.ffn == 1_476_395_008


def test_init_params_layout_dtypes_and_determinism():
    jcfg = jmoe.MoEConfig.tiny()
    cfg = torch_cfg(jcfg)
    a = tmoe.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = tmoe.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    ref = jax.eval_shape(lambda: jmoe.init_params(jax.random.key(0), jcfg))
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        got = _leaf(a, path)
        assert tuple(got.shape) == leaf.shape
        assert got.dtype == TDT[leaf.dtype.type], path
        assert torch.equal(got, _leaf(b, path))
    assert a["layers"]["router"].dtype == torch.float32
    w = a["layers"]["w_gate"].float()
    assert w.abs().max() <= 3.0 / cfg.hidden ** 0.5 + 1e-6


# -- routing ------------------------------------------------------------------


def _probs(case):
    rng = np.random.default_rng(1)
    if case == "tied":
        # a zero router: every probability 1/E, so every top-k is a tie,
        # broken toward the lower expert; experts 0 and 1 overflow
        return np.full((2, 24, 4), 0.25, np.float32), 2, 5
    logits = rng.standard_normal((3, 40, 6)).astype(np.float32) * 2
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), -1))
    # "roomy": room for every token (an expert takes a token once);
    # "drops": capacity 6 for 40 tokens x 2 slots over 6 experts
    return probs, 2, 40 if case == "roomy" else 6


@pytest.mark.parametrize("case", ["roomy", "drops", "tied"])
def test_route_matches(case):
    # dispatch is exact (integer positions on both sides); combine holds
    # the same normalized f32 top-k values, divided in one order
    probs, k, cap = _probs(case)
    dj, cj = jmoe.route(jnp.asarray(probs), k, cap)
    dt, ct = tmoe.route(torch.from_numpy(probs), k, cap)
    assert dt.dtype == torch.bool and ct.dtype == torch.float32
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-6)
    kept = dt.numpy().sum()
    if case == "roomy":
        assert kept == probs.shape[0] * probs.shape[1] * k
    else:
        assert kept < probs.shape[0] * probs.shape[1] * k   # tokens dropped
    if case == "tied":
        assert set(np.nonzero(dt.numpy().any(-1))[2]) == {0, 1}


def _ffn_inputs(jcfg, seed, zero_router=False):
    lp = jax.tree.map(lambda a: a[0], jax_tree(jcfg, seed)["layers"])
    if zero_router:
        lp["router"] = np.zeros_like(lp["router"])
    y = np.random.default_rng(seed).standard_normal(
        (2, 24, jcfg.hidden)).astype(np.float32)
    return lp, y


@pytest.mark.parametrize("zero_router", [False, True])
def test_moe_ffn_output_and_aux_match(zero_router):
    # f32 throughout: the one-hot einsums copy exactly, the expert
    # products sum in other orders (1e-5); a zero router ties every
    # token and drops the overflow of experts 0 and 1
    jcfg = tiny()
    lp, y = _ffn_inputs(jcfg, 2, zero_router)
    out_j, aux_j = jax.jit(functools.partial(jmoe._moe_ffn, jcfg))(
        jax.tree.map(jnp.asarray, lp), jnp.asarray(y))
    out_t, aux_t = tmoe._moe_ffn(
        torch_cfg(jcfg), tmoe.params_from_jax(lp, "cpu"), torch.from_numpy(y))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5)
    assert abs(aux_t.item() - float(aux_j)) <= 1e-6


def test_route_gradient_reaches_router_through_combine_only():
    # the gradient reaches the router through probs (the aux loss) and the
    # normalized top-k values inside combine; dispatch carries none
    jcfg = tiny()
    lp, y = _ffn_inputs(jcfg, 3)

    def loss_j(router):
        out, aux = jmoe._moe_ffn(jcfg, {**jax.tree.map(jnp.asarray, lp),
                                        "router": router}, jnp.asarray(y))
        return jnp.sum(out ** 2) + aux

    g_j = jax.jit(jax.grad(loss_j))(jnp.asarray(lp["router"]))
    params = tmoe.params_from_jax(lp, "cpu")
    params["router"].requires_grad_()
    out, aux = tmoe._moe_ffn(torch_cfg(jcfg), params, torch.from_numpy(y))
    (g_t,) = torch.autograd.grad((out ** 2).sum() + aux, params["router"])
    assert _rel(g_t, g_j) < 1e-5


# -- the model ----------------------------------------------------------------


def _record_routes(monkeypatch):
    """The router probabilities [B, S, E] of every layer, in order, from
    both models' ``route`` (JAX's through a host callback in its scan)."""
    seen = {"jax": [], "torch": []}
    real_j, real_t = jmoe.route, tmoe.route

    def route_j(probs, k, cap):
        jax.debug.callback(lambda p: seen["jax"].append(np.array(p)), probs,
                           ordered=True)
        return real_j(probs, k, cap)

    def route_t(probs, k, cap):
        seen["torch"].append(probs.detach().numpy().copy())
        return real_t(probs, k, cap)

    monkeypatch.setattr(jmoe, "route", route_j)
    monkeypatch.setattr(tmoe, "route", route_t)
    return seen


def _top_k(probs, k):
    """Each token's top-k expert set, ties to the lower index."""
    return np.sort(np.argsort(-probs, axis=-1, kind="stable")[..., :k], -1)


def _flips(seen, k):
    """(b, s) of every token whose top-k differs between the two models in
    some layer, and whether each such flip sits at a near-tie: the port's
    k-th and (k+1)-th probabilities closer than twice the largest
    probability difference between the models in that layer."""
    flips, explained = set(), True
    for pj, pt in zip(seen["jax"], seen["torch"], strict=True):
        dev = np.abs(pj - pt).max()
        desc = -np.sort(-pt, -1)
        for b, s in np.argwhere((_top_k(pj, k) != _top_k(pt, k)).any(-1)):
            flips.add((int(b), int(s)))
            explained &= bool(desc[b, s, k - 1] - desc[b, s, k] < 2 * dev)
    return flips, explained


@pytest.mark.parametrize("case", ["tiny_f32", "flash_bf16"])
def test_forward_logits_and_aux_match(jax_kernels, monkeypatch, case):
    # f32, plain attention: summation order only, every token routed alike
    # and the logits within 1e-5.  bf16 through flash attention: every
    # matmul output is rounded in other orders, the dense model's
    # tolerance (6e-2) holds the logits, and the router's bf16 input moves
    # its probabilities by up to ~1e-2 (7.0e-3 measured), which flips the
    # top-k of a token whose k-th and (k+1)-th experts are that close
    # (1 token of 256 here: 0.168 against 0.167): such a token's FFN output
    # is another expert's, so it is held to this account instead -- at
    # most 1% of the tokens, each at a near-tie; the aux loss moves by
    # E * 2 / (B * S) per flip beside 1e-3 of probability noise
    if case == "tiny_f32":
        jcfg, attn, seq, atol, flip_share = tiny(), None, 12, 1e-5, 0.0
    else:
        jcfg, attn, seq, atol, flip_share = (
            flash_cfg(jnp.bfloat16), jpa.flash_attention, 128, 6e-2, 0.01)
    tree = jax_tree(jcfg, 4)
    tokens = np.random.default_rng(5).integers(0, 256, (2, seq),
                                               dtype=np.int32)
    seen = _record_routes(monkeypatch)
    ref, aux_j = jax.jit(functools.partial(jmoe.forward, cfg=jcfg,
                                           attn_fn=attn))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(tokens))
    ref = _np(ref)
    out, aux_t = tmoe.forward(tmoe.params_from_jax(tree, "cpu"),
                              torch.from_numpy(tokens).long(),
                              torch_cfg(jcfg))
    assert out.dtype == torch.float32 and out.shape == (2, seq, 256)
    flips, explained = _flips(seen, jcfg.experts_per_token)
    assert len(flips) <= flip_share * tokens.size and explained, flips
    keep = np.ones(tokens.shape, bool)
    for b, s in flips:
        keep[b, s] = False
    np.testing.assert_allclose(out.numpy()[keep], ref[keep], atol=atol)
    aux_tol = 1e-5 if case == "tiny_f32" else \
        1e-3 + jcfg.experts * 2 * len(flips) / tokens.size
    assert abs(aux_t.item() - float(aux_j)) <= aux_tol


@pytest.fixture(scope="module")
def jax_tiny():
    """The reference's loss and gradients at the tiny config (f32, full
    logits), computed once for the tests below."""
    jcfg = tiny()
    tree = jax_tree(jcfg, 8)
    tokens = np.random.default_rng(9).integers(0, 256, (4, 17),
                                               dtype=np.int32)
    loss, grads = jax.jit(jax.value_and_grad(jmoe.loss_fn),
                          static_argnums=2)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(tokens), jcfg)
    return jcfg, tree, tokens, float(loss), grads


@pytest.mark.parametrize("xent_chunk", [0, 8])
def test_loss_fn_full_and_chunked_match(jax_tiny, xent_chunk):
    # f32: the cross entropy and the aux term sum in other orders only;
    # the chunked loss is the reference's full one
    jcfg, tree, tokens, loss_j, _ = jax_tiny
    loss_t = tmoe.loss_fn(tmoe.params_from_jax(tree, "cpu"),
                          torch.from_numpy(tokens),
                          torch_cfg(jcfg, xent_chunk=xent_chunk))
    assert abs(loss_t.item() - loss_j) <= 1e-5 * loss_j
    if xent_chunk:
        chunked_j = jax.jit(jmoe.loss_fn, static_argnums=2)(
            jax.tree.map(jnp.asarray, tree), jnp.asarray(tokens),
            dataclasses.replace(jcfg, xent_chunk=xent_chunk))
        assert abs(loss_t.item() - float(chunked_j)) <= 1e-5 * loss_j


def _loss_and_grads(cfg, tree, tokens):
    params = tmoe.params_from_jax(tree, "cpu")
    leaves = [t.requires_grad_() for t in ttraining.tree_leaves(params)]
    loss = tmoe.loss_fn(params, torch.from_numpy(tokens), cfg)
    grads = torch.autograd.grad(loss, leaves)
    return params, loss.item(), dict(zip(map(id, leaves), grads))


@pytest.mark.parametrize("policy", [None, "dots", "full", "ffn"])
def test_grads_match_jax_under_each_remat_policy(jax_tiny, policy):
    # f32, plain attention: summation order only, 1e-5 in relative norm
    # per leaf; a remat policy replays the same ops on the same inputs,
    # so it gives remat=False's loss and gradients
    jcfg, tree, tokens, loss_j, grads_j = jax_tiny
    cfg = torch_cfg(jcfg) if policy is None else torch_cfg(
        jcfg, remat=True, remat_policy=policy)
    params, loss_t, grads_t = _loss_and_grads(cfg, tree, tokens)
    assert abs(loss_t - loss_j) <= 1e-5 * loss_j
    for path, jg in jax.tree_util.tree_leaves_with_path(grads_j):
        leaf = _leaf(params, path)
        g = grads_t[id(leaf)]
        assert g.dtype == leaf.dtype and g.shape == leaf.shape, path
        assert _rel(g, jg) < 1e-5, (path, _rel(g, jg))


def test_grads_match_jax_ffn_offload(jax_tiny):
    # the reference's "ffn_offload" off the TPU keeps "ffn"'s save set in
    # device memory, and its MoE layer tags no name, so it saves nothing;
    # the port's saves nothing either: f32 summation order only, 1e-5
    jcfg, tree, tokens, _, _ = jax_tiny
    jcfg = dataclasses.replace(jcfg, remat=True, remat_policy="ffn_offload")
    loss_j, grads_j = jax.jit(jax.value_and_grad(jmoe.loss_fn),
                              static_argnums=2)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(tokens), jcfg)
    params, loss_t, grads_t = _loss_and_grads(torch_cfg(jcfg), tree, tokens)
    assert abs(loss_t - float(loss_j)) <= 1e-5 * float(loss_j)
    for path, jg in jax.tree_util.tree_leaves_with_path(grads_j):
        assert _rel(grads_t[id(_leaf(params, path))], jg) < 1e-5, path


def test_grads_match_jax_flash_route(jax_kernels):
    # both models run flash attention and the fused RMSNorm forward and
    # backward (JAX: Pallas in interpret mode; port: the plain versions),
    # chunked cross entropy and "dots" remat, in f32; the flash kernels'
    # bf16 roundings flip in other summation orders, as in the dense
    # model's flash test: loss within 1e-4, each gradient within 3e-3
    jcfg = flash_cfg(xent_chunk=64)
    tree = jax_tree(jcfg, 10)
    tokens = np.random.default_rng(11).integers(0, 256, (2, 129),
                                                dtype=np.int32)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        functools.partial(jmoe.loss_fn, cfg=jcfg,
                          attn_fn=jpa.flash_attention)))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(tokens))
    params, loss_t, grads_t = _loss_and_grads(
        torch_cfg(jcfg, remat=True, remat_policy="dots"), tree, tokens)
    assert abs(loss_t - float(loss_j)) < 1e-4 * float(loss_j)
    for path, jg in jax.tree_util.tree_leaves_with_path(grads_j):
        g = grads_t[id(_leaf(params, path))]
        assert _rel(g, jg) < 3e-3, (path, _rel(g, jg))


class _CountOps(TorchDispatchMode):
    def __init__(self, ops):
        super().__init__()
        self.counts = dict.fromkeys(ops, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.counts:
            self.counts[func] += 1
        return func(*args, **(kwargs or {}))


def _backward_counts(cfg):
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    params = tmoe.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    leaves = [t.requires_grad_() for t in ttraining.tree_leaves(params)]
    loss = tmoe.loss_fn(params, torch.randint(0, 256, (2, 9)), cfg)
    with _CountOps((mm, bmm)) as counter:
        torch.autograd.grad(loss, leaves)
    return counter.counts[mm], counter.counts[bmm]


def test_dots_layer_reruns_no_matmul_in_its_backward():
    # "dots" saves every matmul output, the einsums' bmm among them: its
    # backward runs remat=False's gradient products and nothing more.
    # "full" replays the layer up to the last tensor a backward reads:
    # the router and the 4 attention projections (mm), and the plain
    # attention's two products and 4 of the 5 einsums (bmm: the combine
    # einsum's output no backward reads)
    base = tmoe.MoEConfig.tiny()
    none = _backward_counts(base)
    dots = _backward_counts(dataclasses.replace(base, remat=True))
    full = _backward_counts(dataclasses.replace(base, remat=True,
                                                remat_policy="full"))
    assert dots == none
    assert full == (none[0] + 5 * base.layers, none[1] + 6 * base.layers)


# -- optimizer steps ----------------------------------------------------------


def _jax_update(optimizer, grads, params, jit=True):
    """The reference optimizer's first step (the 8-bit one on its jnp
    path), jitted or one op at a time: (new params, new state)."""
    jo = (jopt.adamw8bit(LR, weight_decay=0.1) if optimizer == "adam8bit"
          else optax.adamw(LR, weight_decay=0.1))

    def step(g, p):
        updates, state = jo.update(g, jo.init(p), p)
        return optax.apply_updates(p, updates), state

    return (jax.jit(step) if jit else step)(grads, params)


@pytest.mark.parametrize("optimizer", [None, "adam8bit"])
def test_train_step_matches_jax(jax_tiny, optimizer, monkeypatch):
    # the port's make_train_step against the reference's gradient and
    # optimizer from the same parameters: the first step moves each
    # weight by about ±lr * sign(g) plus the decay, so a gradient near
    # zero may flip the sign between the two: within 2 * lr (the dense
    # model's train-step tolerance)
    monkeypatch.setenv("TPUNET_ADAM8_FUSED", "0")
    jcfg, tree, tokens, loss_j, grads_j = jax_tiny
    new_j, _ = _jax_update(optimizer, grads_j,
                           jax.tree.map(jnp.asarray, tree))
    step, _, opt = tmoe.make_train_step(torch_cfg(jcfg), optimizer=optimizer,
                                        device="cpu")
    params_t = tmoe.params_from_jax(tree, "cpu")
    params_t, state, loss_t = step(params_t, opt.init(params_t),
                                   torch.from_numpy(tokens))
    assert state["count"] == 1
    assert abs(loss_t.item() - loss_j) < 1e-5 * loss_j
    for path, jleaf in jax.tree_util.tree_leaves_with_path(new_j):
        after = _leaf(params_t, path).detach()
        assert after.dtype == TDT[jleaf.dtype.type], path
        np.testing.assert_allclose(after.numpy(), _np(jleaf), rtol=0,
                                   atol=2 * LR, err_msg=str(path))
        assert not np.array_equal(after.numpy(), _leaf(tree, path)), path


def test_adam8_on_the_moe_leaves_bit_identical_to_jnp_path(jax_tiny,
                                                            monkeypatch):
    # the reference's gradients through the port's 8-bit update (the plain
    # version) against the reference's jnp path, one op at a time, and
    # optax.apply_updates (jitted, XLA fuses multiply-adds: an ulp away),
    # on the leaves the dense model lacks: the f32 router [L, h, E] and a
    # 4-D expert leaf, both in whole-row blocks (E 4 and ffn 128 < 256);
    # the same bits everywhere
    monkeypatch.setenv("TPUNET_ADAM8_FUSED", "0")
    jcfg, tree, _, _, grads_j = jax_tiny
    names = ("router", "w_gate")
    params_np = {n: tree["layers"][n] for n in names}
    new_j, js = _jax_update(
        "adam8bit", {n: grads_j["layers"][n] for n in names},
        jax.tree.map(jnp.asarray, params_np), jit=False)
    to = topt.adamw8bit(LR, weight_decay=0.1)
    params_t = tmoe.params_from_jax(params_np, "cpu")
    state = to.init(params_t)
    grads_t = tmoe.params_from_jax(
        {n: np.asarray(grads_j["layers"][n]) for n in names}, "cpu")
    to.apply(params_t, [grads_t[n] for n in names], state)
    assert tuple(state["m"]["router"].scale.shape) == (jcfg.layers,
                                                       jcfg.hidden, 1)
    assert params_t["w_gate"].dim() == 4
    for n in names:
        np.testing.assert_array_equal(_bits(params_t[n]), _bits(new_j[n]),
                                      err_msg=n)
        for side in ("m", "v"):
            got, want = state[side][n], getattr(js, side)[n]
            np.testing.assert_array_equal(_bits(got.q), _bits(want.q),
                                          err_msg=n)
            np.testing.assert_array_equal(_bits(got.scale),
                                          _bits(want.scale), err_msg=n)


def _bits(x) -> np.ndarray:
    """The raw bits of a torch tensor or a JAX array (bf16 and float8
    included), for equality that sees every bit."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.view({1: torch.uint8, 2: torch.int16,
                       4: torch.int32}[x.element_size()]).numpy()
    x = np.asarray(x)
    return x.view({1: np.uint8, 2: np.int16, 4: np.int32}[x.dtype.itemsize])


# -- workload CLI and entry points --------------------------------------------


def _train(argv, capsys):
    from tpu_network_operator_torch.workload import cli

    assert cli.main(["train", "--device", "cpu", "--model", "moe",
                     "--preset", "tiny", "--batch", "2", "--seq-len", "16",
                     *argv]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_workload_train_moe_prints_json(capsys):
    out = _train(["--steps", "2"], capsys)
    assert out["metric"] == "moe:tiny train throughput"
    assert out["unit"] == "tokens/sec/chip" and out["value"] > 0
    assert out["steps"] == 2 and np.isfinite(out["final_loss"])
    assert out["mesh"] == {"devices": 1, "device": "cpu"}


def test_workload_train_moe_resumes_adam8_from_checkpoint(tmp_path, capsys):
    # 3 steps in one run, against 2 steps and a resume for 1 more, on a
    # token file: the iterator restarts at the restored step and the CPU
    # ops are deterministic, so the last losses are equal
    data = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 256, 20_000,
                                      dtype=np.uint16).tofile(data)

    def run(name, steps):
        return _train(["--optimizer", "adam8bit", "--data", str(data),
                       "--checkpoint-dir", str(tmp_path / name),
                       "--steps", str(steps)], capsys)

    whole = run("whole", 3)
    first, second = run("split", 2), run("split", 1)
    assert (whole["resumed_from"], first["resumed_from"],
            second["resumed_from"]) == (0, 0, 2)
    assert second["final_loss"] == whole["final_loss"]
    assert TrainCheckpointer(tmp_path / "split").all_steps() == [2, 3]


def test_workload_train_checks_the_preset_per_model():
    from tpu_network_operator_torch.workload import cli

    with pytest.raises(SystemExit, match="unknown preset 'small' for model "
                                         "'llama'"):
        cli.main(["train", "--device", "cpu", "--preset", "small"])
    with pytest.raises(SystemExit, match="for model 'moe'"):
        cli.main(["train", "--device", "cpu", "--model", "moe",
                  "--preset", "llama3-1b"])


def test_moe_entry_points_raise_without_cuda(monkeypatch):
    from tpu_network_operator_torch.workload import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tmoe.MoEConfig.tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmoe.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmoe.make_train_step(cfg, optimizer="adam8bit")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "--model", "moe", "--preset", "tiny"])
