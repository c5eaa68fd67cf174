"""The port's train step held against the JAX package's, on the CPU.

Parameters are made by the JAX package and moved across with
``params_from_jax``; tokens, activations and gradients are made with
numpy.  Where the JAX model reaches its Pallas kernels (flash attention and
the fused RMSNorm, forward and backward), they run in interpret mode, routed
there through the seams the JAX suite uses.  Each tolerance is stated
beside its reason.
"""

import ctypes
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tpu_network_operator.models import llama as jllama
from tpu_network_operator.models import training as jtraining
from tpu_network_operator_torch.models import llama as tllama
from tpu_network_operator_torch.models import training as ttraining

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _rel(a, ref):
    a, ref = _np(a), _np(ref)
    return float(np.linalg.norm(a - ref) / max(np.linalg.norm(ref), 1e-12))


def torch_cfg(jcfg):
    fields = {f.name for f in dataclasses.fields(tllama.LlamaConfig)}
    kw = {k: v for k, v in dataclasses.asdict(jcfg).items()
          if k in fields and k != "dtype"}
    dtype = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
    return tllama.LlamaConfig(**kw, dtype=dtype[jcfg.dtype])


def flash_cfg(dtype, **kw):
    """head_dim 64 and 128-token sequences: the flash gate passes on both
    sides, and 256 rows x hidden 128 pass the fused-RMSNorm gate."""
    return jllama.LlamaConfig(
        vocab_size=256, hidden=128, layers=2, heads=2, kv_heads=1, ffn=256,
        max_seq=256, remat=False, dtype=dtype, **kw)


@pytest.fixture
def jax_kernels(monkeypatch):
    """Route the JAX model through both Pallas kernels (interpret mode)."""
    monkeypatch.setattr(jllama, "_backend", lambda: "tpu", raising=True)
    monkeypatch.setenv("TPUNET_RMS_FUSED", "1")


def _by_path(tree_t, tree_j):
    """Pairs (torch leaf, jax leaf) matched by key path."""
    pairs = []
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree_j):
        node = tree_t
        for key in path:
            node = node[key.key]
        pairs.append((node, leaf, "/".join(k.key for k in path)))
    return pairs


# -- loss math ----------------------------------------------------------------


def test_next_token_xent_matches():
    # f32 logsumexp and gather on both sides: summation order only
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 9, 64)) * 3).astype(np.float32)
    tokens = rng.integers(0, 64, (2, 10), dtype=np.int32)
    ref = float(jtraining.next_token_xent(jnp.asarray(logits),
                                          jnp.asarray(tokens)))
    out = ttraining.next_token_xent(torch.from_numpy(logits),
                                    torch.from_numpy(tokens))
    assert out.dtype == torch.float32
    assert abs(out.item() - ref) < 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_xent_value_and_grads_match(dtype):
    # the projection has f32 output from operands in the model dtype on
    # both sides.  f32: summation order only (1e-5 relative).  bf16: the
    # backward rounds the f32 logits cotangent to bf16 before its GEMMs
    # (the JAX CPU run keeps it f32), and both gradients are rounded to
    # bf16 once: 1e-2 in relative norm
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 96)) / 8).astype(np.float32)
    tokens = rng.integers(0, 96, (2, 33), dtype=np.int32)
    jdt, tdt = JDT[dtype], TDT[dtype]
    loss_j, (gx_j, gw_j) = jax.value_and_grad(
        lambda a, b: jtraining.chunked_next_token_xent(
            a, b, jnp.asarray(tokens), 8), argnums=(0, 1))(
        jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tw = torch.from_numpy(w).to(tdt).requires_grad_()
    loss_t = ttraining.chunked_next_token_xent(
        tx, tw, torch.from_numpy(tokens), 8)
    gx_t, gw_t = torch.autograd.grad(loss_t, (tx, tw))
    assert loss_t.dtype == torch.float32
    assert gx_t.dtype == tdt and gw_t.dtype == tdt
    assert abs(loss_t.item() - float(loss_j)) < 1e-5 * abs(float(loss_j))
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert _rel(gx_t.float(), gx_j) < tol
    assert _rel(gw_t.float(), gw_j) < tol


def test_chunked_xent_equals_full_and_rejects_ragged():
    # f32: the chunked loss is the full loss, summed in another order
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 16, 32, generator=g)
    w = torch.randn(32, 50, generator=g)
    tokens = torch.randint(0, 50, (2, 17), generator=g)
    full = ttraining.next_token_xent(x @ w, tokens)
    chunked = ttraining.chunked_next_token_xent(x, w, tokens, 4)
    assert abs(full.item() - chunked.item()) < 1e-5
    with pytest.raises(ValueError, match="not divisible"):
        ttraining.chunked_next_token_xent(x, w, tokens, 5)


# -- the model's loss and gradients -------------------------------------------


def test_loss_and_grads_match_jax_flash_route(jax_kernels):
    # both models run flash attention and the fused RMSNorm forward and
    # backward (JAX: the Pallas kernels in interpret mode; port: the plain
    # versions) and the chunked cross entropy, in f32 (the full-logits
    # loss is held by the train-step test below).  Both round only where the flash kernels round
    # (q*scale, dO, p, dS to bf16), but f32 summation order flips a few of
    # those roundings, and the flips carry through two layers forward and
    # back: loss within 1e-4, each gradient within 3e-3 in relative norm
    # (1.3e-3 measured, on wq; the same model in bf16 measured 1.3e-2,
    # where every matmul output is rounded in other orders)
    jcfg = flash_cfg(jnp.float32, xent_chunk=64)
    tree = jax.tree.map(np.asarray, jllama.init_params(jax.random.key(1),
                                                       jcfg))
    tokens = np.random.default_rng(3).integers(0, 256, (2, 129),
                                               dtype=np.int32)
    loss_j, grads_j = jax.value_and_grad(jllama.loss_fn)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(tokens), jcfg)

    params = tllama.params_from_jax(tree, "cpu")
    leaves = [t.requires_grad_() for t in ttraining.tree_leaves(params)]
    loss_t = tllama.loss_fn(params, torch.from_numpy(tokens), torch_cfg(jcfg))
    grads_t = dict(zip(map(id, leaves), torch.autograd.grad(loss_t, leaves)))

    assert abs(loss_t.item() - float(loss_j)) < 1e-4 * float(loss_j)
    for leaf, jg, name in _by_path(params, grads_j):
        g = grads_t[id(leaf)]
        assert g.dtype == leaf.dtype and g.shape == leaf.shape, name
        assert _rel(g, jg) < 3e-3, (name, _rel(g, jg))


def _loss_and_grads(cfg, tree, tokens):
    params = tllama.params_from_jax(tree, "cpu")
    leaves = [t.requires_grad_() for t in ttraining.tree_leaves(params)]
    loss = tllama.loss_fn(params, tokens, cfg)
    return loss.item(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("policy", ["dots", "ffn", "ffn_lite", "ffn_offload",
                                    "full"])
def test_remat_policies_match_no_remat(policy):
    # eager recompute replays the same ops on the same inputs in the same
    # order, so every policy gives remat=False's loss and gradients; in
    # bf16 the JAX suite allows 1e-3 between policies (XLA fuses them
    # differently), here the spread is 0 and 1e-6 is summation noise
    jcfg = flash_cfg(jnp.bfloat16)
    tree = jax.tree.map(np.asarray, jllama.init_params(jax.random.key(4),
                                                       jcfg))
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (2, 129), dtype=np.int32))
    base = torch_cfg(jcfg)
    ref_loss, ref_grads = _loss_and_grads(base, tree, tokens)
    loss, grads = _loss_and_grads(
        dataclasses.replace(base, remat=True, remat_policy=policy), tree,
        tokens)
    assert abs(loss - ref_loss) <= 1e-6
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-6)


def test_ffn_offload_loss_and_grads_match_jax():
    # the reference's "ffn_offload" off the TPU keeps "ffn"'s save set in
    # device memory (save_only_these_names); the port's keeps it on the
    # CPU as well.  f32 at the tiny config, plain attention: summation
    # order only, loss 1e-5, each gradient 1e-5 in relative norm
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32,
                               remat=True, remat_policy="ffn_offload")
    tree = jax.tree.map(np.asarray, jllama.init_params(jax.random.key(6),
                                                       jcfg))
    tokens = np.random.default_rng(7).integers(0, 256, (2, 17),
                                               dtype=np.int32)
    loss_j, grads_j = jax.jit(jax.value_and_grad(jllama.loss_fn),
                              static_argnums=2)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(tokens), jcfg)
    params = tllama.params_from_jax(tree, "cpu")
    leaves = [t.requires_grad_() for t in ttraining.tree_leaves(params)]
    loss_t = tllama.loss_fn(params, torch.from_numpy(tokens),
                            torch_cfg(jcfg))
    grads_t = dict(zip(map(id, leaves), torch.autograd.grad(loss_t, leaves)))
    assert abs(loss_t.item() - float(loss_j)) < 1e-5 * float(loss_j)
    for leaf, jg, name in _by_path(params, grads_j):
        assert _rel(grads_t[id(leaf)], jg) < 1e-5, (name, _rel(
            grads_t[id(leaf)], jg))


class _CountOps(TorchDispatchMode):
    def __init__(self, ops):
        super().__init__()
        self.ops = ops
        self.counts = {op: 0 for op in ops}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.counts:
            self.counts[func] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy,mm_rerun", [
    ("full", 6), ("dots", 0), ("ffn", 3), ("ffn_lite", 4),
    ("ffn_offload", 3)])
def test_remat_policies_save_what_they_name(policy, mm_rerun):
    # what the backward recomputes per layer.  The checkpoint stops
    # replaying once it has every tensor the backward needs, so the last
    # projection (w_down, whose output no backward reads) never reruns:
    # "full" reruns the other 6; "dots" takes every matmul output from its
    # cache; "ffn" saves resid_mid, ffn_gate and ffn_up, so only the
    # attention half's q, k and v projections rerun, as under XLA's
    # save_only_these_names; "ffn_lite" recomputes ffn_up as well;
    # "ffn_offload" saves what "ffn" saves (on the CPU, where it stays)
    mm = torch.ops.aten.mm.default
    cfg = dataclasses.replace(tllama.LlamaConfig.tiny(), remat=True,
                              remat_policy=policy)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0),
                                "cpu")
    leaves = [t.requires_grad_() for t in ttraining.tree_leaves(params)]
    tokens = torch.randint(0, 256, (2, 9))
    loss = tllama.loss_fn(params, tokens, cfg)
    with _CountOps((mm,)) as counter:
        torch.autograd.grad(loss, leaves)
    # gradient GEMMs: 2 per projection (dx, dW) plus the lm_head's 2
    grad_mms = (2 * 7 * cfg.layers + 2)
    assert counter.counts[mm] == grad_mms + mm_rerun * cfg.layers


def test_remat_offload_and_unknown_policies_raise():
    # "ffn_offload" is ported (test_remat_policies_match_no_remat); an
    # unknown name still raises
    base = dataclasses.replace(tllama.LlamaConfig.tiny(), remat=True)
    params = tllama.init_params(base, torch.Generator().manual_seed(0),
                                "cpu")
    tokens = torch.randint(0, 256, (1, 9))
    with pytest.raises(ValueError, match="unknown remat_policy"):
        tllama.loss_fn(params, tokens,
                       dataclasses.replace(base, remat_policy="dotz"))


# -- AdamW --------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_optax_on_shared_grads(dtype):
    # the same gradients feed both for three steps.  f32: optax's order of
    # operations in f32 on both sides, so ~1 ulp per step.  bf16: each
    # torch op rounds to bf16, where XLA may keep an intermediate in f32
    # inside a fusion; a flipped rounding of the update can move p's own
    # rounding by one bf16 ulp (2^-8 relative)
    rng = np.random.default_rng(6)
    shapes = {"a": (8, 16), "b": {"c": (32,), "d": (4, 4, 4)}}
    jdt, tdt = JDT[dtype], TDT[dtype]

    def make(fn):
        return jax.tree.map(fn, shapes, is_leaf=lambda s: isinstance(s,
                                                                     tuple))

    p_np = make(lambda s: rng.standard_normal(s).astype(np.float32))
    g_np = [make(lambda s: (rng.standard_normal(s) * 10.0 ** rng.integers(
        -4, 1)).astype(np.float32)) for _ in range(3)]

    opt = optax.adamw(3e-4, weight_decay=0.1)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), p_np)
    js = opt.init(jp)
    tp = ttraining.tree_map(lambda a: torch.from_numpy(a).to(tdt), p_np)
    topt = ttraining.adamw(3e-4, weight_decay=0.1)
    ts = topt.init(tp)
    for g in g_np:
        jg = jax.tree.map(lambda a: jnp.asarray(a, jdt), g)
        updates, js = opt.update(jg, js, jp)
        jp = optax.apply_updates(jp, updates)
        tg = [torch.from_numpy(a).to(tdt) for a in
              ttraining.tree_leaves(g)]
        tp, ts = topt.apply(tp, tg, ts)
    assert ts["count"] == 3
    for leaf, jleaf, name in _by_path(tp, jp):
        assert leaf.dtype == tdt, name
        if dtype == "float32":
            np.testing.assert_allclose(leaf.numpy(), _np(jleaf), rtol=1e-6,
                                       atol=1e-7, err_msg=name)
        else:
            np.testing.assert_allclose(leaf.float().numpy(), _np(jleaf),
                                       rtol=2 ** -8, atol=1e-6,
                                       err_msg=name)
    for leaf, jleaf, name in _by_path(ts["mu"], js[0].mu):
        np.testing.assert_allclose(leaf.float().numpy(), _np(jleaf),
                                   rtol=1e-5 if dtype == "float32"
                                   else 2 ** -7, atol=1e-9, err_msg=name)


def _adamw_leaves(dtype=torch.bfloat16, shapes=((8, 16), (32,), (4, 4, 4)),
                  seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = {f"p{i}": torch.randn(s, generator=gen).to(dtype)
              for i, s in enumerate(shapes)}
    grads = [torch.randn(s, generator=gen).mul_(1e-2).to(dtype)
             for s in shapes]
    return params, grads


def test_adamw_cpu_leaves_take_the_plain_path():
    # CPU leaves go through adamw_plain, as the eager loop always did: no
    # kernel launch, no count of fused values, the plain version's bits
    from torch.profiler import ProfilerActivity, profile

    from tpu_network_operator_torch import tracing
    from tpu_network_operator_torch.ops import _kernels

    params, grads = _adamw_leaves()
    ref = {k: p.clone() for k, p in params.items()}
    opt = ttraining.adamw(3e-4, weight_decay=0.1)
    state, ref_state = opt.init(params), opt.init(ref)
    _kernels.reset_launches()
    tracing.reset_counters()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for count in (1, 2):
                out = opt.apply(params, grads, state)
                assert out[0] is params and out[1] is state
                ttraining.adamw_plain(
                    list(zip(ref.values(), grads, ref_state["mu"].values(),
                             ref_state["nu"].values())),
                    opt.consts(count, {torch.bfloat16}))
        assert _kernels.LAUNCHES["adamw_fused"] == 0
        assert "optim.adamw_fused_elems" not in tracing.counters()
    finally:
        tracing.reset_counters()
    assert state["count"] == 2
    for a, b in zip([*params.values(), *state["mu"].values(),
                     *state["nu"].values()],
                    [*ref.values(), *ref_state["mu"].values(),
                     *ref_state["nu"].values()]):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("dtype,count", [(torch.bfloat16, 1),
                                         (torch.bfloat16, 1000),
                                         (torch.float16, 3),
                                         (torch.float32, 7)])
def test_adamw_consts_are_the_constants_rounded_to_the_dtype(dtype, count):
    # each constant rounded to the leaf's dtype through float64, the bias
    # corrections first taken in f32: what the eager loop's per-leaf c()
    # gave, now once a step for each dtype
    opt = ttraining.adamw(3e-4, weight_decay=0.1)
    k = opt.consts(count, [dtype])[dtype]
    bc1, bc2 = ttraining.bias_corrections(0.9, 0.999, count)

    def c(x):
        return torch.tensor(float(x), dtype=torch.float64).to(dtype).item()

    assert tuple(k) == tuple(c(x) for x in (0.9, 1 - 0.9, 0.999, 1 - 0.999,
                                            bc1, bc2, 1e-8, 0.1, -3e-4))
    if dtype == torch.bfloat16:
        assert (k.b2, k.omb1) == (1.0, 0.10009765625)
    kc = list(ttraining._kernel_consts({dtype: k}))
    code = ttraining.ADAMW_DTYPES[dtype]
    row = kc[9 * code:9 * code + 9]
    recip = [float(np.float32(1.0) / np.float32(c)) for c in (k.c1, k.c2)]
    assert row == pytest.approx([k.b1, k.omb1, k.b2, k.omb2, *recip, k.eps,
                                 k.wd, k.neg_lr], rel=0, abs=0)
    assert not any(kc[:9 * code] + kc[9 * code + 9:])


def test_adamw_tables_number_units_and_pick_the_vector_path():
    # 16-byte units (8 values in 16 bits, 4 in f32) numbered through the
    # table, an empty leaf left out, a view 2 bytes off its buffer on the
    # scalar loop, and a new table every 64 leaves
    buf = torch.zeros(1 + 8 * 257, dtype=torch.bfloat16)
    leaves = []
    for p in (torch.zeros(7, 13, dtype=torch.bfloat16),
              torch.zeros(0, 4), torch.zeros(5),
              torch.zeros(3, 5, dtype=torch.float16), buf[1:].view(8, 257)):
        leaves.append((p, torch.zeros_like(p), torch.zeros_like(p),
                       torch.zeros_like(p)))
    [table] = ttraining.adamw_tables(leaves)
    got = [(e.start, e.n, e.dtype, e.vec) for e in table]
    aligned = [all(t.data_ptr() % 16 == 0 for t in leaf) for leaf in leaves]
    assert got == [(0, 91, 1, int(aligned[0])), (12, 5, 0, int(aligned[2])),
                   (14, 15, 2, int(aligned[3])), (16, 2056, 1, 0)]
    many = [(t, t, t, t) for t in torch.zeros(130, 4).unbind()]
    tables = ttraining.adamw_tables(many)
    assert [len(t) for t in tables] == [64, 64, 2]
    assert [t[0].start for t in tables] == [0, 0, 0]
    assert ctypes.sizeof(ttraining.AdamWLeafEntry) == 56


@pytest.mark.parametrize("case,error,match", [
    ("g_dtype", ValueError, "adamw_fused takes g of p's dtype"),
    ("m_shape", ValueError, "adamw_fused takes m of p's dtype"),
    ("v_dtype", ValueError, "adamw_fused takes v of p's dtype"),
    ("float64", TypeError, "adamw_fused takes float32, bfloat16 or float16"),
    ("strided", ValueError, "adamw_fused takes contiguous tensors"),
    ("aliased", ValueError, "adamw_fused takes leaves whose tensors share"),
    ("cpu", ValueError, "adamw_fused takes CUDA tensors"),
])
def test_adamw_fused_refuses_by_name(case, error, match):
    # each refusal is raised before any kernel is built or launched
    from tpu_network_operator_torch.ops import _kernels

    p = torch.zeros(4, 8, dtype=torch.bfloat16)
    g, m, v = (torch.zeros_like(p) for _ in range(3))
    if case == "g_dtype":
        g = g.float()
    elif case == "m_shape":
        m = m.reshape(8, 4)
    elif case == "v_dtype":
        v = v.half()
    elif case == "float64":
        p, g, m, v = (t.double() for t in (p, g, m, v))
    elif case == "strided":
        p, g, m, v = (t.t() for t in (p, g, m, v))
    elif case == "aliased":
        m = p.view(4, 8)
    _kernels.reset_launches()
    k = ttraining.adamw().consts(1, {p.dtype, torch.float64})
    with pytest.raises(error, match=match):
        ttraining.adamw_fused([(p, g, m, v)], k)
    assert _kernels.LAUNCHES["adamw_fused"] == 0


# -- one whole train step -----------------------------------------------------


def test_train_step_matches_jax_make_train_step():
    # the reference's sharded step on the 8-device CPU mesh against the
    # port's single-device step, from the same parameters and tokens, in
    # f32 (bf16 is held by the AdamW and loss tests above).  The loss:
    # summation order (1e-5).  The parameters: Adam's first step moves
    # each weight by about ±lr * sign(g) plus the decay, so a gradient
    # near zero can flip the sign between the two: within 2 * lr
    from tpu_network_operator.parallel import make_mesh, plan_axes

    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    mesh = make_mesh(plan_axes(len(jax.devices())))
    step_j, init_j, _ = jllama.make_train_step(jcfg, mesh)
    params_j, opt_j = init_j(jax.random.key(7))
    tree = jax.tree.map(np.asarray, params_j)
    tokens = np.random.default_rng(8).integers(0, 256, (8, 17),
                                               dtype=np.int32)
    new_j, _, loss_j = step_j(params_j, opt_j, jnp.asarray(tokens))

    tcfg = torch_cfg(jcfg)
    step_t, _, opt = tllama.make_train_step(tcfg, device="cpu")
    params_t = tllama.params_from_jax(tree, "cpu")
    params_t, state, loss_t = step_t(params_t, opt.init(params_t),
                                     torch.from_numpy(tokens))
    assert state["count"] == 1
    assert abs(loss_t.item() - float(loss_j)) < 1e-5 * float(loss_j)
    for leaf, jleaf, name in _by_path(params_t, new_j):
        before = tree
        for key in name.split("/"):
            before = before[key]
        after = leaf.detach().numpy()
        np.testing.assert_allclose(after, _np(jleaf), rtol=0, atol=2 * 3e-4,
                                   err_msg=name)
        assert not np.array_equal(after, before), name    # the step moved it


# -- workload CLI and entry points --------------------------------------------


def test_workload_train_cpu_prints_json(capsys):
    from tpu_network_operator_torch.workload import cli

    assert cli.main(["train", "--device", "cpu", "--preset", "tiny",
                     "--steps", "2", "--batch", "2", "--seq-len", "16"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    out = json.loads(line)
    assert out["metric"] == "llama:tiny train throughput"
    assert out["unit"] == "tokens/sec/chip" and out["value"] > 0
    assert out["steps"] == 2 and np.isfinite(out["final_loss"])
    assert out["mesh"] == {"devices": 1, "device": "cpu"}


@pytest.mark.parametrize("cmd", ["generate", "train"])
def test_workload_profile_writes_a_chrome_trace(capsys, tmp_path, cmd):
    from tpu_network_operator_torch.workload import cli

    argv = {"generate": ["--batch", "2", "--prompt-len", "4",
                         "--max-new-tokens", "4"],
            "train": ["--steps", "2", "--batch", "2", "--seq-len", "16"]}
    assert cli.main([cmd, "--device", "cpu", "--preset", "tiny",
                     "--profile", str(tmp_path), *argv[cmd]]) == 0
    json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    trace = json.loads((tmp_path / f"{cmd}.trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names or "aten::addmm" in names


def test_train_entry_points_raise_without_cuda(monkeypatch):
    from tpu_network_operator_torch.workload import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tllama.make_train_step(tllama.LlamaConfig.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "--preset", "tiny"])
