"""Ring and Ulysses attention of the port on gloo ranks against the
reference's on the virtual CPU mesh.

Each world (2 and 4 ranks) is spawned once and runs every case; the
parent holds the gathered outputs and gradients to the reference's
``ring_attention`` / ``ulysses_attention`` on ``jax.devices()[:n]``, with
the Pallas chunk kernels in interpret mode for ``impl="flash"``
(``TPUNET_SP_FLASH=1``), and to the port's in-process ring driver.

Tolerances: plain per-chunk math is f32 on both sides, 2e-5; the flash
path as the dense flash kernels are held to the Pallas vjp
(``test_torch_ops_bwd.py``): atol 1e-3 in f32 and 3e-2 in bf16 (out, dq,
dk, dv).  In bf16 the reference sums each chunk's K/V cotangent in bf16
(the dtype of the chunk it carries round the ring) where the port sums in
f32 and rounds once, so bf16 also allows 2e-2 relative (2.5 bf16 ulps).

:func:`run_ranks` is the spawn helper of the port's multi-rank tests: the
children import this module (not JAX) to find their target.
:func:`free_port` and :func:`retry_on_taken_port` serve the tests that
start ranks as a launcher does, on a TCP rendezvous port.
"""

import os
import random
import socket
import time

import numpy as np
import pytest
import torch

RANK_TIMEOUT_S = 120
# the TCP store's error where its port is taken: errno 98, EADDRINUSE
PORT_TAKEN = ("EADDRINUSE", "Address already in use",
              "address already in use")


def _ephemeral_low() -> int:
    """The low end of the kernel's range for the local ports of outgoing
    connections (32768 by Linux's default)."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 32768


def free_port() -> int:
    """A TCP port for a rendezvous, free when chosen and below the
    kernel's ephemeral range.  A port from ``bind(0)`` lies in that range,
    where the kernel also numbers the outgoing connections that every
    gloo rank of a parallel test run opens: one of them can take the port
    between its release here and the rank that binds it.  A random port
    below the range is never handed out that way."""
    low = _ephemeral_low()
    rng = random.Random(time.monotonic_ns() ^ os.getpid())
    for _ in range(200):
        port = rng.randrange(10000, max(low, 10001))
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port
    raise RuntimeError(f"no free TCP port found in [10000, {low})")


def retry_on_taken_port(launch, attempts: int = 3):
    """``launch(attempt)`` (which picks its own :func:`free_port`),
    called again where it failed because its rendezvous port was taken
    when a rank bound it (another test may bind the same free port in the
    meantime): any other failure, and the last attempt's, propagate."""
    for attempt in range(attempts):
        try:
            return launch(attempt)
        except AssertionError as e:
            if attempt == attempts - 1 or not any(
                    word in str(e) for word in PORT_TAKEN):
                raise


def _without_device(rank, world, device, fn, *args):
    return fn(rank, world, *args)


def run_ranks(world, fn, *args, timeout=RANK_TIMEOUT_S):
    """``fn(rank, world, *args)`` in ``world`` gloo rank processes started
    by the port's launcher (``graft.launch_ranks``): the results in rank
    order.  A rank that raises, dies or outlasts ``timeout`` fails the
    caller's assertion with the launcher's message naming it; every
    process is gone on return."""
    from tpu_network_operator_torch import graft

    try:
        return graft.launch_ranks(world, _without_device, fn, *args,
                                  device_type="cpu", timeout=timeout)
    except RuntimeError as e:
        raise AssertionError(str(e)) from e


# -- the cases ------------------------------------------------------------------


def _cases(n):
    """name -> case: the scheme, the port's impl, the mesh axes, dtype and
    the global [B, S, H, D] inputs with a cotangent, from numpy seeds."""
    cases = {}

    def inputs(seed, b, s, h, hkv, d):
        rng = np.random.default_rng(seed)
        return [rng.standard_normal(shape, dtype=np.float32)
                for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d),
                              (b, s, h, d))]

    for dtype in ("float32", "bfloat16"):
        cases[f"ring_flash_{dtype}"] = dict(
            scheme="ring", impl="flash", axes=dict(seq=n), dtype=dtype,
            arrays=inputs(1, 1, 128 * n, 4, 2, 64))
        # head_dim 16: the flash route refuses it
        cases[f"ring_plain_{dtype}"] = dict(
            scheme="ring", impl="plain", axes=dict(seq=n), dtype=dtype,
            arrays=inputs(2, 2, 16 * n, 4, 2, 16))
        ulysses_axes = dict(seq=2, tensor=2) if n == 4 else dict(seq=n)
        cases[f"ulysses_{dtype}"] = dict(
            scheme="ulysses", impl=None, axes=ulysses_axes, dtype=dtype,
            arrays=inputs(3, 2, 32, 8, 4, 16))
    return cases


def _local(x, mesh, seq_dim=1, head_dim=2):
    x = x.chunk(mesh.size("seq"), dim=seq_dim)[mesh.coord["seq"]]
    return x.chunk(mesh.size("tensor"), dim=head_dim)[mesh.coord["tensor"]]


def _attention_rank(rank, world, cases):
    """Every case on this rank: its chunks of out, dq, dk and dv (f32)
    with its (seq, tensor) coordinate."""
    from tpu_network_operator_torch.parallel import make_mesh, plan_axes
    from tpu_network_operator_torch.parallel.ring import ring_attention
    from tpu_network_operator_torch.parallel.ulysses import ulysses_attention

    meshes, out = {}, {}
    for name, case in cases.items():
        key = tuple(sorted(case["axes"].items()))
        if key not in meshes:
            meshes[key] = make_mesh(
                plan_axes(world, fsdp=1, data=1, **case["axes"]), "cpu")
        mesh = meshes[key]
        dtype = getattr(torch, case["dtype"])
        q, k, v, do = (_local(torch.from_numpy(a).to(dtype), mesh)
                       for a in case["arrays"])
        q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
        if case["scheme"] == "ring":
            o = ring_attention(q, k, v, mesh, impl=case["impl"])
        else:
            o = ulysses_attention(q, k, v, mesh)
        grads = torch.autograd.grad(o, (q, k, v), do)
        out[name] = dict(
            coord=(mesh.coord["seq"], mesh.coord["tensor"]),
            tensors=[t.detach().float().numpy() for t in (o, *grads)])
    return out


def _assemble(per_rank, name, n_seq, n_tensor):
    """The global out, dq, dk, dv from every rank's chunks."""
    parts = {}
    for res in per_rank:
        r = res[name]
        parts[r["coord"]] = r["tensors"]
    return [np.concatenate([
        np.concatenate([parts[(i, j)][t] for j in range(n_tensor)], axis=2)
        for i in range(n_seq)], axis=1) for t in range(4)]


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"{n}ranks")
def world(request):
    n = request.param
    cases = _cases(n)
    per_rank = run_ranks(n, _attention_rank, cases)
    return n, cases, per_rank


def _reference(case, monkeypatch):
    """The reference's output and (dq, dk, dv) on jax.devices()[:n]."""
    import jax
    import jax.numpy as jnp

    from tpu_network_operator.parallel import make_mesh, plan_axes
    from tpu_network_operator.parallel.ring import ring_attention
    from tpu_network_operator.parallel.ulysses import ulysses_attention

    monkeypatch.setenv("TPUNET_SP_FLASH", "1")
    axes = case["axes"]
    n = axes.get("seq", 1) * axes.get("tensor", 1)
    mesh = make_mesh(plan_axes(n, fsdp=1, data=1, **axes),
                     devices=jax.devices()[:n])
    dtype = getattr(jnp, case["dtype"])
    q, k, v, do = (jnp.asarray(a).astype(dtype) for a in case["arrays"])
    if case["scheme"] == "ring":
        impl = "flash" if case["impl"] == "flash" else "xla"

        def f(q, k, v):
            return ring_attention(q, k, v, mesh, impl=impl)
    else:
        def f(q, k, v):
            return ulysses_attention(q, k, v, mesh)
    out, vjp = jax.vjp(jax.jit(f), q, k, v)
    return [np.asarray(t.astype(jnp.float32)) for t in (out, *vjp(do))]


def _tol(case):
    if case["dtype"] == "bfloat16":
        return dict(atol=3e-2, rtol=2e-2)
    return dict(atol=1e-3 if case["impl"] == "flash" else 2e-5, rtol=0)


@pytest.mark.parametrize("name", ["ring_flash_float32", "ring_flash_bfloat16",
                                  "ring_plain_float32", "ring_plain_bfloat16",
                                  "ulysses_float32", "ulysses_bfloat16"])
def test_matches_reference(world, name, monkeypatch):
    n, cases, per_rank = world
    case = cases[name]
    got = _assemble(per_rank, name, case["axes"].get("seq", 1),
                    case["axes"].get("tensor", 1))
    ref = _reference(case, monkeypatch)
    for what, g, r in zip(("out", "dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(g, r, **_tol(case),
                                   err_msg=f"{name} {what}")


@pytest.mark.parametrize("name", ["ring_flash_float32", "ring_flash_bfloat16",
                                  "ring_plain_float32", "ring_plain_bfloat16"])
def test_in_process_ring_equals_the_group_ring(world, name):
    # the same per-step body over n chunks in one process: the same bits
    from tpu_network_operator_torch.parallel import ring

    n, cases, per_rank = world
    case = cases[name]
    dtype = getattr(torch, case["dtype"])
    q, k, v, do = (list(torch.from_numpy(a).to(dtype).chunk(n, dim=1))
                   for a in case["arrays"])
    outs, lses = ring.ring_forward_chunks(q, k, v, case["impl"])
    dq, dk, dv = ring.ring_backward_chunks(q, k, v, outs, lses, do,
                                           case["impl"])
    got = _assemble(per_rank, name, n, 1)
    want = [torch.cat(t, dim=1) for t in (outs, dq, dk, dv)]
    want = [want[0]] + [t.to(dtype) for t in want[1:]]
    for what, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_array_equal(g, w.float().numpy(), err_msg=what)


def test_ring_launch_schedule_counts_chunks():
    # rank i computes i + 1 chunks (the diagonal and the past ones): n(n+1)/2
    from tpu_network_operator_torch.parallel import ring

    calls = []

    class Count:
        def fwd(self, q, k, v, causal):
            calls.append(("fwd", causal))
            return q.float(), torch.zeros(q.shape[:-1])

        def bwd(self, q, k, v, do, lse, delta, causal):
            calls.append(("bwd", causal))
            return q.float(), k.float(), v.float()

    n = 4
    for my in range(n):
        acc = None
        dq = dk = dv = None
        for j in range(n):
            src = (my - j) % n
            x = torch.zeros(1, 2, 4, 8)
            acc = ring.fwd_step(Count(), x, x, x, src, my, acc)
            dq, dk, dv = ring.bwd_step(Count(), x, x, x, x, None, None, src,
                                       my, dq, dk, dv)
    assert calls.count(("fwd", True)) == n
    assert calls.count(("fwd", False)) == n * (n - 1) // 2
    assert calls.count(("bwd", True)) == n
    assert calls.count(("bwd", False)) == n * (n - 1) // 2


def test_gqa_repeat_factor_and_its_named_error():
    from tpu_network_operator.parallel.ring import _gqa_repeat_factor as ref
    from tpu_network_operator_torch.parallel.ring import _gqa_repeat_factor

    for h, hkv, t in ((8, 4, 2), (8, 2, 4), (4, 2, 4), (32, 8, 16), (6, 2, 3)):
        assert _gqa_repeat_factor(h, hkv, t) == ref(h, hkv, t)
    with pytest.raises(ValueError, match="no GQA repeat factor") as port:
        _gqa_repeat_factor(8, 4, 3)
    with pytest.raises(ValueError) as jax_side:
        ref(8, 4, 3)
    assert str(port.value) == str(jax_side.value)


def test_ulysses_heads_for_and_its_named_error():
    from tpu_network_operator.parallel.ulysses import _heads_for as ref
    from tpu_network_operator_torch.parallel.ulysses import (
        _heads_for, ulysses_attention)

    for axis_n, h, hkv in ((4, 8, 4), (4, 4, 2), (8, 32, 8), (2, 8, 1)):
        assert _heads_for(axis_n, h, hkv) == ref(axis_n, h, hkv)

    class Mesh:                 # seq 4 x tensor 2: 16 heads do not divide
        def size(self, axis):
            return {"seq": 4, "tensor": 2}[axis]

    q = torch.zeros(1, 8, 6, 16)            # 12 heads over tensor 2
    with pytest.raises(ValueError, match="ulysses needs heads 12 divisible "
                                         "by tensor shards 2 and local heads "
                                         "12/2 divisible by seq shards 4"):
        ulysses_attention(q, q[:, :, :2], q[:, :, :2], Mesh())
