"""The port's pipeline schedules on the CPU, in one process.

* The 1F1B / interleaved tick tables (``_1f1b_tables``, the port's own
  copy) equal the reference's array for array, and ``_parse_schedule``
  gives the reference's results and messages.  No compile.
* GPipe's tables: every unit once, each backward after its own forward
  and after its right neighbour's backward.
* The executor over S stages held in one process (the in-process wire
  that ``chip_smoke.py`` drives on the card) gives the single-device
  loss and ``torch.autograd.grad`` of the dense ``loss_fn`` on the same
  f32 parameters, under every schedule: 1e-5 of each leaf's largest
  value and of its norm.  The MoE's loss is the reference's microbatched
  estimator, the mean over microbatches of the single-device
  ``loss_fn`` (each microbatch's cross entropy and router aux), and so
  are its gradients.
* Live forward-unit graphs per stage: 1F1B holds at most its in-flight
  cap V - vs a chunk, GPipe all M.
* The refusals raise the reference's messages.
"""

import dataclasses

import numpy as np
import pytest
import torch

M_RANGE = range(1, 9)


@pytest.mark.parametrize("v", [1, 2, 3])
@pytest.mark.parametrize("stages", [1, 2, 3, 4])
def test_1f1b_tables_equal_the_reference(stages, v):
    from tpu_network_operator.parallel import pipeline as jpipe
    from tpu_network_operator_torch.parallel import pipeline as tpipe

    for m in M_RANGE:
        ref = jpipe._1f1b_tables(stages, m, v)
        got = tpipe._1f1b_tables(stages, m, v)
        assert len(got) == len(ref) == 4
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b, err_msg=f"S{stages} M{m} "
                                                        f"v{v}")


@pytest.mark.parametrize("schedule,v", [
    ("gpipe", 1), ("gpipe", 3), ("1f1b", 1), ("1f1b", 4),
    ("interleaved", 2), ("interleaved", 3), ("interleaved", 1),
    ("interleaved", 0), ("zigzag", 2), ("GPipe", 2)])
def test_parse_schedule_is_the_reference(schedule, v):
    from tpu_network_operator.parallel import pipeline as jpipe
    from tpu_network_operator_torch.parallel import pipeline as tpipe

    try:
        want = jpipe._parse_schedule(schedule, v)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tpipe._parse_schedule(schedule, v)
        assert str(got.value) == str(e)
        return
    assert tpipe._parse_schedule(schedule, v) == want


@pytest.mark.parametrize("stages,micro", [(1, 1), (2, 4), (4, 3), (3, 8)])
def test_gpipe_tables_run_every_unit_once_in_order(stages, micro):
    from tpu_network_operator_torch.parallel import pipeline as tpipe

    fmb, fck, bmb, bck = tpipe._gpipe_tables(stages, micro)
    assert not fck.any() and not bck.any()
    tf, tb = {}, {}
    for t in range(fmb.shape[0]):
        for r in range(stages):
            if fmb[t, r] >= 0:
                tf[(r, int(fmb[t, r]))] = t
            if bmb[t, r] >= 0:
                tb[(r, int(bmb[t, r]))] = t
    units = {(r, m) for r in range(stages) for m in range(micro)}
    assert set(tf) == set(tb) == units
    for r, m in units:
        if r:
            assert tf[(r, m)] > tf[(r - 1, m)]
        if r < stages - 1:
            assert tb[(r, m)] > tb[(r + 1, m)]
        # every forward before the first backward: M graphs a stage
        assert tb[(r, m)] > max(tf.values())
    # the last stage backwards the microbatches in reverse order
    last = [tb[(stages - 1, m)] for m in range(micro)]
    assert last == sorted(last, reverse=True)


def _cfg(family, **kw):
    from tpu_network_operator_torch.models import llama, moe

    base = (llama.LlamaConfig.tiny() if family == "llama"
            else moe.MoEConfig.tiny())
    return dataclasses.replace(base, dtype=torch.float32, **kw)


def _setup(family, layers=4, batch=8, seq=16, seed=0):
    from tpu_network_operator_torch.models import llama, moe

    mod = moe if family == "moe" else llama
    cfg = _cfg(family, layers=layers)
    params = mod.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_size, (batch, seq + 1), dtype=np.int64))
    return mod, cfg, params, tokens


def _single_device(mod, cfg, params, tokens, micro):
    """(loss, grads): the dense ``loss_fn`` on the whole batch; for the
    MoE the mean over microbatches of ``loss_fn`` on each."""
    from tpu_network_operator_torch.models import training

    leaves = [p.detach().clone().requires_grad_()
              for p in training.tree_leaves(params)]
    it = iter(leaves)
    tree = training.tree_map(lambda _: next(it), params)
    if mod.__name__.endswith("moe"):
        loss = sum(mod.loss_fn(tree, t, cfg)
                   for t in tokens.chunk(micro)) / micro
    else:
        loss = mod.loss_fn(tree, tokens, cfg)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def _close(got, ref, tol=1e-5):
    big = ref.abs().max().item()
    assert (got - ref).abs().max().item() <= tol * big
    assert (got - ref).norm().item() <= tol * ref.norm().item()


@pytest.mark.parametrize("family", ["llama", "moe"])
@pytest.mark.parametrize("schedule,stages", [
    ("gpipe", 2), ("gpipe", 4), ("1f1b", 2), ("1f1b", 4),
    ("interleaved", 2), ("gpipe", 1)])
def test_stages_in_process_give_the_single_device_gradients(family,
                                                            schedule,
                                                            stages):
    from tpu_network_operator_torch.models import training
    from tpu_network_operator_torch.parallel import pipeline as tpipe

    mod, cfg, params, tokens = _setup(family)
    micro = 4
    loss_ref, grads_ref = _single_device(mod, cfg, params, tokens, micro)
    step, _, _ = tpipe.make_pipeline_train_step(
        cfg, None, micro, schedule=schedule, device="cpu",
        stages_in_process=stages)
    stored = tpipe.chunked_layers(params, step.v)
    loss, grads = step.grads_fn(stored, tokens)
    assert abs(loss.item() - loss_ref.item()) <= 1e-5 * abs(loss_ref.item())
    for g, r in zip(training.tree_leaves(grads), grads_ref):
        _close(g.reshape(r.shape), r)


@pytest.mark.parametrize("stages,v", [(2, 1), (4, 1), (2, 2)])
def test_live_graphs_stay_under_the_1f1b_cap_and_gpipe_holds_all(stages,
                                                                  v):
    from tpu_network_operator_torch.parallel import pipeline as tpipe

    _, cfg, params, tokens = _setup("llama", layers=4, batch=8)
    micro = 8
    schedule = "1f1b" if v == 1 else "interleaved"
    live = {}
    for name in (schedule, "gpipe"):
        step, _, _ = tpipe.make_pipeline_train_step(
            cfg, None, micro, schedule=name, virtual_stages=v,
            device="cpu", stages_in_process=stages)
        step.grads_fn(tpipe.chunked_layers(params, step.v), tokens)
        live[name] = step.stats["max_live_graphs"]
    V = stages * v
    caps = [sum(min(V - (c * stages + r), micro) for c in range(v))
            for r in range(stages)]
    assert all(n <= cap for n, cap in zip(live[schedule], caps)), live
    if v == 1:
        # the cap binds: the first stage fills to it
        assert live[schedule][0] == caps[0]
    assert max(live[schedule]) < micro
    assert live["gpipe"] == [micro] * stages


def _reference_message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("case", ["batch_gpipe", "batch_1f1b",
                                  "layers_gpipe", "layers_1f1b",
                                  "layers_interleaved", "v_lt_2",
                                  "unknown_schedule"])
def test_refusals_raise_the_reference_messages(case):
    """Each refusal's message is the one the reference raises on the
    virtual CPU mesh for the same configuration (traced only, never
    compiled)."""
    import jax
    import jax.numpy as jnp

    from tpu_network_operator.models import llama as jllama
    from tpu_network_operator.parallel import make_mesh, plan_axes
    from tpu_network_operator.parallel import pipeline as jpipe
    from tpu_network_operator.parallel import (
        make_pipeline_train_step as jmake)
    from tpu_network_operator_torch.parallel import pipeline as tpipe

    layers, batch, schedule, v = 4, 8, "gpipe", 2
    if case.startswith("batch"):
        batch, schedule = 6, case.split("_")[1]
    elif case.startswith("layers"):
        layers, schedule = 3, case.split("_")[1]
    elif case == "v_lt_2":
        schedule, v = "interleaved", 1
    else:
        schedule = "pipedream"
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), layers=layers,
                               dtype=jnp.float32)
    mesh = make_mesh(plan_axes(2, pipe=2), devices=jax.devices()[:2])

    def reference():
        if case == "layers_gpipe":
            # the jitted step's sharding refuses the 3 layers first; the
            # schedule's own check is pipeline_apply's
            jpipe.pipeline_apply(lambda x, lp: x, {"w": jnp.zeros((3, 4))},
                                 jnp.zeros((8, 4)), mesh, 4)
        step, _, opt = jmake(jcfg, mesh, n_microbatches=4,
                             schedule=schedule, virtual_stages=v)
        params = jllama.init_params(jax.random.key(0), jcfg)
        step(params, opt.init(params), jnp.zeros((batch, 17), jnp.int32))

    want = _reference_message(reference)
    cfg = _cfg("llama", layers=layers)

    def port():
        step, init_all, opt = tpipe.make_pipeline_train_step(
            cfg, None, 4, schedule=schedule, virtual_stages=v,
            device="cpu", stages_in_process=2)
        params, state = init_all(torch.Generator().manual_seed(0))
        step(params, state, torch.zeros((batch, 17), dtype=torch.int64))

    assert _reference_message(port) == want


def test_microbatch_rows_are_each_ranks_share_of_every_microbatch():
    """On data x fsdp = 2 with 3 microbatches of 4 rows, rank i holds rows
    2i, 2i+1 of each microbatch, as the data loader's shard gives them."""
    from tpu_network_operator_torch.data import DataConfig, local_batches
    from tpu_network_operator_torch.parallel import mesh as tmesh
    from tpu_network_operator_torch.parallel import pipeline as tpipe

    tokens = torch.arange(12 * 3).reshape(12, 3)
    plan = tmesh.plan_axes(4, fsdp=2, pipe=2)
    got = [tpipe.microbatch_rows(tokens, tmesh.MeshCoord(plan, {"fsdp": i}),
                                 3) for i in range(2)]
    assert got[0][:, 0].tolist() == [0, 3, 12, 15, 24, 27]
    assert got[1][:, 0].tolist() == [6, 9, 18, 21, 30, 33]
    with pytest.raises(ValueError, match="batch 12 not divisible by "
                                         "microbatches 5"):
        tpipe.microbatch_rows(tokens, None, 5)

    class Source:
        def __len__(self):
            return 1000

        def window(self, start, span):
            return np.full(span, start, np.int32)

    cfg = DataConfig(batch=12, seq_len=4)
    whole = next(local_batches(Source(), cfg))
    for i in range(2):
        rows = next(local_batches(Source(), cfg, process_index=i,
                                  process_count=2, microbatches=3))
        want = tpipe.microbatch_rows(torch.from_numpy(whole),
                                     tmesh.MeshCoord(plan, {"fsdp": i}), 3)
        np.testing.assert_array_equal(rows, want.numpy())
