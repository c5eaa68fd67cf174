"""The port's train checkpoints on the CPU: bit-exact round trips of the
AdamW and 8-bit AdamW states, restore in place, the async snapshot,
retention, half-written steps, and a resumed ``workload train`` that ends
where an uninterrupted one does."""

import json

import numpy as np
import pytest
import torch

from tpu_network_operator_torch.models import llama as tllama
from tpu_network_operator_torch.models.checkpoint import TrainCheckpointer
from tpu_network_operator_torch.workload import cli


def _state_tensors(params, opt_state):
    """Key path -> tensor, every tensor of the train state."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}")
        elif isinstance(node, tuple):
            for k, v in zip(node._fields, node):
                walk(v, f"{prefix}/{k}")
        elif isinstance(node, torch.Tensor):
            out[prefix] = node
    walk(params, "params")
    walk(opt_state, "opt")
    return out


def _bits(t):
    t = t.detach()
    if t.element_size() == 1:
        return t.view(torch.uint8)
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def _assert_same_state(a, b):
    ta, tb = _state_tensors(*a), _state_tensors(*b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert ta[k].dtype == tb[k].dtype and ta[k].shape == tb[k].shape, k
        assert torch.equal(_bits(ta[k]), _bits(tb[k])), k
    assert a[1]["count"] == b[1]["count"]


def _trained(optimizer, steps=2, seed=0):
    cfg = tllama.LlamaConfig.tiny()
    step, init_all, _ = tllama.make_train_step(cfg, optimizer=optimizer,
                                               device="cpu")
    params, opt_state = init_all(torch.Generator().manual_seed(seed))
    tokens = torch.randint(0, cfg.vocab_size, (2, 17),
                           generator=torch.Generator().manual_seed(1))
    for _ in range(steps):
        params, opt_state, _ = step(params, opt_state, tokens)
    return (params, opt_state), init_all


def _clone(state):
    params, opt_state = state
    copy = lambda t: t.detach().clone()                       # noqa: E731

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, tuple):
            return type(node)(*(walk(v) for v in node))
        return copy(node) if isinstance(node, torch.Tensor) else node
    return walk(params), walk(opt_state)


@pytest.mark.parametrize("optimizer", [None, "adam8bit"])
def test_round_trip_is_bit_exact_and_in_place(tmp_path, optimizer):
    # AdamW: bf16 moments; adam8bit: int8 and float8 codes with f32 scales;
    # both with the host-int count
    state, init_all = _trained(optimizer)
    with TrainCheckpointer(tmp_path) as ckpt:
        ckpt.save(2, *state)
        ckpt.wait()
        assert ckpt.latest_step() == 2
        fresh = init_all(torch.Generator().manual_seed(9))
        ptrs = {k: t.data_ptr() for k, t in _state_tensors(*fresh).items()}
        step, params, opt_state = ckpt.restore(fresh)
    assert step == 2 and opt_state["count"] == 2
    assert params is fresh[0] and opt_state is fresh[1]
    assert {k: t.data_ptr() for k, t in
            _state_tensors(params, opt_state).items()} == ptrs
    _assert_same_state((params, opt_state), state)


def test_async_save_snapshots_before_returning(tmp_path):
    # the step updates in place: a change right after save() must not
    # reach the checkpoint, even while the write is still queued
    state, init_all = _trained("adam8bit")
    before = _clone(state)
    with TrainCheckpointer(tmp_path) as ckpt:
        ckpt.save(2, *state)
        for t in _state_tensors(*state).values():
            t.detach().zero_()
        state[1]["count"] = 99
        ckpt.wait()
        restored = ckpt.restore(init_all(torch.Generator().manual_seed(3)))
    _assert_same_state(restored[1:], before)


def test_retention_keeps_the_newest(tmp_path):
    state, _ = _trained(None, steps=0)
    with TrainCheckpointer(tmp_path, max_to_keep=2) as ckpt:
        for i in range(1, 5):
            ckpt.save(i, *state)
        ckpt.wait()
        assert ckpt.all_steps() == [3, 4]
        assert ckpt.latest_step() == 4
    with TrainCheckpointer(tmp_path / "all", max_to_keep=None,
                           async_save=False) as ckpt:
        for i in (5, 1, 3):
            ckpt.save(i, *state)
        assert ckpt.all_steps() == [1, 3, 5]


def test_half_written_steps_are_ignored(tmp_path):
    state, init_all = _trained(None, steps=0)
    with TrainCheckpointer(tmp_path) as ckpt:
        with pytest.raises(FileNotFoundError, match="no checkpoint"):
            ckpt.restore(init_all(torch.Generator().manual_seed(0)))
        ckpt.save(3, *state)
        ckpt.wait()
        # a write cut short under its temporary name, and a step directory
        # without its metadata (never renamed into place by this class)
        (tmp_path / ".tmp-7").mkdir()
        (tmp_path / ".tmp-7" / "__0_0.distcp").write_bytes(b"partial")
        (tmp_path / "8").mkdir()
        assert ckpt.all_steps() == [3]
        assert ckpt.latest_step() == 3
        assert ckpt.restore(init_all(torch.Generator().manual_seed(0)))[0] == 3


def _train(tmp_path, ckpt_dir, steps, capsys):
    path = tmp_path / "tokens.bin"
    if not path.exists():
        np.random.default_rng(0).integers(0, 256, 20_000,
                                          dtype=np.uint16).tofile(path)
    assert cli.main(["train", "--device", "cpu", "--preset", "tiny",
                     "--optimizer", "adam8bit", "--data", str(path),
                     "--checkpoint-dir", str(ckpt_dir), "--batch", "2",
                     "--seq-len", "16", "--steps", str(steps)]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_resumed_workload_train_ends_where_an_uninterrupted_one_does(
        tmp_path, capsys):
    # 4 steps in one run, against 2 steps and a resume for 2 more: the
    # data iterator restarts at the restored step and the CPU ops are
    # deterministic, so the final states are the same bits
    whole = _train(tmp_path, tmp_path / "whole", 4, capsys)
    first = _train(tmp_path, tmp_path / "split", 2, capsys)
    second = _train(tmp_path, tmp_path / "split", 2, capsys)
    assert whole["resumed_from"] == 0 and first["resumed_from"] == 0
    assert second["resumed_from"] == 2
    assert second["final_loss"] == whole["final_loss"]
    _, init_all, _ = tllama.make_train_step(
        tllama.LlamaConfig.tiny(), optimizer="adam8bit", device="cpu")
    ends = []
    for name in ("whole", "split"):
        with TrainCheckpointer(tmp_path / name) as ckpt:
            assert ckpt.latest_step() == 4
            ends.append(ckpt.restore(
                init_all(torch.Generator().manual_seed(5)))[1:])
    assert TrainCheckpointer(tmp_path / "split").all_steps() == [2, 4]
    _assert_same_state(ends[0], ends[1])
