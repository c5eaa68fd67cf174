"""The port's input pipeline held against the JAX package's, on the CPU.

The token sources and ``local_batches`` are pure numpy on both sides, so
every batch must be the same ids, row for row, from the same file, seed
and step.
"""

import numpy as np
import pytest
import torch

from tpu_network_operator import data as jdata
from tpu_network_operator_torch import data as tdata


@pytest.fixture
def token_file(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 1000, 50_000,
                                      dtype=np.uint16).tofile(path)
    return str(path)


def _take(it, n):
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("start_step", [0, 7])
def test_local_batches_match_jax_row_for_row(token_file, start_step):
    cfg_j = jdata.DataConfig(batch=4, seq_len=32, seed=3)
    cfg_t = tdata.DataConfig(batch=4, seq_len=32, seed=3)
    ref = _take(jdata.local_batches(
        jdata.MemmapTokens(token_file, vocab_size=1000), cfg_j,
        start_step=start_step), 5)
    out = _take(tdata.local_batches(
        tdata.MemmapTokens(token_file, vocab_size=1000), cfg_t,
        start_step=start_step), 5)
    for b_ref, b_out in zip(ref, out):
        assert b_out.dtype == np.int32 and b_out.shape == (4, 33)
        np.testing.assert_array_equal(b_out, b_ref)
    # resuming at step k reproduces the uninterrupted run from step k on
    later = _take(tdata.local_batches(
        tdata.MemmapTokens(token_file, vocab_size=1000), cfg_t,
        start_step=start_step + 2), 3)
    for b_out, b_later in zip(out[2:], later):
        np.testing.assert_array_equal(b_later, b_out)


def test_synthetic_tokens_match_jax():
    ref = jdata.SyntheticTokens(512, total=1 << 20, seed=5).window(1000, 64)
    out = tdata.SyntheticTokens(512, total=1 << 20, seed=5).window(1000, 64)
    np.testing.assert_array_equal(out, ref)


def test_vocab_probe_raises_on_wrong_dtype(tmp_path):
    # a uint32 file read as uint16 (vocab <= 65536), and a uint16 file read
    # as uint32 (a Llama-3 vocab), both show ids past the vocab
    wide = tmp_path / "wide.bin"
    np.arange(1, 5000, dtype=np.uint32).tofile(wide)
    with pytest.raises(ValueError, match="wrong dtype"):
        tdata.MemmapTokens(str(wide), vocab_size=1000)
    narrow = tmp_path / "narrow.bin"
    np.arange(100, 5000, dtype=np.uint16).tofile(narrow)
    with pytest.raises(ValueError, match="wrong dtype"):
        tdata.MemmapTokens(str(narrow), vocab_size=128_256)
    assert len(tdata.MemmapTokens(str(narrow), vocab_size=5000)) == 4900
    empty = tmp_path / "empty.bin"
    empty.write_bytes(b"")
    with pytest.raises(ValueError):
        tdata.MemmapTokens(str(empty))


def test_config_errors_raise_at_construction(token_file):
    src = tdata.MemmapTokens(token_file, vocab_size=1000)
    with pytest.raises(ValueError, match="shorter than"):
        tdata.local_batches(src, tdata.DataConfig(batch=2, seq_len=60_000))
    with pytest.raises(ValueError, match="not divisible"):
        tdata.local_batches(src, tdata.DataConfig(batch=3, seq_len=8),
                            process_count=2)


@pytest.mark.parametrize("prefetch", [0, 1, 2])
def test_device_batches_on_cpu_yield_the_same_batches(token_file, prefetch):
    cfg = tdata.DataConfig(batch=2, seq_len=16, seed=1)
    src = tdata.MemmapTokens(token_file, vocab_size=1000)
    ref = _take(tdata.local_batches(src, cfg, start_step=4), 4)
    out = _take(tdata.device_batches(src, cfg, "cpu", start_step=4,
                                     prefetch=prefetch), 4)
    for b_ref, b_out in zip(ref, out):
        assert isinstance(b_out, torch.Tensor)
        assert b_out.device.type == "cpu" and b_out.dtype == torch.int32
        np.testing.assert_array_equal(b_out.numpy(), b_ref)


def test_device_batches_default_to_cuda(monkeypatch, token_file):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = tdata.MemmapTokens(token_file, vocab_size=1000)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdata.device_batches(src, tdata.DataConfig(batch=2, seq_len=8))
