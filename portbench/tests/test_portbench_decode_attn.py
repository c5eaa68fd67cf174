"""``decode_attn_roofline.serve`` on traces whose numbers are known."""

from __future__ import annotations

import pytest

from portbench import common

READER = common.load_module("metrics", "decode_attn_roofline.serve")
H100 = "NVIDIA H100 80GB HBM3"


class Kernels:
    """A reading whose kernels named ``decode_attn`` took ``secs``."""

    def __init__(self, secs: float):
        self.secs = secs

    def kernel_s(self, *names):
        return self.secs if "decode_attn" in names else 0.0


def _trace(secs: float, kind: str = "decode"):
    cell, cfg = common.workload("mistral-7b.decode-b128")
    return {"kind": kind, "config": cfg, "traffic": cell["traffic"],
            "device_kind": H100, "reading": Kernels(secs)}


def test_bytes_of_the_traced_decode_steps():
    # 33 decode steps attending 513 .. 545 keys; 32 layers of 128 rows,
    # K and V of 8 kv-heads and q and o of 32 heads, 128 bf16 values each
    keys = sum(range(513, 546))
    nbytes = 32 * 128 * (2 * keys * 8 + 33 * 2 * 32) * 128 * 2
    secs = nbytes / 3.35e12
    assert READER.read(_trace(secs)) == pytest.approx(100.0)
    assert READER.read(_trace(2 * secs)) == pytest.approx(50.0)


def test_nothing_to_read():
    # a program without the kernel (the parent), and the train cells
    assert READER.read(_trace(0.0)) is None
    assert READER.read(_trace(1.0, kind="train")) is None


def test_step_bytes():
    _, cfg = common.workload("mistral-7b.decode-b128")
    one = READER.step_bytes(cfg, 1, 1)
    assert one == 32 * (2 * 8 + 2 * 32) * 128 * 2
    assert READER.step_bytes(cfg, 128, 768) == pytest.approx(
        128 * (one + 767 * 32 * 2 * 8 * 128 * 2))
