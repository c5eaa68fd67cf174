"""Each driver end to end on the CPU at tiny widths, through the port's
plain paths (the harness's look for a chip skipped): a sound run is
correct, the float8 control fails a limit, and each fault the cell can
have, planted under the timed path, turns ``correct`` false.

The limits here are the tiny size's own: a little above what sound tiny
runs read (bf16 parameters move by whole ulps at width 64, so the
parameters' change reads far wider than at full width), below the
control's readings.  The cells' files hold the limits set at full size.
"""

from __future__ import annotations

import pytest

from portbench.tests import tiny

TRAIN_LIMITS = {"loss_gap": 0.015, "grad_norm_gap": 0.015,
                "median_grad_gap": 0.015, "median_grad_diff": 0.05,
                "change_norm_gap": 0.3}
LIMITS = {
    "mixtral-8x7b-l4.train-8k": TRAIN_LIMITS,
    "mistral-7b-l24.train-4k": TRAIN_LIMITS,
    "mistral-7b.decode-b128": {"logit_gap": 0.05},
    "nccl-fsdp4.allreduce-256m": {"sum_error": 0.05},
}
FAULTS = [("mixtral-8x7b-l4.train-8k", "unchanged"),
          ("mixtral-8x7b-l4.train-8k", "half_batch"),
          ("mistral-7b-l24.train-4k", "unchanged"),
          ("mistral-7b-l24.train-4k", "half_batch"),
          ("mistral-7b.decode-b128", "token"),
          ("nccl-fsdp4.allreduce-256m", "no_exchange"),
          ("nccl-fsdp4.allreduce-256m", "answer")]


@pytest.mark.parametrize("name", sorted(LIMITS))
def test_sound_run_and_control(name):
    got = tiny.run(name, LIMITS[name], control=True)
    res = got["result"]
    assert res["correct"], got["out"]["compared"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) >= {"setup_s"} and len(res["metrics"]) == 2
    assert all(m["value"] > 0 for m in res["metrics"].values())
    control = got["out"]["control"]
    assert any(control[k] > LIMITS[name][k] for k in control), control


@pytest.mark.parametrize("name,fault", FAULTS)
def test_planted_fault_is_caught(name, fault):
    got = tiny.run(name, LIMITS[name], fault=fault)
    assert not got["result"]["correct"], got["out"]["compared"]


def test_seed_fixes_the_inputs():
    import torch

    from portbench import weights

    _, cfg = tiny.cell("mixtral-8x7b-l4.train-8k")
    seed = 2 ** 33 + 7          # more than 32 bits
    a, b = weights.draw(cfg, seed, "cpu"), weights.draw(cfg, seed, "cpu")
    c = weights.draw(cfg, seed + 1, "cpu")
    for path, t in weights.flat(a).items():
        assert torch.equal(t, weights.flat(b)[path])
        if "ln" not in path:
            assert not torch.equal(t, weights.flat(c)[path])
    assert torch.equal(weights.token_rows(seed, 2, 2, 9, 256, "cpu"),
                       weights.token_rows(seed, 2, 2, 9, 256, "cpu"))
    a = tiny.run("mistral-7b.decode-b128", LIMITS["mistral-7b.decode-b128"])
    b = tiny.run("mistral-7b.decode-b128", LIMITS["mistral-7b.decode-b128"])
    assert a["out"]["compared"] == b["out"]["compared"]
