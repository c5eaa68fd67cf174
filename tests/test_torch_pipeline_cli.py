"""``workload train --pipe 2`` on two gloo ranks, through the CLI's
``main`` in each rank of one spawned world (``run_ranks``):

* both families under each schedule (the interleaved one on 4-layer
  tiny configs, given by a ``cfg.json`` sidecar): the loss falls on the
  fixed batch, both ranks print the same losses, and the JSON line's
  ``mesh`` names the schedule, the microbatches and the chunks a stage;
* a token file through ``--data`` with ``--checkpoint-dir``: 3 gpipe
  steps at once, and 2 gpipe steps then a resume under 1f1b for 1 more,
  which restarts at step 2 (the same flat layout) and ends within 1e-5
  of the uninterrupted run (the schedules sum in different orders);
* ``convert --pipe 2`` writes the imported weights sharded by the plain
  specs (pipe replicating), and ``train --pipe 2 --pp-schedule 1f1b``
  resumes that checkpoint at step 0 with exactly the first loss it
  gives from the one-process convert of the same weights.
"""

import dataclasses
import os

import numpy as np
import pytest

from test_torch_dist_attention import run_ranks
from test_torch_dist_resume import _main, write_hf_llama

TRAIN = ["train", "--device", "cpu", "--pipe", "2", "--batch", "8",
         "--seq-len", "16"]
# name -> extra flags
RUNS = {
    "llama_1f1b": ["--pp-schedule", "1f1b", "--steps", "3"],
    "llama_gpipe": ["--pp-schedule", "gpipe", "--steps", "3"],
    "moe_gpipe": ["--model", "moe", "--pp-schedule", "gpipe",
                  "--optimizer", "adam8bit", "--steps", "3"],
    "moe_1f1b": ["--model", "moe", "--pp-schedule", "1f1b", "--steps", "3"],
}


def _rank(rank, world, root):
    out = {name: _main([*TRAIN, *flags]) for name, flags in RUNS.items()}
    for family in ("llama", "moe"):
        out[f"{family}_interleaved"] = _main([
            *TRAIN, "--pp-schedule", "interleaved", "--virtual-stages", "2",
            "--steps", "3", "--checkpoint-dir",
            os.path.join(root, f"four_{family}")])
    data = ["--data", os.path.join(root, "tokens.bin")]
    for name, schedule, steps, ckpt in (("whole", "gpipe", 3, "whole"),
                                        ("first", "gpipe", 2, "split"),
                                        ("resumed", "1f1b", 1, "split")):
        out[name] = _main([*TRAIN, *data, "--pp-schedule", schedule,
                           "--steps", str(steps), "--checkpoint-dir",
                           os.path.join(root, ckpt)])
    _main(["convert", "--device", "cpu", "--pipe", "2", "--hf-path",
           os.path.join(root, "hf"), "--checkpoint-dir",
           os.path.join(root, "mesh")])
    for name in ("mesh", "one"):
        out[f"from_{name}"] = _main([
            *TRAIN, "--pp-schedule", "1f1b", "--steps", "1",
            "--checkpoint-dir", os.path.join(root, name)])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from tpu_network_operator_torch.models import llama, moe
    from tpu_network_operator_torch.models.convert import cfg_to_json

    root = tmp_path_factory.mktemp("pipe_cli")
    for family, cfg in (("llama", llama.LlamaConfig.tiny()),
                        ("moe", moe.MoEConfig.tiny())):
        (root / f"four_{family}").mkdir()
        (root / f"four_{family}" / "cfg.json").write_text(cfg_to_json(
            dataclasses.replace(cfg, layers=4)))
    np.random.default_rng(0).integers(0, 256, 20_000, dtype=np.uint16).tofile(
        root / "tokens.bin")
    write_hf_llama(root / "hf")
    _main(["convert", "--device", "cpu", "--hf-path", str(root / "hf"),
           "--checkpoint-dir", str(root / "one")])
    return run_ranks(2, _rank, str(root),
                     store_dir=tmp_path_factory.mktemp("store"))


@pytest.mark.parametrize("name", [*RUNS, "llama_interleaved",
                                  "moe_interleaved"])
def test_workload_train_over_pipe_runs_each_schedule(runs, name):
    lines = [r[name] for r in runs]
    schedule = name.split("_")[1]
    for line in lines:
        assert line["mesh"]["pipe"] == 2 and line["mesh"]["devices"] == 2
        assert line["mesh"]["pp_schedule"] == schedule
        assert line["mesh"]["microbatches"] == 4
        assert line["mesh"]["virtual_stages"] == (
            2 if schedule == "interleaved" else 1)
        assert line["final_loss"] < line["first_loss"]
        assert line["value"] > 0
    assert lines[0]["final_loss"] == lines[1]["final_loss"]
    assert lines[0]["first_loss"] == lines[1]["first_loss"]


def test_a_gpipe_run_resumes_under_1f1b(runs):
    got = runs[0]
    assert got["whole"]["resumed_from"] == 0
    assert got["resumed"]["resumed_from"] == 2
    assert got["resumed"]["mesh"]["pp_schedule"] == "1f1b"
    whole = got["whole"]["final_loss"]
    assert abs(got["resumed"]["final_loss"] - whole) <= 1e-5 * abs(whole)


def test_convert_over_pipe_then_train_1f1b_resumes_at_step_0(runs):
    for r in runs:
        mesh, one = r["from_mesh"], r["from_one"]
        assert mesh["resumed_from"] == one["resumed_from"] == 0
        assert mesh["first_loss"] == one["first_loss"]
        assert np.isfinite(mesh["first_loss"])
        assert mesh["mesh"]["pp_schedule"] == "1f1b"
