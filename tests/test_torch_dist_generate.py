"""Serving over a mesh and the workload CLI on launched ranks.

The port's ``generate(..., mesh=...)`` on 4 gloo ranks (data x tensor and
fsdp x tensor, the native and the int8 KV cache, and meshes with an expert
or a pipe axis, which replicate as the reference's dense specs name
neither) gives the reference's
greedy tokens: ``make_generate_fn(cfg, n, mesh=...)`` on 4 CPU devices,
from the same f32 parameters (token ids compared exactly; the tiny model's
top-1 margins are far above f32 summation noise).  ``workload train`` on
2 processes started as a launcher starts them prints its JSON line with
the mesh, the dense model over tensor and the MoE over expert, and the
combinations the port does not shard yet exit by name.
"""

import dataclasses
import json
import os
import subprocess
import sys
from argparse import Namespace
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_dist_attention import (free_port, retry_on_taken_port,
                                       run_ranks)

ROOT = Path(__file__).resolve().parents[1]
# name -> (mesh axes over 4 ranks, KV-cache dtype)
MESHES = {
    "data2_tensor2": (dict(data=2, tensor=2, fsdp=1), "native"),
    "fsdp2_tensor2": (dict(fsdp=2, tensor=2), "native"),
    "data2_tensor2_int8": (dict(data=2, tensor=2, fsdp=1), "int8"),
    "expert2_fsdp2": (dict(expert=2, fsdp=2), "native"),
    "pipe2_tensor2": (dict(pipe=2, tensor=2, fsdp=1), "native"),
}
PROMPT, NEW = 8, 8


def _generate_rank(rank, world, tree, prompt):
    from torch.profiler import ProfilerActivity, profile

    from tpu_network_operator_torch import tracing
    from tpu_network_operator_torch.models import llama as tllama
    from tpu_network_operator_torch.models.generate import make_generate_fn
    from tpu_network_operator_torch.parallel import make_mesh, plan_axes

    cfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.float32)
    out = {}
    for name, (axes, kv_dtype) in MESHES.items():
        mesh = make_mesh(plan_axes(world, **axes), "cpu")
        params = tllama.shard_params(tllama.params_from_jax(tree, "cpu"),
                                     cfg, mesh)
        rows = torch.from_numpy(prompt).chunk(mesh.size("data", "fsdp"))[
            mesh.index("data", "fsdp")]
        gen = make_generate_fn(cfg, NEW, kv_dtype=kv_dtype, mesh=mesh)
        tracing.reset_counters()
        with profile(activities=[ProfilerActivity.CPU]):
            tokens = gen(params, rows).numpy()
        out[name] = (mesh.index("data", "fsdp"), tokens)
        out[name + "/counters"] = tracing.counters()
    return out


@pytest.fixture(scope="module")
def reference_params():
    import jax
    import jax.numpy as jnp

    from tpu_network_operator.models import llama as jllama

    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    return jax.tree.map(np.asarray, jllama.init_params(jax.random.key(3),
                                                       jcfg))


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(4).integers(0, 256, (4, PROMPT),
                                             dtype=np.int32)


@pytest.fixture(scope="module")
def world4(reference_params, prompt):
    return run_ranks(4, _generate_rank, reference_params, prompt)


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_generate_gives_the_reference_greedy_tokens(
        world4, reference_params, prompt, name):
    import jax
    import jax.numpy as jnp

    from tpu_network_operator.models import llama as jllama
    from tpu_network_operator.models.generate import make_generate_fn
    from tpu_network_operator.parallel import make_mesh, plan_axes

    axes, kv_dtype = MESHES[name]
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    mesh = make_mesh(plan_axes(4, **axes), devices=jax.devices()[:4])
    ref = np.asarray(make_generate_fn(jcfg, NEW, kv_dtype=kv_dtype,
                                      mesh=mesh)(
        jax.tree.map(jnp.asarray, reference_params), jnp.asarray(prompt)))
    shards = {}
    for r in world4:
        index, rows = r[name]
        if index in shards:     # the ranks of one batch shard agree
            np.testing.assert_array_equal(rows, shards[index])
        shards[index] = rows
    got = np.concatenate([shards[i] for i in sorted(shards)])
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_generate_takes_the_eager_loop(world4, name):
    # a mesh's steps never run as a CUDA graph replay
    for r in world4:
        assert r[name + "/counters"] == {"generate.eager_steps": NEW - 1,
                                         "generate.graph_steps": 0}


def _launch_two_ranks(flags):
    """``workload train`` with ``flags`` on 2 processes started as a
    launcher starts them: each rank's JSON line."""
    return retry_on_taken_port(lambda _: _launch_once(flags))


def _launch_once(flags):
    argv = [sys.executable, "-m", "tpu_network_operator_torch.workload",
            "train", "--device", "cpu", "--preset", "tiny", *flags,
            "--steps", "2", "--batch", "4", "--seq-len", "32"]
    port = str(free_port())
    procs = []
    for rank in range(2):
        env = {**os.environ, "RANK": str(rank), "LOCAL_RANK": str(rank),
               "WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": port, "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen(argv, cwd=ROOT, env=env, text=True,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE))
    lines = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
            lines.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return lines


def test_workload_train_on_two_launched_ranks_prints_its_mesh():
    lines = _launch_two_ranks(["--tensor", "2"])
    want = {"data": 1, "fsdp": 1, "pipe": 1, "expert": 1, "seq": 1,
            "tensor": 2, "devices": 2, "device": "cpu"}
    for line in lines:
        assert line["mesh"] == want
        assert line["unit"] == "tokens/sec/chip" and line["value"] > 0
        assert np.isfinite(line["final_loss"])
    assert lines[0]["final_loss"] == lines[1]["final_loss"]
    assert lines[0]["first_loss"] == lines[1]["first_loss"]


def test_workload_train_moe_over_expert_on_two_launched_ranks():
    """The MoE with its experts over 2 launched ranks: both print the
    mesh and the same losses (the ranks hold the same rows, and the
    partial expert outputs are summed over expert)."""
    lines = _launch_two_ranks(["--model", "moe", "--expert", "2"])
    want = {"data": 1, "fsdp": 1, "pipe": 1, "expert": 2, "seq": 1,
            "tensor": 1, "devices": 2, "device": "cpu"}
    for line in lines:
        assert line["mesh"] == want
        assert line["metric"] == "moe:tiny train throughput"
        assert np.isfinite(line["final_loss"]) and line["value"] > 0
    assert lines[0]["final_loss"] == lines[1]["final_loss"]
    assert lines[0]["first_loss"] == lines[1]["first_loss"]


# The ids are stable names.  Case 0 pinned the refusal of --pipe > 1 on a
# mesh, which the pipeline schedules removed; cases 1 to 4 pinned refusals
# that the mesh's 8-bit AdamW and sharded checkpoints removed.  So each now
# holds that its combination, and it with --pipe 2 under each schedule,
# passes cmd_train's checks of the flags.
@pytest.mark.parametrize("flags", [
    pytest.param(dict(pipe=2), id="flags0---pipe > 1"),
    pytest.param(dict(expert=2, model="moe", optimizer="adam8bit"),
                 id="flags1---expert > 1, --model moe"),
    pytest.param(dict(model="moe", checkpoint_dir="ckpt"),
                 id="flags2---model moe"),
    pytest.param(dict(optimizer="adam8bit"),
                 id="flags3---optimizer adam8bit"),
    pytest.param(dict(checkpoint_dir="ckpt"), id="flags4---checkpoint-dir"),
])
def test_train_refuses_what_this_slice_does_not_shard(flags):
    from tpu_network_operator_torch.workload import train

    args = Namespace(**{**dict(pipe=1, expert=1, seq=1, model="llama",
                               optimizer="adamw", checkpoint_dir=None,
                               sp_impl="ring", pp_schedule="gpipe",
                               virtual_stages=2),
                        **flags})
    train.check_train_flags(args)
    for schedule in ("gpipe", "1f1b", "interleaved"):
        args.pipe, args.seq, args.pp_schedule = 2, 2, schedule
        train.check_train_flags(args)        # runs on a mesh now
    # what is still refused: Ulysses inside the pipeline, a schedule the
    # reference does not know, interleaving without chunks
    args.sp_impl = "ulysses"
    with pytest.raises(SystemExit, match="ulysses cannot nest"):
        train.check_train_flags(args)
    args.sp_impl = "ring"
    args.pp_schedule = "zigzag"
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        train.check_train_flags(args)
    args.pp_schedule, args.virtual_stages = "interleaved", 1
    with pytest.raises(ValueError, match="virtual_stages >= 2"):
        train.check_train_flags(args)


def test_reference_refusals_come_first():
    from tpu_network_operator_torch.workload import cli

    with pytest.raises(SystemExit, match="--expert requires --model moe"):
        cli.main(["train", "--device", "cpu", "--expert", "2"])
    with pytest.raises(SystemExit, match="ulysses cannot nest"):
        cli.main(["train", "--device", "cpu", "--pipe", "2", "--seq", "2",
                  "--sp-impl", "ulysses"])
    # convert takes the mesh flags now: over one process a 2-way axis is
    # refused as train refuses it, before any file is read
    with pytest.raises(ValueError, match="does not divide device count 1"):
        cli.main(["convert", "--device", "cpu", "--hf-path", "hf",
                  "--checkpoint-dir", "ckpt", "--tensor", "2"])
    # one process cannot hold a 2-way axis
    with pytest.raises(ValueError, match="does not divide device count 1"):
        cli.main(["train", "--device", "cpu", "--tensor", "2"])
