"""``workload exec-bench`` of the port and its launcher
``tools/exec_bench_torch.py`` over agent-written, plan-adopted bootstrap
files on gloo ranks: the byte-equality, hint and schema checks of the
reference's own tests (``tests/e2e/test_workload_distributed.py``
``test_exec_bench_worker_pair_executes_plan`` and
``tests/test_bench.py`` ``TestExecBench``).

The port runs one process per device: a node's bootstrap file is read by
``LOCAL_WORLD_SIZE`` rank processes (``LOCAL_RANK`` 0..n-1), so a node of
2 devices is 2 processes sharing the file and its job lock.
"""

import hashlib
import json
import os
import socket
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCHER = os.path.join(ROOT, "tools", "exec_bench_torch.py")
TIMINGS = ("planned_s", "ring_s", "hierarchical_s", "naive_s")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _toy_plan(n, scenario="uniform"):
    """A real compute_plan over a hand-built RTT matrix: uniform = one
    flat rack, skewed = two racks interleaved with the naming order (as
    the reference's e2e test builds it)."""
    from tpu_network_operator.planner import plan as pp

    nodes = [f"exec-{i:03d}" for i in range(n)]
    groups = {
        node: (f"rack-{i % 2:02d}" if scenario == "skewed" else "rack-00")
        for i, node in enumerate(nodes)
    }
    obs = {a: {b: (0.1 if groups[a] == groups[b] else 5.0)
               * (1.0 + 0.01 * (i + j))
               for j, b in enumerate(nodes) if i != j}
           for i, a in enumerate(nodes)}
    return nodes, pp.compute_plan(pp.PlanInputs(
        nodes=nodes, rtt=pp.build_matrix(obs), groups=groups,
        excluded=frozenset(), seed="exec-e2e",
    ))


def _write_planned_bootstraps(tmp_path, n, devices, plan, nodes):
    """The agent path per node (build -> write -> apply_plan): each node
    a slice of ``devices`` chips; [(path, sha256)] in node order."""
    from tpu_network_operator.agent.tpu.bootstrap import (apply_plan,
                                                          build_bootstrap,
                                                          write_bootstrap)
    from tpu_network_operator.agent.tpu.topology import TpuTopology

    port = _free_port()
    out = []
    for pid in range(n):
        topo = TpuTopology(
            accelerator_type=f"cpu-host-{devices}", topology=f"1x{devices}",
            ici_mesh=(1, devices), num_chips=devices,
            chips_per_host=devices, num_hosts=1, worker_id=0,
            num_slices=n, slice_id=pid, megascale_coordinator="127.0.0.1",
        )
        cfg = build_bootstrap(
            topo, [{"workerId": 0, "ipAddress": "127.0.0.1"}],
            coordinator_port=port,
            megascale_coordinator=topo.megascale_coordinator,
        )
        path = tmp_path / f"bootstrap-{n}x{devices}-{pid}.json"
        write_bootstrap(cfg, str(path))
        assert apply_plan(str(path), plan.to_payload(),
                          node=nodes[pid]) is True
        out.append((path, hashlib.sha256(path.read_bytes()).hexdigest()))
    return out


def _run_workers(pairs, devices, argv, timeout=120):
    """``workload exec-bench --device cpu`` as ``devices`` rank processes
    per node file; each rank's JSON line, in rank order.  Every child is
    killed on any failure."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    try:
        for path, _ in pairs:
            for local in range(devices):
                procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "tpu_network_operator_torch.workload", "exec-bench",
                     "--device", "cpu", "--bootstrap", str(path), *argv],
                    cwd=ROOT, text=True, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE,
                    env={**env, "LOCAL_RANK": str(local),
                         "LOCAL_WORLD_SIZE": str(devices)}))
        lines = []
        for rank, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"rank {rank}: {err[-2000:]}"
            lines.append(json.loads(out.strip().splitlines()[-1]))
        return lines
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.mark.exec
@pytest.mark.parametrize("devices", [1, 2], ids=["2x1", "2x2"])
def test_exec_bench_workers_execute_the_plan(tmp_path, devices):
    """2 nodes of ``devices`` devices read agent-written plan-adopted
    bootstraps: each rank reports the sha256 of the bytes the agent left,
    the plan's version, hint and axis order, the world, and timings of
    every variant (the plan hints ring, so the planned timing is the
    ring's).  Several ranks share a node's file and job lock; none fails
    on it, and the lock is gone once all have exited."""
    nodes, plan = _toy_plan(2, "uniform")
    pairs = _write_planned_bootstraps(tmp_path, 2, devices, plan, nodes)
    lines = _run_workers(pairs, devices, ["--sizes-mb", "0.25", "--iters",
                                          "1"])
    payload = plan.to_payload()
    world = 2 * devices
    assert len(lines) == world
    for rank, r in enumerate(lines):
        path, sha = pairs[rank // devices]
        assert r["bootstrap_sha256"] == sha              # byte equality
        assert hashlib.sha256(path.read_bytes()).hexdigest() == sha
        assert r["plan_version"] == plan.version
        assert r["collective_hint"] == "ring"            # one flat rack
        assert r["mesh_axis_order"] == payload["meshAxisOrder"]
        assert r["mesh_axis_order"][0] == "fsdp"
        assert (r["process"], r["num_processes"]) == (rank // devices, 2)
        assert (r["local_devices"], r["global_devices"]) == (1, world)
        assert r["mesh_planned"] == {"fsdp": devices, "data": 2, "pipe": 1,
                                     "expert": 1, "seq": 1, "tensor": 1}
        assert list(r["mesh_naive"]) == sorted(r["mesh_planned"])
        (row,) = r["results"]
        for key in TIMINGS:
            assert row[key] > 0, key
        assert row["planned_strategy"] == "ring"
        assert row["planned_s"] == row["ring_s"]
        assert row["size_bytes"] == lines[0]["results"][0]["size_bytes"]
    for path, _ in pairs:
        assert not os.path.exists(str(path) + ".lock")


@pytest.mark.exec
def test_skewed_plan_hints_hierarchical_for_the_port(tmp_path):
    """Plan only, no processes: the launcher's skewed scenario at 4 nodes
    hints hierarchical and keeps data outermost, and the port's reader
    takes that from the files the agent path wrote (8 ranks of data 4 x
    fsdp 2 at 2 devices a node)."""
    from tpu_network_operator_torch.bootstrap import read_bootstrap
    from tpu_network_operator_torch.parallel.mesh import (
        dcn_collective, plan_from_bootstrap, planned_axis_order)

    eb = _launcher()
    plan, planned_ms, naive_ms = eb.compute_scenario_plan(4, "skewed", 7)
    assert plan.collective == "hierarchical"
    assert planned_ms < naive_ms
    pairs = eb.write_rank_bootstraps(str(tmp_path), "sk", 4, 2, plan)
    for pid, (path, sha) in enumerate(pairs):
        cfg = read_bootstrap(path)
        assert dcn_collective(cfg) == "hierarchical"
        assert planned_axis_order(cfg)[0] == "data"
        assert plan_from_bootstrap(cfg, 8).axis_sizes == {
            "data": 4, "fsdp": 2, "pipe": 1, "expert": 1, "seq": 1,
            "tensor": 1}
        assert cfg.plan["ringIndex"] == plan.ring.index(f"exec-{pid:03d}")


def _launcher():
    import importlib.util

    spec = importlib.util.spec_from_file_location("exec_bench_torch",
                                                  LAUNCHER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_launcher(tmp_path, argv, timeout):
    out = tmp_path / "BENCH_exec_torch.json"
    proc = subprocess.run(
        [sys.executable, LAUNCHER, *argv, "--out", str(out)],
        capture_output=True, text=True, timeout=timeout, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    row = json.loads(proc.stdout.strip().splitlines()[-1])
    assert row == json.loads(out.read_text())
    for key in ("metric", "value", "unit", "vs_baseline",
                "modeled_improvement_pct", "measured_vs_modeled_gap_pp",
                "measured_hier_vs_ring_pct", "scenarios", "notes", "ok",
                "failures"):
        assert key in row, key
    assert row["ok"] is True and row["failures"] == []
    assert row["unit"] == "percent"
    assert any("measured-vs-modeled gap" in n for n in row["notes"])
    for s in row["scenarios"]:
        assert s["collective_hint"] == s["expected_hint"]
        assert s["bootstrap_bytes_verified"] is True
        assert s["global_devices"] == s["procs"] * s["devices_per_proc"]
        assert s["modeled_planned_allreduce_ms"] > 0
        assert "measured_order_improvement_pct" in s
        assert "measured_vs_modeled_gap_pp" in s
        for r0 in s["results"]:
            for key in TIMINGS:
                assert r0[key] > 0, key
    return row


@pytest.mark.exec
def test_launcher_artifact_schema_and_gates(tmp_path):
    """The launcher at toy scale, 2 nodes x 2 rank processes: the BENCH
    artifact's schema and gates as ``TestExecBench`` holds the
    reference's (the single tiny payload sits far inside same-host
    jitter, so the ordering gate is opened to 3.0 as there)."""
    row = _run_launcher(tmp_path, [
        "--procs-list", "2", "--devices-per-proc", "2", "--sizes-mb",
        "0.25", "--iters", "1", "--order-noise-tol", "3.0"], timeout=300)
    (s,) = row["scenarios"]
    assert s["scenario"] == "uniform" and s["procs"] == 2
    assert s["collective_hint"] == s["expected_hint"] == "ring"
    assert s["global_devices"] == 4
    assert s["mesh_planned"]["fsdp"] == s["mesh_planned"]["data"] == 2
    assert len(s["results"]) == 1


@pytest.mark.exec
@pytest.mark.slow
def test_launcher_default_sweep_soak(tmp_path):
    """The launcher's default sweep: uniform at 2 nodes and skewed at 4
    nodes, 2 rank processes a node (8 ranks), 3 sizes, best of 3, at the
    default ordering tolerance."""
    row = _run_launcher(tmp_path, [], timeout=900)
    uniform, skewed = row["scenarios"]
    assert (uniform["scenario"], uniform["global_devices"]) == ("uniform", 4)
    assert (skewed["scenario"], skewed["global_devices"]) == ("skewed", 8)
    assert skewed["collective_hint"] == "hierarchical"
    assert skewed["mesh_planned"]["data"] == 4
