"""The port's CUDA device probe (``topology.py``) against the agent's
runtime probe (``agent/tpu/topology.py`` ``_from_libtpu``): the same
device records give the same topology dict, ``source`` aside, and the
probe refuses with the reference's two messages reworded for CUDA.

The reference reads its records through its ``TPUNET_FAKE_LIBTPU`` seam;
the port takes them as ``from_runtime(devices=...)``."""

import json

import pytest
import torch

from test_tpu_discovery import _fake_libtpu_file


@pytest.mark.parametrize("spec", [
    dict(),                                        # 2x2x2 coords, 2 hosts
    dict(coords=False, procs=1, pindex=0),         # flat, one host
    dict(grid=(4, 1, 1), procs=4, pindex=3, kind="TPU v5 lite"),
])
def test_same_records_give_the_reference_topology(tmp_path, monkeypatch,
                                                  spec):
    from tpu_network_operator.agent.tpu import topology as ref
    from tpu_network_operator_torch import topology

    path = _fake_libtpu_file(tmp_path, **spec)
    monkeypatch.setenv("TPUNET_FAKE_LIBTPU", path)
    want = ref._from_libtpu().to_dict()
    with open(path) as f:
        records = json.load(f)
    got = topology.from_runtime(devices=records["devices"],
                                process_index=records["process_index"])
    assert got.source == "cuda" and want["source"] == "libtpu"
    assert {**got.to_dict(), "source": None} == {**want, "source": None}


def test_probe_lists_the_cuda_devices_of_this_process(monkeypatch):
    """Without a launcher, one host; the process's host index is its
    ``RANK`` over ``LOCAL_WORLD_SIZE``, and every host of the world holds
    this host's cards."""
    from tpu_network_operator_torch import topology

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i: "NVIDIA H100 80GB HBM3")
    for var in ("RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    devices, me = topology.probe_devices()
    assert me == 0
    assert devices == [{"index": i, "device_kind": "NVIDIA H100 80GB HBM3",
                        "process_index": 0, "coords": None}
                       for i in range(4)]

    def fields(t):
        return (t.accelerator_type, t.ici_mesh, t.topology, t.num_chips,
                t.chips_per_host, t.num_hosts, t.worker_id, t.source)

    assert fields(topology.from_runtime()) == (
        "NVIDIA H100 80GB HBM3", (4,), "4", 4, 4, 1, 0, "cuda")
    # torchrun on the one 4-card host: rank 3 is on host 0
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert fields(topology.from_runtime()) == (
        "NVIDIA H100 80GB HBM3", (4,), "4", 4, 4, 1, 0, "cuda")
    # two 4-card hosts: rank 6 is on host 1, the mesh spans both
    monkeypatch.setenv("RANK", "6")
    monkeypatch.setenv("WORLD_SIZE", "8")
    devices, me = topology.probe_devices()
    assert me == 1
    assert [d["process_index"] for d in devices] == [0] * 4 + [1] * 4
    assert fields(topology.from_runtime()) == (
        "NVIDIA H100 80GB HBM3", (8,), "8", 8, 4, 2, 1, "cuda")
    # ranks started by hand without LOCAL_WORLD_SIZE share one host
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert topology.from_runtime().worker_id == 0


def test_probe_refusals(monkeypatch):
    from tpu_network_operator_torch import topology

    with pytest.raises(topology.TopologyError,
                       match="^cuda probe found no CUDA devices$"):
        topology.from_runtime(devices=[], process_index=0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(topology.TopologyError,
                       match="^cuda probe found no CUDA devices$"):
        topology.from_runtime()

    def broken():
        raise RuntimeError("no device node")

    monkeypatch.setattr(torch.cuda, "device_count", broken)
    with pytest.raises(topology.TopologyError,
                       match="^cuda probe failed: no device node$"):
        topology.from_runtime()
