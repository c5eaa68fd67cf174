"""The CUDA device probe: the local runtime's devices as the agent's
topology record.

Counterpart of ``tpu_network_operator/agent/tpu/topology.py:347-405``
(``_probe_devices`` and ``_from_libtpu``, the agent's ``jax.devices("tpu")``
probe): :func:`probe_devices` lists the ``torch.cuda`` devices of every host
of a launcher's world, each with its host's index (the reference's
``process_index``: one JAX process a host), and :func:`from_runtime` builds a :class:`GpuTopology` with the
fields the reference's libtpu path fills and the same ``to_dict()``.  GPUs
report no grid coordinates, so the ICI mesh is flat, ``(n,)``; a given
device record that carries ``coords`` is honoured as the reference honours
them.  The agent keeps its own probe; nothing here imports it.

The seam for tests is :func:`from_runtime`'s ``devices=`` argument (records
of the reference's fake-device shape: ``{"device_kind": ..,
"process_index": .., "coords": [..] or None}``); nothing on the card's path
reads an environment variable to redirect the probe.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch


class TopologyError(Exception):
    pass


@dataclass
class GpuTopology:
    """The devices' mesh and this process's place in it, in the fields
    (and ``to_dict()`` keys) of the reference's ``TpuTopology``."""

    accelerator_type: str = ""
    generation: str = ""
    topology: str = ""
    ici_mesh: Tuple[int, ...] = ()
    chips_per_host_bounds: Tuple[int, ...] = ()
    host_bounds: Tuple[int, ...] = ()
    num_chips: int = 0
    chips_per_host: int = 0
    num_hosts: int = 0
    worker_id: int = 0
    num_slices: int = 1
    slice_id: int = 0
    megascale_coordinator: str = ""
    source: str = ""

    def to_dict(self) -> Dict:
        return {
            "accelerator_type": self.accelerator_type,
            "generation": self.generation,
            "topology": self.topology,
            "ici_mesh": list(self.ici_mesh),
            "chips_per_host_bounds": list(self.chips_per_host_bounds),
            "host_bounds": list(self.host_bounds),
            "num_chips": self.num_chips,
            "chips_per_host": self.chips_per_host,
            "num_hosts": self.num_hosts,
            "worker_id": self.worker_id,
            "num_slices": self.num_slices,
            "slice_id": self.slice_id,
            "megascale_coordinator": self.megascale_coordinator,
            "source": self.source,
        }


def host_layout() -> Tuple[int, int]:
    """(this process's host index, the number of hosts) from a launcher's
    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_WORLD_SIZE``: ranks are numbered
    host by host, ``LOCAL_WORLD_SIZE`` a host (without it, every rank is
    on one host); (0, 1) without a launcher."""
    world = int(os.environ.get("WORLD_SIZE", 1))
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return (int(os.environ.get("RANK", 0)) // max(1, local),
            max(1, world // max(1, local)))


def probe_devices() -> Tuple[List[Dict], int]:
    """(every host's ``torch.cuda`` devices, as records with ``index``,
    ``device_kind``, ``process_index`` (the host's index) and ``coords``
    None; this process's host index).  A process sees only its own host's
    cards, so every other host of the launcher's world is taken to hold
    the same cards, as a launcher's hosts do."""
    me, hosts = host_layout()
    local = [torch.cuda.get_device_name(i)
             for i in range(torch.cuda.device_count())]
    return [{"index": i, "device_kind": kind, "process_index": host,
             "coords": None}
            for host in range(hosts) for i, kind in enumerate(local)], me


def from_runtime(devices: Optional[Sequence[Mapping]] = None,
                 process_index: Optional[int] = None) -> GpuTopology:
    """The topology of ``devices`` (None: :func:`probe_devices`) seen by
    the host ``process_index`` (None: this process's).  Raises
    :class:`TopologyError` where the probe fails or finds no device."""
    try:
        if devices is None:
            devices, probed = probe_devices()
            if process_index is None:
                process_index = probed
    except Exception as e:
        raise TopologyError(f"cuda probe failed: {e}") from e
    if process_index is None:
        process_index = host_layout()[0]
    if not devices:
        raise TopologyError("cuda probe found no CUDA devices")
    coords = [d.get("coords") for d in devices]
    kind = devices[0]["device_kind"]
    if all(c is not None for c in coords):
        mesh = tuple(max(c[i] for c in coords) + 1
                     for i in range(len(coords[0])))
    else:
        mesh = (len(devices),)
    local = [d for d in devices if d["process_index"] == process_index]
    return GpuTopology(
        accelerator_type=kind,
        generation=kind,
        topology="x".join(str(d) for d in mesh),
        ici_mesh=mesh,
        num_chips=len(devices),
        chips_per_host=len(local),
        num_hosts=max(1, len(devices) // max(1, len(local))),
        worker_id=process_index,
        source="cuda",
    )
