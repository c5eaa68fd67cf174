"""The port's own reader of the agent's bootstrap file, and the job lock.

The node agent writes ``jax-coordinator.json`` (schema:
``docs/bootstrap-schema.md``); the reference reads it with
``tpu_network_operator/agent/tpu/bootstrap.py``.  This module reads the
same schema for the PyTorch workload and imports nothing of the agent.
It keeps the fields the mesh reads: ``version``, ``coordinator_address``,
``num_processes``, ``process_id``, ``topology.num_chips`` /
``num_slices`` / ``chips_per_host``, and the optional ``plan`` block the
operator's planner folds in.  An unknown ``version`` is a hard error, as
in the reference.

The reference runs one JAX process per host, so ``num_processes`` counts
hosts x slices.  The port runs one process per GPU: a host's launcher
starts ``local_world`` of them, and :func:`gpu_rank` numbers them
``process_id * local_world + local_rank`` in a world of ``num_processes *
local_world``, which must equal ``num_chips * num_slices``.

:class:`JobLock` is the drain signal: a job that consumed the bootstrap
holds ``<bootstrap>.lock`` and refreshes its mtime every
:data:`LOCK_HEARTBEAT` seconds; the agent's SIGTERM drain waits for it to
clear or go stale before it withdraws routes.
"""

from __future__ import annotations

import binascii
import json
import os
import tempfile
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

SCHEMA_VERSION = 1
LOCK_HEARTBEAT = 3.0


class BootstrapError(Exception):
    pass


@dataclass(frozen=True)
class Topology:
    """The slice facts the mesh reads from the bootstrap's ``topology``."""

    num_chips: int = 0
    chips_per_host: int = 0
    num_slices: int = 1


@dataclass(frozen=True)
class BootstrapConfig:
    coordinator_address: str = ""
    num_processes: int = 0
    process_id: int = 0
    topology: Optional[Topology] = None
    plan: Optional[Dict] = None

    @classmethod
    def from_dict(cls, d: Dict) -> "BootstrapConfig":
        if d.get("version") != SCHEMA_VERSION:
            raise BootstrapError(
                f"unsupported bootstrap schema version {d.get('version')!r}"
            )
        topo = d.get("topology") or {}
        plan = d.get("plan")
        return cls(
            coordinator_address=d.get("coordinator_address", ""),
            num_processes=d.get("num_processes", 0),
            process_id=d.get("process_id", 0),
            topology=Topology(
                num_chips=topo.get("num_chips", 0),
                chips_per_host=topo.get("chips_per_host", 0),
                num_slices=topo.get("num_slices", 1),
            ),
            plan=dict(plan) if isinstance(plan, dict) else None,
        )


def read_bootstrap(path: str) -> BootstrapConfig:
    with open(path) as f:
        return BootstrapConfig.from_dict(json.load(f))


def gpu_rank(cfg: BootstrapConfig, local_rank: int = 0,
             local_world: int = 1) -> Tuple[int, int]:
    """(rank, world) of this GPU process: ``process_id * local_world +
    local_rank`` of ``num_processes * local_world``.  Raises
    :class:`BootstrapError` where the file's chip count disagrees with
    that world (nothing is reshaped to fit) or the ids are out of range."""
    if cfg.num_processes < 1 or not 0 <= cfg.process_id < cfg.num_processes:
        raise BootstrapError(
            f"process_id {cfg.process_id} out of range for num_processes "
            f"{cfg.num_processes}"
        )
    if not 0 <= local_rank < local_world:
        raise BootstrapError(
            f"local rank {local_rank} out of range for {local_world} "
            "processes on this host"
        )
    world = cfg.num_processes * local_world
    topo = cfg.topology
    if topo is not None and topo.num_chips > 0 \
            and topo.num_chips * topo.num_slices != world:
        raise BootstrapError(
            f"the bootstrap's num_chips {topo.num_chips} x num_slices "
            f"{topo.num_slices} is not the world of {world} GPU processes "
            f"({cfg.num_processes} processes x {local_world} per host)"
        )
    return cfg.process_id * local_world + local_rank, world


# -- job lock -----------------------------------------------------------------


def lock_path(bootstrap_path: str) -> str:
    return bootstrap_path + ".lock"


def _write_atomic(path: str, data: str) -> None:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=".tmp-")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(data)
        os.chmod(tmp, 0o644)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


class JobLock:
    """``<bootstrap>.lock`` held while the job runs, its mtime refreshed
    by a daemon thread.  :meth:`release` removes only a lock that still
    carries this holder's token, as the reference's does."""

    def __init__(self, bootstrap_path: str):
        self.path = lock_path(bootstrap_path)
        self.token = binascii.hexlify(os.urandom(8)).decode()
        _write_atomic(self.path, json.dumps(
            {"token": self.token, "pid": os.getpid()}) + "\n")
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._beat, daemon=True)
        self._thread.start()

    def _beat(self) -> None:
        while not self._stop.wait(LOCK_HEARTBEAT):
            try:
                os.utime(self.path)
            except OSError:
                return          # the lock was removed: stop beating

    def release(self) -> None:
        self._stop.set()
        try:
            with open(self.path) as f:
                if json.load(f).get("token") != self.token:
                    return      # another holder's lock now: leave it
        except (OSError, ValueError):
            return
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass


def acquire_job_lock(bootstrap_path: str) -> JobLock:
    return JobLock(bootstrap_path)
