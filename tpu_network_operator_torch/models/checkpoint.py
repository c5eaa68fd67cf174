"""Checkpoint and resume for the train state, on one device or a mesh.

Counterpart of ``tpu_network_operator/models/checkpoint.py`` (orbax) with
the same surface, built on ``torch.distributed.checkpoint`` (DCP):

* a step is a directory ``<directory>/<step>`` holding the parameters and
  the optimizer state (the moments, the int8 / float8 codes and their f32
  scales, and ``count``), written under a temporary name and renamed when
  complete, so a half-written step is never the latest;
* :meth:`TrainCheckpointer.restore` loads in place into the tensors that
  ``init_all`` made, the port's counterpart of the reference's
  ``abstract_state``: one copy of the state, never two;
* saves are asynchronous by default.  The train step updates the
  parameters and moments in place, so :meth:`TrainCheckpointer.save`
  copies the state to host memory before it returns, and only the file
  write runs in the background: a later step never reaches an earlier
  step's checkpoint;
* ``max_to_keep`` keeps the newest steps and deletes the rest.

On one device (``mesh`` None) DCP runs without a process group and every
leaf is a whole tensor.  On a mesh (``mesh`` and ``specs``, the train
state's mesh specs by name) every rank saves its shards as ``DTensor`` s
of the global leaves (:func:`..parallel.mesh.as_dtensor`), and a restore
reads each rank's shards of whatever mesh the resuming job built: the
reference's elastic resume across mesh shapes of one world.  A
checkpoint of either kind restores as the other, since DCP stores global
leaves in chunks.  ``count``, a host int, is one replicated tensor:
saved once, read by every rank.

The mesh's saves plan and finish over a gloo group of the checkpointer's
own, made on every rank in the same order when it is built: the write
runs in a background thread, and DCP's collectives there must not share
a communicator with the train step's, which the main thread keeps
issuing (two threads on one NCCL communicator may order their
collectives differently on two ranks, and hang).  Rank 0 alone clears a
temporary directory, renames a written step into place and deletes old
steps, each behind a barrier on that group, so no rank sees a step
before every rank's shards and the metadata are on disk.  The directory
must be one that every rank sees (a shared file system across hosts).
"""

from __future__ import annotations

import concurrent.futures
import shutil
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

_TMP = ".tmp-"


def _flatten(tree: Any, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    """Key path -> tensor for every leaf of a nested dict / NamedTuple
    tree.  Tensors are detached views (a load into them writes the
    caller's tensors); an int leaf becomes a 0-dim int64 tensor."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            _flatten(v, f"{prefix}/{k}", out)
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            _flatten(v, f"{prefix}/{k}", out)
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree.detach()
    elif isinstance(tree, int):
        out[prefix] = torch.tensor(tree, dtype=torch.int64)
    else:
        raise TypeError(f"cannot checkpoint {prefix}: {type(tree).__name__}")


def _set_ints(tree: Any, prefix: str, flat: Mapping[str, torch.Tensor]):
    """Write the loaded values of the int leaves back into ``tree``."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            if isinstance(v, int):
                tree[k] = int(flat[f"{prefix}/{k}"])
            else:
                _set_ints(v, f"{prefix}/{k}", flat)


def flat_state(params: Any, opt_state: Any) -> Dict[str, torch.Tensor]:
    """Key path -> tensor for every leaf of the train state, the form a
    step is saved in (``count`` as a 0-dim int64 tensor)."""
    flat: Dict[str, torch.Tensor] = {}
    _flatten(params, "params", flat)
    _flatten(opt_state, "opt_state", flat)
    return flat


def _flatten_specs(tree: Any, prefix: str, out: Dict[str, Any]) -> None:
    """Key path -> spec for a tree of specs shaped as the train state (a
    spec is a tuple of axis names, None where the leaf is not sharded)."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            _flatten_specs(v, f"{prefix}/{k}", out)
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            _flatten_specs(v, f"{prefix}/{k}", out)
    else:
        out[prefix] = tree


class TrainCheckpointer:
    """Checkpoint manager for (params, opt_state) train state.

    Usage::

        ckpt = TrainCheckpointer(path, max_to_keep=3)
        ckpt.save(step, params, opt_state)          # async by default
        step, params, opt_state = ckpt.restore(
            init_all(generator))                     # latest step, in place
        ckpt.close()                                 # drain pending saves

    On a mesh, ``mesh`` is the job's :class:`..parallel.mesh.Mesh` and
    ``specs`` the (params, opt_state) pair of spec trees (the model's
    ``param_specs`` and the optimizer's ``state_specs``); every rank
    builds the checkpointer and calls each method at the same point."""

    def __init__(self, directory, *, max_to_keep: Optional[int] = 3,
                 async_save: bool = True, mesh=None, specs=None):
        self._dir = Path(directory).resolve()
        self._dir.mkdir(parents=True, exist_ok=True)
        self._max_to_keep = max_to_keep
        self._pool = (concurrent.futures.ThreadPoolExecutor(max_workers=1)
                      if async_save else None)
        self._pending: List[concurrent.futures.Future] = []
        self._mesh = mesh
        if mesh is not None:
            from ..parallel.mesh import host_device_mesh

            if specs is None:
                raise ValueError("a checkpoint on a mesh needs the state's "
                                 "specs")
            self._specs: Dict[str, Any] = {}
            _flatten_specs(specs[0], "params", self._specs)
            _flatten_specs(specs[1], "opt_state", self._specs)
            self._group = dist.new_group(backend="gloo")
            self._host_mesh = host_device_mesh(mesh.plan)
            self._lead = dist.get_rank() == 0

    def _dtensors(self, flat: Dict[str, torch.Tensor], device_mesh):
        """Each sharded leaf of ``flat`` as a DTensor view on
        ``device_mesh``; ``count`` stays a plain (replicated) tensor."""
        from ..parallel.mesh import as_dtensor

        return {k: t if self._specs[k] is None else
                as_dtensor(t, self._specs[k], self._mesh.plan, device_mesh)
                for k, t in flat.items()}

    def save(self, step: int, params: Any, opt_state: Any) -> None:
        """Snapshot the state to host memory, then write it (in the
        background when async)."""
        snapshot = {k: t.to("cpu", copy=True)
                    for k, t in flat_state(params, opt_state).items()}
        if self._mesh is not None:
            snapshot = self._dtensors(snapshot, self._host_mesh)
        if self._pool is None:
            self._write(step, snapshot)
        else:
            self._pending.append(self._pool.submit(self._write, step,
                                                   snapshot))

    def _write(self, step: int, snapshot: Dict[str, torch.Tensor]) -> None:
        final, tmp = self._dir / str(step), self._dir / f"{_TMP}{step}"
        if self._mesh is None:
            shutil.rmtree(tmp, ignore_errors=True)
            dcp.save(snapshot, storage_writer=dcp.FileSystemWriter(tmp),
                     no_dist=True)
            self._publish(tmp, final)
            return
        if self._lead:
            shutil.rmtree(tmp, ignore_errors=True)
        dist.barrier(group=self._group)
        dcp.save(snapshot, storage_writer=dcp.FileSystemWriter(tmp),
                 process_group=self._group)
        dist.barrier(group=self._group)
        if self._lead:
            self._publish(tmp, final)
        dist.barrier(group=self._group)

    def _publish(self, tmp: Path, final: Path) -> None:
        """Rename a complete step into place and apply the retention."""
        shutil.rmtree(final, ignore_errors=True)
        tmp.rename(final)
        if self._max_to_keep is not None:
            for old in self.all_steps()[:-self._max_to_keep]:
                shutil.rmtree(self._dir / str(old), ignore_errors=True)

    def all_steps(self) -> List[int]:
        """The complete steps on disk, oldest first."""
        return sorted(int(p.name) for p in self._dir.iterdir()
                      if p.name.isdigit() and (p / ".metadata").exists())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(
        self,
        templates: Tuple[Any, Any],
        step: Optional[int] = None,
    ) -> Tuple[int, Any, Any]:
        """(step, params, opt_state): ``templates`` (the (params,
        opt_state) pair ``init_all`` returned: on a mesh, this rank's
        shards) loaded in place with the saved step (the latest when
        None) and returned, after any pending save is on disk."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self._dir}")
        params, opt_state = templates
        flat = flat_state(params, opt_state)
        reader = dcp.FileSystemReader(self._dir / str(step))
        if self._mesh is None:
            dcp.load(flat, storage_reader=reader, no_dist=True)
        else:
            dcp.load(self._dtensors(flat, self._mesh.device_mesh),
                     storage_reader=reader, process_group=self._group)
        _set_ints(opt_state, "opt_state", flat)
        return step, params, opt_state

    def wait(self) -> None:
        """Block until queued async saves are on disk (re-raising a
        failed save's error)."""
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            if self._pool is not None:
                self._pool.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
