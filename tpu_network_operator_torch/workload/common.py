"""Shared plumbing for the workload subcommands: the process group and
the mesh, result emission, model presets and ``--profile`` (the port's own
copies of the reference's helpers)."""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import sys
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .. import resolve_device

def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def emit(payload: dict) -> None:
    print(json.dumps(payload))


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def llama_presets():
    from ..models import LlamaConfig

    return {
        "tiny": LlamaConfig.tiny,
        "llama3-150m": LlamaConfig.llama3_150m,
        "llama3-1b": LlamaConfig.llama3_1b,
        "llama3-3b": LlamaConfig.llama3_3b,
        "llama3-8b": LlamaConfig.llama3_8b,
    }


def moe_presets():
    from ..models import MoEConfig

    return {
        "tiny": MoEConfig.tiny,
        "small": MoEConfig.small,
        "mixtral-8x7b": MoEConfig.mixtral_8x7b,
    }


LLAMA_PRESET_NAMES = (
    "tiny", "llama3-150m", "llama3-1b", "llama3-3b", "llama3-8b"
)


def pick_preset(presets: dict, name: str, model: str):
    if name not in presets:
        raise SystemExit(
            f"unknown preset {name!r} for model {model!r}; "
            f"choose from {sorted(presets)}"
        )
    return presets[name]()


@contextlib.contextmanager
def maybe_profile(directory: Optional[str], name: str,
                  device: torch.device):
    """``torch.profiler`` over the block when ``directory`` is given (the
    ``--profile`` flag), else nothing: the host's ops and, on CUDA, the
    card's kernels and copies, written on exit as the Chrome trace
    ``<directory>/<name>.trace.json``."""
    if not directory:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(directory, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
        sync(device)
    path = os.path.join(directory, f"{name}.trace.json")
    prof.export_chrome_trace(path)
    log(f"profile of {name} written to {path}")


# set by the CLI's main when a subcommand returned: the group this process
# started is then torn down at exit, every rank through one barrier
_RETURNED = {"ok": False}


def finish_subcommand() -> None:
    """Mark the subcommand as returned (the CLI's ``main`` calls it)."""
    _RETURNED["ok"] = True


def _teardown_group() -> None:
    """At exit, the process group :func:`init_distributed` started, if it
    is still up: after a returned subcommand, a barrier (rank 0 serves the
    TCP store the others' groups read, so it waits for them) and then
    ``destroy_process_group``, while Python can still join the groups'
    threads.  A group left to the interpreter's teardown can abort the
    process ("terminate called without an active exception") after its
    work is done.  After a failure, no barrier: a peer may never reach it.
    """
    if not dist.is_initialized():
        return
    if _RETURNED["ok"]:
        dist.barrier()
    dist.destroy_process_group()


def init_distributed(bootstrap_path: Optional[str], device) -> Tuple:
    """(bootstrap config or None, this process's device), after starting
    the process group where there is one: from the agent's bootstrap file
    (``--bootstrap``; its job lock held for the life of the process, as
    the agent's drain expects), or from a launcher's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
    ``MASTER_PORT``, as torchrun sets them), one process per GPU.  Neither:
    one process, no group.  The backend follows ``device``: NCCL for
    CUDA, gloo for the CPU.  A group started here is torn down at exit
    (:func:`_teardown_group`)."""
    from ..bootstrap import acquire_job_lock, read_bootstrap
    from ..parallel.mesh import BACKENDS, DEFAULT_TIMEOUT, init_process_group

    dev = resolve_device(device)
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    if bootstrap_path:
        cfg = read_bootstrap(bootstrap_path)
        lock = acquire_job_lock(bootstrap_path)
        atexit.register(lock.release)
        # registered after the lock: atexit runs it first
        atexit.register(_teardown_group)
        dev = init_process_group(
            cfg, dev, local_rank=local_rank,
            local_world=int(os.environ.get("LOCAL_WORLD_SIZE", 1)))
        log(f"process group ({dist.get_backend()}): rank {dist.get_rank()}/"
            f"{dist.get_world_size()}, coordinator "
            f"{cfg.coordinator_address}")
        return cfg, dev
    if "WORLD_SIZE" not in os.environ:
        return None, dev
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    dist.init_process_group(BACKENDS[dev.type], init_method="env://",
                            timeout=DEFAULT_TIMEOUT)
    atexit.register(_teardown_group)
    return None, dev


def build_mesh(args, bootstrap, device):
    """The job mesh of the flags over the process group (None: one
    process and no group, the single-device path)."""
    from ..parallel.mesh import make_mesh, mesh_from_bootstrap, plan_axes

    kw = dict(tensor=args.tensor, seq=args.seq, expert=args.expert,
              pipe=args.pipe)
    if not dist.is_initialized():
        plan_axes(1, **kw)          # raises where the flags need more ranks
        return None
    if bootstrap is not None:
        return mesh_from_bootstrap(bootstrap, device, **kw)
    return make_mesh(plan_axes(dist.get_world_size(), **kw), device)


def mesh_report(mesh, device, pipeline=None) -> dict:
    """The JSON line's ``mesh``: the axis sizes, the world and the device;
    with a ``pipeline`` step (``parallel.pipeline.PipelineStep``) also its
    schedule, microbatches and layer chunks a stage."""
    if mesh is None:
        return {"devices": 1, "device": str(device)}
    report = {**mesh.shape, "devices": mesh.plan.size(),
              "device": str(device)}
    if pipeline is not None:
        report.update(pp_schedule=pipeline.schedule,
                      microbatches=pipeline.M,
                      virtual_stages=pipeline.v)
    return report


def batch_rows(tokens: torch.Tensor, mesh,
               microbatches: int = 1) -> torch.Tensor:
    """This rank's rows of a global batch: its shard along data x fsdp,
    and under the pipeline's ``microbatches`` its share of each
    (``parallel.pipeline.microbatch_rows``)."""
    if mesh is None:
        return tokens
    if microbatches > 1:
        from ..parallel.pipeline import microbatch_rows

        return microbatch_rows(tokens, mesh, microbatches)
    n = mesh.size("data", "fsdp")
    if tokens.shape[0] % n:
        raise SystemExit(
            f"batch {tokens.shape[0]} does not shard over the {n} ranks of "
            "data x fsdp"
        )
    return tokens.chunk(n)[mesh.index("data", "fsdp")]
