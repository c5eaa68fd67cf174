"""Back-to-back all-reduces over the fsdp axis of the port's mesh.

The command starts one process a chip; they meet through a file store
under ``TMPDIR``, build the port's mesh (``parallel/mesh.py`` ``make_mesh``
over fsdp = ranks) and sum each rank's seeded bf16 buffer over the axis's
NCCL group with the port's out-of-place all-reduce (``parallel/comm.py``
``all_reduce``, the one the sharded train step's gradient sums use).  Set-up
times a few calls to fix how many the window holds (every rank must issue
the same number), which rank 0 broadcasts; the window enqueues them back
to back after a barrier and ends with one synchronisation.  Seeded calls'
outputs are kept, and after the window every rank holds each of them to
the float32 sum of all ranks' inputs, drawn again from the seed.
"""

from __future__ import annotations

import math
import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from typing import Dict, List

import torch

from portbench import common, costs, weights

RANK_TIMEOUT_S = 600.0


def planted(fault, reduce):
    """The all-reduce with a fault the comparison must catch planted under
    it: the exchange left out, or an answer altered where it is made."""
    if fault is None:
        return reduce
    if fault == "no_exchange":
        return lambda x, group: x.clone()
    if fault == "answer":
        def altered(x, group):
            out = reduce(x, group)
            out[0] += 1.0
            return out
        return altered
    raise ValueError(f"no fault {fault!r} in an all-reduce cell")


def _input(seed: int, rank: int, n: int, device) -> torch.Tensor:
    g = weights.generator(device, weights.mix(seed, 1 << 24, rank))
    return torch.randn(n, generator=g, dtype=torch.bfloat16, device=device)


def reference_sum(seed: int, world: int, n: int, device) -> torch.Tensor:
    total = torch.zeros(n, dtype=torch.float32, device=device)
    for r in range(world):
        total += _input(seed, r, n, device).float()
    return total


def control_sum(seed: int, world: int, n: int, device) -> torch.Tensor:
    """The sum carried in float8 e4m3, one rank's input at a time: the
    control one precision below the buffers' bfloat16."""
    acc = torch.zeros(n, dtype=torch.float8_e4m3fn, device=device)
    for r in range(world):
        acc = (acc.float() + _input(seed, r, n, device).float()).to(
            torch.float8_e4m3fn)
    return acc.float()


def sum_error(outs: List[torch.Tensor], ref: torch.Tensor) -> float:
    """The widest distance of any output element from the float32 sum, in
    units of the sum's root mean square."""
    rms = float(ref.pow(2).mean().sqrt())
    return max(float((o.float() - ref).abs().max()) for o in outs) / rms


def _rank_body(rank: int, world: int, dev: torch.device, job: Dict) -> Dict:
    import torch.distributed as dist
    from tpu_network_operator_torch.parallel import comm
    from tpu_network_operator_torch.parallel.mesh import make_mesh, plan_axes

    cfg, tr = job["config"], job["traffic"]
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    mesh = make_mesh(plan_axes(world, fsdp=world), dev)
    group = mesh.group(cfg["axis"])
    n = cfg["buffer_bytes_per_rank"] // 2
    x = _input(job["seed"], rank, n, dev)
    reduce = planted(job["fault"], comm.all_reduce)
    for _ in range(tr["warm_calls"]):
        reduce(x, group)
    sync()
    dist.barrier()
    t = time.perf_counter()
    for _ in range(tr["calibrate_calls"]):
        reduce(x, group)
    sync()
    per = (time.perf_counter() - t) / tr["calibrate_calls"]
    calls = torch.tensor([max(math.ceil(job["seconds"] / per), 1)],
                         dtype=torch.int64, device=dev)
    dist.broadcast(calls, src=0)
    calls = int(calls.item())
    g = weights.generator("cpu", weights.mix(job["seed"], 9))
    keep = set(torch.randperm(calls, generator=g)[:tr["samples"]].tolist())
    keep.add(calls - 1)
    # the allocator holds the blocks the kept outputs will take
    blocks = [torch.empty_like(x) for _ in range(len(keep) + 2)]
    del blocks
    sync()
    dist.barrier()
    sync()

    t_start = time.perf_counter()
    kept = []
    for i in range(calls):
        out = reduce(x, group)
        if i in keep:
            kept.append(out)
    sync()
    window = time.perf_counter() - t_start
    res = {"calls": calls, "window_s": window, "t_start": t_start,
           "bytes": x.numel() * x.element_size(),
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                 if cuda else 0)}
    if job["trace"]:
        from portbench import trace

        def twenty():
            for _ in range(20):
                reduce(x, group)

        prof, wall = trace.profile(twenty)
        reading = trace.Reading(prof, wall)
        res.update(busy_s=reading.busy_s, trace_window_s=wall,
                   breakdown=reading.breakdown())
        del prof
    res["forbidden"] = common.forbidden_modules()
    del out
    ref = reference_sum(job["seed"], world, n, dev)
    res["sum_error"] = sum_error(kept, ref)
    if job["control"]:
        res["control_error"] = sum_error([control_sum(job["seed"], world, n,
                                                      dev)], ref)
    return res


def _rank_main(rank: int, world: int, device_type: str, store: str, job: Dict,
               results) -> None:
    import datetime

    import torch.distributed as dist

    if device_type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            init_method=f"file://{store}", rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
        try:
            results.put((rank, True, _rank_body(rank, world, dev, job)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def launch(world: int, device_type: str, job: Dict) -> List[Dict]:
    """``world`` rank processes, each its result, in rank order; none is
    left running on return."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    got: Dict[int, tuple] = {}
    with tempfile.TemporaryDirectory(prefix="portbench-",
                                     dir=os.environ.get("TMPDIR")) as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world, device_type, store, job, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + RANK_TIMEOUT_S
        failed = None
        try:
            while len(got) < world and time.monotonic() < deadline:
                try:
                    rank, ok, value = results.get(timeout=0.5)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in got]
                    if dead:
                        failed = f"rank {dead[0]} died before it reported"
                        break
                    continue
                got[rank] = (ok, value)
                if not ok:
                    failed = f"rank {rank} raised:\n{value}"
                    break
            if failed is None and len(got) < world:
                failed = f"ranks gave no result within {RANK_TIMEOUT_S} s"
        finally:
            for p in procs:
                if p.is_alive() and failed is None:
                    p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                p.join()
            results.close()
            results.join_thread()
    if failed is not None:
        raise RuntimeError(failed)
    return [got[r][1] for r in range(world)]


def run(ctx) -> Dict:
    cfg = ctx.config
    world = cfg["ranks"]
    job = {"config": cfg, "traffic": ctx.traffic, "seed": ctx.seed,
           "seconds": ctx.seconds, "trace": ctx.trace, "fault": ctx.fault,
           "control": ctx.control}
    ranks = launch(world, torch.device(ctx.device).type, job)
    head = ranks[0]
    out = {"attempted": head["calls"], "failed": 0,
           "setup_s": head["t_start"] - ctx.clock.t0,
           "e2e": {"allreduce_busbw": costs.allreduce_busbw(
               head["calls"], head["bytes"], world, head["window_s"])},
           "memory_peak_bytes": max(r["memory_peak_bytes"] for r in ranks),
           "device_count": world,
           "forbidden": sorted({m for r in ranks for m in r["forbidden"]}),
           "compared": {"sum_error": max(r["sum_error"] for r in ranks)}}
    if ctx.control:
        out["control"] = {"sum_error": max(r["control_error"] for r in ranks)}
    if ctx.trace:
        busy = sum(r["busy_s"] for r in ranks) / world
        win = sum(r["trace_window_s"] for r in ranks) / world
        out["trace"] = {"kind": "allreduce", "busy_s": busy,
                        "trace_window_s": win,
                        "breakdown": head["breakdown"]}
    return out
