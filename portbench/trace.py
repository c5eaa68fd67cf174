"""The traced run's reading of ``torch.profiler``: the device's busy time
(the union of its kernel and copy intervals), the operations that took
the most device time, the longest idle gaps named by what the host was
doing, and the device time of the GEMMs grouped by their operands."""

from __future__ import annotations

import bisect
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

TOP = 10


def profile(fn: Callable[[], None], record_shapes: bool = False):
    """(profiler, wall seconds) of ``fn()``, the device idle at both ends."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof_ctx

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with prof_ctx(activities=acts, record_shapes=record_shapes) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall


def _is_device(e) -> bool:
    from torch.autograd import DeviceType

    return e.device_type == DeviceType.CUDA


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Reading:
    """What one profiled stretch shows (times in seconds)."""

    def __init__(self, prof, wall: float):
        events = list(prof.events())
        dev = [e for e in events if _is_device(e)]
        self.window_s = wall
        self.kernels: List[Tuple[str, float, float]] = [
            (e.name, e.time_range.start, e.time_range.end) for e in dev]
        spans = _union([(a, b) for _, a, b in self.kernels])
        self.busy_s = sum(b - a for a, b in spans) / 1e6
        self.launches = sum(1 for e in dev if not e.name.startswith("Memcpy")
                            and not e.name.startswith("Memset"))
        by_name: Dict[str, float] = {}
        for name, a, b in self.kernels:
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
        self.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])
        host = sorted(((e.time_range.start, e.time_range.end, e.name)
                       for e in events if not _is_device(e)
                       and not e.name.startswith("cuda")),
                      key=lambda t: t[0])
        self.idle_gaps = self._gaps(spans, host)
        self._events = events

    @staticmethod
    def _gaps(spans, host) -> List[Tuple[str, float]]:
        """The idle time between device work, summed by the name of the
        innermost host operation running at each gap's middle, for the
        longest gaps."""
        gaps = sorted(((b0, a1) for (_, b0), (a1, _) in zip(spans, spans[1:])
                       if a1 > b0), key=lambda g: g[0] - g[1])[:500]
        starts = [h[0] for h in host]
        out: Dict[str, float] = {}
        for a, b in gaps:
            mid = (a + b) / 2
            i = bisect.bisect_right(starts, mid)
            best = None
            for j in range(i - 1, max(i - 4000, -1), -1):
                s, e, name = host[j]
                if e >= mid and (best is None or e - s < best[0]):
                    best = (e - s, name)
            label = best[1] if best else "host outside any operation"
            out[label] = out.get(label, 0.0) + (b - a) / 1e6
        return sorted(out.items(), key=lambda kv: -kv[1])

    def kernel_s(self, *fragments: str) -> float:
        """Device seconds of the kernels whose names hold any fragment."""
        return sum((b - a) / 1e6 for name, a, b in self.kernels
                   if any(f in name for f in fragments))

    def gemm_s(self, group: Callable[[list], Optional[str]]) -> Dict[str, float]:
        """Device seconds of the ``aten::mm`` / ``aten::bmm`` calls (the
        kernels each launched), summed by ``group(input_shapes)``."""
        out: Dict[str, float] = {}
        for e in self._events:
            if _is_device(e) or e.name not in ("aten::mm", "aten::bmm"):
                continue
            g = group(e.input_shapes)
            if g is None:
                continue
            us = getattr(e, "device_time_total", None)
            us = e.cuda_time_total if us is None else us
            out[g] = out.get(g, 0.0) + us / 1e6
        return out

    def breakdown(self) -> Dict:
        return {"device_ops": [[n[:160], s] for n, s in
                               self.device_ops[:TOP]],
                "idle_gaps": [[n[:160], s] for n, s in self.idle_gaps[:TOP]]}
