"""Device time put down to the program's own spans, and the program's
counters, for the readers of the traced run.

The port opens named ranges while a profiler records
(``tpu_network_operator_torch/tracing.py``): the train phases
(``train.forward``, ``train.backward``, ``train.optimizer``) and the regions
inside them (``moe.*``, ``generate.*``).  In the profiler's events:

* a device event (kernel or copy) goes to the regions open on the thread of
  its launch call (the runtime call with the same correlation id) when that
  call was made, innermost last;
* a launch under no region whose innermost op with a sequence number is an
  autograd backward node goes to the regions of the node's forward op,
  matched by (forward thread, sequence number), so a region's time holds
  its forward, its recompute and its backward (a remat recompute that a
  backward node sets off runs forward ops, which carry sequence numbers of
  their own: outside any region its work stays outside);
* a train phase takes every launch made in its host interval on any
  thread: the autograd engine's device thread launches the backward while
  the caller waits inside ``train.backward``;
* a region's device time is the union of its events' intervals.

The readings below return None where the trace holds no span of the names
asked for (a program without the spans) or no device work under them,
never 0.
"""

from __future__ import annotations

import bisect
import statistics
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from torch.autograd import DeviceType

PHASES = ("train.forward", "train.backward", "train.optimizer")
REGIONS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine",
           "generate.prefill", "generate.decode_step", "generate.attention")
# names of the host-side runtime and driver calls that launch device work
LAUNCH_PREFIX = "cu"


class Span:
    """One program span on the host (times in microseconds)."""

    __slots__ = ("name", "thread", "start", "end")

    def __init__(self, name: str, thread: int, start: float, end: float):
        self.name, self.thread, self.start, self.end = name, thread, start, end


class Work:
    """One device event, with the regions (outer to inner) and the train
    phase it was put down to."""

    __slots__ = ("name", "start", "end", "regions", "phase")

    def __init__(self, name, start, end, regions, phase):
        self.name, self.start, self.end = name, start, end
        self.regions: Tuple[Span, ...] = regions
        self.phase: Optional[str] = phase


def union_ms(intervals: Iterable[Tuple[float, float]]) -> float:
    """Milliseconds covered by the union of [start, end) in microseconds."""
    total, cur_a, cur_b = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_b is not None and a <= cur_b:
            cur_b = max(cur_b, b)
            continue
        if cur_b is not None:
            total += cur_b - cur_a
        cur_a, cur_b = a, b
    if cur_b is not None:
        total += cur_b - cur_a
    return total / 1e3


class Attribution:
    """The device events of one profiled stretch, each put down to the
    program's spans (see the module's docstring)."""

    def __init__(self, events: Sequence):
        host, device, launches = [], [], {}
        for e in events:
            if e.device_type != DeviceType.CPU:
                if not getattr(e, "is_user_annotation", False):
                    device.append(e)
            elif not e.is_async:
                host.append(e)
                if e.name.startswith(LAUNCH_PREFIX):
                    launches[e.id] = e
        self.spans: Dict[str, List[Span]] = {}
        at_launch: Dict[int, Tuple[Tuple[Span, ...], Optional[tuple]]] = {}
        forward: Dict[tuple, Tuple[Span, ...]] = {}
        by_thread: Dict[int, list] = {}
        for e in host:
            by_thread.setdefault(e.thread, []).append(e)
        for thread, evs in by_thread.items():
            evs.sort(key=lambda e: (e.time_range.start, -e.time_range.end))
            # open events: (end, pushed a region, pushed an owner)
            stack: List[Tuple[float, bool, bool]] = []
            regions: List[Span] = []
            # the open ops with a sequence number: a backward node's forward
            # key (forward thread, sequence number), None for a forward op
            owners: List[Optional[tuple]] = []
            for e in evs:
                start, end = e.time_range.start, e.time_range.end
                while stack and stack[-1][0] <= start:
                    _, r, o = stack.pop()
                    if r:
                        regions.pop()
                    if o:
                        owners.pop()
                name = e.name
                is_span = name in REGIONS or name in PHASES
                if is_span:
                    s = Span(name, thread, start, end)
                    self.spans.setdefault(name, []).append(s)
                seq = e.sequence_nr
                fwd = e.fwd_thread
                if launches.get(e.id) is e:
                    at_launch[e.id] = (tuple(regions),
                                       owners[-1] if owners else None)
                elif seq >= 0 and not fwd:
                    forward.setdefault((thread, seq), tuple(regions))
                is_region = name in REGIONS
                if is_region:
                    regions.append(s)
                if seq >= 0:
                    owners.append((fwd, seq) if fwd else None)
                stack.append((end, is_region, seq >= 0))
        phases = sorted((s.start, s.end, s.name) for n in PHASES
                        for s in self.spans.get(n, ()))
        starts = [p[0] for p in phases]
        self.work: List[Work] = []
        for d in device:
            launch = launches.get(d.id)
            regions, phase = (), None
            if launch is not None:
                t = launch.time_range.start
                regions, node = at_launch.get(d.id, ((), None))
                if not regions and node is not None:
                    regions = forward.get(node, ())
                i = bisect.bisect_right(starts, t) - 1
                if i >= 0 and phases[i][1] >= t:
                    phase = phases[i][2]
            self.work.append(Work(d.name, d.time_range.start,
                                  d.time_range.end, regions, phase))

    def has(self, *names: str) -> bool:
        return any(self.spans.get(n) for n in names)

    def phase_ms(self, name: str) -> float:
        return union_ms((w.start, w.end) for w in self.work
                        if w.phase == name)

    def innermost_ms(self, names: Sequence[str],
                     within: Optional[str] = None) -> float:
        """Device ms of the events whose innermost region is one of
        ``names`` (and, with ``within``, that lie inside a region of that
        name too)."""
        return union_ms(
            (w.start, w.end) for w in self.work
            if w.regions and w.regions[-1].name in names
            and (within is None
                 or any(r.name == within for r in w.regions)))

    def inside_ms(self, name: str) -> float:
        """Device ms of the events inside a region called ``name``."""
        return union_ms((w.start, w.end) for w in self.work
                        if any(r.name == name for r in w.regions))

    def by_instance(self, name: str) -> Dict[Span, List[Work]]:
        """The device events inside each span called ``name``."""
        out: Dict[Span, List[Work]] = {s: [] for s in self.spans.get(name, ())}
        for w in self.work:
            for r in w.regions:
                if r.name == name and r in out:
                    out[r].append(w)
        return out


def of(t) -> Optional[Attribution]:
    """The attribution of the traced run ``t``'s reading, made once and
    kept on the reading (its events are the profiler's ``FunctionEvent``s)."""
    reading = t.get("reading") if isinstance(t, dict) else None
    if reading is None:
        return None
    got = reading.__dict__.get("_program_spans")
    if got is None:
        got = reading.__dict__["_program_spans"] = Attribution(
            reading._events)
    return got


def _found(ms: float) -> Optional[float]:
    return ms if ms > 0 else None


def phase_ms(t, name: str) -> Optional[float]:
    """Device ms a profiled step launched inside the train phase ``name``."""
    a = of(t)
    if a is None or not a.has(name):
        return None
    return _found(a.phase_ms(name) / t["profiled_steps"])


def region_ms(t, *names: str) -> Optional[float]:
    """Device ms a profiled step put down to the regions ``names``."""
    a = of(t)
    if a is None or not a.has(*names):
        return None
    return _found(a.innermost_ms(names) / t["profiled_steps"])


def inside_ms(t, name: str) -> Optional[float]:
    """Device ms of the work inside the spans ``name`` (nested ones too)."""
    a = of(t)
    if a is None or not a.has(name):
        return None
    return _found(a.inside_ms(name))


def per_instance_ms(t, name: str) -> List[float]:
    """Device-busy ms of each span ``name`` that launched work."""
    a = of(t)
    if a is None:
        return []
    return [union_ms((w.start, w.end) for w in work)
            for work in a.by_instance(name).values() if work]


def counter(name: str) -> Optional[int]:
    """The program's counter ``name`` (``tracing.counters()``), None where
    the program has no such counter."""
    try:
        from tpu_network_operator_torch import tracing
    except ImportError:
        return None
    return tracing.counters().get(name)


def median_or_none(values: List[float]) -> Optional[float]:
    return statistics.median(values) if values else None
