"""Spans and counters inside the port, recorded while a torch profiler is
recording and free otherwise.

The switch is the profiler itself (``torch.profiler.profile``, which
``workload --profile`` and the benchmark's traced run turn on): there is
no flag of this module's own.

* :func:`span` opens a named range in the profiler's trace.  It is a
  ``RecordFunction`` of the plain function scope, on the same clock as the
  CUDA kernels the profiler records (each kernel's launch call sits inside
  the span that was open), and unlike ``torch.profiler.record_function``'s
  user scope it adds no ``gpu_user_annotation`` range to the device's rows
  of the trace, so the device's events stay the kernels and copies alone.
  With no profiler recording it returns one shared null context: one flag
  check.
* :func:`count` adds a device tensor into a per-name device total while a
  profiler records and the caller is not inside a backward pass (a remat
  recompute runs the forward again there), else does nothing: no kernel,
  no sync, no allocation.  :func:`counters` reads the totals with one
  sync; :func:`reset_counters` clears them.

The names in use, and the benchmark metric that reads each, are listed in
PERF.md.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Union

import torch
from torch.autograd import profiler as _profiler

_NULL = contextlib.nullcontext()
_TOTALS: Dict[str, torch.Tensor] = {}


def span(name: str):
    """A context manager: the profiler range ``name`` while a profiler is
    recording, else one shared null context."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return torch._C._profiler._RecordFunctionFast(name)


def count(name: str,
          value: Union[torch.Tensor, Callable[[], torch.Tensor]]) -> None:
    """Add ``value`` (an integer tensor, or a function returning one, called
    only when the count is taken) to the total ``name``, while a profiler
    records and outside a backward pass."""
    if not _profiler._is_profiler_enabled \
            or torch._C._current_graph_task_id() != -1:
        return
    v = (value() if callable(value) else value).detach().to(torch.int64)
    total = _TOTALS.get(name)
    _TOTALS[name] = v if total is None else total + v.to(total.device)


def counters() -> Dict[str, int]:
    """The totals since the last :func:`reset_counters`, by name."""
    if not _TOTALS:
        return {}
    names = list(_TOTALS)
    first = _TOTALS[names[0]].device
    values = torch.stack([_TOTALS[n].to(first) for n in names]).tolist()
    return dict(zip(names, values))


def reset_counters() -> None:
    _TOTALS.clear()
