"""The program's spans of the hybrid-attention MoE for its readers: the
attribution of ``spans.py`` with the regions this family adds
(``attn.window``, ``attn.full``, ``moe.permute``, ``moe.unpermute``) among
its regions.

``spans.Attribution`` reads its region names from its module's global
``REGIONS`` when it is built and takes no others: :func:`of` rebinds that
global to the widened names while it builds an attribution of its own,
restores it, and keeps that attribution on the reading apart from the one
the other readers share, so their readings do not change.  A ``regions``
parameter on ``spans.Attribution`` would retire the swap.  Every reading
returns None where the trace holds no span of the names asked for or no
device work under them.
"""

from __future__ import annotations

from typing import Optional, Sequence

from portbench import spans

REGIONS = ("attn.window", "attn.full", "moe.permute", "moe.unpermute")


def of(t) -> Optional[spans.Attribution]:
    reading = t.get("reading") if isinstance(t, dict) else None
    if reading is None:
        return None
    got = reading.__dict__.get("_hybrid_spans")
    if got is None:
        shared = spans.REGIONS
        spans.REGIONS = shared + REGIONS
        try:
            got = spans.Attribution(reading._events)
        finally:
            spans.REGIONS = shared
        reading.__dict__["_hybrid_spans"] = got
    return got


def region_ms(t, *names: str) -> Optional[float]:
    """Device ms a profiled step put down to the regions ``names``."""
    a = of(t)
    if a is None or not a.has(*names):
        return None
    ms = a.innermost_ms(names) / t["profiled_steps"]
    return ms if ms > 0 else None


def kernels_s(t, region: str, fragments: Sequence[str]) -> Optional[float]:
    """Device seconds a profiled step of the kernels inside ``region``
    whose names hold any of ``fragments`` (case folded)."""
    a = of(t)
    if a is None or not a.has(region):
        return None
    frags = [f.lower() for f in fragments]
    ms = spans.union_ms((w.start, w.end) for w in a.work
                        if any(r.name == region for r in w.regions)
                        and any(f in w.name.lower() for f in frags))
    return ms / 1e3 / t["profiled_steps"] if ms > 0 else None
