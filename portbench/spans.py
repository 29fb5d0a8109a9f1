"""Readings of the program's own spans (``linalg_tpu_torch.utils.profiling``)
for the per-layer readers: the device's idle time under a host span of
the traced segment, and the device time the tracer recorded for a span.

A program without a span or without the tracer leaves nothing to read:
each function then returns None and raises nothing.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from portbench import trace


def _union(ivs: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e in sorted(ivs):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def idle_pct_under(events: Sequence[trace.Event], span, name: str
                   ) -> Optional[float]:
    """Per cent of ``span`` in which the device is idle while a host span
    ``name`` is open: the union of those host events, less the device's
    busy intervals, over the span's length. None with no device activity
    or no such host span in ``span``."""
    if span is None or not trace.device_events(events, span):
        return None
    lo, hi = span
    host = _union([(max(lo, s), min(hi, s + d)) for n, c, s, d in events
                   if c == "cpu" and n == name and s + d > lo and s < hi])
    if not host:
        return None
    busy = trace.busy_intervals(events, span)
    idle = 0.0
    for s, e in host:
        idle += (e - s) - sum(max(0.0, min(e, be) - max(s, bs))
                              for bs, be in busy)
    return 100.0 * idle / (hi - lo)


def device_ms_per_step(name: str, steps: int) -> Optional[float]:
    """The device ms the tracer recorded for span ``name`` in the newest
    profiler session (the traced segment's), over ``steps``. None where
    the program has no tracer or recorded no such span."""
    try:
        from linalg_tpu_torch.utils.profiling import device_ms
    except ImportError:
        return None
    ms = device_ms(name)
    if not ms or not steps:
        return None
    return sum(ms) / steps
