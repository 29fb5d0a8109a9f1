"""The traced segment: a ``torch.profiler`` session around a few steps of
a cell, reduced to plain event tuples that the metric readers take.

An event is ``(name, cat, start_us, dur_us)`` with ``cat`` one of
``kernel``, ``memcpy``, ``memset`` (device activity) or ``cpu`` (host ops
and the harness's annotations), all on the profiler's one clock. The
segment's span is the ``portbench.segment`` annotation around it, which
ends after a device synchronise, so every device operation the segment
issued lies inside it.
"""

from __future__ import annotations

import contextlib
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

SEGMENT = "portbench.segment"

Event = Tuple[str, str, float, float]

GEMM = re.compile(r"gemm|nvjet|xmma|cutlass|splitKreduce|cublas", re.I)
FLASH = re.compile(r"\b(fwd|dq|dkdv)_(bf16|f32)\b|\bdelta_rows\b")
PAGED = re.compile(r"\bpaged_(partials|combine)\b")

DEVICE_CATS = ("kernel", "memcpy", "memset")


def _device_cat(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def events_from_profiler(prof) -> List[Event]:
    """Events of a finished ``torch.profiler.profile``. A host annotation
    also appears as a device event of the same name spanning the work it
    enclosed; those mirrors are not device operations and are dropped."""
    from torch.autograd import DeviceType

    cpu: List[Event] = []
    dev: List[Event] = []
    for e in prof.events():
        tr = e.time_range
        on_host = getattr(e, "device_type", DeviceType.CPU) == DeviceType.CPU
        ev = (e.name, "cpu" if on_host else _device_cat(e.name),
              float(tr.start), float(tr.end - tr.start))
        (cpu if on_host else dev).append(ev)
    host_names = {e[0] for e in cpu}
    return cpu + [e for e in dev if e[0] not in host_names]


class Segment:
    """``with seg.record(sync):`` profiles the body; afterwards
    ``seg.events`` holds its events and ``seg.span`` its (start, end)."""

    def __init__(self):
        self.events: List[Event] = []
        self.span: Optional[Tuple[float, float]] = None

    @contextlib.contextmanager
    def record(self, sync):
        from torch.profiler import ProfilerActivity, profile, record_function

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(SEGMENT):
                yield
                sync()
        self.set_events(events_from_profiler(prof))

    def set_events(self, events: Sequence[Event]) -> None:
        self.events = list(events)
        spans = [(s, s + d) for n, c, s, d in self.events
                 if c == "cpu" and n == SEGMENT]
        self.span = spans[0] if spans else None


def device_events(events: Iterable[Event], span, cats=DEVICE_CATS
                  ) -> List[Event]:
    """Device events of ``cats`` that start inside ``span``."""
    lo, hi = span
    return [e for e in events if e[1] in cats and lo <= e[2] <= hi]


def busy_intervals(events: Iterable[Event], span) -> List[Tuple[float,
                                                                float]]:
    """The union of device activity inside ``span``, as sorted disjoint
    (start, end) intervals, clipped to the span."""
    lo, hi = span
    ivs = sorted((max(lo, s), min(hi, s + d))
                 for _, c, s, d in events if c in DEVICE_CATS
                 and s + d > lo and s < hi)
    merged: List[List[float]] = []
    for s, e in ivs:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_us(events: Iterable[Event], span) -> float:
    return sum(e - s for s, e in busy_intervals(events, span))


def kernel_us(events: Iterable[Event], span, pattern=None,
              exclude: Sequence = ()) -> float:
    """Summed device time of the kernels inside ``span`` whose name
    matches ``pattern`` (all when None) and none of ``exclude``."""
    total = 0.0
    for n, c, s, d in device_events(events, span, ("kernel",)):
        if pattern is not None and not pattern.search(n):
            continue
        if any(x.search(n) for x in exclude):
            continue
        total += d
    return total


def _hosts_at(cpu, times) -> List[str]:
    """For each of the rising ``times``, the innermost host op running
    then: of the ops begun by then and not yet ended, the one begun last
    (a sweep over ``cpu``, sorted (start, end, name))."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(cpu) and cpu[i][0] <= t:
            while stack and stack[-1][1] <= cpu[i][0]:
                stack.pop()
            stack.append(cpu[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else "(no host op)")
    return out


def breakdown(events: Sequence[Event], span, top: int = 10) -> Dict:
    """The device operations that took most time, and the longest idle
    gaps grouped by the innermost host operation running when each gap
    began; seconds, at most ``top`` of each."""
    by_op: Dict[str, float] = {}
    for n, _, _, d in device_events(events, span):
        by_op[n] = by_op.get(n, 0.0) + d
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    cpu = sorted((s, s + d, n) for n, c, s, d in events
                 if c == "cpu" and n != SEGMENT)
    gaps: List[Tuple[float, float]] = []
    prev = span[0]
    for s, e in busy_intervals(events, span) + [(span[1], span[1])]:
        if s > prev:
            gaps.append((prev, s - prev))
        prev = max(prev, e)
    by_host: Dict[str, float] = {}
    for host, (_, d) in zip(_hosts_at(cpu, [g[0] for g in gaps]), gaps):
        by_host[host] = by_host.get(host, 0.0) + d
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], d / 1e6] for n, d in ops],
            "idle_gaps": [[n[:160], d / 1e6] for n, d in idle]}


def idle_pct(events: Sequence[Event], span) -> Optional[float]:
    """Per cent of ``span`` with no device operation running; None when
    the trace holds no device activity."""
    if span is None or not device_events(events, span):
        return None
    return 100.0 * (1.0 - busy_us(events, span) / (span[1] - span[0]))
