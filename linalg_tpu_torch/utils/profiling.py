"""Profiling hooks — the counterpart of ``linalg_tpu/utils/profiling.py``:
a ``torch.profiler`` trace, the program's spans, and the step timer the
trainer reports steps/s and tok/s with.

Spans (``span``) mark where the engine and the trainer spend a step. They
are on exactly while a ``torch.profiler`` session records, and then each
is a host event on the profiler's clock, the clock of its device events,
so a trace names the device's idle gaps by the span the host was in. A
span opened with a CUDA ``device`` also records a CUDA event pair around
its work: ``device_ms(name)`` reads the device time of each such span of
the newest profiler session. With no session recording a span costs one
attribute check. ``count(name, value)`` keeps a counter's device tensor
while a session records, and ``counts(name)`` reads them after it.
"""

from __future__ import annotations

import contextlib
import pathlib
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["trace", "span", "device_ms", "count", "counts", "StepTimer"]

# (name, start, end) of each device-timed span of the newest profiler
# session, in the order the spans closed
_records: List[Tuple[str, "torch.cuda.Event", "torch.cuda.Event"]] = []
# name -> the tensors ``count`` kept in the newest profiler session
_counts: Dict[str, List[torch.Tensor]] = {}
_NO_SPAN = contextlib.nullcontext()


def _on_profiler_start(start=_autograd_profiler._run_on_profiler_start):
    """torch calls this as a profiler session starts: a new session starts
    with no device records or counts."""
    _records.clear()
    _counts.clear()
    start()


_autograd_profiler._run_on_profiler_start = _on_profiler_start


def span(name: str, device: Optional[torch.device] = None,
         args: Optional[Dict] = None):
    """Context manager: a span named ``name`` around the block while a
    profiler records, else the shared no-op context. ``args`` (ints and
    strings) ride on the host event, in the trace of a session that
    records shapes. With a CUDA ``device`` the span also records a timing
    event on that device's current stream as it opens and as it closes,
    for ``device_ms``."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _recorded(name, device, args)


@contextlib.contextmanager
def _recorded(name: str, device: Optional[torch.device],
              args: Optional[Dict]):
    # torch.profiler.record_function's RecordFunction, taking keyword
    # values (record_function drops its args string) at an eighth the cost
    with torch._C._profiler._RecordFunctionFast(name, (), args or {}):
        if device is None or device.type != "cuda":
            yield
            return
        stream = torch.cuda.current_stream(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        yield
        end.record(stream)
        _records.append((name, start, end))


def count(name: str, value: Callable[[], torch.Tensor]) -> None:
    """While a profiler session records, keep the tensor ``value()`` (on
    its device: nothing is copied to the host here) under ``name``; with
    none recording, ``value`` is not called."""
    if _autograd_profiler._is_profiler_enabled:
        _counts.setdefault(name, []).append(value().detach())


def counts(name: str) -> List[list]:
    """The values ``count`` kept under ``name`` in the newest profiler
    session, in order, as lists (one copy to the host each)."""
    return [v.tolist() for v in _counts.get(name, [])]


def device_ms(name: str) -> List[float]:
    """Device milliseconds of each span ``name`` opened with a CUDA device
    in the newest profiler session, in order; the caller has synchronised
    the device."""
    return [s.elapsed_time(e) for n, s, e in _records if n == name]


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """Context manager: record a ``torch.profiler`` trace of the block (CPU,
    and CUDA where a card is present) into ``logdir/trace.json``, a Chrome
    trace. No-op when ``logdir`` is empty, so callers can wrap hot loops
    unconditionally. Yields the profiler (or None)."""
    if not logdir:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = pathlib.Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


class StepTimer:
    """Running steps/s and tok/s over a sliding window of host timestamps.

    ``tick(n_steps)`` records that n_steps completed since the last tick, so
    the trainer can tick once per sync point (every 20 steps) instead of
    per step — per-step host timing would only measure async dispatch.
    """

    def __init__(self, tokens_per_step: int, window: int = 100):
        self.tokens_per_step = tokens_per_step
        self.window = window
        self._stamps = [(time.perf_counter(), 0)]
        self._total = 0

    def tick(self, n_steps: int = 1) -> None:
        self._total += n_steps
        self._stamps.append((time.perf_counter(), self._total))
        if len(self._stamps) > self.window + 1:
            self._stamps.pop(0)

    @property
    def steps_per_sec(self) -> float:
        if len(self._stamps) < 2:
            return 0.0
        dt = self._stamps[-1][0] - self._stamps[0][0]
        ds = self._stamps[-1][1] - self._stamps[0][1]
        return ds / max(dt, 1e-9)

    @property
    def tokens_per_sec(self) -> float:
        return self.steps_per_sec * self.tokens_per_step
