"""Profiling hooks — the counterpart of ``linalg_tpu/utils/profiling.py``:
a ``torch.profiler`` trace and the step timer the trainer reports
steps/s and tok/s with.
"""

from __future__ import annotations

import contextlib
import pathlib
import time
from typing import Optional

import torch

__all__ = ["trace", "StepTimer"]


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
