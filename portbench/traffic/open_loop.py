"""Open-loop serving traffic through the program's continuous-batching
engine: the ``closed_loop`` kind's engine, lengths, ids, window and check
(``portbench.traffic.closed_loop``), with requests that arrive on their
own clock instead of when a client's last one completes.

The mix file gives, beside the closed kind's ``engine``, ``prompt``,
``output`` and ``grid`` (``clients`` is 0: no first wave), ``rate`` (the
mean arrivals a second), ``burst`` (``every`` seconds, the rate times
``factor`` for the first ``for`` of them; the rest of the time at the
base rate, so that the mean is ``rate``) and ``warm_s``. Arrivals are a
Poisson process of that rate, drawn from the seed by thinning, on a clock
that starts after the engine is warmed; set-up runs the stream for
``warm_s`` seconds, so that the window opens on a running system, and the
window goes on with it. The clock stops between set-up and the window, so
that no arrival comes while the harness profiles the traced segment (whose
engine steps serve the load set-up left) or reads its trace. A request's
latencies count from its arrival, however late the host submits it.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np

from portbench.traffic import closed_loop

ARRIVALS_S = 3600.0  # the longest stream a run draws


def arrival_times(mix: Dict, seed: int, horizon: float = ARRIVALS_S
                  ) -> np.ndarray:
    """Seconds from the clock's start of each arrival: a Poisson process
    at the base rate, ``factor`` times it in each burst (thinning of a
    stream at the burst's rate, exact for a piecewise-constant rate)."""
    b = mix["burst"]
    every, dur, fac = float(b["every"]), float(b["for"]), float(b["factor"])
    base = float(mix["rate"]) / (1.0 + (fac - 1.0) * dur / every)
    top = base * max(fac, 1.0)
    rng = np.random.default_rng([int(seed), 31])
    n = int(top * horizon * 1.2) + 100
    t = np.cumsum(rng.exponential(1.0 / top, n))
    t = t[t < horizon]
    rate = np.where(np.mod(t, every) < dur, base * fac, base)
    return t[rng.random(t.shape[0]) < rate / top]


class Run(closed_loop.Run):
    def __init__(self, cell: Dict, seed: int, device):
        super().__init__(cell, seed, device)
        self.arrivals = arrival_times(self.mix, self.seed)
        self.t_start = None  # the arrival clock, started after the warm-up
        self.stopped = None  # when the clock stopped, while it is stopped
        self.k = 0

    def setup(self) -> None:
        super().setup()  # weights, engine, the warm request; no wave
        self.sending = False  # a completion sends nothing: arrivals do
        self.t_start = time.perf_counter()
        while time.perf_counter() - self.t_start < self.mix["warm_s"]:
            self._step()
        self._sync()
        self.stopped = time.perf_counter()

    def measure(self, seconds: float) -> Dict:
        self.t_start += time.perf_counter() - self.stopped
        self.stopped = None
        return super().measure(seconds)

    def _arrive(self) -> None:
        """Submit every request whose arrival has come, stamped with its
        arrival time; with nothing to run, wait for the next arrival."""
        if self.t_start is None or self.stopped is not None:
            return
        now = time.perf_counter()
        if not self.live and not self.eng.pending:
            gap = self.t_start + self.arrivals[self.k] - now
            if gap > 0:
                time.sleep(gap)
                now = time.perf_counter()
        while self.t_start + self.arrivals[self.k] <= now:
            self._send(self.t_start + self.arrivals[self.k])
            self.k += 1

    def _step(self, span: bool = False) -> Dict:
        self._arrive()
        return super()._step(span)
