"""The reader of ``head_ms.train`` on the CPU: the chunked CE's
``ce.forward`` and ``ce.backward`` spans summed over the traced steps, on
fake device records of the program's tracer.

    python -m pytest portbench/tests/test_portbench_head.py -q
"""

import pytest

from linalg_tpu_torch.utils import profiling
from portbench import manifest
from portbench.tests import tiny


def read(ctx):
    return manifest.reader(tiny.REPO, "head_ms.train")(ctx)


class _FakeEvent:
    def __init__(self, t):
        self.t = t

    def elapsed_time(self, end):
        return end.t - self.t


def _records(monkeypatch, ms):
    recs = [(name, _FakeEvent(0.0), _FakeEvent(t))
            for name, times in ms.items() for t in times]
    monkeypatch.setattr(profiling, "_records", recs)


def test_head_reads_nothing_without_the_ce_spans(monkeypatch):
    """A program without the spans (the parent) reads None."""
    _records(monkeypatch, {"train.forward": [100.0, 100.0]})
    assert read({"segment": {"steps": 2}}) is None
    _records(monkeypatch, {})
    assert read({"segment": {"steps": 2}}) is None


def test_head_reads_both_ce_spans_a_step(monkeypatch):
    _records(monkeypatch, {"ce.forward": [3.0, 5.0],
                           "ce.backward": [9.0, 11.0],
                           "train.backward": [300.0, 300.0]})
    assert read({"segment": {"steps": 2}}) == pytest.approx(14.0)
    # a forward recorded without its backward still reads
    _records(monkeypatch, {"ce.forward": [6.0]})
    assert read({"segment": {"steps": 3}}) == pytest.approx(2.0)
