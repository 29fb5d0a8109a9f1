"""The readers of the program's spans (``portbench/spans.py``) on the CPU:
the serving idle shares on a canned trace of ``serve.*`` host spans with
kernels between them, and the training phases on fake device records of
the program's tracer.

    python -m pytest portbench/tests/test_portbench_spans.py -q
"""

import pytest
from torch.profiler import ProfilerActivity, profile

from linalg_tpu_torch.utils import profiling
from portbench import manifest, trace
from portbench.tests import tiny

SERVE = ("idle_admit_pct.serve", "idle_decode_pct.serve")
TRAIN = ("forward_ms.train", "backward_ms.train", "optimizer_ms.train")


def read(name, ctx):
    return manifest.reader(tiny.REPO, name)(ctx)


def _canned_serve():
    """An engine step of 1,000 µs: two admissions back to back (50-400),
    a decode dispatch (450-700) and the fetch (700-880), with kernels
    under each and a copy after the last."""
    seg = trace.Segment()
    seg.set_events([
        (trace.SEGMENT, "cpu", 0.0, 1000.0),
        ("serve.step", "cpu", 0.0, 900.0),
        ("serve.admit", "cpu", 50.0, 200.0),
        ("serve.admit", "cpu", 250.0, 150.0),
        ("serve.prefill", "cpu", 60.0, 150.0),
        ("serve.decode", "cpu", 450.0, 250.0),
        ("serve.fetch", "cpu", 700.0, 180.0),
        ("nvjet_tst_64x32_64x16_2x4_h_bz_NNT", "kernel", 100.0, 50.0),
        ("nvjet_tst_64x64_64x13_2x4_h_bz_NNT", "kernel", 300.0, 100.0),
        ("void at::native::vectorized_elementwise_kernel<4>", "kernel",
         500.0, 20.0),
        ("void (anonymous namespace)::paged_partials<64>(x)", "kernel",
         600.0, 50.0),
        ("void (anonymous namespace)::paged_partials<64>(x)", "kernel",
         700.0, 150.0),
        ("Memcpy DtoH", "memcpy", 850.0, 10.0),
    ])
    return {"events": seg.events, "span": seg.span,
            "segment": {"steps": 1, "token_steps": 16}}


def test_serve_idle_under_the_engine_spans():
    ctx = _canned_serve()
    # busy 50 + 100 + 20 + 50 + 160 of 1,000 µs: idle 62%
    assert read("idle_pct.serve", ctx) == pytest.approx(62.0)
    # admissions 50-400 less 150 µs of kernels; decode 450-700 less 70
    admit = read("idle_admit_pct.serve", ctx)
    decode = read("idle_decode_pct.serve", ctx)
    assert admit == pytest.approx(20.0)
    assert decode == pytest.approx(18.0)
    assert admit + decode <= read("idle_pct.serve", ctx)


def test_serve_readers_read_nothing_without_device_or_span():
    ctx = _canned_serve()
    host_only = dict(ctx, events=[e for e in ctx["events"] if e[1] == "cpu"])
    # a program without the engine's spans: the parent's trace
    unnamed = dict(ctx, events=[e for e in ctx["events"]
                                if not e[0].startswith("serve.")])
    for name in SERVE:
        assert read(name, host_only) is None
        assert read(name, unnamed) is None
        assert read(name, dict(ctx, span=None)) is None


class _FakeEvent:
    def __init__(self, t):
        self.t = t

    def elapsed_time(self, end):
        return end.t - self.t


def _records(monkeypatch, ms):
    recs = []
    for name, times in ms.items():
        for t in times:
            recs.append((name, _FakeEvent(0.0), _FakeEvent(t)))
    monkeypatch.setattr(profiling, "_records", recs)
    return recs


def test_train_readers_read_the_step_mean(monkeypatch):
    _records(monkeypatch, {"train.forward": [10.0, 14.0],
                           "train.backward": [30.0, 34.0],
                           "train.optimizer": [4.0, 5.0],
                           "train.step": [99.0]})
    ctx = {"segment": {"steps": 2}}
    assert read("forward_ms.train", ctx) == pytest.approx(12.0)
    assert read("backward_ms.train", ctx) == pytest.approx(32.0)
    assert read("optimizer_ms.train", ctx) == pytest.approx(4.5)
    # two microbatches a step: both forwards count toward the step
    ctx = {"segment": {"steps": 1}}
    assert read("forward_ms.train", ctx) == pytest.approx(24.0)


def test_train_readers_read_nothing_without_records(monkeypatch):
    _records(monkeypatch, {})
    for name in TRAIN:
        assert read(name, {"segment": {"steps": 3}}) is None


def test_train_readers_never_read_an_earlier_session(monkeypatch):
    recs = _records(monkeypatch, {"train.forward": [10.0],
                                  "train.backward": [20.0],
                                  "train.optimizer": [3.0]})
    assert read("forward_ms.train", {"segment": {"steps": 1}}) == 10.0
    with profile(activities=[ProfilerActivity.CPU]):
        pass
    assert recs == []
    for name in TRAIN:
        assert read(name, {"segment": {"steps": 1}}) is None
