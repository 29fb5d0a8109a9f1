"""The harness on the CPU at tiny sizes: the manifest and the lookup by
name, a cell and a metric added as new files alone, the traffic draws,
the metric readers on a canned trace, the result line, the plain
reference against ``linalg_tpu_torch``, and ``correct`` coming out false
with the timed path broken underneath.

    python -m pytest portbench/tests -q

The ``cuda`` test runs the tiny cells on a card and skips without one.
"""

import json
import math
import re

import numpy as np
import pytest
import torch

from portbench import control, manifest, trace
from portbench.run import run_cell
from portbench.tests import tiny

REPO = tiny.REPO
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CPU = torch.device("cpu")
SEED = 2**31 + 12345


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("checkout"))


def run(root, name, trace_on=False, seed=SEED):
    return run_cell(root, name, seed, 2.0, trace_on, CPU)


# -- the manifest ---------------------------------------------------------


def test_manifest_is_well_formed():
    b = manifest.load(REPO)
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and len(b["command"]) <= 32
    assert 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    assert ((2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 2 * 90
            + 1200) <= 43200
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        for k in c["reduced"]:
            assert k in cfg and not k.endswith(("_dim", "_rank", "_size"))
        names.add(c["name"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"]: w for w in b["workloads"]}
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == len(
        cells)
    for name, w in cells.items():
        assert NAME.match(name) and w["chips"] == 1 and len(w["why"]) <= 200
        assert w["config"] in names
        c = manifest.cell(REPO, b, name)
        assert (REPO / "portbench" / "traffic" /
                f"{c['mix']['kind']}.py").exists()
        reported = [m["name"] for m in manifest.metrics_of(
            b, name, "end_to_end")]
        assert "setup_s" in reported and len(reported) >= 2
        assert manifest.metrics_of(b, name, "per_layer")
    for m in b["per_layer"]:
        assert (REPO / "portbench" / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert m["moves"] in [x["name"] for x in manifest.metrics_of(
                b, w, "end_to_end")]


def test_a_cell_and_a_metric_are_added_by_new_files_alone(root, tmp_path):
    """A fresh copy gains a per-layer metric as one new reader file and one
    entry; the tiny cells themselves came as new files and entries."""
    dest = tiny.make_root(tmp_path / "more", {
        "tiny-train": tiny.CELLS["tiny-train"]})
    (dest / "portbench" / "metrics" / "steps_traced.train.py").write_text(
        "def read(ctx):\n    return float(ctx['segment']['steps'])\n")
    b = json.loads((dest / "BENCHMARK.json").read_text())
    b["per_layer"].append({"name": "steps_traced.train", "unit": "steps",
                           "better": "higher", "source": "program_counter",
                           "layer": "model step", "moves": "train_tok_s",
                           "workloads": ["tiny-train"]})
    (dest / "BENCHMARK.json").write_text(json.dumps(b))
    out = run(dest, "tiny-train", trace_on=True)
    assert out["metrics"]["steps_traced.train"]["value"] == 3.0
    with pytest.raises(KeyError):
        manifest.cell(dest, b, "no-such-cell")


# -- traffic ----------------------------------------------------------------


def test_length_grid_and_the_seeded_stream(root):
    from portbench.traffic import closed_loop as cl

    mix = tiny.MIXES["t-serve"]
    g = cl.length_grid({"dist": "lognormal", "median": 384, "sigma": 0.5,
                        "min": 128, "max": 768}, 1024)
    assert g.min() >= 128 and g.max() <= 768
    assert abs(np.median(g) - 384) <= 2
    u = cl.length_grid({"dist": "uniform", "min": 128, "max": 256}, 1290)
    assert set(u.tolist()) == set(range(128, 257))
    a, b = cl.Traffic(mix, 300, 7), cl.Traffic(mix, 300, 7)
    c = cl.Traffic(mix, 300, 8)
    assert [a.next() for _ in range(5)] == [b.next() for _ in range(5)]
    # another seed: the same lengths in another order
    assert sorted(a.plens) == sorted(c.plens)
    assert list(a.plens) != list(c.plens)


def test_training_rows_are_the_steps_own():
    from linalg_tpu_torch.train.trainer import _windows

    from portbench.traffic import train

    data = torch.randint(0, 50, (500,))
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(5)
    g2.manual_seed(5)
    for _ in range(3):
        x1, y1 = _windows(data, 4, 16, g1)
        x2, y2 = train.windows(data, 4, 16, g2)
        assert torch.equal(x1, x2) and torch.equal(y1, y2)


# -- metric readers on a canned trace ------------------------------------


def _canned():
    """A segment of 1,000 µs: two host ops, a GEMM, a flash kernel, an
    element-wise and a paged kernel, a copy, and a kernel past the end."""
    seg = trace.Segment()
    seg.set_events([
        (trace.SEGMENT, "cpu", 0.0, 1000.0),
        ("aten::mm", "cpu", 0.0, 120.0),
        ("aten::add", "cpu", 380.0, 200.0),
        ("nvjet_tst_128x256_h_bz", "kernel", 100.0, 200.0),
        ("void (anonymous namespace)::fwd_bf16<64, 1>(x)", "kernel",
         300.0, 100.0),
        ("void at::native::vectorized_elementwise_kernel<4>", "kernel",
         500.0, 50.0),
        ("void (anonymous namespace)::paged_partials<128>(x)", "kernel",
         700.0, 40.0),
        ("Memcpy DtoH", "memcpy", 600.0, 20.0),
        ("outside", "kernel", 2000.0, 5.0),
    ])
    return seg


def test_readers_on_a_canned_trace(root):
    seg = _canned()
    assert seg.span == (0.0, 1000.0)
    assert trace.busy_us(seg.events, seg.span) == 410.0
    ctx = {"events": seg.events, "span": seg.span,
           "segment": {"steps": 2, "token_steps": 4,
                       "attn_least_s": 50e-6, "paged_least_s": 20e-6},
           "window": {"steps": 2, "model_flops": 989e12, "seconds": 2.0,
                      "least_s": 0.5}}

    def read(name):
        return manifest.reader(root, name)(ctx)

    assert read("idle_pct.train") == pytest.approx(59.0)
    assert read("idle_pct.serve") == pytest.approx(59.0)
    # neither GEMM nor flash: the element-wise and paged kernels, per step
    assert read("elementwise_ms.train") == pytest.approx(0.045)
    assert read("flash_roofline_pct.train") == pytest.approx(100.0)
    assert read("paged_roofline_pct.serve") == pytest.approx(50.0)
    assert read("launches_per_token.serve") == pytest.approx(1.0)
    assert read("mfu.train") == pytest.approx(50.0)
    assert read("mfu.serve") == pytest.approx(25.0)
    # the serving window's rate and first-token tail, read from its counts
    assert read("serve_tok_s.window") is None
    served = dict(ctx, window=dict(ctx["window"], metrics={
        "serve_tok_s": 1200.0, "ttft_p95_ms": 2300.0}))
    assert manifest.reader(root, "serve_tok_s.window")(served) == 1200.0
    assert manifest.reader(root, "ttft_p95_ms.window")(served) == 2300.0
    bd = trace.breakdown(seg.events, seg.span)
    assert bd["device_ops"][0] == ["nvjet_tst_128x256_h_bz", 200e-6]
    gaps = dict(bd["idle_gaps"])
    assert gaps["aten::mm"] == pytest.approx(100e-6)
    assert gaps["aten::add"] == pytest.approx(150e-6)
    assert gaps["(no host op)"] == pytest.approx(340e-6)
    assert sum(gaps.values()) == pytest.approx(590e-6)
    # a trace with no device activity: the device readers read nothing
    empty = dict(ctx, events=[e for e in seg.events if e[1] == "cpu"])
    for name in ("idle_pct.train", "elementwise_ms.train",
                 "flash_roofline_pct.train", "paged_roofline_pct.serve",
                 "launches_per_token.serve"):
        assert manifest.reader(root, name)(empty) is None


# -- one run: the result line, and the reference against the port ----------


@pytest.mark.parametrize("name", sorted(tiny.CELLS))
def test_the_port_agrees_with_the_reference(root, name):
    out = run(root, name)
    assert out["correct"] is True, out["compared"]
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    b = manifest.load(root)
    want = {m["name"] for m in manifest.metrics_of(b, name, "end_to_end")}
    assert set(out["metrics"]) == want
    assert all(math.isfinite(m["value"]) for m in out["metrics"].values())
    assert set(out["compared"]) == set(tiny.CELLS[name][2])


@pytest.mark.parametrize("name", ["tiny-train", "tiny-serve"])
def test_the_traced_line(root, name):
    out = run(root, name, trace_on=True)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "compared"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(out["device"])
    # on the CPU only the metrics read from the host's clock have values
    host = {"tiny-train": {"mfu.train"},
            "tiny-serve": {"mfu.serve", "serve_tok_s.window",
                           "ttft_p95_ms.window"}}
    assert set(out["metrics"]) == host[name]
    assert out["correct"] is True


# -- correct comes out false with the timed path broken underneath ---------


def _unchanged(mp):
    import linalg_tpu_torch.train.trainer as tr

    mp.setattr(tr, "adamw_update", lambda p, g, s, *a, **k: (p, s))


def _half_batch(mp):
    import linalg_tpu_torch.train.trainer as tr

    orig = tr._windows

    def half(data, batch, T, gen):
        x, y = orig(data, batch, T, gen)
        return x[:batch // 2], y[:batch // 2]

    mp.setattr(tr, "_windows", half)


def _token_altered(mp):
    import linalg_tpu_torch.serve.paged as paged

    orig = paged.decode_chunk_paged

    def altered(*a, **k):
        toks, logits, cache = orig(*a, **k)
        toks = toks.clone()
        toks[:, 0] = 0  # each slot's first token of every chunk
        return toks, logits, cache

    mp.setattr(paged, "decode_chunk_paged", altered)


@pytest.mark.parametrize("name,fault", [
    ("tiny-train", _unchanged), ("tinyw-train", _half_batch),
    ("tiny-serve", _token_altered)])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, name, fault):
    fault(monkeypatch)
    out = run(root, name)
    assert out["correct"] is False, out["compared"]


@pytest.mark.parametrize("name", ["tiny-train", "tinyw-train", "tiny-serve"])
def test_the_control_is_not_correct(root, name):
    """The reference in float8, put in the program's place, fails a limit
    that the program passes (the readings a limit is set from); in
    serving its first-choice tokens are scored as the check scores the
    served ones."""
    cell = manifest.cell(root, manifest.load(root), name)
    kind = manifest.kind_module(root, cell["mix"]["kind"])
    run = kind.Run(cell, SEED, CPU)
    limits = cell["spec"]["limits"]
    if cell["mix"]["kind"] == "closed_loop":
        got = control.serve_readings(run, True, 2.0)
        for side, ok in (("program", True), ("control", False)):
            compared = got[side]["compared"]
            assert set(compared) == set(limits)
            assert all(c["value"] <= c["limit"]
                       for c in compared.values()) is ok, compared
        return
    got = control.train_readings(kind, run, True)
    assert all(got["program"][k] <= v for k, v in limits.items())
    assert any(got["control"][k] > v for k, v in limits.items())
    assert any(got["half"][k] > v for k, v in limits.items())


@pytest.mark.cuda
def test_tiny_cells_on_the_card(root):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name in sorted(tiny.CELLS):
        out = run_cell(root, name, SEED, 0.5, True, torch.device("cuda", 0))
        assert out["device"]["platform"] == "gpu"
        assert out["device"]["busy_s"] > 0
