"""The ``open_loop`` kind: its seeded arrival stream, and a tiny cell of it
through the harness on the CPU, added by new files alone."""

import numpy as np
import pytest
import torch

from portbench.run import run_cell
from portbench.tests import tiny
from portbench.traffic.open_loop import arrival_times

MIX = dict(tiny.MIXES["t-serve"], kind="open_loop", clients=0, rate=40.0,
           burst={"every": 1.0, "for": 0.2, "factor": 2.0}, warm_s=0.2)


def test_arrivals_are_seeded_and_keep_the_mean_rate():
    mix = {"rate": 3.5, "burst": {"every": 10, "for": 2, "factor": 2}}
    a, b = arrival_times(mix, 5), arrival_times(mix, 5)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, arrival_times(mix, 6))
    assert np.all(np.diff(a) > 0)
    assert abs(len(a) / 3600.0 / 3.5 - 1.0) < 0.03
    # a burst (2 s of each 10) at twice the base rate holds a third of them
    assert abs(np.mean(np.mod(a, 10) < 2) - 1 / 3) < 0.02


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    cells = dict(tiny.CELLS)
    cells["tiny-open"] = ("tinys", "t-open", tiny.SERVE_LIMITS,
                          "gpt2xl-serve")
    tiny.MIXES["t-open"] = MIX
    try:
        return tiny.make_root(tmp_path_factory.mktemp("open") / "c", cells)
    finally:
        del tiny.MIXES["t-open"]


@pytest.mark.parametrize("trace", [False, True])
def test_the_open_loop_cell_runs_and_is_correct(root, trace):
    out = run_cell(root, "tiny-open", 2 ** 31 + 7, 0.5, trace,
                   torch.device("cpu"))
    assert out["correct"] is True, out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    # the clock stops while the segment is traced: the window's requests
    # are the ~40 a second of its own half second, not a backlog
    assert out["attempted"] < 60
    if trace:
        assert {"mfu.serve", "serve_tok_s.window"} <= set(out["metrics"])
    else:
        assert {"tpot_p95_ms", "setup_s"} <= set(out["metrics"])
