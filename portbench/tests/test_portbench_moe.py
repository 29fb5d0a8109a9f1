"""The ``train_moe`` kind through the harness on the CPU, at a tiny
Mellum-shaped size added by new files alone (``tiny.make_root``): every
published key the reference reads, a head width apart from d_model /
n_heads, 3:1 band/full layers with YaRN, top-4 of 16 experts of which the
cell holds the first 4. The K13 calls take their plain version here."""

import importlib.util
import json
import math
import pathlib

import pytest
import torch

from portbench import manifest
from portbench.run import run_cell
from portbench.tests import tiny

LAYERS = ["sliding_attention"] * 3 + ["full_attention"]
CONFIG = {
    "layer_types": LAYERS, "sliding_window": 16, "num_experts_per_tok": 4,
    "norm_topk_prob": True, "num_experts": 4,
    "rope_parameters": {
        "full_attention": {"rope_type": "yarn", "rope_theta": 500000,
                           "factor": 4, "original_max_position_embeddings":
                           16, "beta_fast": 32, "beta_slow": 1,
                           "attention_factor": 1.1386294361119891},
        "sliding_attention": {"rope_type": "default",
                              "rope_theta": 500000}},
    "port": {"d_model": 32, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
             "n_layers": 4, "d_ff": 24, "ctx_len": 64, "vocab_size": 300,
             "pos": "rope", "ffn": "swiglu", "window": 16, "full_every": 4,
             "rope_theta": 500000.0,
             "rope_scaling": {"factor": 4.0,
                              "original_max_position_embeddings": 16,
                              "beta_fast": 32.0, "beta_slow": 1.0,
                              "attention_factor": 1.1386294361119891},
             "n_experts": 16, "experts_held": 4,
             "router_top_k": 4, "dispatch": "grouped", "aux_weight": 0.01,
             "dtype": "bfloat16"},
    "init": {"std": 0.02},
}
MIX = {"kind": "train_moe", "batch": 2, "seq": 64, "grad_accum": 1,
       "corpus_tokens": 5000,
       "schedule": {"base_lr": 3e-4, "min_lr": 3e-5, "warmup": 200,
                    "max_steps": 4000, "weight_decay": 0.01}}
# the CPU's bfloat16 program against the float32 reference at this size
# reads loss_gap ~1e-6 and grad_gap ~0.054 (seed 5), the widest on the
# routers' gradients: the normalised top-k gates' gradient is a difference
# of near-equal bfloat16 terms. Half of each batch reads loss_gap > 0.01.
LIMITS = {"loss_gap": 0.01, "grad_gap": 0.1}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    cells = dict(tiny.CELLS)
    cells["tinym-train"] = ("tinym", "t-moe", LIMITS, "mellum2-ep8-train")
    base = tmp_path_factory.mktemp("moe") / "checkout"
    tiny.CONFIGS["tinym"] = CONFIG
    tiny.MIXES["t-moe"] = MIX
    try:
        return tiny.make_root(base, cells)
    finally:
        del tiny.CONFIGS["tinym"], tiny.MIXES["t-moe"]


def _run(root, trace, seed=5):
    return run_cell(root, "tinym-train", seed, 0.3, trace,
                    torch.device("cpu"))


def test_the_moe_cell_runs_and_is_correct(root):
    out = _run(root, False)
    assert out["correct"] is True, out["compared"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"train_tok_s", "setup_s"}
    json.dumps(out)


def test_the_traced_line_reads_the_routed_rows(root):
    out = _run(root, True, seed=2 ** 31 + 11)
    assert out["correct"] is True, out["compared"]
    # on the CPU: the host clock's mfu and the program's row counter
    assert set(out["metrics"]) == {"mfu.train", "expert_imbalance.train"}
    imb = out["metrics"]["expert_imbalance.train"]["value"]
    assert 1.0 <= imb <= 4.0 and math.isfinite(imb)


def test_half_the_batch_breaks_a_limit(root):
    """The kind's fault: each step's loss over half of each batch, read
    against the full-batch reference."""
    cell = manifest.cell(root, manifest.load(root), "tinym-train")
    kind = manifest.kind_module(root, "train_moe")
    run = kind.Run(cell, 3, torch.device("cpu"))
    run.setup()
    run.release()
    base = run.reference()
    h = run.reference(rows=1)
    got = kind.compare(h["losses"], h["grad_norms"], h["change"], base)
    assert any(got[k] > LIMITS[k] for k in LIMITS), got
    prog = run.readings(base)
    assert all(prog[k] <= LIMITS[k] for k in LIMITS), prog


def test_imbalance_weights_layers_by_rows(monkeypatch):
    """The reader sums the largest expert's rows and the mean rows over
    every layer: a layer whose held experts take few rows, all on one
    expert, barely moves it (a worst-layer maximum would read the ceiling,
    ``experts_held``), and it reads 1 for an even split."""
    from portbench import counters
    path = (pathlib.Path(__file__).parents[1] / "metrics"
            / "expert_imbalance.train.py")
    spec = importlib.util.spec_from_file_location("imbalance", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ctx = {"cell": {"config": {"port": {"experts_held": 8}}}}
    rows = {"moe.rows": [[8000, 1000], [8, 8]]}
    monkeypatch.setattr(counters, "program_counts", rows.get)
    assert mod.read(ctx) == pytest.approx(8 * 1008 / 8008)
    rows["moe.rows"] = [[8000, 2000], [4000, 1000]]
    assert mod.read(ctx) == pytest.approx(2.0)
    rows["moe.rows"] = [[800, 100]] * 3
    assert mod.read(ctx) == 1.0
    rows["moe.rows"] = [[0, 0]]
    assert mod.read(ctx) is None
    del rows["moe.rows"]
    assert mod.read(ctx) is None
