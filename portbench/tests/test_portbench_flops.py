"""The benchmark's operation and byte counts against hand counts of the
two configurations (CPU)."""

import json
import pathlib

import pytest

from portbench import flops

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"


def shape(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())["port"]


def test_attn_pairs_brute_force():
    for T in (1, 5, 17, 64):
        for w in (None, 1, 4, 16, 64, 100):
            want = sum(min(i + 1, w or T) for i in range(T))
            assert flops.attn_pairs(T, w) == want


def test_gpt2_xl_counts():
    s = shape("gpt2-xl")
    assert flops.layer_matmul_params(s) * 48 == 1_474_560_000
    assert flops.head_params(s) == 80_411_200  # 1.557B in all
    f = flops.train_step_flops(s, 8, 1024)
    assert f["layers"] == pytest.approx(7.248e13, rel=1e-3)
    assert f["head"] == pytest.approx(3.952e12, rel=1e-3)
    assert f["attn"] == pytest.approx(3.869e12, rel=1e-3)
    assert 79e12 < f["total"] < 81e12  # "about 80 TFLOP a step"


def test_mistral_w4k_counts():
    s = shape("mistral-7b-w4k")
    assert s["n_layers"] == 8
    assert flops.attn_pairs(16384, 4096) == 58_722_304
    assert flops.layer_matmul_params(s) * 4 == 872_415_232
    assert flops.head_params(s) == 131_072_000
    # the hand counts of a 4-layer stage
    f = flops.train_step_flops(dict(s, n_layers=4), 1, 16384)
    assert f["layers"] == pytest.approx(8.576e13, rel=1e-3)
    assert f["head"] == pytest.approx(1.288e13, rel=1e-3)
    assert f["attn"] == pytest.approx(1.155e13, rel=1e-3)
    assert f["total"] == pytest.approx(1.10e14, rel=5e-3)
    # the cell's 8 layers: twice the layers and attention, the same head
    g = flops.train_step_flops(s, 1, 16384)
    assert g["layers"] == pytest.approx(2 * f["layers"])
    assert g["attn"] == pytest.approx(2 * f["attn"])
    assert g["head"] == pytest.approx(f["head"])
    assert g["total"] == pytest.approx(2.07e14, rel=5e-3)


def test_serving_bytes():
    s = shape("gpt2-xl")
    # K and V of one position in all 48 layers, bf16: 307,200 bytes
    assert flops.kv_row_bytes(s) * 48 == 307_200
    # the default pool: 1 + 128 slots x 16 pages of 64 rows
    assert 2049 * 64 * 307_200 == pytest.approx(40.3e9, rel=1e-3)
    # a token step at ~500 positions a slot, 128 slots: ~6.8 ms
    kv = 128 * 500 * 307_200
    least = flops.least_seconds(
        128 * flops.decode_token_flops(s, 500),
        flops.weight_bytes(s) + kv)
    assert least == pytest.approx(6.8e-3, rel=0.03)
    # one paged call reads every slot's rows of one layer, q and out
    assert flops.paged_call_bytes(s, 1000, 2) == (
        1000 * 6400 + 2 * 2 * 25 * 64 * 2)


def test_attention_calls_add_up_to_the_model_count():
    for name, B, T in (("gpt2-xl", 8, 1024), ("mistral-7b-w4k", 1, 16384)):
        s = shape(name)
        fwd, bwd = flops.attn_train_calls(s, B, T)
        assert bwd[0] == 2 * fwd[0]
        least = flops.attn_train_least_seconds(s, B, T)
        assert least >= s["n_layers"] * (fwd[0] + bwd[0]) / (
            flops.PEAK_BF16_FLOPS)
        total = flops.train_step_flops(s, B, T)["attn"]
        assert s["n_layers"] * (fwd[0] + bwd[0]) == pytest.approx(total)
