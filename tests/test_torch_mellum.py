"""Mellum-style layers in the port: per-layer window/full attention with
YaRN on the full layers, a head width apart from d_model / n_heads, and
the dropless top-k routed FFN through K13, the grouped GEMM.

The CPU tests hold the port against ``portbench/reference/moe.py``, the
benchmark's plain float32 reference of the same model, at a small size in
float64 (loss, logits and every leaf's gradient), and the grouped dispatch
against the ``gather`` dispatch at a capacity that drops nothing. K13's
tests carry the ``cuda`` marker: the kernel against its plain version on
the card, empty and ragged groups, the forward and both backward
products. No JAX here, so the card tests run with ``--noconftest``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

from linalg_tpu_torch.kernels import grouped_gemm as gg
from linalg_tpu_torch.models import moe as tmoe
from linalg_tpu_torch.models.gpt import GPTConfig, _layer_kinds
from linalg_tpu_torch.models.moe import (MoEGPTConfig, init_moe_params,
                                         moe_ffn, moe_gpt_apply, moe_gpt_loss)
from linalg_tpu_torch.nn.functional import YaRN, yarn_tables
from portbench.reference import moe as ref

YARN = YaRN(factor=4.0, original_max_position_embeddings=16, beta_fast=32.0,
            beta_slow=1.0, attention_factor=1.2772588722239782)
SMALL = dict(vocab_size=37, d_model=64, n_heads=4, n_kv_heads=2, head_dim=32,
             n_layers=4, d_ff=48, ctx_len=32, pos="rope", window=8,
             full_every=4, ffn="swiglu", n_experts=16, router_top_k=4,
             dispatch="grouped", rope_theta=500000.0, rope_scaling=YARN)


def _inv64(d, base, y=None):
    """Inverse frequencies (d/2,) in float64: RoPE's, YaRN-blended with
    ``y`` (Hugging Face's ``_compute_yarn_parameters`` written out)."""
    i = np.arange(d // 2)
    inv = 1.0 / base ** (2.0 * i / d)
    if y is None:
        return inv
    dim = lambda rot: d * math.log(  # noqa: E731
        y.original_max_position_embeddings / (rot * 2 * math.pi)) / (
        2 * math.log(base))
    low = max(math.floor(dim(y.beta_fast)), 0)
    high = min(math.ceil(dim(y.beta_slow)), d - 1)
    ramp = np.clip((i - low) / (high - low), 0.0, 1.0)
    return inv / y.factor * ramp + inv * (1.0 - ramp)


def _tables64(d, pos, base=10000.0, y=None):
    ang = torch.as_tensor(pos).double()[..., None] * torch.tensor(
        _inv64(d, base, y))
    af = 1.0 if y is None else y.attention_factor
    return torch.cos(ang) * af, torch.sin(ang) * af


@pytest.fixture
def f64(monkeypatch):
    """The router's and the head's float32 casts, and the port's RoPE and
    YaRN tables, in float64."""
    from linalg_tpu_torch.models import gpt as tgpt
    monkeypatch.setattr(tmoe, "_ROUTER_DTYPE", torch.float64)
    monkeypatch.setattr(tmoe, "_head", lambda p, h, dt: (
        h @ p["tok_W"].to(dt).T + p["head_b"].to(dt)))
    monkeypatch.setattr(tgpt, "rope_tables", _tables64)
    monkeypatch.setattr(tgpt, "yarn_tables", _tables64)


@dataclasses.dataclass(frozen=True)
class Moe64(MoEGPTConfig):
    @property
    def compute_dtype(self):
        return torch.float64


def ref_shape(cfg: MoEGPTConfig) -> dict:
    """The reference's view of a port config: the published keys it reads
    and its ``port`` shape."""
    L = cfg.n_layers
    types = ["full_attention" if w is None else "sliding_attention"
             for w in cfg.layer_windows]
    y = cfg.rope_scaling
    return {
        "layer_types": types, "sliding_window": cfg.window,
        "num_experts_per_tok": cfg.router_top_k, "norm_topk_prob": True,
        "rope_parameters": {
            "full_attention": {
                "rope_type": "yarn", "rope_theta": cfg.rope_theta,
                "factor": y.factor,
                "original_max_position_embeddings":
                    y.original_max_position_embeddings,
                "beta_fast": y.beta_fast, "beta_slow": y.beta_slow,
                "attention_factor": y.attention_factor},
            "sliding_attention": {"rope_type": "default",
                                  "rope_theta": cfg.rope_theta}},
        "port": {"d_model": cfg.d_model, "n_heads": cfg.n_heads,
                 "n_kv_heads": cfg.kv_heads, "head_dim": cfg.d_head,
                 "n_layers": L, "d_ff": cfg.dff,
                 "vocab_size": cfg.vocab_size, "n_experts": cfg.n_experts,
                 "experts_held": None,
                 "aux_weight": cfg.aux_weight}}


def f64_params(cfg, seed=3, held=None, scale=1.0):
    p = init_moe_params(cfg, seed)
    g = torch.Generator().manual_seed(seed)
    out = {"tok_W": p["tok_W"].double(), "head_b": torch.randn(
        p["head_b"].shape, generator=g, dtype=torch.float64) * 0.1,
        "layers": {}}
    for k, v in p["layers"].items():
        v = v.double()
        if k in ("b1", "bg", "b2", "ln1_b", "ln2_b"):
            v = torch.randn(v.shape, generator=g, dtype=torch.float64) * 0.1
        if k == "Wr":
            v = v * scale
        if held is not None and k in ("W1", "b1", "Wg", "bg", "W2", "b2"):
            v = v[:, held].clone()
        out["layers"][k] = v
    return out


def _leaves(p):
    return [p["tok_W"], p["head_b"], *p["layers"].values()]


def _grads(fn, p):
    for t in _leaves(p):
        t.requires_grad_(True)
        t.grad = None
    out = fn(p)
    out.backward()
    return out.detach(), {k: t.grad.clone() for k, t in
                          [("tok_W", p["tok_W"]), ("head_b", p["head_b"]),
                           *p["layers"].items()]}


# ---------------------------------------------------------------- the model


def test_yarn_tables_equal_the_written_formula():
    d, base, y = 128, 500000.0, YaRN(16.0, 8192, 32.0, 1.0,
                                     1.2772588722239782)
    pos = torch.arange(0, 9000, 7)
    cos, sin = yarn_tables(d, pos, base, y)
    inv_e, inv = _inv64(d, base), _inv64(d, base, y)
    ang = pos.numpy()[:, None].astype(np.float64) * inv
    # float32 angles: up to ~9000 * 2^-23 of rounding far out, ~1e-5 near
    near = pos.numpy() < 64
    for got, want in ((cos, np.cos(ang)), (sin, np.sin(ang))):
        want = want * 1.2772588722239782
        np.testing.assert_allclose(got.numpy(), want, atol=2e-3)
        np.testing.assert_allclose(got.numpy()[near], want[near], atol=2e-5)
    # the pairs below the fast correction dim keep their frequency, those
    # above the slow one are divided by the factor
    low = math.floor(d * math.log(8192 / (32 * 2 * math.pi))
                     / (2 * math.log(base)))
    high = math.ceil(d * math.log(8192 / (2 * math.pi)) / (2 * math.log(base)))
    assert 0 < low < high < d // 2
    np.testing.assert_allclose(inv[:low], inv_e[:low])
    np.testing.assert_allclose(inv[high:], inv_e[high:] / 16.0)
    # and with no attention factor, 0.1 ln(factor) + 1
    c2, _ = yarn_tables(d, pos, base, dataclasses.replace(
        y, attention_factor=None))
    torch.testing.assert_close(c2 * 1.2772588722239782, cos * (
        0.1 * math.log(16.0) + 1.0), rtol=1e-6, atol=1e-6)


def test_layer_kinds_follow_full_every():
    cfg = GPTConfig(vocab_size=11, d_model=16, n_heads=2, n_layers=8,
                    pos="rope", window=4, full_every=4,
                    rope_scaling=YARN)
    assert cfg.layer_windows == (4, 4, 4, None, 4, 4, 4, None)
    kinds = _layer_kinds(cfg, 12, torch.float32, torch.device("cpu"),
                         rope=("band", "band"))
    assert [k[2] == ("band", "band") for k in kinds] == [
        True, True, True, False, True, True, True, False]
    full_mask, band_mask = kinds[3][1], kinds[0][1]
    assert (full_mask[0, 0, 11] > -1).sum() == 12
    assert (band_mask[0, 0, 11] > -1).sum() == 4
    # a config without full_every keeps one kind for every layer
    plain = dataclasses.replace(cfg, full_every=None, rope_scaling=None)
    assert len({id(k[1]) for k in _layer_kinds(
        plain, 12, torch.float32, torch.device("cpu"), rope=None)}) == 1
    with pytest.raises(ValueError):
        GPTConfig(vocab_size=11, full_every=4)


def test_head_dim_apart_from_d_model_shapes():
    cfg = MoEGPTConfig(**SMALL)
    p = init_moe_params(cfg, 0)
    assert p["layers"]["Wq"].shape == (4, 64, 128)
    assert p["layers"]["Wo"].shape == (4, 128, 64)
    assert p["layers"]["Wk"].shape == (4, 64, 64)
    logits, aux = moe_gpt_apply(p, torch.randint(0, 37, (2, 32)), cfg)
    assert logits.shape == (2, 32, 37) and torch.isfinite(aux)


@pytest.mark.parametrize("held", [None, slice(0, 8)])
def test_loss_logits_and_grads_match_the_reference(f64, held):
    """The whole model (4 layers S, S, S, F; YaRN on; head width 32 with
    H * d = 128 != D = 64; top-4 of 16) against the plain reference in
    float64: the loss, the logits and every leaf's gradient; also as an
    expert-parallel slice (the first 8 experts held, as the benchmark's
    rank holds them)."""
    cfg = Moe64(**SMALL, dtype="float32")
    p = f64_params(cfg, held=held)
    x = torch.randint(0, 37, (2, 32), generator=torch.Generator()
                      .manual_seed(1))
    y = torch.randint(0, 37, (2, 32), generator=torch.Generator()
                      .manual_seed(2))
    shape = ref_shape(cfg)
    if held is not None:
        shape["port"]["experts_held"] = 8
    loss, g = _grads(lambda q: moe_gpt_loss(q, x, y, cfg), p)
    rloss, rg = _grads(lambda q: ref.batch_loss(q, x, y, shape,
                                                 dtype=torch.float64), p)
    torch.testing.assert_close(loss, rloss, rtol=1e-10, atol=0)
    for k in g:
        torch.testing.assert_close(g[k], rg[k], rtol=1e-8, atol=1e-12,
                                   msg=lambda m: f"{k}: {m}")
    with torch.no_grad():
        logits, _ = moe_gpt_apply(p, x, cfg)
        rl = ref.logits(p, ref.hidden(p, x[1], shape, dtype=torch.float64))
    torch.testing.assert_close(logits[1], rl, rtol=1e-10, atol=1e-10)


def _ffn_args(cfg, p, i=0):
    lay = p["layers"]
    return (lay["Wr"][i], lay["W1"][i], lay["b1"][i], lay["W2"][i],
            lay["b2"][i])


def test_grouped_equals_gather_without_drops():
    cfg = MoEGPTConfig(**SMALL)
    p = init_moe_params(cfg, 5)
    x = torch.randn(3, 20, 64, dtype=torch.float64)
    lay = {k: v.double() for k, v in p["layers"].items()}
    args = (lay["Wr"][0], lay["W1"][0], lay["b1"][0] + 0.1, lay["W2"][0],
            lay["b2"][0] + 0.2)
    kw = dict(top_k=4, Wg=lay["Wg"][0], bg=lay["bg"][0] - 0.1, ffn="swiglu")
    got, aux = moe_ffn(x, *args, capacity=1, mode="grouped", **kw)
    want, aux2 = moe_ffn(x, *args, capacity=80, mode="gather", **kw)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(aux, aux2)


def test_skewed_router_drops_nothing():
    """A router that sends nearly every token to expert 3 first: the
    grouped dispatch computes every assignment (the einsum dispatch at the
    default capacity would drop most of them)."""
    cfg = MoEGPTConfig(**SMALL)
    p = init_moe_params(cfg, 6)
    lay = {k: v.double() for k, v in p["layers"].items()}
    x = torch.randn(2, 30, 64, dtype=torch.float64).abs()
    Wr = lay["Wr"][0].clone()
    Wr[:, 3] += 1.0  # x >= 0: expert 3's logit dominates
    kw = dict(top_k=4, Wg=lay["Wg"][0], bg=lay["bg"][0], ffn="swiglu")
    args = (Wr, lay["W1"][0], lay["b1"][0], lay["W2"][0], lay["b2"][0])
    probs, idxs, gates = tmoe._route(x, Wr, 4)
    assert (idxs[..., 0] == 3).float().mean() > 0.9
    got, _ = moe_ffn(x, *args, capacity=1, mode="grouped", **kw)
    # every token's four experts, computed one by one
    want = torch.zeros_like(x)
    for b in range(2):
        for t in range(30):
            for j in range(4):
                e = int(idxs[b, t, j])
                u = x[b, t] @ lay["W1"][0, e] + lay["b1"][0, e]
                v = x[b, t] @ lay["Wg"][0, e] + lay["bg"][0, e]
                h = u * torch.sigmoid(u) * v
                want[b, t] += gates[b, t, j] * (h @ lay["W2"][0, e]
                                                + lay["b2"][0, e])
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    dropped, _ = moe_ffn(x, *args, capacity=4, mode="einsum", **kw)
    assert not torch.allclose(dropped, want)


def test_expert_slices_add_up_to_the_whole_layer():
    """The E / El slices of one routed FFN (``moe_ffn``'s
    ``expert_offset``, as ``parallel.expert`` passes each rank's) add up
    to the uncut FFN; with the attention half (which every rank computes
    alike) counted once, they add up to the uncut layer."""
    cfg = MoEGPTConfig(**SMALL)
    p = init_moe_params(cfg, 7)
    lay = {k: v[0].double() for k, v in p["layers"].items()}
    x = torch.randn(2, 32, 64, dtype=torch.float64)
    mask = torch.zeros(1, 1, 32, 32, dtype=torch.float64)
    from linalg_tpu_torch.nn.functional import layer_norm, sdpa
    whole, _, aux = tmoe._moe_layer(x, lay, mask, 4, sdpa, None, 1, 4,
                                    mode="grouped", n_kv=2, ffn="swiglu")
    h1 = x + tmoe._attn_half(x, lay, mask, 4, 2, sdpa)[0]
    x2 = layer_norm(h1, lay["ln2_g"], lay["ln2_b"])
    parts = []
    for off in range(0, 16, 4):
        sl = {k: lay[k][off:off + 4] for k in ("W1", "b1", "Wg", "bg", "W2",
                                                "b2")}
        f, a = moe_ffn(x2, lay["Wr"], sl["W1"], sl["b1"], sl["W2"],
                       sl["b2"], 1, 4, "grouped", Wg=sl["Wg"], bg=sl["bg"],
                       ffn="swiglu", expert_offset=off)
        torch.testing.assert_close(a, aux)
        parts.append(f)
    torch.testing.assert_close(h1 + sum(parts), whole, rtol=1e-12,
                               atol=1e-12)


def test_grouped_dispatch_reads_nothing_back_and_counts_rows():
    """The dispatch keeps the offsets on the device: no ``.item()``,
    ``.tolist()`` or ``.cpu()`` on the step's tensors, apart from the plain
    K13 version's own (CPU tensors); while a profiler records, each layer
    counts its routed rows."""
    from linalg_tpu_torch.utils import profiling
    cfg = MoEGPTConfig(**SMALL)
    p = init_moe_params(cfg, 8)
    x = torch.randint(0, 37, (2, 32))
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        moe_gpt_apply(p, x, cfg)
    rows = profiling.counts("moe.rows")
    assert len(rows) == cfg.n_layers
    for held, biggest in rows:
        assert held == 2 * 32 * 4 and 0 < biggest <= held


def test_dense_trunk_takes_each_layers_kind():
    """The dense GPT with full_every: the full layers see the whole past,
    the band layers their window (a change at position 0 reaches position
    31 only through a full layer)."""
    base = dict(vocab_size=17, d_model=32, n_heads=2, n_layers=2,
                ctx_len=32, pos="rope", window=4, ffn="swiglu")
    from linalg_tpu_torch.models.gpt import gpt_apply, init_gpt_params
    banded = GPTConfig(**base)
    mixed = GPTConfig(**base, full_every=2)
    p = init_gpt_params(banded, 1)
    x = torch.randint(0, 17, (1, 32))
    x2 = x.clone()
    x2[0, 0] = (x[0, 0] + 1) % 17
    with torch.no_grad():
        d_band = gpt_apply(p, x2, banded) - gpt_apply(p, x, banded)
        d_mix = gpt_apply(p, x2, mixed) - gpt_apply(p, x, mixed)
    assert d_band[0, 31].abs().max() == 0
    assert d_mix[0, 31].abs().max() > 0


def test_checkpoint_keeps_the_port_only_fields(tmp_path):
    from linalg_tpu_torch.train import checkpoint as tckpt
    cfg = MoEGPTConfig(**SMALL)
    p = init_moe_params(cfg, 2)
    tckpt.save_ckpt(tmp_path, p, cfg, {"a": 0}, {0: "a"})
    back, cfg2, _, _ = tckpt.load_ckpt(tmp_path)
    assert cfg2 == cfg
    for k, v in p["layers"].items():
        torch.testing.assert_close(back["layers"][k], v, rtol=0, atol=0)


def test_serving_refuses_mixed_layers():
    cfg = MoEGPTConfig(**SMALL)
    p = init_moe_params(cfg, 0)
    with pytest.raises(ValueError, match="trained only"):
        tmoe.moe_prefill(p, torch.zeros(1, 4, dtype=torch.long), cfg)
    plain = GPTConfig(vocab_size=11, d_model=16, n_heads=2, n_layers=2,
                      pos="rope", rope_theta=500000.0)
    from linalg_tpu_torch.models.gpt import gpt_prefill, init_gpt_params
    with pytest.raises(ValueError, match="trained only"):
        gpt_prefill(init_gpt_params(plain), torch.zeros(1, 4,
                                                        dtype=torch.long),
                    plain)


def test_top_k_past_two_only_dropless():
    """Top-k beyond 2 routes through the dropless dispatch; the capacity
    dispatches keep the JAX package's rule and message."""
    with pytest.raises(ValueError, match="router_top_k must be 1 or 2"):
        MoEGPTConfig(**dict(SMALL, dispatch="gather"))
    assert MoEGPTConfig(**dict(SMALL, router_top_k=16)).router_top_k == 16
    with pytest.raises(ValueError, match="exceed"):
        MoEGPTConfig(**dict(SMALL, router_top_k=17))


# ------------------------------------------------------------ K13 on a card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _groups(counts, tail, device):
    offs = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                        dtype=torch.int32, device=device)
    return offs, int(sum(counts)) + tail


CASES = [
    # (group rows, tail rows, K, N)
    ([0, 300, 1, 129, 0, 1024, 77, 0], 201, 2304, 1792),
    ([1100, 900, 1024, 980, 1050, 1000, 1070, 1068], 57345, 896, 2304),
    ([5, 0, 0, 130], 1, 200, 136),
    ([0, 0], 3, 64, 64),
]


def _close(got, want, what):
    scale = want.abs().max().clamp_min(1e-6)
    err = ((got.float() - want).abs().max() / scale).item()
    assert err < 1.5e-2, f"{what}: max error {err:.3g} of the largest entry"


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_k13_rows_matches_plain_version(cuda, case):
    counts, tail, K, N = case
    offs, M = _groups(counts, tail, cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    El = len(counts)
    A = torch.randn(3000, K, generator=g, device=cuda).bfloat16()
    idx = torch.randint(0, 3000, (M,), generator=g, device=cuda,
                        dtype=torch.int32)
    W = torch.randn(El, K, N, generator=g, device=cuda).bfloat16()
    for a_idx, trans in ((idx, False), (None, False), (None, True)):
        AA = A if a_idx is not None else torch.randn(
            M, K, generator=g, device=cuda).bfloat16()
        WW = W if not trans else W.transpose(1, 2).contiguous()
        got = gg.grouped_rows(AA, a_idx, offs, WW, M, trans)
        torch.cuda.synchronize()
        want = gg.grouped_rows_ref(AA.float(), a_idx, offs, WW.float(), M,
                                   trans)
        _close(got, want, f"rows a_idx={a_idx is not None} trans={trans}")
        live = int(offs[-1])
        assert got[live:].abs().max().item() == 0 if live < M else True


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_k13_dw_matches_plain_version(cuda, case):
    counts, tail, K, N = case
    offs, M = _groups(counts, tail, cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    A = torch.randn(3000, K, generator=g, device=cuda).bfloat16()
    idx = torch.randint(0, 3000, (M,), generator=g, device=cuda,
                        dtype=torch.int32)
    D = torch.randn(M, N, generator=g, device=cuda).bfloat16()
    got = gg.grouped_dw(A, idx, D, offs)
    torch.cuda.synchronize()
    want = gg.grouped_dw_ref(A.float(), idx, D.float(), offs)
    for e, c in enumerate(counts):
        if c == 0:
            assert got[e].abs().max().item() == 0
        else:
            _close(got[e], want[e], f"dw group {e} ({c} rows)")


@pytest.mark.cuda
def test_grouped_ffn_on_card_matches_cpu(cuda):
    """The grouped routed FFN (K13 forward, dX and dW through
    ``GroupedFFN``) in bf16 on the card against the same function on the
    CPU in float32 from the same bf16 values, on one routing (taken once,
    so that no near-tie flips between the two): output and every
    gradient, the gates' included."""
    g = torch.Generator().manual_seed(4)
    E, El, D, F, k = 16, 8, 256, 128, 8
    t = {"x": torch.randn(2, 200, D, generator=g),
         "W1": torch.randn(El, D, F, generator=g) * 0.05,
         "Wg": torch.randn(El, D, F, generator=g) * 0.05,
         "W2": torch.randn(El, F, D, generator=g) * 0.05,
         "b1": torch.randn(El, F, generator=g) * 0.1,
         "bg": torch.randn(El, F, generator=g) * 0.1,
         "b2": torch.randn(El, D, generator=g) * 0.1}
    t = {k_: v.bfloat16() for k_, v in t.items()}
    _, idxs, gates = tmoe._route(t["x"].float(), torch.randn(
        D, E, generator=g), k)
    t["gates"] = gates.bfloat16()
    outs = {}
    for name, dev, dt in (("card", cuda, torch.bfloat16),
                          ("cpu", torch.device("cpu"), torch.float32)):
        v = {k_: a.to(dev, dt).requires_grad_(True) for k_, a in t.items()}
        y = tmoe._grouped_ffn(v["x"], idxs.to(dev), v["gates"], v["W1"],
                              v["b1"], v["W2"], v["b2"], v["Wg"], v["bg"],
                              "swiglu", 4)
        dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(9))
        (y.float() * dy.to(dev)).sum().backward()
        outs[name] = [y.float().cpu()] + [v[k_].grad.float().cpu()
                                          for k_ in t]
    for i, (a, b) in enumerate(zip(outs["card"], outs["cpu"])):
        scale = b.abs().max().clamp_min(1e-6)
        assert ((a - b).abs().max() / scale).item() < 3e-2, i
