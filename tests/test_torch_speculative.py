"""The port's speculative-decoding model code (linalg_tpu_torch/models/
speculative.py) and its multi-row slot write (nn/cache.py) against the
JAX package's.

Both packages start from the same ``init_gpt_params`` weights. The block
forward is compared in float64 on the CPU (compute dtype float64; x64 is
on for JAX; the port reads the JAX package's float32 RoPE and sinusoidal
tables, whose cos/sin differ from PyTorch's by an ulp, as in
tests/test_torch_sample.py): logits rtol 1e-9, and rtol 1e-5 with grouped
K/V heads, whose decode softmax both packages take in float32. The S = 1
block equals the port's own ``gpt_decode_step`` exactly. Writes, drafts
and greedy tokens compare exactly (greedy runs in float32); the
rejection sampler's law by a chi-square test on the port's generator.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from linalg_tpu.models import gpt as jgpt
from linalg_tpu.models import speculative as jspec
from linalg_tpu.nn import cache as jcache
from linalg_tpu.nn import functional as jF
from linalg_tpu_torch.models import gpt as tgpt
from linalg_tpu_torch.models import speculative as tspec
from linalg_tpu_torch.nn import cache as tcache

torch.set_num_threads(2)


@dataclasses.dataclass(frozen=True)
class JaxCfg64(jgpt.GPTConfig):
    @property
    def compute_dtype(self):
        return jnp.float64


@dataclasses.dataclass(frozen=True)
class PortCfg64(tgpt.GPTConfig):
    @property
    def compute_dtype(self):
        return torch.float64


# GQA (2 KV heads for 4 query heads) and a window band in every mode
BASE = dict(vocab_size=37, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
            ctx_len=48, window=9)
POS = ["sinusoidal", "rope", "learned", "alibi"]


def both64(monkeypatch, seed=3, **kw):
    """(jax cfg, jax params, port cfg, port params) in float64; the port
    reads the JAX package's float32 position tables."""
    kw = dict(BASE, **kw)
    jc, tc = JaxCfg64(**kw), PortCfg64(**kw)
    host = jax.tree.map(lambda a: np.asarray(a, np.float64),
                        jgpt.init_gpt_params(jc, seed=seed))

    def tables(d, pos):
        return tuple(torch.tensor(np.asarray(t)) for t in jF.rope_tables(
            d, np.asarray(pos)))

    monkeypatch.setattr(tgpt, "rope_tables", tables)
    monkeypatch.setattr(tspec, "rope_tables", tables)
    monkeypatch.setattr(tgpt, "sinusoidal_encoding", lambda n, d, device: (
        torch.tensor(np.asarray(jF.sinusoidal_encoding(n, d)))))
    return (jc, jax.tree.map(jnp.asarray, host), tc,
            tgpt.params_from_numpy(host))


def close(got, want, rtol=1e-9, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# -- the multi-row slot write -------------------------------------------

@pytest.mark.parametrize("t", [1, 3, 7])
def test_fkv_write_slots_matches_jax(t):
    """Each slot's t rows land where the JAX vmapped dynamic_update_slice
    puts them: in range, clamped at max_T - t, a negative start wrapped
    once (then clamped), and one far below -max_T (clamped to 0)."""
    rng = np.random.default_rng(t)
    B, h, T, d = 7, 2, 10, 3
    kb = rng.normal(size=(B, h, T, d)).astype(np.float32)
    vb = rng.normal(size=(B, h, T, d)).astype(np.float32)
    kn = rng.normal(size=(B, h, t, d)).astype(np.float32)
    vn = rng.normal(size=(B, h, t, d)).astype(np.float32)
    pos = np.array([0, 2, T - t, T - 1, -1, -3, -25], np.int32)
    jk, jv = jcache.fkv_write_slots(jnp.asarray(kb), jnp.asarray(vb),
                                    jnp.asarray(pos), jnp.asarray(kn),
                                    jnp.asarray(vn))
    tk, tv = tcache.fkv_write_slots(torch.tensor(kb), torch.tensor(vb),
                                    torch.tensor(pos), torch.tensor(kn),
                                    torch.tensor(vn))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_fkv_write_slots_clamp_keeps_rows_contiguous():
    """A start past max_T - t shifts the whole block back (it does not
    drop rows): the clamp the engine's extend pads its buffers against."""
    buf = torch.zeros(1, 1, 8, 1)
    new = torch.arange(1.0, 4.0).reshape(1, 1, 3, 1)
    tcache.fkv_write_slots(buf, buf.clone(), torch.tensor([7]), new, new)
    assert buf[0, 0, :, 0].tolist() == [0, 0, 0, 0, 0, 1, 2, 3]


# -- the block forward ----------------------------------------------------

@pytest.mark.parametrize("S", [1, 5])
@pytest.mark.parametrize("pos", POS)
def test_decode_block_matches_jax(pos, S, monkeypatch):
    """Prefill 7 ids in both packages, then one S-row block: the logits
    and the block's cache rows agree; the length is not advanced."""
    jc, jp, tc, tp = both64(monkeypatch, pos=pos)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, jc.vocab_size, (2, 7))
    blk = rng.integers(0, jc.vocab_size, (2, S))
    _, jcc = jgpt.gpt_prefill(jp, jnp.asarray(ids), jc)
    _, tcc = tgpt.gpt_prefill(tp, torch.from_numpy(ids), tc)
    jl, jcc = jspec.gpt_decode_block(jp, jcc, jnp.asarray(blk), jc, S)
    tl, tcc = tspec.gpt_decode_block(tp, tcc, torch.from_numpy(blk), tc, S)
    assert tl.shape == (2, S, jc.vocab_size) and tl.dtype == torch.float32
    assert int(tcc["length"]) == 7
    tol = dict(rtol=1e-5, atol=1e-6)  # grouped heads: float32 softmax
    close(tl, jl, **tol)
    close(tcc["k"][..., :7 + S, :], jcc["k"][..., :7 + S, :], **tol)
    close(tcc["v"][..., :7 + S, :], jcc["v"][..., :7 + S, :], **tol)


@pytest.mark.parametrize("pos", POS)
def test_decode_block_s1_equals_decode_step(pos):
    """S = 1 is ``gpt_decode_step``'s arithmetic: equal logits and cache
    (float32, the port alone)."""
    cfg = tgpt.GPTConfig(**dict(BASE, pos=pos))
    params = tgpt.init_gpt_params(cfg, seed=0)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 37, (2, 7)))
    _, c1 = tgpt.gpt_prefill(params, ids, cfg)
    _, c2 = tgpt.gpt_prefill(params, ids, cfg)
    tok = torch.tensor([5, 11])
    ls, c1 = tgpt.gpt_decode_step(params, c1, tok, cfg)
    lb, c2 = tspec.gpt_decode_block(params, c2, tok[:, None], cfg, 1)
    assert torch.equal(lb[:, 0], ls)
    assert torch.equal(c1["k"], c2["k"]) and torch.equal(c1["v"], c2["v"])


# -- drafting and verification ---------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_draft_lookup_matches_jax(seed):
    """Random histories over a small vocabulary (so bigrams repeat), every
    history length from 1 to C, S 1 and 4: the JAX drafts, row by row."""
    rng = np.random.default_rng(seed)
    C = 24
    hist = rng.integers(0, 3 + seed, (C, C)).astype(np.int32)
    hlen = np.arange(1, C + 1, dtype=np.int32)
    for S in (1, 4):
        got = tspec._draft_lookup(torch.from_numpy(hist).long(),
                                  torch.from_numpy(hlen), S)
        want = np.stack([np.asarray(jspec._draft_lookup(
            jnp.asarray(h), jnp.int32(n), S)) for h, n in zip(hist, hlen)])
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("draft", [0, 2, 4])
def test_accept_or_resample_marginal_is_target(draft):
    """Chi-square test (40,000 draws from the port's generator) that the
    returned token follows softmax(z), whichever token was drafted."""
    z = torch.tensor([1.2, -0.3, 0.7, -2.0, 0.1])
    target = torch.softmax(z, -1).numpy()
    gen = torch.Generator().manual_seed(draft)
    n = 40000
    toks = [int(tspec.spec_accept_or_resample(gen, z, draft)[0])
            for _ in range(n)]
    counts = np.bincount(toks, minlength=5)
    chi2 = float(((counts - n * target) ** 2 / (n * target)).sum())
    # p = 0.001 with 4 degrees of freedom: a true law fails 1 run in 1000
    assert chi2 < stats.chi2.ppf(0.999, df=4), (counts, n * target)


# -- single-stream generators -------------------------------------------

GCFG = dict(vocab_size=13, d_model=32, n_heads=4, n_layers=2, ctx_len=96)


def port_greedy(params, cfg, prompt, n):
    logits, cache = tgpt.gpt_prefill(params, torch.tensor([prompt]), cfg)
    out = []
    for _ in range(n):
        t = int(logits[0].argmax())
        out.append(t)
        logits, cache = tgpt.gpt_decode_step(params, cache, torch.tensor([t]),
                                             cfg)
    return out


@pytest.mark.parametrize("prompt", [[4], [1, 2, 3, 1, 2, 3, 1, 2],
                                    list(range(11))],
                         ids=["one_id", "repetitive", "random"])
@pytest.mark.parametrize("pos", ["sinusoidal", "rope", "alibi"])
def test_generate_speculative_greedy(pos, prompt):
    """Greedy (top_k 1) prompt-lookup speculative tokens equal the JAX
    package's, with the same number of rounds, and plain greedy decoding."""
    kw = dict(GCFG, pos=pos, n_kv_heads=2)
    jc, tc = jgpt.GPTConfig(**kw), tgpt.GPTConfig(**kw)
    jp, tp = jgpt.init_gpt_params(jc, seed=0), tgpt.init_gpt_params(tc,
                                                                   seed=0)
    want, jr = jspec.gpt_generate_speculative(jp, jc, prompt, 24, n_draft=4,
                                              top_k=1, seed=1)
    got, tr = tspec.gpt_generate_speculative(tp, tc, prompt, 24, n_draft=4,
                                             top_k=1, seed=1)
    assert got.tolist() == want.tolist() and tr == jr
    assert got.tolist() == port_greedy(tp, tc, prompt, 24)


@pytest.mark.parametrize("pos", ["sinusoidal", "rope"])
def test_generate_speculative_draft_greedy(pos):
    """Greedy draft-model speculation: a 1-layer draft of the target's
    vocabulary; tokens and rounds equal the JAX package's, the tokens
    plain greedy decoding's. The target drafting for itself too: its
    rounds equal the JAX package's (not n_tokens / (n_draft + 1): after a
    round that accepts every draft, both packages' draft caches lack the
    last draft's row, which the next round's draft steps then read)."""
    kw = dict(GCFG, pos=pos)
    jc, tc = jgpt.GPTConfig(**kw), tgpt.GPTConfig(**kw)
    dkw = dict(kw, d_model=16, n_layers=1)
    jdc, tdc = jgpt.GPTConfig(**dkw), tgpt.GPTConfig(**dkw)
    jp, tp = jgpt.init_gpt_params(jc, seed=0), tgpt.init_gpt_params(tc,
                                                                   seed=0)
    jd, td = jgpt.init_gpt_params(jdc, seed=5), tgpt.init_gpt_params(tdc,
                                                                    seed=5)
    prompt = [3, 1, 4, 1, 5, 9]
    for (jdp, jdcfg), (tdp, tdcfg) in (((jd, jdc), (td, tdc)),
                                       ((jp, jc), (tp, tc))):
        want, jr = jspec.gpt_generate_speculative_draft(
            jp, jc, jdp, jdcfg, prompt, 20, n_draft=3, top_k=1, seed=2)
        got, tr = tspec.gpt_generate_speculative_draft(
            tp, tc, tdp, tdcfg, prompt, 20, n_draft=3, top_k=1, seed=2)
        assert got.tolist() == want.tolist() and tr == jr
        assert got.tolist() == port_greedy(tp, tc, prompt, 20)


def test_generate_speculative_sampled_in_range_and_seeded():
    cfg = tgpt.GPTConfig(**GCFG)
    params = tgpt.init_gpt_params(cfg, seed=0)

    def run(seed):
        return tspec.gpt_generate_speculative(
            params, cfg, [1, 2, 3, 1, 2, 3], 30, n_draft=4, temperature=0.9,
            top_k=5, seed=seed)[0]

    a = run(3)
    assert a.shape == (30,) and a.min() >= 0 and a.max() < 13
    assert np.array_equal(a, run(3))


def test_generate_speculative_refusals():
    cfg = tgpt.GPTConfig(**GCFG)
    params = tgpt.init_gpt_params(cfg, seed=0)
    with pytest.raises(ValueError, match="ctx_len"):
        tspec.gpt_generate_speculative(params, cfg, [1] * 80, 10, n_draft=8)
    with pytest.raises(ValueError, match="non-empty"):
        tspec.gpt_generate_speculative(params, cfg, [], 10)
    small = tgpt.GPTConfig(**dict(GCFG, vocab_size=7))
    with pytest.raises(ValueError, match="vocab"):
        tspec.gpt_generate_speculative_draft(
            params, cfg, tgpt.init_gpt_params(small), small, [1, 2], 4)
