"""The port's sampling path (linalg_tpu_torch/models/gpt.py decode entry
points, models/beam.py, train/trainer.py ``sample``, apps/gpt.py
``--repl``) against the JAX package's.

Both packages start from the same ``init_gpt_params`` weights and run in
float64 on the CPU (configs whose compute dtype is float64; x64 is on for
JAX). The RoPE and sinusoidal tables are float32 in both packages and
PyTorch's float32 cos/sin differ from XLA's by an ulp, so the port gets
the JAX package's tables (as tests/test_torch_train.py does). Tolerances:
logits and caches rtol 1e-9 (float64 sums in another order; logits are
float64 values rounded once to float32 in both), and rtol 1e-5 for decode
steps with grouped K/V heads, whose attention softmax both packages take
in float32; greedy and beam tokens
exactly; beam scores (sums of float32 log-probabilities) rtol 1e-5;
stochastic draws by total variation against the filtered softmax.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_tpu.models import beam as jbeam
from linalg_tpu.models import gpt as jgpt
from linalg_tpu.nn import functional as jF
from linalg_tpu.train import trainer as jtrainer
from linalg_tpu_torch.models import beam as tbeam
from linalg_tpu_torch.models import gpt as tgpt
from linalg_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parents[1]


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


BASE = dict(vocab_size=37, d_model=32, n_heads=4, n_layers=2, ctx_len=48)
CFGS = {
    "sinusoidal": {},
    "rope_gqa_window": dict(pos="rope", n_kv_heads=2, window=9,
                            ffn="swiglu"),
    "alibi": dict(pos="alibi", ffn="geglu"),
    "learned": dict(pos="learned", ffn="gelu"),
}


def both64(monkeypatch, seed=3, **kw):
    """(jax cfg, jax params, port cfg, port params) in float64; the port
    reads the JAX package's float32 position tables."""
    kw = dict(BASE, **kw)
    jc, tc = JaxCfg64(**kw), PortCfg64(**kw)
    host = jax.tree.map(lambda a: np.asarray(a, np.float64),
                        jgpt.init_gpt_params(jc, seed=seed))
    monkeypatch.setattr(tgpt, "rope_tables", lambda d, pos: tuple(
        torch.tensor(np.asarray(t)) for t in jF.rope_tables(d, pos.numpy())))
    monkeypatch.setattr(tgpt, "sinusoidal_encoding", lambda n, d, device: (
        torch.tensor(np.asarray(jF.sinusoidal_encoding(n, d)))))
    return (jc, jax.tree.map(jnp.asarray, host), tc,
            tgpt.params_from_numpy(host))


def prompts(B, lo, hi, V, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V, rng.integers(lo, hi + 1)) for _ in range(B)]


def close(got, want, rtol=1e-9, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_decode_step_logits_match_jax(name, monkeypatch):
    """Prefill 7 ids, then 5 ``gpt_decode_step`` calls in both packages:
    logits and the cache's written rows agree."""
    jc, jp, tc, tp = both64(monkeypatch, **CFGS[name])
    ids = np.random.default_rng(1).integers(0, jc.vocab_size, (2, 7))
    jl, jcache = jgpt.gpt_prefill(jp, jnp.asarray(ids), jc)
    tl, tcache = tgpt.gpt_prefill(tp, torch.from_numpy(ids), tc)
    close(tl, jl)
    # grouped K/V heads: both packages' decode attention takes its softmax
    # in float32, so the steps agree to float32 rounding
    tol = (dict(rtol=1e-5, atol=1e-6) if tc.kv_heads != tc.n_heads
           else {})
    for t in range(5):
        tok = np.array([t % jc.vocab_size, (3 * t + 1) % jc.vocab_size])
        jl, jcache = jgpt.gpt_decode_step(jp, jcache, jnp.asarray(tok), jc)
        tl, tcache = tgpt.gpt_decode_step(tp, tcache, torch.from_numpy(tok),
                                          tc)
        assert tl.dtype == torch.float32 and int(tcache["length"]) == 8 + t
        close(tl, jl, **tol)
    close(tcache["k"][..., :12, :], jcache["k"][..., :12, :], **tol)
    close(tcache["v"][..., :12, :], jcache["v"][..., :12, :], **tol)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_prefill_batched_matches_jax(name, monkeypatch):
    """Left-padded ragged prompts (starts 0 to 13 in a window of 16):
    next-token logits, the cache and ``start``."""
    jc, jp, tc, tp = both64(monkeypatch, **CFGS[name])
    W = 16
    ps = prompts(4, 3, 16, jc.vocab_size, seed=2)
    buf = np.zeros((4, W), np.int32)
    start = np.array([W - len(p) for p in ps], np.int32)
    for b, p in enumerate(ps):
        buf[b, start[b]:] = p
    jl, jcache = jgpt.gpt_prefill_batched(jp, jnp.asarray(buf),
                                          jnp.asarray(start), jc)
    tl, tcache = tgpt.gpt_prefill_batched(tp, torch.from_numpy(buf),
                                          torch.from_numpy(start), tc)
    close(tl, jl)
    close(tcache["k"], jcache["k"])
    close(tcache["v"], jcache["v"])
    assert int(tcache["length"]) == W
    np.testing.assert_array_equal(tcache["start"].numpy(), start)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_generate_greedy_equals_jax(name, monkeypatch):
    """``gpt_generate`` with top_k 1: five ragged prompts (one longer than
    the window, so it is cut), 20 new tokens each, token for token."""
    jc, jp, tc, tp = both64(monkeypatch, **CFGS[name])
    ps = prompts(5, 1, 35, jc.vocab_size, seed=4)
    want = np.asarray(jgpt.gpt_generate(jp, jc, ps, 20, top_k=1))
    got = tgpt.gpt_generate(tp, tc, ps, 20, top_k=1, seed=9)
    assert got.shape == (5, 20)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_rows_equal_alone(monkeypatch):
    """A batch row decodes as its prompt alone does (B 1), greedily."""
    _, _, tc, tp = both64(monkeypatch, **CFGS["rope_gqa_window"])
    ps = prompts(3, 2, 20, tc.vocab_size, seed=6)
    batch = tgpt.gpt_generate(tp, tc, ps, 12, top_k=1)
    for b, p in enumerate(ps):
        np.testing.assert_array_equal(
            tgpt.gpt_generate(tp, tc, [p], 12, top_k=1)[0], batch[b])


def test_generate_refusals():
    tc = tgpt.GPTConfig(**BASE)
    tp = tgpt.init_gpt_params(tc, seed=0)
    with pytest.raises(ValueError, match="ctx_len"):
        tgpt.gpt_generate(tp, tc, [[1]], BASE["ctx_len"])
    with pytest.raises(ValueError, match="empty"):
        tgpt.gpt_generate(tp, tc, [[1], []], 4)


def test_init_decode_cache_matches_jax():
    jc, tc = jgpt.GPTConfig(**BASE, n_kv_heads=2), tgpt.GPTConfig(
        **BASE, n_kv_heads=2)
    want = jgpt.init_decode_cache(jc, batch=3)
    got = tgpt.init_decode_cache(tc, batch=3, device="cpu")
    for k in ("k", "v"):
        assert tuple(got[k].shape) == want[k].shape
        assert got[k].dtype == torch.float32 and not got[k].any()
    assert int(got["length"]) == int(want["length"]) == 0


@pytest.mark.parametrize("beam", [1, 3, 8])
@pytest.mark.parametrize("name", ["sinusoidal", "rope_gqa_window"])
def test_beam_equals_jax(beam, name, monkeypatch):
    """``gpt_generate_beam`` token for token, its score within rtol 1e-5,
    with a stop token and a length penalty at beam 8."""
    jc, jp, tc, tp = both64(monkeypatch, **CFGS[name])
    prompt = [4, 11, 2, 30, 7]
    kw = dict(stop_token=5, length_penalty=0.7) if beam == 8 else {}
    jt, js = jbeam.gpt_generate_beam(jp, jc, prompt, 12, beam=beam, **kw)
    tt, ts = tbeam.gpt_generate_beam(tp, tc, prompt, 12, beam=beam, **kw)
    assert tt.dtype == np.int32
    np.testing.assert_array_equal(tt, np.asarray(jt))
    assert ts == pytest.approx(js, rel=1e-5)


# tests/test_beam.py's model: V 5, so beam V**n is exhaustive
BCFG = dict(vocab_size=5, d_model=16, n_heads=2, n_layers=2, ctx_len=16)


@pytest.fixture(scope="module")
def beam_model():
    cfg = tgpt.GPTConfig(**BCFG)
    return cfg, tgpt.init_gpt_params(cfg, seed=3)


def brute_force(params, cfg, prompt, n):
    """Score every V**n continuation teacher-forced through ``gpt_apply``."""
    import itertools

    V, m = cfg.vocab_size, len(prompt)
    seqs = np.array(list(itertools.product(range(V), repeat=n)), np.int64)
    full = np.concatenate([np.tile(np.asarray(prompt), (len(seqs), 1)),
                           seqs], axis=1)
    with torch.no_grad():
        logp = torch.log_softmax(tgpt.gpt_apply(
            params, torch.from_numpy(full), cfg), -1).numpy()
    tot = logp[np.arange(len(seqs))[:, None], m - 1 + np.arange(n)[None],
               seqs].sum(axis=1)
    return seqs, tot


def test_exhaustive_beam_finds_global_argmax(beam_model):
    cfg, params = beam_model
    prompt, n = [1, 3, 0], 3
    seqs, tot = brute_force(params, cfg, prompt, n)
    toks, score = tbeam.gpt_generate_beam(params, cfg, prompt, n,
                                          beam=cfg.vocab_size ** n)
    np.testing.assert_array_equal(toks, seqs[np.argmax(tot)])
    assert score == pytest.approx(float(tot.max()), abs=1e-4)
    jc = jgpt.GPTConfig(**BCFG)
    jt, _ = jbeam.gpt_generate_beam(jgpt.init_gpt_params(jc, seed=3), jc,
                                    prompt, n, beam=cfg.vocab_size ** n)
    np.testing.assert_array_equal(toks, np.asarray(jt))


def test_score_is_true_logprob(beam_model):
    cfg, params = beam_model
    prompt, n = [2, 4], 3
    seqs, tot = brute_force(params, cfg, prompt, n)
    for beam in (1, 2, 4):
        toks, score = tbeam.gpt_generate_beam(params, cfg, prompt, n,
                                              beam=beam)
        i = np.flatnonzero((seqs == toks).all(axis=1))[0]
        assert score == pytest.approx(float(tot[i]), abs=1e-4)


def test_beam1_equals_greedy_decode(beam_model):
    cfg, params = beam_model
    prompt = torch.tensor([[3, 1]])
    logits, cache = tgpt.gpt_prefill(params, prompt, cfg)
    greedy, _, _ = tgpt.gpt_decode_chunk(params, cache, logits,
                                         torch.Generator().manual_seed(0),
                                         cfg, 6, 1.0, 1, 0.0)
    toks, _ = tbeam.gpt_generate_beam(params, cfg, [3, 1], 6, beam=1)
    np.testing.assert_array_equal(toks, greedy[0].numpy())


def test_stop_token_truncates_and_freezes(beam_model):
    cfg, params = beam_model
    greedy, s1 = tbeam.gpt_generate_beam(params, cfg, [3, 1], 1, beam=1)
    stop = int(greedy[0])
    toks, score = tbeam.gpt_generate_beam(params, cfg, [3, 1], 5, beam=1,
                                          stop_token=stop)
    assert toks.tolist() == [stop]
    assert score == pytest.approx(s1, abs=1e-4)
    for beam in (2, 8):
        toks, _ = tbeam.gpt_generate_beam(params, cfg, [0, 4, 2], 6,
                                          beam=beam, stop_token=3)
        assert 3 not in toks.tolist()[:-1]


def test_beam_rejects_bad_args(beam_model):
    cfg, params = beam_model
    with pytest.raises(ValueError, match="beam"):
        tbeam.gpt_generate_beam(params, cfg, [1], 2, beam=0)
    with pytest.raises(ValueError, match="empty"):
        tbeam.gpt_generate_beam(params, cfg, [], 2)
    with pytest.raises(ValueError, match="ctx_len"):
        tbeam.gpt_generate_beam(params, cfg, [1] * 15, 5)


def test_sample_greedy_equals_jax(monkeypatch):
    """``sample`` with top_k 1 for 300 tokens at ctx 64: n = 32 tokens a
    chunk, so the context rolls over (a fresh prefill of the last 32 ids)
    before every chunk after the first, nine times in all."""
    jc, jp, tc, tp = both64(monkeypatch, ctx_len=64)
    itos = {i: chr(65 + i) for i in range(jc.vocab_size)}
    ctx = [3, 1, 4, 1, 5, 9, 2, 6]
    calls = []
    real = tgpt.gpt_prefill
    monkeypatch.setattr(ttrainer, "gpt_prefill", lambda *a: calls.append(
        a[-1]) or real(*a))
    want = "".join(jtrainer.sample(jp, jc, ctx, itos, steps=300, top_k=1))
    got = "".join(ttrainer.sample(tp, tc, ctx, itos, steps=300, top_k=1,
                                  seed=1))
    assert len(got) == 300 and got == want
    assert calls[0] == len(ctx) and calls[1:] == [32] * 9


def test_sample_refusals():
    """The JAX sampler's refusal of an unknown quant mode; the windowed
    RoPE/ALiBi stream and the int8 modes (once refused) now sample."""
    itos = {i: chr(65 + i % 26) for i in range(BASE["vocab_size"])}
    kw = dict(BASE, window=8)
    for pos in ("rope", "alibi"):
        tc = tgpt.GPTConfig(pos=pos, **kw)
        out = "".join(ttrainer.sample(tgpt.init_gpt_params(tc), tc, [1],
                                      itos, steps=60, chunk=16))
        assert len(out) == 60
    tc = tgpt.GPTConfig(**BASE)
    for quant in ("int8", "int8kv"):
        assert len("".join(ttrainer.sample(tgpt.init_gpt_params(tc), tc,
                                           [1], itos, steps=5,
                                           quant=quant))) == 5
    with pytest.raises(ValueError, match="unknown quant mode"):
        next(ttrainer.sample(tgpt.init_gpt_params(tc), tc, [1], itos,
                             quant="int4"))
    with pytest.raises(ValueError, match="unknown quant mode"):
        next(jtrainer.sample(jgpt.init_gpt_params(jgpt.GPTConfig(**BASE)),
                             jgpt.GPTConfig(**BASE), [1], itos,
                             quant="int4"))


def tv(counts, p):
    return 0.5 * float(np.abs(counts / counts.sum() - p).sum())


@pytest.mark.parametrize("temperature,top_k,top_p",
                         [(1.0, 0, 0.0), (0.8, 5, 0.0), (1.0, 0, 0.9)])
def test_sample_token_distribution(temperature, top_k, top_p):
    """20,000 draws of ``sample_token`` from one row of logits: total
    variation <= 0.02 from softmax(JAX's ``filter_logits``), and no draw
    outside its support."""
    logits = np.random.default_rng(7).standard_normal((1, 16)).astype(
        np.float32) * 1.5
    z = np.asarray(jgpt.filter_logits(jnp.asarray(logits), temperature,
                                      top_k, top_p))[0]
    p = np.exp(z - z.max())
    p /= p.sum()
    draws = tgpt.sample_token(
        torch.Generator().manual_seed(11),
        torch.from_numpy(np.repeat(logits, 20000, axis=0)), temperature,
        top_k, top_p).numpy()
    counts = np.bincount(draws, minlength=16).astype(np.float64)
    assert counts[p < 1e-12].sum() == 0
    assert tv(counts, p) <= 0.02


def _env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def _run(module, argv, stdin):
    out = subprocess.run([sys.executable, "-m", module, *argv], cwd=REPO,
                         env=_env(), input=stdin, capture_output=True,
                         text=True, timeout=300, check=True)
    return out.stdout


@pytest.mark.parametrize("tokenizer", ["char", "bpe"])
def test_repl_prints_jax_text(tokenizer, tmp_path):
    """A checkpoint trained for 2 steps by the port's CLI; ``--repl
    --top_k 1`` with two prompts on stdin (one longer than ctx_len, so the
    sampler rolls over) prints the same text through the port's CLI
    (``--device cpu``) and the JAX package's, and ``--beam 3`` too."""
    data = tmp_path / "corpus.txt"
    from linalg_tpu_torch.train.data import synthetic_corpus

    data.write_text(synthetic_corpus()[:20000], encoding="utf-8")
    ck = str(tmp_path / "ck")
    from linalg_tpu_torch.apps import gpt as tapp

    tapp.main(["--train", "--tokenizer", tokenizer, "--vocab_size", "300",
               "--steps", "2", "--eval_every", "2", "--d_model", "32",
               "--layers", "2", "--heads", "2", "--ctx_len", "32",
               "--batch_size", "2", "--data", str(data), "--ckpt_dir", ck,
               "--device", "cpu"])
    stdin = ("First Citizen: before we proceed any further, hear me "
             "speak.\nhé\n")
    for extra in ([], ["--beam", "3"]):
        argv = ["--repl", "--ckpt_dir", ck, "--top_k", "1", "--gen_tokens",
                "24", *extra]
        want = _run("linalg_tpu.apps.gpt", argv, stdin)
        got = _run("linalg_tpu_torch.apps.gpt", argv + ["--device", "cpu"],
                   stdin)
        assert got == want
        assert got.count("> ") == 3 and got.rstrip().endswith("bye")
