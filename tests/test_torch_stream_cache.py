"""Ring-mode streaming of the port (linalg_tpu_torch/models/stream.py, the
ring mode of serve/engine.py, the ring stream of train/trainer.py
``sample``) against the JAX package's.

- ``stream_fill``: ring rows, ``rpos`` and ``pos`` EXACT (a copy), for a
  prompt shorter than the window, equal to it and longer.
- Single-stream and per-slot ring chunks in float64 on the CPU, RoPE and
  ALiBi, equal and grouped K/V heads, positions past ``ctx_len``: greedy
  tokens equal; logits and ring rows atol 1e-9 (float64 sums in another
  order) with equal K/V heads, rtol 1e-5 / atol 1e-6 with grouped heads,
  whose decode softmax both packages take in float32. The port gets the
  JAX package's float32 RoPE tables (as tests/test_torch_sample.py does).
- The ring engine against the JAX ring engine, float32 greedy tokens
  EQUAL, with chunked prefill, a registered prefix and ``auto_prefix``,
  budgets running past ``ctx_len``.
- ``sample`` of a windowed model (the ring, no rollover) in float64:
  greedy text equal.
- The ring column of PARITY.md: every refused composition raises the
  same ValueError in both packages, and a composition the JAX engine
  serves outside the ring (int8 weights) is served the same way.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_tpu.models import gpt as jgpt
from linalg_tpu.models import stream as jstream
from linalg_tpu.nn import functional as jF
from linalg_tpu.serve import Request as JRequest
from linalg_tpu.serve import ServeEngine as JEngine
from linalg_tpu.train import trainer as jtrainer
from linalg_tpu_torch.models import gpt as tgpt
from linalg_tpu_torch.models import stream as tstream
from linalg_tpu_torch.serve import Request, ServeEngine
from linalg_tpu_torch.train import trainer as ttrainer

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


BASE = dict(vocab_size=37, d_model=32, n_heads=4, n_layers=2, ctx_len=16)
CFGS = {
    "rope": dict(pos="rope", window=6),
    "alibi": dict(pos="alibi", window=5, ffn="swiglu"),
    "rope_gqa": dict(pos="rope", window=5, n_kv_heads=2),
    "alibi_mqa": dict(pos="alibi", window=7, n_kv_heads=1, ffn="geglu"),
}


def jax_tables(d, pos):
    return tuple(torch.tensor(np.asarray(t)) for t in jF.rope_tables(
        d, np.asarray(pos)))


def both64(monkeypatch, seed=0, **kw):
    """(jax cfg, jax params, port cfg, port params) in float64, the port
    on the JAX package's float32 RoPE tables."""
    kw = dict(BASE, **kw)
    jc, tc = JaxCfg64(**kw), PortCfg64(**kw)
    host = jax.tree.map(lambda a: np.asarray(a, np.float64),
                        jgpt.init_gpt_params(jc, seed=seed))
    for mod in (tgpt, tstream):
        monkeypatch.setattr(mod, "rope_tables", jax_tables)
    return (jc, jax.tree.map(jnp.asarray, host), tc,
            tgpt.params_from_numpy(host))


def tol(cfg):
    if cfg.kv_heads != cfg.n_heads:
        return dict(rtol=1e-5, atol=1e-6)
    return dict(rtol=0, atol=1e-9)


def close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **kw)


@pytest.mark.parametrize("plen", [3, 6, 11])
def test_stream_fill_rows_exact(plen):
    """Ring row j % window holds absolute row j of the prefill; rows
    before the prompt are zero with rpos -1."""
    kw = dict(BASE, pos="rope", window=6, n_kv_heads=2)
    jc, tc = jgpt.GPTConfig(**kw), tgpt.GPTConfig(**kw)
    rng = np.random.default_rng(plen)
    shape = (2, 3, 2, 16, 8)
    k, v = rng.normal(size=shape), rng.normal(size=shape)
    want = jstream.stream_fill(
        jstream.init_stream_cache(jc, 3),
        {"k": jnp.asarray(k, jnp.float32), "v": jnp.asarray(v, jnp.float32)},
        plen, jc)
    got = tstream.stream_fill(
        tstream.init_stream_cache(tc, 3),
        {"k": torch.tensor(k, dtype=torch.float32),
         "v": torch.tensor(v, dtype=torch.float32)}, plen, tc)
    for key in ("k", "v", "rpos", "pos"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    rpos = got["rpos"].numpy()
    assert sorted(rpos[rpos >= 0]) == list(range(max(0, plen - 6), plen))
    assert all(r % 6 == s for s, r in enumerate(rpos) if r >= 0)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_stream_chunk_matches_jax(name, monkeypatch):
    """``gpt_stream_prefill`` of a 7-id prompt (batch 2), then 3 chunks of
    7 greedy tokens: positions reach 28 of a ctx_len of 16. Tokens equal;
    logits and the ring (rows, rpos, pos) agree."""
    jc, jp, tc, tp = both64(monkeypatch, **CFGS[name])
    ids = np.random.default_rng(1).integers(0, jc.vocab_size, (2, 7))
    jl, jring = jstream.gpt_stream_prefill(jp, jnp.asarray(ids), jc)
    tl, tring = tstream.gpt_stream_prefill(tp, torch.from_numpy(ids), tc)
    close(tl, jl, **tol(tc))
    gen = torch.Generator().manual_seed(0)
    for c in range(3):
        jt, jl, jring = jstream.gpt_stream_chunk(
            jp, jring, jl, jax.random.PRNGKey(c), jc, 7, 1.0, 1, 0.0)
        tt, tl, tring = tstream.gpt_stream_chunk(tp, tring, tl, gen, tc, 7,
                                                 1.0, 1, 0.0)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        close(tl, jl, **tol(tc))
    assert int(tring["pos"]) == 28 > tc.ctx_len
    assert tring["k"].shape[3] == tc.window  # O(window) state
    np.testing.assert_array_equal(tring["rpos"].numpy(),
                                  np.asarray(jring["rpos"]))
    close(tring["k"], jring["k"], **tol(tc))
    close(tring["v"], jring["v"], **tol(tc))


def slot_cache(mod, ring_of, prompts, cfg, params, ids_of):
    """A per-slot ring cache (B slots, ragged prompts) from one
    single-stream ring a prompt, in either package."""
    rings, logits = [], []
    for p in prompts:
        lg, ring = mod.gpt_stream_prefill(params, ids_of(p[None]), cfg)
        rings.append(ring)
        logits.append(lg)
    return ring_of(rings, logits)


@pytest.mark.parametrize("name", ["alibi", "rope_gqa"])
def test_stream_chunk_slots_matches_jax(name, monkeypatch):
    """Three slots at ragged positions (prompts of 4, 9 and 13 ids), two
    per-slot ring chunks of 8 greedy tokens, each slot with its own
    temperature: tokens equal, logits and the ring agree."""
    jc, jp, tc, tp = both64(monkeypatch, **CFGS[name])
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, jc.vocab_size, n) for n in (4, 9, 13)]

    def jring_of(rings, logits):
        return ({"k": jnp.concatenate([r["k"] for r in rings], 1),
                 "v": jnp.concatenate([r["v"] for r in rings], 1),
                 "rpos": jnp.stack([r["rpos"] for r in rings]),
                 "pos": jnp.stack([r["pos"] for r in rings])},
                jnp.concatenate(logits))

    def tring_of(rings, logits):
        return ({"k": torch.cat([r["k"] for r in rings], 1),
                 "v": torch.cat([r["v"] for r in rings], 1),
                 "rpos": torch.stack([r["rpos"] for r in rings]),
                 "pos": torch.stack([r["pos"] for r in rings])},
                torch.cat(logits))

    jcache, jl = slot_cache(jstream, jring_of, prompts, jc, jp, jnp.asarray)
    tcache, tl = slot_cache(tstream, tring_of, prompts, tc, tp,
                            torch.from_numpy)
    temp = np.array([1.0, 0.5, 2.0], np.float32)
    top_p = np.zeros(3, np.float32)
    top_k = np.ones(3, np.int32)
    ops = tgpt._dt_decode_ops(tp, tc)
    gen = torch.Generator().manual_seed(0)
    for c in range(2):
        jt, jl, jcache = jstream.stream_chunk_slots(
            jp, jcache, jl, jax.random.PRNGKey(c), temp, top_p, top_k, jc,
            8)
        tt, tl, tcache = tstream.stream_chunk_slots(
            ops, tcache, tl, gen, torch.from_numpy(temp),
            torch.from_numpy(top_p), torch.from_numpy(top_k), tc, 8)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        close(tl, jl, **tol(tc))
    assert tcache["pos"].tolist() == [20, 25, 29]
    np.testing.assert_array_equal(tcache["rpos"].numpy(),
                                  np.asarray(jcache["rpos"]))
    close(tcache["k"], jcache["k"], **tol(tc))


def test_stream_validation():
    with pytest.raises(ValueError, match="window"):
        tstream.init_stream_cache(tgpt.GPTConfig(vocab_size=7, pos="rope"))
    with pytest.raises(ValueError, match="rope"):
        tstream.init_stream_cache(tgpt.GPTConfig(vocab_size=7, window=4))


def test_sample_streams_past_ctx_like_jax(monkeypatch):
    """``sample`` of a windowed RoPE model: 100 greedy tokens from a
    5-id prompt at ctx_len 16 go through the ring (no second prefill) and
    equal the JAX sampler's."""
    jc, jp, tc, tp = both64(monkeypatch, **CFGS["rope_gqa"])
    itos = {i: chr(48 + i) for i in range(jc.vocab_size)}
    calls = []
    real = tgpt.gpt_prefill
    monkeypatch.setattr(ttrainer, "gpt_prefill",
                        lambda *a: calls.append(1) or real(*a))
    ctx = [1, 2, 3, 4, 5]
    want = "".join(jtrainer.sample(jp, jc, ctx, itos, steps=100, top_k=1))
    got = "".join(ttrainer.sample(tp, tc, ctx, itos, steps=100, top_k=1))
    assert got == want and len(got) == 100
    assert len(calls) == 1


# -- the ring engine ---------------------------------------------------------

ENG_KW = dict(vocab_size=31, d_model=64, n_heads=4, n_kv_heads=2,
              n_layers=2, ctx_len=64)
ENGINE_KW = dict(n_slots=3, chunk=4, top_k=1, prefill_window=16)
_JAX = {}


def engine_run(make, request, reqs, prefixes=(), **kw):
    eng = make(**dict(ENGINE_KW, **kw))
    pids = [eng.register_prefix(p) for p in prefixes]
    rids = [eng.submit(request(p, n, prefix_id=None if i is None
                               else pids[i])) for p, n, i in reqs]
    done = {c.request_id: c for c in eng.run()}
    return [(done[r].tokens, done[r].prompt_len) for r in rids], eng


def ring_scenario():
    """Prompts of 3-60 ids (chunked past the 16-id window), budgets of
    5-90 (past ctx_len 64), two of them on registered prefixes."""
    rng = np.random.default_rng(4)
    V = ENG_KW["vocab_size"]
    prefixes = [rng.integers(0, V, 20).tolist()]
    reqs = [(rng.integers(0, V, int(n)).tolist(), int(b), i)
            for n, b, i in ((3, 90, None), (40, 12, None), (60, 30, None),
                            (7, 70, 0), (25, 5, 0), (12, 45, None))]
    return reqs, prefixes


@pytest.mark.parametrize("pos", ["rope", "alibi"])
def test_ring_engine_matches_jax(pos):
    reqs, prefixes = ring_scenario()
    kw = dict(ENG_KW, pos=pos, window=9)
    if pos not in _JAX:
        jc = jgpt.GPTConfig(**kw)
        _JAX[pos] = engine_run(
            lambda **k: JEngine(jgpt.init_gpt_params(jc, seed=5), jc, **k),
            JRequest, reqs, prefixes)[0]
    tc = tgpt.GPTConfig(**kw)
    got, eng = engine_run(
        lambda **k: ServeEngine(tgpt.init_gpt_params(tc, seed=5), tc,
                                device="cpu", **k), Request, reqs, prefixes)
    assert eng._ring and eng._cache["k"].shape[3] == 9
    assert got == _JAX[pos]
    assert [len(t) for t, _ in got] == [n for _, n, _ in reqs]


def test_ring_engine_auto_prefix_matches_jax():
    """``auto_prefix`` in ring mode: the full prompts, matched at submit."""
    reqs, prefixes = ring_scenario()
    full = [((prefixes[0] + p) if i is not None else p, n, None)
            for p, n, i in reqs]
    kw = dict(ENG_KW, pos="rope", window=9)
    jc, tc = jgpt.GPTConfig(**kw), tgpt.GPTConfig(**kw)
    want = engine_run(lambda **k: JEngine(jgpt.init_gpt_params(jc, seed=5),
                                          jc, **k),
                      JRequest, full, prefixes, auto_prefix=True)[0]
    got = engine_run(lambda **k: ServeEngine(
        tgpt.init_gpt_params(tc, seed=5), tc, device="cpu", **k),
        Request, full, prefixes, auto_prefix=True)[0]
    assert got == want
    assert got[3][1] == len(reqs[3][0])  # the suffix: the prefix matched


def both_engines(cfg_kw, **kw):
    """(JAX engine, port engine) or the ValueError message each raised."""
    out = []
    for make in (lambda: JEngine(jgpt.init_gpt_params(
                     jgpt.GPTConfig(**cfg_kw)), jgpt.GPTConfig(**cfg_kw),
                     **kw),
                 lambda: ServeEngine(tgpt.init_gpt_params(
                     tgpt.GPTConfig(**cfg_kw)), tgpt.GPTConfig(**cfg_kw),
                     device="cpu", **kw)):
        try:
            out.append(make())
        except ValueError as e:
            out.append(str(e))
    return out


@pytest.mark.parametrize("feature,kw", [
    ("paged", dict(paged=True, page=8)),
    ("page_cache", dict(page_cache=True)),
    ("lora", dict(max_loras=2)),
    ("kv8", dict(kv8=True)),
    ("speculative", dict(speculative=2)),
    ("quant", dict(quant="int8")),
])
def test_ring_column_refusals_match_jax(feature, kw):
    """PARITY.md's ring column: paged KV, the page cache, LoRA, kv8 and
    speculative decoding raise the same ValueError in both packages; int8
    weights leave ring mode in both (the bounded slot cache serves)."""
    cfg_kw = dict(ENG_KW, pos="alibi", window=9)
    jeng, teng = both_engines(cfg_kw, **kw)
    if feature == "quant":
        assert not jeng._ring and not teng._ring
        assert teng._cache["k"].shape[3] == cfg_kw["ctx_len"]
        return
    assert isinstance(jeng, str) and isinstance(teng, str)
    key = {"paged": "paged KV supports", "page_cache": "requires paged",
           "lora": "multi-LoRA", "kv8": "requires paged",
           "speculative": "speculative serving"}[feature]
    assert key in jeng and key in teng


def test_ring_submit_bounds_only_the_prompt():
    """Ring mode bounds prefix + prompt by ctx_len, not the budget, with
    the JAX engine's refusal past it."""
    cfg_kw = dict(ENG_KW, pos="rope", window=9)
    for eng, req in zip(both_engines(cfg_kw, **ENGINE_KW),
                        (JRequest, Request)):
        eng.submit(req(list(range(30)), 500))
        with pytest.raises(ValueError, match="bounded even in ring mode"):
            eng.submit(req(list(range(65)), 4))
