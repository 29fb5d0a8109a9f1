"""Int8 weights and the int8 KV cache of the port
(linalg_tpu_torch/models/quant.py, the kv8 pools of serve/paged.py, the
int8 engines of serve/engine.py, ``sample(quant=...)``) against the JAX
package's, on the CPU.

- ``quantize_weight``, ``_act_quantize``, ``_kv_row_quantize`` and
  ``quantize_gpt_params``: int8 values and scales BIT-equal (both compute
  ``x / s`` in float32 and round half to even).
- ``_ddot`` and ``_qdot`` against JAX's: float32 rtol 1e-6; ``_qdot``'s
  int32 sums exactly equal to numpy's int64 matmul.
- ``gpt_decode_chunk_q`` in both modes, with and without kv8, float32:
  greedy tokens equal, logits rtol 1e-4 / atol 1e-5 (float32 sums of a
  2-layer model in another order).
- The slot and paged int8 engines and the kv8 paged engine: float32
  greedy tokens equal to the JAX engines'; kv8 paged EQUAL to the dense
  int8-KV twin built from ``models.quant``'s pieces.
- ``sample`` with ``int8`` and ``int8kv``: greedy text equal to JAX's.
- PARITY.md's refusals for quant and kv8 raise the same ValueError in
  both packages.

K5/K6 under int8 decode ops on the card: tests/test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_tpu.models import gpt as jgpt
from linalg_tpu.models import quant as jq
from linalg_tpu.nn.cache import fkv_write_slots as jwrite_slots
from linalg_tpu.serve import Request as JRequest
from linalg_tpu.serve import ServeEngine as JEngine
from linalg_tpu.train import trainer as jtrainer
from linalg_tpu_torch.models import gpt as tgpt
from linalg_tpu_torch.models import quant as tq
from linalg_tpu_torch.nn.cache import fkv_write_slots
from linalg_tpu_torch.serve import Request, ServeEngine
from linalg_tpu_torch.serve.paged import init_paged_cache
from linalg_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(2)

CFG_KW = dict(vocab_size=31, d_model=64, n_heads=4, n_kv_heads=2,
              n_layers=2, ctx_len=64)
ENGINE_KW = dict(n_slots=3, chunk=4, top_k=1, prefill_window=16)


def both(seed=7, **over):
    kw = dict(CFG_KW, **over)
    jc, tc = jgpt.GPTConfig(**kw), tgpt.GPTConfig(**kw)
    return (jc, jgpt.init_gpt_params(jc, seed=seed), tc,
            tgpt.init_gpt_params(tc, seed=seed))


def npy(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = npy(v)
    return out


class TestPrimitives:
    def weights(self):
        rng = np.random.default_rng(0)
        w = rng.normal(size=(3, 40, 24)).astype(np.float32)
        # a channel whose max is 127: w / s = w exactly, so the .5 entries
        # test round half to even
        w[0, :6, 0] = [127.0, 0.5, 1.5, 2.5, -0.5, -3.5]
        w[1, :, 1] = 0.0  # an all-zero channel: the 1e-12 scale floor
        return w

    @pytest.mark.parametrize("axis", [-2, -1])
    def test_quantize_weight_bit_equal(self, axis):
        w = self.weights()
        jq_, js = jq.quantize_weight(jnp.asarray(w), axis=axis)
        tq_, ts = tq.quantize_weight(torch.from_numpy(w), axis=axis)
        assert tq_.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq_))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        if axis == -2:
            assert tq_[0, :6, 0].tolist() == [127, 0, 2, 2, 0, -4]

    def test_act_and_kv_row_quantize_bit_equal(self):
        x = self.weights()[..., :16]
        for jfn, tfn in ((jq._act_quantize, tq._act_quantize),
                         (jq._kv_row_quantize, tq._kv_row_quantize)):
            jv, js = jfn(jnp.asarray(x))
            tv, ts = tfn(torch.from_numpy(x))
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))

    def test_ddot_and_qdot_match_jax(self):
        rng = np.random.default_rng(1)
        x = rng.normal(size=(3, 1, 40)).astype(np.float32)
        w = self.weights()[2]
        wq, ws = jq.quantize_weight(jnp.asarray(w))
        twq, tws = torch.tensor(np.asarray(wq)), torch.tensor(np.asarray(ws))
        for jfn, tfn in ((jq._ddot, tq._ddot), (jq._qdot, tq._qdot)):
            want = jfn(jnp.asarray(x), wq, ws)
            got = tfn(torch.from_numpy(x), twq, tws)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)

    def test_qdot_int32_sums_exact(self):
        """The float64 product of int8 operands IS the int32 sum, at the
        widest reduction the models use and past 2^24 (where float32 would
        round)."""
        rng = np.random.default_rng(2)
        K = 4096
        a = rng.integers(-127, 128, (5, K), dtype=np.int8)
        b = rng.integers(-127, 128, (K, 7), dtype=np.int8)
        b[:, 0] = a[0]  # one sum of K * 127^2-scale squares
        exact = a.astype(np.int64) @ b.astype(np.int64)
        assert abs(exact).max() > 2 ** 24
        got = (torch.from_numpy(a).double() @ torch.from_numpy(b).double())
        np.testing.assert_array_equal(got.numpy().astype(np.int64), exact)
        np.testing.assert_array_equal(
            tq._int_dot(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
            exact.astype(np.float32))

    @pytest.mark.parametrize("ffn", ["relu", "swiglu"])
    def test_quantize_gpt_params_bit_equal(self, ffn):
        jc, jp, tc, tp = both(ffn=ffn, pos="learned")
        want = flat(jq.quantize_gpt_params(jp, jc))
        got = flat(tq.quantize_gpt_params(tp, tc))
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)

    def test_quantize_kv_cache_bit_equal(self):
        """The JAX package's prefill cache, quantized by both."""
        jc, jp, _, _ = both()
        ids = np.random.default_rng(3).integers(0, 31, (2, 9))
        _, jcache = jgpt.gpt_prefill(jp, jnp.asarray(ids), jc)
        want = jq.quantize_kv_cache(jcache)
        got = tq.quantize_kv_cache({k: torch.tensor(np.asarray(v))
                                    for k, v in jcache.items()})
        for kv in ("k", "v"):
            for part in ("q", "s"):
                np.testing.assert_array_equal(
                    got[kv][part].numpy(), np.asarray(want[kv][part]))


@pytest.mark.parametrize("mode,kv8,pos", [
    ("deq", False, "sinusoidal"), ("int8", False, "rope"),
    ("deq", True, "rope"), ("int8", True, "sinusoidal")])
def test_decode_chunk_q_matches_jax(mode, kv8, pos):
    """Prefill 6 ids (batch 2), then 2 int8 chunks of 6 greedy tokens."""
    jc, jp, tc, tp = both(pos=pos)
    ids = np.random.default_rng(4).integers(0, 31, (2, 6))
    jl, jcache = jgpt.gpt_prefill(jp, jnp.asarray(ids), jc)
    tl, tcache = tgpt.gpt_prefill(tp, torch.from_numpy(ids), tc)
    if kv8:
        jcache, tcache = jq.quantize_kv_cache(jcache), tq.quantize_kv_cache(
            tcache)
    jqp, tqp = jq.quantize_gpt_params(jp, jc), tq.quantize_gpt_params(tp, tc)
    gen = torch.Generator().manual_seed(0)
    for c in range(2):
        jt, jl, jcache = jq.gpt_decode_chunk_q(
            jqp, jcache, jl, jax.random.PRNGKey(c), jc, 6, 1.0, 1, 0.0,
            mode=mode, kv8=kv8)
        tt, tl, tcache = tq.gpt_decode_chunk_q(tqp, tcache, tl, gen, tc, 6,
                                               1.0, 1, 0.0, mode=mode,
                                               kv8=kv8)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-5)
    assert int(tcache["length"]) == 18
    if kv8:
        assert tcache["k"]["q"].dtype == torch.int8


def test_unknown_mode_raises():
    _, _, tc, tp = both()
    with pytest.raises(ValueError, match="unknown quant decode mode"):
        tq._q_decode_ops(tq.quantize_gpt_params(tp, tc), tc, "int4")


# -- engines -----------------------------------------------------------------

MODES = {
    "slot int8": dict(quant="int8"),
    "paged int8 gather": dict(quant="int8", paged=True, page=8,
                              paged_attn="gather"),
    "paged int8 kernel": dict(quant="int8", paged=True, page=8,
                              paged_attn="kernel"),
    "paged kv8": dict(paged=True, page=8, kv8=True, paged_attn="gather"),
    "paged int8 kv8": dict(quant="int8", paged=True, page=8, kv8=True,
                           paged_attn="gather"),
}
_JAX = {}


def requests():
    rng = np.random.default_rng(5)
    return [(rng.integers(0, 31, int(n)).tolist(), int(b))
            for n, b in ((3, 20), (30, 9), (12, 30), (5, 6), (20, 14))]


def engine_tokens(make, request, **kw):
    eng = make(**dict(ENGINE_KW, **kw))
    ids = [eng.submit(request(p, n)) for p, n in requests()]
    done = {c.request_id: c for c in eng.run()}
    return [done[i].tokens for i in ids], eng


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_matches_jax(mode):
    kw = MODES[mode]
    jkw = dict(kw, paged_attn="gather") if "paged" in kw else kw
    key = tuple(sorted(jkw.items()))
    jc, jp, tc, tp = both()
    if key not in _JAX:
        _JAX[key] = engine_tokens(lambda **k: JEngine(jp, jc, **k), JRequest,
                                  **jkw)[0]
    got, eng = engine_tokens(lambda **k: ServeEngine(tp, tc, device="cpu",
                                                     **k), Request, **kw)
    assert got == _JAX[key]
    if kw.get("kv8"):
        assert eng._cache["pool_k"]["q"].dtype == torch.int8
        held = eng._allocator.n_pages - 1
        assert eng._allocator.n_free == held


def test_kv8_engine_equals_dense_int8_kv_twin():
    """paged kv8 == a dense int8-KV decode from ``models.quant``'s pieces
    (quantized prefill cache, kv8 write and attention), in the port and
    against the same twin in the JAX package."""
    jc, jp, tc, tp = both()
    prompt = np.random.default_rng(6).integers(0, 31, 7).tolist()
    eng = ServeEngine(tp, tc, n_slots=1, chunk=8, top_k=1, paged=True,
                      page=16, kv8=True, device="cpu")
    eng.submit(Request(prompt, 8))
    got = eng.run()[0].tokens
    logits, cache = tgpt.gpt_prefill(tp, torch.tensor([prompt]), tc)
    qc = tq.quantize_kv_cache(cache)
    ops = dict(tgpt._dt_decode_ops(tp, tc), attn=tq._kv8_attn(tc.compute_dtype))
    toks, *_ = tgpt._decode_chunk_core(
        tc, ops, logits, tq._layer_views(qc["k"]), tq._layer_views(qc["v"]),
        torch.tensor([len(prompt)], dtype=torch.int32), 0,
        torch.Generator(), 8, torch.ones((1, 1)), torch.ones(1,
                                                             dtype=torch.int32),
        torch.zeros((1, 1)), tq._kv8_write(fkv_write_slots))
    assert got == toks[0].tolist()
    jl, jcache = jgpt.gpt_prefill(jp, jnp.asarray([prompt]), jc)
    jqc = jq.quantize_kv_cache(jcache)
    jops = dict(jgpt._dt_decode_ops(jp, jc), attn=jq._kv8_attn(jnp.float32))
    jtoks, *_ = jgpt._decode_chunk_core(
        jc, jops, jl, jqc["k"], jqc["v"], jnp.asarray([len(prompt)],
                                                      jnp.int32),
        jnp.zeros((), jnp.int32), jax.random.PRNGKey(0), 8,
        jnp.ones((1, 1), jnp.float32), jnp.ones((1,), jnp.int32),
        jnp.zeros((1, 1), jnp.float32), jq._kv8_write(jwrite_slots))
    assert got == np.asarray(jtoks)[0].tolist()


def test_kv8_pool_bytes():
    """An int8 pool row is d int8 + one f32 scale: (64 + 4) / 256 of an
    f32 row at d_head 64, (64 + 4) / 128 of a bf16 one."""
    cfg = tgpt.GPTConfig(**dict(CFG_KW, d_model=128, n_heads=2))

    def nbytes(c):
        return sum(x.numel() * x.element_size() for k in ("pool_k", "pool_v")
                   for x in (c[k].values() if isinstance(c[k], dict)
                             else [c[k]]))

    full = nbytes(init_paged_cache(cfg, 2, 9, 16))
    q8 = nbytes(init_paged_cache(cfg, 2, 9, 16, kv8=True))
    assert q8 / full == (64 + 4) / 256


@pytest.mark.parametrize("quant", ["int8", "int8kv"])
def test_sample_quant_matches_jax(quant):
    """``sample`` through int8 weights (and an int8 KV cache), 70 greedy
    tokens with a rollover at ctx_len 64."""
    jc, jp, tc, tp = both(pos="rope")
    itos = {i: chr(48 + i) for i in range(31)}
    want = "".join(jtrainer.sample(jp, jc, [1, 2, 3], itos, steps=70,
                                   top_k=1, chunk=16, quant=quant))
    got = "".join(ttrainer.sample(tp, tc, [1, 2, 3], itos, steps=70,
                                  top_k=1, chunk=16, quant=quant))
    assert got == want and len(got) == 70


@pytest.mark.parametrize("kw,key", [
    (dict(kv8=True), "requires paged"),
    (dict(paged=True, page=8, kv8=True, page_cache=True), "page_cache"),
    (dict(paged=True, page=8, kv8=True, paged_attn="kernel"), "kv8"),
    (dict(quant="int8", speculative=2), "speculative"),
    (dict(paged=True, page=8, kv8=True, speculative=2), "speculative"),
    (dict(quant="int4"), "unknown quant mode"),
])
def test_quant_refusals_match_jax(kw, key):
    jc, jp, tc, tp = both()
    with pytest.raises(ValueError, match=key):
        JEngine(jp, jc, **kw)
    with pytest.raises(ValueError, match=key):
        ServeEngine(tp, tc, device="cpu", **kw)
