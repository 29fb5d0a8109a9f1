"""The port's GPT (linalg_tpu_torch/models/gpt.py), its functional ops,
tokenizer and checkpoint reader against the JAX package's.

Same numpy-seeded inputs and the same weights go through both packages
in float32 on the CPU. Tolerances: weights and checkpoints are compared
bit for bit; forward values within 2e-5 relative / 2e-6 absolute unless
a test says otherwise (float32 sums taken in another order); greedy
tokens exactly.
"""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_tpu.models import gpt as jgpt
from linalg_tpu.nn import functional as jF
from linalg_tpu_torch.models import gpt as tgpt
from linalg_tpu_torch.nn import functional as tF
from torch_config_common import jax_fields

torch.set_num_threads(2)

RTOL, ATOL = 2e-5, 2e-6

# (2 layers, d 32, MHA, learned positions) and (d 256, one KV head, gelu);
# the long-context features: RoPE + SwiGLU + GQA + a window of 5 (the
# prompts of 9-12 tokens outgrow it), ALiBi + GeGLU, and a window alone
CFGS = {
    "d32": dict(vocab_size=31, d_model=32, n_heads=2, n_layers=2,
                ctx_len=32, pos="learned"),
    "d256_hk1": dict(vocab_size=29, d_model=256, n_heads=4, n_kv_heads=1,
                     n_layers=2, ctx_len=32, ffn="gelu", d_ff=384),
    "rope_swiglu_gqa_w5": dict(vocab_size=31, d_model=64, n_heads=4,
                               n_kv_heads=2, n_layers=2, ctx_len=32,
                               pos="rope", ffn="swiglu", window=5),
    "alibi_geglu": dict(vocab_size=31, d_model=48, n_heads=3, n_layers=2,
                        ctx_len=32, pos="alibi", ffn="geglu", d_ff=80),
    "window7": dict(vocab_size=31, d_model=32, n_heads=2, n_layers=2,
                    ctx_len=32, window=7),
}


def both(name, seed=5):
    """(jax cfg, jax params, torch cfg, torch params) from one seed."""
    kw = CFGS[name]
    jc, tc = jgpt.GPTConfig(**kw), tgpt.GPTConfig(**kw)
    return (jc, jgpt.init_gpt_params(jc, seed=seed), tc,
            tgpt.init_gpt_params(tc, seed=seed))


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_port_imports_neither_jax_nor_reference():
    """Importing every module of the port loads no JAX and no linalg_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import linalg_tpu_torch as p\n"
        "import linalg_tpu_torch.ops, linalg_tpu_torch.ops.qr_panel\n"
        "import linalg_tpu_torch.train.trainer, linalg_tpu_torch.nn.flash\n"
        "import linalg_tpu_torch.nn.flash_long, linalg_tpu_torch.nn.flash_stream"
        ", linalg_tpu_torch.nn.positional\n"
        "import linalg_tpu_torch.nn.flash_btd, linalg_tpu_torch.nn.fused_layer"
        ", linalg_tpu_torch.kernels.fused_layer\n"
        "import linalg_tpu_torch.parallel, linalg_tpu_torch.parallel.mesh"
        ", linalg_tpu_torch.parallel.ring, linalg_tpu_torch.parallel.ring_pallas"
        ", linalg_tpu_torch.parallel.sharding"
        ", linalg_tpu_torch.kernels.ring_attention\n"
        "import linalg_tpu_torch.nn.losses, linalg_tpu_torch.models.beam"
        ", linalg_tpu_torch.native, linalg_tpu_torch.native.loader"
        ", linalg_tpu_torch.nn.tokenizers, linalg_tpu_torch.apps.gpt\n"
        "import linalg_tpu_torch.models.moe, linalg_tpu_torch.nn.activations"
        ", linalg_tpu_torch.nn.normalization, linalg_tpu_torch.nn.attention"
        ", linalg_tpu_torch.nn.stateful, linalg_tpu_torch.nn.cache"
        ", linalg_tpu_torch.models.transformer"
        ", linalg_tpu_torch.models.gpt_modules"
        ", linalg_tpu_torch.models.seq2seq"
        ", linalg_tpu_torch.apps.reverse_demo\n"
        "for m in pkgutil.walk_packages(p.__path__, 'linalg_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'linalg_tpu' or m.startswith('linalg_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules "
        "if m.startswith('linalg_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert int(out.stdout.strip()) >= 58  # every module was imported


def test_resolve_device_defaults_to_the_card(monkeypatch):
    """No device asked for means ``cuda``; the CPU only when asked for."""
    from linalg_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        resolve_device()


class TestFunctional:
    def test_ops_match_jax(self):
        rng = np.random.default_rng(0)
        x = rng.normal(size=(2, 3, 5, 8)).astype(np.float32)
        g = rng.normal(size=(8,)).astype(np.float32)
        b = rng.normal(size=(8,)).astype(np.float32)
        tx = torch.from_numpy(x)
        pairs = [
            (tF.relu(tx), jF.relu(x)),
            (tF.gelu(tx), jF.gelu(x)),
            (tF.softmax_last(tx), jF.softmax_last(x)),
            (tF.layer_norm(tx, torch.from_numpy(g), torch.from_numpy(b)),
             jF.layer_norm(x, g, b)),
            (tF.causal_mask(6), jF.causal_mask(6)),
            (tF.sinusoidal_encoding(40, 16), jF.sinusoidal_encoding(40, 16)),
        ]
        for got, want in pairs:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("masked", [False, True])
    def test_sdpa_matches_jax(self, masked):
        rng = np.random.default_rng(1)
        q, k, v = (rng.normal(size=(2, 3, 6, 16)).astype(np.float32)
                   for _ in range(3))
        mask = np.array(jF.causal_mask(6)) if masked else None
        got = tF.sdpa(*(torch.from_numpy(a) for a in (q, k, v)),
                      None if mask is None else torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jF.sdpa(q, k, v, mask)),
                                   rtol=RTOL, atol=ATOL)


class TestCache:
    def test_fkv_matches_jax(self):
        from linalg_tpu.nn import cache as jcache
        from linalg_tpu_torch.nn import cache as tcache

        rng = np.random.default_rng(7)
        L, B, h, T, d = 2, 3, 2, 8, 4
        tc = tcache.fkv_init(L, B, h, T, d)
        jc = jcache.fkv_init(L, B, h, T, d, dtype=jnp.float32)
        assert tc["k"].shape == jc["k"].shape and int(tc["length"]) == 0
        assert int(tcache.fkv_advance(tc, 3)["length"]) == 3
        buf = rng.normal(size=(B, h, T, d)).astype(np.float32)
        # a block write at 3, and one whose start clamps to T - t
        for at, t in ((3, 2), (7, 3)):
            new = rng.normal(size=(B, h, t, d)).astype(np.float32)
            got = tcache.fkv_write(torch.tensor(buf), torch.tensor(-buf), at,
                                   torch.tensor(new), torch.tensor(-new))
            want = jcache.fkv_write(jnp.asarray(buf), jnp.asarray(-buf),
                                    jnp.asarray(at), jnp.asarray(new),
                                    jnp.asarray(-new))
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        # per-slot one-row writes: negative positions wrap, large ones clamp
        pos = np.array([2, -1, 11], np.int32)
        new = rng.normal(size=(B, h, 1, d)).astype(np.float32)
        got = tcache.fkv_write_slots(torch.tensor(buf), torch.tensor(-buf),
                                     torch.tensor(pos), torch.tensor(new),
                                     torch.tensor(-new))
        want = jcache.fkv_write_slots(jnp.asarray(buf), jnp.asarray(-buf),
                                      jnp.asarray(pos), jnp.asarray(new),
                                      jnp.asarray(-new))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


class TestParams:
    @pytest.mark.parametrize("name", sorted(CFGS))
    def test_init_bit_equal(self, name):
        _, jp, _, tp = both(name)
        want, got = flat(jp), flat(jax.tree.map(lambda t: t.numpy(), tp))
        assert want.keys() == got.keys()
        for key in want:
            assert got[key].dtype == np.float32
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)

    def test_params_from_numpy(self):
        _, jp, _, tp = both("d32")
        port = tgpt.params_from_numpy(to_np(jp))
        for key, val in flat(jax.tree.map(lambda t: t.numpy(), port)).items():
            np.testing.assert_array_equal(val, flat(jp)[key])
        half = tgpt.params_from_numpy(to_np(jp), dtype=torch.bfloat16)
        assert half["layers"]["Wq"].dtype == torch.bfloat16

    def test_config_validation(self):
        """The JAX package's validation; rope, alibi, the gated FFNs and a
        window construct (and equal the JAX configs field for field), and
        the serving engine takes each of them: a window with RoPE or
        ALiBi in ring mode (an O(window) ring a slot), whose paged form
        raises the JAX engine's ValueError."""
        from linalg_tpu_torch.serve.engine import ServeEngine

        with pytest.raises(ValueError, match="n_kv_heads"):
            tgpt.GPTConfig(vocab_size=8, n_heads=4, n_kv_heads=3)
        with pytest.raises(ValueError, match="dtype"):
            tgpt.GPTConfig(vocab_size=8, dtype="float16")
        with pytest.raises(ValueError, match="window"):
            tgpt.GPTConfig(vocab_size=8, window=0)
        for kw in (dict(pos="rope"), dict(pos="alibi"), dict(ffn="swiglu"),
                   dict(ffn="geglu"), dict(window=4),
                   dict(pos="rope", window=4), dict(pos="alibi", window=4)):
            cfg = tgpt.GPTConfig(vocab_size=8, d_model=16, n_layers=1,
                                 ctx_len=64, **kw)
            assert jax_fields(cfg) == dataclasses.asdict(
                jgpt.GPTConfig(vocab_size=8, d_model=16, n_layers=1,
                               ctx_len=64, **kw))
            params = tgpt.init_gpt_params(cfg)
            if "window" in kw and "pos" in kw:
                eng = ServeEngine(params, cfg, chunk=8, device="cpu")
                assert eng._ring and eng._cache["k"].shape[3] == 4
                with pytest.raises(ValueError, match="paged KV supports"):
                    ServeEngine(params, cfg, chunk=8, paged=True, page=8,
                                device="cpu")
            else:
                for paged in (False, True):
                    ServeEngine(params, cfg, chunk=8, paged=paged, page=8,
                                device="cpu")

    def test_checkpoint_cross_load(self, tmp_path):
        from linalg_tpu.nn.tokenizers import CharTokenizer as JTok
        from linalg_tpu.train.checkpoint import save_ckpt
        from linalg_tpu_torch.train.checkpoint import (load_ckpt,
                                                       load_tokenizer)

        jc, jp, tc, _ = both("d256_hk1")
        text = "abcdefghijklmnopqrstuvwxyz .\n"
        jtok = JTok(text)
        save_ckpt(tmp_path, jp, jc, jtok.stoi, jtok.itos)
        params, cfg, stoi, itos = load_ckpt(tmp_path)
        assert cfg == tc and stoi == jtok.stoi and itos == jtok.itos
        for key, val in flat(jax.tree.map(lambda t: t.numpy(),
                                          params)).items():
            np.testing.assert_array_equal(val, flat(jp)[key], err_msg=key)
        tok = load_tokenizer(tmp_path)
        s = "the quick brown fox, jumps!\n"
        np.testing.assert_array_equal(tok.encode(s), jtok.encode(s))
        assert tok.decode(tok.encode(s)) == jtok.decode(jtok.encode(s))


class TestForward:
    @pytest.mark.parametrize("name", sorted(CFGS))
    def test_gpt_apply_matches_jax(self, name):
        jc, jp, tc, tp = both(name)
        ids = np.random.default_rng(2).integers(0, jc.vocab_size, (2, 12))
        want = np.asarray(jgpt.gpt_apply(jp, jnp.asarray(ids), jc))
        got = tgpt.gpt_apply(tp, torch.from_numpy(ids), tc)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("name", sorted(CFGS))
    def test_gpt_prefill_matches_jax(self, name):
        """Right-padded prefill with a true length: logits at length-1 and
        the ctx-padded grouped K/V."""
        jc, jp, tc, tp = both(name)
        ids = np.zeros((1, 16), np.int64)
        ids[0, :11] = np.random.default_rng(3).integers(0, jc.vocab_size, 11)
        jl, jcache = jgpt.gpt_prefill(jp, jnp.asarray(ids), jc, length=11)
        tl, tcache = tgpt.gpt_prefill(tp, torch.from_numpy(ids), tc,
                                      length=11)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                                   atol=ATOL)
        assert int(tcache["length"]) == 11
        for key in ("k", "v"):
            assert tcache[key].shape == jcache[key].shape
            np.testing.assert_allclose(tcache[key].numpy(),
                                       np.asarray(jcache[key]), rtol=RTOL,
                                       atol=ATOL)

    @pytest.mark.parametrize("name", sorted(CFGS))
    def test_decode_chunk_greedy_tokens_equal(self, name):
        jc, jp, tc, tp = both(name)
        ids = np.random.default_rng(4).integers(0, jc.vocab_size, (2, 9))
        jl, jcache = jgpt.gpt_prefill(jp, jnp.asarray(ids), jc)
        tl, tcache = tgpt.gpt_prefill(tp, torch.from_numpy(ids), tc)
        jt, jl2, _ = jgpt.gpt_decode_chunk(jp, jcache, jl,
                                           jax.random.PRNGKey(0), jc, 12,
                                           top_k=1)
        tt, tl2, tcache2 = tgpt.gpt_decode_chunk(
            tp, tcache, tl, torch.Generator().manual_seed(0), tc, 12,
            top_k=1)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        assert int(tcache2["length"]) == 9 + 12
        # logits of the last step: float32 sums of 12 decode steps
        np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=1e-4,
                                   atol=1e-5)

    @pytest.mark.parametrize("vector", [False, True])
    def test_filter_logits_matches_jax(self, vector):
        rng = np.random.default_rng(5)
        z = rng.normal(scale=3.0, size=(4, 23)).astype(np.float32)
        if vector:
            temp = np.array([[0.5], [1.0], [2.0], [1e-9]], np.float32)
            top_p = np.array([[0.0], [0.9], [0.5], [1.0]], np.float32)
            top_k = np.array([0, 3, 30, 1], np.int32)
            targs = (torch.from_numpy(temp), torch.from_numpy(top_k),
                     torch.from_numpy(top_p))
            jargs = (jnp.asarray(temp), jnp.asarray(top_k), jnp.asarray(top_p))
        else:
            targs = jargs = (0.7, 5, 0.8)
        got = tgpt.filter_logits(torch.from_numpy(z), *targs)
        want = np.asarray(jgpt.filter_logits(jnp.asarray(z), *jargs))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)

    def test_sample_token_follows_filter(self):
        """Sampling draws only tokens the filter keeps, and greedy
        (top_k=1) is the argmax."""
        rng = np.random.default_rng(6)
        z = torch.from_numpy(rng.normal(size=(64, 17)).astype(np.float32))
        gen = torch.Generator().manual_seed(1)
        tok = tgpt.sample_token(gen, z, temperature=1.0, top_k=3)
        top3 = torch.topk(z, 3, dim=-1).indices
        assert bool((top3 == tok[:, None]).any(-1).all())
        np.testing.assert_array_equal(
            tgpt.sample_token(gen, z, top_k=1).numpy(),
            z.argmax(-1).numpy())
