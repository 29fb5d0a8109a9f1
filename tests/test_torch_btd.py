"""The port's (B, T, H*d) attention (linalg_tpu_torch/nn/flash_btd.py, K7)
and its picker against the JAX package's.

Same numpy-seeded inputs through both packages, in float32. The JAX
kernel runs as tests/test_flash_btd.py runs it, in Pallas interpret mode;
on the CPU the port runs its plain versions (the CUDA kernels' tests are
in tests/test_torch_kernels.py). Tolerances are tests/test_flash_btd.py's
against the exact sdpa: forward atol 1e-5, gradients 2e-5 (float32 sums
in another order); ``gpt_loss`` with the picker forced on, loss 1e-5 and
gradients atol 1e-4 / rtol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from linalg_tpu.models import gpt as jgpt
from linalg_tpu.nn.flash_btd import attention_btd as j_btd
from linalg_tpu.nn.flash_btd import btd_supported as j_supported
from linalg_tpu_torch.models import gpt as tgpt
from linalg_tpu_torch.nn.flash_btd import (attention_btd, attention_btd_ref,
                                           btd_bwd_ref, btd_fwd_ref,
                                           btd_supported)

torch.set_num_threads(2)

SHAPES = [(2, 64, 2, 128), (3, 128, 4, 128)]


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def port_vjp(fn, args, cot):
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, torch.tensor(cot))
    return out.detach().numpy(), [g.numpy() for g in grads]


def jax_vjp(fn, args, cot):
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
        grads = vjp(jnp.asarray(cot))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("B,T,H,d", SHAPES)
class TestAttentionBTD:
    def test_forward_and_grads_match_jax(self, B, T, H, d):
        args = [rand((B, T, H * d), s) for s in (0, 1, 2)]
        cot = rand((B, T, H * d), 3)
        tout, tg = port_vjp(lambda q, k, v: attention_btd(q, k, v, H), args,
                            cot)
        jout, jg = jax_vjp(lambda q, k, v: j_btd(q, k, v, H, True), args,
                           cot)
        np.testing.assert_allclose(tout, jout, atol=1e-5)
        for a, b in zip(tg, jg):
            np.testing.assert_allclose(a, b, atol=2e-5)

    def test_causality(self, B, T, H, d):
        q, k, v = (torch.tensor(rand((B, T, H * d), s)) for s in (6, 7, 8))
        k2, v2 = k.clone(), v.clone()
        k2[:, T // 2:] = 99.0
        v2[:, T // 2:] = -7.0
        o1 = attention_btd(q, k, v, H)
        o2 = attention_btd(q, k2, v2, H)
        torch.testing.assert_close(o1[:, :T // 2], o2[:, :T // 2], rtol=0,
                                   atol=1e-5)

    def test_plain_versions_are_the_function(self, B, T, H, d):
        """The autograd Function on the CPU is the plain versions, exactly;
        L is (B, H, T) float32."""
        q, k, v, do = (torch.tensor(rand((B, T, H * d), s))
                       for s in (10, 11, 12, 13))
        o, L = btd_fwd_ref(q, k, v, H)
        assert L.shape == (B, H, T) and L.dtype == torch.float32
        want = btd_bwd_ref(q, k, v, o, L, do, H)
        for fn in (attention_btd, attention_btd_ref):
            xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
            out = fn(*xs, H)
            out.backward(do)
            torch.testing.assert_close(out.detach(), o, rtol=0, atol=0)
            for x, w in zip(xs, want):
                torch.testing.assert_close(x.grad, w, rtol=0, atol=0)


def test_bf16_io():
    """bf16 in, bf16 out, within bf16's rounding of the float32 result."""
    B, T, H, d = 2, 64, 2, 128
    args = [rand((B, T, H * d), s) for s in (20, 21, 22)]
    o16 = attention_btd(*(torch.tensor(a).bfloat16() for a in args), H)
    assert o16.dtype == torch.bfloat16
    o32 = attention_btd(*(torch.tensor(a).bfloat16().float() for a in args),
                        H)
    torch.testing.assert_close(o16.float(), o32, rtol=0, atol=2e-2)


def test_supported_gate():
    """The JAX gate's cases, plus the kernels' terms: d_head 256 passes
    both (the kernels take widths up to 256); T must fill 64-row tiles."""
    for args in ((4, 256, 512, 4), (4, 256, 512, 8), (4, 2048, 512, 4),
                 (2, 64, 256, 2), (3, 128, 512, 4), (4, 256, 512, 2)):
        assert btd_supported(*args) == j_supported(*args), args
    assert j_supported(4, 256, 512, 2) and btd_supported(4, 256, 512, 2)
    assert j_supported(4, 40, 256, 2) and not btd_supported(4, 40, 256, 2)


def test_gpt_loss_with_btd_forced_matches_jax(monkeypatch):
    """gpt_loss and every gradient with both packages' btd picker forced
    on, at tests/test_flash_btd.py's config."""
    kw = dict(vocab_size=19, d_model=256, n_heads=2, n_layers=2, ctx_len=32)
    jcfg, tcfg = jgpt.GPTConfig(**kw), tgpt.GPTConfig(**kw)
    jp = jgpt.init_gpt_params(jcfg, seed=0)
    tp = tgpt.params_from_numpy(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(0)
    x = rng.integers(0, 19, size=(2, 32)).astype(np.int32)
    y = rng.integers(0, 19, size=(2, 32)).astype(np.int32)

    monkeypatch.setattr(jgpt, "_pick_attn_btd", lambda B, T, c: (
        lambda q, k, v: j_btd(q, k, v, c.n_heads, True)))
    seen = []

    def forced(B, T, c, device_type):
        seen.append((B, T))
        return lambda q, k, v: attention_btd(q, k, v, c.n_heads, True)

    monkeypatch.setattr(tgpt, "_pick_attn_btd", forced)
    with pltpu.force_tpu_interpret_mode():
        jloss, jg = jax.value_and_grad(jgpt.gpt_loss)(
            jp, jnp.asarray(x), jnp.asarray(y), jcfg)
    leaves = [t.requires_grad_(True) for t in jax.tree.leaves(tp)]
    tloss = tgpt.gpt_loss(tp, torch.tensor(x), torch.tensor(y), tcfg)
    tg = torch.autograd.grad(tloss, leaves)
    assert seen == [(2, 32)]
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               atol=1e-5)
    for a, b in zip(tg, jax.tree.leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-3)


CFGS = {
    "published": dict(vocab_size=65, d_model=512, n_heads=4, n_layers=4,
                      ctx_len=256),
    "d_head 64": dict(vocab_size=65, d_model=512, n_heads=8, n_layers=1,
                      ctx_len=256),
    "gqa": dict(vocab_size=65, d_model=512, n_heads=4, n_kv_heads=2,
                n_layers=1, ctx_len=256),
    "window": dict(vocab_size=65, d_model=512, n_heads=4, n_layers=1,
                   ctx_len=256, window=64),
    "alibi": dict(vocab_size=65, d_model=512, n_heads=4, n_layers=1,
                  ctx_len=256, pos="alibi"),
    "rope": dict(vocab_size=65, d_model=512, n_heads=4, n_layers=1,
                 ctx_len=256, pos="rope"),
    "swiglu": dict(vocab_size=65, d_model=512, n_heads=4, n_layers=1,
                   ctx_len=256, ffn="swiglu"),
}


@pytest.mark.parametrize("name", sorted(CFGS))
@pytest.mark.parametrize("force", ["", "0", "1"], ids=["auto", "off", "on"])
def test_picker_matches_jax_rule(monkeypatch, name, force):
    """``_pick_attn_btd`` (with ``_gpt_trunk``'s exclusions) against the
    JAX package's for device_type="cuda" (the JAX rule read with its TPU
    backend), across B, T, and LINALG_TPU_BTD_ATTN."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    if force:
        monkeypatch.setenv("LINALG_TPU_BTD_ATTN", force)
    else:
        monkeypatch.delenv("LINALG_TPU_BTD_ATTN", raising=False)
    kw = CFGS[name]
    jcfg, tcfg = jgpt.GPTConfig(**kw), tgpt.GPTConfig(**kw)
    gated = (kw.get("pos") != "alibi" and "n_kv_heads" not in kw
             and "window" not in kw)  # _gpt_trunk's own exclusions
    for B in (1, 64, 127, 128, 256):
        for T in (128, 256, 384, 512):
            want = gated and jgpt._pick_attn_btd(B, T, jcfg) is not None
            got = gated and tgpt._pick_attn_btd(B, T, tcfg,
                                                "cuda") is not None
            assert got == want, (B, T)
            assert tgpt._pick_attn_btd(B, T, tcfg, "cpu") is None
