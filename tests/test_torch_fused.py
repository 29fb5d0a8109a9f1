"""The port's fused LayerNorm kernels (linalg_tpu_torch/nn/fused_layer.py:
K8 ``ln_qkv``, K9 ``ln_ffn``) and their picker against the JAX package's.

Same numpy-seeded inputs through both packages. The JAX kernels run as
tests/test_fused_layer.py runs them, in Pallas interpret mode; on the CPU
the port runs its plain versions (the CUDA kernels' tests are in
tests/test_torch_kernels.py). Tolerances are tests/test_fused_layer.py's
against the unfused composition (float32 sums in another order): ln_qkv
forward atol 2e-5, gradients atol 5e-4 / rtol 1e-4; ln_ffn forward 5e-5,
gradients 1e-3 / 1e-4; ``gpt_loss`` with the picker forced on, loss 1e-5,
gradients 1e-4 / 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from linalg_tpu.models import gpt as jgpt
from linalg_tpu.nn import fused_layer as jfl
from linalg_tpu_torch.models import gpt as tgpt
from linalg_tpu_torch.nn import fused_layer as tfl

torch.set_num_threads(2)


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def qkv_args(B=2, T=256, D=128, seed=0):
    return [rand((B, T, D), seed), rand((D,), seed + 1) * 0.1 + 1.0,
            rand((D,), seed + 2) * 0.1] + [
        rand((D, D), seed + i) / np.sqrt(D) for i in (3, 4, 5)]


def ffn_args(B=2, T=256, D=128, F=256, seed=20):
    return [rand((B, T, D), seed), rand((D,), seed + 1) * 0.1 + 1.0,
            rand((D,), seed + 2) * 0.1, rand((D, F), seed + 3) / np.sqrt(D),
            rand((F,), seed + 4) * 0.1, rand((F, D), seed + 5) / np.sqrt(F),
            rand((D,), seed + 6) * 0.1]


def both(port_fn, jax_fn, args, cots):
    """Outputs and gradients of sum(out_i * cot_i) through the port and
    through the JAX kernel in interpret mode."""
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    outs = port_fn(*ts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    tg = torch.autograd.grad(outs, ts, [torch.tensor(c) for c in cots])

    def loss(*a):
        o = jax_fn(*a)
        o = o if isinstance(o, tuple) else (o,)
        return sum(jnp.sum(x * c) for x, c in zip(o, cots))

    with pltpu.force_tpu_interpret_mode():
        jouts = jax_fn(*(jnp.asarray(a) for a in args))
        jg = jax.grad(loss, argnums=tuple(range(len(args))))(
            *(jnp.asarray(a) for a in args))
    jouts = jouts if isinstance(jouts, tuple) else (jouts,)
    return ([o.detach().numpy() for o in outs], [g.numpy() for g in tg],
            [np.asarray(o) for o in jouts], [np.asarray(g) for g in jg])


class TestLnQKV:
    @pytest.mark.parametrize("B", [2, 4], ids=["B2", "B4_multi_block"])
    def test_forward_and_gradients_match_jax(self, B):
        """All three outputs and all six gradients; B 4 runs the JAX
        kernel over several grid steps (its multi-block accumulation)."""
        args = qkv_args(B=B, seed=7 * B)
        cots = [rand((B, 256, 128), 9 + i) for i in range(3)]
        to, tg, jo, jg = both(tfl.ln_qkv, jfl.ln_qkv, args, cots)
        for a, b in zip(to, jo):
            np.testing.assert_allclose(a, b, atol=2e-5)
        for a, b in zip(tg, jg):
            np.testing.assert_allclose(a, b, atol=5e-4, rtol=1e-4)

    def test_bf16_io(self):
        args = [torch.tensor(a).bfloat16() for a in qkv_args()]
        outs = tfl.ln_qkv(*args)
        assert all(o.dtype == torch.bfloat16 for o in outs)
        with pltpu.force_tpu_interpret_mode():
            jouts = jfl.ln_qkv(*(jnp.asarray(a.float().numpy(), jnp.bfloat16)
                                 for a in args))
        for a, b in zip(outs, jouts):
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32), atol=0.15)


class TestLnFFN:
    def test_forward_and_gradients_match_jax(self):
        args = ffn_args()
        to, tg, jo, jg = both(tfl.ln_ffn, jfl.ln_ffn, args,
                              [rand((2, 256, 128), 30)])
        np.testing.assert_allclose(to[0], jo[0], atol=5e-5)
        for a, b in zip(tg, jg):
            np.testing.assert_allclose(a, b, atol=1e-3, rtol=1e-4)

    def test_bf16_io(self):
        """tests/test_fused_layer.py's bound against the float32
        composition, and the JAX kernel's bf16 output."""
        args = [torch.tensor(a).bfloat16() for a in ffn_args()]
        f = tfl.ln_ffn(*args)
        assert f.dtype == torch.bfloat16
        ref = tfl.ln_ffn(*(a.float() for a in args))
        np.testing.assert_allclose(f.float().numpy(), ref.numpy(), atol=0.15)
        with pltpu.force_tpu_interpret_mode():
            jf = jfl.ln_ffn(*(jnp.asarray(a.float().numpy(), jnp.bfloat16)
                              for a in args))
        np.testing.assert_allclose(f.float().numpy(),
                                   np.asarray(jf, np.float32), atol=0.15)


def test_plain_versions_are_the_functions():
    """On the CPU the autograd Functions are the plain versions, exactly,
    with and without ``plain=True``."""
    x, g, b, wq, wk, wv = (torch.tensor(a) for a in qkv_args(B=1))
    dys = [torch.tensor(rand((1, 256, 128), 40 + i)) for i in range(3)]
    want = tfl.ln_qkv_bwd_ref(x[0], g, b, wq, wk, wv, *(d[0] for d in dys))
    for plain in (False, True):
        xs = [t.clone().requires_grad_(True) for t in (x, g, b, wq, wk, wv)]
        outs = tfl.ln_qkv(*xs, plain=plain)
        for o, w in zip(outs, tfl.ln_qkv_ref(x[0], g, b, wq, wk, wv)):
            torch.testing.assert_close(o[0].detach(), w, rtol=0, atol=0)
        grads = torch.autograd.grad(outs, xs, dys)
        for got, w in zip(grads, want):
            torch.testing.assert_close(got.reshape(w.shape), w, rtol=0,
                                       atol=0)


def test_fused_supported_is_the_jax_rule():
    for args in ((16384, 512, 2048), (16384 + 1, 512, 2048),
                 (16384, 512 + 1, 2048), (100, 512, 2048), (256, 128, 128),
                 (256, 64, 256), (512, 128, 192)):
        assert tfl.fused_supported(*args) == jfl.fused_supported(*args)


def test_gpt_loss_with_fused_forced_matches_jax(monkeypatch):
    """gpt_loss and every gradient with both packages' ``_pick_fused``
    forced on, at tests/test_fused_layer.py's config."""
    kw = dict(vocab_size=17, d_model=128, n_heads=4, n_layers=2, d_ff=256,
              ctx_len=256)
    jcfg, tcfg = jgpt.GPTConfig(**kw), tgpt.GPTConfig(**kw)
    jp = jgpt.init_gpt_params(jcfg, seed=0)
    tp = tgpt.params_from_numpy(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(0)
    x = rng.integers(0, 17, (1, 256)).astype(np.int32)
    y = rng.integers(0, 17, (1, 256)).astype(np.int32)
    calls = []
    monkeypatch.setattr(jgpt, "_pick_fused", lambda B, T, c: True)
    monkeypatch.setattr(tgpt, "_pick_fused",
                        lambda B, T, c, dev: calls.append((B, T)) or True)
    real = tgpt.ln_ffn
    monkeypatch.setattr(tgpt, "ln_ffn", lambda *a: calls.append("ffn")
                        or real(*a))
    with pltpu.force_tpu_interpret_mode():
        jloss, jg = jax.value_and_grad(jgpt.gpt_loss)(
            jp, jnp.asarray(x), jnp.asarray(y), jcfg)
    leaves = [t.requires_grad_(True) for t in jax.tree.leaves(tp)]
    tloss = tgpt.gpt_loss(tp, torch.tensor(x), torch.tensor(y), tcfg)
    tg = torch.autograd.grad(tloss, leaves)
    assert calls == [(1, 256), "ffn", "ffn"]  # the fused path, per layer
    assert abs(float(tloss.detach()) - float(jloss)) < 1e-5
    for a, b in zip(tg, jax.tree.leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-3)


CFGS = {
    "published": dict(vocab_size=65, d_model=512, n_heads=4, n_layers=4,
                      ctx_len=256),
    "gqa": dict(vocab_size=65, d_model=512, n_heads=4, n_kv_heads=2,
                n_layers=1, ctx_len=256),
    "window": dict(vocab_size=65, d_model=512, n_heads=4, n_layers=1,
                   ctx_len=256, window=64),
    "gelu": dict(vocab_size=65, d_model=512, n_heads=4, n_layers=1,
                 ctx_len=256, ffn="gelu"),
    "swiglu": dict(vocab_size=65, d_model=512, n_heads=4, n_layers=1,
                   ctx_len=256, ffn="swiglu"),
    "alibi": dict(vocab_size=65, d_model=512, n_heads=4, n_layers=1,
                  ctx_len=256, pos="alibi"),
    "rope": dict(vocab_size=65, d_model=512, n_heads=4, n_layers=1,
                 ctx_len=256, pos="rope"),
    "d_ff 192": dict(vocab_size=65, d_model=128, n_heads=4, n_layers=1,
                     d_ff=192, ctx_len=256),
}


@pytest.mark.parametrize("name", sorted(CFGS))
@pytest.mark.parametrize("switch", ["", "1", "0"], ids=["unset", "on", "0"])
def test_picker_matches_jax_rule(monkeypatch, name, switch):
    """``_pick_fused`` for device_type="cuda" against the JAX package's
    (its TPU backend) across B, T and LINALG_TPU_FUSED_LN, with
    ``_gpt_trunk``'s own GQA exclusion; never off CUDA."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    if switch:
        monkeypatch.setenv("LINALG_TPU_FUSED_LN", switch)
    else:
        monkeypatch.delenv("LINALG_TPU_FUSED_LN", raising=False)
    kw = CFGS[name]
    jcfg, tcfg = jgpt.GPTConfig(**kw), tgpt.GPTConfig(**kw)
    for B in (1, 3, 64, 128):
        for T in (64, 256, 384):
            want = jgpt._pick_fused(B, T, jcfg)
            assert tgpt._pick_fused(B, T, tcfg, "cuda") == want, (B, T)
            assert not tgpt._pick_fused(B, T, tcfg, "cpu")
