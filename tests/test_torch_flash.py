"""The port's hand-derived backwards (linalg_tpu_torch/nn/functional.py),
flash attention (nn/flash.py, nn/flash_long.py, their plain versions on
the CPU) and attention picker against the JAX package's.

Same numpy-seeded inputs through both packages. The functional ops run in
float64 (tests/conftest.py turns on x64 for JAX): forwards and gradients
agree to rtol 1e-10, the order of float64 sums. The flash kernels run as
tests/test_flash.py runs them, in Pallas interpret mode, in float32:
forward atol 1e-5 and gradients atol 2e-5, the tolerances that file holds
them to against the exact sdpa (float32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from linalg_tpu.nn import functional as jF
from linalg_tpu.nn.flash import flash_attention as j_flash
from linalg_tpu.nn.flash_long import flash_attention_long as j_flash_long
from linalg_tpu_torch.models import gpt as tgpt
from linalg_tpu_torch.nn import functional as tF
from linalg_tpu_torch.nn.flash import FLASH_MAX_T, flash_attention
from linalg_tpu_torch.nn.flash_long import LONG_MAX_T, flash_attention_long

torch.set_num_threads(2)

F64_RTOL = 1e-10


def rand(shape, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def torch_vjp(fn, args, cot):
    """(output, grads of <fn(args), cot>) through torch autograd."""
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, torch.tensor(cot))
    return out.detach().numpy(), [g.numpy() for g in grads]


def jax_vjp(fn, args, cot):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


class TestFunctionalGradients:
    """Each autograd.Function against the JAX custom_vjp it ports."""

    @pytest.mark.parametrize("name", ["relu", "gelu"])
    def test_activation(self, name):
        x = rand((3, 5, 8), 0)
        cot = rand(x.shape, 1)
        tout, tg = torch_vjp(getattr(tF, name), [x], cot)
        jout, jg = jax_vjp(getattr(jF, name), [x], cot)
        np.testing.assert_allclose(tout, jout, rtol=F64_RTOL)
        np.testing.assert_allclose(tg[0], jg[0], rtol=F64_RTOL)

    def test_layer_norm(self):
        args = [rand((2, 3, 16), 2), rand((16,), 3), rand((16,), 4)]
        cot = rand((2, 3, 16), 5)
        tout, tg = torch_vjp(tF.layer_norm, args, cot)
        jout, jg = jax_vjp(jF.layer_norm, args, cot)
        np.testing.assert_allclose(tout, jout, rtol=F64_RTOL)
        for a, b in zip(tg, jg):
            np.testing.assert_allclose(a, b, rtol=F64_RTOL, atol=1e-13)

    @pytest.mark.parametrize("masked", [False, True])
    def test_sdpa(self, masked):
        q, k, v = (rand((2, 3, 6, 8), s) for s in (6, 7, 8))
        cot = rand((2, 3, 6, 8), 9)
        mask = np.asarray(jF.causal_mask(6, dtype=jnp.float64)) if masked \
            else None
        tmask = None if mask is None else torch.tensor(mask)
        tout, tg = torch_vjp(lambda q, k, v: tF.sdpa(q, k, v, tmask),
                             [q, k, v], cot)
        jout, jg = jax_vjp(lambda q, k, v: jF.sdpa(q, k, v, mask),
                           [q, k, v], cot)
        np.testing.assert_allclose(tout, jout, rtol=F64_RTOL)
        for a, b in zip(tg, jg):
            np.testing.assert_allclose(a, b, rtol=F64_RTOL, atol=1e-13)

    def test_no_graph_without_grad(self):
        """Inference takes the plain forward: same values, no graph."""
        x = torch.tensor(rand((4, 8), 10))
        g, b = torch.ones(8, dtype=torch.float64), torch.zeros(
            8, dtype=torch.float64)
        for y in (tF.relu(x), tF.gelu(x), tF.layer_norm(x, g, b),
                  tF.sdpa(x[None], x[None], x[None])):
            assert y.grad_fn is None


def run_flash(port_fn, jax_fn, T, causal, seed, shape=(1, 2, None, 16)):
    """Forward and gradients of <fn(q, k, v), dO> in float32 through the
    port and through the JAX kernel in interpret mode."""
    B, h, _, d = shape
    args = [rand((B, h, T, d), seed + i, np.float32) for i in range(3)]
    cot = rand((B, h, T, d), seed + 3, np.float32)
    tout, tg = torch_vjp(lambda q, k, v: port_fn(q, k, v, causal), args, cot)
    with pltpu.force_tpu_interpret_mode():
        jout, jg = jax_vjp(lambda q, k, v: jax_fn(q, k, v, causal), args,
                           cot)
    return tout, tg, jout, jg


def assert_flash_close(tout, tg, jout, jg):
    np.testing.assert_allclose(tout, jout, atol=1e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, atol=2e-5)


class TestFlash:
    @pytest.mark.parametrize("causal", [True, False],
                             ids=["causal", "full"])
    @pytest.mark.parametrize("port_fn,jax_fn,T",
                             [(flash_attention, j_flash, 128),
                              (flash_attention_long, j_flash_long, 512)],
                             ids=["flash", "flash_long"])
    def test_matches_jax_kernel(self, port_fn, jax_fn, T, causal):
        assert_flash_close(*run_flash(port_fn, jax_fn, T, causal, seed=T))

    def test_ragged_T_through_padding(self):
        """T 200 right-padded to 256 by the picker's wrapper against JAX's
        sdpa with the causal mask (which tests/test_flash.py holds equal to
        the kernels): the padded rows and keys are inert."""
        T = 200
        args = [rand((1, 2, T, 16), 20 + i, np.float32) for i in range(3)]
        cot = rand((1, 2, T, 16), 23, np.float32)
        padded = tgpt._padded_attn(flash_attention, T, 256)
        tout, tg = torch_vjp(lambda q, k, v: padded(q, k, v, None), args,
                             cot)
        mask = jF.causal_mask(T, dtype=jnp.float32)
        jout, jg = jax_vjp(lambda q, k, v: jF.sdpa(q, k, v, mask), args, cot)
        assert_flash_close(tout, tg, jout, jg)

    def test_long_contract(self):
        q = torch.zeros(1, 1, 300, 16)
        with pytest.raises(ValueError, match="256"):
            flash_attention_long(q, q, q)
        assert (FLASH_MAX_T, LONG_MAX_T) == (1024, 8192)


class TestPicker:
    """``_pick_attn`` as a table: device type, T and d_head -> choice."""

    @pytest.mark.parametrize("T", [64, 511, 1024, 2048, 5000])
    def test_off_cuda_is_sdpa(self, T):
        assert tgpt._pick_attn(T, 128, "cpu") is tF.sdpa

    @pytest.mark.parametrize("T,d_head,kernel", [
        (256, 128, None),
        (511, 64, None),
        (512, 128, "flash_attention"),
        (1000, 128, "flash_attention"),  # padded to 1024
        (1024, 128, "flash_attention"),
        (1024, 32, "flash_attention"),
        (2048, 64, "flash_attention_long"),
        (3000, 128, "flash_attention_long"),  # padded to 3072
        (4096, 128, "flash_attention_long"),
        (1024, 16, None),  # d_heads the kernels do not take
        (2048, 96, None),
    ])
    def test_on_cuda(self, T, d_head, kernel, monkeypatch):
        """None means the rematted sdpa. A kernel pick is called on CPU
        tensors with the kernels' entry points recorded, so the choice and
        the padded length show without a card."""
        seen = []
        for name in ("flash_attention", "flash_attention_long"):
            monkeypatch.setattr(tgpt, name, lambda q, k, v, c, _n=name:
                                seen.append((_n, q.shape[-2])) or q)
        fn = tgpt._pick_attn(T, d_head, "cuda")
        if kernel is None:
            assert fn is tgpt._REMAT_SDPA
            return
        q = torch.zeros(1, 1, T, d_head)
        assert fn(q, q, q, None).shape == q.shape
        assert seen == [(kernel, -(-T // 256) * 256)]

    def test_beyond_4096_raises(self):
        with pytest.raises(NotImplementedError, match="item 4"):
            tgpt._pick_attn(4097, 128, "cuda")

    def test_cfg_pick_follows_d_head(self):
        cfg = tgpt.GPTConfig(vocab_size=65, d_model=1024, n_heads=8,
                             n_layers=1, ctx_len=1024)
        assert tgpt._pick_attn_cfg(cfg, 1024, "cpu") is tF.sdpa
        assert tgpt._pick_attn_cfg(cfg, 256, "cuda") is tgpt._REMAT_SDPA

    def test_remat_sdpa_gradients_equal_sdpa(self):
        """The rematted sdpa recomputes P in the backward: same values and
        gradients as sdpa, bit for bit."""
        args = [rand((2, 2, 8, 4), 30 + i) for i in range(3)]
        cot = rand((2, 2, 8, 4), 33)
        mask = tF.causal_mask(8, dtype=torch.float64)
        a = torch_vjp(lambda q, k, v: tgpt._REMAT_SDPA(q, k, v, mask), args,
                      cot)
        b = torch_vjp(lambda q, k, v: tF.sdpa(q, k, v, mask), args, cot)
        np.testing.assert_array_equal(a[0], b[0])
        for x, y in zip(a[1], b[1]):
            np.testing.assert_array_equal(x, y)
