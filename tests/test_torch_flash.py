"""The port's hand-derived backwards (linalg_tpu_torch/nn/functional.py),
flash attention (nn/flash.py, nn/flash_long.py, their plain versions on
the CPU) and attention picker against the JAX package's. The streaming
kernel K4 (nn/flash_stream.py) has its own file, tests/test_torch_stream.py.

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
from linalg_tpu_torch.kernels.flash_attention import reads_in_place
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

    @pytest.mark.parametrize("name", ["relu", "gelu", "silu"])
    def test_activation(self, name):
        x = rand((3, 5, 8), 0)
        cot = rand(x.shape, 1)
        tout, tg = torch_vjp(getattr(tF, name), [x], cot)
        jout, jg = jax_vjp(getattr(jF, name), [x], cot)
        np.testing.assert_allclose(tout, jout, rtol=F64_RTOL)
        np.testing.assert_allclose(tg[0], jg[0], rtol=F64_RTOL)

    @pytest.mark.parametrize("name", ["swiglu", "geglu"])
    def test_gated_unit(self, name):
        """The product-rule backward of f(a) * g, both branches."""
        args = [rand((3, 5, 8), 40), rand((3, 5, 8), 41)]
        cot = rand((3, 5, 8), 42)
        tout, tg = torch_vjp(getattr(tF, name), args, cot)
        jout, jg = jax_vjp(getattr(jF, name), args, cot)
        np.testing.assert_allclose(tout, jout, rtol=F64_RTOL)
        for a, b in zip(tg, jg):
            np.testing.assert_allclose(a, b, rtol=F64_RTOL, atol=1e-13)

    @pytest.mark.parametrize("name", ["layer_norm", "rms_norm"])
    def test_layer_norm(self, name):
        """LayerNorm and RMSNorm (its corrected /rms term) with the
        gradients of x and gamma (and beta)."""
        n_args = 3 if name == "layer_norm" else 2
        args = [rand((2, 3, 16), 2), rand((16,), 3), rand((16,), 4)][:n_args]
        cot = rand((2, 3, 16), 5)
        tout, tg = torch_vjp(getattr(tF, name), args, cot)
        jout, jg = jax_vjp(getattr(jF, name), args, cot)
        np.testing.assert_allclose(tout, jout, rtol=F64_RTOL)
        for a, b in zip(tg, jg):
            np.testing.assert_allclose(a, b, rtol=F64_RTOL, atol=1e-13)

    def test_rope_rotate(self):
        """The rotation and its autograd gradient against jax.vjp, on the
        same float64 tables."""
        c, s = (np.asarray(t) for t in jF.rope_tables(
            8, np.arange(6), dtype=jnp.float64))
        x, cot = rand((2, 3, 6, 8), 50), rand((2, 3, 6, 8), 51)
        tout, tg = torch_vjp(lambda x: tF.rope_rotate(
            x, torch.tensor(c), torch.tensor(s)), [x], cot)
        jout, jg = jax_vjp(lambda x: jF.rope_rotate(x, c, s), [x], cot)
        np.testing.assert_allclose(tout, jout, rtol=F64_RTOL)
        np.testing.assert_allclose(tg[0], jg[0], rtol=F64_RTOL, atol=1e-13)

    @pytest.mark.parametrize("d_head,positions", [
        (8, np.arange(64)), (128, np.arange(4096)),
        (16, np.array([[3], [40]]))], ids=["d8", "d128_T4096", "decode"])
    def test_rope_tables(self, d_head, positions):
        """float32 tables: the angles agree bit for bit; PyTorch's and
        XLA's float32 cos/sin differ by at most one ulp (6e-8)."""
        tc, ts = tF.rope_tables(d_head, torch.from_numpy(positions))
        jc, js = jF.rope_tables(d_head, positions)
        assert tc.shape == jc.shape and tc.dtype == torch.float32
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                                   atol=6e-8)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                                   atol=6e-8)

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
        for y in (tF.relu(x), tF.gelu(x), tF.silu(x), tF.swiglu(x, x),
                  tF.geglu(x, x), tF.layer_norm(x, g, b), tF.rms_norm(x, g),
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

    def test_transposed_head_views_pass_uncopied(self):
        """The model's head split hands (B, T, h, d) projections over as
        transposed (B, h, T, d) views; the kernels read those in place, so
        flash_attention copies none of them (``reads_in_place``). Output and
        gradients on the views equal the contiguous call's and JAX's K2 in
        interpret mode."""
        T, causal = 128, True
        btd = [rand((1, T, 2, 16), 40 + i, np.float32) for i in range(3)]
        cot = rand((1, 2, T, 16), 43, np.float32)
        views = [torch.tensor(a).transpose(1, 2) for a in btd]
        assert all(not t.is_contiguous() and reads_in_place(t)
                   for t in views)
        vout, vg = torch_vjp(lambda q, k, v: flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal), btd, cot)
        vg = [g.transpose(0, 2, 1, 3) for g in vg]  # to (B, h, T, d)
        heads = [np.ascontiguousarray(a.transpose(0, 2, 1, 3)) for a in btd]
        tout, tg = torch_vjp(lambda q, k, v: flash_attention(q, k, v, causal),
                             heads, cot)
        np.testing.assert_allclose(vout, tout, rtol=0, atol=1e-6)
        for a, b in zip(vg, tg):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        with pltpu.force_tpu_interpret_mode():
            jout, jg = jax_vjp(lambda q, k, v: j_flash(q, k, v, causal),
                               heads, cot)
        assert_flash_close(vout, vg, jout, jg)

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
        # d_heads between the kernels' widths: zero-padded inside
        (1024, 16, "flash_attention"),
        (2048, 96, "flash_attention_long"),
        (1024, 4, None),  # d_heads the kernels do not take
        (1024, 512, None),
        # JAX's rule (linalg_tpu/models/gpt.py:444): every d_head >= 8 to
        # the kernels; 160 zero-padded to 256
        (2048, 256, "flash_attention_long"),
        (1024, 160, "flash_attention"),
        (1024, 256, "flash_attention"),
        (8192, 160, "flash_attention_stream"),
        (8192, 256, "flash_attention_stream"),
    ])
    def test_on_cuda(self, T, d_head, kernel, monkeypatch):
        """None means the rematted sdpa. A kernel pick is called on CPU
        tensors with the kernels' entry points recorded, so the choice and
        the padded length show without a card."""
        seen = []
        for name in ("flash_attention", "flash_attention_long",
                     "flash_attention_stream"):
            monkeypatch.setattr(tgpt, name, lambda q, k, v, c, _n=name:
                                seen.append((_n, q.shape[-2])) or q)
        fn = tgpt._pick_attn(T, d_head, "cuda")
        if kernel is None:
            assert fn is tgpt._REMAT_SDPA
            return
        q = torch.zeros(1, 1, T, d_head)
        assert fn(q, q, q, None).shape == q.shape
        assert seen == [(kernel, -(-T // 256) * 256)]

    def test_beyond_4096_raises(self, monkeypatch):
        """Past T 4096 the picker streams (K4): T 4097 right-padded to
        4352, grouped K/V handed over as they are (``gqa_native``)."""
        seen = []
        monkeypatch.setattr(tgpt, "flash_attention_stream",
                            lambda q, k, v, c: seen.append(
                                (q.shape[-2], k.shape[1])) or q)
        fn = tgpt._pick_attn(4097, 128, "cuda")
        assert fn.gqa_native
        q, k = torch.zeros(1, 4, 4097, 128), torch.zeros(1, 2, 4097, 128)
        assert fn(q, k, k, None).shape == q.shape
        assert seen == [(4352, 2)]
        assert not tgpt._pick_attn(4096, 128, "cuda").gqa_native

    def test_cfg_pick_follows_d_head(self):
        cfg = tgpt.GPTConfig(vocab_size=65, d_model=1024, n_heads=8,
                             n_layers=1, ctx_len=1024)
        assert tgpt._pick_attn_cfg(cfg, 1024, "cpu") is tF.sdpa
        assert tgpt._pick_attn_cfg(cfg, 256, "cuda") is tgpt._REMAT_SDPA

    @pytest.mark.parametrize("kw,device,T,want", [
        (dict(pos="alibi"), "cuda", 2048, None),
        (dict(pos="alibi"), "cpu", 64, None),
        (dict(window=512), "cpu", 4096, None),
        (dict(window=512), "cuda", 511, None),
        (dict(window=512, d_model=384), "cuda", 1024, 1024),  # d_head 96
        (dict(window=512, d_model=1024), "cuda", 1024, 1024),  # d_head 256
        (dict(window=512, d_model=2048), "cuda", 1024, None),  # d_head 512
        (dict(window=512), "cuda", 4096, 4096),
        (dict(window=300, pos="rope"), "cuda", 1000, 1024),
        (dict(window=64, n_kv_heads=1), "cuda", 8192, 8192),
    ])
    def test_cfg_pick_alibi_and_window(self, kw, device, T, want,
                                       monkeypatch):
        """ALiBi always takes the rematted sdpa; a window takes the band
        through flash_attention_stream on CUDA from T 512 (ragged T padded
        to 256, grouped K/V in place), else the rematted sdpa with the band
        in its mask. ``want`` is the stream's T, None the rematted sdpa."""
        seen = []
        monkeypatch.setattr(tgpt, "flash_attention_stream",
                            lambda q, k, v, c, window: seen.append(
                                (q.shape[-2], k.shape[1], c, window)) or q)
        cfg = tgpt.GPTConfig(**dict(dict(vocab_size=65, d_model=512,
                                          n_heads=4, n_layers=1,
                                          ctx_len=8192), **kw))
        fn = tgpt._pick_attn_cfg(cfg, T, device)
        if want is None:
            assert fn is tgpt._REMAT_SDPA
            return
        assert fn.gqa_native
        q = torch.zeros(1, 4, T, 128)
        k = torch.zeros(1, cfg.kv_heads, T, 128)
        assert fn(q, k, k, None).shape == q.shape
        assert seen == [(want, cfg.kv_heads, True, cfg.window)]

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


@pytest.mark.parametrize("window", [None, 200], ids=["causal", "window200"])
@pytest.mark.parametrize("d_model,heads", [(32, 2), (48, 1)],
                         ids=["d_head16", "d_head48"])
def test_narrow_heads_take_the_flash_path(d_model, heads, window,
                                          monkeypatch):
    """The CUDA pick for a d_head between the kernels' widths (the JAX
    rule sends every d_head >= 8 to its kernels) is the flash path, run
    here through its plain versions on CPU tensors: each head is
    zero-padded to the next width (16 -> 32, 48 -> 64) with the scale of
    its own width, and gpt_loss and every gradient equal the sdpa's."""
    from linalg_tpu_torch.nn import flash as nn_flash
    from linalg_tpu_torch.train.optim import tree_leaves

    widths = []
    real = nn_flash.flash_fwd
    monkeypatch.setattr(nn_flash, "flash_fwd", lambda q, *a: widths.append(
        q.shape[-1]) or real(q, *a))
    cfg = tgpt.GPTConfig(vocab_size=13, d_model=d_model, n_heads=heads,
                         n_layers=2, ctx_len=512, window=window)
    attn = tgpt._pick_attn_cfg(cfg, 512, "cuda")
    assert attn is not tgpt._REMAT_SDPA
    rng = np.random.default_rng(heads)
    x, y = (torch.tensor(rng.integers(0, 13, (2, 512))) for _ in range(2))
    out = []
    for fn in (attn, tF.sdpa):
        p = tgpt.init_gpt_params(cfg, seed=0)
        leaves = tree_leaves(p)
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss = tgpt.gpt_loss(p, x, y, cfg, attn_fn=fn)
        out.append((float(loss.detach()), torch.autograd.grad(loss, leaves)))
    assert widths == [32 if cfg.d_head == 16 else 64] * cfg.n_layers
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-6)
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)
