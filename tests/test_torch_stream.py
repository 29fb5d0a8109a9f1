"""The port's streaming attention (linalg_tpu_torch/nn/flash_stream.py,
K4: a sliding-window band and grouped K/V) against the JAX package's.

Same numpy-seeded inputs through both packages, in float32 on the CPU,
where the port runs the kernels' plain versions and the JAX package runs
its Pallas kernels in interpret mode (``flash_stream._interpret``).
Tolerances are tests/test_torch_flash.py's: forward atol 1e-5, gradients
atol 2e-5 (float32 sums taken in another order). T 768 has 256-row blocks
in K4, so window 200 drops whole block pairs there; the port's 64-row
tiles drop more. Window 300 is not a multiple of 64, so a tile can be
wholly banned for some rows of a block and not for others.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_tpu.nn import flash_stream as jstream
from linalg_tpu_torch.nn.flash_stream import (flash_attention_stream,
                                              stream_bwd_ref, stream_fwd_ref)

torch.set_num_threads(2)

B, H, D = 1, 4, 16
FWD_ATOL, GRAD_ATOL = 1e-5, 2e-5


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def inputs(T, hk, seed):
    return ([rand((B, H, T, D), seed), rand((B, hk, T, D), seed + 1),
             rand((B, hk, T, D), seed + 2)], rand((B, H, T, D), seed + 3))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "band"])
@pytest.mark.parametrize("window", [None, 200, 300],
                         ids=["nowin", "w200", "w300"])
@pytest.mark.parametrize("hk", [4, 2, 1], ids=["mha", "gqa2", "mqa"])
def test_matches_jax_kernel(hk, window, causal):
    """Forward and the gradients of <o, dO> for q, k and v (k, v at their
    grouped size) through the port and through K4 in interpret mode."""
    T = 768 if window == 200 else 1024
    args, cot = inputs(T, hk, seed=hk + (window or 0))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = flash_attention_stream(*ts, causal, window)
    tg = torch.autograd.grad(out, ts, torch.tensor(cot))
    jout, vjp = jax.vjp(lambda q, k, v: jstream.flash_attention_stream(
        q, k, v, causal, window), *(jnp.asarray(a) for a in args))
    jg = vjp(jnp.asarray(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=FWD_ATOL)
    for what, a, b in zip("qkv", tg, jg):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL,
                                   err_msg=f"d{what}")


@pytest.mark.parametrize("causal,window,hk", [
    (True, 300, 2), (False, 300, 1), (True, None, 4)])
def test_plain_versions_match_xla_oracle(causal, window, hk):
    """``stream_fwd_ref`` against K4's forward (o and L) and
    ``stream_bwd_ref`` against K4's chunked XLA backward
    (``_vjp_bwd_xla``), from the same (q, k, v, o, L, dO). The oracle takes
    equal head counts, so it gets K/V expanded to the query heads and its
    dk/dv are summed over each group (the repeat's transpose)."""
    T = 512
    args, cot = inputs(T, hk, seed=60 + hk)
    q, k, v = (jnp.asarray(a) for a in args)
    jo, (_, _, _, _, jL) = jstream._fwd(q, k, v, causal, window)
    o, L = stream_fwd_ref(*(torch.tensor(a) for a in args), causal, window)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=FWD_ATOL)
    np.testing.assert_allclose(L.numpy(), np.asarray(jL), atol=FWD_ATOL)
    g = H // hk
    ke, ve = (jnp.repeat(x, g, axis=1) for x in (k, v))
    res = (q, ke, ve, jnp.asarray(o.numpy()), jnp.asarray(L.numpy()))
    jdq, jdk, jdv = jstream._vjp_bwd_xla(causal, window, res,
                                         jnp.asarray(cot))
    jdk, jdv = (x.reshape(B, hk, g, T, D).sum(axis=2) for x in (jdk, jdv))
    got = stream_bwd_ref(*(torch.tensor(a) for a in args), o, L,
                         torch.tensor(cot), causal, window)
    for what, a, b in zip("qkv", got, (jdq, jdk, jdv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL,
                                   err_msg=f"d{what}")


def test_band_bans_exactly_the_keys_behind_it():
    """Row i with window w and causal=False sees keys j > i - w, the
    future included: o equals a dense float64 softmax over exactly those
    keys (to float32 rounding: the plain versions compute in float32)."""
    T, w = 256, 37
    args, _ = inputs(T, 2, seed=70)
    o, _ = stream_fwd_ref(*(torch.tensor(a) for a in args), False, w)
    q, k, v = (torch.tensor(a, dtype=torch.float64) for a in args)
    ke, ve = (x.repeat_interleave(2, dim=1) for x in (k, v))
    i = torch.arange(T)
    s = q @ ke.transpose(-1, -2) / D ** 0.5
    s = s.masked_fill((i[:, None] - i[None, :]) >= w, float("-inf"))
    np.testing.assert_allclose(o.numpy(), (torch.softmax(s, -1) @ ve).numpy(),
                               atol=1e-6)


def test_contract():
    q = torch.zeros(1, 4, 256, 16)
    with pytest.raises(ValueError, match="divide"):
        flash_attention_stream(q, q[:, :3], q[:, :3])
    with pytest.raises(ValueError, match="256"):
        flash_attention_stream(q[:, :, :200], q[:, :, :200], q[:, :, :200])
    with pytest.raises(ValueError, match="window"):
        flash_attention_stream(q, q, q, True, 0)
