"""Functional NN ops with hand-derived backward passes — the PyTorch
counterpart of ``linalg_tpu/nn/functional.py``.

The reference's exact forward formulas: the ``+1e-12`` softmax
denominator, the ``-1e9`` causal fill, LayerNorm at eps 1e-5, the
tanh-approximation GELU and an explicit-matmul ``sdpa``. Each of the JAX
package's ``jax.custom_vjp``s is a ``torch.autograd.Function`` here with
the same closed-form backward (``_relu_bwd``, ``_gelu_bwd``, ``_silu_bwd``,
``_swiglu_bwd``, ``_geglu_bwd``, ``_ln_bwd``, ``_rms_bwd``,
``_sdpa_vjp_bwd``); autograd never differentiates through the forwards.
The RoPE tables and rotation are plain tensor ops there and here,
differentiated by autograd.
When no input requires a gradient (prefill, decode, evaluation) the plain
forward runs without the Function, so inference pays nothing for it; the
forward is the same function either way.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

__all__ = ["relu", "relu_backward", "gelu", "gelu_backward", "silu",
           "silu_backward", "swiglu", "swiglu_backward", "geglu",
           "geglu_backward", "softmax_last", "causal_mask", "layer_norm",
           "rms_norm", "sdpa", "sinusoidal_encoding", "rope_tables",
           "rope_rotate", "YaRN", "yarn_tables", "he_init"]

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
_GELU_C = 0.044715


def _wants_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in xs)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------


def _relu_fwd(x):
    return torch.clamp_min(x, 0.0)


def relu_backward(x):
    """d/dx ReLU: the explicit mask."""
    return (x > 0.0).to(x.dtype)


class _ReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _relu_fwd(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * relu_backward(x)


def relu(x):
    """max(0, x), with the hand-written mask as its gradient."""
    return _ReLU.apply(x) if _wants_grad(x) else _relu_fwd(x)


def _gelu_fwd(x):
    return 0.5 * x * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (x + _GELU_C * x**3)))


def gelu_backward(x):
    """d/dx of tanh-approximation GELU."""
    t = torch.tanh(_SQRT_2_OVER_PI * (x + _GELU_C * x**3))
    sech2 = 1.0 - t**2
    inner_deriv = _SQRT_2_OVER_PI * (1.0 + 3.0 * _GELU_C * x**2)
    return 0.5 * (1.0 + t) + 0.5 * x * sech2 * inner_deriv


class _GELU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _gelu_fwd(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * gelu_backward(x)


def gelu(x):
    """Tanh-approximation GELU with the hand-derived gradient."""
    return _GELU.apply(x) if _wants_grad(x) else _gelu_fwd(x)


def _silu_fwd(x):
    return x * torch.sigmoid(x)


def silu_backward(x):
    """d/dx SiLU = sigma(x) * (1 + x * (1 - sigma(x)))."""
    s = torch.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


class _SiLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _silu_fwd(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * silu_backward(x)


def silu(x):
    """SiLU/Swish ``x * sigmoid(x)`` with the hand-derived gradient."""
    return _SiLU.apply(x) if _wants_grad(x) else _silu_fwd(x)


def _swiglu_fwd(a, g):
    return (a * torch.sigmoid(a)) * g


def swiglu_backward(a, g):
    """The elementwise factors (d/da, d/dg) of ``swiglu(a, g)``:
    (g * silu'(a), silu(a))."""
    s = torch.sigmoid(a)
    return g * (s * (1.0 + a * (1.0 - s))), a * s


def _geglu_fwd(a, g):
    return _gelu_fwd(a) * g


def geglu_backward(a, g):
    """The elementwise factors (d/da, d/dg) of ``geglu(a, g)``:
    (g * gelu'(a), gelu(a)), tanh-approximation GELU."""
    return g * gelu_backward(a), _gelu_fwd(a)


class _Gated(torch.autograd.Function):
    """A gated unit f(a) * g with the hand-written product-rule backward."""

    @staticmethod
    def forward(ctx, a, g, fwd, bwd):
        ctx.save_for_backward(a, g)
        ctx.bwd = bwd
        return fwd(a, g)

    @staticmethod
    def backward(ctx, dy):
        a, g = ctx.saved_tensors
        da_f, dg_f = ctx.bwd(a, g)
        return dy * da_f, dy * dg_f, None, None


def swiglu(a, g):
    """Gated SiLU unit ``silu(a) * g`` (Shazeer 2020): ``a`` the activation
    branch (x @ W1 + b1), ``g`` the linear gate branch (x @ Wg + bg)."""
    if _wants_grad(a, g):
        return _Gated.apply(a, g, _swiglu_fwd, swiglu_backward)
    return _swiglu_fwd(a, g)


def geglu(a, g):
    """Gated GELU unit ``gelu(a) * g`` with the tanh-approximation GELU."""
    if _wants_grad(a, g):
        return _Gated.apply(a, g, _geglu_fwd, geglu_backward)
    return _geglu_fwd(a, g)


# ---------------------------------------------------------------------------
# softmax / masks
# ---------------------------------------------------------------------------


def softmax_last(x, eps: float = 1e-12):
    """Stabilized softmax along the last axis, denominator ``sum + eps``."""
    e = torch.exp(x - torch.amax(x, dim=-1, keepdim=True))
    return e / (torch.sum(e, dim=-1, keepdim=True) + eps)


def causal_mask(seq_len: int, fill: float = -1e9, dtype=torch.float32,
                device=None):
    """Additive future-blocking mask of shape (1, 1, T, T)."""
    i = torch.arange(seq_len, device=device)
    m = (i[:, None] < i[None, :]).to(dtype) * fill
    return m[None, None]


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------


def _ln_fwd(x, gamma, beta, eps):
    """(y, xhat, sigma): y = xhat * gamma + beta."""
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    sigma = torch.sqrt(var + eps)
    xhat = (x - mu) / sigma
    return xhat * gamma + beta, xhat, sigma


def _sum_to(g, like):
    """Sum a broadcast gradient back over the leading axes of ``like``."""
    return g.sum(dim=tuple(range(g.dim() - like.dim()))) if (
        g.dim() > like.dim()) else g


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        y, xhat, sigma = _ln_fwd(x, gamma, beta, eps)
        ctx.save_for_backward(xhat, sigma, gamma)
        return y

    @staticmethod
    def backward(ctx, dy):
        # closed form: dx = (ghat - mean(ghat) - xhat * mean(ghat * xhat))
        # / sigma with ghat = dy * gamma
        xhat, sigma, gamma = ctx.saved_tensors
        ghat = dy * gamma
        m1 = torch.mean(ghat, dim=-1, keepdim=True)
        m2 = torch.mean(ghat * xhat, dim=-1, keepdim=True)
        dx = (ghat - m1 - xhat * m2) / sigma
        dgamma = _sum_to(dy * xhat, gamma)
        dbeta = _sum_to(dy, gamma)
        return dx, dgamma, dbeta, None


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    """y = gamma * (x - mean) / sqrt(var + eps) + beta over the last axis."""
    if _wants_grad(x, gamma, beta):
        return _LayerNorm.apply(x, gamma, beta, eps)
    return _ln_fwd(x, gamma, beta, eps)[0]


def _rms_fwd(x, gamma, eps):
    """(y, xnorm, rms): y = xnorm * gamma."""
    rms = torch.sqrt(torch.mean(x**2, dim=-1, keepdim=True) + eps)
    xnorm = x / rms
    return xnorm * gamma, xnorm, rms


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, eps):
        y, xnorm, rms = _rms_fwd(x, gamma, eps)
        ctx.save_for_backward(xnorm, rms, gamma)
        return y

    @staticmethod
    def backward(ctx, dy):
        # closed form: dx = (g - xnorm * mean(g * xnorm)) / rms with
        # g = dy * gamma -- the JAX package's corrected form, whose final
        # /rms on the correction term the reference dropped
        xnorm, rms, gamma = ctx.saved_tensors
        g = dy * gamma
        dx = (g - xnorm * torch.mean(g * xnorm, dim=-1, keepdim=True)) / rms
        return dx, _sum_to(dy * xnorm, gamma), None


def rms_norm(x, gamma, eps: float = 1e-6):
    """y = gamma * x / sqrt(mean(x^2) + eps) over the last axis, no
    centering."""
    if _wants_grad(x, gamma):
        return _RMSNorm.apply(x, gamma, eps)
    return _rms_fwd(x, gamma, eps)[0]


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _sdpa_fwd(Q, K, V, mask):
    """(O, P) of softmax(QK^T/sqrt(d) + mask) V, in the inputs' dtype."""
    S = (1.0 / math.sqrt(Q.shape[-1])) * (Q @ K.transpose(-1, -2))
    if mask is not None:
        S = S + mask
    P = softmax_last(S)
    return P @ V, P


class _SDPA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, Q, K, V, mask):
        O, P = _sdpa_fwd(Q, K, V, mask)
        ctx.save_for_backward(Q, K, V, P)
        return O

    @staticmethod
    def backward(ctx, dO):
        # the softmax Jacobian trick dS = (dP - rowsum(dP * P)) * P; the
        # mask gets no gradient
        Q, K, V, P = ctx.saved_tensors
        scale = 1.0 / math.sqrt(Q.shape[-1])
        dV = P.transpose(-1, -2) @ dO
        dP = dO @ V.transpose(-1, -2)
        dS = (dP - torch.sum(dP * P, dim=-1, keepdim=True)) * P
        dQ = (dS @ K) * scale
        dK = (dS.transpose(-1, -2) @ Q) * scale
        return dQ, dK, dV, None


def sdpa(Q, K, V, mask=None):
    """Scaled dot-product attention softmax(QK^T/sqrt(d) + mask) V.

    Q (..., T, d), K/V (..., S, d), additive mask broadcastable to
    (..., T, S). Explicit matmuls and ``softmax_last``, in the inputs'
    dtype, as the reference computes it; the backward is the reference's
    hand-derived form (the probabilities are saved for it)."""
    if _wants_grad(Q, K, V):
        return _SDPA.apply(Q, K, V, mask)
    return _sdpa_fwd(Q, K, V, mask)[0]


def sinusoidal_encoding(max_len: int, d_model: int, dtype=torch.float32,
                        device=None):
    """Vaswani sin/cos table of shape (max_len, d_model); the frequency
    denominators are formed in float64 and rounded once to float32."""
    pos = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(d_model, device=device)[None, :]
    denom = (10000.0 ** (2 * (i // 2) / d_model).to(torch.float64)).to(
        torch.float32)
    angle = pos / denom
    pe = torch.where(i % 2 == 0, torch.sin(angle), torch.cos(angle))
    return pe.to(dtype)


def rope_tables(d_head: int, positions, base: float = 10000.0,
                dtype=torch.float32):
    """cos/sin tables (..., d_head/2) for integer ``positions`` (...,),
    computed in float32 on the positions' device. PyTorch's float32
    cos/sin and XLA's differ by at most one ulp."""
    positions = torch.as_tensor(positions)
    inv_freq = 1.0 / (base ** (torch.arange(
        0, d_head, 2, dtype=torch.float32, device=positions.device) / d_head))
    angles = positions.to(torch.float32)[..., None] * inv_freq
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


@dataclasses.dataclass(frozen=True)
class YaRN:
    """YaRN's RoPE scaling (Peng et al. 2023), the parameters of Hugging
    Face's ``rope_type: "yarn"``: the context grows ``factor`` times past
    ``original_max_position_embeddings``; rotary pairs that turn fewer than
    ``beta_slow`` times over that context are interpolated, those that
    turn more than ``beta_fast`` times keep their frequency, and a linear
    ramp blends the ones between. ``attention_factor`` scales cos and sin
    (None: 0.1 ln(factor) + 1)."""

    factor: float
    original_max_position_embeddings: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    attention_factor: Optional[float] = None


def yarn_tables(d_head: int, positions, base: float, yarn: YaRN,
                dtype=torch.float32):
    """cos/sin tables (..., d_head/2) of YaRN-scaled RoPE, float32, as
    Hugging Face's ``_compute_yarn_parameters`` and rotary embedding form
    them: per pair i, the inverse frequency ``inv_e = base^(-2i/d)``
    blended with ``inv_e / factor`` by ``1 - ramp(i)``, the ramp linear
    from 0 to 1 between floor(low) and ceil(high), the correction dims
    of ``beta_fast`` and ``beta_slow`` (clamped to [0, d - 1]); the
    tables are then multiplied by the attention factor."""
    positions = torch.as_tensor(positions)
    dev = positions.device
    orig = yarn.original_max_position_embeddings

    def corr_dim(rotations):
        return (d_head * math.log(orig / (rotations * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(corr_dim(yarn.beta_fast)), 0)
    high = min(math.ceil(corr_dim(yarn.beta_slow)), d_head - 1)
    if low == high:
        high += 0.001
    inv_e = 1.0 / (base ** (torch.arange(
        0, d_head, 2, dtype=torch.float32, device=dev) / d_head))
    ramp = torch.clamp((torch.arange(d_head // 2, dtype=torch.float32,
                                     device=dev) - low) / (high - low),
                       0.0, 1.0)
    extra = 1.0 - ramp  # the share of each pair kept at its frequency
    inv = inv_e / yarn.factor * (1.0 - extra) + inv_e * extra
    af = (yarn.attention_factor if yarn.attention_factor is not None
          else 0.1 * math.log(yarn.factor) + 1.0)
    angles = positions.to(torch.float32)[..., None] * inv
    return ((torch.cos(angles) * af).to(dtype),
            (torch.sin(angles) * af).to(dtype))


def rope_rotate(x, cos, sin):
    """Rotate the interleaved even/odd feature pairs of x (..., T, d) by
    cos/sin tables broadcastable to (..., T, d/2)."""
    xe, xo = x[..., 0::2], x[..., 1::2]
    return torch.stack([xe * cos - xo * sin, xe * sin + xo * cos],
                       dim=-1).reshape(x.shape)


def he_init(fan_in: int, fan_out: int, rng, device=None) -> torch.Tensor:
    """Kaiming/He init for ReLU layers, (fan_in, fan_out) float32: the
    JAX package's host-side draw from the numpy Generator ``rng`` (float64
    rounded once), so one seed gives the same weights in both."""
    std = math.sqrt(2.0 / fan_in)
    return torch.tensor(rng.normal(0.0, std, size=(fan_in, fan_out)),
                        dtype=torch.float32, device=device)
