"""Functional NN ops (forward) — the PyTorch counterpart of
``linalg_tpu/nn/functional.py``.

Forwards only, with the reference's exact formulas: the ``+1e-12``
softmax denominator, the ``-1e9`` causal fill, LayerNorm at eps 1e-5, the
tanh-approximation GELU and an explicit-matmul ``sdpa``. The serving path
never differentiates; the hand-derived backwards (``jax.custom_vjp`` in the
JAX package) become ``torch.autograd.Function``s with the training slice.
"""

from __future__ import annotations

import math

import torch

__all__ = ["relu", "gelu", "softmax_last", "causal_mask", "layer_norm",
           "sdpa", "sinusoidal_encoding"]

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
_GELU_C = 0.044715


def relu(x):
    """max(0, x)."""
    return torch.clamp_min(x, 0.0)


def gelu(x):
    """Tanh-approximation GELU."""
    return 0.5 * x * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (x + _GELU_C * x**3)))


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


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    """y = gamma * (x - mean) / sqrt(var + eps) + beta over the last axis."""
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * gamma + beta


def sdpa(Q, K, V, mask=None):
    """Scaled dot-product attention softmax(QK^T/sqrt(d) + mask) V.

    Q (..., T, d), K/V (..., S, d), additive mask broadcastable to
    (..., T, S). Explicit matmuls and ``softmax_last``, in the inputs'
    dtype, as the reference computes it."""
    S = (1.0 / math.sqrt(Q.shape[-1])) * (Q @ K.transpose(-1, -2))
    if mask is not None:
        S = S + mask
    return softmax_last(S) @ V


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
