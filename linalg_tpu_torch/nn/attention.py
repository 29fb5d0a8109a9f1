"""Scaled dot-product and multi-head attention — the counterpart of
``linalg_tpu/nn/attention.py``.

The reference's contracts: ``ScaledDotProductAttention.forward(Q, K, V,
mask) -> (O, cache)`` and ``backward(dO, cache) -> (dQ, dK, dV)`` on
(BH, T, d) (or any leading axes), with the explicit softmax-Jacobian
backward; ``MultiHeadAttention.forward(X, mask, KV)`` for self- or
cross-attention, ``backward(dY) -> (dX, dKV)`` with dKV None for self,
``step`` SGD with decay on all four projections. ``mha_apply`` is the
pure form over a weight dict, its inner attention swappable
(``attn_fn``, default ``nn.functional.sdpa``); the stateful class records
it and pulls its gradients back with autograd.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .functional import causal_mask, he_init, sdpa, softmax_last
from .stateful import Stateful

__all__ = ["softmax_last", "causal_mask", "he_init",
           "ScaledDotProductAttention", "MultiHeadAttention", "MHA",
           "Attention", "mha_init", "mha_apply"]


class ScaledDotProductAttention(nn.Module):
    """O = softmax(QK^T / sqrt(d) + mask) V with an explicit cache-based
    backward (no autograd)."""

    def forward(self, Q, K, V, mask=None) -> Tuple[torch.Tensor, Tuple]:
        Q, K, V = (torch.as_tensor(a) for a in (Q, K, V))
        d = Q.shape[-1]
        S = (1.0 / math.sqrt(d)) * (Q @ K.transpose(-1, -2))
        if mask is not None:
            S = S + mask
        P = softmax_last(S)
        return P @ V, (Q, K, V, P, d)

    def backward(self, dO, cache) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
        Q, K, V, P, d = cache
        scale = 1.0 / math.sqrt(d)
        dO = torch.as_tensor(dO)
        dV = P.transpose(-1, -2) @ dO
        dP = dO @ V.transpose(-1, -2)
        dS = (dP - torch.sum(dP * P, dim=-1, keepdim=True)) * P
        return (dS @ K) * scale, (dS.transpose(-1, -2) @ Q) * scale, dV


def mha_init(d_model: int, n_heads: int, seed: int = 0,
             device=None) -> Dict[str, torch.Tensor]:
    """He-initialized projections Wq, Wk, Wv, Wo: the JAX package's draws
    in its order."""
    rng = np.random.default_rng(seed)
    hd = n_heads * (d_model // n_heads)
    return {"Wq": he_init(d_model, hd, rng, device),
            "Wk": he_init(d_model, hd, rng, device),
            "Wv": he_init(d_model, hd, rng, device),
            "Wo": he_init(hd, d_model, rng, device)}


def _split_heads(X, h: int):
    B, T, HD = X.shape
    return X.reshape(B, T, h, HD // h).transpose(1, 2)


def _combine_heads(H):
    B, h, T, d = H.shape
    return H.transpose(1, 2).reshape(B, T, h * d)


def _broadcast_mask(mask, B: int, h: int, T: int, T_kv: int):
    if mask is None:
        return None
    mb = torch.as_tensor(mask)
    while mb.dim() < 4:
        mb = mb[None]
    return mb.expand(B, h, T, T_kv)


def mha_apply(params, X, mask=None, KV=None, *, n_heads: int,
              attn_fn=sdpa):
    """Pure multi-head attention (B, T, D) -> (B, T, D); keys and values
    from ``KV`` (cross-attention) or ``X``."""
    X_kv = X if KV is None else KV
    B, T, _ = X.shape
    T_kv = X_kv.shape[1]
    Q = _split_heads(X @ params["Wq"], n_heads)
    K = _split_heads(X_kv @ params["Wk"], n_heads)
    V = _split_heads(X_kv @ params["Wv"], n_heads)
    mb = _broadcast_mask(mask, B, n_heads, T, T_kv)
    return _combine_heads(attn_fn(Q, K, V, mb)) @ params["Wo"]


class MultiHeadAttention(Stateful):
    """Stateful MHA with the reference's forward/backward/step contract."""

    DECAY = ("Wq", "Wk", "Wv", "Wo")

    def __init__(self, d_model: int, n_heads: int, seed: int = 0,
                 device=None) -> None:
        super().__init__()
        assert d_model % n_heads == 0, "d_model must be divisible by n_heads"
        self.D = d_model
        self.h = n_heads
        self.d = d_model // n_heads
        for name, w in mha_init(d_model, n_heads, seed, device).items():
            self._param(name, w)
        self.attn = ScaledDotProductAttention()
        self._is_cross = False

    split_heads = staticmethod(lambda X, h: _split_heads(torch.as_tensor(X),
                                                         h))
    combine_heads = staticmethod(lambda H: _combine_heads(torch.as_tensor(H)))

    def _params(self):
        return {"Wq": self.Wq, "Wk": self.Wk, "Wv": self.Wv, "Wo": self.Wo}

    def forward(self, X, mask=None, KV=None):
        self._is_cross = KV is not None
        if KV is None:
            return self._record(lambda x: mha_apply(
                self._params(), x, mask=mask, n_heads=self.h), X)
        return self._record(lambda x, kv: mha_apply(
            self._params(), x, mask=mask, KV=kv, n_heads=self.h), X, KV)

    def backward(self, dY) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        grads = self._pull(dY)
        return grads[0], (grads[1] if self._is_cross else None)


MHA = MultiHeadAttention
Attention = ScaledDotProductAttention
