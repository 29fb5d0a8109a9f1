"""Positional encodings — the counterpart of ``linalg_tpu/nn/positional.py``.

``alibi_slopes`` (the per-head slopes of ``GPTConfig(pos="alibi")``), and
the reference's L2 objects: ``LearnedPositionalEmbedding`` (a trainable
table whose backward accumulates into ``gradW`` until ``step``) and
``RotaryPositionalEmbedding`` (cos/sin caches, an ``offset`` for KV-cache
decode), with the ``get_positional_encoding`` factory. The sinusoidal
table and the RoPE tables and rotation live in ``nn.functional``.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from .functional import rope_rotate, sinusoidal_encoding
from .stateful import Stateful

__all__ = ["sinusoidal_encoding", "LearnedPositionalEmbedding",
           "RotaryPositionalEmbedding", "alibi_slopes",
           "get_positional_encoding"]


def alibi_slopes(n_heads: int, device=None) -> torch.Tensor:
    """Per-head ALiBi slopes (Press et al., "Train Short, Test Long"),
    float32 (n_heads,): head h biases its scores by ``slope_h * (j - i)``.

    The paper's geometric sequence starting at 2^(-8/n) for power-of-two
    head counts, its interleaving rule otherwise; computed in Python
    floats and rounded once to float32, as the JAX package does."""

    def pow2_slopes(n: int):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start ** (i + 1) for i in range(n)]

    if n_heads < 1:
        raise ValueError("n_heads must be >= 1")
    if math.log2(n_heads).is_integer():
        s = pow2_slopes(n_heads)
    else:
        p = 2 ** int(math.floor(math.log2(n_heads)))
        s = pow2_slopes(p) + pow2_slopes(2 * p)[0::2][: n_heads - p]
    return torch.tensor(s, dtype=torch.float32, device=device)


class LearnedPositionalEmbedding(Stateful):
    """Trainable position table, N(0, 0.02) init (the JAX package's draw);
    ``backward`` accumulates into ``gradW``, ``step`` is SGD (decay on W)
    and zeroes it."""

    DECAY = ("W",)

    def __init__(self, max_len: int, d_model: int, seed: int = 0,
                 device=None) -> None:
        super().__init__()
        rng = np.random.default_rng(seed)
        self.max_len = max_len
        self.d_model = d_model
        self._param("W", torch.tensor(rng.normal(0.0, 0.02, size=(
            max_len, d_model)), dtype=torch.float32, device=device))
        self._seq_len = 0

    def forward(self, seq_len: int):
        assert seq_len <= self.max_len, (
            f"seq_len {seq_len} > max_len {self.max_len}")
        self._seq_len = seq_len
        return self.W.detach()[:seq_len]

    @torch.no_grad()
    def backward(self, dPE) -> None:
        dPE = torch.as_tensor(dPE).to(self.W)
        if dPE.dim() == 3:  # (B, T, D): positions shared across the batch
            dPE = dPE.sum(dim=0)
        self.gradW[:self._seq_len] += dPE


class RotaryPositionalEmbedding(torch.nn.Module):
    """RoPE: rotates Q/K feature pairs by position-dependent angles, from
    float32 cos/sin caches of ``max_len`` positions."""

    def __init__(self, d_head: int, max_len: int = 4096,
                 base: float = 10000.0, device=None):
        super().__init__()
        assert d_head % 2 == 0, "d_head must be even for RoPE"
        self.d_head = d_head
        self.max_len = max_len
        self.base = base
        inv_freq = 1.0 / (base ** (torch.arange(
            0, d_head, 2, dtype=torch.float32, device=device) / d_head))
        pos = torch.arange(max_len, dtype=torch.float32, device=device)
        angles = pos[:, None] * inv_freq[None, :]  # (max_len, d_head/2)
        self.register_buffer("inv_freq", inv_freq, persistent=False)
        self.register_buffer("_cos_cache", torch.cos(angles),
                             persistent=False)
        self.register_buffer("_sin_cache", torch.sin(angles),
                             persistent=False)

    def tables(self, seq_len: int, offset: int = 0):
        """cos/sin slices for positions [offset, offset + seq_len)."""
        return (self._cos_cache[offset:offset + seq_len],
                self._sin_cache[offset:offset + seq_len])

    def forward(self, q, k, offset: int = 0) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
        """Rotate Q and K (..., T, d_head)."""
        T = q.shape[-2]
        assert offset + T <= self.max_len, (
            "Sequence too long for precomputed cache")
        cos, sin = self.tables(T, offset)
        return rope_rotate(q, cos, sin), rope_rotate(k, cos, sin)


def get_positional_encoding(name: str, max_len: int, d_model: int, **kwargs):
    """Factory: 'sinusoidal' -> a table, 'learned'/'rope' -> objects."""
    if name == "sinusoidal":
        return sinusoidal_encoding(max_len, d_model, **kwargs)
    if name == "learned":
        return LearnedPositionalEmbedding(max_len, d_model, **kwargs)
    if name == "rope":
        return RotaryPositionalEmbedding(d_model, max_len, **kwargs)
    raise KeyError(f"Unknown positional encoding: {name}")
