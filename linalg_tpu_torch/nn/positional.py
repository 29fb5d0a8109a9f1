"""Positional encodings — the counterpart of ``linalg_tpu/nn/positional.py``.

This slice ports ``alibi_slopes``, the per-head slopes of
``GPTConfig(pos="alibi")``. The sinusoidal table and the RoPE tables live
in ``nn.functional``; the package's L2 classes (learned and rotary
embedding objects) are ROADMAP.md queue 1, item 6.
"""

from __future__ import annotations

import math

import torch

__all__ = ["alibi_slopes"]


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
