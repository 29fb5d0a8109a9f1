"""Batched variants of the dense linear-algebra cores.

Port of ``linalg_tpu/ops/batched.py``. The JAX package ``vmap``s its jitted
cores; here the cores themselves take a leading batch dimension, so a
stack of small decompositions is one sequence of batched device ops. Error
semantics differ from the scalar API by necessity (no per-matrix raising
inside one batched sweep): validity comes back as a mask.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .elimination import _back_substitute_core, _forward_eliminate_core
from .matrix_functions import _det_core
from .qr import _as_float, _householder_core, _mgs_core
from .svd import _svd_core
from ..utils.numerics import full_f32_matmul, scale_tol

__all__ = [
    "batched_qr",
    "batched_householder_qr",
    "batched_svd",
    "batched_solve",
    "batched_det",
]


@full_f32_matmul()
def batched_qr(A) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """MGS QR of a stack: (B, m, n) -> (Q (B, m, n), R (B, n, n), ok (B,)).

    ``ok[i]`` False marks a rank-deficient input (the scalar API raises).
    """
    return _mgs_core(_as_float(A, allow_batched=True))


@full_f32_matmul()
def batched_householder_qr(A, block: int = 128):
    """Blocked Householder QR of a stack (B, m, n) with m >= n, n % block
    handled by padding. Returns (Q (B, m, n), R (B, n, n))."""
    A = _as_float(A, allow_batched=True)
    Bb, m, n = A.shape
    if m < n:
        raise ValueError("requires m >= n")
    b = max(1, min(block, n))
    n_pad = -(-n // b) * b
    if n_pad != n:
        A = torch.cat([A, A.new_zeros((Bb, m, n_pad - n))], dim=2)
    Q, R = _householder_core(A, b)
    return Q[:, :, :n], R[:, :n, :n]


@full_f32_matmul()
def batched_svd(A):
    """Economy SVD of a stack (B, m, n), m >= n, full-rank inputs.

    Returns (U (B, m, n), s (B, n), Vt (B, n, n)). Rank-deficient inputs get
    garbage U columns for zero sigmas (the scalar API completes them).
    """
    A = _as_float(A, allow_batched=True)
    if A.shape[1] < A.shape[2]:
        raise ValueError("requires m >= n (transpose the stack)")
    return _svd_core(A)


def batched_solve(A, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve a stack of square systems: (B, n, n), (B, n[, k]).

    Returns (x, ok) where ok[i] is False for singular systems (their x is
    garbage; the scalar API raises or falls back instead).
    """
    A = _as_float(A, allow_batched=True)
    b = torch.as_tensor(b).to(dtype=A.dtype, device=A.device)
    squeeze = b.ndim == 2
    b2 = b[..., None] if squeeze else b
    U, c, _perm, _sign, _pr, _r = _forward_eliminate_core(A, b2, True)
    x, any_zero, _wi, _inc = _back_substitute_core(U, c, scale_tol(U))
    return (x[..., 0] if squeeze else x), ~any_zero


def batched_det(A) -> torch.Tensor:
    """Determinants of a stack of square matrices (B, n, n) -> (B,)."""
    return _det_core(_as_float(A, allow_batched=True))
