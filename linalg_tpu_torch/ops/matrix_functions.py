"""Determinant and adjugate via elimination and QR.

Port of ``linalg_tpu/ops/matrix_functions.py``: ``det`` from the pivoted
echelon form (diagonal product times permutation sign, the sign carried on
the device), ``adj`` via ``det(A) * A^{-1}`` on the MGS QR route for
nonsingular inputs, with a cofactor expansion for singular ones, and the
``rank_numpy`` convenience. The cofactor path computes all n^2 minors'
determinants as one batch through the batched elimination core (the JAX
package vmaps it).
"""

from __future__ import annotations

import logging

import torch

from .elimination import _forward_eliminate_core
from .qr import _as_float, qr
from ..utils.numerics import full_f32_matmul

logger = logging.getLogger(__name__)

__all__ = ["det", "adj", "rank_numpy"]


def _det_core(A: torch.Tensor) -> torch.Tensor:
    """Determinants of a stack (B, n, n) -> (B,), no host readback."""
    Bn, m, _n = A.shape
    b = A.new_zeros((Bn, m, 1))
    U, _c, _perm, sign, _pivot_row, _r = _forward_eliminate_core(A, b, True)
    return sign.to(A.dtype) * torch.diagonal(U, dim1=1, dim2=2).prod(dim=1)


def det(A) -> float:
    """Determinant of a square matrix via pivoted elimination."""
    A = _as_float(A)
    m, n = A.shape
    if m != n:
        raise ValueError("The determinant is undefined for non-square matrices.")
    return float(_det_core(A[None])[0])


def rank_numpy(A) -> int:
    """Rank via SVD thresholding (the reference delegates to NumPy's)."""
    return int(torch.linalg.matrix_rank(torch.as_tensor(A)))


def _cofactor_core(A: torch.Tensor) -> torch.Tensor:
    """All-minors determinant matrix C with C[i, j] = (-1)^(i+j) det(minor_ij)."""
    n = A.shape[0]
    r = torch.arange(n - 1, device=A.device)
    ii = torch.arange(n, device=A.device)
    keep = r[None, :] + (r[None, :] >= ii[:, None])  # (n, n-1): drop row i
    minors = A[keep[:, None, :, None], keep[None, :, None, :]]
    C = _det_core(minors.reshape(n * n, n - 1, n - 1)).reshape(n, n)
    signs = 1.0 - 2.0 * ((ii[:, None] + ii[None, :]) % 2)
    return signs.to(A.dtype) * C


@full_f32_matmul()
def adj(A) -> torch.Tensor:
    """Adjugate (classical adjoint) of a square matrix.

    Nonsingular: ``det(A) * A^{-1}`` via MGS QR (solve ``R Z = Q^T``).
    Singular: cofactor expansion, all minors in one batch.
    """
    A = _as_float(A)
    m, n = A.shape
    if m != n:
        raise ValueError("A must be a square matrix")

    d = det(A)
    if d == 0:
        logger.warning("adj(): falling back to cofactor expansion")
        return _cofactor_core(A).T

    Q, R = qr(A)
    ain = torch.linalg.solve_triangular(R, Q.T, upper=True)
    return d * ain
