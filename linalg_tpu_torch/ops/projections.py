"""Projection onto a column space.

Port of ``linalg_tpu/ops/projections.py``: the normal-equations projection
``p = A (A^T A)^{-1} A^T b``, with a pseudo-inverse fallback (and printed
warning) when A's columns are dependent. Products in full precision.
"""

from __future__ import annotations

import torch

from .qr import _as_float
from ..utils.numerics import full_f32_matmul

__all__ = ["project_onto_colspace"]


@full_f32_matmul()
def project_onto_colspace(A, b) -> torch.Tensor:
    """Orthogonal projection of b onto col(A).

    Returns shape (m, k) for b of shape (m,) or (m, k): always the 2-D
    column form, as the reference does.
    """
    A = _as_float(A)
    b = torch.as_tensor(b).to(dtype=A.dtype, device=A.device)
    if b.ndim == 1:
        b = b[:, None]

    r = int(torch.linalg.matrix_rank(A))
    if r < A.shape[1]:
        print("The columns of A are not independent, falling back to pseudo-inverse")
        return A @ (torch.linalg.pinv(A) @ b)
    x = torch.linalg.solve(A.T @ A, A.T @ b)
    return A @ x
