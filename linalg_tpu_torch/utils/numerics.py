"""Numeric utilities: tolerances, permutation parity, random test matrices.

Port of ``linalg_tpu/utils/numerics.py``: the same per-dtype tolerance
table keyed by torch dtypes, ``scale_tol`` returning a tensor on the
input's device (no host readback), and the same numpy-seeded test-matrix
generators, so both packages draw identical fixtures from one seed.

``full_f32_matmul`` is the port's counterpart of ``Precision.HIGHEST``:
the JAX package passes it to every dot of the QR, SVD and projection
code; here float32 products on a CUDA card would otherwise follow the
caller's global TF32 setting.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import numpy as np
import torch

__all__ = [
    "EPS",
    "eps_for",
    "scale_tol",
    "permutation_sign",
    "random_nonsingular_upper",
    "random_nonsingular_qr",
    "full_f32_matmul",
]

# Reference-parity constant (float64 tolerance base).
EPS: float = 1e-12

# Per-dtype tolerance bases. float64 matches the reference; the rest are
# scaled to ~25-50x machine epsilon so pivot/rank detection stays meaningful
# in reduced precision.
_EPS_BY_DTYPE = {
    torch.float64: 1e-12,
    torch.float32: 3e-6,
    torch.bfloat16: 4e-2,
    torch.float16: 2e-3,
}


def eps_for(dtype: torch.dtype) -> float:
    """Tolerance base for a floating torch dtype (EPS for float64)."""
    return _EPS_BY_DTYPE.get(dtype, EPS)


def scale_tol(A: torch.Tensor) -> torch.Tensor:
    """Absolute tolerance scaled to the matrix magnitude.

    ``eps_for(A.dtype) * max(1, ||A||_inf)``, as a tensor on ``A``'s
    device. A stack of matrices (..., m, n) gets one tolerance per matrix,
    as the JAX version gives under ``vmap``.
    """
    base = eps_for(A.dtype)
    if A.ndim == 1:
        norm_inf = A.abs().amax()
    else:
        norm_inf = A.abs().sum(dim=-1).amax(dim=-1)
    return base * torch.clamp(norm_inf, min=1.0)


def permutation_sign(perm: Sequence[int]) -> float:
    """+1.0 or -1.0 depending on permutation parity (cycle counting)."""
    perm = [int(p) for p in np.asarray(perm)]
    n = len(perm)
    visited = [False] * n
    cycles = 0
    for i in range(n):
        if not visited[i]:
            cycles += 1
            j = i
            while not visited[j]:
                visited[j] = True
                j = perm[j]
    return -1.0 if (n - cycles) & 1 else 1.0


def random_nonsingular_upper(n: int, low=-100, high=100, seed=None) -> np.ndarray:
    """Random upper-triangular matrix with nonzero diagonal (test fixture):
    uniform entries, triu, then the diagonal resampled away from zero."""
    rng = np.random.default_rng(seed)
    U = np.triu(rng.uniform(low, high, size=(n, n)))
    diag = rng.uniform(low if low != 0 else 1, high, size=n)
    U[np.diag_indices(n)] = diag
    return np.asarray(U)


def random_nonsingular_qr(n: int, seed=None) -> np.ndarray:
    """Random well-conditioned nonsingular matrix: an orthonormal basis
    times log-spaced column scales (test fixture)."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    scales = rng.uniform(0.5, 10.0, size=n)
    return np.asarray(Q * scales[None, :])


@contextlib.contextmanager
def full_f32_matmul():
    """Run float32 matrix products in full float32 (no TF32, no bf16
    passes) whatever the caller's global setting, and restore that
    setting afterwards. Usable as a decorator.

    PyTorch keeps the setting twice: a global value, and one per backend
    (CUDA's and oneDNN's matmuls, and their generic default). Both are
    restored: the global setter overwrites every backend, including one
    the caller never set. Where the caller left the backends disagreeing
    (one set through the legacy ``allow_tf32`` flag), the global getter
    raises; then only the backends' values are restored, which leaves the
    caller's state as it was."""
    backends = (torch.backends, torch.backends.cuda.matmul,
                torch.backends.mkldnn.matmul)
    prev = [b.fp32_precision for b in backends]
    try:
        prev_global = torch.get_float32_matmul_precision()
    except RuntimeError:  # the caller mixed the legacy and new settings
        prev_global = None
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        if prev_global is not None:
            torch.set_float32_matmul_precision(prev_global)
        for b, p in zip(backends, prev):
            b.fp32_precision = p
