"""QR decompositions.

Port of ``linalg_tpu/ops/qr.py``: ``qr`` (right-looking Modified
Gram-Schmidt, optional second pass), ``householder_qr`` (blocked compact-WY,
economy, m >= n), ``least_squares_qr`` and ``least_squares_householder_qr``.

- The loops over columns enqueue device work only: rank deficiency is
  carried as a status flag on the device, and the host raises after ONE
  readback at the end, never after a sync per column.
- Every product is full float32 or float64, whatever the caller's TF32
  setting (the JAX package passes ``Precision.HIGHEST`` to every dot).
- The cores take a leading batch dimension, which ``ops/batched.py`` uses
  in place of ``vmap``.
- ``qr(A, reorth=True)`` returns ``R = R2 @ R1``, so A = QR still holds
  after the second pass (a deliberate deviation from the reference, kept
  from the JAX package).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..kernels.qr_panel import MAX_M
from ..utils.numerics import eps_for, full_f32_matmul
from .qr_panel import householder_qr_panel

__all__ = [
    "qr",
    "householder_qr",
    "least_squares_qr",
    "least_squares_householder_qr",
]


# ---------------------------------------------------------------------------
# Modified Gram-Schmidt
# ---------------------------------------------------------------------------


def _mgs_core(A: torch.Tensor):
    """Right-looking MGS of (..., m, n). Returns (Q, R, ok) with ``ok``
    False (per matrix) on rank deficiency; no host readback."""
    *batch, m, n = A.shape
    eps = eps_for(A.dtype)
    col_ids = torch.arange(n, device=A.device)
    W = A.clone()  # columns < j are final q's, >= j are working
    R = A.new_zeros((*batch, n, n))
    ok = torch.ones(batch, dtype=torch.bool, device=A.device)
    for j in range(n):
        v = W[..., :, j]
        nrm = torch.sqrt((v[..., None, :] @ v[..., :, None])[..., 0, 0])
        ok = ok & (nrm >= eps)
        q = v / torch.where(nrm == 0, 1.0, nrm)[..., None]
        coeffs = (q[..., None, :] @ W)[..., 0, :]  # projections on all cols
        trailing = torch.where(col_ids > j, coeffs, 0.0)
        W -= q[..., :, None] * trailing[..., None, :]
        W[..., :, j] = q
        trailing[..., j] = nrm
        R[..., j, :] = trailing
    return W, R, ok


@full_f32_matmul()
def qr(A, reorth: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Modified Gram-Schmidt QR of a full-column-rank matrix.

    Returns (Q (m, n) orthonormal columns, R (n, n) upper-triangular) with
    A = QR. ``reorth=True`` runs a second Gram-Schmidt pass ("twice is
    enough") for machine-precision orthogonality. Raises ``ValueError`` on
    linearly dependent input columns.
    """
    A = _as_float(A)
    Q, R, ok = _mgs_core(A)
    if not bool(ok):
        raise ValueError("Input vectors are linearly dependent")
    if reorth:
        Q, R2, ok2 = _mgs_core(Q)
        if not bool(ok2):
            raise ValueError("Input vectors are linearly dependent")
        R = torch.triu(R2 @ R)
    return Q, R


# ---------------------------------------------------------------------------
# Blocked Householder (compact WY)
# ---------------------------------------------------------------------------


def _panel_factor(P: torch.Tensor, k: int, rows: torch.Tensor):
    """Factor one panel (..., m, b) whose pivot rows start at global row k.

    Returns (P_out, V, T): the transformed panel (R entries on top,
    annihilated below), the unit-norm reflectors V (zeros above their pivot
    row) and the (b, b) upper-triangular compact-WY factor T with
    H_0 H_1 ... H_{b-1} = I - V T V^T, tau = 2.
    """
    *batch, m, b = P.shape
    eps = eps_for(P.dtype)
    P = P.clone()
    V = P.new_zeros((*batch, m, b))
    T = P.new_zeros((*batch, b, b))
    for jl in range(b):
        jg = k + jl
        x = torch.where(rows >= jg, P[..., :, jl], 0.0)
        nrm = torch.sqrt((x[..., None, :] @ x[..., :, None])[..., 0, 0])
        has = nrm >= eps
        # padded columns may pivot past the last row: x is zero, the step
        # is skipped, and x0 reads the last row (JAX clamps the index)
        x0 = P[..., min(jg, m - 1), jl]
        alpha = torch.where(x0 >= 0, nrm, -nrm)
        w_un = x.clone()
        if jg < m:
            w_un[..., jg] += alpha
        wn = torch.sqrt((w_un[..., None, :] @ w_un[..., :, None])[..., 0, 0])
        w = torch.where(has[..., None],
                        w_un / torch.where(wn == 0, 1.0, wn)[..., None], 0.0)
        # H = I - 2 w w^T on the whole panel (finalized columns have ~zero
        # below their pivot, so the extra columns are a no-op)
        P -= 2.0 * w[..., :, None] * (w[..., None, :] @ P)
        V[..., :, jl] = w
        # T column: T[:jl, jl] = -2 T[:jl, :jl] (V^T w); T[jl, jl] = 2
        z = (w[..., None, :] @ V)[..., 0, :]
        z[..., jl] = 0.0
        tcol = -2.0 * (T @ z[..., :, None])[..., 0]
        tcol[..., jl] = torch.where(has, 2.0, 0.0)
        T[..., :, jl] = tcol
    return P, V, T


def _householder_core(A: torch.Tensor, block: int):
    """Blocked Householder QR of (..., m, n) with n % block == 0, m >= n.
    Returns (Q (..., m, n), R (..., n, n))."""
    *batch, m, n = A.shape
    rows = torch.arange(m, device=A.device)
    R = A.clone()
    panels = []
    for k in range(0, n, block):
        P, V, T = _panel_factor(R[..., :, k:k + block], k, rows)
        R[..., :, k:k + block] = P
        # trailing update: C -= V (T^T (V^T C)) applies Q_panel^T
        if k + block < n:
            C = R[..., :, k + block:]
            W = T.mT @ (V.mT @ C)
            R[..., :, k + block:] = C - V @ W
        panels.append((k, V, T))
    # economy Q: the panels in reverse, applied to the (m, n) identity block
    Q = torch.eye(m, n, dtype=A.dtype, device=A.device).expand(
        *batch, m, n).clone()
    for k, V, T in reversed(panels):
        X = Q[..., :, k:]
        W = T @ (V.mT @ X)
        Q[..., :, k:] = X - V @ W
    return Q, torch.triu(R[..., :n, :n])


@full_f32_matmul()
def householder_qr(A, block: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Economy Householder QR of an (m, n) matrix with m >= n.

    Returns (Q (m, n) orthonormal columns, R (n, n) upper-triangular) with
    A = QR. Numerically-zero columns are skipped, leaving a zero on R's
    diagonal. ``block`` is the panel width.

    Which implementation runs is the JAX package's own rule
    (``linalg_tpu/ops/qr.py:203-208``), with "on a TPU" read as "a CUDA
    tensor": float32 on a CUDA device with n >= 2 * block and m within the
    panel kernel's limit goes through ``householder_qr_panel`` and the
    hand-written panel kernel — which builds and launches or raises;
    everything else (float64, CPU tensors, narrow or very tall inputs) runs
    the blocked core ``_householder_core``. That split is the algorithm's
    choice for the input, not a fallback from a failing kernel.
    """
    A = _as_float(A)
    m, n = A.shape
    if m < n:
        raise ValueError(f"householder_qr requires m >= n, got {tuple(A.shape)}")
    b = max(1, min(block, _next_pow2(n)))
    use_kernel = (A.dtype == torch.float32 and A.is_cuda and n >= 2 * b
                  and m <= MAX_M)
    n_pad = -(-n // b) * b
    if n_pad != n:
        # zero columns are skipped (norm 0), even past the last row
        A_p = torch.cat([A, A.new_zeros((m, n_pad - n))], dim=1)
    else:
        A_p = A
    if use_kernel:
        Q, R = householder_qr_panel(A_p, block=b)
    else:
        Q, R = _householder_core(A_p, b)
    return Q[:, :n], R[:n, :n]


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def _as_float(A, allow_batched: bool = False) -> torch.Tensor:
    """A as a floating tensor on its own device (numpy arrays land on the
    CPU). Non-floating input takes torch's default dtype, the counterpart
    of JAX's x64 switch."""
    A = torch.as_tensor(A)
    if not A.is_floating_point():
        A = A.to(torch.get_default_dtype())
    want = 3 if allow_batched else 2
    if A.ndim != want:
        raise ValueError(f"A must be {want}-D")
    return A


# ---------------------------------------------------------------------------
# Least squares
# ---------------------------------------------------------------------------


def _solve_upper(R, y):
    if y.ndim == 1:
        return torch.linalg.solve_triangular(R, y[:, None], upper=True)[:, 0]
    return torch.linalg.solve_triangular(R, y, upper=True)


def _rhs(b, A: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(b).to(dtype=A.dtype, device=A.device)


@full_f32_matmul()
def least_squares_qr(A, b) -> torch.Tensor:
    """min ||Ax - b||_2 via thin MGS QR."""
    A = _as_float(A)
    b = _rhs(b, A)
    n = A.shape[1]
    Q, R = qr(A)
    y = Q.T @ b
    return _solve_upper(R[:n, :n], y[:n]).ravel()


@full_f32_matmul()
def least_squares_householder_qr(A, b) -> torch.Tensor:
    """min ||Ax - b||_2 via economy Householder QR."""
    A = _as_float(A)
    b = _rhs(b, A)
    Q, R = householder_qr(A)
    y = Q.T @ b
    return _solve_upper(R, y).ravel()
