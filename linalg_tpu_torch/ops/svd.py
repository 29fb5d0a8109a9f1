"""Economy SVD via the A^T A eigen-route or one-sided Jacobi, and PCA.

Port of ``linalg_tpu/ops/svd.py``: the same algorithm outline (normal
matrix, symmetric eigensolve, u = A v / sigma, a random orthonormal
completion for rank-deficient inputs, transpose recursion for wide
matrices), the one-sided Hestenes Jacobi route with its round-robin
schedule, and the same 6-tuple PCA bookkeeping.

- Products are full float32 or float64, whatever the caller's TF32 setting
  (the JAX package passes ``Precision.HIGHEST``).
- The completion draws from a ``torch.Generator`` seeded by ``seed`` on the
  tensor's device: deterministic, but not ``jax.random``'s numbers, so it
  is held to properties (U orthonormal, A = U diag(s) V^T), not values.
- The Jacobi sweep count is data-dependent: the host reads the
  convergence measure once per sweep (at most 30), where JAX runs a device
  ``while_loop``. Each sweep is (n-1) vectorized rounds on the device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils.numerics import full_f32_matmul

__all__ = ["svd", "pca"]


def _svd_core(A: torch.Tensor):
    """Eigen-route SVD of (..., m, n), m >= n: (U_raw, s, Vt). U_raw
    columns for sigma = 0 are garbage (the wrapper completes them)."""
    ATA = A.mT @ A
    eigenvalues, V = torch.linalg.eigh(ATA)
    idx = torch.argsort(eigenvalues, dim=-1, stable=True).flip(-1)
    eigenvalues = eigenvalues.gather(-1, idx)
    V = V.gather(-1, idx[..., None, :].expand_as(V))
    s = torch.sqrt(torch.clamp(eigenvalues, min=0.0))
    U = (A @ V) / torch.where(s > 0, s, 1.0)[..., None, :]
    return U, s, V.mT


def _jacobi_schedule(n: int) -> np.ndarray:
    """Round-robin tournament pairings: (n-1, 2, n/2) index arrays covering
    every column pair once per sweep, each round's pairs disjoint (so all
    n/2 rotations in a round apply in parallel)."""
    players = list(range(n))
    rounds = []
    for _ in range(n - 1):
        ia = [players[i] for i in range(n // 2)]
        ib = [players[n - 1 - i] for i in range(n // 2)]
        rounds.append((ia, ib))
        # rotate all but the first player
        players = [players[0]] + [players[-1]] + players[1:-1]
    return np.asarray(rounds, dtype=np.int32)  # (n-1, 2, n/2)


def _svd_jacobi_core(A: torch.Tensor):
    """One-sided (Hestenes) Jacobi SVD core: returns (W, V, sweeps) with
    W = U * s (columns mutually orthogonal) and A = W @ V.T.

    Works on A's columns directly — never forms A^T A — so singular values
    keep high relative accuracy and U comes out orthogonal to working
    precision. A round rotates n/2 disjoint column pairs at once.
    """
    m, n = A.shape
    dtype, dev = A.dtype, A.device
    finfo = torch.finfo(dtype)
    eps = finfo.eps
    n_pad = n + (n % 2)
    W = torch.nn.functional.pad(A, (0, n_pad - n))
    V = torch.nn.functional.pad(torch.eye(n, dtype=dtype, device=dev),
                                (0, n_pad - n, 0, n_pad - n))
    sched = torch.as_tensor(_jacobi_schedule(n_pad), dtype=torch.long,
                            device=dev)  # (R, 2, p)
    max_sweeps = 30

    def sweep(W, V):
        off = torch.zeros((), dtype=dtype, device=dev)
        for ia, ib in sched:
            X, Y = W[:, ia], W[:, ib]
            a = (X * X).sum(dim=0)
            b = (Y * Y).sum(dim=0)
            c = (X * Y).sum(dim=0)
            # relative off-diagonal weight of each pair; rotate only pairs
            # meaningfully coupled (guards 0/0 on zero columns)
            denom = torch.sqrt(torch.clamp(a * b, min=finfo.tiny))
            rel = c.abs() / denom
            do = rel > eps
            c_safe = torch.where(do, c, 1.0)
            tau = (b - a) / (2.0 * c_safe)
            t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
            cs = 1.0 / torch.sqrt(1.0 + t * t)
            sn = t * cs
            cs = torch.where(do, cs, 1.0)
            sn = torch.where(do, sn, 0.0)
            W[:, ia], W[:, ib] = cs * X - sn * Y, sn * X + cs * Y
            Vx, Vy = V[:, ia], V[:, ib]
            V[:, ia], V[:, ib] = cs * Vx - sn * Vy, sn * Vx + cs * Vy
            off = torch.maximum(off, rel.max())
        return off

    # always one sweep, then iterate to converge (one readback per sweep)
    k = 1
    off = sweep(W, V)
    while float(off) > 4 * eps and k < max_sweeps:
        off = sweep(W, V)
        k += 1
    return W[:, :n], V[:n, :n], k


@full_f32_matmul()
def svd(A, tol: float = 1e-12, seed: int = 0,
        reorthogonalize: bool = False,
        method: str = "eigh") -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Economy SVD: A (m, n) -> (U (m, n), s (n,), Vt (n, n)) for m >= n.

    Wide matrices recurse on A^T with U/V roles swapped. Columns of U
    beyond the numerical rank are completed with a deterministic random
    orthonormal complement (seeded by ``seed``).

    ``method``: ``"eigh"`` (the reference's algorithm: A^T A + symmetric
    eigensolve; squaring costs accuracy, ~sqrt(eps)*kappa in float32) or
    ``"jacobi"`` (one-sided Hestenes Jacobi on A's columns: U orthogonal to
    working precision, singular values with high relative accuracy).
    ``reorthogonalize=True`` polishes U with a sign-preserving QR.
    """
    A = torch.as_tensor(A)
    if not A.is_floating_point():
        A = A.to(torch.get_default_dtype())
    if method not in ("eigh", "jacobi"):
        raise ValueError(f"Unknown SVD method: {method!r}")
    m, n = A.shape
    if m < n:
        Vt, s, Ut = svd(A.T, tol, seed, reorthogonalize, method)
        return Ut.T, s, Vt.T

    if method == "jacobi":
        W, V, _ = _svd_jacobi_core(A)
        s = torch.linalg.norm(W, dim=0)
        order = torch.argsort(s, stable=True).flip(0)
        s = s[order]
        U = W[:, order] / torch.where(s > 0, s, 1.0)[None, :]
        Vt = V[:, order].T
    else:
        U, s, Vt = _svd_core(A)
    s_host = s.cpu().numpy()
    eps = float(torch.finfo(A.dtype).eps)
    s_max = float(s_host[0]) if s_host.size else 0.0
    if method == "jacobi":
        # singular values from un-squared column norms: noise ~eps*sigma_max
        eff_tol = max(float(tol), s_max * n * eps)
    else:
        # eigh's eigenvalue noise is ~eps*sigma_max^2, so spurious sigmas
        # surface at ~sqrt(eps)*sigma_max: clip them to exact zeros so the
        # orthonormal completion owns those columns
        eff_tol = max(float(tol), s_max * np.sqrt(n * eps))
    rank = int(np.sum(s_host > eff_tol))

    if rank < n:
        s = torch.where(torch.arange(n, device=A.device) < rank, s, 0.0)
        gen = torch.Generator(device=A.device).manual_seed(int(seed))
        G = torch.randn((m, n - rank), generator=gen, dtype=A.dtype,
                        device=A.device)
        Q, _ = torch.linalg.qr(G)
        U_r = U[:, :rank]
        # project out span(U_r), then re-orthogonalize; twice, so the
        # second pass cleans the first's rounding residual
        for _ in range(2):
            Q = Q - U_r @ (U_r.T @ Q)
            Q, _ = torch.linalg.qr(Q)
        U = torch.cat([U_r, Q], dim=1)

    if reorthogonalize:
        Qu, Ru = torch.linalg.qr(U)
        # sign-fix so each polished column keeps its original direction
        signs = torch.sign(torch.diagonal(Ru))
        U = Qu * torch.where(signs == 0, 1.0, signs)[None, :]

    return U, s, Vt


def pca(A, k: int):
    """PCA with samples in rows, features in columns.

    Returns ``(pcs, scores, explained_variance, explained_variance_ratio,
    total_variance, mean_)``.
    """
    A = torch.as_tensor(A)
    if not A.is_floating_point():
        A = A.to(torch.get_default_dtype())
    k = int(k)
    mean_ = A.mean(dim=0, keepdim=True)
    X = A - mean_
    _, S, Vt = torch.linalg.svd(X, full_matrices=False)
    pcs = Vt[:k].T
    scores = X @ pcs
    n_samples = A.shape[0]
    explained_variance = S[:k] ** 2 / (n_samples - 1)
    total_variance = torch.linalg.norm(X) ** 2 / (n_samples - 1)
    explained_variance_ratio = explained_variance / total_variance
    return (pcs, scores, explained_variance, explained_variance_ratio,
            float(total_variance), mean_.ravel())
