"""Gaussian elimination with partial pivoting.

Port of ``linalg_tpu/ops/elimination.py``: ``forward_eliminate``,
``back_substitute``, ``gaussian_solve``, ``rref``, ``rank_elimination`` and
``nullspace_basis_elimination``, with the same return conventions and
raises.

- The column sweeps enqueue device work only: pivot argmax, row swaps
  (gathers by an index built with ``scatter``) and the rank-1 updates stay
  on the tensor's device, with no readback per column.
- Rank deficiency and inconsistency are status flags and masks; the thin
  host wrappers read them once and convert them to the reference's Python
  lists and ``ValueError``s.
- The cores take a leading batch dimension (``ops/batched.py`` uses it in
  place of ``vmap``). JAX's out-of-range ``mode="drop"`` scatters become
  scatters into one extra trash slot that is cut off afterwards.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import torch

from ..utils.numerics import scale_tol

logger = logging.getLogger(__name__)

__all__ = [
    "forward_eliminate",
    "back_substitute",
    "gaussian_solve",
    "rref",
    "rank_elimination",
    "nullspace_basis_elimination",
]


# ---------------------------------------------------------------------------
# cores (fixed shapes, mask-encoded dynamic rank, leading batch dimension)
# ---------------------------------------------------------------------------


def _take_row(X: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row ``idx[i]`` of each X[i]: X (B, m, k), idx (B,) -> (B, k)."""
    return X.gather(1, idx[:, None, None].expand(-1, 1, X.shape[2]))[:, 0]


def _forward_eliminate_core(A: torch.Tensor, b: torch.Tensor, pivot: bool):
    """Row-echelon reduction of a stack A (B, m, n), RHS b (B, m, k).

    Returns (U, c, perm, sign, pivot_row, rank): ``pivot_row[:, col]`` is
    the row where column ``col``'s pivot landed, or -1 for a free column;
    ``sign`` is the permutation parity (+/-1).
    """
    Bn, m, n = A.shape
    dev = A.device
    tol = scale_tol(A)  # (B,)
    row_ids = torch.arange(m, device=dev)
    U, c = A.clone(), b.clone()
    perm = row_ids.expand(Bn, m).clone()
    sign = torch.ones(Bn, dtype=torch.long, device=dev)
    pivot_row = torch.full((Bn, n), -1, dtype=torch.long, device=dev)
    r = torch.zeros(Bn, dtype=torch.long, device=dev)
    for col in range(n):
        colabs = U[:, :, col].abs()
        masked = torch.where(row_ids >= r[:, None], colabs, -torch.inf)
        piv = masked.argmax(dim=1)
        has_pivot = masked.gather(1, piv[:, None])[:, 0] > tol
        # r can equal m once all rows hold pivots; clamp (has_pivot is
        # False there, so every update below is a no-op)
        r_c = torch.clamp(r, max=m - 1)
        piv_eff = torch.where(has_pivot, piv, r_c) if pivot else r_c
        # swap rows r_c and piv_eff (identity swap when equal)
        idx = row_ids.expand(Bn, m).clone()
        idx.scatter_(1, r_c[:, None], piv_eff[:, None])
        idx.scatter_(1, piv_eff[:, None], r_c[:, None])
        U = U.gather(1, idx[:, :, None].expand(-1, -1, n))
        c = c.gather(1, idx[:, :, None].expand(-1, -1, c.shape[2]))
        perm = perm.gather(1, idx)
        sign = sign * torch.where(piv_eff != r_c, -1, 1)

        pivval = U[:, :, col].gather(1, r_c[:, None])[:, 0]
        safe = torch.where(pivval == 0, 1.0, pivval)
        below = (row_ids[None, :] > r_c[:, None]) & has_pivot[:, None]
        factors = torch.where(below, U[:, :, col] / safe[:, None], 0.0)
        U = U - factors[:, :, None] * _take_row(U, r_c)[:, None, :]
        # exact zeros below the pivot in this column
        U[:, :, col] = torch.where(below, 0.0, U[:, :, col])
        c = c - factors[:, :, None] * _take_row(c, r_c)[:, None, :]

        pivot_row[:, col] = torch.where(has_pivot, r_c, -1)
        r = r + has_pivot.long()
    return U, c, perm, sign, pivot_row, r


def _back_substitute_core(U: torch.Tensor, c: torch.Tensor,
                          tol: torch.Tensor):
    """Solve U x = c for a stack of square upper-triangular U (B, n, n),
    c (B, n, k), with status flags.

    Returns (x, any_zero_pivot, worst_i, inconsistent_at_worst): ``worst_i``
    is the largest row index with a ~zero diagonal (the first one a
    bottom-up scan hits).
    """
    Bn, n, k = c.shape
    dev = U.device
    diag = torch.diagonal(U, dim1=1, dim2=2).abs()
    zero_piv = diag <= tol[:, None]
    any_zero = zero_piv.any(dim=1)
    rev_idx = zero_piv.flip(1).to(torch.uint8).argmax(dim=1)
    worst_i = torch.where(any_zero, n - 1 - rev_idx, 0)
    inconsistent = (_take_row(c, worst_i).abs() > tol[:, None]).any(dim=1)

    col_ids = torch.arange(n, device=dev)
    x = U.new_zeros((Bn, n, k))
    for t in range(n):
        i = n - 1 - t
        urow = torch.where(col_ids > i, U[:, i, :], 0.0)
        s = c[:, i, :] - (urow[:, None, :] @ x)[:, 0, :]
        piv = U[:, i, i]
        x[:, i, :] = s / torch.where(piv == 0, 1.0, piv)[:, None]
    return x, any_zero, worst_i, inconsistent


def _rref_core(U: torch.Tensor, pivot_row: torch.Tensor, tol: torch.Tensor):
    """Backward sweep of RREF given the forward-eliminated U (m, n);
    ``pivot_row[col]`` maps pivot columns to their row (or -1)."""
    m, n = U.shape
    dev = U.device
    row_ids = torch.arange(m, device=dev)
    # invert pivot_row: the pivot column each row owns (or n); free columns
    # land in the trash slot m
    rows = torch.where(pivot_row >= 0, pivot_row, m)
    pivcol_of_row = torch.full((m + 1,), n, dtype=torch.long, device=dev)
    pivcol_of_row.scatter_(0, rows, torch.arange(n, device=dev))
    pivcol_of_row = pivcol_of_row[:m]

    R = U.clone()
    for rr in range(m - 1, -1, -1):
        col = pivcol_of_row[rr]
        has = col < n
        col_c = torch.clamp(col, max=n - 1).reshape(1)
        piv_val = R[rr].gather(0, col_c)[0]
        do_scale = has & (piv_val.abs() > tol)
        R[rr] = torch.where(do_scale,
                            R[rr] / torch.where(piv_val == 0, 1.0, piv_val),
                            R[rr])
        # zero the entries above the pivot
        factors = torch.where((row_ids < rr) & has,
                              R.index_select(1, col_c)[:, 0], 0.0)
        R = R - factors[:, None] * R[rr][None, :]
    return torch.where(R.abs() < tol, 0.0, R)


def _nullspace_core(U: torch.Tensor, pivot_row: torch.Tensor,
                    rank: torch.Tensor):
    """Candidate nullspace vector for every column j of A (m, n).

    Returns Z (n, n): column j is the basis vector that would arise if
    column j were free (garbage for pivot columns; the wrapper keeps only
    free columns) — the per-free-column back-substitution through the
    pivot submatrix, for all columns at once.
    """
    m, n = U.shape
    dev = U.device
    t_ids = torch.arange(n, device=dev)
    # pivcols[i] = column of the i-th pivot (row i), or n (padding)
    slot = torch.where(pivot_row >= 0, pivot_row, n)
    pivcols = torch.full((n + 1,), n, dtype=torch.long, device=dev)
    pivcols.scatter_(0, slot, t_ids)
    pivcols_c = torch.clamp(pivcols[:n], max=n - 1)
    # Rsub[i, t] = U[i, pivcols[t]]: the (rank x rank) pivot submatrix,
    # padded to (n, n); rows beyond m-1 read as zero via clamping + mask
    r_rows = torch.clamp(t_ids, max=m - 1)
    live = t_ids < rank
    Rsub = U[r_rows[:, None], pivcols_c[None, :]]
    Rsub = torch.where(live[:, None] & live[None, :], Rsub, 0.0)
    # RHS[i, j] = -U[i, j] for pivot rows i < rank, all candidate columns j
    RHS = torch.where(live[:, None], -U[r_rows], 0.0)

    X = U.new_zeros((n, n))
    for s in range(n):
        i = n - 1 - s
        rrow = torch.where(t_ids > i, Rsub[i], 0.0)
        num = RHS[i] - rrow @ X
        piv = Rsub[i, i]
        X[i] = torch.where(live[i], num / torch.where(piv == 0, 1.0, piv),
                           0.0)

    # Z = eye (z[j] = 1) with the pivot-row entries scattered in:
    # Z[pivcols[i], :] = X[i, :] for i < rank; the rest go to trash row n
    Z = torch.cat([torch.eye(n, dtype=U.dtype, device=dev),
                   U.new_zeros((1, n))], dim=0)
    Z[torch.where(live, pivcols_c, n)] = X
    return Z[:n]


# ---------------------------------------------------------------------------
# host wrappers (reference API: lists, None, raising)
# ---------------------------------------------------------------------------


def _as_float_matrix(A) -> torch.Tensor:
    A = torch.as_tensor(A)
    if not A.is_floating_point():
        A = A.to(torch.get_default_dtype())
    return A


def _echelon(A: torch.Tensor, b2: torch.Tensor, pivot: bool = True):
    """The forward core on one matrix: (U, c, perm, sign, pivot_row, r)."""
    return tuple(t[0] for t in _forward_eliminate_core(A[None], b2[None],
                                                       pivot))


def forward_eliminate(
    A,
    b=None,
    pivot: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], List[int], List[int],
           List[int]]:
    """Row-echelon reduction with partial pivoting.

    Returns (U, c, pivots, free, perm): ``pivots``/``free`` are pivot/free
    column index lists, ``perm`` lists the original row of each final row
    (length max(m, n)), and ``c`` is ``b`` after identical row ops ((m, k),
    or None).
    """
    A = _as_float_matrix(A)
    if A.ndim != 2:
        raise ValueError("A must be 2-D")
    m, n = A.shape
    if b is None:
        b2 = A.new_zeros((m, 1))
    else:
        b2 = torch.as_tensor(b).to(dtype=A.dtype, device=A.device)
        b2 = b2[:, None] if b2.ndim == 1 else b2

    U, c, perm, _sign, pivot_row, _r = _echelon(A, b2, bool(pivot))

    pr = pivot_row.cpu().numpy()
    pivots = [int(col) for col in range(n) if pr[col] >= 0]
    free = [int(col) for col in range(n) if pr[col] < 0]
    perm_list = [int(p) for p in perm.cpu().numpy()]
    if n > m:
        perm_list += list(range(m, n))
    return U, (c if b is not None else None), pivots, free, perm_list


def back_substitute(U, c) -> torch.Tensor:
    """Solve Ux = c for upper-triangular U, raising the reference's errors:
    ``ValueError("inconsistent system (no solution)")`` or
    ``ValueError("rank deficient (infinitely many solutions)")`` by the
    reference's bottom-up scan."""
    U = _as_float_matrix(U)
    c = torch.as_tensor(c).to(dtype=U.dtype, device=U.device)
    squeeze = c.ndim == 1
    c2 = c[:, None] if squeeze else c
    tol = scale_tol(U).reshape(1)
    x, any_zero, _worst_i, inconsistent = _back_substitute_core(
        U[None], c2[None], tol)
    x = x[0]
    flags = torch.stack([any_zero[0], inconsistent[0]]).cpu()  # one readback
    if bool(flags[0]):
        if bool(flags[1]):
            raise ValueError("inconsistent system (no solution)")
        raise ValueError("rank deficient (infinitely many solutions)")
    return x.ravel() if (squeeze or x.shape[1] == 1) else x


def gaussian_solve(A, b, pivot: bool = True) -> torch.Tensor:
    """Direct solve via elimination + back substitution.

    A rank-deficient but consistent system falls back to least squares
    (the minimum-norm solution, as ``jnp.linalg.lstsq`` gives);
    inconsistent systems raise.
    """
    try:
        U, c, _pivots, _free, _perm = forward_eliminate(A, b, pivot=pivot)
        return back_substitute(U, c)
    except ValueError as e:
        if "inconsistent" in str(e):
            raise
        logger.debug(
            "%s; rank deficient but consistent, falling back to least squares",
            e,
        )
        A = _as_float_matrix(A)
        b = torch.as_tensor(b).to(dtype=A.dtype, device=A.device)
        return torch.linalg.pinv(A) @ b


def rref(A) -> Tuple[torch.Tensor, List[int]]:
    """Reduced row-echelon form and pivot column list."""
    A = _as_float_matrix(A)
    m, n = A.shape
    U, _c, _perm, _sign, pivot_row, _r = _echelon(A, A.new_zeros((m, 1)))
    R = _rref_core(U, pivot_row, scale_tol(U))
    pr = pivot_row.cpu().numpy()
    pivots = [int(col) for col in range(n) if pr[col] >= 0]
    return R, pivots


def rank_elimination(A) -> int:
    """Matrix rank = number of pivot columns."""
    A = _as_float_matrix(A)
    m, _n = A.shape
    r = _echelon(A, A.new_zeros((m, 1)))[5]
    return int(r)


def nullspace_basis_elimination(A) -> torch.Tensor:
    """Basis of the nullspace of A as an (n, n-r) matrix; full-rank inputs
    return shape (n, 0). One vector per free column, by back-substitution
    through the pivot columns."""
    A = _as_float_matrix(A)
    m, n = A.shape
    U, _c, _perm, _sign, pivot_row, r = _echelon(A, A.new_zeros((m, 1)))
    pr = pivot_row.cpu().numpy()
    free = [int(col) for col in range(n) if pr[col] < 0]
    if not free:
        return A.new_zeros((n, 0))
    Z = _nullspace_core(U, pivot_row, r)
    return Z[:, torch.as_tensor(free, device=A.device)]

