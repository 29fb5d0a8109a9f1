"""Eigen methods: power iteration and eigendecomposition-based matrix powers.

Port of ``linalg_tpu/ops/eigen.py``: same signatures, convergence criteria,
fallbacks and return conventions.

- ``power_iteration`` runs its steps on the tensor's device with a
  convergence freeze (a converged state stops changing), as the JAX
  ``scan`` variant does; the host reads the done flag once every
  ``_CHECK_EVERY`` steps to stop early, so results equal the JAX
  ``while_loop``'s without a readback per step.
- ``matrix_power_eig`` calls ``torch.linalg.eig`` on the tensor's own
  device (the JAX package pinned it to the CPU backend, a TPU workaround).
  Its ill-conditioned fallback is binary exponentiation.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["power_iteration", "matrix_power_eig", "matrix_power_binary"]

_CHECK_EVERY = 32  # power-iteration steps between host readbacks


def _power_step(A, v, tol):
    """One step: (v_new, lam, resid, vanished) with the reference's rules."""
    w = A @ v
    norm_w = torch.linalg.norm(w)
    vanished = norm_w < tol  # A maps v to ~0: singular direction
    v_new = w / torch.where(vanished, 1.0, norm_w)
    lam_new = v_new @ (A @ v_new)  # Rayleigh quotient
    resid = torch.linalg.norm(A @ v_new - lam_new * v_new)
    return v_new, lam_new, resid, vanished


def _power_core(A, v, tol, max_iter: int):
    """Stop at resid < tol, a vanished iterate, or max_iter steps."""
    lam = A.new_zeros(())
    done = torch.zeros((), dtype=torch.bool, device=A.device)
    for it in range(max_iter):
        v_new, lam_new, _resid, vanished = _power_step(A, v, tol)
        step_done = vanished | (_resid < tol)
        lam = torch.where(done, lam, torch.where(vanished, 0.0, lam_new))
        v = torch.where(done | vanished, v, v_new)
        done = done | step_done
        if (it + 1) % _CHECK_EVERY == 0 and bool(done):
            break
    return v, lam


def _power_core_history(A, v, tol, max_iter: int):
    """Every step's residual, whether it was appended to the history, and
    whether the step ran; inactive steps leave the state frozen."""
    lam = A.new_zeros(())
    active = torch.ones((), dtype=torch.bool, device=A.device)
    resids, appended, ran = [], [], []
    for it in range(max_iter):
        v_new, lam_new, resid, vanished = _power_step(A, v, tol)
        appended.append(active & ~vanished)
        ran.append(active)
        resids.append(resid)
        lam = torch.where(active, torch.where(vanished, 0.0, lam_new), lam)
        v = torch.where(active & ~vanished, v_new, v)
        active = active & ~vanished & (resid >= tol)
        if (it + 1) % _CHECK_EVERY == 0 and not bool(active):
            break  # every later step would be frozen: not appended, not run
    return v, lam, torch.stack(resids), torch.stack(appended), torch.stack(ran)


def power_iteration(
    A,
    max_iter: int = 2000,
    tol: float = 1e-10,
    v0: Optional[np.ndarray] = None,
    return_history: bool = False,
):
    """Dominant eigenpair via power iteration.

    Stops when ``||Av - lam v||_2 < tol`` or after ``max_iter`` iterations.
    Returns ``(lam, v)``, or ``(lam, v, iters, hist)`` with
    ``return_history=True``.
    """
    A = torch.as_tensor(A)
    if not A.is_floating_point():
        A = A.to(torch.get_default_dtype())
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError("Power iteration requires a square matrix.")
    n = A.shape[0]

    if v0 is None:
        # deterministic default start vector (the reference draws from the
        # global np.random state)
        v = np.random.default_rng(0).standard_normal(n)
    else:
        v = np.asarray(torch.as_tensor(v0).cpu(), dtype=float).copy()
        if v.shape != (n,):
            raise ValueError("v0 must be shape (n,).")
    v = torch.as_tensor(v, dtype=A.dtype, device=A.device)
    v = v / torch.linalg.norm(v)

    if not return_history:
        v, lam = _power_core(A, v, tol, int(max_iter))
        return float(lam), v

    v, lam, resids, appended, ran = _power_core_history(A, v, tol,
                                                        int(max_iter))
    appended = appended.cpu().numpy()
    hist = resids.cpu().numpy()[appended]
    n_ran = int(ran.sum())
    iters = max(0, n_ran - 1)
    return float(lam), v, iters, hist


def matrix_power_binary(A, k: int):
    """A^k for k >= 0 by repeated squaring, on the tensor's device."""
    A = torch.as_tensor(A)
    n = A.shape[0]
    result = torch.eye(n, dtype=A.dtype, device=A.device)
    base = A
    kk = int(k)
    while kk > 0:
        if kk & 1:
            result = result @ base
        base = base @ base
        kk >>= 1
    return result


def matrix_power_eig(A, k: int, *, tol=1e-10, cond_thresh=1e12):
    """A^k via eigendecomposition ``V diag(w)^k V^{-1}`` when well-conditioned.

    k=0 -> identity; k<0 -> invert then recurse; cond(V) > cond_thresh or
    non-finite -> binary exponentiation; tiny imaginary parts of the
    reconstruction are dropped for real inputs (a genuinely complex result
    comes back as a complex tensor).
    """
    A = torch.as_tensor(A)
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError("matrix_power_eig only defined for square matrices.")
    n = A.shape[0]
    k = int(k)
    if k == 0:
        return torch.eye(n, dtype=A.dtype, device=A.device)
    if k < 0:
        return matrix_power_eig(torch.linalg.inv(A), -k, tol=tol,
                                cond_thresh=cond_thresh)

    w, V = torch.linalg.eig(A)
    condV = float(torch.linalg.cond(V))
    if not np.isfinite(condV) or condV > cond_thresh:
        return matrix_power_binary(A, k)

    X = torch.linalg.solve(V, torch.eye(n, dtype=V.dtype, device=V.device))
    Ak = (V * (w ** k)[None, :]) @ X
    if not A.is_complex():
        # imag parts of the reconstruction are conjugate-pair roundoff for
        # a real input; the drop threshold scales with the working precision
        eps = float(torch.finfo(A.dtype).eps)
        drop = max(float(tol),
                   np.sqrt(eps) * max(1.0, float(Ak.real.abs().max())))
        if float(Ak.imag.abs().max()) < drop:
            return Ak.real.to(A.dtype)
    return Ak
