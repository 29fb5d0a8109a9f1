"""K13: the grouped GEMM over variable-size expert groups, its plain
PyTorch version, and the ``autograd.Function`` of the dropless routed FFN
built on it.

Rows of a routed layer are sorted by expert: group e owns the rows
``offs[e]:offs[e + 1]`` (``offs`` (El + 1,) int32 on the device, ``offs[0]
== 0``), and the M rows of an output past ``offs[El]`` are its tail, zero.

- ``grouped_rows(A, a_idx, offs, W, M, trans=False)``: C (M, N) with
  ``C[r] = A[a_idx[r]] @ W[e]`` (``W[e].T`` when ``trans``) for r in group
  e; ``a_idx`` None reads ``A[r]``.
- ``grouped_dw(A, a_idx, D, offs)``: (El, K, N) with
  ``C[e] = A[a_idx[rows of e]].T @ D[rows of e]``, zero for an empty group.

On CUDA tensors they launch ``csrc/grouped_gemm.cu`` (bf16 only, f32
accumulation) or raise; on CPU tensors they compute the plain version,
which loops over the groups with the offsets read on the host. Each
wrapper's ``launches`` counts its kernel launches.

``GroupedFFN`` is the expert half of the routed layer over those rows:
``Y = (act(x[tok] @ W1g + bias) * gate) @ W2`` with the hand-written
backward of ``docs/DERIVATIONS.md`` (K13 for dX and dW, the activation's
closed form). ``RowSum`` combines rows back to tokens.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import build

__all__ = ["grouped_rows", "grouped_dw", "grouped_rows_ref",
           "grouped_dw_ref", "GroupedFFN", "RowSum", "row_sum"]


@functools.cache
def _lib():
    lib = ctypes.CDLL(str(build("grouped_gemm")))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.grouped_rows_launch.argtypes = [ptr] * 5 + [i32] * 5 + [ptr]
    lib.grouped_dw_launch.argtypes = [ptr] * 5 + [i32] * 3 + [ptr]
    lib.grouped_rows_launch.restype = i32
    lib.grouped_dw_launch.restype = i32
    return lib


def _check(name, tensors, idx, offs):
    dev = tensors[0].device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError(f"{name} needs every tensor on one CUDA device")
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise ValueError(f"{name} takes bfloat16 operands, got "
                         f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")
    for what, t in (("a_idx", idx), ("offs", offs)):
        if t is not None and (t.dtype != torch.int32 or t.device != dev
                              or not t.is_contiguous() or t.dim() != 1):
            raise ValueError(f"{name}: {what} must be a contiguous int32 "
                             f"vector on {dev}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(name, rc):
    if rc:
        raise RuntimeError(f"{name} launch failed (CUDA error {rc})")


def grouped_rows_ref(A, a_idx, offs, W, M: int, trans: bool = False):
    """The plain version of ``grouped_rows`` (groups read on the host)."""
    N = W.shape[1] if trans else W.shape[2]
    C = A.new_zeros((M, N))
    o = offs.tolist()
    for e in range(W.shape[0]):
        lo, hi = o[e], o[e + 1]
        if hi > lo:
            a = A[a_idx[lo:hi].long()] if a_idx is not None else A[lo:hi]
            C[lo:hi] = a @ (W[e].T if trans else W[e])
    return C


def grouped_dw_ref(A, a_idx, D, offs):
    """The plain version of ``grouped_dw`` (groups read on the host)."""
    El, K, N = offs.shape[0] - 1, A.shape[1], D.shape[1]
    C = A.new_zeros((El, K, N))
    o = offs.tolist()
    for e in range(El):
        lo, hi = o[e], o[e + 1]
        if hi > lo:
            a = A[a_idx[lo:hi].long()] if a_idx is not None else A[lo:hi]
            C[e] = a.T @ D[lo:hi]
    return C


def grouped_rows(A, a_idx, offs, W, M: int, trans: bool = False):
    """C (M, N) = the grouped rows product (module docstring); W (El, K, N),
    or (El, N, K) when ``trans``."""
    if not A.is_cuda:
        return grouped_rows_ref(A, a_idx, offs, W, M, trans)
    _check("grouped_rows", [A, W], a_idx, offs)
    El = W.shape[0]
    K = A.shape[1]
    N = W.shape[1] if trans else W.shape[2]
    if (W.shape[2] if trans else W.shape[1]) != K:
        raise ValueError(f"grouped_rows: A has {K} columns, W is "
                         f"{tuple(W.shape)} (trans={trans})")
    if offs.shape[0] != El + 1:
        raise ValueError("grouped_rows: offs must hold El + 1 offsets")
    if a_idx is not None and a_idx.shape[0] < M - 1:
        raise ValueError("grouped_rows: a_idx must cover the routed rows")
    if K % 8 or N % 8 or M < 1:
        raise ValueError(f"grouped_rows: K {K} and N {N} must be multiples "
                         f"of 8, M {M} positive")
    C = torch.empty((M, N), dtype=A.dtype, device=A.device)
    with torch.cuda.device(A.device):
        rc = _lib().grouped_rows_launch(
            A.data_ptr(), None if a_idx is None else a_idx.data_ptr(),
            W.data_ptr(), C.data_ptr(), offs.data_ptr(), El, M, K, N,
            int(trans), _stream(A))
    _raise_on("grouped_rows", rc)
    grouped_rows.launches += 1
    return C


def grouped_dw(A, a_idx, D, offs):
    """(El, K, N) = the grouped weight gradient (module docstring)."""
    if not A.is_cuda:
        return grouped_dw_ref(A, a_idx, D, offs)
    _check("grouped_dw", [A, D], a_idx, offs)
    El, K, N = offs.shape[0] - 1, A.shape[1], D.shape[1]
    if K % 8 or N % 8:
        raise ValueError(f"grouped_dw: K {K} and N {N} must be multiples "
                         "of 8")
    C = torch.empty((El, K, N), dtype=A.dtype, device=A.device)
    with torch.cuda.device(A.device):
        rc = _lib().grouped_dw_launch(
            A.data_ptr(), None if a_idx is None else a_idx.data_ptr(),
            D.data_ptr(), C.data_ptr(), offs.data_ptr(), El, K, N,
            _stream(A))
    _raise_on("grouped_dw", rc)
    grouped_dw.launches += 1
    return C


grouped_rows.launches = 0
grouped_dw.launches = 0


def _acc_dtype(t):
    """t's accumulation dtype: float32 at least."""
    return torch.promote_types(t.dtype, torch.float32)


def row_sum(Y, R):
    """out[n] = sum_j Y[R[n, j]] in float32 (float64 for float64 Y),
    rounded once to Y's dtype; R (N, k) indexes Y's rows (its last row,
    zero, for "none")."""
    return Y[R].sum(1, dtype=_acc_dtype(Y)).to(Y.dtype)


class RowSum(torch.autograd.Function):
    """``row_sum(Y, R)`` with its backward dY[r] = dOut[tok[r]]: each routed
    row feeds exactly one token (``tok`` (M,) the token of each row of Y;
    the tail's rows, zero, take any token and reach nothing)."""

    @staticmethod
    def forward(ctx, Y, R, tok):
        ctx.save_for_backward(tok)
        return row_sum(Y, R)

    @staticmethod
    def backward(ctx, dout):
        (tok,) = ctx.saved_tensors
        return dout.index_select(0, tok), None, None


class GroupedFFN(torch.autograd.Function):
    """The routed rows' expert FFN, (M, D) rows sorted by expert:

        UG = x[tok] @ W1g + onehot @ b1g     (K13; UG = [U | G] when gated)
        H = act(U, G) or act(U)
        Y = (H * gate[:, None]) @ W2          (K13)

    x (Ntok, D); W1g (El, D, F or 2F); b1g (El, F or 2F); W2 (El, F, D);
    gate (M,) (zero on the tail); tok (M,) int32, the token of each row;
    offs (El + 1,) int32; onehot (M, El), each routed row's expert (zero
    on the tail); R (Ntok, k) each token's rows (M - 1, the last tail row,
    for "none"): dx is the row sum of dX's rows. ``act`` is (forward,
    backward) of ``nn.functional``: gated ``f(a, g)`` / ``(d/da, d/dg)``,
    or ``f(a)`` / ``d/da``. Saves UG; H is recomputed in the backward."""

    @staticmethod
    def forward(ctx, x, W1g, b1g, W2, gate, tok, offs, onehot, R, act,
                gated):
        M = gate.shape[0]
        UG = grouped_rows(x, tok, offs, W1g, M) + onehot @ b1g
        H = _act_fwd(UG, act, gated)
        Y = grouped_rows(H * gate[:, None], None, offs, W2, M)
        ctx.save_for_backward(x, W1g, W2, gate, tok, offs, onehot, R, UG)
        ctx.act, ctx.gated = act, gated
        return Y

    @staticmethod
    def backward(ctx, dY):
        x, W1g, W2, gate, tok, offs, onehot, R, UG = ctx.saved_tensors
        M = gate.shape[0]
        dY = dY.contiguous()
        H = _act_fwd(UG, ctx.act, ctx.gated)
        dHg = grouped_rows(dY, None, offs, W2, M, trans=True)
        dW2 = grouped_dw(H * gate[:, None], None, dY, offs)
        dgate = (dHg.to(_acc_dtype(dHg)) * H).sum(-1).to(gate.dtype)
        dH = dHg * gate[:, None]
        if ctx.gated:
            F_ = UG.shape[1] // 2
            da, dg = ctx.act[1](UG[:, :F_], UG[:, F_:])
            dUG = torch.cat([dH * da, dH * dg], dim=1)
        else:
            dUG = dH * ctx.act[1](UG)
        db1g = onehot.T @ dUG
        dW1g = grouped_dw(x, tok, dUG, offs)
        dx = row_sum(grouped_rows(dUG, None, offs, W1g, M, trans=True), R)
        return (dx, dW1g, db1g, dW2, dgate, None, None, None, None, None,
                None)


def _act_fwd(UG, act, gated: bool):
    if gated:
        F_ = UG.shape[1] // 2
        return act[0](UG[:, :F_], UG[:, F_:])
    return act[0](UG)
