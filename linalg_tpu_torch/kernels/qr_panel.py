"""Wrapper of the hand-written CUDA Householder panel kernel.

``factor_strip_cuda`` launches ``csrc/qr_panel.cu`` on the current CUDA
stream, for strips (K1) and wider panels (K12) alike. It validates every
argument and raises on what the kernel does not take; it never substitutes
another implementation. The plain PyTorch versions of the same function
are ``linalg_tpu_torch.ops.qr_panel.factor_strip_ref`` and
``factor_panel_ref``, and the dispatcher ``ops.qr_panel.factor_strip``
picks between kernel and plain version by the device the tensor lies on.

``factor_strip_cuda.launches`` counts launches, so a run can show that its
QR went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.numerics import eps_for
from .build import build

__all__ = ["factor_strip_cuda", "MAX_B", "MAX_M"]

# the kernel's limits (csrc/qr_panel.cu: MAX_B, MAX_M)
MAX_B = 256
MAX_M = 32768


@functools.cache
def _launcher():
    fn = ctypes.CDLL(str(build("qr_panel"))).qr_panel_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def factor_strip_cuda(St: torch.Tensor, k: int):
    """Householder sweep over a transposed strip ``St`` (b, m) float32,
    pivots starting at lane ``k``; b <= MAX_B, m <= MAX_M, contiguous, on
    a CUDA device. Returns (St_out, Vt (b, m), Tt (b, b)) with the contract
    of ``linalg_tpu/ops/pallas/qr_panel.py``."""
    if not isinstance(St, torch.Tensor) or not St.is_cuda:
        raise ValueError("factor_strip_cuda needs a tensor on a CUDA device")
    if St.dtype != torch.float32:
        raise ValueError(f"unsupported dtype {St.dtype} (the kernel is "
                         "float32 only)")
    if St.ndim != 2:
        raise ValueError(f"St must be 2-D (b, m), got shape {tuple(St.shape)}")
    b, m = St.shape
    if not 1 <= b <= MAX_B:
        raise ValueError(f"strip width b = {b} outside [1, {MAX_B}]")
    if not 1 <= m <= MAX_M:
        raise ValueError(f"m = {m} outside [1, {MAX_M}] (the reflector is "
                         "kept in shared memory)")
    k = int(k)
    if k < 0:
        raise ValueError(f"pivot offset k = {k} must be >= 0")
    if not St.is_contiguous():
        raise ValueError("factor_strip_cuda needs a contiguous St")
    S_out = torch.empty_like(St)
    Vt = torch.empty_like(St)
    Tt = torch.empty((b, b), dtype=St.dtype, device=St.device)
    stream = torch.cuda.current_stream(St.device).cuda_stream
    with torch.cuda.device(St.device):
        rc = _launcher()(St.data_ptr(), S_out.data_ptr(), Vt.data_ptr(),
                         Tt.data_ptr(), b, m, k, eps_for(torch.float32),
                         stream)
    if rc:
        raise RuntimeError(f"qr_panel launch failed (code {rc})")
    factor_strip_cuda.launches += 1
    return S_out, Vt, Tt


factor_strip_cuda.launches = 0
