"""Wrapper of the hand-written CUDA Householder panel kernels.

``factor_strip_cuda`` launches one of the two kernels of
``csrc/qr_panel.cu`` on the current CUDA stream, for strips (K1) and wider
panels (K12) alike, chosen by shape alone (``cluster_shape``):

- the cluster kernel, one thread-block cluster per strip holding the strip
  in registers, for b <= 64 rows whose live lanes m - (k & ~3) fill at
  most ``MAX_CLUSTER`` CTAs: every strip of the 4096^2 QR;
- the single-block kernel for every other shape (K12's b 128-256, or more
  live lanes than a cluster holds).

Both compute the same function. This is a shape rule between two
hand-written kernels, not a fallback: a build, launch or cluster-scheduling
failure raises, and nothing substitutes another implementation. The plain
PyTorch versions of the same function are
``linalg_tpu_torch.ops.qr_panel.factor_strip_ref`` and ``factor_panel_ref``,
and the dispatcher ``ops.qr_panel.factor_strip`` picks between kernel and
plain version by the device the tensor lies on.

``factor_strip_cuda.launches`` counts launches of both kernels,
``.cluster_launches`` and ``.block_launches`` each, so a run can show that
its QR went through the kernels, and through which.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.numerics import eps_for
from .build import build

__all__ = ["factor_strip_cuda", "cluster_shape", "cluster_ctas", "MAX_B",
           "MAX_M", "MAX_CLUSTER"]

# the kernels' limits (csrc/qr_panel.cu: MAX_B, MAX_M, MAX_CLUSTER)
MAX_B = 256
MAX_M = 32768
MAX_CLUSTER = 16
CLUSTER_MAX_B = 64  # rows the cluster kernel holds in registers
CTA_THREADS = 256


def cluster_ctas(m: int, k: int, lpt: int) -> int:
    """CTAs the cluster kernel needs for the live lanes m - (k & ~3) of a
    strip at ``lpt`` lanes a thread: ceil(live / (256 lpt)), at least 1."""
    live = max(m - (k & ~3), 0)
    return max(1, -(-live // (CTA_THREADS * lpt)))


def cluster_shape(b: int, m: int, k: int) -> tuple[int, int]:
    """(C, lanes a thread) of the cluster kernel for a (b, m) strip with
    pivots from lane k, or (0, 0) when the shape takes the single-block
    kernel.

    The rule, from (b, m, k) alone (nothing is read back from the card):
    with live = m - (k & ~3) lanes, a CTA of 256 threads holds 256 of them
    at one lane a thread, so C = ceil(live / 256), at least 1; past 16
    CTAs a strip of b <= 32 rows takes two lanes a thread (C =
    ceil(live / 512), the rows then fill the registers); past that, or
    for b > 64, the single-block kernel. One lane a thread is kept where
    it fits: at m 4096 its 16 CTAs beat two lanes' 8 (PERF.md §6)."""
    if b > CLUSTER_MAX_B:
        return 0, 0
    for lpt in ((1, 2) if b <= 32 else (1,)):
        C = cluster_ctas(m, k, lpt)
        if C <= MAX_CLUSTER:
            return C, lpt
    return 0, 0


@functools.cache
def _launchers(lib: str | None = None):
    """The single-block and the cluster launch entries of the built
    library, or of the library at path ``lib`` (a build of the same
    source with other flags)."""
    dll = ctypes.CDLL(lib or str(build("qr_panel")))
    fns = []
    for name, n_int in (("qr_panel_launch", 0), ("qr_cluster_launch", 2)):
        fn = getattr(dll, name)
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_float] + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns.append(fn)
    return tuple(fns)


def _launch(St: torch.Tensor, k: int, C: int, lpt: int,
            lib: str | None = None):
    """One launch on a checked St: the cluster kernel of C CTAs at ``lpt``
    lanes a thread, or the single-block kernel for C 0. Raises on any
    failure; counts nothing."""
    b, m = St.shape
    S_out = torch.empty_like(St)
    Vt = torch.empty_like(St)
    Tt = torch.empty((b, b), dtype=St.dtype, device=St.device)
    stream = torch.cuda.current_stream(St.device).cuda_stream
    args = (St.data_ptr(), S_out.data_ptr(), Vt.data_ptr(), Tt.data_ptr(),
            b, m, k, eps_for(torch.float32))
    block, cluster = _launchers(lib)
    with torch.cuda.device(St.device):
        if C:
            rc = cluster(*args, C, lpt, stream)
        else:
            rc = block(*args, stream)
    if rc == -2:
        raise RuntimeError(f"qr_panel: no cluster of {C} CTAs can be "
                           "scheduled on this device")
    if rc:
        raise RuntimeError(f"qr_panel launch failed (code {rc})")
    return S_out, Vt, Tt


def factor_strip_cuda(St: torch.Tensor, k: int):
    """Householder sweep over a transposed strip ``St`` (b, m) float32,
    pivots starting at lane ``k``; b <= MAX_B, m <= MAX_M, contiguous, on
    a CUDA device. Returns (St_out, Vt (b, m), Tt (b, b)) with the contract
    of ``linalg_tpu/ops/pallas/qr_panel.py``. The kernel is the cluster
    kernel when ``cluster_shape(b, m, k)`` gives it a cluster, else the
    single-block kernel."""
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
    C, lpt = cluster_shape(b, m, k)
    out = _launch(St, k, C, lpt)
    factor_strip_cuda.launches += 1
    if C:
        factor_strip_cuda.cluster_launches += 1
    else:
        factor_strip_cuda.block_launches += 1
    return out


factor_strip_cuda.launches = 0
factor_strip_cuda.cluster_launches = 0
factor_strip_cuda.block_launches = 0
