"""Wrapper of the hand-written CUDA Householder panel kernels.

``factor_strip_cuda`` launches one of the two kernels of
``csrc/qr_panel.cu`` on the current CUDA stream, for strips (K1) and wider
panels (K12) alike, chosen by shape alone:

- the cluster kernel (``cluster_shape``), one thread-block cluster per
  strip holding the strip in registers, for b <= 64 rows whose live lanes
  m - (k & ~3) fill at most ``MAX_CLUSTER`` CTAs: every strip of the
  4096^2 QR;
- the grid kernel (``grid_shape``) for every other shape (K12's b 65-256,
  and strips with more live lanes than a cluster holds, such as every
  strip of a 16384 x 4096 QR): G <= ``MAX_GRID`` co-resident CTAs, one an
  SM, launched cooperatively, exchanging one reduction a step through L2.

Both compute the same function; at the cluster kernel's shapes it was
measured faster than the grid kernel at every one timed (PERF.md §6).
This is a shape rule between two hand-written kernels, not a fallback: a build, launch, cluster-scheduling
or co-residency failure raises, and nothing substitutes another
implementation. The plain PyTorch versions of the same function are
``linalg_tpu_torch.ops.qr_panel.factor_strip_ref`` and ``factor_panel_ref``,
and the dispatchers ``ops.qr_panel.factor_strip`` / ``factor_panel`` pick
between kernel and plain version by the device the tensor lies on.

``factor_strip_cuda.launches`` counts launches of both kernels,
``.cluster_launches`` and ``.grid_launches`` each, and ``.panel_launches``
those at K12's widths (b > 64), so a run can show that its QR went through
the kernels, and through which.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.numerics import eps_for
from .build import build

__all__ = ["factor_strip_cuda", "cluster_shape", "cluster_ctas",
           "grid_shape", "grid_lanes", "grid_on_chip", "MAX_B", "MAX_M",
           "MAX_CLUSTER", "MAX_GRID"]

# the kernels' limits (csrc/qr_panel.cu: MAX_B, MAX_M, MAX_CLUSTER,
# MAX_GRID)
MAX_B = 256
MAX_M = 32768
MAX_CLUSTER = 16
MAX_GRID = 128
CLUSTER_MAX_B = 64  # rows the cluster kernel holds in registers
CTA_THREADS = 256
GRID_MIN_LANES = 64  # lanes a grid CTA holds at least
# dynamic shared memory a grid CTA may take: the H100's 232,448 bytes a
# block, less the kernel's 6,208 static bytes and a margin
# (csrc/qr_panel.cu: GRID_SMEM)
GRID_SMEM = 221184
# the grid kernel's exchange buffer in 64-bit words: the launch epoch (low
# half) and the CTAs' finish count (high half) in the first word of a
# 128-byte head, then 2 parities x 2 MAX_B slots x (MAX_GRID partials, the
# total, the pivot entry) (csrc/qr_panel.cu: WORK_HEAD, WORK_WORDS, EPOCHS)
WORK_HEAD = 16
WORK_WORDS = WORK_HEAD + 2 * 2 * MAX_B * (MAX_GRID + 2)
EPOCHS = 1 << 23  # a word's tag is (epoch << 9) | (step + 1)
_work: dict[tuple[int, int], torch.Tensor] = {}


def cluster_ctas(m: int, k: int, lpt: int) -> int:
    """CTAs the cluster kernel needs for the live lanes m - (k & ~3) of a
    strip at ``lpt`` lanes a thread: ceil(live / (256 lpt)), at least 1."""
    live = max(m - (k & ~3), 0)
    return max(1, -(-live // (CTA_THREADS * lpt)))


def cluster_shape(b: int, m: int, k: int) -> tuple[int, int]:
    """(C, lanes a thread) of the cluster kernel for a (b, m) strip with
    pivots from lane k, or (0, 0) when the shape takes the grid kernel
    (``grid_shape``).

    The rule, from (b, m, k) alone (nothing is read back from the card):
    with live = m - (k & ~3) lanes, a CTA of 256 threads holds 256 of them
    at one lane a thread, so C = ceil(live / 256), at least 1; past 16
    CTAs a strip of b <= 32 rows takes two lanes a thread (C =
    ceil(live / 512), the rows then fill the registers); past that, or
    for b > 64, the grid kernel. One lane a thread is kept where it fits:
    at m 4096 its 16 CTAs beat two lanes' 8 (PERF.md §6)."""
    if b > CLUSTER_MAX_B:
        return 0, 0
    for lpt in ((1, 2) if b <= 32 else (1,)):
        C = cluster_ctas(m, k, lpt)
        if C <= MAX_CLUSTER:
            return C, lpt
    return 0, 0


def grid_lanes(live: int, G: int) -> int:
    """Lanes a grid CTA holds when ``live`` lanes are spread over at most G
    CTAs: ceil(live / G) rounded up to a multiple of 32."""
    return 32 * max(1, -(-live // (32 * G)))


def grid_shape(b: int, m: int, k: int,
               max_ctas: int = MAX_GRID) -> tuple[int, int, bool]:
    """(G CTAs, L lanes a CTA, S and Vt on chip) of the grid kernel for a
    (b, m) strip with pivots from lane k, at most ``max_ctas`` CTAs (the
    wrapper's rule takes ``MAX_GRID``; tools/bench_qr.py also times fewer).

    The rule, from (b, m, k) alone: the live lanes m - (k & ~3) are spread
    over at most ``max_ctas`` CTAs of at least 64 lanes (a multiple of 32),
    G = ceil(live / L), at least 1. A CTA's local work a step grows with L
    and a reducer's polls with G; the most CTAs measured best at every
    shape of phase 6 (PERF.md §6). S and Vt stay in the CTA's shared
    memory when their 2 b (L + 1) floats fit beside x, else in device
    memory (b >= 128 past m ~8192)."""
    live = max(m - (k & ~3), 0)
    L = max(GRID_MIN_LANES, grid_lanes(live, max_ctas))
    G = max(1, -(-live // L))
    return G, L, grid_on_chip(b, L)


def grid_on_chip(b: int, L: int) -> bool:
    """Whether a grid CTA of L lanes holds its S and Vt columns (2 b (L +
    1) floats) beside x (2 L) in shared memory."""
    return 4 * (2 * L + 2 * b * (L + 1)) <= GRID_SMEM


@functools.cache
def _launchers(lib: str | None = None):
    """The grid and the cluster launch entries of the built library, or of
    the library at path ``lib`` (a build of the same source with other
    flags)."""
    dll = ctypes.CDLL(lib or str(build("qr_panel")))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    grid = dll.qr_grid_launch
    grid.argtypes = ([ptr] * 5 + [i32] * 3 + [ctypes.c_float] + [i32] * 3
                     + [ptr])
    cluster = dll.qr_cluster_launch
    cluster.argtypes = ([ptr] * 4 + [i32] * 3 + [ctypes.c_float] + [i32] * 2
                        + [ptr])
    for fn in (grid, cluster):
        fn.restype = i32
    return grid, cluster


def _outputs(St: torch.Tensor):
    b, m = St.shape
    return (torch.empty_like(St), torch.empty_like(St),
            torch.empty((b, b), dtype=St.dtype, device=St.device))


def _check(rc: int, what: str):
    if rc == -2:
        raise RuntimeError(f"qr_panel: {what} cannot be scheduled on this "
                           "device")
    if rc:
        raise RuntimeError(f"qr_panel launch failed (code {rc})")


def _launch(St: torch.Tensor, k: int, C: int, lpt: int,
            lib: str | None = None):
    """One launch of the cluster kernel on a checked St, C CTAs at ``lpt``
    lanes a thread. Raises on any failure; counts nothing."""
    b, m = St.shape
    S_out, Vt, Tt = _outputs(St)
    stream = torch.cuda.current_stream(St.device).cuda_stream
    with torch.cuda.device(St.device):
        rc = _launchers(lib)[1](St.data_ptr(), S_out.data_ptr(),
                                Vt.data_ptr(), Tt.data_ptr(), b, m, k,
                                eps_for(torch.float32), C, lpt, stream)
    _check(rc, f"a cluster of {C} CTAs")
    return S_out, Vt, Tt


def _work_buffer(device: torch.device, stream: int) -> torch.Tensor:
    """The grid kernel's exchange buffer of the stream: zeroed once, when
    the stream's first grid launch is made, and kept. A launch tags its
    words with an epoch that the kernel reads from the buffer and its
    last CTA to finish advances, so no word of an earlier launch carries
    a live tag and no launch needs the buffer cleared. Launches on one
    stream run in order; a CUDA graph keeps the buffer of the stream it
    was captured on, so its replays must not overlap launches on that
    stream. A stream's first launch cannot be made inside a capture (the
    buffer's zeroing would only be recorded, not run)."""
    key = (device.index, stream)
    work = _work.get(key)
    if work is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "qr_panel: the grid kernel's first launch on a stream cannot "
                "be captured; launch it once on the capturing stream first")
        work = _work[key] = torch.zeros(WORK_WORDS, dtype=torch.int64,
                                        device=device)
    return work


def _launch_grid(St: torch.Tensor, k: int, G: int, L: int, on_chip: bool,
                 lib: str | None = None):
    """One launch of the grid kernel on a checked St, G co-resident CTAs
    of L lanes, S and Vt on chip or in device memory, exchanging through
    the stream's buffer (``_work_buffer``). Raises on any failure, a
    refused cooperative launch included; counts nothing."""
    b, m = St.shape
    S_out, Vt, Tt = _outputs(St)
    stream = torch.cuda.current_stream(St.device).cuda_stream
    work = _work_buffer(St.device, stream)
    with torch.cuda.device(St.device):
        rc = _launchers(lib)[0](St.data_ptr(), S_out.data_ptr(),
                                Vt.data_ptr(), Tt.data_ptr(),
                                work.data_ptr(), b, m, k,
                                eps_for(torch.float32), G, L, int(on_chip),
                                stream)
    _check(rc, f"a grid of {G} co-resident CTAs")
    return S_out, Vt, Tt


def factor_strip_cuda(St: torch.Tensor, k: int):
    """Householder sweep over a transposed strip ``St`` (b, m) float32,
    pivots starting at lane ``k``; b <= MAX_B, m <= MAX_M, contiguous, on
    a CUDA device. Returns (St_out, Vt (b, m), Tt (b, b)) with the contract
    of ``linalg_tpu/ops/pallas/qr_panel.py``. The kernel is the cluster
    kernel when ``cluster_shape(b, m, k)`` gives it a cluster, else the
    grid kernel at ``grid_shape(b, m, k)``."""
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
        raise ValueError(f"m = {m} outside [1, {MAX_M}]")
    k = int(k)
    if k < 0:
        raise ValueError(f"pivot offset k = {k} must be >= 0")
    if not St.is_contiguous():
        raise ValueError("factor_strip_cuda needs a contiguous St")
    C, lpt = cluster_shape(b, m, k)
    if C:
        out = _launch(St, k, C, lpt)
        factor_strip_cuda.cluster_launches += 1
    else:
        out = _launch_grid(St, k, *grid_shape(b, m, k))
        factor_strip_cuda.grid_launches += 1
    if b > CLUSTER_MAX_B:
        factor_strip_cuda.panel_launches += 1
    factor_strip_cuda.launches += 1
    return out


factor_strip_cuda.launches = 0
factor_strip_cuda.cluster_launches = 0
factor_strip_cuda.grid_launches = 0
factor_strip_cuda.panel_launches = 0
