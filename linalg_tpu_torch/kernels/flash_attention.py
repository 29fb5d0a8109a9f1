"""Wrappers of the hand-written CUDA flash-attention kernels.

``flash_fwd_cuda``, ``flash_dq_cuda`` and ``flash_dkdv_cuda`` launch the
three kernels of ``csrc/flash_attention.cu`` on the current CUDA stream;
``flash_delta_cuda`` launches its one pass of the backward outside them,
delta = rowsum(dO * O).
Each validates its arguments and raises on what the kernel does not take;
none substitutes another implementation. The plain PyTorch versions are
``linalg_tpu_torch.nn.flash.flash_fwd_ref`` / ``flash_bwd_ref`` /
``flash_delta_ref``, and the dispatchers ``nn.flash.flash_fwd`` /
``flash_bwd`` pick between the two by the device the tensors lie on.

``window`` (a sliding-window band, None for none) and ``group`` (query
heads per K/V head) are K4's: with ``group`` g > 1, k and v are
(B, H / g, T, d) and dk, dv come back at that grouped size. Without it,
K/V must have q's heads.

Head tensors are read and written through their strides: any (B, H, T,
d) view whose d axis is contiguous and whose other strides are multiples
of 16 bytes, such as the head view ``x.view(B, T, H, d).transpose(1, 2)``
of the model's (B, T, H*d) projections (K7, ``nn.flash_btd``). Outputs
take the layout of the input they mirror (``torch.empty_like``): o and dq
q's, dk and dv k's and v's.

Each wrapper's ``launches`` attribute counts its launches, so a run can
show that its attention went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .build import build

__all__ = ["flash_fwd_cuda", "flash_dq_cuda", "flash_dkdv_cuda",
           "flash_delta_cuda", "reads_in_place", "SUPPORTED_D", "BLOCK"]

SUPPORTED_D = (32, 64, 128, 256)
BLOCK = 64  # rows per tile: T must be a multiple
MAX_BH = 65535  # batch * heads rides the grid's y dimension
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib():
    lib = ctypes.CDLL(str(build("flash_attention")))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # B, H, T, causal, window, group, scale, strides, stream
    tail = [i32, i32, i32, i32, i32, i32, f32, ptr, ptr]
    lib.flash_fwd_launch.argtypes = [i32, i32] + [ptr] * 5 + tail
    lib.flash_dq_launch.argtypes = [i32, i32] + [ptr] * 7 + tail
    lib.flash_dkdv_launch.argtypes = [i32, i32] + [ptr] * 8 + tail
    lib.flash_delta_launch.argtypes = [i32, i32] + [ptr] * 3 + tail
    for fn in (lib.flash_fwd_launch, lib.flash_dq_launch,
               lib.flash_dkdv_launch, lib.flash_delta_launch):
        fn.restype = i32
    lib.flash_smem_bytes.argtypes = [i32, i32, i32]
    lib.flash_smem_bytes.restype = ctypes.c_longlong
    return lib


def smem_bytes(dtype_code: int, d: int, which: int) -> int:
    """Dynamic shared memory (bytes) of one kernel: dtype_code 0 float32,
    1 bfloat16; which 0 forward, 1 dq, 2 dk/dv (-1 for none)."""
    return int(_lib().flash_smem_bytes(dtype_code, d, which))


def _strides_ok(t):
    """The d axis contiguous and the batch, head and row strides multiples
    of 16 bytes: the layouts the kernels read and write in place."""
    vec = 16 // t.element_size()  # elements in 16 bytes
    return t.stride(3) == 1 and not any(st % vec for st in t.stride()[:3])


def reads_in_place(t) -> bool:
    """True when the kernels take the (B, H, T, d) tensor ``t`` as it lies
    (``_check``'s stride and alignment rules), so a caller need not copy
    it: contiguous heads and the model's transposed head views of
    (B, T, H*d) both qualify."""
    return _strides_ok(t) and t.data_ptr() % 16 == 0


def _check(name, heads, rows=(), group=1):
    """Validate the tensors ``heads`` = (q, k, v[, dO]), q and dO
    (B, H, T, d), k and v (B, H / group, T, d), and the f32 (B, H, T)
    ``rows``; return (B*H, T, d)."""
    q = heads[0]
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be (B, H, T, d), got "
                         f"{tuple(q.shape)}")
    B, H, T, d = q.shape
    if not all(t.is_cuda and t.device == q.device for t in heads + rows):
        raise ValueError(f"{name} needs every tensor on one CUDA device")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: unsupported dtype {q.dtype} (float32, "
                         "bfloat16)")
    if any(t.dtype != q.dtype for t in heads):
        raise ValueError(f"{name}: q, k, v (and o, dO) must share one dtype")
    if group < 1 or H % group:
        raise ValueError(f"{name}: group {group} must divide the {H} query "
                         "heads")
    kv_shape = (B, H // group, T, d)
    if any(t.shape != q.shape for t in heads[3:]) or any(
            t.shape != kv_shape for t in heads[1:3]):
        raise ValueError(
            f"{name}: q (and dO) must be (B, H, T, d) and k, v "
            f"(B, H / group, T, d) = {kv_shape}, got "
            f"{[tuple(t.shape) for t in heads]}; grouped K/V heads are "
            "taken only with group = H / hk")
    if any(t.dtype != torch.float32 or t.shape != (B, H, T) for t in rows):
        raise ValueError(f"{name}: L and delta must be float32 (B, H, T)")
    if d not in SUPPORTED_D:
        raise ValueError(f"{name}: d_head {d} unsupported (the kernels are "
                         f"built for {SUPPORTED_D})")
    if T == 0 or T % BLOCK:
        raise ValueError(f"{name}: T {T} must be a positive multiple of "
                         f"{BLOCK}")
    if not 0 < B * H <= MAX_BH:
        raise ValueError(f"{name}: B*H {B * H} outside (0, {MAX_BH}]")
    if not all(t.is_contiguous() for t in rows):
        raise ValueError(f"{name} needs contiguous L and delta")
    if not all(_strides_ok(t) for t in heads):
        raise ValueError(f"{name}: each head's d axis must be contiguous "
                         "and the batch, head and row strides multiples of "
                         "16 bytes")
    if any(t.data_ptr() % 16 for t in heads):
        raise ValueError(f"{name} needs 16-byte aligned tensors")
    return B, H, T, d


def _strides(*tensors):
    """The (batch, head, row) strides of q, k, v, o, dO, dq, dk, dv (None
    for a tensor the launch does not take) as the kernels' int64 array."""
    vals = []
    for t in tensors:
        vals += list(t.stride()[:3]) if t is not None else [0, 0, 0]
    return (ctypes.c_longlong * 24)(*vals)


def _call(name, fn, dtype, dims, ptrs, causal, window, group, strides,
          device, scale):
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be >= 1 or None, got "
                         f"{window}")
    B, H, T, d = dims
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = fn(_DTYPE_CODE[dtype], d, *ptrs, B, H, T, int(bool(causal)),
                window or 0, group,
                1.0 / math.sqrt(d) if scale is None else float(scale),
                strides, stream)
    if rc:
        raise RuntimeError(f"{name} launch failed (code {rc})")


def flash_fwd_cuda(q, k, v, causal: bool = True, window=None,
                   group: int = 1, scale=None):
    """Attention forward: q (B, H, T, d), k, v (B, H / group, T, d) ->
    (o (B, H, T, d) in q's dtype, L (B, H, T) float32 row logsumexp).
    ``scale`` multiplies q k^T (default 1/sqrt(d); a head zero-padded to
    d passes its true width's)."""
    dims = _check("flash_fwd_cuda", (q, k, v), group=group)
    o = torch.empty_like(q)
    L = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _call("flash_fwd", _lib().flash_fwd_launch, q.dtype, dims,
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
           L.data_ptr()), causal, window, group,
          _strides(q, k, v, o, None, None, None, None), q.device, scale)
    flash_fwd_cuda.launches += 1
    return o, L


def flash_dq_cuda(q, k, v, do, L, delta, causal: bool = True, window=None,
                  group: int = 1, scale=None):
    """dq of attention from the forward's L and delta = rowsum(dO * O)
    (both float32 (B, H, T))."""
    dims = _check("flash_dq_cuda", (q, k, v, do), (L, delta), group)
    dq = torch.empty_like(q)
    _call("flash_dq", _lib().flash_dq_launch, q.dtype, dims,
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           L.data_ptr(), delta.data_ptr(), dq.data_ptr()), causal, window,
          group, _strides(q, k, v, None, do, dq, None, None), q.device,
          scale)
    flash_dq_cuda.launches += 1
    return dq


def flash_dkdv_cuda(q, k, v, do, L, delta, causal: bool = True, window=None,
                    group: int = 1, scale=None):
    """(dk, dv) of attention from the same inputs as ``flash_dq_cuda``, at
    k's grouped size: each K/V head's gradient summed over its group in
    float32 and rounded once."""
    dims = _check("flash_dkdv_cuda", (q, k, v, do), (L, delta), group)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _call("flash_dkdv", _lib().flash_dkdv_launch, q.dtype, dims,
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           L.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr()),
          causal, window, group,
          _strides(q, k, v, None, do, None, dk, dv), q.device, scale)
    flash_dkdv_cuda.launches += 1
    return dk, dv


def flash_delta_cuda(o, do):
    """delta = rowsum(dO * O) in float32, (B, H, T), from the forward's o
    and the incoming dO (both (B, H, T, d), one dtype, any layout the
    other wrappers take): the input the dq and dk/dv kernels take besides
    L, read once from each tensor."""
    dims = _check("flash_delta_cuda", (o, o, o, do))
    delta = torch.empty(o.shape[:3], dtype=torch.float32, device=o.device)
    _call("flash_delta", _lib().flash_delta_launch, o.dtype, dims,
          (o.data_ptr(), do.data_ptr(), delta.data_ptr()), False, None, 1,
          _strides(None, None, None, o, do, None, None, None), o.device,
          None)
    flash_delta_cuda.launches += 1
    return delta


flash_fwd_cuda.launches = 0
flash_dq_cuda.launches = 0
flash_dkdv_cuda.launches = 0
flash_delta_cuda.launches = 0
