"""Wrapper of the hand-written CUDA paged decode-attention kernel.

``paged_attention_cuda`` launches ``csrc/paged_attention.cu`` on the
current CUDA stream. It validates every argument and raises on what the
kernel does not take; it never substitutes another implementation. The
plain PyTorch version of the same function is
``linalg_tpu_torch.serve.paged.paged_attention_ref``, and the dispatcher
``serve.paged.paged_attention`` picks between the two by the device the
tensors lie on.

``paged_attention_cuda.launches`` counts launches, so a run can show that
its decode went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .build import build

__all__ = ["paged_attention_cuda", "SUPPORTED_D"]

SUPPORTED_D = (32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _launcher():
    fn = ctypes.CDLL(str(build("paged_attention"))).paged_attention_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                   + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def paged_attention_cuda(q, pool_k, pool_v, mask, table, pos):
    """Decode attention against a paged KV pool, pages read in place.

    ``q`` (B, H, 1, d); ``pool_k``/``pool_v`` (n_pages, hk, page, d) with
    hk | H; ``mask`` (B, 1|H, 1, ctx) additive, ctx = Pmax * page;
    ``table`` (B, Pmax) int32; ``pos`` (B,) int32. q, pools and mask share
    one dtype, float32 or bfloat16; d is 32, 64 or 128; page % 8 == 0. All
    tensors contiguous on one CUDA device. Returns (B, H, 1, d)."""
    B, H, one, d = q.shape
    n_pages, hk, page, d_k = pool_k.shape
    Pmax = table.shape[-1]
    tensors = (q, pool_k, pool_v, mask, table, pos)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("paged_attention_cuda needs every tensor on one "
                         "CUDA device")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtype {q.dtype} (float32, bfloat16)")
    if not (pool_k.dtype == pool_v.dtype == mask.dtype == q.dtype):
        raise ValueError("q, pools and mask must share one dtype")
    if table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("table and pos must be int32")
    if d not in SUPPORTED_D:
        raise ValueError(f"d_head {d} unsupported (the kernel is built for "
                         f"{SUPPORTED_D})")
    if page % 8:
        raise ValueError(f"page {page} must be a multiple of 8")
    if one != 1 or d_k != d or H % hk or pool_v.shape != pool_k.shape:
        raise ValueError("shape mismatch: q (B,H,1,d), pools "
                         "(n_pages,hk,page,d) with hk | H")
    if (table.shape != (B, Pmax) or pos.shape != (B,)
            or mask.shape[0] != B or mask.shape[1] not in (1, H)
            or mask.shape[2] != 1 or mask.shape[3] != Pmax * page):
        raise ValueError("shape mismatch: mask (B,1|H,1,Pmax*page), table "
                         "(B,Pmax), pos (B,)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention_cuda needs contiguous tensors")
    if any(t.data_ptr() % 16 for t in (pool_k, pool_v)):
        raise ValueError("pools must be 16-byte aligned")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = _launcher()(
            _DTYPE_CODE[q.dtype], q.data_ptr(), pool_k.data_ptr(),
            pool_v.data_ptr(), mask.data_ptr(), table.data_ptr(),
            pos.data_ptr(), out.data_ptr(), B, H, hk, d, page, Pmax,
            mask.shape[1], 1.0 / math.sqrt(d), stream)
    if rc:
        raise RuntimeError(f"paged_attention launch failed (code {rc})")
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0
