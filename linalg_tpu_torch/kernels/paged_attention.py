"""Wrapper of the hand-written CUDA paged decode-attention kernels.

``paged_attention_cuda`` launches ``csrc/paged_attention.cu`` on the
current CUDA stream: a partials kernel that splits each slot's live KV
tiles over ``S`` blocks per (slot, KV head), then a combine kernel that
merges the S partials of each (slot, query head). It validates every
argument and raises on what the kernels do not take; it never substitutes
another implementation. The plain PyTorch versions are in
``linalg_tpu_torch.serve.paged``: ``paged_attention_ref`` for the whole
function, ``paged_attention_partials_ref`` and
``paged_attention_combine_ref`` for the two kernels. The dispatcher
``serve.paged.paged_attention`` picks between kernel and plain version by
the device the tensors lie on.

``paged_attention_cuda.launches`` counts calls (each call makes two CUDA
launches), so a run can show that its decode went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .build import build

__all__ = ["paged_attention_cuda", "paged_splits", "head_block",
           "SUPPORTED_D", "TILE_ROWS"]

# every multiple of 8 from 8 to 256
SUPPORTED_D = range(8, 257, 8)
# key rows of a tile, the unit the partials kernel splits a slot's live
# rows by (TILE in csrc/paged_attention.cu, which checks it)
TILE_ROWS = 32
# the partials grid should cover this many waves of the card's SMs
WAVES = 2
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _launcher():
    fn = ctypes.CDLL(str(build("paged_attention"))).paged_attention_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def head_block(g: int) -> int:
    """Query heads one partials block serves, of a KV head's ``g``: the
    least power of two >= g, at most 8 (ceil(g / 8) blocks share a KV head
    past that)."""
    return min(8, 1 << (g - 1).bit_length())


def paged_splits(B: int, H: int, hk: int, page: int, Pmax: int,
                 n_sm: int) -> int:
    """Splits S of each slot's live tiles: enough blocks (B * hk * ng * S)
    for ``WAVES`` waves of ``n_sm`` SMs, at most the tiles in ctx. Chosen
    from shapes alone: the positions stay on the device."""
    g = H // hk
    blocks = B * hk * -(-g // head_block(g))
    tiles = Pmax * -(-page // TILE_ROWS)
    return max(1, min(tiles, -(-WAVES * n_sm // blocks)))


def paged_attention_cuda(q, pool_k, pool_v, mask, table, pos):
    """Decode attention against a paged KV pool, pages read in place.

    ``q`` (B, H, 1, d); ``pool_k``/``pool_v`` (n_pages, hk, page, d) with
    hk | H; ``mask`` (B, 1|H, 1, ctx) additive, ctx = Pmax * page;
    ``table`` (B, Pmax) int32; ``pos`` (B,) int32. q, pools and mask share
    one dtype, float32 or bfloat16; d is a multiple of 8 from 8 to 256;
    page % 8 == 0. All tensors contiguous on one CUDA device, pools and
    mask 16-byte aligned. S comes from ``paged_splits``. Returns (B, H, 1,
    d)."""
    B, H, one, d = q.shape
    n_pages, hk, page, d_k = pool_k.shape
    Pmax = table.shape[-1]
    tensors = (q, pool_k, pool_v, mask, table, pos)
    dev = q.get_device()  # -1 on the CPU
    if dev < 0 or not all(t.get_device() == dev for t in tensors):
        raise ValueError("paged_attention_cuda needs every tensor on one "
                         "CUDA device")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtype {q.dtype} (float32, bfloat16)")
    if not (pool_k.dtype == pool_v.dtype == mask.dtype == q.dtype):
        raise ValueError("q, pools and mask must share one dtype")
    if table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("table and pos must be int32")
    if d not in SUPPORTED_D:
        raise ValueError(f"d_head {d} unsupported (the kernel takes "
                         f"multiples of 8 from 8 to 256)")
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
    if any(t.data_ptr() % 16 for t in (pool_k, pool_v, mask)):
        raise ValueError("pools and mask must be 16-byte aligned")
    S = paged_splits(B, H, hk, page, Pmax, _sm_count(dev))
    out = torch.empty_like(q)
    scratch = torch.empty(B * H * S * (d + 2) + 4, dtype=torch.float32,
                          device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = _launcher()(
            _DTYPE_CODE[q.dtype], q.data_ptr(), pool_k.data_ptr(),
            pool_v.data_ptr(), mask.data_ptr(), table.data_ptr(),
            pos.data_ptr(), scratch.data_ptr(), out.data_ptr(), B, H, hk, d,
            page, Pmax, mask.shape[1], head_block(H // hk), S, TILE_ROWS,
            1.0 / math.sqrt(d), stream)
    if rc:
        raise RuntimeError(f"paged_attention launch failed (code {rc})")
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0
