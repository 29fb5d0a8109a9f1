"""Paged KV cache for the serving engine — the counterpart of
``linalg_tpu/serve/paged.py``.

The K/V of every slot live in ONE pool of fixed-size pages plus a
per-slot page table:

- ``pool_k``/``pool_v``: (L, n_pages, kv_heads, page, d_head);
- ``table``: (n_slots, ctx_len/page) int32 — slot s's logical rows
  [i*page, (i+1)*page) live in pool page ``table[s, i]``;
- ``pos``: (n_slots,) int32 slot positions.

Page 0 is the TRASH page: idle slots keep decoding and their writes land
there, because a retired slot's table row is reset to 0. Admission
reserves pages from a host-side free list (``PageAllocator``). Pages of a
registered prefix, or of the engine's page cache, stand in several slots'
tables at once: every reader walks them in place, and no slot writes
them (``_admit_slot_paged`` scatters their rows into the trash page).

Decode attention reads the pool one of two ways:

- ``paged_attention``: the hand-written CUDA kernels
  (``kernels/csrc/paged_attention.cu``) read each slot's live pages in
  place and stop the walk at the slot's position: a partials kernel splits
  the live tiles of each (slot, KV head) over S blocks, a combine kernel
  merges their partial softmax states. They replace both Pallas kernels of
  the JAX package (``paged_attn_pallas_dma`` and ``paged_attn_pallas``).
  On a CPU tensor the dispatcher computes the plain version,
  ``paged_attention_ref``; ``paged_attention_partials_ref`` and
  ``paged_attention_combine_ref`` are the plain versions of the two
  kernels, split rule included.
- the table gather: materialize each slot's (kv_heads, ctx, d) view and
  run the grouped decode attention over it — the JAX ``use_kernel=False``
  path, kept as an engine mode the user picks (``paged_attn="gather"``).

``kv8`` pools hold int8 rows with a per-row f32 scale ({"q", "s"}
dicts): each row is quantized once, when it is written, and the gather
dequantizes it; the kernels read plain pools only, as in the JAX
package.

The pools, table and positions are updated IN PLACE.
"""

from __future__ import annotations

import math
from typing import List

import torch

from ..kernels.paged_attention import SUPPORTED_D as SUPPORTED_KERNEL_D
from ..kernels.paged_attention import TILE_ROWS, paged_attention_cuda
from ..models.gpt import GPTConfig, _decode_chunk_core, _gqa_decode_attn
from ..models.quant import _kv8_dequant, _kv_row_quantize, _layer_views

__all__ = ["init_paged_cache", "PageAllocator", "decode_chunk_paged",
           "paged_attention", "paged_attention_ref",
           "paged_attention_partials_ref", "paged_attention_combine_ref",
           "SUPPORTED_KERNEL_D"]

# the running max of a split that saw no row (float32 min / 2, as in Pallas)
NEG_INIT = float(torch.finfo(torch.float32).min) / 2


def init_paged_cache(cfg: GPTConfig, n_slots: int, n_pages: int, page: int,
                     kv8: bool = False, device=None):
    """Zeroed paged cache. ``ctx_len`` must divide by ``page``; page 0 is
    the trash page.

    ``kv8=True`` stores the pools int8 with a per-row f32 scale (each row
    quantized once, at write time, against its own max-abs: the
    ``models.quant`` int8-KV scheme), so the same memory holds about twice
    the pages of bf16. The pools are then {"q": int8 (..., page, d), "s":
    f32 (..., page, 1)} dicts, read by the table gather only."""
    if cfg.ctx_len % page:
        raise ValueError(f"page size {page} must divide ctx_len "
                         f"{cfg.ctx_len}")
    if n_pages < 2:
        raise ValueError("need at least 2 pages (page 0 is the trash page)")
    shape = (cfg.n_layers, n_pages, cfg.kv_heads, page, cfg.d_head)
    dt = cfg.compute_dtype

    def pool():
        if kv8:
            return {"q": torch.zeros(shape, dtype=torch.int8, device=device),
                    "s": torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                     device=device)}
        return torch.zeros(shape, dtype=dt, device=device)

    return {
        "pool_k": pool(),
        "pool_v": pool(),
        "table": torch.zeros((n_slots, cfg.ctx_len // page),
                             dtype=torch.int32, device=device),
        "pos": torch.zeros((n_slots,), dtype=torch.int32, device=device),
    }


class PageAllocator:
    """Host-side free list over pages 1..n_pages-1 (0 = trash)."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages - 1, 0, -1))

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` pages or raise MemoryError (caller checks n_free)."""
        if n > len(self._free):
            raise MemoryError(f"need {n} pages, {len(self._free)} free")
        if n <= 0:  # the JAX allocator's [-0:] slice would take them all
            return []
        taken, self._free = self._free[-n:], self._free[:-n]
        return list(reversed(taken))

    def release(self, pages: List[int]) -> None:
        for p in pages:
            if not 0 < p < self.n_pages:
                raise ValueError(f"page {p} is not an allocatable page")
        self._free.extend(pages)


def _pages_of(x, page: int):
    """(L, 1, hk, ctx, d) prefill buffer -> (L, ctx/page, hk, page, d)."""
    L, _, hk, ctx, d = x.shape
    return x[:, 0].reshape(L, hk, ctx // page, page, d).transpose(1, 2)


def _scatter_pages(cache, slot_k, slot_v, page_ids):
    """Write a prefilled sequence's pages into the pool at ``page_ids``
    ((ctx/page,) int); entries 0 dump their rows into the trash page. An
    int8 pool quantizes each row here, by the rule decode writes use."""
    ids = page_ids.long()
    for name, slot in (("pool_k", slot_k), ("pool_v", slot_v)):
        pool = cache[name]
        if isinstance(pool, dict):
            q, s = _kv_row_quantize(slot)
            page = pool["q"].shape[3]
            pool["q"][:, ids] = _pages_of(q, page)
            pool["s"][:, ids] = _pages_of(s, page)
        else:
            pool[:, ids] = _pages_of(slot, pool.shape[3])
    return cache


def _point_slot(cache, logits, plen, slot_logits, b, table_ids):
    """Point slot ``b``'s table row at ``table_ids``, set its position to
    ``plen`` and its logits row to ``slot_logits`` (1, V)."""
    cache["table"][b] = table_ids
    cache["pos"][b] = plen
    logits[b] = slot_logits[0]
    return cache, logits


def _admit_slot_paged(cache, logits, slot_k, slot_v, plen, slot_logits, b,
                      scatter_ids, table_ids, cfg: GPTConfig):
    """Scatter one prefilled sequence (L, 1, hk, ctx, d) into the pool and
    point slot ``b`` at it. ``scatter_ids`` says where each page's data is
    written (the trash page for shared prefix pages, which are never
    rewritten, and for unreserved tails), ``table_ids`` where the slot
    reads it (the shared ids too). Without sharing the two are equal."""
    del cfg
    cache = _scatter_pages(cache, slot_k, slot_v, scatter_ids)
    return _point_slot(cache, logits, plen, slot_logits, b, table_ids)


def _reset_table_row(cache, b):
    """Retire slot ``b``: its logical rows all point at the trash page."""
    cache["table"][b] = 0
    return cache


def _gather_prefix_pages(cache, page_ids):
    """Inverse of ``_scatter_pages``: the pool pages at ``page_ids``
    ((ctx/page,) int; tail entries 0 = the trash page) as dense
    (L, 1, hk, ctx, d) K and V buffers, new tensors the block-extend
    forward may write. Rows past the cached length come from the trash
    page and are masked by the extend's positions, as a dense prefix
    buffer's unwritten tail is. Full-precision pools only, as in the JAX
    package (an int8 pool would dequantize here)."""
    ids = page_ids.long()

    def get(pool):  # (L, n_pages, hk, page, d) -> (L, 1, hk, ctx, d)
        x = pool[:, ids].transpose(1, 2)  # (L, hk, P, page, d)
        L, hk, P, pg, d = x.shape
        return x.reshape(L, hk, P * pg, d)[:, None]

    return get(cache["pool_k"]), get(cache["pool_v"])


def _gather_pages(pool, table):
    """(n_pages, hk, page, d) pool -> (B, hk, Pmax*page, d) per-slot view."""
    x = pool[table.long()].transpose(1, 2)  # (B, hk, Pmax, page, d)
    B, hk, P, page, d = x.shape
    return x.reshape(B, hk, P * page, d)


def paged_attention_ref(q, pool_k, pool_v, mask, table, pos):
    """Plain PyTorch version of the paged decode attention: gather every
    slot's pages, then the grouped decode attention. ``pos`` is unused —
    rows past a slot's position are dead through ``mask``."""
    del pos
    return _gqa_decode_attn(q, _gather_pages(pool_k, table),
                            _gather_pages(pool_v, table), mask)


def split_rows(pos, page: int, Pmax: int, splits: int):
    """(B, splits) first row and row past the last of each split: slot b's
    walk covers its min(pos/page + 1, Pmax) live pages, cut into tiles of
    TILE_ROWS rows within each page, and split s takes tiles
    [s * n / splits, (s + 1) * n / splits) of its n live tiles."""
    n_live = torch.clamp(torch.clamp(pos.long(), min=0) // page + 1,
                         max=Pmax)
    tpp = -(-page // TILE_ROWS)  # tiles per page
    edges = (torch.arange(splits + 1, device=pos.device)[None, :]
             * (n_live * tpp)[:, None] // splits)
    rows = (edges // tpp) * page + (edges % tpp) * TILE_ROWS
    return rows[:, :-1], rows[:, 1:]


def paged_attention_partials_ref(q, pool_k, pool_v, mask, table, pos,
                                 splits: int):
    """Plain PyTorch version of the partials kernel: for every slot,
    query head and split of ``split_rows``, the split's f32 softmax state
    m (B, H, S), l (B, H, S) and acc (B, H, S, d): m the max of its scores
    (q.k / sqrt(d) + mask, in f32), l the sum of p = exp(s - m), acc the
    sum of p (rounded to the compute dtype) times v. A split with no row
    has m = NEG_INIT, l = 0, acc = 0."""
    B, H, _, d = q.shape
    hk, page = pool_k.shape[1], pool_k.shape[2]
    Pmax = table.shape[1]
    ctx = Pmax * page
    k = _gather_pages(pool_k, table).float()  # (B, hk, ctx, d)
    v = _gather_pages(pool_v, table).float()
    qg = q.float().reshape(B, hk, H // hk, d)
    sc = (qg @ k.transpose(-1, -2)).reshape(B, H, ctx) * (1.0 / math.sqrt(d))
    sc = sc + mask.float().expand(B, H, 1, ctx)[:, :, 0]
    lo, hi = split_rows(pos, page, Pmax, splits)
    t = torch.arange(ctx, device=q.device)
    member = (t >= lo[..., None]) & (t < hi[..., None])  # (B, S, ctx)
    s = torch.where(member[:, None], sc[:, :, None], -math.inf)
    m = torch.where(member.any(-1)[:, None], s.amax(-1), NEG_INIT)
    p = torch.exp(s - m[..., None])  # (B, H, S, ctx)
    pr = p.to(q.dtype).float().reshape(B, hk, -1, ctx)  # (g * S) rows
    acc = (pr @ v).reshape(B, H, splits, d)
    return m, p.sum(-1), acc


def paged_attention_combine_ref(m, l, acc, dtype):
    """Plain PyTorch version of the combine kernel: merge the S partials
    of each (slot, head), M = max m_s, L = sum l_s e^(m_s - M), out = sum
    acc_s e^(m_s - M) / (L, or 1 if L = 0), in ``dtype``. Returns
    (B, H, 1, d)."""
    w = torch.exp(m - m.amax(-1, keepdim=True))
    L = (l * w).sum(-1)
    out = (acc * w[..., None]).sum(-2) / torch.where(L == 0, 1.0, L)[..., None]
    return out[:, :, None].to(dtype)


def paged_attention(q, pool_k, pool_v, mask, table, pos):
    """Decode attention against the page pool.

    ``q`` (B, H, 1, d); ``pool_k``/``pool_v`` (n_pages, hk, page, d);
    ``mask`` (B, 1|H, 1, ctx) additive; ``table`` (B, ctx/page) int32;
    ``pos`` (B,) int32. Returns (B, H, 1, d). Tensors on the CPU take the
    plain version; tensors on a CUDA device launch the kernel, which raises
    on anything it does not take."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, pool_k, pool_v, mask, table, pos)
    return paged_attention_cuda(q.contiguous(), pool_k, pool_v,
                                mask.contiguous(), table, pos)


@torch.no_grad()
def decode_chunk_paged(ops, cache, logits, generator, temp, top_p, top_k,
                       cfg: GPTConfig, n_tokens: int,
                       use_kernel: bool = False):
    """Sample ``n_tokens`` for every slot of a paged cache.

    ``ops`` are the engine's decode ops (``serve.engine.select_decode_ops``:
    the weights cast to the compute dtype, int8 weights, and/or the
    per-slot LoRA side-path: none of them touches the KV layout);
    ``temp``/``top_p``/``top_k`` are (B,) per-slot tensors. Each step
    writes the new token's K/V at (page, row) = (table[s, pos/page],
    pos % page), positions clamped to ctx-1 so idle slots write into the
    trash page, then reads the pool — through ``paged_attention`` with
    ``use_kernel``, else through the table gather. An int8 (kv8) pool
    quantizes each written row and dequantizes in the gather; the kernels
    read plain pools only. Updates ``cache`` in place; returns (tokens
    (B, n), logits, cache)."""
    table = cache["table"]
    B = table.shape[0]
    kv8 = isinstance(cache["pool_k"], dict)
    page = (cache["pool_k"]["q"] if kv8 else cache["pool_k"]).shape[3]
    ctx = cfg.ctx_len
    dt = cfg.compute_dtype
    bidx = torch.arange(B, device=table.device)
    heads = torch.arange(cfg.kv_heads, device=table.device)[None, :]

    if use_kernel and kv8:
        raise ValueError("the paged kernels read plain pools; kv8 uses the "
                         "gather path")
    if use_kernel:
        def paged_attn(q, pk_l, pv_l, mask, pos):
            return paged_attention(q, pk_l, pv_l, mask, table, pos)

        paged_attn.wants_pos = True  # the page walk stops at the position
    else:
        def gathered(pool):
            if isinstance(pool, dict):  # int8 rows * per-row scale
                return _kv8_dequant({"q": _gather_pages(pool["q"], table),
                                     "s": _gather_pages(pool["s"], table)},
                                    dt)
            return _gather_pages(pool, table)

        def paged_attn(q, pk_l, pv_l, mask):
            return _gqa_decode_attn(q, gathered(pk_l), gathered(pv_l), mask)

    def write_rows(pk_l, pv_l, pos, k, v):
        # one flat row scatter per pool: row (page, head, row) of the
        # (n_pages*hk*page, d) view. Duplicate targets only arise between
        # idle slots colliding on the trash page, where any value will do.
        n_pg, hk, pg, d = pk_l.shape
        p = torch.clamp(pos, max=ctx - 1).long()
        pidx = table[bidx, p // page].long()
        ridx = ((pidx[:, None] * hk + heads) * pg
                + (p % page)[:, None]).reshape(-1)
        pk_l.view(n_pg * hk * pg, d)[ridx] = k[:, :, 0, :].reshape(-1, d)
        pv_l.view(n_pg * hk * pg, d)[ridx] = v[:, :, 0, :].reshape(-1, d)
        return pk_l, pv_l

    def write_paged(pk_l, pv_l, pos, k, v):
        if not kv8:
            return write_rows(pk_l, pv_l, pos, k, v)
        kq, ks = _kv_row_quantize(k)
        vq, vs = _kv_row_quantize(v)
        write_rows(pk_l["q"], pv_l["q"], pos, kq, vq)
        write_rows(pk_l["s"], pv_l["s"], pos, ks, vs)
        return pk_l, pv_l

    toks, logits, _, _, pos = _decode_chunk_core(
        cfg, dict(ops, attn=paged_attn), logits,
        _layer_views(cache["pool_k"]), _layer_views(cache["pool_v"]),
        cache["pos"], 0, generator, n_tokens, temp[:, None], top_k,
        top_p[:, None], write_paged)
    return toks, logits, dict(cache, pos=pos)
