"""KV caches — the counterpart of ``linalg_tpu/nn/cache.py``.

Two forms, as there:

- The reference's object caches: ``KVCache`` (one layer, (B, h, max_T, d)
  buffers, ``update`` appends and returns the live prefix, overflow
  raises, ``reset`` zeroes), ``LayerKVCache`` (one per layer, a shared
  length) and ``apply_kv_cache``.
- The fixed-shape functional cache the decode paths use: (L, B, h, max_T,
  d) buffers with a position (a scalar ``length`` or a per-slot ``pos``
  vector).

JAX returns updated copies; here the writes update the buffers IN PLACE
(no second cache-sized allocation per token) and return them for the same
call shape.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

__all__ = ["KVCache", "LayerKVCache", "apply_kv_cache", "fkv_init",
           "fkv_write", "fkv_write_slots", "fkv_update", "fkv_advance"]


class KVCache:
    """KV cache of one attention layer; buffers (B, h, max_T, d)."""

    def __init__(self, batch_size: int, n_heads: int, max_seq_len: int,
                 d_head: int, dtype=torch.float32, device=None) -> None:
        self.batch_size = batch_size
        self.n_heads = n_heads
        self.max_seq_len = max_seq_len
        self.d_head = d_head
        self.dtype = dtype
        shape = (batch_size, n_heads, max_seq_len, d_head)
        self.k_cache = torch.zeros(shape, dtype=dtype, device=device)
        self.v_cache = torch.zeros(shape, dtype=dtype, device=device)
        self.seq_len = 0

    def update(self, k_new, v_new) -> Tuple[torch.Tensor, torch.Tensor]:
        """Append k_new/v_new (B, h, t, d) along time; return the live
        prefix."""
        t = k_new.shape[2]
        new_len = self.seq_len + t
        if new_len > self.max_seq_len:
            raise ValueError(
                f"Cache overflow: {new_len} > max_seq_len {self.max_seq_len}")
        self.k_cache[:, :, self.seq_len:new_len] = k_new
        self.v_cache[:, :, self.seq_len:new_len] = v_new
        self.seq_len = new_len
        return self.get()

    def get(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return (self.k_cache[:, :, :self.seq_len],
                self.v_cache[:, :, :self.seq_len])

    def reset(self) -> None:
        self.seq_len = 0
        self.k_cache.zero_()
        self.v_cache.zero_()

    @property
    def is_empty(self) -> bool:
        return self.seq_len == 0


class LayerKVCache:
    """Per-layer list of KVCaches with a shared length."""

    def __init__(self, n_layers: int, batch_size: int, n_heads: int,
                 max_seq_len: int, d_head: int, dtype=torch.float32,
                 device=None) -> None:
        self.n_layers = n_layers
        self.caches: List[KVCache] = [
            KVCache(batch_size, n_heads, max_seq_len, d_head, dtype, device)
            for _ in range(n_layers)]

    def __getitem__(self, layer_idx: int) -> KVCache:
        return self.caches[layer_idx]

    def reset(self) -> None:
        for c in self.caches:
            c.reset()

    @property
    def seq_len(self) -> int:
        return self.caches[0].seq_len if self.caches else 0


def apply_kv_cache(k, v, cache: Optional[KVCache]):
    """Pass k/v through without a cache; else append and return the live
    prefix."""
    if cache is None:
        return k, v
    return cache.update(k, v)


def fkv_init(n_layers: int, batch: int, n_heads: int, max_seq_len: int,
             d_head: int, dtype=torch.float32,
             device=None) -> Dict[str, torch.Tensor]:
    """Zeroed cache: k/v (L, B, h, max_T, d) plus an int32 ``length``."""
    shape = (n_layers, batch, n_heads, max_seq_len, d_head)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "length": torch.zeros((), dtype=torch.int32, device=device),
    }


def _clamped_start(length, t: int, max_T: int) -> int:
    """``lax.dynamic_update_slice``'s start rule: clamp into [0, max_T-t]."""
    return max(0, min(int(length), max_T - t))


def fkv_write(k_buf, v_buf, length, k_new, v_new):
    """Write k_new/v_new (B, h, t, d) into (B, h, max_T, d) buffers at time
    offset ``length`` (shared by every row), in place."""
    t, max_T = k_new.shape[2], k_buf.shape[2]
    at = _clamped_start(length, t, max_T)
    k_buf[:, :, at:at + t] = k_new
    v_buf[:, :, at:at + t] = v_new
    return k_buf, v_buf


def fkv_write_slots(k_buf, v_buf, pos, k_new, v_new):
    """Per-slot write: k_new/v_new (B, h, t, d) land contiguously at rows
    [s_b, s_b + t) of slot b, in place. The start follows the JAX vmapped
    ``dynamic_update_slice``: a negative ``pos[b]`` wraps once (+ max_T),
    then the start clamps to [0, max_T - t] (for t = 1 the JAX row
    scatter's rule: wrap, then clamp to [0, max_T - 1])."""
    B, h, max_T, d = k_buf.shape
    t = k_new.shape[2]
    s = torch.where(pos < 0, pos + max_T, pos).clamp(0, max_T - t).long()
    b = torch.arange(B, device=k_buf.device)
    if t == 1:
        k_buf[b, :, s] = k_new[:, :, 0]
        v_buf[b, :, s] = v_new[:, :, 0]
        return k_buf, v_buf
    rows = s[:, None] + torch.arange(t, device=k_buf.device)  # (B, t)
    # advanced indices around a slice: the result is (B, t, h, d)
    k_buf[b[:, None], :, rows] = k_new.transpose(1, 2)
    v_buf[b[:, None], :, rows] = v_new.transpose(1, 2)
    return k_buf, v_buf


def fkv_update(cache: Dict[str, torch.Tensor], layer: int, k_new, v_new):
    """Write k_new/v_new (B, h, t, d) into layer ``layer`` at the cache's
    length, in place: (cache, k_full, v_full), the full (B, h, max_T, d)
    buffers of that layer (attention masks past length + t). ``length``
    advances separately (``fkv_advance``) once every layer has written."""
    k, v = fkv_write(cache["k"][layer], cache["v"][layer], cache["length"],
                     k_new, v_new)
    return cache, k, v


def fkv_advance(cache: Dict[str, torch.Tensor], n_tokens):
    """Return the cache with ``length`` advanced by ``n_tokens``."""
    return dict(cache, length=cache["length"] + int(n_tokens))
