"""Fixed-shape KV cache — the PyTorch counterpart of the functional cache
of ``linalg_tpu/nn/cache.py``.

Buffers are (L, B, h, max_T, d) with a position (a scalar ``length`` or a
per-slot ``pos`` vector). JAX returns updated copies; here the writes
update the buffers IN PLACE (no second cache-sized allocation per token)
and return them for the same call shape.
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["fkv_init", "fkv_write", "fkv_write_slots", "fkv_advance"]


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


def fkv_advance(cache: Dict[str, torch.Tensor], n_tokens):
    """Return the cache with ``length`` advanced by ``n_tokens``."""
    return dict(cache, length=cache["length"] + int(n_tokens))
