"""Streaming fused attention for any T, with a sliding-window band and
grouped K/V — the counterpart of ``linalg_tpu/nn/flash_stream.py`` (K4).

On the TPU K4 is a third kernel set: an online softmax over a compressed
grid of live (query block, key block) pairs, so VMEM holds only blocks
whatever T is; pairs behind the band are dropped at grid-build time, and
grouped K/V heads are read through ``b // g`` index maps. The Hopper
kernels of ``kernels/csrc/flash_attention.cu`` already stream over 64-row
tiles at any T, so K4 is K2/K3's kernel family with two launch arguments
more: the band (``window``), whose tile loops skip the pairs behind it,
and the group size, with which the kernels read each K/V head for its
query heads and dk/dv come back at the grouped size.

``flash_attention_stream`` is the autograd Function of ``nn.flash``
(saving q, k, v, o, L) under K4's contract. On a CUDA tensor it runs the
kernels or raises; on a CPU tensor their plain versions
``stream_fwd_ref`` / ``stream_bwd_ref``, which are the family's plain
versions: the same band and group rules, dk/dv summed over each group in
float32 and rounded once.
"""

from __future__ import annotations

from .flash import _Flash, flash_bwd_ref, flash_fwd_ref

__all__ = ["flash_attention_stream", "stream_fwd_ref", "stream_bwd_ref",
           "STREAM_BLOCK"]

STREAM_BLOCK = 256  # K4's smallest block: T must be a multiple

# K4's plain versions: the family's, which take the band and grouped K/V
stream_fwd_ref = flash_fwd_ref
stream_bwd_ref = flash_bwd_ref


def flash_attention_stream(q, k, v, causal: bool = True, window=None):
    """Streaming fused attention: q (B, H, T, d), k/v (B, hk, T, d) with hk
    dividing H (each K/V head serves H / hk query heads, read in place) ->
    (B, H, T, d). T % 256 == 0.

    ``window`` bans keys ``window`` or more positions behind each query;
    with ``causal=False`` it is the only ban (keys ahead stay visible)."""
    H, T = q.shape[1], q.shape[2]
    hk = k.shape[1]
    if H % hk:
        raise ValueError(f"KV heads ({hk}) must divide query heads ({H})")
    if T % STREAM_BLOCK:
        raise ValueError(f"T={T} must be a multiple of {STREAM_BLOCK}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    return _Flash.apply(q, k, v, causal, window, False)
