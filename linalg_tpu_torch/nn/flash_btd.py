"""Causal multi-head attention in the model's (B, T, H*d) layout — the
counterpart of ``linalg_tpu/nn/flash_btd.py`` (K7).

``attention_btd(q, k, v, n_heads)`` takes the raw projection outputs
(B, T, H*d) and returns (B, T, H*d), ready for ``@ Wo``: head h is the
column slice [h d, (h + 1) d), never transposed into (B, H, T, d). It is
an ``autograd.Function`` that saves (q, k, v, o, L), not the (T, T)
probabilities, and its closed-form backward recomputes P = exp(S - L).

On a CUDA tensor it runs the flash kernels of
``kernels/csrc/flash_attention.cu`` (forward, dq, dk/dv) on head views of
the (B, T, H*d) tensors: the kernels take each head through its strides,
so q, k, v are read in place and O, dq, dk, dv are written in (B, T, H*d)
with no transpose copy. K7 computes K2's function; only the layout
differs. The launches count on ``flash_{fwd,dq,dkdv}_cuda.launches``. L
is (B, H, T) float32 (the TPU kernel's (8 H, T) broadcast rows do not
carry over). On a CPU tensor it runs the plain versions ``btd_fwd_ref``
/ ``btd_bwd_ref``; any other device raises.

``btd_supported`` is the JAX rule (T <= 1024, T % 8, d % 128) plus what
the kernels add: d_head one of theirs (32, 64, 128, 256, so of the JAX
rule's widths d 128 and 256) and T a multiple of 64.
"""

from __future__ import annotations

import math

import torch

from ..kernels.flash_attention import BLOCK, MAX_BH, SUPPORTED_D

__all__ = ["attention_btd", "attention_btd_ref", "btd_supported",
           "btd_fwd_ref", "btd_bwd_ref", "BTD_MAX_T"]

BTD_MAX_T = 1024


def _heads(x, n_heads: int):
    """(B, T, H*d) -> the (B, H, T, d) view of its column slices."""
    B, T, D = x.shape
    return x.view(B, T, n_heads, D // n_heads).transpose(1, 2)


def _unheads(x):
    B, H, T, d = x.shape
    return x.transpose(1, 2).reshape(B, T, H * d)


def btd_fwd_ref(q, k, v, n_heads: int, causal: bool = True):
    """Plain version of the forward: (o (B, T, H*d) in q's dtype, L float32
    (B, H, T)). Scores and softmax in float32; P is rounded to v's dtype
    before P v, as the kernels and the Pallas kernel do."""
    qh, kh, vh = (_heads(t, n_heads).float() for t in (q, k, v))
    T, d = qh.shape[-2:]
    s = (qh @ kh.transpose(-1, -2)) / math.sqrt(d)
    if causal:
        i = torch.arange(T, device=q.device)
        s = torch.where(i[None, :] <= i[:, None], s, -1e9)
    m = torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s - m)
    denom = torch.sum(e, dim=-1, keepdim=True)
    o = (e / denom).to(v.dtype).float() @ vh
    return _unheads(o).to(q.dtype), (m + torch.log(denom))[..., 0]


def btd_bwd_ref(q, k, v, o, L, do, n_heads: int, causal: bool = True):
    """Plain version of the backward: (dq, dk, dv) (B, T, H*d) in q's dtype
    from the saved L, with delta = rowsum(dO * O) in float32; P and dS are
    rounded to the io dtype before the products, as in the kernels."""
    qh, kh, vh, oh, doh = (_heads(t, n_heads).float()
                           for t in (q, k, v, o, do))
    T, d = qh.shape[-2:]
    scale = 1.0 / math.sqrt(d)
    s = scale * (qh @ kh.transpose(-1, -2))
    if causal:
        i = torch.arange(T, device=q.device)
        s = torch.where(i[None, :] <= i[:, None], s, -1e9)
    p = torch.exp(s - L[..., None])
    dv = p.to(do.dtype).float().transpose(-1, -2) @ doh
    dp = doh @ vh.transpose(-1, -2)
    delta = torch.sum(doh * oh, dim=-1, keepdim=True)
    ds = ((dp - delta) * p).to(q.dtype).float()
    dq = scale * (ds @ kh)
    dk = scale * (ds.transpose(-1, -2) @ qh)
    return tuple(_unheads(g).to(q.dtype) for g in (dq, dk, dv))


def _btd_fwd(q, k, v, n_heads, causal):
    if q.device.type == "cpu":
        return btd_fwd_ref(q, k, v, n_heads, causal)
    if q.device.type != "cuda":
        raise ValueError(f"attention_btd: no kernel and no plain version "
                         f"for device {q.device}")
    from ..kernels.flash_attention import flash_fwd_cuda

    o, L = flash_fwd_cuda(*(_heads(t, n_heads) for t in (q, k, v)), causal)
    return _unheads(o), L  # o lies in (B, T, H*d): a view, no copy


def _btd_bwd(q, k, v, o, L, do, n_heads, causal):
    if q.device.type == "cpu":
        return btd_bwd_ref(q, k, v, o, L, do, n_heads, causal)
    from ..kernels.flash_attention import (flash_delta_cuda,
                                           flash_dkdv_cuda, flash_dq_cuda)

    qh, kh, vh, doh = (_heads(t, n_heads) for t in (q, k, v, do))
    # rowsum(dO * O) in float32 outside the dq and dk/dv kernels, as the K2
    # path takes it
    delta = flash_delta_cuda(_heads(o, n_heads), doh)
    dq = flash_dq_cuda(qh, kh, vh, doh, L, delta, causal)
    dk, dv = flash_dkdv_cuda(qh, kh, vh, doh, L, delta, causal)
    return _unheads(dq), _unheads(dk), _unheads(dv)


class _AttentionBTD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, n_heads, causal, plain):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, L = (btd_fwd_ref if plain else _btd_fwd)(q, k, v, n_heads,
                                                    causal)
        ctx.save_for_backward(q, k, v, o, L)
        ctx.n_heads, ctx.causal, ctx.plain = n_heads, causal, plain
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, L = ctx.saved_tensors
        dq, dk, dv = (btd_bwd_ref if ctx.plain else _btd_bwd)(
            q, k, v, o, L, do.contiguous(), ctx.n_heads, ctx.causal)
        return dq, dk, dv, None, None, None


def attention_btd(q, k, v, n_heads: int, causal: bool = True):
    """Fused multi-head attention in (B, T, H*d) layout.

    Drop-in for ``_unheads(sdpa(_heads(q), _heads(k), _heads(v), mask))``
    with no head relayouts and no (T, T) scores in device memory. On the
    card the shapes must pass ``btd_supported``'s kernel terms (the
    kernel wrappers raise otherwise)."""
    return _AttentionBTD.apply(q, k, v, n_heads, causal, False)


def attention_btd_ref(q, k, v, n_heads: int, causal: bool = True):
    """``attention_btd`` through the plain versions on any device: the
    reference a run on the card holds the kernels' path against."""
    return _AttentionBTD.apply(q, k, v, n_heads, causal, True)


def btd_supported(B: int, T: int, D: int, n_heads: int) -> bool:
    """Shape gate: the JAX rule (T <= 1024 and a multiple of 8, d_head a
    multiple of 128) plus the kernels' terms (d_head in their sizes, T a
    multiple of their 64-row tile, B*H within the grid)."""
    if T > BTD_MAX_T or T % 8 != 0 or T % BLOCK != 0:
        return False
    d = D // n_heads
    if d * n_heads != D or d % 128 != 0 or d not in SUPPORTED_D:
        return False
    return 0 < B * n_heads <= MAX_BH
