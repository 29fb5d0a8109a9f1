"""Fused causal attention (flash-style: P never touches device memory) —
the counterpart of ``linalg_tpu/nn/flash.py`` (K2).

``flash_attention(q, k, v, causal)`` is an ``autograd.Function`` that saves
(q, k, v, o, L), not the (T, T) probabilities: the backward recomputes
P = exp(S - L). On a CUDA tensor it runs the hand-written kernels of
``kernels/csrc/flash_attention.cu`` (forward, dq, dk/dv); on a CPU tensor
it runs their plain PyTorch versions ``flash_fwd_ref`` / ``flash_bwd_ref``,
which follow K2's formulas (``linalg_tpu/nn/flash.py:36-106``). Any other
device raises. ``nn.flash_long.flash_attention_long`` (K3) and
``nn.flash_stream.flash_attention_stream`` (K4) are the same math behind
the same kernels; K4 adds the sliding-window band (``window``) and K/V
with fewer heads than q (``H % hk == 0``), which the plain versions here
take too. A head of 8 <= d < 256 columns outside the kernels' widths is
zero-padded to the next one (``kernel_width``) with the scale 1/sqrt(d)
passed explicitly, so every head width the JAX package sends to its flash
kernels runs here; the outputs and gradients are sliced back to d.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import SUPPORTED_D as FLASH_D
from ..kernels.flash_attention import reads_in_place

__all__ = ["flash_attention", "flash_attention_ref", "flash_fwd",
           "flash_bwd", "flash_fwd_ref", "flash_bwd_ref", "flash_delta",
           "flash_delta_ref", "kernel_width", "FLASH_MAX_T"]

FLASH_MAX_T = 1024


def _expand(kv, H):
    """Grouped K/V (B, hk, T, d) read by query head h at h // (H / hk), as
    the (B, H, T, d) float32 tensor the plain versions multiply."""
    return kv.float().repeat_interleave(H // kv.shape[1], dim=1)


def _scores(q, k, causal, window=None, scale=None):
    """scale * q k^T in float32 (scale 1/sqrt(d) by default); entries
    outside the band (future keys when causal, keys window or more behind
    the query) at the -1e9 fill."""
    T, d = q.shape[-2:]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    s = scale * (q.float() @ _expand(k, q.shape[1]).transpose(-1, -2))
    i = torch.arange(T, device=q.device)
    if causal:
        s = torch.where(i[None, :] <= i[:, None], s, -1e9)
    if window is not None:
        s = torch.where(i[:, None] - i[None, :] < window, s, -1e9)
    return s


def flash_fwd_ref(q, k, v, causal: bool = True, window=None, scale=None):
    """Plain version of the forward kernel: (o in q's dtype, L float32
    (B, H, T)). Products of the io dtype accumulate in float32; P is
    rounded to v's dtype before P v. k and v may have fewer heads than q."""
    s = _scores(q, k, causal, window, scale)
    m = torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s - m)
    denom = torch.sum(e, dim=-1, keepdim=True)
    o = (e / denom).to(v.dtype).float() @ _expand(v, q.shape[1])
    return o.to(q.dtype), (m + torch.log(denom))[..., 0]


def flash_bwd_ref(q, k, v, o, L, do, causal: bool = True, window=None,
                  scale=None):
    """Plain version of the dq and dk/dv kernels: (dq, dk, dv) in q's
    dtype, with P recomputed from L and delta = rowsum(dO * O) in float32.
    For grouped k/v, dk and dv are each KV head's group summed in float32
    and rounded once, at k's size."""
    B, H, T, d = q.shape
    hk = k.shape[1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    p = torch.exp(_scores(q, k, causal, window, scale) - L[..., None])
    dof = do.float()
    dv = p.to(do.dtype).float().transpose(-1, -2) @ dof
    dp = dof @ _expand(v, H).transpose(-1, -2)
    delta = torch.sum(dof * o.float(), dim=-1, keepdim=True)
    ds = (dp - delta) * p
    dq = scale * (ds.to(k.dtype).float() @ _expand(k, H))
    dk = scale * (ds.to(q.dtype).float().transpose(-1, -2) @ q.float())
    dk, dv = (x.reshape(B, hk, H // hk, T, d).sum(dim=2) for x in (dk, dv))
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def flash_delta_ref(o, do):
    """Plain version of the delta kernel: rowsum(dO * O) in float32,
    (B, H, T)."""
    return torch.sum(do.float() * o.float(), dim=-1)


def _on_cpu(x, name):
    """True for a CPU tensor, False for a CUDA one; any other device
    raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel and no plain version for "
                         f"device {x.device}")
    return x.device.type == "cpu"


def flash_fwd(q, k, v, causal: bool = True, window=None, scale=None):
    """(o, L): the CUDA forward kernel, or its plain version on the CPU."""
    if _on_cpu(q, "flash_fwd"):
        return flash_fwd_ref(q, k, v, causal, window, scale)
    from ..kernels.flash_attention import flash_fwd_cuda

    return flash_fwd_cuda(q, k, v, causal, window, q.shape[1] // k.shape[1],
                          scale)


def flash_delta(o, do):
    """delta = rowsum(dO * O): the CUDA kernel, or its plain version on the
    CPU."""
    if _on_cpu(o, "flash_delta"):
        return flash_delta_ref(o, do)
    from ..kernels.flash_attention import flash_delta_cuda

    return flash_delta_cuda(o, do)


def flash_bwd(q, k, v, o, L, do, causal: bool = True, window=None,
              scale=None):
    """(dq, dk, dv): the CUDA dq and dk/dv kernels, or their plain version
    on the CPU. delta = rowsum(dO * O) is one float32 pass before them
    (``flash_delta``), as K3 and K4 take it outside their kernels
    (``flash_long.py:213-217``, ``flash_stream.py:367-368``)."""
    if _on_cpu(q, "flash_bwd"):
        return flash_bwd_ref(q, k, v, o, L, do, causal, window, scale)
    from ..kernels.flash_attention import flash_dkdv_cuda, flash_dq_cuda

    group = q.shape[1] // k.shape[1]
    delta = flash_delta(o, do)
    dq = flash_dq_cuda(q, k, v, do, L, delta, causal, window, group, scale)
    dk, dv = flash_dkdv_cuda(q, k, v, do, L, delta, causal, window, group,
                             scale)
    return dq, dk, dv


def kernel_width(d: int) -> int:
    """The head width the flash kernels run a d-wide head at: d itself, or
    for 8 <= d < 256 the next of ``kernels.flash_attention.SUPPORTED_D``,
    zero-padded (exact: zero columns add nothing to q k^T and give zero
    output columns; the scale stays 1/sqrt(d)). Other widths are refused
    by the kernel wrappers."""
    if 8 <= d < FLASH_D[-1]:
        return next(w for w in FLASH_D if w >= d)
    return d


def _in_place(t):
    """``t`` itself where the kernels read it as it lies, else a contiguous
    copy."""
    return t if reads_in_place(t) else t.contiguous()


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, plain):
        d = q.shape[-1]
        w = kernel_width(d)
        # the kernels read the model's transposed head views in place; only
        # a tensor whose strides they cannot take is copied
        q, k, v = (F.pad(t, (0, w - d)) if w != d else _in_place(t)
                   for t in (q, k, v))
        scale = 1.0 / math.sqrt(d)
        o, L = (flash_fwd_ref if plain else flash_fwd)(q, k, v, causal,
                                                       window, scale)
        ctx.save_for_backward(q, k, v, o, L)
        ctx.causal, ctx.window, ctx.plain = causal, window, plain
        ctx.d, ctx.scale = d, scale
        return o[..., :d] if w != d else o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, L = ctx.saved_tensors
        d, w = ctx.d, q.shape[-1]
        do = F.pad(do, (0, w - d)) if w != d else _in_place(do)
        grads = (flash_bwd_ref if ctx.plain else flash_bwd)(
            q, k, v, o, L, do, ctx.causal, ctx.window, ctx.scale)
        dq, dk, dv = (g[..., :d] for g in grads)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True):
    """Fused attention: q, k, v (B, h, T, d) -> (B, h, T, d).

    Drop-in for ``sdpa(q, k, v, causal_mask(T))`` on the training path.
    On the card T must be a multiple of 64 and d in [8, 256] (a d outside
    32, 64, 128, 256 is zero-padded to the next, ``kernel_width``; the
    kernel wrapper raises on the rest); the model's picker pads T to a
    multiple of 256 and sends other head widths to sdpa."""
    return _Flash.apply(q, k, v, causal, None, False)


def flash_attention_ref(q, k, v, causal: bool = True, window=None):
    """``flash_attention`` (or, with a window or grouped k/v,
    ``flash_attention_stream``) through the plain versions on any device:
    the reference a run on the card holds the kernels' path against."""
    return _Flash.apply(q, k, v, causal, window, True)
