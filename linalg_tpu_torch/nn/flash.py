"""Fused causal attention (flash-style: P never touches device memory) —
the counterpart of ``linalg_tpu/nn/flash.py`` (K2).

``flash_attention(q, k, v, causal)`` is an ``autograd.Function`` that saves
(q, k, v, o, L), not the (T, T) probabilities: the backward recomputes
P = exp(S - L). On a CUDA tensor it runs the hand-written kernels of
``kernels/csrc/flash_attention.cu`` (forward, dq, dk/dv); on a CPU tensor
it runs their plain PyTorch versions ``flash_fwd_ref`` / ``flash_bwd_ref``,
which follow K2's formulas (``linalg_tpu/nn/flash.py:36-106``). Any other
device raises. ``nn.flash_long.flash_attention_long`` (K3) is the same
math behind the same kernels.
"""

from __future__ import annotations

import math

import torch

__all__ = ["flash_attention", "flash_attention_ref", "flash_fwd",
           "flash_bwd", "flash_fwd_ref", "flash_bwd_ref", "FLASH_MAX_T"]

FLASH_MAX_T = 1024


def _scores(q, k, causal):
    """scale * q k^T in float32, causal entries at the -1e9 fill."""
    T, d = q.shape[-2:]
    s = (1.0 / math.sqrt(d)) * (q.float() @ k.float().transpose(-1, -2))
    if causal:
        i = torch.arange(T, device=q.device)
        s = torch.where(i[None, :] <= i[:, None], s, -1e9)
    return s


def flash_fwd_ref(q, k, v, causal: bool = True):
    """Plain version of the forward kernel: (o in q's dtype, L float32
    (B, H, T)). Products of the io dtype accumulate in float32; P is
    rounded to v's dtype before P v."""
    s = _scores(q, k, causal)
    m = torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s - m)
    denom = torch.sum(e, dim=-1, keepdim=True)
    o = (e / denom).to(v.dtype).float() @ v.float()
    return o.to(q.dtype), (m + torch.log(denom))[..., 0]


def flash_bwd_ref(q, k, v, o, L, do, causal: bool = True):
    """Plain version of the dq and dk/dv kernels: (dq, dk, dv) in q's
    dtype, with P recomputed from L and delta = rowsum(dO * O) in float32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_scores(q, k, causal) - L[..., None])
    dof = do.float()
    dv = p.to(do.dtype).float().transpose(-1, -2) @ dof
    dp = dof @ v.float().transpose(-1, -2)
    delta = torch.sum(dof * o.float(), dim=-1, keepdim=True)
    ds = (dp - delta) * p
    dq = scale * (ds.to(k.dtype).float() @ k.float())
    dk = scale * (ds.to(q.dtype).float().transpose(-1, -2) @ q.float())
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _on_cpu(x, name):
    """True for a CPU tensor, False for a CUDA one; any other device
    raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel and no plain version for "
                         f"device {x.device}")
    return x.device.type == "cpu"


def flash_fwd(q, k, v, causal: bool = True):
    """(o, L): the CUDA forward kernel, or its plain version on the CPU."""
    if _on_cpu(q, "flash_fwd"):
        return flash_fwd_ref(q, k, v, causal)
    from ..kernels.flash_attention import flash_fwd_cuda

    return flash_fwd_cuda(q, k, v, causal)


def flash_bwd(q, k, v, o, L, do, causal: bool = True):
    """(dq, dk, dv): the CUDA dq and dk/dv kernels, or their plain version
    on the CPU. delta = rowsum(dO * O) is one float32 pass here, as K3
    takes it outside its kernels (``flash_long.py:213-217``)."""
    if _on_cpu(q, "flash_bwd"):
        return flash_bwd_ref(q, k, v, o, L, do, causal)
    from ..kernels.flash_attention import flash_dkdv_cuda, flash_dq_cuda

    delta = torch.sum(do.float() * o.float(), dim=-1)
    dq = flash_dq_cuda(q, k, v, do, L, delta, causal)
    dk, dv = flash_dkdv_cuda(q, k, v, do, L, delta, causal)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, plain):
        # the kernels take contiguous (B, H, T, d); the model's head split
        # hands over transposed views, so they are copied here explicitly
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, L = (flash_fwd_ref if plain else flash_fwd)(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, L)
        ctx.causal, ctx.plain = causal, plain
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, L = ctx.saved_tensors
        dq, dk, dv = (flash_bwd_ref if ctx.plain else flash_bwd)(
            q, k, v, o, L, do.contiguous(), ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True):
    """Fused attention: q, k, v (B, h, T, d) -> (B, h, T, d).

    Drop-in for ``sdpa(q, k, v, causal_mask(T))`` on the training path.
    On the card T must be a multiple of 64 and d one of 32, 64, 128 (the
    kernel wrapper raises otherwise); the model's picker pads T to a
    multiple of 256 and sends other head widths to sdpa."""
    return _Flash.apply(q, k, v, causal, False)


def flash_attention_ref(q, k, v, causal: bool = True):
    """``flash_attention`` through the plain versions on any device: the
    reference a run on the card holds the kernels' path against."""
    return _Flash.apply(q, k, v, causal, True)
