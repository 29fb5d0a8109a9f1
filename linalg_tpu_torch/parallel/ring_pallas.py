"""Ring attention through the ring kernels K10/K11 — the counterpart of
``linalg_tpu/parallel/ring_pallas.py`` (``--ring pallas``), with its names.

On the TPU one Pallas kernel per device runs all n ring steps and moves
the K/V chunks with remote DMAs, issuing step s+1's transfer before it
computes step s and holding it back with credits until the neighbour's
slot is free. Here the ring's ranks are rank-stacked on one device
(``mesh`` devices may repeat), and on CUDA tensors each direction is one
call of the kernels (``kernels.ring_attention``): the forward is one K10
launch, the backward K11's dq and dk/dv launches, once each, for every
rank. Every block loops over the ring's steps in the ring's order and
reads the chunk a step needs where it already lies, rows [src Tl,
(src + 1) Tl) of the (B*h, T, D) head tensors: no chunk is copied and no
running state leaves the registers between steps. A build or launch
failure raises.

On CPU tensors, and with ``plain=True`` on the card, the kernels' plain
versions run the TPU's protocol step by step: the forward keeps two K/V
slots of (n, 2, BH, Tl, d) and rotates one hop per step
(``kernels.ring_attention.rotate``: rank r+1 receives rank r's chunk);
the backward laps an f32 bundle (k, v, dk, dv) of (n, 4, BH, Tl, d),
each step running the dq and dk/dv passes and then rotating the bundle,
which after n rotations is home, in slot n % 2 (``ring_pallas.py:433``).
Both ways fold chunk ``src = (r - s) mod n`` at step s, with
``chunk_live`` skipping dead chunks, so they sum in the same order. Head
widths from 8 up are zero-padded to the kernels' next width with the
scale of the true width; no ``torch.cuda.synchronize()`` is on the path.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.ring_attention import (padded_d, ring_bwd_cuda,
                                      ring_bwd_step_ref, ring_fwd_cuda,
                                      ring_fwd_step_ref, rotate)

__all__ = ["make_ring_attention_pallas", "ring_attention_pallas_local",
           "ring_attention_pallas_bwd_local"]


def _ring_size(mesh, axis: str, device) -> int:
    """n, the ring's ranks; every mesh device must be ``device`` (the
    ranks share it)."""
    def same(dv):
        dv = torch.device(dv)
        return dv.type == device.type and (
            dv.index is None or device.index is None
            or dv.index == device.index)

    if not all(same(dv) for dv in mesh.devices.flat):
        raise NotImplementedError(
            f"ring ranks on devices other than the tensors' {device} (one "
            "range of ranks per card, with a torch.distributed transport) "
            "are not ported yet (ROADMAP.md queue 1, item 7)")
    return mesh.shape[axis]


def _heads(x, D):
    """(B, h, T, d) -> contiguous (B*h, T, D), zero-padded to width D."""
    B, h, T, d = x.shape
    if D != d:
        x = F.pad(x, (0, D - d))
    return x.reshape(B * h, T, D).contiguous()


def _slot_chunks(x, n):
    """(BH, T, D) -> the rank-stacked (n, BH, T / n, D) chunks."""
    BH, T, D = x.shape
    return x.view(BH, n, T // n, D).transpose(0, 1)


def _validate(q, n, causal, window):
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ring attention: no kernel and no plain version "
                         f"for device {q.device}")
    d, T = q.shape[-1], q.shape[-2]
    if T % n:
        raise ValueError(f"T {T} must divide into the ring's {n} ranks")
    if d < 8:
        raise ValueError(f"ring attention takes d_head >= 8, got {d}")


def _slopes_on(slopes, device):
    return (None if slopes is None else
            torch.tensor(slopes, dtype=torch.float32, device=device))


def ring_attention_pallas_local(q, k, v, *, mesh, axis: str = "sp",
                                causal: bool = True, with_lse: bool = False,
                                slopes=None, window=None,
                                plain: bool = False):
    """K10 over every rank: q, k, v (B, h, T, d), rank r's rows at [r Tl,
    (r + 1) Tl) -> o (B, h, T, d) in q's dtype and, with ``with_lse``, the
    float32 row logsumexp L (B, h, T). ``slopes`` (len h) adds the ALiBi
    bias, ``window`` (causal only) the band. ``plain`` runs the kernel's
    plain version on CUDA tensors too (the reference a card run holds the
    kernel against)."""
    n = _ring_size(mesh, axis, q.device)
    _validate(q, n, causal, window)
    B, h, T, d = q.shape
    D = padded_d(d)
    Tl = T // n
    dev = q.device
    qf = _heads(q, D)
    kf, vf = _heads(k.to(q.dtype), D), _heads(v.to(q.dtype), D)
    kw = dict(n=n, H=h, causal=causal, window=window,
              slopes=_slopes_on(slopes, dev), scale=1.0 / math.sqrt(d))
    if dev.type == "cuda" and not plain:
        o, L = ring_fwd_cuda(qf, kf, vf, **kw)
    else:
        kv = torch.empty((2, n, 2, B * h, Tl, D), dtype=q.dtype, device=dev)
        kv[0, :, 0] = _slot_chunks(kf, n)
        kv[0, :, 1] = _slot_chunks(vf, n)
        m = torch.empty((B * h, T), dtype=torch.float32, device=dev)
        l = torch.empty_like(m)
        acc = torch.empty((B * h, T, D), dtype=torch.float32, device=dev)
        o = torch.empty_like(qf)
        L = torch.empty_like(m)
        for s in range(n):
            cur = kv[s % 2]
            if s < n - 1:
                rotate(cur, kv[(s + 1) % 2])
            ring_fwd_step_ref(qf, cur, m, l, acc, o, L, step=s, ranks=(0, n),
                              last=s == n - 1, **kw)
    o = o.view(B, h, T, D)[..., :d]
    if not with_lse:
        return o
    return o, L.view(B, h, T)


def ring_attention_pallas_bwd_local(q, k, v, do, lse, delta, *, mesh,
                                    axis: str = "sp", causal: bool = True,
                                    slopes=None, window=None,
                                    plain: bool = False):
    """K11 over every rank: the local (dq, dk, dv), each (B, h, T, d) in
    q's dtype, from the forward's ``lse`` and ``delta`` = rowsum(dO * O),
    both float32 (B, h, T). ``plain`` as for the forward."""
    n = _ring_size(mesh, axis, q.device)
    _validate(q, n, causal, window)
    B, h, T, d = q.shape
    D = padded_d(d)
    Tl = T // n
    dev = q.device
    qf, dof = _heads(q, D), _heads(do.to(q.dtype), D)
    L = lse.reshape(B * h, T).float().contiguous()
    dl = delta.reshape(B * h, T).float().contiguous()
    kw = dict(n=n, H=h, causal=causal, window=window,
              slopes=_slopes_on(slopes, dev), scale=1.0 / math.sqrt(d))

    def back(x):  # (B*h, T, D) -> (B, h, T, d)
        return x.view(B, h, T, D)[..., :d]

    if dev.type == "cuda" and not plain:
        kf, vf = _heads(k.to(q.dtype), D), _heads(v.to(q.dtype), D)
        return tuple(back(x) for x in ring_bwd_cuda(qf, kf, vf, dof, L, dl,
                                                    **kw))
    bundle = torch.empty((2, n, 4, B * h, Tl, D), dtype=torch.float32,
                         device=dev)
    bundle[0, :, 0] = _slot_chunks(_heads(k.float(), D), n)
    bundle[0, :, 1] = _slot_chunks(_heads(v.float(), D), n)
    bundle[0, :, 2:] = 0
    dq_acc = torch.empty((B * h, T, D), dtype=torch.float32, device=dev)
    dq = torch.empty_like(qf)
    for s in range(n):
        cur, nxt = bundle[s % 2], bundle[(s + 1) % 2]
        ring_bwd_step_ref(qf, dof, L, dl, cur, dq_acc, dq, step=s,
                          ranks=(0, n), last=s == n - 1, **kw)
        if n > 1:  # every step, so the bundle finishes its lap at home
            rotate(cur, nxt)
    home = bundle[n % 2 if n > 1 else 0]

    def gather(x):  # (n, BH, Tl, D) rank-stacked -> (B, h, T, d)
        return back(x.transpose(0, 1).reshape(B * h, T, D)).to(q.dtype)

    return back(dq), gather(home[:, 2]), gather(home[:, 3])


class _RingAttention(torch.autograd.Function):
    """The JAX package's ``custom_vjp``: the forward saves (q, k, v, o, L);
    the backward forms delta = rowsum(dO * O) in float32 and runs K11."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal, slopes, window):
        o, L = ring_attention_pallas_local(q, k, v, mesh=mesh, axis=axis,
                                           causal=causal, with_lse=True,
                                           slopes=slopes, window=window)
        ctx.save_for_backward(q, k, v, o, L)
        ctx.cfg = dict(mesh=mesh, axis=axis, causal=causal, slopes=slopes,
                       window=window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, L = ctx.saved_tensors
        delta = torch.sum(do.float() * o.float(), dim=-1)
        dq, dk, dv = ring_attention_pallas_bwd_local(q, k, v, do, L, delta,
                                                     **ctx.cfg)
        return dq, dk.to(k.dtype), dv.to(v.dtype), None, None, None, None, \
            None


def make_ring_attention_pallas(mesh, *, axis: str = "sp",
                               causal: bool = True,
                               batch_axis: str | None = None, slopes=None,
                               window=None):
    """attn(q, k, v) on GLOBAL (B, h, T, d) tensors with T split over
    ``mesh``'s ``axis``, the contract of ``parallel.ring
    .make_ring_attention``; forward K10, backward K11. ``batch_axis`` is
    accepted for the JAX signature (attention is pointwise over the batch,
    and the ranks of a dp x sp mesh all run in the kernels' launch).
    ``slopes`` (len h) adds the ALiBi bias; ``window`` (causal only) the
    sliding-window band, whose far-past chunks skip their compute."""
    del batch_axis
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        window = int(window)
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    if slopes is not None:
        slopes = tuple(float(s) for s in slopes)

    def attn(q, k, v):
        return _RingAttention.apply(q, k, v, mesh, axis, causal, slopes,
                                    window)

    return attn
