"""Fused softmax cross-entropy, chunked over the vocabulary — the
counterpart of ``linalg_tpu/nn/losses.py``.

``chunked_softmax_ce(h, W, b, y)`` is the mean CE of ``h @ W^T + b``
against ``y`` without the (N, V) logits: the forward walks the vocabulary
in chunks of ``DEFAULT_CHUNK`` rows with an online (max, sumexp) reduction
and picks up each gold logit in the chunk that holds it; the backward
recomputes each chunk's logits and applies the reference's closed form
dlogits = (softmax - onehot) / N, writing dW and db chunk by chunk into
their preallocated slices and accumulating dh. It saves only (h, W, b, y)
and the (N,) streaming stats, so peak memory is O(N * chunk) plus W's
gradient.

The vocabulary is padded to a chunk multiple with zero rows and a bias of
-1e30 (exp underflows to 0, the max stays finite). h, W and b are cast to
float32 before the products, as the JAX package does; float64 inputs stay
float64 (the CPU parity tests). The chunk products are plain
``torch.matmul``: the JAX package computes them outside any kernel.
"""

from __future__ import annotations

import torch

__all__ = ["chunked_softmax_ce", "DEFAULT_CHUNK"]

DEFAULT_CHUNK = 4096
_NEG = -1e30  # padded-vocab logit: exp() == 0, finite max


def _work_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32, or float64 for float64 inputs."""
    return torch.promote_types(dtype, torch.float32)


def _pad_vocab(W, b, chunk: int):
    V = W.shape[0]
    Vp = -(-V // chunk) * chunk
    if Vp != V:
        W = torch.cat([W, W.new_zeros((Vp - V, W.shape[1]))])
        b = torch.cat([b, b.new_full((Vp - V,), _NEG)])
    return W, b, Vp


def _chunks(h2, W, b, chunk: int):
    """Yield (base, f32 logits of rows [base, base + chunk), W chunk) of
    the padded vocabulary."""
    Wp, bp, Vp = _pad_vocab(W, b, chunk)
    dt = h2.dtype
    for base in range(0, Vp, chunk):
        Wk = Wp[base:base + chunk].to(dt)
        yield base, h2 @ Wk.T + bp[base:base + chunk].to(dt)[None, :], Wk


def _gold_rows(y, base: int, chunk: int):
    """(hit mask (N,), index in the chunk (N,)) of the labels."""
    hit = (y >= base) & (y < base + chunk)
    return hit, torch.clamp(y - base, 0, chunk - 1)


class _ChunkedCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, W, b, y, chunk):
        D = h.shape[-1]
        h2 = h.reshape(-1, D).to(_work_dtype(h.dtype))
        yf = y.reshape(-1).long()
        N = h2.shape[0]
        m = torch.full((N,), _NEG, dtype=h2.dtype, device=h.device)
        s = torch.zeros((N,), dtype=h2.dtype, device=h.device)
        gold = torch.zeros((N,), dtype=h2.dtype, device=h.device)
        for base, logits, _ in _chunks(h2, W, b, chunk):
            m_new = torch.maximum(m, logits.amax(dim=1))
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(dim=1)
            m = m_new
            hit, idx = _gold_rows(yf, base, chunk)
            gold = gold + torch.where(
                hit, logits.gather(1, idx[:, None])[:, 0], 0.0)
        ctx.save_for_backward(h, W, b, y, m, s)
        ctx.chunk = chunk
        return torch.mean(torch.log(s) + m - gold)

    @staticmethod
    def backward(ctx, g):
        h, W, b, y, m, s = ctx.saved_tensors
        chunk = ctx.chunk
        D, V = h.shape[-1], W.shape[0]
        h2 = h.reshape(-1, D).to(_work_dtype(h.dtype))
        yf = y.reshape(-1).long()
        N = h2.shape[0]
        logz = torch.log(s) + m
        scale = g.to(h2.dtype) / N  # d(mean)/d(sum) x the upstream grad
        dh = torch.zeros_like(h2)
        Vp = -(-V // chunk) * chunk
        dW = torch.empty((Vp, D), dtype=h2.dtype, device=h.device)
        db = torch.empty((Vp,), dtype=h2.dtype, device=h.device)
        cols = torch.arange(chunk, device=h.device)
        for base, logits, Wk in _chunks(h2, W, b, chunk):
            p = torch.exp(logits - logz[:, None])  # softmax over the full V
            hit, idx = _gold_rows(yf, base, chunk)
            onehot = (hit[:, None] & (cols[None, :] == idx[:, None])).to(
                p.dtype)
            dl = (p - onehot) * scale  # the reference's dZ = (P - onehot)/N
            dh += dl @ Wk
            torch.matmul(dl.T, h2, out=dW[base:base + chunk])
            torch.sum(dl, dim=0, out=db[base:base + chunk])
        return (dh.reshape(h.shape).to(h.dtype), dW[:V].to(W.dtype),
                db[:V].to(b.dtype), None, None)


def chunked_softmax_ce(h, W, b, y, chunk: int = DEFAULT_CHUNK):
    """Mean softmax CE of ``h @ W^T + b`` against labels ``y``.

    h (..., D) float; W (V, D); b (V,); y (...) integer. Returns a float32
    scalar (float64 for float64 h). Differentiable in h, W and b."""
    return _ChunkedCE.apply(h, W, b, y, int(chunk))
