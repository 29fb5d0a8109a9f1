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
-1e30 (exp underflows to 0, the max stays finite). The reduction, the
softmax and dlogits are float32 (float64 for float64 h), as in the JAX
package. The chunk products take their operands in one of two precisions,
chosen by h:

- a bfloat16 h on a CUDA device keeps h in bfloat16 and casts W once a
  pass to bfloat16, and dlogits once a chunk; each product is a bf16 x
  bf16 tensor-core GEMM with float32 accumulation and a float32 result
  (``out_dtype``). This is what the JAX package's dots at DEFAULT
  precision do on a TPU, and the precision of every other product of a
  bf16-compute step. Logits are never rounded to bf16.
- any other h (float32, float64, or any h on the CPU) casts h, W and b to
  the working type and runs plain ``torch.matmul`` in it, as the JAX
  package does on the CPU.

Each pass runs inside a span, ``ce.forward`` / ``ce.backward``, whose args
name the products' precision (``path``: "bf16", "f32" or "f64") and the
number of chunks.
"""

from __future__ import annotations

import torch

from ..utils.profiling import span

__all__ = ["chunked_softmax_ce", "DEFAULT_CHUNK"]

DEFAULT_CHUNK = 4096
_NEG = -1e30  # padded-vocab logit: exp() == 0, finite max
_PATH = {torch.bfloat16: "bf16", torch.float32: "f32", torch.float64: "f64"}


def _work_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32, or float64 for float64 inputs."""
    return torch.promote_types(dtype, torch.float32)


def _operand_dtype(h) -> torch.dtype:
    """The chunk products' operand type: bfloat16 for a bfloat16 h on a
    CUDA device (tensor cores, float32 accumulation), else the working
    type."""
    if h.dtype == torch.bfloat16 and h.is_cuda:
        return torch.bfloat16
    return _work_dtype(h.dtype)


def _pad_vocab(W, b, chunk: int):
    V = W.shape[0]
    Vp = -(-V // chunk) * chunk
    if Vp != V:
        W = torch.cat([W, W.new_zeros((Vp - V, W.shape[1]))])
        b = torch.cat([b, b.new_full((Vp - V,), _NEG)])
    return W, b, Vp


def _chunks(h2, W, b, chunk: int):
    """Yield (base, logits of rows [base, base + chunk) in the working
    type, W chunk in h2's type) of the padded vocabulary; W is cast once."""
    dt = h2.dtype
    wt = _work_dtype(dt)
    Wp, bp, Vp = _pad_vocab(W.to(dt), b.to(wt), chunk)
    for base in range(0, Vp, chunk):
        Wk, bk = Wp[base:base + chunk], bp[base:base + chunk]
        if dt == wt:
            yield base, h2 @ Wk.T + bk[None, :], Wk
        else:
            yield base, torch.addmm(bk, h2, Wk.T, out_dtype=wt), Wk


def _gold_rows(y, base: int, chunk: int):
    """(hit mask (N,), index in the chunk (N,)) of the labels."""
    hit = (y >= base) & (y < base + chunk)
    return hit, torch.clamp(y - base, 0, chunk - 1)


def _span(name: str, h2, V: int, chunk: int):
    return span(name, h2.device, args={"path": _PATH[h2.dtype],
                                       "chunks": -(-V // chunk)})


class _ChunkedCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, W, b, y, chunk):
        D = h.shape[-1]
        h2 = h.reshape(-1, D).to(_operand_dtype(h))
        wt = _work_dtype(h.dtype)
        yf = y.reshape(-1).long()
        N = h2.shape[0]
        m = torch.full((N,), _NEG, dtype=wt, device=h.device)
        s = torch.zeros((N,), dtype=wt, device=h.device)
        gold = torch.zeros((N,), dtype=wt, device=h.device)
        with _span("ce.forward", h2, W.shape[0], chunk):
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
        h2 = h.reshape(-1, D).to(_operand_dtype(h))
        wt = _work_dtype(h.dtype)
        yf = y.reshape(-1).long()
        N = h2.shape[0]
        logz = torch.log(s) + m
        scale = g.to(wt) / N  # d(mean)/d(sum) x the upstream grad
        dh = torch.zeros((N, D), dtype=wt, device=h.device)
        Vp = -(-V // chunk) * chunk
        dW = torch.empty((Vp, D), dtype=wt, device=h.device)
        db = torch.empty((Vp,), dtype=wt, device=h.device)
        cols = torch.arange(chunk, device=h.device)
        with _span("ce.backward", h2, V, chunk):
            for base, logits, Wk in _chunks(h2, W, b, chunk):
                p = torch.exp(logits - logz[:, None])  # softmax, full V
                hit, idx = _gold_rows(yf, base, chunk)
                onehot = (hit[:, None] & (cols[None, :] == idx[:, None])
                          ).to(p.dtype)
                dl = (p - onehot) * scale  # the reference's (P - onehot)/N
                torch.sum(dl, dim=0, out=db[base:base + chunk])
                if h2.dtype == wt:
                    dh += dl @ Wk
                    torch.matmul(dl.T, h2, out=dW[base:base + chunk])
                else:
                    dl = dl.to(h2.dtype)
                    torch.addmm(dh, dl, Wk, out_dtype=wt, out=dh)
                    torch.mm(dl.T, h2, out_dtype=wt,
                             out=dW[base:base + chunk])
        return (dh.reshape(h.shape).to(h.dtype), dW[:V].to(W.dtype),
                db[:V].to(b.dtype), None, None)


def chunked_softmax_ce(h, W, b, y, chunk: int = DEFAULT_CHUNK):
    """Mean softmax CE of ``h @ W^T + b`` against labels ``y``.

    h (..., D) float; W (V, D); b (V,); y (...) integer. Returns a float32
    scalar (float64 for float64 h). Differentiable in h, W and b. A
    bfloat16 h on a CUDA device takes bf16 tensor-core products with
    float32 accumulation; any other h takes products in the working type."""
    return _ChunkedCE.apply(h, W, b, y, int(chunk))
