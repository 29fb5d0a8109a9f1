"""Fused LayerNorm + projections for the GPT hot path — the counterpart of
``linalg_tpu/nn/fused_layer.py`` (K8 ``ln_qkv``, K9 ``ln_ffn``).

- ``ln_qkv(x, g, b, Wq, Wk, Wv) -> (q, k, v)``: LayerNorm (f32 statistics,
  eps 1e-5) then the three attention projections.
- ``ln_ffn(x, g, b, W1, b1, W2, b2) -> f``: LayerNorm then the ReLU MLP.

Both are ``autograd.Function``s that save only their inputs, as the JAX
``custom_vjp``s do: the backward recomputes the LayerNorm (and the FFN's
hidden) from x. On CUDA tensors they run the hand-written kernels of
``kernels/csrc/fused_layer.cu``; on CPU tensors the plain versions
``ln_qkv_ref``/``ln_qkv_bwd_ref`` and ``ln_ffn_ref``/``ln_ffn_bwd_ref``,
which round where the kernels (and the Pallas kernels) round: the
normalized x to the io dtype before each product, relu(z) and dz to the io
dtype, products accumulated in float32, weight gradients rounded once.
The LayerNorm backward of both takes the float32 dxn (the JAX ``ln_ffn``
rounds dxn to the io dtype first and runs the LN backward in it; in
float32 the two are the same).
"""

from __future__ import annotations

import torch

__all__ = ["ln_qkv", "ln_ffn", "fused_supported", "ln_qkv_ref",
           "ln_qkv_bwd_ref", "ln_ffn_ref", "ln_ffn_bwd_ref", "EPS"]

EPS = 1e-5


def fused_supported(n_tokens: int, d_model: int, d_ff: int) -> bool:
    """Shapes the kernels handle: the JAX rule (whole 256-token blocks,
    lane-aligned D and F), which also covers the CUDA kernels' 64-row and
    128-column tiles."""
    return (n_tokens % 256 == 0 and d_model % 128 == 0 and d_ff % 128 == 0
            and d_model >= 128 and d_ff >= 128)


def _ln(x, g, b):
    """(x^ rounded to x's dtype, xhat f32, rstd f32) of 2-D x."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    xc = x32 - mu
    rstd = torch.rsqrt(torch.mean(xc * xc, dim=-1, keepdim=True) + EPS)
    xhat = xc * rstd
    return (xhat * g.float() + b.float()).to(x.dtype), xhat, rstd


def _ln_bwd(dxn, xhat, rstd, g):
    """(dx f32, dg f32, db f32) of the LayerNorm from float32 dxn."""
    ghat = dxn * g.float()
    m1 = torch.mean(ghat, dim=-1, keepdim=True)
    m2 = torch.mean(ghat * xhat, dim=-1, keepdim=True)
    dx = (ghat - m1 - xhat * m2) * rstd
    return dx, torch.sum(dxn * xhat, dim=0), torch.sum(dxn, dim=0)


def _mm(a, b):
    """a @ b of io-dtype operands, accumulated in float32."""
    return a.float() @ b.float()


def ln_qkv_ref(x, g, b, wq, wk, wv):
    """Plain version of the K8 forward on x (N, D): (q, k, v)."""
    xn = _ln(x, g, b)[0]
    return tuple(_mm(xn, w).to(x.dtype) for w in (wq, wk, wv))


def ln_qkv_bwd_ref(x, g, b, wq, wk, wv, dq, dk, dv):
    """Plain version of the K8 backward: (dx, dg, db, dWq, dWk, dWv)."""
    xn, xhat, rstd = _ln(x, g, b)
    dxn = sum(_mm(dy, w.T) for dy, w in ((dq, wq), (dk, wk), (dv, wv)))
    dws = [_mm(xn.T, dy).to(w.dtype)
           for dy, w in ((dq, wq), (dk, wk), (dv, wv))]
    dx, dg, db = _ln_bwd(dxn, xhat, rstd, g)
    return (dx.to(x.dtype), dg.to(g.dtype), db.to(b.dtype), *dws)


def ln_ffn_ref(x, g, b, w1, b1, w2, b2):
    """Plain version of the K9 forward on x (N, D): f (N, D)."""
    xn = _ln(x, g, b)[0]
    a = torch.relu(_mm(xn, w1) + b1.float()).to(x.dtype)
    return (_mm(a, w2) + b2.float()).to(x.dtype)


def ln_ffn_bwd_ref(x, g, b, w1, b1, w2, df):
    """Plain version of the K9 backward: (dx, dg, db, dW1, db1, dW2,
    db2)."""
    xn, xhat, rstd = _ln(x, g, b)
    z = _mm(xn, w1) + b1.float()
    a = torch.relu(z).to(x.dtype)
    dz32 = torch.where(z > 0, _mm(df, w2.T), 0.0)
    dz = dz32.to(x.dtype)
    dx, dg, db = _ln_bwd(_mm(dz, w1.T), xhat, rstd, g)
    return (dx.to(x.dtype), dg.to(g.dtype), db.to(b.dtype),
            _mm(xn.T, dz).to(w1.dtype), dz32.sum(dim=0).to(b1.dtype),
            _mm(a.T, df).to(w2.dtype), df.float().sum(dim=0).to(x.dtype))


def _pick(x, ref, kernel_name):
    """The plain version for a CPU tensor, the CUDA kernel's wrapper for a
    CUDA one; any other device raises."""
    if x.device.type == "cpu":
        return ref
    if x.device.type != "cuda":
        raise ValueError(f"{kernel_name}: no kernel and no plain version "
                         f"for device {x.device}")
    from ..kernels import fused_layer as k

    return getattr(k, kernel_name)


class _LnQKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, b, wq, wk, wv, plain):
        shape = x.shape
        x2 = x.reshape(-1, shape[-1]).contiguous()
        ws = [t.contiguous() for t in (g, b, wq, wk, wv)]
        fwd = ln_qkv_ref if plain else _pick(x2, ln_qkv_ref,
                                             "ln_qkv_fwd_cuda")
        outs = fwd(x2, *ws)
        ctx.save_for_backward(x2, *ws)
        ctx.shape, ctx.plain = shape, plain
        return tuple(o.reshape(shape) for o in outs)

    @staticmethod
    def backward(ctx, dq, dk, dv):
        x2 = ctx.saved_tensors[0]
        dys = [torch.zeros_like(x2) if d is None
               else d.reshape(x2.shape).contiguous() for d in (dq, dk, dv)]
        bwd = ln_qkv_bwd_ref if ctx.plain else _pick(
            x2, ln_qkv_bwd_ref, "ln_qkv_bwd_cuda")
        dx, *rest = bwd(*ctx.saved_tensors, *dys)
        return (dx.reshape(ctx.shape), *rest, None)


class _LnFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, b, w1, b1, w2, b2, plain):
        shape = x.shape
        x2 = x.reshape(-1, shape[-1]).contiguous()
        ws = [t.contiguous() for t in (g, b, w1, b1, w2, b2)]
        fwd = ln_ffn_ref if plain else _pick(x2, ln_ffn_ref,
                                             "ln_ffn_fwd_cuda")
        f = fwd(x2, *ws)
        ctx.save_for_backward(x2, *ws[:5])
        ctx.shape, ctx.plain = shape, plain
        return f.reshape(shape)

    @staticmethod
    def backward(ctx, df):
        x2 = ctx.saved_tensors[0]
        bwd = ln_ffn_bwd_ref if ctx.plain else _pick(
            x2, ln_ffn_bwd_ref, "ln_ffn_bwd_cuda")
        dx, *rest = bwd(*ctx.saved_tensors,
                        df.reshape(x2.shape).contiguous())
        return (dx.reshape(ctx.shape), *rest, None)


def ln_qkv(x, g, b, wq, wk, wv, plain: bool = False):
    """LayerNorm(x) @ {Wq, Wk, Wv} fused; x (..., D) -> three like x.
    ``plain=True`` runs the plain versions on any device (the reference a
    run on the card holds the kernels against)."""
    return _LnQKV.apply(x, g, b, wq, wk, wv, plain)


def ln_ffn(x, g, b, w1, b1, w2, b2, plain: bool = False):
    """relu(LayerNorm(x) @ W1 + b1) @ W2 + b2 fused; x (..., D)."""
    return _LnFFN.apply(x, g, b, w1, b1, w2, b2, plain)
