"""Wrappers of the hand-written CUDA kernels of fused LayerNorm + QKV (K8)
and LayerNorm + ReLU FFN (K9), forward and backward.

``ln_qkv_fwd_cuda``, ``ln_qkv_bwd_cuda``, ``ln_ffn_fwd_cuda`` and
``ln_ffn_bwd_cuda`` launch the kernels of ``csrc/fused_layer.cu`` on the
current CUDA stream, on 2-D row-major tensors: x (N, D), W (D, D), W1
(D, F), W2 (F, D), the vectors g, b (D), b1 (F), b2 (D), all in one dtype
(float32 or bfloat16). Each validates its arguments and raises on what
the kernels do not take; none substitutes another implementation. The
plain PyTorch versions are ``linalg_tpu_torch.nn.fused_layer.ln_qkv_ref``
and friends, and the dispatchers there pick between the two by the device
the tensors lie on.

The kernels sum weight, gamma and beta gradients over ``SPLITS`` row
groups, and b1 gradients over 64-row tiles, as float32 partials; the
backward also writes the normalized x once as scratch. The wrappers add
the partials in a fixed order (``torch.sum`` over the group axis) and
round once to the parameter's dtype, so two runs give the same bits. db2 = column sums of df is one
float32 ``torch.sum`` here, as the JAX package takes it outside its
kernels.

Each wrapper's ``launches`` attribute counts its calls (each call launches
its kernels once), so a run can show that its layers went through them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import build

__all__ = ["ln_qkv_fwd_cuda", "ln_qkv_bwd_cuda", "ln_ffn_fwd_cuda",
           "ln_ffn_bwd_cuda", "ROW_BLOCK", "COL_BLOCK", "SPLITS"]

ROW_BLOCK = 64   # rows of a tile: N must be a multiple
COL_BLOCK = 128  # columns of a tile: D and F must be multiples
SPLITS = 8       # row groups of the weight-gradient sums
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib():
    lib = ctypes.CDLL(str(build("fused_layer")))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ln_qkv_fwd_launch.argtypes = [i32] + [ptr] * 10 + [i32, i32, ptr]
    lib.ln_qkv_bwd_launch.argtypes = ([i32] + [ptr] * 15
                                      + [i32, i32, i32, ptr])
    lib.ln_ffn_fwd_launch.argtypes = [i32] + [ptr] * 9 + [i32, i32, i32, ptr]
    lib.ln_ffn_bwd_launch.argtypes = ([i32] + [ptr] * 17
                                      + [i32, i32, i32, i32, ptr])
    for fn in (lib.ln_qkv_fwd_launch, lib.ln_qkv_bwd_launch,
               lib.ln_ffn_fwd_launch, lib.ln_ffn_bwd_launch):
        fn.restype = i32
    return lib


def _check(name, x, shaped):
    """Validate x (N, D) and the ``shaped`` (tensor, expected shape) pairs:
    one CUDA device, one dtype, the expected shapes, contiguous; return
    (N, D)."""
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be (N, D), got {tuple(x.shape)}")
    N, D = x.shape
    ts = [x] + [t for t, _ in shaped]
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError(f"{name} needs every tensor on one CUDA device")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: unsupported dtype {x.dtype} (float32, "
                         "bfloat16)")
    if any(t.dtype != x.dtype for t in ts):
        raise ValueError(f"{name}: every tensor must share x's dtype "
                         f"{x.dtype}")
    for t, shape in shaped:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
    if N == 0 or N % ROW_BLOCK or N // ROW_BLOCK > 65535:
        raise ValueError(f"{name}: N {N} must be a positive multiple of "
                         f"{ROW_BLOCK}")
    if D == 0 or D % COL_BLOCK:
        raise ValueError(f"{name}: D {D} must be a positive multiple of "
                         f"{COL_BLOCK}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} needs contiguous tensors")
    return N, D


def _run(name, fn, x, *args):
    """Launch ``fn`` on x's device and current stream; raise on an error
    code."""
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = fn(_DTYPE_CODE[x.dtype], *args, stream)
    if rc:
        raise RuntimeError(f"{name} launch failed (code {rc})")


def _p(*ts):
    return [t.data_ptr() for t in ts]


def _stats(x):
    return torch.empty(x.shape[0], 2, dtype=torch.float32, device=x.device)


def _f32(*shape, device):
    return torch.empty(shape, dtype=torch.float32, device=device)


def ln_qkv_fwd_cuda(x, g, b, wq, wk, wv):
    """(q, k, v) = LN(x) @ Wq, Wk, Wv, each (N, D) in x's dtype."""
    D_ = x.shape[-1]
    N, D = _check("ln_qkv_fwd_cuda", x, [
        (g, (D_,)), (b, (D_,)), (wq, (D_, D_)), (wk, (D_, D_)),
        (wv, (D_, D_))])
    q, k, v = (torch.empty_like(x) for _ in range(3))
    stats = _stats(x)
    _run("ln_qkv_fwd", _lib().ln_qkv_fwd_launch, x,
         *_p(x, g, b, wq, wk, wv, q, k, v, stats), N, D)
    ln_qkv_fwd_cuda.launches += 1
    return q, k, v


def ln_qkv_bwd_cuda(x, g, b, wq, wk, wv, dq, dk, dv):
    """(dx, dg, db, dWq, dWk, dWv) of ``ln_qkv_fwd_cuda`` from the output
    gradients; the LayerNorm is recomputed from x."""
    D_ = x.shape[-1]
    N, D = _check("ln_qkv_bwd_cuda", x, [
        (g, (D_,)), (b, (D_,)), (wq, (D_, D_)), (wk, (D_, D_)),
        (wv, (D_, D_)), (dq, x.shape), (dk, x.shape), (dv, x.shape)])
    dev = x.device
    dx, xhat = torch.empty_like(x), torch.empty_like(x)
    stats, dxn = _stats(x), _f32(N, D, device=dev)
    dw_part = _f32(3, SPLITS, D, D, device=dev)
    dgb_part = _f32(SPLITS, 2, D, device=dev)
    _run("ln_qkv_bwd", _lib().ln_qkv_bwd_launch, x,
         *_p(x, g, b, wq, wk, wv, dq, dk, dv, dx, stats, xhat, dxn, dw_part,
             dgb_part), N, D, SPLITS)
    ln_qkv_bwd_cuda.launches += 1
    dw = dw_part.sum(dim=1).to(wq.dtype)
    dgb = dgb_part.sum(dim=0)
    return (dx, dgb[0].to(g.dtype), dgb[1].to(b.dtype), dw[0], dw[1], dw[2])


def ln_ffn_fwd_cuda(x, g, b, w1, b1, w2, b2):
    """f = relu(LN(x) @ W1 + b1) @ W2 + b2, (N, D) in x's dtype."""
    D_, F = x.shape[-1], w1.shape[-1]
    N, D = _check("ln_ffn_fwd_cuda", x, [
        (g, (D_,)), (b, (D_,)), (w1, (D_, F)), (b1, (F,)), (w2, (F, D_)),
        (b2, (D_,))])
    _check_f(F, "ln_ffn_fwd_cuda")
    f = torch.empty_like(x)
    stats = _stats(x)
    _run("ln_ffn_fwd", _lib().ln_ffn_fwd_launch, x,
         *_p(x, g, b, w1, b1, w2, b2, f, stats), N, D, F)
    ln_ffn_fwd_cuda.launches += 1
    return f


def ln_ffn_bwd_cuda(x, g, b, w1, b1, w2, df):
    """(dx, dg, db, dW1, db1, dW2, db2) of ``ln_ffn_fwd_cuda`` from df; the
    LayerNorm, z and a are recomputed from x."""
    D_, F = x.shape[-1], w1.shape[-1]
    N, D = _check("ln_ffn_bwd_cuda", x, [
        (g, (D_,)), (b, (D_,)), (w1, (D_, F)), (b1, (F,)), (w2, (F, D_)),
        (df, x.shape)])
    _check_f(F, "ln_ffn_bwd_cuda")
    dev = x.device
    dx, xhat = torch.empty_like(x), torch.empty_like(x)
    db1_part = _f32(N // ROW_BLOCK, F, device=dev)
    dw1_part = _f32(SPLITS, D, F, device=dev)
    dw2_part = _f32(SPLITS, F, D, device=dev)
    dgb_part = _f32(SPLITS, 2, D, device=dev)
    stats, dxn = _stats(x), _f32(N, D, device=dev)
    a, dz = (torch.empty(N, F, dtype=x.dtype, device=dev) for _ in range(2))
    _run("ln_ffn_bwd", _lib().ln_ffn_bwd_launch, x,
         *_p(x, g, b, w1, b1, w2, df, dx, stats, xhat, a, dz, db1_part,
             dw1_part, dw2_part, dxn, dgb_part), N, D, F, SPLITS)
    ln_ffn_bwd_cuda.launches += 1
    dgb = dgb_part.sum(dim=0)
    return (dx, dgb[0].to(g.dtype), dgb[1].to(b.dtype),
            dw1_part.sum(dim=0).to(w1.dtype),
            db1_part.sum(dim=0).to(b1.dtype),
            dw2_part.sum(dim=0).to(w2.dtype),
            df.float().sum(dim=0).to(x.dtype))


def _check_f(F, name):
    if F == 0 or F % COL_BLOCK:
        raise ValueError(f"{name}: F {F} must be a positive multiple of "
                         f"{COL_BLOCK}")


ln_qkv_fwd_cuda.launches = 0
ln_qkv_bwd_cuda.launches = 0
ln_ffn_fwd_cuda.launches = 0
ln_ffn_bwd_cuda.launches = 0
