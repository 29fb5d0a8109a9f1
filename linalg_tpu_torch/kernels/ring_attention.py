"""Ring attention: wrappers of the hand-written CUDA kernels of
``csrc/ring_attention.cu`` (K10 forward, K11 backward), which run the
whole ring in one launch, and the plain PyTorch versions of one ring step
with the rotation of the rank-stacked K/V slots.

A ring of n ranks holds a sequence of T = n * Tl rows: rank r owns rows
[r Tl, (r + 1) Tl). At step s rank r folds the K/V chunk of rank
``src = (r - s) mod n``. Every buffer is rank-stacked on one device:

- ``q``, ``k``, ``v``, ``do``, ``o``, ``dq``, ``dk``, ``dv``: (BH, T, D)
  in the io dtype (float32 or bfloat16), rank r's rows at [r Tl, (r + 1)
  Tl);
- ``L``, ``delta``: (BH, T) float32.

``ring_fwd_cuda`` returns (o, L) and ``ring_bwd_cuda`` (dq, dk, dv), each
from ONE call over all n steps: each block loops over the steps in the
ring's order and reads chunk src's rows of k and v where they lie, with
its running state in registers, so no chunk is copied and no state goes
to device memory between steps. The kernels take a range of ranks (of
chunks for dk/dv); one card runs them all. D is the padded head
width, one of ``SUPPORTED_D``; ``scale`` is 1/sqrt(true d_head).
``slopes`` is a float32 (H,) tensor of ALiBi slopes (head h of batch b is
row b H + h) or None.

On a CUDA tensor the wrappers launch the kernels or raise; they validate
what the kernels do not take and substitute nothing. Each wrapper's
``launches`` counts its calls (one per ring call; K11's dq and dk/dv
kernels count as one).

The plain versions compute the same function the TPU's way, one step at a
time: ``ring_fwd_step_ref`` / ``ring_bwd_step_ref`` update per-rank state
buffers from the chunk in a K/V slot (n, 2, BH, Tl, D) or an f32 bundle
slot (n, 4, BH, Tl, D) = (k, v, dk, dv), which ``rotate`` moves one hop
between steps (``parallel.ring_pallas`` drives them; ``chunk_live``
decides as the kernels do). The CPU tests hold them against the JAX
package's ring in interpret mode, and a card run holds the kernels
against them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import build

__all__ = ["ring_fwd_cuda", "ring_bwd_cuda", "ring_fwd_step_ref",
           "ring_bwd_step_ref", "rotate", "chunk_live", "padded_d",
           "SUPPORTED_D"]

SUPPORTED_D = (32, 64, 128, 256)
MAX_BH = 65535  # batch * heads rides the grid's y dimension
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def padded_d(d: int) -> int:
    """The smallest kernel width that holds a head of ``d`` columns."""
    for w in SUPPORTED_D:
        if d <= w:
            return w
    raise ValueError(f"d_head {d} is wider than the ring kernels' widest, "
                     f"{SUPPORTED_D[-1]}")


def chunk_live(src: int, r: int, Tl: int, causal: bool, window) -> bool:
    """Whether the K/V chunk of rank ``src`` can hold a key visible to rank
    ``r`` (``ring_pallas.py:74``): causal bans the future chunks, and a
    window the chunks whose newest key is window - 1 or more behind r's
    oldest row."""
    if not causal:
        return True
    live = src <= r
    if window is not None:
        live = live and (r - src - 1) * Tl < window - 1
    return live


def rotate(cur, nxt):
    """One hop of the ring on rank-stacked slots: rank r + 1 receives rank
    r's chunk, rank 0 rank n - 1's. Two copies, no temporary."""
    nxt[1:].copy_(cur[:-1])
    nxt[0].copy_(cur[-1])


@functools.cache
def _lib():
    lib = ctypes.CDLL(str(build("ring_attention")))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # slopes, BH, H, n, Tl, r0, nr, causal, window, scale, stream
    tail = [ptr] + [i32] * 8 + [f32, ptr]
    lib.ring_fwd_launch.argtypes = [i32, i32] + [ptr] * 5 + tail
    lib.ring_bwd_launch.argtypes = [i32, i32] + [ptr] * 9 + tail
    lib.ring_fwd_launch.restype = i32
    lib.ring_bwd_launch.restype = i32
    return lib


def _check(name, io, rows, n, H, slopes, window):
    """Validate a call's tensors: ``io`` (BH, T, D) in one dtype, ``rows``
    float32 (BH, T); return (BH, T, D, Tl)."""
    q = io[0]
    if q.dim() != 3:
        raise ValueError(f"{name}: q must be (BH, T, D), got "
                         f"{tuple(q.shape)}")
    BH, T, D = q.shape
    tensors = io + rows + ((slopes,) if slopes is not None else ())
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"{name} needs every tensor on one CUDA device")
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype for t in io):
        raise ValueError(f"{name}: q, k, v (and do) must share float32 or "
                         f"bfloat16, got {[t.dtype for t in io]}")
    if any(t.shape != q.shape for t in io):
        raise ValueError(f"{name}: q, k, v (and do) must all be "
                         f"{tuple(q.shape)}, got "
                         f"{[tuple(t.shape) for t in io]}")
    if any(t.dtype != torch.float32 or t.shape != (BH, T) for t in rows):
        raise ValueError(f"{name}: L and delta must be float32 ({BH}, {T})")
    if D not in SUPPORTED_D:
        raise ValueError(f"{name}: head width {D} unsupported (the kernels "
                         f"are built for {SUPPORTED_D}; pad with padded_d)")
    if n < 1 or T % n:
        raise ValueError(f"{name}: T {T} must divide into n = {n} ranks")
    if T >= 2 ** 31:
        raise ValueError(f"{name}: T {T} past the kernels' int positions")
    if not 0 < BH <= MAX_BH or H < 1 or BH % H:
        raise ValueError(f"{name}: BH {BH} must be in (0, {MAX_BH}] and a "
                         f"multiple of H {H}")
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be >= 1 or None, got "
                         f"{window}")
    if slopes is not None and (slopes.dtype != torch.float32
                               or slopes.shape != (H,)):
        raise ValueError(f"{name}: slopes must be float32 ({H},)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")
    if any(t.data_ptr() % 16 for t in io):
        raise ValueError(f"{name} needs 16-byte aligned tensors")
    return BH, T, D, T // n


def _call(name, fn, q, ptrs, slopes, BH, H, n, Tl, causal, window, scale):
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = fn(_DTYPE_CODE[q.dtype], q.shape[-1], *ptrs,
                None if slopes is None else slopes.data_ptr(), BH, H, n, Tl,
                0, n, int(bool(causal)), window or 0, float(scale), stream)
    if rc:
        raise RuntimeError(f"{name} launch failed (code {rc})")


def ring_fwd_cuda(q, k, v, *, n: int, H: int, causal: bool, window,
                  slopes, scale: float):
    """K10 over the whole ring: q, k, v (BH, T, D) -> (o (BH, T, D) in q's
    dtype, L (BH, T) float32)."""
    BH, T, _, Tl = _check("ring_fwd_cuda", (q, k, v), (), n, H, slopes,
                          window)
    o = torch.empty_like(q)
    L = torch.empty((BH, T), dtype=torch.float32, device=q.device)
    _call("ring_fwd", _lib().ring_fwd_launch, q,
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
           L.data_ptr()), slopes, BH, H, n, Tl, causal, window, scale)
    ring_fwd_cuda.launches += 1
    return o, L


def ring_bwd_cuda(q, k, v, do, L, delta, *, n: int, H: int, causal: bool,
                  window, slopes, scale: float):
    """K11 over the whole ring: (dq, dk, dv), each (BH, T, D) in q's dtype,
    from the forward's L and delta = rowsum(dO * O) (both float32 (BH,
    T)); the dq pass, then the dk/dv pass."""
    BH, _, _, Tl = _check("ring_bwd_cuda", (q, k, v, do), (L, delta), n, H,
                          slopes, window)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    _call("ring_bwd", _lib().ring_bwd_launch, q,
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           L.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
           dv.data_ptr()), slopes, BH, H, n, Tl, causal, window, scale)
    ring_bwd_cuda.launches += 1
    return dq, dk, dv


ring_fwd_cuda.launches = 0
ring_bwd_cuda.launches = 0


def _scores(q_r, k, r, src, Tl, H, causal, window, slopes, scale):
    """Rank r's float32 scores against the chunk of rank ``src``:
    scale q k^T plus the ALiBi bias, banned entries -inf."""
    s = scale * (q_r.float() @ k.float().transpose(-1, -2))
    i = torch.arange(Tl, device=q_r.device)
    rows = (r * Tl + i)[:, None]
    cols = (src * Tl + i)[None, :]
    if slopes is not None:
        sl = slopes.repeat(q_r.shape[0] // H)[:, None, None]
        s = s + sl * (cols - rows).float()
    ban = torch.zeros((Tl, Tl), dtype=torch.bool, device=q_r.device)
    if causal:
        ban |= cols > rows
    if window is not None:
        ban |= rows - cols >= window
    return torch.where(ban, float("-inf"), s)


@torch.no_grad()
def ring_fwd_step_ref(q, kv, m, l, acc, o, L, *, n: int, H: int, step: int,
                      ranks, causal: bool, window, slopes, scale: float,
                      last: bool):
    """One forward step the TPU's way, the plain version of K10: fold the
    chunk in the K/V slot ``kv`` (n, 2, BH, Tl, D) into the float32 running
    max ``m``, normalizer ``l`` (BH, T) and accumulator ``acc`` (BH, T, D),
    the same online softmax (-inf for banned scores), rank by rank; at the
    last step write o and L instead."""
    Tl = q.shape[1] // n
    ninf = float("-inf")
    for r in range(ranks[0], ranks[0] + ranks[1]):
        src = (r - step) % n
        live = chunk_live(src, r, Tl, causal, window)
        if not live and not last:
            continue
        rows = slice(r * Tl, (r + 1) * Tl)
        if step == 0:
            m_r = torch.full_like(m[:, rows], ninf)
            l_r = torch.zeros_like(l[:, rows])
            acc_r = torch.zeros_like(acc[:, rows])
        else:
            m_r, l_r, acc_r = m[:, rows], l[:, rows], acc[:, rows]
        if live:
            s = _scores(q[:, rows], kv[r, 0], r, src, Tl, H, causal, window,
                        slopes, scale)
            mn = torch.maximum(m_r, s.amax(-1))
            none = mn == ninf  # nothing visible yet
            alpha = torch.where(none, 1.0, torch.exp(m_r - mn))
            p = torch.where(none[..., None], 0.0, torch.exp(s - mn[..., None]))
            l_r = l_r * alpha + p.sum(-1)
            acc_r = acc_r * alpha[..., None] + p @ kv[r, 1].float()
            m_r = mn
        if last:
            denom = torch.where(l_r == 0, 1.0, l_r)
            o[:, rows] = (acc_r / denom[..., None]).to(o.dtype)
            L[:, rows] = m_r + torch.log(denom)
        else:
            m[:, rows], l[:, rows], acc[:, rows] = m_r, l_r, acc_r


@torch.no_grad()
def ring_bwd_step_ref(q, do, L, delta, bundle, dq_acc, dq, *, n: int,
                      H: int, step: int, ranks, causal: bool, window, slopes,
                      scale: float, last: bool):
    """One backward step the TPU's way, the plain version of K11: P
    recomputed from L, dq accumulated in float32 ``dq_acc`` (written to
    ``dq`` at the last step), the bundle slot's dk/dv gaining each rank's
    share of the chunk it holds."""
    Tl = q.shape[1] // n
    for r in range(ranks[0], ranks[0] + ranks[1]):
        src = (r - step) % n
        live = chunk_live(src, r, Tl, causal, window)
        if not live and not last:
            continue
        rows = slice(r * Tl, (r + 1) * Tl)
        acc_r = (torch.zeros_like(dq_acc[:, rows]) if step == 0
                 else dq_acc[:, rows])
        if live:
            k, v = bundle[r, 0], bundle[r, 1]
            q_r, do_r = q[:, rows].float(), do[:, rows].float()
            s = _scores(q_r, k, r, src, Tl, H, causal, window, slopes, scale)
            p = torch.where(s == float("-inf"), 0.0,
                            torch.exp(s - L[:, rows, None]))
            ds = (do_r @ v.transpose(-1, -2) - delta[:, rows, None]) * p
            acc_r = acc_r + ds @ k
            bundle[r, 2] += scale * (ds.transpose(-1, -2) @ q_r)
            bundle[r, 3] += p.transpose(-1, -2) @ do_r
        if last:
            dq[:, rows] = (scale * acc_r).to(dq.dtype)
        else:
            dq_acc[:, rows] = acc_r
