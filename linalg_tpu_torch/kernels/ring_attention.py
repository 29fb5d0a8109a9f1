"""One step of ring attention: wrappers of the hand-written CUDA kernels
of ``csrc/ring_attention.cu`` (K10 forward, K11 backward), their plain
PyTorch versions, and the rotation of the rank-stacked K/V slots.

A ring of n ranks holds a sequence of T = n * Tl rows: rank r owns rows
[r Tl, (r + 1) Tl). At step s rank r holds the K/V chunk of rank
``src = (r - s) mod n``. Every buffer is rank-stacked on one device:

- ``q``, ``do``, ``o``, ``dq``: (BH, T, D) in the io dtype (float32 or
  bfloat16), rank r's rows at [r Tl, (r + 1) Tl);
- ``m``, ``l``, ``L``, ``delta``: (BH, T) float32; ``acc``, ``dq_acc``:
  (BH, T, D) float32, each rank's state between steps;
- the forward's K/V slot: (n, 2, BH, Tl, D) in the io dtype (the TPU's
  double-buffered ``kv`` scratch, ``ring_pallas.py:259``, one per rank);
- the backward's bundle slot: (n, 4, BH, Tl, D) float32 = (k, v, dk, dv)
  (``ring_pallas.py:468``).

``ring_fwd_step_cuda`` folds the chunk in the slot into (m, l, acc) and,
at the last step, writes o and L; ``ring_bwd_step_cuda`` adds the chunk's
share to dq (written at the last step) and to the bundle's dk/dv. Both
take a range of ranks ``(r0, nr)``: one device launches the whole ring
here, and a placement over several cards would launch one range per card.
D is the padded head width, one of ``SUPPORTED_D``; ``scale`` is
1/sqrt(true d_head). ``slopes`` is a float32 (H,) tensor of ALiBi slopes
(head h of batch b is row b H + h) or None.

On a CUDA tensor the wrappers launch the kernel or raise; they validate
what the kernel does not take and substitute nothing. The plain versions
``ring_fwd_step_ref`` / ``ring_bwd_step_ref`` update the same buffers the
same way, rank by rank, with ``chunk_live`` deciding as the kernels do;
the callers in ``parallel.ring_pallas`` take them for CPU tensors. Each
wrapper's ``launches`` counts its launches (one per ring step).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import build

__all__ = ["ring_fwd_step_cuda", "ring_bwd_step_cuda", "ring_fwd_step_ref",
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
    r's chunk, rank 0 rank n - 1's. Two device copies, no temporary."""
    nxt[1:].copy_(cur[:-1])
    nxt[0].copy_(cur[-1])


@functools.cache
def _lib():
    lib = ctypes.CDLL(str(build("ring_attention")))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # BH, H, n, Tl, step, r0, nr, causal, window, scale, last, stream
    tail = [i32] * 9 + [f32, i32, ptr]
    lib.ring_fwd_step_launch.argtypes = [i32, i32] + [ptr] * 8 + tail
    lib.ring_bwd_step_launch.argtypes = [i32, i32] + [ptr] * 8 + tail
    lib.ring_fwd_step_launch.restype = i32
    lib.ring_bwd_step_launch.restype = i32
    return lib


def _check(name, io, f32, slot, slot_dtype, n, H, ranks, slopes):
    """Validate a step's tensors: ``io`` (BH, T, D) in one dtype, ``f32``
    float32 (BH, T) or (BH, T, D), the (n, k, BH, Tl, D) ``slot``; return
    (BH, T, D, Tl)."""
    q = io[0]
    if q.dim() != 3:
        raise ValueError(f"{name}: q must be (BH, T, D), got "
                         f"{tuple(q.shape)}")
    BH, T, D = q.shape
    tensors = io + f32 + (slot,) + ((slopes,) if slopes is not None else ())
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"{name} needs every tensor on one CUDA device")
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype for t in io):
        raise ValueError(f"{name}: q and its io tensors must share float32 "
                         f"or bfloat16, got {[t.dtype for t in io]}")
    if D not in SUPPORTED_D:
        raise ValueError(f"{name}: head width {D} unsupported (the kernels "
                         f"are built for {SUPPORTED_D}; pad with padded_d)")
    if n < 1 or T % n:
        raise ValueError(f"{name}: T {T} must divide into n = {n} ranks")
    Tl = T // n
    if not 0 < BH <= MAX_BH or H < 1 or BH % H:
        raise ValueError(f"{name}: BH {BH} must be in (0, {MAX_BH}] and a "
                         f"multiple of H {H}")
    r0, nr = ranks
    if not (0 <= r0 and nr >= 1 and r0 + nr <= n):
        raise ValueError(f"{name}: ranks {ranks} outside the ring of {n}")
    if any(t.shape != q.shape for t in io) or any(
            t.dtype != torch.float32 or t.shape not in ((BH, T), (BH, T, D))
            for t in f32):
        raise ValueError(f"{name}: io tensors must be {tuple(q.shape)} and "
                         f"the f32 state (BH, T) or (BH, T, D)")
    if slot.dtype != slot_dtype or slot.shape[0] != n or tuple(
            slot.shape[2:]) != (BH, Tl, D):
        raise ValueError(f"{name}: slot must be {slot_dtype} (n, k, BH, Tl, "
                         f"D) = ({n}, k, {BH}, {Tl}, {D}), got "
                         f"{slot.dtype} {tuple(slot.shape)}")
    if slopes is not None and (slopes.dtype != torch.float32
                               or slopes.shape != (H,)):
        raise ValueError(f"{name}: slopes must be float32 ({H},)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")
    return BH, T, D, Tl


def _call(name, fn, q, ptrs, slopes, BH, H, n, Tl, step, ranks, causal,
          window, scale, last):
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be >= 1 or None, got "
                         f"{window}")
    if not 0 <= step < n:
        raise ValueError(f"{name}: step {step} outside [0, {n})")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = fn(_DTYPE_CODE[q.dtype], q.shape[-1], *ptrs,
                None if slopes is None else slopes.data_ptr(), BH, H, n, Tl,
                step, ranks[0], ranks[1], int(bool(causal)), window or 0,
                float(scale), int(bool(last)), stream)
    if rc:
        raise RuntimeError(f"{name} launch failed (code {rc})")


def ring_fwd_step_cuda(q, kv, m, l, acc, o, L, *, n: int, H: int, step: int,
                       ranks, causal: bool, window, slopes, scale: float,
                       last: bool):
    """K10, one step: fold the chunks in ``kv`` (this step's slot) into
    (m, l, acc), or at the last step finalize o and L, for ``ranks``."""
    BH, _, _, Tl = _check("ring_fwd_step_cuda", (q, o), (m, l, acc, L), kv,
                          q.dtype, n, H, ranks, slopes)
    _call("ring_fwd_step", _lib().ring_fwd_step_launch, q,
          (q.data_ptr(), kv.data_ptr(), m.data_ptr(), l.data_ptr(),
           acc.data_ptr(), o.data_ptr(), L.data_ptr()), slopes, BH, H, n,
          Tl, step, ranks, causal, window, scale, last)
    ring_fwd_step_cuda.launches += 1


def ring_bwd_step_cuda(q, do, L, delta, bundle, dq_acc, dq, *, n: int,
                       H: int, step: int, ranks, causal: bool, window,
                       slopes, scale: float, last: bool):
    """K11, one step: the dq pass (accumulated in ``dq_acc``, written to
    ``dq`` at the last step) and the dk/dv pass into ``bundle`` (this
    step's slot), for ``ranks``."""
    BH, _, _, Tl = _check("ring_bwd_step_cuda", (q, do, dq),
                          (L, delta, dq_acc), bundle, torch.float32, n, H,
                          ranks, slopes)
    _call("ring_bwd_step", _lib().ring_bwd_step_launch, q,
          (q.data_ptr(), do.data_ptr(), L.data_ptr(), delta.data_ptr(),
           bundle.data_ptr(), dq_acc.data_ptr(), dq.data_ptr()), slopes, BH,
          H, n, Tl, step, ranks, causal, window, scale, last)
    ring_bwd_step_cuda.launches += 1


ring_fwd_step_cuda.launches = 0
ring_bwd_step_cuda.launches = 0


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
    """Plain version of ``ring_fwd_step_cuda``: the same buffers, the same
    online softmax (float32, -inf for banned scores), rank by rank."""
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
    """Plain version of ``ring_bwd_step_cuda``: P recomputed from L, dq
    accumulated in float32, the bundle's dk/dv gaining each rank's share."""
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
