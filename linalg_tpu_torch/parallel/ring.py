"""Ring attention over an ``sp`` mesh axis — the counterpart of
``linalg_tpu/parallel/ring.py`` (``--ring xla``).

The sequence axis is split over the ring's n ranks; every rank keeps its
query chunk while the K/V chunks rotate one hop per step and an online
softmax (running max m, normalizer l, float32 accumulator) takes in one
chunk per step. The JAX package runs the per-device loop inside
``shard_map`` with ``lax.ppermute`` as the rotation; here the ranks are
rank-stacked: chunk tensors carry a leading rank axis and one hop is
``torch.roll`` along it. Gradients come from torch autograd through these
plain ops, as JAX's come from ``jax.grad`` through ``ppermute``.

``ring_attention_ranks`` is the same loop with each rank's chunk a tensor
of its own, as a mesh whose ranks lie in several processes holds them:
the K/V chunks rotate by ``parallel.mesh.ppermute``, across processes
through their group, and autograd runs the reverse rotation backward.
"""

from __future__ import annotations

import math

import torch

__all__ = ["make_ring_attention", "ring_attention_local",
           "ring_attention_ranks"]

_NEG = -1e30


def _chunks(x, n: int):
    """(B, h, T, d) -> the rank-stacked (n, B, h, T / n, d) chunks."""
    B, h, T, d = x.shape
    return x.reshape(B, h, n, T // n, d).permute(2, 0, 1, 3, 4)


def _fold(q, k, v, rows, cols, m, l, acc, slopes, causal, window):
    """One ring step's online-softmax update (m, l, acc) from the chunk
    (k, v) whose key positions are ``cols``, for queries at ``rows``
    (broadcastable position grids): scores in q's dtype, state float32."""
    d = q.shape[-1]
    sc = ((1.0 / math.sqrt(d)) * (q @ k.transpose(-1, -2))).float()
    if slopes is not None:
        sc = sc + slopes * (cols - rows).float()
    if causal:
        sc = torch.where(cols <= rows, sc, _NEG)
    if window is not None:
        sc = torch.where(cols > rows - window, sc, _NEG)
    m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
    p = torch.exp(sc - m_new)
    alpha = torch.exp(m - m_new)
    return m_new, l * alpha + p.sum(-1, keepdim=True), \
        acc * alpha + p @ v.float()


def ring_attention_local(q, k, v, *, n: int, causal: bool = True,
                         slopes=None, window=None):
    """The per-rank loop of ``ring.py:32-84`` over every rank at once: q,
    k, v are global (B, h, T, d) with rank r's rows at [r Tl, (r + 1) Tl).

    ``slopes`` (h,) adds the ALiBi bias ``slope_h * (col - row)``;
    ``window`` bans keys window or more behind each query. As in JAX,
    scores are formed in q's dtype and the softmax state is float32; every
    chunk makes the full loop (banned entries take -1e30)."""
    B, h, T, d = q.shape
    if T % n:
        raise ValueError(f"T {T} must divide into the ring's {n} ranks")
    Tl = T // n
    dev = q.device
    ranks = torch.arange(n, device=dev)
    pos = torch.arange(Tl, device=dev)
    rows = (ranks[:, None] * Tl + pos)[:, None, None, :, None]
    sl = None if slopes is None else torch.as_tensor(
        slopes, dtype=torch.float32, device=dev)[None, None, :, None, None]

    qc = _chunks(q, n)
    k_cur, v_cur = _chunks(k, n), _chunks(v, n)
    m = torch.full((n, B, h, Tl, 1), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((n, B, h, Tl, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((n, B, h, Tl, d), dtype=torch.float32, device=dev)
    for s in range(n):
        src = (ranks - s) % n  # origin rank of the chunk each rank holds
        cols = (src[:, None] * Tl + pos)[:, None, None, None, :]
        m, l, acc = _fold(qc, k_cur, v_cur, rows, cols, m, l, acc, sl,
                          causal, window)
        if s != n - 1:  # rank r + 1 receives rank r's chunk
            k_cur = torch.roll(k_cur, 1, dims=0)
            v_cur = torch.roll(v_cur, 1, dims=0)
    out = acc / torch.where(l == 0, 1.0, l)
    return out.permute(1, 2, 0, 3, 4).reshape(B, h, T, d).to(q.dtype)


def make_ring_attention(mesh, *, axis: str = "sp", causal: bool = True,
                        batch_axis: str | None = None, slopes=None,
                        window=None):
    """attn(q, k, v) for GLOBAL (B, h, T, d) tensors with T split over
    ``mesh``'s ``axis`` (T must divide by its size). ``batch_axis`` names
    the axis B is split over in the JAX package; attention is pointwise
    over the batch, so the result does not depend on it. ``slopes`` (h,)
    enables the ALiBi bias, ``window`` the sliding-window band."""
    del batch_axis
    n = mesh.shape[axis]
    if slopes is not None:
        slopes = tuple(float(s) for s in slopes)

    def attn(q, k, v):
        return ring_attention_local(q, k, v, n=n, causal=causal,
                                    slopes=slopes, window=window)

    return attn


def ring_attention_ranks(qs, ks, vs, mesh, axis: str = "sp", *,
                         causal: bool = True, slopes=None, window=None):
    """The ring over per-rank chunks: ``qs``, ``ks``, ``vs`` per-rank lists
    of (B, h, Tl, d) (None for the ranks of other processes), the rank at
    index j of its ``axis`` group holding positions [j Tl, (j + 1) Tl).
    Each step folds the K/V chunk a rank holds into its online softmax,
    in ``ring_attention_local``'s order and arithmetic, then one
    ``ppermute`` hands every chunk to the next rank. Returns the per-rank
    (B, h, Tl, d) outputs in q's dtype."""
    from .mesh import ppermute

    n = mesh.shape[axis]
    perm = [(i, (i + 1) % n) for i in range(n)]
    st = {}  # rank: [m, l, acc]
    for r in mesh.local_ranks:
        B, h, Tl, d = qs[r].shape
        st[r] = [qs[r].new_full((B, h, Tl, 1), _NEG, dtype=torch.float32),
                 qs[r].new_zeros((B, h, Tl, 1), dtype=torch.float32),
                 qs[r].new_zeros((B, h, Tl, d), dtype=torch.float32)]
    kv = [None if k is None else torch.stack([k, v])
          for k, v in zip(ks, vs)]
    for s in range(n):
        for r, state in st.items():
            q, j = qs[r], mesh.coords[r][axis]
            Tl, pos = q.shape[2], torch.arange(q.shape[2], device=q.device)
            sl = None if slopes is None else torch.as_tensor(
                slopes, dtype=torch.float32, device=q.device)[None, :, None,
                                                              None]
            state[:] = _fold(q, kv[r][0], kv[r][1],
                             (j * Tl + pos)[None, None, :, None],
                             (((j - s) % n) * Tl + pos)[None, None, None, :],
                             *state, sl, causal, window)
        if s != n - 1:
            kv = ppermute(kv, mesh, axis, perm)
    out = [None] * mesh.size
    for r, (_, l, acc) in st.items():
        out[r] = (acc / torch.where(l == 0, 1.0, l)).to(qs[r].dtype)
    return out
