"""Blocked Householder QR around the hand-written panel kernel.

Port of ``linalg_tpu/ops/pallas/qr_panel.py`` (the port has no ``pallas``
sub-package). Same layout and contract: the panel is stored TRANSPOSED as
``St (b, m)`` — column j of the panel is row j of St — and a panel sweep
returns

- ``St_out (b, m)``: the transformed panel (rows hold this panel's R rows),
- ``Vt (b, m)``: unit-norm reflectors, row j zero left of its pivot lane,
- ``Tt (b, b)``: the TRANSPOSE of the compact-WY factor, i.e.
  H_0 H_1 ... H_{b-1} = I - V T V^T with T = Tt^T and tau = 2.

On Hopper the transposed layout is kept for the kernel's sake too: each
panel column is one contiguous row, read with coalesced 16-byte loads.

- ``factor_strip_ref`` / ``factor_panel_ref``: the plain PyTorch versions
  of the two TPU kernels (one sweep, b steps, element-wise float32 — no
  matrix product, as the TPU kernels stay off the MXU).
- ``_cluster_sweep_ref`` / ``_grid_sweep_ref``: the two kernels' split
  algebra (contiguous lane ranges, folded dots summed in rank order), the
  CPU tests' plain references for it; no card path calls them.
- ``factor_strip`` / ``factor_panel``: the dispatchers of K1 (b <= 64) and
  K12 (any b <= 256). A CPU tensor takes the plain version; a CUDA tensor
  launches ``kernels/csrc/qr_panel.cu`` (whose wrapper
  ``factor_strip_cuda`` picks its cluster kernel or its grid kernel by
  shape), which raises on what it does not take.
- ``householder_qr_panel``: the driver ``householder_qr_pallas`` with all of
  its structure (two-level strips, ``wy_merge``, live-lane slicing at
  ``LQ``, pair/``agg`` far-field aggregation, reverse Q accumulation with
  ``e_top``). Its products are ``torch.matmul`` in full float32 whatever
  the caller's TF32 setting; the long ones over the lane axis are summed
  per chunk of lanes (``_xvt``). JAX's functional slice updates become
  in-place writes into one (n, m) buffer.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..kernels.qr_panel import factor_strip_cuda, grid_lanes
from ..utils.numerics import eps_for, full_f32_matmul

__all__ = [
    "factor_strip_ref",
    "factor_panel_ref",
    "factor_strip",
    "factor_panel",
    "householder_qr_panel",
]

# widest strip the unrolled TPU kernel took (qr_panel.py:150)
STRIP_MAX_B = 64
# long contractions are summed as partial products over chunks of at least
# KCHUNK lanes, at most MAX_CHUNKS of them (see _xvt)
KCHUNK = 128
MAX_CHUNKS = 32


def _xvt(X: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """X @ V.T over the long lane axis, as a sum of per-chunk products.

    The contraction runs over up to m live lanes. A float32 GEMM on the
    card accumulates each output over all of them in one register, and at
    m = 4096 that alone put the 4096^2 QR's ||A - QR||_F / ||A||_F at
    1.005e-6 (NVIDIA H100, 700 W), over the 1e-6 gate; the TPU's HIGHEST
    products met it. Chunks of 128 lanes, one batched product, then a sum
    over the chunks: 6.6e-7, at no measurable cost in time.
    """
    K = X.shape[1]
    cs = KCHUNK * max(1, -(-K // (KCHUNK * MAX_CHUNKS)))
    nc = K // cs
    if nc < 2:
        return X @ V.T
    Km = nc * cs
    G = (X[:, :Km].unflatten(1, (nc, cs)).transpose(0, 1)
         @ V[:, :Km].unflatten(1, (nc, cs)).permute(1, 2, 0)).sum(dim=0)
    if Km < K:
        G += X[:, Km:] @ V[:, Km:].T
    return G


def _sweep_ref(St: torch.Tensor, k: int):
    """The reflector sweep of both TPU kernels, step by step in PyTorch.

    Per step: one masked row, its norm, the reflector, then y = S w and
    z = Vt w as element-wise multiply + reduce (never a matmul, so TF32
    cannot enter). No host readback: the skip test is a tensor ``where``.
    """
    b, m = St.shape
    dtype, dev = St.dtype, St.device
    eps = eps_for(dtype)
    S = St.clone()
    Vt = torch.zeros_like(St)
    Tt = torch.zeros((b, b), dtype=dtype, device=dev)
    lane = torch.arange(m, device=dev)
    for jl in range(b):
        jg = k + jl
        x = torch.where(lane >= jg, S[jl], 0.0)
        nrm2 = (x * x).sum()
        nrm = torch.sqrt(nrm2)
        has = nrm >= eps
        pivot = lane == jg
        x0 = torch.where(pivot, x, 0.0).sum()
        alpha = torch.where(x0 >= 0, nrm, -nrm)
        w_un = x + torch.where(pivot, alpha, 0.0)
        # ||x + alpha e||^2 = ||x||^2 + 2 alpha x0 + alpha^2, analytically
        wn2 = nrm2 + 2.0 * alpha * x0 + alpha * alpha
        inv = torch.rsqrt(torch.where(wn2 == 0, 1.0, wn2))
        w = torch.where(has, w_un * inv, 0.0)
        y = (S * w).sum(dim=1, keepdim=True)  # (b, 1)
        S -= 2.0 * y * w
        Vt[jl] = w
        t_row = torch.zeros(b, dtype=dtype, device=dev)
        if jl:
            z = (Vt[:jl] * w).sum(dim=1, keepdim=True)  # (jl, 1)
            t_row = -2.0 * (z * Tt[:jl]).sum(dim=0)
        t_row[jl] = torch.where(has, 2.0, 0.0)
        Tt[jl] = t_row
    return S, Vt, Tt


def _split_sweep_ref(St: torch.Tensor, k: int, per: int):
    """The kernels' arithmetic, in PyTorch: the same function as
    ``_sweep_ref``, with the live lanes [k & ~3, m) split into contiguous
    ranges of ``per`` lanes, one a CTA, as the kernels split them.

    Each step forms every range's partial dots S_r . x and Vt_i . x, with x
    row j on lanes >= jg, and sums them in rank order; then
    y_r = inv (S_r . x + alpha S_r[jg]) and z_i = inv (Vt_i . x +
    alpha Vt_i[jg]) (S_j . x is nrm^2), and Tt row j from z, as every
    kernel CTA forms them from the same sums.
    """
    b, m = St.shape
    dtype, dev = St.dtype, St.device
    eps = eps_for(dtype)
    lo = min(k & ~3, m)
    ranges = [(a, min(a + per, m)) for a in range(lo, m, per)]
    S = St.clone()
    Vt = torch.zeros_like(St)
    Tt = torch.zeros((b, b), dtype=dtype, device=dev)
    lane = torch.arange(m, device=dev)
    zero = torch.zeros(b, dtype=dtype, device=dev)
    for j in range(b):
        jg = k + j
        x = torch.where(lane >= jg, S[j], 0.0)
        P, Q = zero.clone(), zero.clone()
        for a, e in ranges:  # rank order
            P = P + (S[:, a:e] * x[a:e]).sum(dim=1)
            Q = Q + (Vt[:, a:e] * x[a:e]).sum(dim=1)
        ps = S[:, jg] if jg < m else zero
        pv = Vt[:, jg] if jg < m else zero
        nrm2 = P[j]
        nrm = torch.sqrt(nrm2)
        has = nrm >= eps
        x0 = ps[j]
        alpha = torch.where(x0 >= 0, nrm, -nrm)
        wn2 = nrm2 + 2.0 * alpha * x0 + alpha * alpha
        inv = torch.rsqrt(torch.where(wn2 == 0, 1.0, wn2))
        w = (x + torch.where(lane == jg, alpha, 0.0)) * inv
        y = inv * (P + alpha * ps)
        z = inv * (Q + alpha * pv)  # zero from row j on: Vt rows >= j are 0
        S = torch.where(has, S - 2.0 * y[:, None] * w, S)
        Vt[j] = torch.where(has, w, 0.0)
        t_row = -2.0 * (z[:j, None] * Tt[:j]).sum(dim=0)
        t_row[j] = 2.0
        Tt[j] = torch.where(has, t_row, 0.0)
    return S, Vt, Tt


def _cluster_sweep_ref(St: torch.Tensor, k: int, C: int):
    """The cluster kernel's split algebra: the live lanes in C ranges of
    ceil(live / C) (the kernel's CTAs hold a fixed 256 each). The plain
    reference on the CPU; no card path calls it."""
    live = St.shape[1] - min(k & ~3, St.shape[1])
    return _split_sweep_ref(St, k, max(1, -(-live // C)))


def _grid_sweep_ref(St: torch.Tensor, k: int, G: int):
    """The grid kernel's split algebra, launched with G CTAs: the live
    lanes in ranges of ``grid_lanes(live, G)`` (ceil(live / G) rounded up
    to a multiple of 32), the last range shorter. (The kernel adds a
    slot's G partials by a shuffle tree in each warp, the warp sums in
    order; this sums them in rank order.) The plain reference on the CPU;
    no card path calls it."""
    live = St.shape[1] - min(k & ~3, St.shape[1])
    return _split_sweep_ref(St, k, grid_lanes(live, G))


def factor_strip_ref(St: torch.Tensor, k: int):
    """Plain version of K1 (``factor_strip``): a strip of b <= 64 rows."""
    if St.shape[0] > STRIP_MAX_B:
        raise ValueError(f"a strip has at most {STRIP_MAX_B} rows, got "
                         f"{St.shape[0]}")
    return _sweep_ref(St, int(k))


def factor_panel_ref(St: torch.Tensor, k: int):
    """Plain version of K12 (``factor_panel``): any panel width."""
    return _sweep_ref(St, int(k))


def factor_strip(St: torch.Tensor, k: int):
    """Factor a transposed strip St (b, m), b <= 64, pivots from lane k.

    A CPU tensor takes ``factor_strip_ref``; a CUDA tensor launches the
    kernel (float32) or raises."""
    if St.device.type == "cpu":
        return factor_strip_ref(St, k)
    if St.shape[0] > STRIP_MAX_B:
        raise ValueError(f"a strip has at most {STRIP_MAX_B} rows, got "
                         f"{St.shape[0]}")
    return factor_strip_cuda(St.contiguous(), k)


def factor_panel(St: torch.Tensor, k: int):
    """Factor a transposed panel St (b, m) of any width b <= 256, pivots
    from lane k: the counterpart of JAX's ``factor_panel`` (K12).

    A CPU tensor takes ``factor_panel_ref``; a CUDA tensor launches the
    kernel (float32) or raises."""
    if St.device.type == "cpu":
        return factor_panel_ref(St, k)
    return factor_strip_cuda(St.contiguous(), k)


@full_f32_matmul()
def householder_qr_panel(A: torch.Tensor, block: int = 128, inner: int = 32,
                         pair: bool = True, agg: int = 0,
                         strip: Callable = factor_strip):
    """Blocked economy Householder QR through the panel kernel.

    A must be (m, n) with n % block == 0 and m >= n (the public wrapper in
    ``ops/qr.py`` pads and validates). Returns (Q (m, n), R (n, n)).

    ``agg`` aggregates runs of adjacent panels into one rank-``agg*block``
    compact-WY operator for the far-field updates (trailing rows beyond the
    run, and the Q rows below it); inside a run, panel j's rows take one
    near-field update with the running prefix operator before being
    factored. ``agg=0`` derives 2/1 from ``pair``. Each width-``block``
    panel is factored as ``block/inner`` strips through ``strip`` (the
    dispatcher ``factor_strip`` unless the caller names another sweep, e.g.
    ``factor_strip_ref`` to time the driver without the kernel), with
    rank-``inner`` updates inside the panel and the strip WY factors merged
    into one (block, block) factor.
    """
    if agg <= 0:
        agg = 2 if pair else 1
    m, n = A.shape
    dtype, dev = A.dtype, A.device
    # Reflectors of panel k are ZERO in lanes < k, so every block update
    # only reads/writes lanes >= kq; kq is quantized to multiples of LQ.
    LQ = 256

    def kq_of(k: int) -> int:
        return min((k // LQ) * LQ, max(m - LQ, 0))

    def apply_live(Xl, Vl, Tt, transpose_t: bool):
        """Xl := Xl Q_panel^(T) on the live lanes: transpose_t False
        applies (I - V T^T V^T) (trailing update); True applies
        (I - V T V^T) (Q accumulation)."""
        G = _xvt(Xl, Vl)  # (rows, b)
        H = G @ Tt if transpose_t else G @ Tt.T
        return Xl - H @ Vl

    def wy_merge(Vt1, Tt1, Vt2, Tt2, kq: int):
        """(I - V1 T1 V1^T)(I - V2 T2 V2^T) = I - Vc Tc Vc^T with
        Vc = [V1; V2], Tc = [[T1, -T1 (V1^T V2) T2], [0, T2]]; transposed,
        Ttc's lower-left block is -Tt2 (Vt2 Vt1^T) Tt1."""
        r1, r2 = Vt1.shape[0], Vt2.shape[0]
        gram = _xvt(Vt2[:, kq:], Vt1[:, kq:])  # (r2, r1)
        cross = -((Tt2 @ gram) @ Tt1)
        Ttc = torch.cat([
            torch.cat([Tt1, torch.zeros((r1, r2), dtype=dtype, device=dev)],
                      dim=1),
            torch.cat([cross, Tt2], dim=1),
        ], dim=0)
        return torch.cat([Vt1, Vt2], dim=0), Ttc

    b_in = inner if block % inner == 0 and block > inner else block

    def factor_block(Pt, k: int):
        """Factor a (block, m) transposed panel via b_in-wide strips."""
        done_rows = []
        sub = []
        for i in range(0, block, b_in):
            St_i, Vt_i, Tt_i = strip(Pt[:b_in], k + i)
            done_rows.append(St_i)
            rest = Pt[b_in:]
            if rest.shape[0]:
                kqi = kq_of(k + i)
                live = apply_live(rest[:, kqi:], Vt_i[:, kqi:], Tt_i,
                                  transpose_t=False)
                rest = live if kqi == 0 else torch.cat(
                    [rest[:, :kqi], live], dim=1)
            sub.append((Vt_i, Tt_i))
            Pt = rest
        St = torch.cat(done_rows, dim=0)
        Vt, Tt = sub[0]
        kq = kq_of(k)
        for Vt_i, Tt_i in sub[1:]:
            Vt, Tt = wy_merge(Vt, Tt, Vt_i, Tt_i, kq)
        return St, Vt, Tt

    # Factorization over ONE (n, m) buffer, updated in place: panel rows
    # are read by slice, the trailing update touches rows [k_end, n) x
    # lanes [kq, m) only.
    M = A.T.contiguous()  # (n, m): row j is column j
    groups = []  # (members [(k, Vt, Tt)], prefix Tts, kq)
    ks = list(range(0, n, block))
    i = 0
    while i < len(ks):
        g = min(agg, len(ks) - i)
        kq = kq_of(ks[i])
        members, prefix_Ts = [], []
        Vc = Ttc = None  # running prefix factor
        for j in range(g):
            kj = ks[i + j]
            if j > 0:
                # near field: panel j's rows, rank-(j*block) prefix operator
                M[kj:kj + block, kq:] = apply_live(
                    M[kj:kj + block, kq:], Vc[:, kq:], Ttc,
                    transpose_t=False)
            St, Vt, Tt = factor_block(M[kj:kj + block], kj)
            M[kj:kj + block] = St
            members.append((kj, Vt, Tt))
            if j == 0:
                Vc, Ttc = Vt, Tt
            else:
                Vc, Ttc = wy_merge(Vc, Ttc, Vt, Tt, kq)
            prefix_Ts.append(Ttc)
        k_end = ks[i + g - 1] + block
        if k_end < n:
            M[k_end:, kq:] = apply_live(M[k_end:, kq:], Vc[:, kq:], Ttc,
                                        transpose_t=False)
        groups.append((members, prefix_Ts, kq))
        i += g

    def e_top(k: int, Vt, Tt, kq: int):
        """(I - V T V^T) applied to this panel's identity rows, live lanes.
        E_b V^T is a slice of Vt (no matmul); rows of E at index >= m are
        zero (column-padded inputs), so the slice is zero-padded."""
        Vl = Vt[:, kq:]
        hi = min(k + block, m)
        G_top = Vl[:, k - kq:hi - kq].T
        if hi - k < block:
            G_top = torch.cat([G_top, torch.zeros(
                (block - (hi - k), block), dtype=dtype, device=dev)], dim=0)
        H_top = G_top @ Tt
        e_rows = torch.arange(block, device=dev)[:, None] + k
        e_live = (e_rows == torch.arange(kq, m, device=dev)[None, :]).to(dtype)
        return e_live - H_top @ Vl

    # Economy Q (transposed), reverse accumulation into one zeroed (n, m)
    # buffer: rows [k_p, k_p + b) are still identity rows when panel p
    # reaches them, so their contribution is e_top's slice of Vt; lanes
    # < kq stay zero.
    Qt = torch.zeros((n, m), dtype=dtype, device=dev)
    for members, prefix_Ts, kq in reversed(groups):
        g = len(members)
        k_end = members[-1][0] + block
        if k_end < n:
            Vfull = torch.cat([Vt for _, Vt, _ in members], dim=0)
            Qt[k_end:, kq:] = apply_live(Qt[k_end:, kq:], Vfull[:, kq:],
                                         prefix_Ts[-1], transpose_t=True)
        for j in range(g - 1, -1, -1):
            kj, Vt, Tt = members[j]
            top = e_top(kj, Vt, Tt, kq)
            if j > 0:
                Vpre = torch.cat([V for _, V, _ in members[:j]], dim=0)
                top = apply_live(top, Vpre[:, kq:], prefix_Ts[j - 1],
                                 transpose_t=True)
            Qt[kj:kj + block, kq:] = top

    R = torch.triu(M[:, :n].T)
    return Qt.T.contiguous(), R
