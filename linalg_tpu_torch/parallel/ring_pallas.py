"""Ring attention through the ring kernels K10/K11 — the counterpart of
``linalg_tpu/parallel/ring_pallas.py`` (``--ring pallas``), with its names.

On the TPU one Pallas kernel per device runs all n ring steps and moves
the K/V chunks with remote DMAs, issuing step s+1's transfer before it
computes step s and holding it back with credits until the neighbour's
slot is free. Here, on CUDA tensors, each direction is one call of the
kernels (``kernels.ring_attention``): the forward K10, the backward K11's
dq and dk/dv passes. Every block loops over the ring's steps in the
ring's order and reads the chunk a step needs where it lies, through a
table of per-rank chunk pointers: no chunk is copied between ranks and
no running state leaves the registers between steps. A build or launch
failure raises.

The kernels and their plain versions take every buffer as the list of
the n ranks' rows, which lie in one of three places:

- every mesh device is the tensors' device (devices may repeat, as the
  trainers' meshes do): views of the (B*h, T, D) head tensors, rank r's
  rows at [r Tl, (r + 1) Tl), and each direction is one launch;
- ranks on other devices of this process (``make_mesh(devices=[...])``
  over several cards): each rank's rows go to its device as a tensor of
  its own; each card launches once for the ranks it holds and reads the
  other cards' chunks in place (peer access, ordered by events), and the
  outputs come back to the input's device. A dp x sp mesh whose groups
  lie on different devices splits the batch over them;
- ranks in other processes (a mesh after ``init_distributed``;
  ``ring_attention_pallas_ranks``, whose per-rank lists hold this
  process's ranks only): each process copies its ranks' chunks into its
  ``RingArena``, a ``cudaMalloc`` arena whose CUDA IPC handle every peer
  opened once, and launches once a direction for its ranks, reading the
  other processes' chunks from their arenas, ordered by interprocess
  events and a host handshake a call; the call joins the tape of the
  crossing collectives, so every process runs its rings, forward and
  backward, in one order.

On CPU tensors, and with ``plain=True`` on the card, the kernels' plain
versions run the TPU's protocol step by step: the forward keeps two K/V
slots (each rank's (2, BH, Tl, d)) and rotates one hop per step
(``kernels.ring_attention.rotate``: rank r+1 receives rank r's chunk; a
rank in another process receives it by the group's point-to-point
message); the backward laps an f32 bundle (k, v, dk, dv), each rank's
(4, BH, Tl, d), each step running the dq and dk/dv passes and then
rotating the bundle, which after n rotations is home, in slot n % 2
(``ring_pallas.py:433``). Both ways fold chunk ``src = (r - s) mod n`` at
step s, with ``chunk_live`` skipping dead chunks, so they sum in the same
order wherever the ranks lie. Head widths from 8 up are zero-padded to
the kernels' next width with the scale of the true width; no
``torch.cuda.synchronize()`` is on the path.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.ring_attention import (_spans, padded_d, ring_arena,
                                      ring_bwd_cuda, ring_bwd_step_ref,
                                      ring_fwd_cuda, ring_fwd_step_ref,
                                      rotate)

__all__ = ["make_ring_attention_pallas", "ring_attention_pallas_local",
           "ring_attention_pallas_bwd_local", "ring_attention_pallas_ranks"]


def _same(dv, device) -> bool:
    dv = torch.device(dv)
    return dv.type == device.type and (
        dv.index is None or device.index is None or dv.index == device.index)


def _ring_size(mesh, axis: str, device):
    """(n, rings): n the ring's ranks along ``axis``. ``rings`` is None
    when every mesh device is ``device``, or when the mesh spans processes
    (the caller holds the global tensors here): the ranks share it, and
    their rows are views of the inputs. Otherwise it lists the ranks'
    devices of each ring: one list when every group along ``axis`` lies
    on the same devices (the whole batch rides it), else one per group in
    row-major order of the other axes, the batch split over them as the
    JAX ring splits it over ``batch_axis``."""
    n = mesh.shape[axis]
    if mesh.spans_processes or all(_same(dv, device)
                                   for dv in mesh.rank_devices):
        return n, None
    groups = [[torch.device(mesh.rank_devices[x]) for x in g]
              for g in mesh.groups(axis)]
    if all(g == groups[0] for g in groups):
        return n, groups[:1]
    return n, groups


def _heads(x, D):
    """(B, h, T, d) -> contiguous (B*h, T, D), zero-padded to width D."""
    B, h, T, d = x.shape
    if D != d:
        x = F.pad(x, (0, D - d))
    return x.reshape(B * h, T, D).contiguous()


def _ranks(x, n, devs=None):
    """Contiguous (BH, T, ...) -> the n ranks' (BH, Tl, ...) rows: views of
    ``x``, or with ``devs`` each rank's rows copied to its device as a
    contiguous tensor of its own."""
    rows = x.view(x.shape[0], n, x.shape[1] // n, *x.shape[2:]).unbind(1)
    if devs is None:
        return rows
    return [t.to(dv, copy=True, memory_format=torch.contiguous_format)
            for t, dv in zip(rows, devs)]


def _validate(q, n, causal, window, rings=None):
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
    if rings is not None:
        if q.shape[0] % len(rings):
            raise ValueError(f"batch {q.shape[0]} must divide over the "
                             f"{len(rings)} rings on distinct devices")
        types = {dv.type for g in rings for dv in g}
        if types != {q.device.type}:
            raise ValueError(f"ring ranks on {sorted(types)} for "
                             f"{q.device.type} tensors")


def _slopes_on(slopes, device):
    return (None if slopes is None else
            torch.tensor(slopes, dtype=torch.float32, device=device))


def _on_rings(fn, ins, outs, n, rings):
    """Run ``fn(in_ranks, out_ranks)`` on every ring: each (BH, T, ...)
    tensor of ``ins`` and ``outs`` as its ranks' rows, views of it where
    the ranks share its device (``rings`` None); else each ring takes its
    block of the batch to its ranks' devices, and the outputs come back
    into ``outs``."""
    if rings is None:
        fn([_ranks(x, n) for x in ins], [_ranks(x, n) for x in outs])
        return
    blocks = len(rings)
    for b, devs in enumerate(rings):
        bi = [x.chunk(blocks)[b] for x in ins]
        bo = [x.chunk(blocks)[b] for x in outs]
        got = [[torch.empty((x.shape[0], x.shape[1] // n) + x.shape[2:],
                            dtype=x.dtype, device=dv) for dv in devs]
               for x in bo]
        fn([_ranks(x, n, devs) for x in bi], got)
        for x, rows in zip(bo, got):
            for view, t in zip(_ranks(x, n), rows):
                view.copy_(t)


def _each(fn, xs):
    return [None if x is None else fn(x) for x in xs]


def _hop(procs, pg):
    """The plain ring's hop over a group whose ranks lie in several
    processes (``procs``: each position's process; ``pg`` their
    sub-group): a copy for a receiver whose sender is in this process, as
    ``rotate`` makes, the group's raw point-to-point messages (no
    autograd) for the others. Entries of other processes' ranks are
    None."""
    from .mesh import _p2p

    def hop(cur, nxt):
        n = len(cur)
        sends, recvs, into = [], [], []
        for j, x in enumerate(cur):
            d = (j + 1) % n
            if x is not None and nxt[d] is not None:
                nxt[d].copy_(x)
            elif x is not None:
                sends.append((x, procs[d], j))
            elif nxt[d] is not None:
                recvs.append(((tuple(nxt[d].shape), nxt[d].dtype), procs[j],
                              j, nxt[d].device))
                into.append(nxt[d])
        for t, got in zip(into, _p2p(pg, sends, recvs)):
            t.copy_(got)
    return hop


def _fwd(qs, ks, vs, os, Ls, kw, kernel, hop=rotate, arena=None):
    """K10, or its plain version through the TPU's two K/V slots, over the
    n ranks' rows (None for another process's rank, whose chunks come
    through ``arena``, or by ``hop`` in the plain version): into ``os``
    and ``Ls``."""
    if kernel:
        ring_fwd_cuda(qs, ks, vs, os, Ls, arena=arena, **kw)
        return
    n = len(qs)
    runs = _spans([j for j, q in enumerate(qs) if q is not None])
    f32 = dict(dtype=torch.float32)
    kv = [[None if k is None else torch.stack([k, v])
           for k, v in zip(ks, vs)],
          _each(lambda q: torch.empty((2,) + q.shape, dtype=q.dtype,
                                      device=q.device), qs)]
    m = _each(lambda q: torch.empty(q.shape[:2], **f32, device=q.device), qs)
    l = _each(torch.empty_like, m)
    acc = _each(lambda q: torch.empty(q.shape, **f32, device=q.device), qs)
    for s in range(n):
        cur = kv[s % 2]
        if s < n - 1:
            hop(cur, kv[(s + 1) % 2])
        for run in runs:
            ring_fwd_step_ref(qs, cur, m, l, acc, os, Ls, n=n, step=s,
                              ranks=run, last=s == n - 1, **kw)


def _bwd(qs, ks, vs, dos, Ls, dls, dqs, dks, dvs, kw, kernel, hop=rotate,
         arena=None):
    """K11, or its plain version through the TPU's f32 bundle lap, over
    the n ranks' rows (other processes' as for ``_fwd``): into ``dqs``,
    ``dks`` and ``dvs``."""
    if kernel:
        ring_bwd_cuda(qs, ks, vs, dos, Ls, dls, dqs, dks, dvs, arena=arena,
                      **kw)
        return
    n = len(qs)
    runs = _spans([j for j, q in enumerate(qs) if q is not None])

    def zeros(k):
        return torch.zeros(k.shape, dtype=torch.float32, device=k.device)

    bundle = [[None if k is None else
               torch.stack([k.float(), v.float(), zeros(k), zeros(k)])
               for k, v in zip(ks, vs)],
              _each(lambda q: torch.empty((4,) + q.shape,
                                          dtype=torch.float32,
                                          device=q.device), qs)]
    dq_acc = _each(lambda q: torch.empty(q.shape, dtype=torch.float32,
                                         device=q.device), qs)
    for s in range(n):
        cur, nxt = bundle[s % 2], bundle[(s + 1) % 2]
        for run in runs:
            ring_bwd_step_ref(qs, dos, Ls, dls, cur, dq_acc, dqs, n=n,
                              step=s, ranks=run, last=s == n - 1, **kw)
        if n > 1:  # every step, so the bundle finishes its lap at home
            hop(cur, nxt)
    for x, dk, dv in zip(bundle[n % 2 if n > 1 else 0], dks, dvs):
        if x is not None:
            dk.copy_(x[2])
            dv.copy_(x[3])


def ring_attention_pallas_local(q, k, v, *, mesh, axis: str = "sp",
                                causal: bool = True, with_lse: bool = False,
                                slopes=None, window=None,
                                plain: bool = False):
    """K10 over every rank: q, k, v (B, h, T, d), rank r's rows at [r Tl,
    (r + 1) Tl) -> o (B, h, T, d) in q's dtype and, with ``with_lse``, the
    float32 row logsumexp L (B, h, T). ``slopes`` (len h) adds the ALiBi
    bias, ``window`` (causal only) the band. ``plain`` runs the kernel's
    plain version on CUDA tensors too (the reference a card run holds the
    kernel against). Ranks on devices other than q's (``make_mesh(
    devices=[...])``) read their rows on their devices, and o and L come
    back to q's device."""
    n, rings = _ring_size(mesh, axis, q.device)
    _validate(q, n, causal, window, rings)
    B, h, T, d = q.shape
    D = padded_d(d)
    dev = q.device
    qf = _heads(q, D)
    kf, vf = _heads(k.to(q.dtype), D), _heads(v.to(q.dtype), D)
    kw = dict(H=h, causal=causal, window=window,
              slopes=_slopes_on(slopes, dev), scale=1.0 / math.sqrt(d))
    kernel = dev.type == "cuda" and not plain
    o = torch.empty_like(qf)
    L = torch.empty((B * h, T), dtype=torch.float32, device=dev)
    _on_rings(lambda i, out: _fwd(*i, *out, kw, kernel), [qf, kf, vf],
              [o, L], n, rings)
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
    both float32 (B, h, T). ``plain`` and the ranks' devices as for the
    forward."""
    n, rings = _ring_size(mesh, axis, q.device)
    _validate(q, n, causal, window, rings)
    B, h, T, d = q.shape
    D = padded_d(d)
    dev = q.device
    qf, dof = _heads(q, D), _heads(do.to(q.dtype), D)
    kf, vf = _heads(k.to(q.dtype), D), _heads(v.to(q.dtype), D)
    L = lse.reshape(B * h, T).float().contiguous()
    dl = delta.reshape(B * h, T).float().contiguous()
    kw = dict(H=h, causal=causal, window=window,
              slopes=_slopes_on(slopes, dev), scale=1.0 / math.sqrt(d))
    kernel = dev.type == "cuda" and not plain
    grads = [torch.empty_like(qf) for _ in range(3)]
    _on_rings(lambda i, out: _bwd(*i, *out, kw, kernel),
              [qf, kf, vf, dof, L, dl], grads, n, rings)
    return tuple(x.view(B, h, T, D)[..., :d] for x in grads)


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
    accepted for the JAX signature (attention is pointwise over the batch:
    the ranks of a dp x sp mesh on one device run in one launch, and groups
    on different devices take the batch's blocks in group order).
    ``slopes`` (len h) adds the ALiBi bias; ``window`` (causal only) the
    sliding-window band, whose far-past chunks skip their compute.

    Over a mesh whose ranks lie in several processes it does what
    ``make_ring_attention`` does there: the process holds the global
    tensors and runs the whole ring over them on q's device, every rank's
    rows a view of them, with no communication.
    ``ring_attention_pallas_ranks`` is the ring across the processes."""
    del batch_axis
    window, slopes = _options(causal, window, slopes)

    def attn(q, k, v):
        return _RingAttention.apply(q, k, v, mesh, axis, causal, slopes,
                                    window)

    return attn


def _options(causal, window, slopes):
    """(window, slopes) checked and made hashable."""
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        window = int(window)
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    if slopes is not None:
        slopes = tuple(float(s) for s in slopes)
    return window, slopes


def _group_link(mesh, group, kernel, device):
    """How a ring over ``group`` reaches its ranks in other processes:
    {"arena": its ``RingArena``} for the kernels, {"hop": the plain
    version's hop}; {} when every rank is in this process."""
    if all(mesh.is_local(r) for r in group):
        return {}
    from .mesh import _Span

    sp = _Span(mesh, group)
    procs = sorted({mesh.rank_process[r] for r in group})
    if kernel:
        return {"arena": ring_arena(procs, sp.members, sp.me, device.index,
                                    sp.pg)}
    return {"hop": _hop([mesh.rank_process[r] for r in group], sp.pg)}


def ring_attention_pallas_ranks(qs, ks, vs, mesh, axis: str = "sp", *,
                                causal: bool = True, slopes=None,
                                window=None, plain: bool = False):
    """K10/K11 over per-rank chunks, the kernel twin of ``parallel.ring
    .ring_attention_ranks``: ``qs``, ``ks``, ``vs`` per-rank lists of (B,
    h, Tl, d) (None for the ranks of other processes), the rank at index
    j of its ``axis`` group holding positions [j Tl, (j + 1) Tl). Returns
    the per-rank (B, h, Tl, d) outputs in q's dtype; the backward forms
    delta = rowsum(dO * O) in float32 and runs K11.

    One call covers all of this process's ranks: each ``axis`` group that
    holds one of them is a ring, launched once a direction for each run of
    its ranks here. A group inside this process reads its ranks' own
    tensors; a group across processes reads the others' chunks through
    its ``RingArena`` (CUDA IPC). Across processes the call, forward and
    backward, joins the tape of the crossing collectives
    (``parallel.mesh.taped``), so every process runs its rings in one
    order; under autograd outside a tape it raises. On CPU tensors, and
    with ``plain``, the kernels' plain versions run, a chunk of another
    process's rank crossing by the group's point-to-point messages, and
    the sums are the one-process ring's."""
    from . import mesh as mesh_mod

    window, slopes = _options(causal, window, slopes)
    groups = [g for g in mesh.groups(axis)
              if any(mesh.is_local(r) for r in g)]
    mine = [r for g in groups for r in g if mesh.is_local(r)]
    if not mine:
        return [None] * mesh.size
    q0 = qs[mine[0]]
    B, h, Tl, d = q0.shape
    if d < 8:
        raise ValueError(f"ring attention takes d_head >= 8, got {d}")
    if q0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ring attention: no kernel and no plain version "
                         f"for device {q0.device}")
    if any(qs[r].shape != q0.shape for r in mine):
        raise ValueError("ring attention: every rank's q must be "
                         f"{tuple(q0.shape)}")
    D, m = padded_d(d), len(mine)
    kernel = q0.device.type == "cuda" and not plain
    at = {r: i for i, r in enumerate(mine)}
    links = [_group_link(mesh, g, kernel, q0.device) for g in groups]
    cfgs = [dict(H=h, causal=causal, window=window, scale=1.0 / math.sqrt(d),
                 slopes=_slopes_on(slopes, qs[next(r for r in g if r in at)]
                                   .device)) for g in groups]
    saved = {}

    def padded(g, xs, like):
        """Group g's rows of this process's (B, h, Tl, d) ``xs`` as
        contiguous (BH, Tl, D) in ``like``'s dtypes; None for the ranks
        of other processes."""
        return [_heads(xs[at[r]].to(like[at[r]].dtype), D) if r in at
                else None for r in g]

    def unpad(t):
        return t.view(B, h, Tl, D)[..., :d]

    def fwd(xs):
        q, k, v = xs[:m], xs[m:2 * m], xs[2 * m:]
        o, L = [None] * m, [None] * m
        for g, link, cfg in zip(groups, links, cfgs):
            qf, kf, vf = (padded(g, x, q) for x in (q, k, v))
            of = _each(torch.empty_like, qf)
            Lf = _each(lambda t: t.new_empty(t.shape[:2],
                                             dtype=torch.float32), qf)
            _fwd(qf, kf, vf, of, Lf, cfg, kernel, **link)
            for r, o_, L_ in zip(g, of, Lf):
                if r in at:
                    o[at[r]], L[at[r]] = unpad(o_), L_
        saved.update(q=q, k=k, v=v, o=o, L=L)
        return o

    def bwd(gs):
        q, k, v, o, L = (saved[x] for x in "qkvoL")
        dq, dk, dv = [None] * m, [None] * m, [None] * m
        for g, link, cfg in zip(groups, links, cfgs):
            qf, kf, vf, dof = (padded(g, x, q) for x in (q, k, v, gs))
            Lf = [L[at[r]] if r in at else None for r in g]
            dl = [torch.sum(gs[at[r]].float() * o[at[r]].float(), dim=-1)
                  .reshape(B * h, Tl).contiguous() if r in at else None
                  for r in g]
            grads = [_each(torch.empty_like, qf) for _ in range(3)]
            _bwd(qf, kf, vf, dof, Lf, dl, *grads, cfg, kernel, **link)
            for j, r in enumerate(g):
                if r in at:
                    i = at[r]
                    dq[i] = unpad(grads[0][j])
                    dk[i] = unpad(grads[1][j]).to(k[i].dtype)
                    dv[i] = unpad(grads[2][j]).to(v[i].dtype)
        return dq + dk + dv

    crossing = any(links)
    apply = mesh_mod._apply_x if crossing else mesh_mod._apply
    outs = apply(fwd, bwd, [qs[r] for r in mine] + [ks[r] for r in mine]
                 + [vs[r] for r in mine])
    res = [None] * mesh.size
    for r, o in zip(mine, outs):
        res[r] = o
    return res
