"""Device meshes and the collectives over them — the counterpart of
``linalg_tpu/parallel/mesh.py``.

A ``Mesh`` names its axes and holds a numpy array of ``torch.device``s of
the mesh's shape, and the process each rank lives in. A device may appear
more than once: the ranks of a mesh then share it, which is how the
sharded trainers run several ranks on one card. ``make_mesh`` without a
device list deals the ranks over the job's devices
(``distributed.job_devices``), row-major, each device an equal contiguous
block of them: after ``init_distributed`` a mesh spans every process of
the group, as a JAX mesh over ``jax.devices()`` spans every host, and
each process holds a contiguous block of ranks (``local_ranks``); a
device of another process is None here.

Where the JAX package hands communication to GSPMD and ``shard_map``, the
port makes it explicit. A rank's shard is a tensor on that rank's mesh
device, and a sharded value is a list of them, one per rank in the mesh's
row-major order; in each process the entries of the other processes'
ranks are None. The collectives below take such a list and the mesh
axis (or axes) to communicate over; ranks that differ only along those
axes form a group:

- ``all_reduce`` (sum or mean), ``all_gather``, ``reduce_scatter``,
  ``all_to_all`` and ``ppermute``, as ``lax.psum``, ``all_gather``,
  ``psum_scatter``, ``all_to_all`` and ``ppermute`` are in JAX.
- Inside one process they move data with ``.to(device)``; ranks that
  share a device share the result (one sum, one concatenation), so no
  copy is made beyond what the result needs.
- A group whose ranks lie in several processes combines its local members
  as above, exchanges with the other processes through the
  ``torch.distributed`` sub-group of those processes (``dist.all_reduce``,
  ``all_gather_single``, ``reduce_scatter_single``, ``all_to_all_single``,
  ``batch_isend_irecv``) and hands the result to its local ranks. NCCL
  carries card tensors where they lie; Gloo takes host tensors, so a card
  tensor under Gloo is staged through the host in one place (``_wire``),
  counted in ``collectives["host_staged"]`` (tensors) and
  ``["host_staged_bytes"]``.
- Autograd goes through them: each one's backward is its adjoint
  collective (an all-reduce's is an all-reduce, an all-gather's a
  reduce-scatter, a permutation's the inverse permutation). Across
  processes the backward collectives must run in the same order in every
  process: under ``taped()`` each crossing collective threads a token, so
  the backward runs them in the reverse of the forward's order, and a
  process whose loss does not reach its own ranks' values still joins
  them (``_loss_and_grads`` in ``parallel.sharding`` opens the tape).
- ``collectives`` counts the calls by kind, backward calls included,
  once a group in each process that holds a member. A group of one rank
  makes no call and counts none, as a psum over an axis of size 1 moves
  nothing.

Sharding rules are specs: one entry per tensor dimension, each None or
the one mesh axis that dimension is split over, as a ``PartitionSpec``'s
entries; ``()`` is replicated. ``shard_tree``/``unshard_tree`` move a
parameter tree between its whole arrays and the per-rank shards (each
rank holds its own copy of a replicated leaf; a process holds its own
ranks' shards).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .distributed import _world, job_devices, local_devices, subgroup

__all__ = ["Mesh", "make_mesh", "pick_dp_tp", "collectives", "all_reduce",
           "all_gather", "reduce_scatter", "all_to_all", "ppermute",
           "shard_tree", "unshard_tree", "spec_axes", "taped"]

# calls by kind: "all_reduce", "all_gather", "reduce_scatter",
# "all_to_all", "ppermute"; "host_staged" / "host_staged_bytes": card
# tensors staged through the host for a Gloo group
collectives: collections.Counter = collections.Counter()


class Mesh:
    """Axis names and a device array: ``shape`` maps each name to its size,
    in order, as ``jax.sharding.Mesh.shape`` does. ``size`` is the number
    of ranks, ``coords[r]`` rank r's {axis: index}, ``rank_devices[r]``
    its device (ranks in row-major order), ``rank_process[r]`` the process
    that holds it (this process for every rank unless given), and
    ``local_ranks`` this process's ranks. A mesh over several processes
    makes the sub-group of every process set its groups span, in every
    process, when it is built (``distributed.subgroup``)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 rank_process: Optional[Sequence[int]] = None):
        if devices.ndim != len(axis_names):
            raise ValueError(f"device array of rank {devices.ndim} for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.size = int(devices.size)
        self.rank_devices = list(devices.reshape(-1))
        self.coords = [dict(zip(self.axis_names, ix)) for ix in
                       itertools.product(*(range(n) for n in devices.shape))]
        self.process = _world()[0]
        self.rank_process = (list(rank_process) if rank_process is not None
                             else [self.process] * self.size)
        self.local_ranks = [r for r, p in enumerate(self.rank_process)
                            if p == self.process]
        self.processes = sorted(set(self.rank_process))
        if len(self.processes) > 1:
            for n in range(1, len(self.axis_names) + 1):
                for axes in itertools.combinations(self.axis_names, n):
                    for group in self.groups(axes):
                        procs = sorted({self.rank_process[r] for r in group})
                        if len(procs) > 1:
                            subgroup(procs)

    def is_local(self, r: int) -> bool:
        return self.rank_process[r] == self.process

    @property
    def spans_processes(self) -> bool:
        return len(self.processes) > 1

    def groups(self, axes) -> list:
        """Lists of ranks that differ only along ``axes`` (a name or a
        tuple of names), each in row-major order."""
        axes = _axes(axes)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"mesh has no axis {a!r} "
                                 f"({self.axis_names})")
        out = {}
        for r, c in enumerate(self.coords):
            key = tuple(c[a] for a in self.axis_names if a not in axes)
            out.setdefault(key, []).append(r)
        return list(out.values())


def _axes(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def pick_dp_tp(n_devices: int, n_heads: int) -> Tuple[int, int]:
    """Choose (dp, tp): the largest tp that divides both n_devices and
    n_heads, remainder to data parallelism."""
    tp = 1
    for cand in range(1, n_devices + 1):
        if n_devices % cand == 0 and n_heads % cand == 0:
            tp = cand
    return n_devices // tp, tp


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("dp", "tp"),
              devices=None, *, device_type: str = "cuda",
              local: bool = False) -> Mesh:
    """Build a Mesh over ``devices``, the first ``prod(shape)`` of them in
    row-major order, every rank in this process. Devices may repeat
    (``[torch.device("cuda")] * 4`` puts four ranks on one card); fewer
    devices than the shape needs raise.

    Without ``devices`` the mesh is dealt over the job's devices of
    ``device_type`` (``distributed.job_devices``: every process's cards in
    process order, or one CPU device a process with ``"cpu"``; without a
    card, raise): rank r on job device r where the job has as many, else
    each device an equal contiguous block of the ranks (a count that does
    not divide raises), so a process holds a contiguous block and a tp
    group stays in one process where the sizes allow it. ``local=True``
    deals over this process's devices only (``distributed.local_devices``),
    as tensor-parallel serving places its ranks.

    ``shape`` defaults to all devices on the first axis."""
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if shape is None:
            shape = (len(devices),) + (1,) * (len(axis_names) - 1)
        n = int(np.prod(shape))
        if n > len(devices):
            raise ValueError(f"mesh shape {tuple(shape)} needs {n} devices, "
                             f"have {len(devices)}")
        procs = None
        devices = devices[:n]
    else:
        job = ([(_world()[0], d) for d in local_devices(device_type)]
               if local else job_devices(device_type))
        if shape is None:
            shape = (len(job),) + (1,) * (len(axis_names) - 1)
        n = int(np.prod(shape))
        if n % len(job) and n > len(job):
            raise ValueError(f"mesh shape {tuple(shape)}: {n} ranks do not "
                             f"deal evenly over the job's {len(job)} "
                             f"devices")
        per = max(1, n // len(job))
        dealt = [job[r // per] for r in range(n)]
        procs = [p for p, _ in dealt]
        devices = [d for _, d in dealt]
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(tuple(shape)), axis_names, procs)


# -- the collectives ---------------------------------------------------------
#
# Each ``_raw_*`` works on one group (a list of tensors, one per rank) with
# no autograd and counts itself; ``_Collective`` runs a raw collective
# forward and its adjoint backward. Each ``_x_*`` works on this process's
# members of a group that spans processes (``_Span``), through the
# group's ``torch.distributed`` sub-group; ``_Crossed`` runs one forward
# and its adjoint backward on the tape's token chain.


def _shared(outs):
    """The group's outputs with a tensor returned to several ranks (ranks
    on one device) given to each as a view: one result, no copy, and
    autograd keeps each rank's gradient apart."""
    seen = set()
    res = []
    for o in outs:
        res.append(o.view_as(o) if id(o) in seen else o)
        seen.add(id(o))
    return res


def _on_each(value, like):
    """``value`` moved to each device of ``like``'s ranks (shared where
    ranks share a device)."""
    by_dev = {}
    for x in like:
        by_dev.setdefault(x.device, value.to(x.device))
    return [by_dev[x.device] for x in like]


def _sum(xs, op):
    """The group's sum (``op="mean"``: mean) in rank order on its first
    device."""
    dev = xs[0].device
    total = xs[0]
    for x in xs[1:]:
        total = total + x.to(dev)
    return total / len(xs) if op == "mean" else total


def _raw_all_reduce(xs, op):
    collectives["all_reduce"] += 1
    return _on_each(_sum(xs, op), xs)


def _raw_all_gather(xs, dim):
    collectives["all_gather"] += 1
    dev = xs[0].device
    return _on_each(torch.cat([x.to(dev) for x in xs], dim=dim), xs)


def _raw_reduce_scatter(xs, dim, op):
    collectives["reduce_scatter"] += 1
    parts = _sum(xs, op).chunk(len(xs), dim=dim)
    return [p.to(x.device) for p, x in zip(parts, xs)]


def _raw_all_to_all(xs, split_dim, concat_dim):
    collectives["all_to_all"] += 1
    n = len(xs)
    pieces = [x.chunk(n, dim=split_dim) for x in xs]
    return [torch.cat([pieces[j][i].to(xs[i].device) for j in range(n)],
                      dim=concat_dim) for i in range(n)]


class _Collective(torch.autograd.Function):
    """One group's collective: ``fwd(xs) -> outs`` forward, ``bwd(gs) ->
    input grads`` backward, both lists over the group's ranks."""

    @staticmethod
    def forward(ctx, fwd, bwd, *xs):
        ctx.bwd = bwd
        return tuple(_shared(fwd(list(xs))))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *ctx.bwd(list(gs)))


def _apply(fwd, bwd, ins):
    """``fwd(ins)``, through ``_Collective`` (backward ``bwd``) when an
    input needs a gradient."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in ins):
        return _Collective.apply(fwd, bwd, *ins)
    return fwd(ins)


# -- across processes --------------------------------------------------------


class _Tape:
    """The token chain of one loss's crossing collectives: ``root`` a leaf,
    ``token`` the last crossing collective's token output."""

    def __init__(self):
        self.root = torch.zeros((), requires_grad=True)
        self.token = self.root

    def tie(self, loss):
        """``loss`` joined to the chain (a zero added), so a backward from
        it, with ``root`` among its inputs, runs every crossing collective
        of the forward, in the reverse of their order, in every process."""
        if self.token is self.root:
            return loss
        return loss + (self.token * 0).to(loss.device, loss.dtype)


# the open tape: a process-wide context, as autograd's grad mode is, since
# the collectives are called deep inside the models' code (``taped``)
_tape: Optional[_Tape] = None


@contextlib.contextmanager
def taped():
    """A tape for the crossing collectives of the forward run inside it
    (see the module docstring); yields the ``_Tape``."""
    global _tape
    prev, _tape = _tape, _Tape()
    try:
        yield _tape
    finally:
        _tape = prev


class _Crossed(torch.autograd.Function):
    """A crossing collective on this process's members: ``fwd(xs) ->
    outs`` forward, ``bwd(gs) -> input grads`` backward, with the tape's
    token in and a new token out, so the backward collectives keep the
    forward's order."""

    @staticmethod
    def forward(ctx, fwd, bwd, token, *xs):
        ctx.bwd = bwd
        return (*_shared(fwd(list(xs))), token.new_zeros(()))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, gs[-1], *ctx.bwd(list(gs[:-1])))


def _apply_x(fwd, bwd, ins):
    """``fwd(ins)``: on the tape when one is open under autograd; a
    crossing collective whose inputs need a gradient outside a tape
    raises, since its backward could not keep the other processes'
    order."""
    if torch.is_grad_enabled():
        if _tape is not None:
            *outs, _tape.token = _Crossed.apply(fwd, bwd, _tape.token, *ins)
            return outs
        if any(x.requires_grad for x in ins):
            raise RuntimeError("a collective across processes under "
                               "autograd runs inside parallel.mesh.taped() "
                               "(as parallel.sharding._loss_and_grads "
                               "opens it)")
    return fwd(ins)


class _Span:
    """A group whose ranks lie in several processes, from this process:
    ``members[i]`` the group positions of the i-th process's ranks (the
    processes in rank order), ``me`` this process's index there, ``k``
    the most members a process holds, ``pg`` their sub-group."""

    def __init__(self, mesh, group):
        procs = sorted({mesh.rank_process[r] for r in group})
        self.n = len(group)
        self.members = [[i for i, r in enumerate(group)
                         if mesh.rank_process[r] == p] for p in procs]
        self.me = procs.index(mesh.process)
        self.k = max(len(m) for m in self.members)
        self.pg = subgroup(procs)


def _wire(t, pg):
    """A fresh contiguous copy of ``t`` as ``pg``'s backend carries it:
    NCCL takes card tensors where they lie; Gloo takes host tensors, so a
    card tensor is staged through the host here, and counted."""
    t = t.detach()
    if t.device.type != "cpu" and dist.get_backend(pg) == "gloo":
        collectives["host_staged"] += 1
        collectives["host_staged_bytes"] += t.numel() * t.element_size()
        return t.contiguous().to("cpu")
    return t.clone(memory_format=torch.contiguous_format)


def _unwire(w, device):
    """A received tensor back on ``device`` (counted when staged)."""
    if w.device.type == "cpu" and torch.device(device).type != "cpu":
        collectives["host_staged"] += 1
        collectives["host_staged_bytes"] += w.numel() * w.element_size()
    return w.to(device)


def _op(name):
    """The collective under the name both torch versions know: the
    ``*_single`` names where they exist (newer), else the older ones."""
    new, old = {"all_gather": ("all_gather_single", "all_gather_into_tensor"),
                "reduce_scatter": ("reduce_scatter_single",
                                   "reduce_scatter_tensor")}[name]
    return getattr(dist, new, None) or getattr(dist, old)


def _x_members(sp, xs):
    """Every member's value of the group, in group order, on ``xs[0]``'s
    device: each process's members stacked (zero-padded to ``k``) and
    gathered. The members' values have one shape."""
    dev = xs[0].device
    stack = torch.stack([x.to(dev) for x in xs])
    if len(xs) < sp.k:
        stack = torch.cat([stack, stack.new_zeros((sp.k - len(xs),
                                                   *stack.shape[1:]))])
    w = _wire(stack, sp.pg)
    out = w.new_empty((len(sp.members) * sp.k, *w.shape[1:]))
    _op("all_gather")(out, w, group=sp.pg)
    out = _unwire(out, dev)
    vals = [None] * sp.n
    for p, mem in enumerate(sp.members):
        for j, i in enumerate(mem):
            vals[i] = out[p * sp.k + j]
    return vals


def _x_all_reduce(sp, xs, op):
    collectives["all_reduce"] += 1
    w = _wire(_sum(xs, "sum"), sp.pg)
    dist.all_reduce(w, group=sp.pg)
    total = _unwire(w, xs[0].device)
    return _on_each(total / sp.n if op == "mean" else total, xs)


def _x_all_gather(sp, xs, dim):
    collectives["all_gather"] += 1
    return _on_each(torch.cat(_x_members(sp, xs), dim=dim), xs)


def _x_reduce_scatter(sp, xs, dim, op):
    """Block i of the group's sum to member i: each process's blocks laid
    out in turn (zero-padded to ``k``), reduced and scattered."""
    collectives["reduce_scatter"] += 1
    chunks = _sum(xs, "sum").chunk(sp.n, dim=dim)
    shape, numel = chunks[0].shape, chunks[0].numel()
    flat = []
    for mem in sp.members:
        flat += [chunks[i].reshape(-1) for i in mem]
        flat += [chunks[0].new_zeros(numel)] * (sp.k - len(mem))
    w = _wire(torch.cat(flat), sp.pg)
    out = w.new_empty(sp.k * numel)
    _op("reduce_scatter")(out, w, group=sp.pg)
    out = _unwire(out, xs[0].device)
    if op == "mean":
        out = out / sp.n
    return [out[j * numel:(j + 1) * numel].view(shape).to(x.device)
            for j, x in enumerate(xs)]


def _x_all_to_all(sp, xs, split_dim, concat_dim):
    """Member i gets block i of every member's value: each process sends
    every other process the blocks of its members for theirs."""
    collectives["all_to_all"] += 1
    pieces = [x.chunk(sp.n, dim=split_dim) for x in xs]
    shape, numel = pieces[0][0].shape, pieces[0][0].numel()
    mine = sp.members[sp.me]
    send = [pieces[a][i].reshape(-1) for mem in sp.members for i in mem
            for a in range(len(xs))]
    send_n = [len(mem) * len(xs) * numel for mem in sp.members]
    recv_n = [len(xs) * len(mem) * numel for mem in sp.members]
    w = _wire(torch.cat(send), sp.pg)
    out = w.new_empty(sum(recv_n))
    dist.all_to_all_single(out, w, recv_n, send_n, group=sp.pg)
    out = _unwire(out, xs[0].device)
    blocks = {}  # (destination position, source position) -> block
    at = 0
    for mem in sp.members:
        for i in mine:
            for j in mem:
                blocks[i, j] = out[at:at + numel].view(shape)
                at += numel
    return [torch.cat([blocks[i, j] for j in range(sp.n)],
                      dim=concat_dim).to(x.device)
            for i, x in zip(mine, xs)]


_DTYPES = (torch.float32, torch.float64, torch.bfloat16, torch.float16,
           torch.int64, torch.int32, torch.int8, torch.uint8, torch.bool)
_META = 10  # ndim (-1: None), up to 8 sizes, dtype code


def _p2p(pg, sends, recvs):
    """One batch of point-to-point messages on ``pg``: ``sends`` (tensor,
    peer process, tag), ``recvs`` ((shape, dtype), peer, tag, device);
    returns the received tensors on their devices."""
    ops, bufs = [], []
    for t, peer, tag in sends:
        ops.append(dist.P2POp(dist.isend, _wire(t, pg), peer, pg, tag))
    for (shape, dtype), peer, tag, dev in recvs:
        wdev = ("cpu" if dist.get_backend(pg) == "gloo" else
                torch.device(dev))
        bufs.append((torch.empty(shape, dtype=dtype, device=wdev), dev))
        ops.append(dist.P2POp(dist.irecv, bufs[-1][0], peer, pg, tag))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [_unwire(b, dev) for b, dev in bufs]


def _meta(t):
    m = torch.full((_META,), -1, dtype=torch.int64)
    if t is not None:
        if t.dim() > _META - 2:
            raise ValueError(f"ppermute across processes takes at most "
                             f"{_META - 2} dims, got {t.dim()}")
        m[0] = t.dim()
        m[1:1 + t.dim()] = torch.tensor(t.shape)
        m[-1] = _DTYPES.index(t.dtype)
    return m


def _x_ppermute(xs, mesh, group, pairs):
    """``ppermute`` of one group that spans processes: (destination rank,
    value) for this process's destinations that receive a value. The
    sources first tell their destinations the shape and dtype (or None)
    of what follows."""
    sp = _Span(mesh, group)
    proc, loc = mesh.rank_process, mesh.is_local
    tags = {pr: 2 * i for i, pr in enumerate(pairs)}
    sends = [pr for pr in pairs if loc(pr[0]) and not loc(pr[1])]
    recvs = [pr for pr in pairs if loc(pr[1]) and not loc(pr[0])]
    meta_dev = torch.device("cpu")
    if dist.get_backend(sp.pg) != "gloo":
        meta_dev = torch.device("cuda", torch.cuda.current_device())
    got = _p2p(sp.pg, [(_meta(xs[s]).to(meta_dev), proc[d], tags[s, d])
                       for s, d in sends],
               [(((_META,), torch.int64), proc[s], tags[s, d], meta_dev)
                for s, d in recvs])
    live_in = [(s, d) for s, d in sends if xs[s] is not None]
    live_out = []
    for (s, d), m in zip(recvs, got):
        m = m.cpu().tolist()
        if m[0] >= 0:
            live_out.append((s, d, (tuple(m[1:1 + m[0]]), _DTYPES[m[-1]])))
    inner = [(s, d) for s, d in pairs
             if loc(s) and loc(d) and xs[s] is not None]
    ins = [xs[s] for s, _ in live_in] + [xs[s] for s, _ in inner]
    if not ins and not live_out:
        return []
    n_in = len(live_in)

    def fwd(v):
        collectives["ppermute"] += 1
        recv = _p2p(sp.pg, [(t, proc[d], tags[s, d] + 1)
                            for t, (s, d) in zip(v, live_in)],
                    [(meta, proc[s], tags[s, d] + 1, mesh.rank_devices[d])
                     for s, d, meta in live_out])
        return recv + [t.to(mesh.rank_devices[d])
                       for t, (_, d) in zip(v[n_in:], inner)]

    def bwd(g):
        collectives["ppermute"] += 1
        back = _p2p(sp.pg, [(t, proc[s], tags[s, d] + 1)
                            for t, (s, d, _) in zip(g, live_out)],
                    [((x.shape, x.dtype), proc[d], tags[s, d] + 1, x.device)
                     for x, (s, d) in zip(ins, live_in)])
        return back + [t.to(x.device) for t, x in
                       zip(g[len(live_out):], ins[n_in:])]

    dsts = [d for _, d, _ in live_out] + [d for _, d in inner]
    return list(zip(dsts, _apply_x(fwd, bwd, ins)))


# -- the collectives over a mesh ---------------------------------------------


def _run(xs, mesh, axes, fwd, bwd, xfwd, xbwd):
    """Apply a group collective to every group of ``mesh`` along ``axes``
    that holds a rank of this process: ``fwd``/``bwd`` on the group's
    values where they are all here, ``xfwd``/``xbwd`` (with the group's
    ``_Span``) on this process's members where the group spans
    processes; a group of one rank passes through."""
    if len(xs) != mesh.size:
        raise ValueError(f"{len(xs)} values for a mesh of {mesh.size} ranks")
    out = list(xs)
    for group in mesh.groups(axes):
        mine = [r for r in group if mesh.is_local(r)]
        if len(group) == 1 or not mine:
            continue
        if len(mine) == len(group):
            res = _apply(fwd, bwd, [xs[r] for r in group])
        else:
            sp = _Span(mesh, group)
            res = _apply_x(lambda v, sp=sp: xfwd(sp, v),
                           lambda g, sp=sp: xbwd(sp, g),
                           [xs[r] for r in mine])
        for r, v in zip(mine, res):
            out[r] = v
    return out


def all_reduce(xs, mesh: Mesh, axes, op: str = "sum"):
    """Every rank gets the sum (``op="mean"``: the mean) of its group's
    values along ``axes``; in one process the sum is formed in rank order
    on the group's first device, so every rank of a group holds the same
    bits; across processes each process's partial sum, so formed, is
    all-reduced."""
    if op not in ("sum", "mean"):
        raise ValueError(f"all_reduce op must be sum or mean, got {op!r}")
    f = lambda v: _raw_all_reduce(v, op)
    xf = lambda sp, v: _x_all_reduce(sp, v, op)
    return _run(xs, mesh, axes, f, f, xf, xf)


def all_gather(xs, mesh: Mesh, axes, dim: int):
    """Every rank gets its group's values concatenated along ``dim`` in
    rank order. Backward: a reduce-scatter (sum) of the gradients."""
    return _run(xs, mesh, axes, lambda v: _raw_all_gather(v, dim),
                lambda g: _raw_reduce_scatter(g, dim, "sum"),
                lambda sp, v: _x_all_gather(sp, v, dim),
                lambda sp, g: _x_reduce_scatter(sp, g, dim, "sum"))


def reduce_scatter(xs, mesh: Mesh, axes, dim: int, op: str = "sum"):
    """Rank i of a group gets block i (along ``dim``) of the group's sum
    (``op="mean"``: mean). Backward: an all-gather."""
    if op not in ("sum", "mean"):
        raise ValueError(f"reduce_scatter op must be sum or mean, got {op!r}")

    def bwd(gs):
        out = _raw_all_gather(gs, dim)
        return [g / len(gs) for g in out] if op == "mean" else out

    def xbwd(sp, gs):
        out = _x_all_gather(sp, gs, dim)
        return [g / sp.n for g in out] if op == "mean" else out

    return _run(xs, mesh, axes, lambda v: _raw_reduce_scatter(v, dim, op),
                bwd, lambda sp, v: _x_reduce_scatter(sp, v, dim, op), xbwd)


def all_to_all(xs, mesh: Mesh, axes, split_dim: int, concat_dim: int):
    """Rank i of a group gets block i (along ``split_dim``) of every rank's
    value, concatenated along ``concat_dim`` in rank order. Backward: the
    all-to-all with the two dims exchanged."""
    return _run(xs, mesh, axes,
                lambda v: _raw_all_to_all(v, split_dim, concat_dim),
                lambda g: _raw_all_to_all(g, concat_dim, split_dim),
                lambda sp, v: _x_all_to_all(sp, v, split_dim, concat_dim),
                lambda sp, g: _x_all_to_all(sp, g, concat_dim, split_dim))


def ppermute(xs, mesh: Mesh, axis: str, perm):
    """Along ``axis``, the rank at index dst of its group gets the value of
    the rank at index src for each (src, dst) of ``perm``; a rank with no
    source, or whose source holds None, gets None (JAX's ppermute gives
    zeros: the callers here skip the ticks that would read them).
    Backward: each gradient goes back to its source. Across processes a
    source tells its destination what it holds before it sends it."""
    if len(xs) != mesh.size:
        raise ValueError(f"{len(xs)} values for a mesh of {mesh.size} ranks")
    out = [None] * len(xs)
    for group in mesh.groups(axis):
        here = [mesh.is_local(r) for r in group]
        if not any(here):
            continue
        if not all(here):
            for d, v in _x_ppermute(xs, mesh, group,
                                    [(group[s], group[d]) for s, d in perm]):
                out[d] = v
            continue
        pairs = [(group[s], group[d]) for s, d in perm
                 if xs[group[s]] is not None]
        if not pairs:
            continue
        srcs = [xs[s] for s, _ in pairs]
        devs = [mesh.rank_devices[d] for _, d in pairs]

        def fwd(v, devs=devs):
            collectives["ppermute"] += 1
            return [t.to(d) for t, d in zip(v, devs)]

        def bwd(g, srcs=srcs):
            collectives["ppermute"] += 1
            return [t.to(x.device) for t, x in zip(g, srcs)]

        for (_, d), v in zip(pairs, _apply(fwd, bwd, srcs)):
            out[d] = v
    return out


# -- sharding a parameter tree ----------------------------------------------


def spec_axes(spec) -> Tuple[str, ...]:
    """The mesh axes a spec splits over, in dimension order."""
    return tuple(a for a in spec if a is not None)


def _shard(x, spec, mesh: Mesh, coord):
    for dim, a in enumerate(spec):
        if a is None:
            continue
        n = mesh.shape[a]
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                             f"divide by the {a!r} axis ({n})")
        step = x.shape[dim] // n
        x = x.narrow(dim, coord[a] * step, step)
    return x


def shard_tree(tree, specs, mesh: Mesh):
    """The per-rank shards of a tree of whole tensors: rank r's leaf is its
    block of the leaf under the spec, a contiguous tensor of its own on
    rank r's device (replicated leaves are copied to every rank). Only
    this process's ranks get theirs; the others' entries are None."""
    def per_rank(r):
        def go(t, s):
            if isinstance(t, dict):
                missing = set(t) - set(s)
                if missing:
                    raise ValueError(f"no sharding spec for {sorted(missing)}")
                return {k: go(v, s[k]) for k, v in t.items()}
            x = _shard(t.detach(), s, mesh, mesh.coords[r])
            return x.to(mesh.rank_devices[r], copy=True).contiguous()
        return go(tree, specs)
    return [per_rank(r) if mesh.is_local(r) else None
            for r in range(mesh.size)]


def unshard_tree(rank_trees, specs, mesh: Mesh):
    """The whole tensors of per-rank shards, on this process's first rank's
    device: each leaf's blocks concatenated back along its split
    dimensions (a replicated leaf is that rank's copy). Over a mesh that
    spans processes every process calls it: the split leaves' shards are
    gathered from all ranks first."""
    first = mesh.local_ranks[0]
    dev = mesh.rank_devices[first]

    def go(ts, s):
        if isinstance(ts[first], dict):
            return {k: go([None if t is None else t[k] for t in ts], s[k])
                    for k in ts[first]}
        dims = [(d, a) for d, a in enumerate(s) if a is not None]
        if not dims:
            return ts[first].detach().to(dev)
        if any(t is None for t in ts):
            ts = _all_ranks(ts, mesh)
        by_coord = {tuple(c[a] for a in mesh.axis_names): t.detach()
                    for c, t in zip(mesh.coords, ts)}

        def build(fixed, dims):
            # concatenate along the first split dim, the rest within
            if not dims:
                key = tuple(fixed.get(a, 0) for a in mesh.axis_names)
                return by_coord[key].to(dev)
            (dim, a), rest = dims[0], dims[1:]
            return torch.cat([build({**fixed, a: i}, rest)
                              for i in range(mesh.shape[a])], dim=dim)

        return build({}, dims)
    return go(list(rank_trees), specs)


def _all_ranks(ts, mesh: Mesh):
    """Every rank's tensor of a per-rank list whose other processes'
    entries are None, gathered over the mesh's processes."""
    collectives["all_gather"] += 1
    sp = _Span(mesh, list(range(mesh.size)))
    with torch.no_grad():
        return _x_members(sp, [ts[r] for r in mesh.local_ranks])
