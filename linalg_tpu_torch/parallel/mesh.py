"""Device meshes and the collectives over them — the counterpart of
``linalg_tpu/parallel/mesh.py``.

A ``Mesh`` names its axes and holds a numpy array of ``torch.device``s of
the mesh's shape. A device may appear more than once: the ranks of a mesh
then share it, which is how the sharded trainers run their ranks on one
card.

Where the JAX package hands communication to GSPMD and ``shard_map``, the
port makes it explicit. A rank's shard is a tensor on that rank's mesh
device, and a sharded value is a list of them, one per rank in the mesh's
row-major order. The collectives below take such a list and the mesh
axis (or axes) to communicate over; ranks that differ only along those
axes form a group:

- ``all_reduce`` (sum or mean), ``all_gather``, ``reduce_scatter``,
  ``all_to_all`` and ``ppermute``, as ``lax.psum``, ``all_gather``,
  ``psum_scatter``, ``all_to_all`` and ``ppermute`` are in JAX.
- They move data with ``.to(device)``; ranks that share a device share
  the result (one sum, one concatenation), so no copy is made beyond
  what the result needs.
- Autograd goes through them: each one's backward is its adjoint
  collective (an all-reduce's is an all-reduce, an all-gather's a
  reduce-scatter, a permutation's the inverse permutation).
- ``collectives`` counts the calls by kind, backward calls included. A
  group of one rank makes no call and counts none, as a psum over an
  axis of size 1 moves nothing.

Sharding rules are specs: one entry per tensor dimension, each None or
the one mesh axis that dimension is split over, as a ``PartitionSpec``'s
entries; ``()`` is replicated. ``shard_tree``/``unshard_tree`` move a
parameter tree between its whole arrays and the per-rank shards (each
rank holds its own copy of a replicated leaf).
"""

from __future__ import annotations

import collections
import itertools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "pick_dp_tp", "collectives", "all_reduce",
           "all_gather", "reduce_scatter", "all_to_all", "ppermute",
           "shard_tree", "unshard_tree", "spec_axes"]

# calls by kind: "all_reduce", "all_gather", "reduce_scatter",
# "all_to_all", "ppermute"
collectives: collections.Counter = collections.Counter()


class Mesh:
    """Axis names and a device array: ``shape`` maps each name to its size,
    in order, as ``jax.sharding.Mesh.shape`` does. ``size`` is the number
    of ranks, ``coords[r]`` rank r's {axis: index}, ``rank_devices[r]``
    its device (ranks in row-major order)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
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


def _cuda_devices():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass devices=[...] (e.g. "
                           "['cpu'] * n) to build a mesh without a card")
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("dp", "tp"),
              devices=None) -> Mesh:
    """Build a Mesh over ``devices`` (default: every CUDA card; without
    one, raise), the first ``prod(shape)`` of them in row-major order.

    ``shape`` defaults to all devices on the first axis. Devices may
    repeat (``[torch.device("cuda")] * 4`` puts four ranks on one card);
    fewer devices than the shape needs raise."""
    devices = [torch.device(d) for d in (
        devices if devices is not None else _cuda_devices())]
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh shape {tuple(shape)} needs {n} devices, "
                         f"have {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(tuple(shape)), axis_names)


# -- the collectives ---------------------------------------------------------
#
# Each ``_raw_*`` works on one group (a list of tensors, one per rank) with
# no autograd and counts itself; ``_Collective`` runs a raw collective
# forward and its adjoint backward.


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


def _run(xs, mesh, axes, fwd, bwd):
    """Apply a group collective to every group of ``mesh`` along ``axes``;
    a group of one rank passes through."""
    if len(xs) != mesh.size:
        raise ValueError(f"{len(xs)} values for a mesh of {mesh.size} ranks")
    out = list(xs)
    for group in mesh.groups(axes):
        if len(group) > 1:
            res = _apply(fwd, bwd, [xs[r] for r in group])
            for r, v in zip(group, res):
                out[r] = v
    return out


def all_reduce(xs, mesh: Mesh, axes, op: str = "sum"):
    """Every rank gets the sum (``op="mean"``: the mean) of its group's
    values along ``axes``; the sum is formed in rank order on the group's
    first device, so every rank of a group holds the same bits."""
    if op not in ("sum", "mean"):
        raise ValueError(f"all_reduce op must be sum or mean, got {op!r}")
    f = lambda v: _raw_all_reduce(v, op)
    return _run(xs, mesh, axes, f, f)


def all_gather(xs, mesh: Mesh, axes, dim: int):
    """Every rank gets its group's values concatenated along ``dim`` in
    rank order. Backward: a reduce-scatter (sum) of the gradients."""
    return _run(xs, mesh, axes, lambda v: _raw_all_gather(v, dim),
                lambda g: _raw_reduce_scatter(g, dim, "sum"))


def reduce_scatter(xs, mesh: Mesh, axes, dim: int, op: str = "sum"):
    """Rank i of a group gets block i (along ``dim``) of the group's sum
    (``op="mean"``: mean). Backward: an all-gather."""
    if op not in ("sum", "mean"):
        raise ValueError(f"reduce_scatter op must be sum or mean, got {op!r}")

    def bwd(gs):
        out = _raw_all_gather(gs, dim)
        return [g / len(gs) for g in out] if op == "mean" else out

    return _run(xs, mesh, axes, lambda v: _raw_reduce_scatter(v, dim, op),
                bwd)


def all_to_all(xs, mesh: Mesh, axes, split_dim: int, concat_dim: int):
    """Rank i of a group gets block i (along ``split_dim``) of every rank's
    value, concatenated along ``concat_dim`` in rank order. Backward: the
    all-to-all with the two dims exchanged."""
    return _run(xs, mesh, axes,
                lambda v: _raw_all_to_all(v, split_dim, concat_dim),
                lambda g: _raw_all_to_all(g, concat_dim, split_dim))


def ppermute(xs, mesh: Mesh, axis: str, perm):
    """Along ``axis``, the rank at index dst of its group gets the value of
    the rank at index src for each (src, dst) of ``perm``; a rank with no
    source, or whose source holds None, gets None (JAX's ppermute gives
    zeros: the callers here skip the ticks that would read them).
    Backward: each gradient goes back to its source."""
    if len(xs) != mesh.size:
        raise ValueError(f"{len(xs)} values for a mesh of {mesh.size} ranks")
    out = [None] * len(xs)
    for group in mesh.groups(axis):
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
    rank r's device (replicated leaves are copied to every rank)."""
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
    return [per_rank(r) for r in range(mesh.size)]


def unshard_tree(rank_trees, specs, mesh: Mesh):
    """The whole tensors of per-rank shards, on rank 0's device: each leaf's
    blocks concatenated back along its split dimensions (a replicated
    leaf is rank 0's copy)."""
    dev = mesh.rank_devices[0]

    def go(ts, s):
        if isinstance(ts[0], dict):
            return {k: go([t[k] for t in ts], s[k]) for k in ts[0]}
        by_coord = {tuple(c[a] for a in mesh.axis_names): t.detach()
                    for c, t in zip(mesh.coords, ts)}
        dims = [(d, a) for d, a in enumerate(s) if a is not None]

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
