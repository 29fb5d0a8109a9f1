"""Sharded GPT training: data-parallel batch x tensor-parallel heads/FFN,
and sequence parallelism — the counterpart of
``linalg_tpu/parallel/sharding.py``.

Layout (megatron-style), as ``gpt_param_specs`` states it:

- Wq/Wk/Wv (L, D, h*dh), W1/b1 and the gate's Wg/bg: split by column over
  ``tp``, so each tp rank owns n_heads/tp heads end to end through
  attention, and F/tp of the FFN.
- Wo (L, h*dh, D) and W2 (L, F, D): split by row; each rank's product is a
  partial sum, and an all-reduce over ``tp`` reassembles the residual
  stream (twice a layer).
- Embeddings, LayerNorms, b2: replicated; every rank holds its own copy.
- The batch (B, T): split over ``dp``.

Where the JAX package lets GSPMD place the collectives, each rank here
runs its own block of the model on its own tensors, and
``parallel.mesh``'s collectives move data between ranks. The residual
stream is replicated over ``tp``: each tp rank carries its copy, the head
and loss run once per dp rank (on its tp rank 0), and ``b2`` is added on
tp rank 0 only (its FFN output is summed over ``tp``). The global loss is
the mean over ``dp`` of each dp rank's mean: its gradient with respect to
a leaf is the sum of the gradients of that leaf's copies (the mean over
``dp``, and for a replicated leaf the sum over ``tp``), which
``_reduce_grads`` forms with one all-reduce a leaf. Clipping takes the
norm of the whole gradient: each shard once, each replicated leaf once.

Attention runs each rank's (B/dp, H/tp, T, d) block through the
single-card pick (``make_sharded_attn``): the flash kernel K2 at T >= 512
on the card. With ``LINALG_TPU_FUSED_LN=1`` each rank takes K8 (its
column blocks zero-padded to the D columns K8 takes) and K9 (its F/tp
columns) as ``_pick_fused`` allows.

Sequence parallelism (``make_sp_*``): the batch is split over (dp, sp)
and attention runs the ring (``parallel.ring``, or K10/K11 through
``parallel.ring_pallas`` with ``pallas=True``); parameters are
replicated, and the ranks share one process, so the pointwise ops run on
the whole batch and only attention is split into ranks. Over a mesh
whose ranks lie in several processes (``make_sp_ranks_*``) every rank
runs its own (B/dp, T/sp) block through the whole trunk with its own copy
of the parameters, attention through the ring over per-rank chunks (the
plain ring over ``ppermute``, ``ring.ring_attention_ranks``, or with
``pallas=True`` K10/K11 reading the other processes' chunks through CUDA
IPC, ``ring_pallas.ring_attention_pallas_ranks``), and the gradients are
all-reduced as replicated leaves' are.

Tensor-parallel serving (``tp_serve_params``, ``tp_serve_ops``,
``tp_prefill``, behind ``ServeEngine(mesh=...)``) keeps the same layout
for inference: each rank its megatron blocks and the KV heads its query
heads read (``tp_kv_heads``), two all-reduces a layer, the head and the
sampling on tp rank 0.

Steps take the trainer's contract: the global batch's windows are drawn on
the parameters' device from a ``torch.Generator`` and then split over the
ranks, so a sharded run draws the batches of the single-device run with
the same seed. Sharded steps take and return per-rank lists of parameter
trees and ``AdamWState``s (``mesh.shard_tree`` makes them).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..models import gpt as _gpt
from ..models.gpt import (_REMAT_SDPA, GPTConfig, _attn_half, _attn_out,
                          _dt_decode_ops, _embed, _ffn_half, _gqa_expand,
                          _grouped_decode_attn, _heads, _hidden_loss,
                          _layer_params, _pick_attn, _pick_fused,
                          _prefill_head, _trunk_mask, _unheads, gpt_loss,
                          init_gpt_params)
from ..nn.functional import causal_mask, layer_norm, rope_rotate, sdpa
from ..nn.fused_layer import fused_supported
from ..nn.positional import alibi_slopes
from ..train.optim import (adamw_init, adamw_update, gpt_lr_scales,
                           gpt_wd_mask, tree_leaves, tree_map, tree_zip,
                           warmup_cosine)
from ..train.trainer import (_eval_device, _value_and_grad, _windows,
                             make_device_train_step)
from .mesh import (all_reduce, make_mesh, pick_dp_tp, shard_tree, spec_axes,
                   taped, unshard_tree)
from .ring import make_ring_attention, ring_attention_ranks
from .ring_pallas import (make_ring_attention_pallas,
                          ring_attention_pallas_ranks)

__all__ = ["gpt_param_specs", "make_sharded_attn", "make_sharded_train_step",
           "make_sharded_device_train_step", "make_sharded_eval",
           "make_sp_train_step", "make_sp_device_train_step", "make_sp_eval",
           "sp_param_specs", "make_sp_ranks_device_train_step",
           "make_sp_ranks_eval",
           "tp_kv_heads", "tp_serve_params", "tp_serve_ops", "tp_prefill",
           "dryrun_multichip"]


def gpt_param_specs(params=None, cfg=None) -> dict:
    """The dp x tp split rule per leaf (see the module docstring): a spec
    tree of the GPT parameter layout, each spec a tuple with the entries
    of the JAX package's ``PartitionSpec``. Pass ``cfg`` (or a params
    dict) so a gated FFN's Wg/bg and learned positions' pos_W get theirs."""
    col, row = (None, None, "tp"), (None, "tp", None)
    layer_specs = {
        "ln1_g": (), "ln1_b": (), "Wq": col, "Wk": col, "Wv": col,
        "Wo": row, "ln2_g": (), "ln2_b": (), "W1": col, "b1": (None, "tp"),
        "W2": row, "b2": (),
    }
    if (params is not None and "Wg" in params.get("layers", {})) or (
            cfg is not None and getattr(cfg, "gated_ffn", False)):
        layer_specs["Wg"] = col
        layer_specs["bg"] = (None, "tp")
    specs = {"tok_W": (), "head_b": (), "layers": layer_specs}
    if (params is not None and "pos_W" in params) or (
            cfg is not None and getattr(cfg, "pos", None) == "learned"):
        specs["pos_W"] = ()
    return specs


def make_sharded_attn(mesh, T: int, d_head: int, batch_axis: str = "dp",
                      head_axis: str | None = "tp", cfg: GPTConfig = None):
    """Attention for the sharded steps: each rank runs its (B/dp, h/tp, T,
    d) block through the single-card pick, with no collective (heads are
    tp-local by the parameter layout, and attention is pointwise over
    batch and head).

    Returns ``fa(q, k, v, mask)`` over global (B, H, T, d) tensors (the
    blocks split out, run, and put back together), whose ``local(coord)``
    is rank ``coord``'s ``attn_fn(q, k, v, mask)`` on its block. The
    ``mask`` argument is ignored: the attention forms its own.

    - ``cfg.pos == "alibi"``: the rematted sdpa with the per-head distance
      bias of the rank's OWN head slice (slopes h_idx * h_loc onward; all
      of them with ``head_axis=None``), under the window band when
      ``cfg.window`` is set.
    - ``cfg.window``: the rematted sdpa over the banded mask.
    - else ``_pick_attn`` on the rank's device (K2 at 512 <= T <= 1024 on
      the card) under the causal mask.
    """
    if cfg is not None and cfg.pos == "alibi":
        sl_all = alibi_slopes(cfg.n_heads)

        def local(coord):
            idx = 0 if head_axis is None else coord[head_axis]

            def attn(q, k, v, mask=None):
                dev, h_loc = q.device, q.shape[1]
                sl = sl_all.to(dev)[idx * h_loc:(idx + 1) * h_loc]
                i = torch.arange(T, device=dev)
                dist = (i[None, :] - i[:, None]).float()  # j - i
                base = causal_mask(T, dtype=torch.float32, device=dev)
                if cfg.window is not None:  # the band under ALiBi
                    far = (i[:, None] - i[None, :]) >= cfg.window
                    base = torch.where(far[None, None], -1e9, base)
                m = (base + (sl[:, None, None] * dist)[None]).to(q.dtype)
                return _REMAT_SDPA(q, k, v, m)
            return attn
    elif cfg is not None and cfg.window is not None:
        def local(coord):
            def attn(q, k, v, mask=None):
                return _REMAT_SDPA(q, k, v, _trunk_mask(cfg, T, q.dtype,
                                                        q.device))
            return attn
    else:
        def local(coord):
            def attn(q, k, v, mask=None):
                fn = _pick_attn(T, d_head, q.device.type)
                return fn(q, k, v, causal_mask(T, dtype=q.dtype,
                                               device=q.device))
            return attn

    nb = mesh.shape[batch_axis] if batch_axis else 1
    nh = mesh.shape[head_axis] if head_axis else 1

    def fa(q, k, v, mask=None):
        B, H = q.shape[:2]
        bs, hs = B // nb, H // nh
        rows = []
        for bi in range(nb):
            cols = []
            for hi in range(nh):
                coord = {batch_axis: bi, head_axis: hi}
                r = next(r for r, c in enumerate(mesh.coords)
                         if all(c.get(a, 0) == i for a, i in coord.items()
                                if a is not None))
                dev = mesh.rank_devices[r]
                blk = [t[bi * bs:(bi + 1) * bs, hi * hs:(hi + 1) * hs]
                       .to(dev) for t in (q, k, v)]
                cols.append(local(mesh.coords[r])(*blk).to(q.device))
            rows.append(torch.cat(cols, dim=1))
        return torch.cat(rows, dim=0)

    fa.local = local
    return fa


# -- the machinery the sharded trainers share --------------------------------
#
# A per-rank list holds None for the ranks of other processes (see
# ``parallel.mesh``): each process computes its own ranks only, and every
# process draws the same global batch from the same generator and keeps
# its ranks' rows, as JAX's global PRNG key gives every host the same
# windows.


def _each(fn, *lists):
    """``fn`` over the ranks' entries of per-rank lists: None where the
    first list's entry is None (a rank of another process)."""
    return [None if args[0] is None else fn(*args) for args in zip(*lists)]


def _first(values):
    """This process's first rank's entry of a per-rank list."""
    return next(v for v in values if v is not None)


def _split_batch(x, mesh, axis):
    """Per-rank blocks of the global batch x (B, ...): split over ``axis``
    (replicated over the other axes), or whole on every rank when
    ``axis`` is None; each on its rank's device, None for the ranks of
    other processes."""
    if axis is not None and x.shape[0] % mesh.shape[axis]:
        raise ValueError(f"batch {x.shape[0]} must divide by the {axis!r} "
                         f"axis ({mesh.shape[axis]})")
    parts = x.chunk(mesh.shape[axis]) if axis is not None else None
    return [(x if axis is None else parts[c[axis]]).to(d)
            if mesh.is_local(r) else None
            for r, (c, d) in enumerate(zip(mesh.coords, mesh.rank_devices))]


class _NoGrad(torch.autograd.Function):
    """The identity forward, a zero gradient backward: a copy of a value
    that joins the backward without adding to it."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g)


def _mean_loss(losses, mesh, n_groups: int):
    """The global loss on every rank from per-rank partial losses (None for
    ranks that hold none): their sum over the mesh over ``n_groups``.
    Returns rank 0's copy, as one process holds them all; in the other
    processes of a mesh, this process's first rank's copy, the same
    value, which carries no gradient: the backward differentiates the one
    copy, as a single process does, and the other processes still run
    every collective of it."""
    like = next((v for v in losses if v is not None), None)
    dt = like.dtype if like is not None else torch.float32
    vals = [None if not mesh.is_local(r) else v.reshape(()) if v is not None
            else torch.zeros((), dtype=dt, device=mesh.rank_devices[r])
            for r, v in enumerate(losses)]
    out = all_reduce(vals, mesh, mesh.axis_names)
    if mesh.is_local(0):
        return out[0] / n_groups
    return _NoGrad.apply(_first(out)) / n_groups


def _rank_grads(rank_params, loss, tape=None):
    """autograd.grad of ``loss`` with respect to this process's ranks'
    leaves: per-rank gradient trees (zeros for a leaf the loss does not
    reach; None for the other processes' ranks). With a ``tape`` its root
    is differentiated too, so every crossing collective's backward runs."""
    leaves = [p for tree in rank_params if tree is not None
              for p in tree_leaves(tree)]
    extra = [tape.root] if tape is not None else []
    it = iter(torch.autograd.grad(loss, leaves + extra, allow_unused=True))

    def grad(p):
        g = next(it)
        return torch.zeros_like(p) if g is None else g

    return [None if tree is None else tree_map(grad, tree)
            for tree in rank_params]


def _requires_grad(rank_params):
    for tree in rank_params:
        for p in tree_leaves(tree) if tree is not None else ():
            p.requires_grad_(True)


def _reduce_grads(rank_grads, specs, mesh):
    """Sum each leaf's gradient over the mesh axes it is replicated on
    (one all-reduce a leaf): every copy then holds the whole gradient of
    its shard, bit for bit the same on every rank."""
    spec_list = [s for (s,) in tree_zip(specs)]
    per_rank = _each(lambda t: [g for (g,) in tree_zip(t)], rank_grads)
    out = [[None] * len(spec_list) for _ in rank_grads]
    for j, spec in enumerate(spec_list):
        axes = tuple(a for a in mesh.axis_names if a not in spec_axes(spec))
        vals = _each(lambda g: g[j], per_rank)
        if axes:
            vals = all_reduce(vals, mesh, axes)
        for r, v in enumerate(vals):
            out[r][j] = v
    res = []
    for r, tree in enumerate(rank_grads):
        it = iter(out[r])
        res.append(None if tree is None else
                   tree_map(lambda _: next(it), tree))
    return res


def _global_norm(rank_grads, specs, mesh):
    """Per-rank copies of the L2 norm of the whole gradient: each rank sums
    the squares of the shards it owns (a replicated leaf is owned by the
    rank at index 0 of the axes it is replicated on), and an all-reduce
    over the mesh adds them."""
    parts = []
    for c, tree in zip(mesh.coords, rank_grads):
        if tree is None:
            parts.append(None)
            continue
        sq = None
        for g, spec in tree_zip(tree, specs):
            split = spec_axes(spec)
            if all(c[a] == 0 for a in mesh.axis_names if a not in split):
                t = torch.sum(torch.square(g.float()))
                sq = t if sq is None else sq + t
        parts.append(sq if sq is not None else torch.zeros(
            (), device=next(iter(tree_leaves(tree))).device))
    return _each(torch.sqrt, all_reduce(parts, mesh, mesh.axis_names))


def _update(rank_params, rank_grads, rank_opt, specs, mesh, lr,
            weight_decay, lr_embed_scale=1.0, lr_head_scale=1.0,
            clip_norm=0.0):
    """AdamW on every rank's shards, in place (the clip on the global
    norm)."""
    norms = (_global_norm(rank_grads, specs, mesh) if clip_norm > 0.0
             else [None] * mesh.size)
    for p, g, o, n in zip(rank_params, rank_grads, rank_opt, norms):
        if p is None:
            continue
        adamw_update(p, g, o, lr, gpt_wd_mask(p, weight_decay),
                     lr_scales=gpt_lr_scales(p, embed=lr_embed_scale,
                                             head=lr_head_scale),
                     clip_norm=clip_norm, grad_norm=n)
    return rank_params, rank_opt


def _loss_and_grads(loss_fn, specs, mesh):
    """(rank_params, x, y) -> (global loss, reduced per-rank grads) of a
    differentiable sharded ``loss_fn(rank_params, x, y)``, its collectives
    across processes on a tape (``mesh.taped``)."""
    def fn(rank_params, x, y):
        _requires_grad(rank_params)
        with taped() as tape:
            loss = tape.tie(loss_fn(rank_params, x, y))
        grads = _reduce_grads(_rank_grads(rank_params, loss, tape), specs,
                              mesh)
        return loss.detach(), grads
    return fn


def _const_step(loss_and_grads, specs, mesh, lr, weight_decay):
    """``step(rank_params, rank_opt, x, y) -> (rank_params, rank_opt,
    loss)`` at a constant lr."""
    def step(rank_params, rank_opt, x, y):
        loss, grads = loss_and_grads(rank_params, x, y)
        _update(rank_params, grads, rank_opt, specs, mesh, lr, weight_decay)
        return rank_params, rank_opt, loss
    return step


def _device_step(loss_and_grads, specs, mesh, batch_size, T, *, base_lr,
                 min_lr, warmup, max_steps, weight_decay,
                 lr_embed_scale=1.0, lr_head_scale=1.0, clip_norm=0.0):
    """The trainer's step contract, ``step(rank_params, rank_opt, data_ids,
    generator) -> (rank_params, rank_opt, generator, loss)``: the global
    batch's windows drawn on ``data_ids``' device, warmup-cosine lr from
    the optimizer's step count, per-leaf lr scales, clipping."""
    def step(rank_params, rank_opt, data_ids, generator):
        x, y = _windows(data_ids, batch_size, T, generator)
        loss, grads = loss_and_grads(rank_params, x, y)
        lr = warmup_cosine(_first(rank_opt).t + 1, base=base_lr,
                           min_lr=min_lr, warmup=warmup, max_steps=max_steps)
        _update(rank_params, grads, rank_opt, specs, mesh, lr, weight_decay,
                lr_embed_scale, lr_head_scale, clip_norm)
        return rank_params, rank_opt, generator, loss
    return step


def _device_eval(loss_fn, batch, batches, T):
    """``evaluate(rank_params, val_ids, generator)``: the mean of
    ``loss_fn`` over ``batches`` windows, one device scalar."""
    @torch.no_grad()
    def evaluate(rank_params, val_ids, generator):
        total = 0.0
        for _ in range(batches):
            total = total + loss_fn(rank_params,
                                    *_windows(val_ids, batch, T, generator))
        return total / batches
    return evaluate


# -- the dp x tp model -------------------------------------------------------


def _b2_once(lp, coord, axis):
    """The layer's weights with b2 zeroed off the axis's rank 0: the FFN
    output is summed over the axis, so b2 enters once (K9 adds it in the
    kernel)."""
    if coord.get(axis, 0) == 0:
        return lp
    return {**lp, "b2": torch.zeros_like(lp["b2"])}


def _tp_fused(cfg: GPTConfig, B: int, T: int, tp: int, device_type: str):
    """``_pick_fused`` for a tp rank's block: its N = B*T rows, and its F/tp
    FFN columns within what K9 takes."""
    return (cfg.kv_heads == cfg.n_heads
            and _pick_fused(B, T, cfg, device_type)
            and fused_supported(B * T, cfg.d_model, cfg.dff // tp))


def _tp_loss(cfg: GPTConfig, mesh, attn_fn, dp_axis="dp", tp_axis="tp"):
    """``loss(rank_params, x, y)``: the dp x tp forward of global (B, T)
    batches, the global mean CE (differentiable)."""
    tp = mesh.shape.get(tp_axis, 1)
    dp = mesh.shape.get(dp_axis, 1) if dp_axis else 1
    if cfg.n_heads % tp or cfg.kv_heads % tp:
        raise ValueError("n_heads (and kv_heads) must divide by tp")
    H, KV = cfg.n_heads // tp, cfg.kv_heads // tp
    locals_ = [attn_fn.local(c) for c in mesh.coords]

    def loss(rank_params, x, y):
        xs, ys = _split_batch(x, mesh, dp_axis), _split_batch(y, mesh, dp_axis)
        B, T = _first(xs).shape
        dt = cfg.compute_dtype
        fused = _tp_fused(cfg, B, T, tp, _first(xs).device.type)
        emb = _each(lambda p, xx: _embed(p, xx, cfg, T, dt), rank_params, xs)
        hs = _each(lambda e: e[0], emb)
        layers = _each(lambda p: _layer_params(p, dt), rank_params)
        for li in range(cfg.n_layers):
            parts = _each(lambda h, lay, at, e: _attn_half(
                h, lay[li], None, H, KV, at, e[1], fused)[0],
                hs, layers, locals_, emb)
            a = all_reduce(parts, mesh, tp_axis)
            h1s = _each(torch.add, hs, a)
            parts = _each(lambda h1, lay, c: _ffn_half(
                h1, _b2_once(lay[li], c, tp_axis), cfg.ffn, fused),
                h1s, layers, mesh.coords)
            f = all_reduce(parts, mesh, tp_axis)
            hs = _each(torch.add, h1s, f)
        losses = _each(lambda p, h, yy, c: _hidden_loss(p, h, yy, cfg)
                       if c.get(tp_axis, 0) == 0 else None,
                       rank_params, hs, ys, mesh.coords)
        return _mean_loss(losses, mesh, dp)

    return loss


def make_sharded_train_step(cfg: GPTConfig, mesh, *, lr: float = 3e-4,
                            weight_decay: float = 0.01, attn_fn=None):
    """``step(rank_params, rank_opt, x, y) -> (rank_params, rank_opt,
    loss)`` over a (dp, tp) mesh at a constant lr: the dp x tp forward,
    gradients reduced over the ranks, AdamW on each rank's shards in
    place. ``rank_params``: ``shard_tree(params, gpt_param_specs(None,
    cfg), mesh)``."""
    if attn_fn is None:
        attn_fn = make_sharded_attn(mesh, cfg.ctx_len, cfg.d_head, cfg=cfg)
    specs = gpt_param_specs(None, cfg)
    return _const_step(_loss_and_grads(_tp_loss(cfg, mesh, attn_fn), specs,
                                       mesh), specs, mesh, lr, weight_decay)


def make_sharded_device_train_step(cfg: GPTConfig, mesh, batch_size: int, *,
                                   base_lr: float, min_lr: float,
                                   warmup: int, max_steps: int,
                                   weight_decay: float,
                                   lr_embed_scale: float = 1.0,
                                   lr_head_scale: float = 1.0,
                                   clip_norm: float = 0.0):
    """The trainer's dp x tp step: ``step(rank_params, rank_opt, data_ids,
    generator) -> (rank_params, rank_opt, generator, loss)``, windows drawn
    on the corpus's device and split over dp."""
    if batch_size % mesh.shape.get("dp", 1):
        raise ValueError("batch_size must divide by dp")
    attn_fn = make_sharded_attn(mesh, cfg.ctx_len, cfg.d_head, cfg=cfg)
    specs = gpt_param_specs(None, cfg)
    return _device_step(
        _loss_and_grads(_tp_loss(cfg, mesh, attn_fn), specs, mesh), specs,
        mesh, batch_size, cfg.ctx_len, base_lr=base_lr, min_lr=min_lr,
        warmup=warmup, max_steps=max_steps, weight_decay=weight_decay,
        lr_embed_scale=lr_embed_scale, lr_head_scale=lr_head_scale,
        clip_norm=clip_norm)


def make_sharded_eval(cfg: GPTConfig, mesh, batch: int, batches: int):
    """``evaluate(rank_params, val_ids, generator)``: the mean dp x tp loss
    over ``batches`` windows, one device scalar."""
    attn_fn = make_sharded_attn(mesh, cfg.ctx_len, cfg.d_head, cfg=cfg)
    return _device_eval(_tp_loss(cfg, mesh, attn_fn), batch, batches,
                        cfg.ctx_len)


# -- sequence parallelism ----------------------------------------------------


def _sp_ring(mesh, pallas: bool, cfg: GPTConfig | None = None):
    """The sp attention ring as the model's ``attn_fn(q, k, v, mask)``: the
    ring kernels (``pallas``) or the plain ring. ``cfg.pos == "alibi"``
    threads the per-head slopes into the ring, and ``cfg.window`` the
    band."""
    slopes = None
    window = None if cfg is None else cfg.window
    if cfg is not None and cfg.pos == "alibi":
        slopes = tuple(float(s) for s in alibi_slopes(cfg.n_heads))
    make = make_ring_attention_pallas if pallas else make_ring_attention
    ring = make(mesh, axis="sp", causal=True, batch_axis="dp", slopes=slopes,
                window=window)
    return lambda q, k, v, mask: ring(q, k, v)


def make_sp_train_step(cfg: GPTConfig, mesh, *, lr: float = 3e-4,
                       weight_decay: float = 0.01, pallas: bool = False):
    """``step(params, opt_state, x, y) -> (params, opt_state, loss)`` over
    a (dp, sp) mesh at a constant ``lr``: attention runs the ring, AdamW
    updates in place."""
    attn_fn = _sp_ring(mesh, pallas, cfg)

    def step(params, opt_state, x, y):
        loss, grads = _value_and_grad(params, x, y, cfg, attn_fn)
        params, opt_state = adamw_update(params, grads, opt_state, lr,
                                         gpt_wd_mask(params, weight_decay))
        return params, opt_state, loss

    return step


def make_sp_device_train_step(cfg: GPTConfig, mesh, batch_size: int, *,
                              base_lr: float, min_lr: float, warmup: int,
                              max_steps: int, weight_decay: float,
                              lr_embed_scale: float = 1.0,
                              lr_head_scale: float = 1.0,
                              pallas: bool = False, clip_norm: float = 0.0):
    """The trainer's device step (``train.trainer.make_device_train_step``:
    windows drawn on the device, warmup-cosine lr, per-leaf lr scales,
    clipping) with attention over the (dp, sp) mesh's ring: the ring
    kernels K10/K11 with ``pallas``, else the plain ring."""
    if batch_size % mesh.shape["dp"]:
        raise ValueError("batch_size must divide by dp")
    return make_device_train_step(
        cfg, batch_size, base_lr=base_lr, min_lr=min_lr, warmup=warmup,
        max_steps=max_steps, weight_decay=weight_decay,
        lr_embed_scale=lr_embed_scale, lr_head_scale=lr_head_scale,
        clip_norm=clip_norm, attn_fn=_sp_ring(mesh, pallas, cfg))


def make_sp_eval(cfg: GPTConfig, mesh, batch: int, batches: int,
                 pallas: bool = False):
    """``evaluate(params, val_ids, generator)``: the mean loss over
    ``batches`` windows through the ring, one device scalar."""
    attn_fn = _sp_ring(mesh, pallas, cfg)

    def evaluate(params, val_ids, generator):
        return _eval_device(params, val_ids, generator, cfg, batch, batches,
                            attn_fn)

    return evaluate


def sp_param_specs(cfg: GPTConfig) -> dict:
    """``gpt_param_specs``' tree with every leaf replicated: sequence
    parallelism splits no parameter."""
    return {k: ({kk: () for kk in v} if isinstance(v, dict) else ())
            for k, v in gpt_param_specs(None, cfg).items()}


def _embed_rows(p, ids, cfg: GPTConfig, T: int, lo: int, dt):
    """``_embed`` of the positions [lo, lo + Tl) of a length-T window whose
    tokens there are ``ids`` (B, Tl): (h, rope tables of those rows)."""
    rows = slice(lo, lo + ids.shape[1])
    dev = p["tok_W"].device
    emb = p["tok_W"][ids]
    if cfg.pos == "rope":
        cos, sin = _gpt._rope(cfg, T, dt, dev)
        return emb.to(dt), (cos[rows], sin[rows])
    if cfg.pos == "alibi":
        return emb.to(dt), None
    pe = (p["pos_W"][:T] if cfg.pos == "learned" else
          _gpt.sinusoidal_encoding(cfg.ctx_len, cfg.d_model, device=dev)[:T])
    return (emb + pe[rows][None]).to(dt), None


def _sp_ranks_loss(cfg: GPTConfig, mesh, pallas: bool = False):
    """``loss(rank_params, x, y)`` of sequence parallelism with every rank's
    block its own: rank (i, j) takes dp block i's rows at positions
    [j T/sp, (j + 1) T/sp) through the trunk (LN, QKV, the ring over the
    sp group: the plain ring, or K10/K11 with ``pallas``, one call a layer
    over all of this process's ranks; Wo, the FFN) and the head; the
    global mean CE."""
    n, dp = mesh.shape["sp"], mesh.shape["dp"]
    ring = ring_attention_pallas_ranks if pallas else ring_attention_ranks
    H, KV = cfg.n_heads, cfg.kv_heads
    slopes = (tuple(float(s) for s in alibi_slopes(cfg.n_heads))
              if cfg.pos == "alibi" else None)

    def loss(rank_params, x, y):
        T = x.shape[1]
        if T % n:
            raise ValueError(f"T {T} must divide into the ring's {n} ranks")
        Tl, dt = T // n, cfg.compute_dtype
        cut = lambda t, c: t[:, c["sp"] * Tl:(c["sp"] + 1) * Tl]
        xs = _each(cut, _split_batch(x, mesh, "dp"), mesh.coords)
        ys = _each(cut, _split_batch(y, mesh, "dp"), mesh.coords)
        emb = _each(lambda p, xx, c: _embed_rows(p, xx, cfg, T,
                                                 c["sp"] * Tl, dt),
                    rank_params, xs, mesh.coords)
        hs = _each(lambda e: e[0], emb)
        layers = _each(lambda p: _layer_params(p, dt), rank_params)
        for li in range(cfg.n_layers):
            def qkv(h, lay, e):
                lp = lay[li]
                xn = layer_norm(h, lp["ln1_g"], lp["ln1_b"])
                q = _heads(xn @ lp["Wq"], H)
                k = _heads(xn @ lp["Wk"], KV)
                v = _heads(xn @ lp["Wv"], KV)
                if e[1] is not None:
                    q, k = rope_rotate(q, *e[1]), rope_rotate(k, *e[1])
                return q, _gqa_expand(k, H), _gqa_expand(v, H)

            t = _each(qkv, hs, layers, emb)
            o = ring(*(_each(lambda u: u[i], t) for i in range(3)), mesh,
                     "sp", causal=True, slopes=slopes, window=cfg.window)
            h1s = _each(lambda h, oo, lay: h + _unheads(oo) @ lay[li]["Wo"],
                        hs, o, layers)
            hs = _each(lambda h1, lay: h1 + _ffn_half(h1, lay[li], cfg.ffn),
                       h1s, layers)
        losses = _each(lambda p, h, yy: _hidden_loss(p, h, yy, cfg),
                       rank_params, hs, ys)
        return _mean_loss(losses, mesh, dp * n)

    return loss


def make_sp_ranks_device_train_step(cfg: GPTConfig, mesh, batch_size: int, *,
                                    base_lr: float, min_lr: float,
                                    warmup: int, max_steps: int,
                                    weight_decay: float,
                                    lr_embed_scale: float = 1.0,
                                    lr_head_scale: float = 1.0,
                                    clip_norm: float = 0.0,
                                    pallas: bool = False):
    """The trainer's sp step over a (dp, sp) mesh whose ranks lie in
    several processes: ``step(rank_params, rank_opt, data_ids, generator)
    -> (rank_params, rank_opt, generator, loss)``, ``rank_params`` =
    ``shard_tree(params, sp_param_specs(cfg), mesh)``; attention through
    the ring kernels with ``pallas``, else the plain ring."""
    if batch_size % mesh.shape["dp"]:
        raise ValueError("batch_size must divide by dp")
    specs = sp_param_specs(cfg)
    return _device_step(
        _loss_and_grads(_sp_ranks_loss(cfg, mesh, pallas), specs, mesh),
        specs, mesh,
        batch_size, cfg.ctx_len, base_lr=base_lr, min_lr=min_lr,
        warmup=warmup, max_steps=max_steps, weight_decay=weight_decay,
        lr_embed_scale=lr_embed_scale, lr_head_scale=lr_head_scale,
        clip_norm=clip_norm)


def make_sp_ranks_eval(cfg: GPTConfig, mesh, batch: int, batches: int,
                       pallas: bool = False):
    """``evaluate(rank_params, val_ids, generator)``: the mean per-rank sp
    loss over ``batches`` windows, one device scalar (the ring kernels
    with ``pallas``)."""
    return _device_eval(_sp_ranks_loss(cfg, mesh, pallas), batch, batches,
                        cfg.ctx_len)


# -- tensor-parallel serving ---------------------------------------------------


def _block(n: int, tp: int, r: int) -> range:
    """Rank r's block of n rows or columns split over tp ranks: the
    megatron block when tp divides n, else as even as integers allow
    (a rank may get none)."""
    return range(r * n // tp, (r + 1) * n // tp)


def tp_kv_heads(cfg: GPTConfig, tp: int, r: int) -> list:
    """The KV heads tp rank r holds, in its cache's order: those its query
    heads (``_block(n_heads, tp, r)``) read, query head h reading KV head
    h // (H / kv_heads). When tp divides kv_heads these are its
    kv_heads/tp own heads; when several ranks' heads read one KV head (tp
    4 over 2 KV heads), that head's columns and cache rows are replicated
    over them. Where a rank's query heads would group unevenly onto its
    KV heads, it keeps one KV head per query head, so its attention
    groups evenly."""
    g = cfg.n_heads // cfg.kv_heads
    reads = [h // g for h in _block(cfg.n_heads, tp, r)]
    heads = sorted(set(reads))
    if heads and len(reads) % len(heads) == 0:
        per = len(reads) // len(heads)
        if reads == [heads[j // per] for j in range(len(reads))]:
            return heads
    return reads


def tp_serve_params(params, cfg: GPTConfig, mesh) -> list:
    """The per-rank weights of tensor-parallel serving over a 1-D ``tp``
    mesh, in ``gpt_param_specs``' megatron layout: Wq and the FFN's W1/b1
    (and a gate's Wg/bg) by columns, Wo and W2 by the matching rows, the
    rest replicated; Wk/Wv the columns of ``tp_kv_heads``; b2 on rank 0
    only (the FFN output is summed over the ranks). Heads and FFN columns
    split as evenly as the counts allow, so a rank of a model with fewer
    heads than tp may hold none (its attention adds nothing). Each rank's
    tensors are its own, on its device."""
    tp, dh = mesh.size, cfg.d_head
    lay = params["layers"]
    out = []
    for r, dev in enumerate(mesh.rank_devices):
        def idx(cols, dev0=lay["Wq"].device):
            return torch.tensor(list(cols), dtype=torch.long, device=dev0)

        heads = _block(cfg.n_heads, tp, r)
        q = idx(range(heads.start * dh, heads.stop * dh))
        kv = idx(c for h in tp_kv_heads(cfg, tp, r)
                 for c in range(h * dh, (h + 1) * dh))
        f = idx(_block(cfg.dff, tp, r))
        rank = {k: v for k, v in lay.items()}
        rank.update(Wq=lay["Wq"].index_select(2, q),
                    Wk=lay["Wk"].index_select(2, kv),
                    Wv=lay["Wv"].index_select(2, kv),
                    Wo=lay["Wo"].index_select(1, q),
                    W1=lay["W1"].index_select(2, f),
                    b1=lay["b1"].index_select(1, f),
                    W2=lay["W2"].index_select(1, f))
        if "Wg" in lay:
            rank.update(Wg=lay["Wg"].index_select(2, f),
                        bg=lay["bg"].index_select(1, f))
        if r:
            rank["b2"] = torch.zeros_like(lay["b2"])
        tree = {k: v for k, v in params.items() if k != "layers"}
        tree["layers"] = rank
        out.append(tree_map(lambda t: t.detach().to(dev, copy=True)
                            .contiguous(), tree))
    return out


def _rank_inputs(mesh, rope, mask, H: int):
    """Per rank: the RoPE tables and the additive mask on its device, a
    per-head (ALiBi) mask cut to its heads."""
    out = []
    for r, dev in enumerate(mesh.rank_devices):
        hb = _block(H, mesh.size, r)
        m = mask[:, hb.start:hb.stop] if mask.shape[1] > 1 else mask
        out.append((None if rope is None else tuple(t.to(dev) for t in rope),
                    m.to(dev)))
    return out


def tp_serve_ops(rank_params, cfg: GPTConfig, mesh) -> dict:
    """The decode ops of tensor-parallel serving, for ``_decode_chunk_core``
    and the block forward of admission extensions: embedding, positions
    and head from tp rank 0's replicated weights on its device, and
    ``"layers"``, the layer loop over per-rank KV buffers. Each rank runs
    the attention of its heads (the model's choice of softmax: float32
    for grouped heads) into its own cache rows and its FFN columns; one
    ``all_reduce`` over ``tp`` follows Wo and one W2, twice a layer."""
    tp = mesh.size
    ops = [_dt_decode_ops(p, cfg) for p in rank_params]
    heads = [(len(_block(cfg.n_heads, tp, r)), len(tp_kv_heads(cfg, tp, r)),
              cfg.d_head) for r in range(tp)]
    attn = sdpa if cfg.kv_heads == cfg.n_heads else _grouped_decode_attn

    def attn_part(o, i, x, ri, kb, vb, p, write_fn, hd):
        if not hd[0]:  # a rank without heads adds nothing
            return torch.zeros_like(x)
        return _attn_out(o, o["lws"][i], x, ri[0], ri[1], kb, vb, p,
                         write_fn, attn, hd)

    def layers(h, rope, mask, kbuf, vbuf, pos, write_fn):
        hs = [h.to(d) for d in mesh.rank_devices]
        ins = _rank_inputs(mesh, rope, mask, cfg.n_heads)
        ps = [pos.to(d) if torch.is_tensor(pos) else pos
              for d in mesh.rank_devices]
        for i in range(cfg.n_layers):
            a = all_reduce([attn_part(o, i, x, ri, kb[i], vb[i], p, write_fn,
                                      hd)
                            for o, x, ri, kb, vb, p, hd in zip(
                                ops, hs, ins, kbuf, vbuf, ps, heads)],
                           mesh, "tp")
            h1 = [x + y for x, y in zip(hs, a)]
            f = all_reduce([o["ffn"](o["lws"][i], o["ln2"](o["lws"][i], x))
                            for o, x in zip(ops, h1)], mesh, "tp")
            hs = [x + y for x, y in zip(h1, f)]
        return hs[0]

    return {k: ops[0][k] for k in ("device", "embed", "pe", "head")} | {
        "layers": layers}


@torch.no_grad()
def tp_prefill(rank_params, ids, cfg: GPTConfig, mesh, length=None):
    """``models.gpt.gpt_prefill`` over tensor-parallel ranks: (next-token
    logits (B, V) on rank 0's device, cache {k, v: per-rank (L, B, kv
    heads of the rank, ctx_len, d), length}). Each rank runs its heads
    (``_attn_half``) and FFN columns (``_ffn_half``), with an
    ``all_reduce`` over ``tp`` after each."""
    tp = mesh.size
    T = ids.shape[1]
    dt = cfg.compute_dtype
    h, rope = _embed(rank_params[0], ids, cfg, T, dt)
    ins = _rank_inputs(mesh, rope, _trunk_mask(cfg, T, dt, h.device),
                       cfg.n_heads)
    hs = [h.to(d) for d in mesh.rank_devices]
    layers = [_layer_params(p, dt) for p in rank_params]
    heads = [(len(_block(cfg.n_heads, tp, r)), len(tp_kv_heads(cfg, tp, r)))
             for r in range(tp)]
    ks, vs = [[] for _ in range(tp)], [[] for _ in range(tp)]
    for li in range(cfg.n_layers):
        outs = []
        for r, (x, lay, ri, (H, n_kv)) in enumerate(zip(hs, layers, ins,
                                                         heads)):
            if H:
                a, (k, v) = _attn_half(x, lay[li], ri[1], H, n_kv, sdpa,
                                       ri[0])
            else:  # a rank without heads adds nothing and caches nothing
                a = torch.zeros_like(x)
                k = v = x.new_zeros((x.shape[0], 0, T, cfg.d_head))
            outs.append(a)
            ks[r].append(k)
            vs[r].append(v)
        a = all_reduce(outs, mesh, "tp")
        h1 = [x + y for x, y in zip(hs, a)]
        f = all_reduce([_ffn_half(x, lay[li], cfg.ffn)
                        for x, lay in zip(h1, layers)], mesh, "tp")
        hs = [x + y for x, y in zip(h1, f)]
    logits, n = _prefill_head(rank_params[0], hs[0], length, dt)
    pad = (0, 0, 0, cfg.ctx_len - T)
    return logits, {"k": [F.pad(torch.stack(k), pad) for k in ks],
                    "v": [F.pad(torch.stack(v), pad) for v in vs],
                    "length": n}


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Build an n-rank mesh over ``devices`` (a list may repeat one
    device; default: the job's cards, ``make_mesh``'s dealing, so after
    ``init_distributed`` the dp x tp step's mesh spans every process and
    the other checks run on this process's cards), run ONE dp x tp train
    step on tiny shapes, and check the pipeline (GPipe loss, 1F1B loss and grads, one
    1F1B optimizer step), the dp x ep MoE step, tensor-parallel serving
    (greedy tokens equal to the unsharded engine's) and one FSDP step
    against the unsharded model; raise on a mismatch. The JAX package's
    dryrun also checks the rings (the port's are
    ``tests/test_torch_ring.py``'s)."""
    from ..models.moe import MoEGPTConfig, init_moe_params, moe_gpt_loss
    from .expert import moe_param_specs, make_ep_train_step
    from .fsdp import fsdp_param_specs, make_fsdp_device_train_step
    from .pipeline import (make_pp_1f1b_grads, make_pp_device_train_step,
                           make_pp_train_step, pp_param_specs)

    job = devices is None
    if job:
        devices = make_mesh((n_devices,), ("d",), local=True).rank_devices
    devices = list(devices)[:n_devices]
    if len(devices) < n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(devices)}")
    dev = torch.device(devices[0])
    rng = np.random.default_rng(0)

    def ids(*shape):
        return torch.as_tensor(rng.integers(0, 37, size=shape), device=dev)

    n_heads = 4
    dp, tp = pick_dp_tp(n_devices, n_heads)
    mesh = (make_mesh((dp, tp), ("dp", "tp")) if job else
            make_mesh((dp, tp), ("dp", "tp"), devices))
    cfg = GPTConfig(vocab_size=37, d_model=32, n_heads=n_heads, n_layers=2,
                    d_ff=64, ctx_len=16)
    params = init_gpt_params(cfg, seed=0, device=dev)
    specs = gpt_param_specs(None, cfg)
    rp = shard_tree(params, specs, mesh)
    B = 2 * dp
    x, y = ids(B, 16), ids(B, 16)
    _, _, loss = make_sharded_train_step(cfg, mesh)(
        rp, [None if p is None else adamw_init(p) for p in rp], x, y)
    with torch.no_grad():
        ref = float(gpt_loss(params, x, y, cfg))
    tp_ok = abs(float(loss) - ref) < 1e-4

    pp = min(n_devices, 4)
    pp_dp = n_devices // pp
    pp_mesh = make_mesh((pp_dp, pp), ("dp", "pp"), devices)
    pp_cfg = GPTConfig(vocab_size=37, d_model=32, n_heads=4,
                       n_layers=2 * pp, d_ff=64, ctx_len=16)
    pp_params = init_gpt_params(pp_cfg, seed=0, device=dev)
    Bpp = 4 * pp_dp
    xpp, ypp = ids(Bpp, 16), ids(Bpp, 16)
    for p in tree_leaves(pp_params):
        p.requires_grad_(True)
    ref_pp = gpt_loss(pp_params, xpp, ypp, pp_cfg)
    ref_grads = torch.autograd.grad(ref_pp, tree_leaves(pp_params))
    pp_params = tree_map(lambda p: p.detach(), pp_params)
    pspecs = pp_param_specs("dp")
    rpp = shard_tree(pp_params, pspecs, pp_mesh)
    _, _, pp_loss = make_pp_train_step(pp_cfg, pp_mesh, n_microbatches=2,
                                       dp_axis="dp")(
        rpp, [adamw_init(p) for p in rpp], xpp, ypp)
    ref_pp = float(ref_pp.detach())
    pp_ok = abs(float(pp_loss) - ref_pp) < 1e-4
    rpp = shard_tree(pp_params, pspecs, pp_mesh)
    f1_loss, f1_grads = make_pp_1f1b_grads(pp_cfg, pp_mesh, n_microbatches=2,
                                           dp_axis="dp")(rpp, xpp, ypp)
    pp_ok = pp_ok and abs(float(f1_loss) - ref_pp) < 1e-4
    whole = unshard_tree(f1_grads, pspecs, pp_mesh)
    for a, b in zip(tree_leaves(whole), ref_grads):
        pp_ok = pp_ok and float((a - b).abs().max()) < 1e-4
    step2 = make_pp_device_train_step(
        pp_cfg, pp_mesh, Bpp, n_microbatches=2, base_lr=1e-3, min_lr=1e-4,
        warmup=10, max_steps=100, weight_decay=0.0)
    gen = torch.Generator(device=dev).manual_seed(0)
    rpp, _, _, pp_train_loss = step2(rpp, [adamw_init(p) for p in rpp],
                                     ids(512), gen)
    moved = float((rpp[0]["tok_W"] - pp_params["tok_W"]).abs().max())
    pp_ok = pp_ok and bool(torch.isfinite(pp_train_loss)) and moved > 0

    ep = min(n_devices, 4)
    ep_dp = n_devices // ep
    ep_mesh = make_mesh((ep_dp, ep), ("dp", "ep"), devices)
    ep_cfg = MoEGPTConfig(vocab_size=37, d_model=32, n_heads=4, n_layers=2,
                          d_ff=64, ctx_len=16, n_experts=ep)
    ep_params = init_moe_params(ep_cfg, seed=0, device=dev)
    Bep = 2 * ep_dp
    xep, yep = ids(Bep, 16), ids(Bep, 16)
    with torch.no_grad():
        ref_ep = float(moe_gpt_loss(ep_params, xep, yep, ep_cfg))
    rep = shard_tree(ep_params, moe_param_specs(ep_cfg), ep_mesh)
    _, _, ep_loss = make_ep_train_step(ep_cfg, ep_mesh, dp_axis="dp")(
        rep, [adamw_init(p) for p in rep], xep, yep)
    ep_ok = abs(float(ep_loss) - ref_ep) < 1e-4

    # tensor-parallel serving over a (1, tp) mesh: greedy tokens equal to
    # the unsharded engine's, GQA grouping included
    from ..serve.engine import Request, ServeEngine

    sv_tp = min(n_devices, 4)
    sv_mesh = make_mesh((1, sv_tp), ("dp", "tp"), devices[:sv_tp])
    sv_cfg = GPTConfig(vocab_size=37, d_model=32, n_heads=4, n_layers=2,
                       ctx_len=32, n_kv_heads=2, pos="rope")
    sv_params = init_gpt_params(sv_cfg, seed=0, device=dev)

    def served(mesh_arg):
        eng = ServeEngine(sv_params, sv_cfg, n_slots=2, chunk=4, top_k=1,
                          mesh=mesh_arg, device=dev)
        rids = [eng.submit(Request(p, 6)) for p in ([1, 2, 3],
                                                     [4, 5, 6, 7, 8])]
        done = {c.request_id: c.tokens for c in eng.run()}
        return [done[i] for i in rids]

    sv_ok = served(sv_mesh) == served(None)

    fs_mesh = make_mesh((n_devices,), ("fsdp",), devices)
    fs_cfg = GPTConfig(vocab_size=37, d_model=64, n_heads=4, n_layers=2,
                       d_ff=256, ctx_len=16)
    fs_params = init_gpt_params(fs_cfg, seed=0, device=dev)
    fs_specs = fsdp_param_specs(fs_params, n_devices)
    rfs = shard_tree(fs_params, fs_specs, fs_mesh)
    fs_step = make_fsdp_device_train_step(
        fs_cfg, fs_mesh, fs_params, 2 * n_devices, base_lr=1e-3,
        min_lr=1e-4, warmup=10, max_steps=100, weight_decay=0.0)
    gen = torch.Generator(device=dev).manual_seed(0)
    rfs, _, _, fs_loss = fs_step(rfs, [adamw_init(p) for p in rfs],
                                 ids(512), gen)
    w1 = rfs[0]["layers"]["W1"]
    fs_ok = (bool(torch.isfinite(fs_loss))
             and w1.numel() * n_devices == fs_params["layers"]["W1"].numel()
             and float((unshard_tree(rfs, fs_specs, fs_mesh)["tok_W"]
                        - fs_params["tok_W"]).abs().max()) > 0)

    print(f"dryrun_multichip ok: mesh dp={dp} tp={tp}, one train step, "
          f"loss={float(loss):.4f} {'ok' if tp_ok else 'MISMATCH'}; "
          f"pipeline dp={pp_dp} pp={pp} {'ok' if pp_ok else 'MISMATCH'}; "
          f"moe dp={ep_dp} ep={ep} {'ok' if ep_ok else 'MISMATCH'}; "
          f"tp-serving tp={sv_tp} {'ok' if sv_ok else 'MISMATCH'}; "
          f"fsdp={n_devices} {'ok' if fs_ok else 'MISMATCH'}")
    assert tp_ok, "dp x tp loss mismatch vs unsharded"
    assert pp_ok, "pipeline-parallel loss/grads mismatch vs unsharded"
    assert ep_ok, "expert-parallel loss mismatch vs unsharded"
    assert sv_ok, "tp-serving tokens mismatch vs unsharded engine"
    assert fs_ok, "fsdp step failed (loss/sharded-storage/update)"
