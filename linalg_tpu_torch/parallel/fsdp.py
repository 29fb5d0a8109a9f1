"""Fully-sharded data parallelism (ZeRO-3 style) over one mesh axis — the
counterpart of ``linalg_tpu/parallel/fsdp.py``.

Plain data parallelism replicates parameters and optimizer state on every
rank. FSDP shards the STORAGE of every large parameter leaf (and so its
AdamW m/v moments and its gradient) over the same axis the batch is split
over: each rank keeps 1/N of it. The step, per rank and explicitly where
the JAX package lets GSPMD insert the collectives:

- forward: all-gather a layer's weight shards right where that layer runs
  (cast to the compute dtype first), so one layer's whole weights are
  gathered at a time; the embedding and head leaves are gathered once;
- backward: the all-gather's adjoint reduce-scatters each gradient
  straight back to the sharded layout (the data-parallel mean and the
  re-shard in one collective); replicated small leaves are all-reduced;
- update: AdamW on the local shard, no communication.

Each rank runs the whole model on its B/N rows (attention through
``make_sharded_attn`` with heads replicated: K2 at T >= 512 on the card;
``_pick_fused`` opens K8/K9 on the gathered square weights). Autograd
keeps each gathered layer's weights until its backward; on one card the
ranks share one gathered copy.
"""

from __future__ import annotations

import math

from ..models.gpt import (GPTConfig, _embed, _hidden_loss, _layer,
                          _pick_fused)
from .mesh import all_gather
from .sharding import (_device_eval, _device_step, _each, _first,
                       _loss_and_grads, _mean_loss, _split_batch,
                       make_sharded_attn)

__all__ = ["fsdp_param_specs", "fsdp_shardings",
           "make_fsdp_device_train_step", "make_fsdp_eval"]


def _leaf_spec(shape, n: int, axis: str, min_elems: int) -> tuple:
    """Shard the largest dimension divisible by ``n``; replicate leaves
    that are too small to be worth a gather (LN scales, biases) or have
    no divisible dim (e.g. a 65-row char vocab embedding's row axis: its
    d_model column axis shards instead). Ties prefer the earlier
    dimension, as the JAX rule does."""
    if math.prod(shape) < min_elems:
        return ()
    best_dim, best_size = None, 0
    for i, s in enumerate(shape):
        if s % n == 0 and s > best_size:
            best_dim, best_size = i, s
    if best_dim is None:
        return ()
    entries = [None] * len(shape)
    entries[best_dim] = axis
    return tuple(entries)


def fsdp_param_specs(params, n: int, *, axis: str = "fsdp",
                     min_elems: int = 2 ** 14):
    """Spec tree sharding every large leaf of ``params`` over ``axis``
    (mesh size ``n``), from leaf SHAPES: GQA's narrower Wk/Wv, MoE expert
    stacks and learned positions shard without special cases."""
    if isinstance(params, dict):
        return {k: fsdp_param_specs(v, n, axis=axis, min_elems=min_elems)
                for k, v in params.items()}
    return _leaf_spec(tuple(params.shape), n, axis, min_elems)


def fsdp_shardings(params, mesh, *, axis: str = "fsdp"):
    """The spec tree of ``params`` over ``mesh``'s fsdp axis."""
    return fsdp_param_specs(params, mesh.shape[axis], axis=axis)


def _gathered(rank_leaves, spec, mesh, axis, dt):
    """Per-rank whole tensors of one leaf in the compute dtype ``dt``: the
    shards cast and all-gathered, or each rank's own copy of a replicated
    leaf."""
    cast = _each(lambda w: w.to(dt), rank_leaves)
    if axis not in spec:
        return cast
    return all_gather(cast, mesh, axis, dim=spec.index(axis))


def _fsdp_loss(cfg: GPTConfig, mesh, specs, axis: str = "fsdp"):
    """``loss(rank_params, x, y)``: each rank's forward on its B/N rows
    with its layers gathered one at a time; the mean CE over the batch."""
    attn = make_sharded_attn(mesh, cfg.ctx_len, cfg.d_head, batch_axis=axis,
                             head_axis=None, cfg=cfg)
    locals_ = [attn.local(c) for c in mesh.coords]
    lspecs = specs["layers"]

    def loss(rank_params, x, y):
        xs, ys = _split_batch(x, mesh, axis), _split_batch(y, mesh, axis)
        B, T = _first(xs).shape
        dt = cfg.compute_dtype
        fused = (cfg.kv_heads == cfg.n_heads
                 and _pick_fused(B, T, cfg, _first(xs).device.type))
        # the embedding/head leaves (float32 masters: the head casts), and
        # layer leaves split along the layer axis, are gathered once
        top = _each(lambda p: {}, rank_params)
        for k, spec in specs.items():
            if k == "layers":
                continue
            vals = _gathered(_each(lambda p: p[k], rank_params), spec, mesh,
                             axis, _first(rank_params)[k].dtype)
            for t, v in zip(top, vals):
                if t is not None:
                    t[k] = v
        whole = {k: _gathered(_each(lambda p: p["layers"][k], rank_params),
                              s, mesh, axis, dt)
                 for k, s in lspecs.items() if s and s[0] == axis}
        emb = _each(lambda t, xx: _embed(t, xx, cfg, T, dt), top, xs)
        hs = _each(lambda e: e[0], emb)
        for li in range(cfg.n_layers):
            lps = _each(lambda p: {}, rank_params)
            for k, s in lspecs.items():
                if k in whole:
                    vals = _each(lambda w: w[li], whole[k])
                elif s:  # a layer's slice, gathered where it is used
                    vals = all_gather(
                        _each(lambda p: p["layers"][k][li].to(dt),
                              rank_params),
                        mesh, axis, dim=s.index(axis) - 1)
                else:
                    vals = _each(lambda p: p["layers"][k][li].to(dt),
                                 rank_params)
                for lp, v in zip(lps, vals):
                    if lp is not None:
                        lp[k] = v
            hs = _each(lambda h, lp, at, e: _layer(
                h, lp, None, cfg.n_heads, cfg.kv_heads, cfg.ffn, at, e[1],
                fused)[0], hs, lps, locals_, emb)
        losses = _each(lambda t, h, yy: _hidden_loss(t, h, yy, cfg), top,
                       hs, ys)
        return _mean_loss(losses, mesh, mesh.shape[axis])

    return loss


def make_fsdp_device_train_step(cfg: GPTConfig, mesh, params,
                                batch_size: int, *, base_lr: float,
                                min_lr: float, warmup: int, max_steps: int,
                                weight_decay: float,
                                lr_embed_scale: float = 1.0,
                                lr_head_scale: float = 1.0,
                                clip_norm: float = 0.0):
    """The trainer's FSDP step over a ('fsdp',) mesh: ``step(rank_params,
    rank_opt, data_ids, generator) -> (rank_params, rank_opt, generator,
    loss)``, parameters AND moments stored sharded (``rank_params`` =
    ``shard_tree(params, fsdp_param_specs(params, N), mesh)``). ``params``
    is only read for leaf shapes."""
    if batch_size % mesh.shape["fsdp"]:
        raise ValueError("batch_size must divide by fsdp")
    specs = fsdp_shardings(params, mesh)
    return _device_step(
        _loss_and_grads(_fsdp_loss(cfg, mesh, specs), specs, mesh), specs,
        mesh, batch_size, cfg.ctx_len, base_lr=base_lr, min_lr=min_lr,
        warmup=warmup, max_steps=max_steps, weight_decay=weight_decay,
        lr_embed_scale=lr_embed_scale, lr_head_scale=lr_head_scale,
        clip_norm=clip_norm)


def make_fsdp_eval(cfg: GPTConfig, mesh, params, batch: int, batches: int):
    """``evaluate(rank_params, val_ids, generator)``: the mean FSDP loss
    over ``batches`` windows, parameters staying sharded."""
    return _device_eval(_fsdp_loss(cfg, mesh, fsdp_shardings(params, mesh)),
                        batch, batches, cfg.ctx_len)
