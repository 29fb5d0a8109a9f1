"""Expert parallelism: the MoE expert weights split over an 'ep' mesh axis —
the counterpart of ``linalg_tpu/parallel/expert.py``.

The MoE layer (``models.moe``) keeps its routing as dense einsums over an
explicit expert axis; the JAX package shards that axis and lets GSPMD
lower the dispatch/combine einsums into all-to-alls. Here each (dp, ep)
rank routes its dp rank's batch over all E experts (the router is
replicated), dispatches it to its own E/ep experts, and combines their
outputs: its share of the combine, which an all-reduce over 'ep' sums.
The load-balance loss takes the router statistics of the whole batch (an
all-reduce mean over 'dp'), as the unsplit batch gives them. Attention,
the router and the embeddings are replicated; attention runs
``make_sharded_attn(head_axis=None)`` (K2 at T >= 512 on the card) and
``_pick_fused`` opens K8 for it. Composes with data parallelism over a
('dp', 'ep') mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models.gpt import _attn_half, _embed, _layer_params, _pick_fused
from ..models.moe import MoEGPTConfig, _capacity, _head, moe_ffn
from ..nn.functional import layer_norm
from .mesh import all_reduce
from .sharding import (_const_step, _device_eval, _device_step, _each,
                       _first, _loss_and_grads, _mean_loss, _split_batch,
                       make_sharded_attn)

__all__ = ["moe_param_specs", "make_ep_train_step",
           "make_ep_device_train_step", "make_ep_eval"]


def moe_param_specs(cfg=None) -> dict:
    """Spec tree of the MoE-GPT parameters: the expert axis (axis 1 of the
    (L, E, ...) stacked expert weights) split over 'ep'; attention, router
    and embeddings replicated."""
    ex = (None, "ep", None, None)
    layer_specs = {
        "ln1_g": (), "ln1_b": (), "Wq": (), "Wk": (), "Wv": (), "Wo": (),
        "ln2_g": (), "ln2_b": (), "Wr": (),
        "W1": ex, "b1": (None, "ep", None), "W2": ex, "b2": (None, "ep", None),
    }
    if cfg is not None and getattr(cfg, "gated_ffn", False):
        layer_specs["Wg"] = ex
        layer_specs["bg"] = (None, "ep", None)
    specs = {"tok_W": (), "head_b": (), "layers": layer_specs}
    if cfg is not None and getattr(cfg, "pos", None) == "learned":
        specs["pos_W"] = ()
    return specs


def _einsum_cfg(cfg: MoEGPTConfig) -> MoEGPTConfig:
    """The ep steps keep the dense-dispatch einsums, whose expert axis
    splits cleanly (the JAX package's reason: gathers across a sharded
    expert axis lower to much worse collectives)."""
    return cfg if cfg.dispatch == "einsum" else dataclasses.replace(
        cfg, dispatch="einsum")


def _ep_loss(cfg: MoEGPTConfig, mesh, attn, dp_axis: Optional[str]):
    """``loss(rank_params, x, y)``: the dp x ep MoE forward, the global
    mean CE plus ``aux_weight`` times the layers' mean load-balance loss
    (differentiable)."""
    ep = mesh.shape["ep"]
    if cfg.n_experts % ep:
        raise ValueError("n_experts must divide by the ep axis size")
    El = cfg.n_experts // ep
    dp = mesh.shape[dp_axis] if dp_axis else 1
    locals_ = [attn.local(c) for c in mesh.coords]

    def loss(rank_params, x, y):
        xs, ys = _split_batch(x, mesh, dp_axis), _split_batch(y, mesh, dp_axis)
        B, T = _first(xs).shape
        dt = cfg.compute_dtype
        fused = _pick_fused(B, T, cfg, _first(xs).device.type)
        cap = _capacity(cfg, T)
        emb = _each(lambda p, xx: _embed(p, xx, cfg, T, dt), rank_params, xs)
        hs = _each(lambda e: e[0], emb)
        layers = _each(lambda p: _layer_params(p, dt), rank_params)
        auxes = _each(lambda p: [], rank_params)
        for li in range(cfg.n_layers):
            h1s, parts, stats = [], [], []
            for h, lay, at, e, c in zip(hs, layers, locals_, emb,
                                        mesh.coords):
                if h is None:
                    h1s.append(None)
                    parts.append(None)
                    stats.append(None)
                    continue
                lp = lay[li]
                a, _ = _attn_half(h, lp, None, cfg.n_heads, cfg.kv_heads, at,
                                  e[1], fused)
                h1 = h + a
                out, (f, P) = moe_ffn(
                    layer_norm(h1, lp["ln2_g"], lp["ln2_b"]), lp["Wr"],
                    lp["W1"], lp["b1"], lp["W2"], lp["b2"], cap,
                    cfg.router_top_k, "einsum", Wg=lp.get("Wg"),
                    bg=lp.get("bg"), ffn=cfg.ffn,
                    expert_offset=c["ep"] * El, stats=True)
                h1s.append(h1)
                parts.append(out)
                stats.append(torch.cat([f, P]))
            f_sum = all_reduce(parts, mesh, "ep")
            if dp_axis:
                stats = all_reduce(stats, mesh, dp_axis, "mean")
            for r, s in enumerate(stats):
                if s is not None:
                    auxes[r].append(cfg.n_experts * torch.sum(
                        s[:cfg.n_experts] * s[cfg.n_experts:]))
            hs = _each(torch.add, h1s, f_sum)
        losses = []
        for p, h, yy, c, aux in zip(rank_params, hs, ys, mesh.coords, auxes):
            if p is None or c["ep"]:
                losses.append(None)
                continue
            logits = _head(p, h, dt)
            gold = torch.gather(logits, -1, yy[..., None].long())[..., 0]
            ce = torch.mean(torch.logsumexp(logits, dim=-1) - gold)
            losses.append(ce + cfg.aux_weight * torch.stack(aux).mean())
        return _mean_loss(losses, mesh, dp)

    return loss


def make_ep_train_step(cfg: MoEGPTConfig, mesh, *, lr: float = 3e-4,
                       weight_decay: float = 0.01,
                       dp_axis: Optional[str] = None):
    """``step(rank_params, rank_opt, x, y) -> (rank_params, rank_opt,
    loss)`` with the experts split over 'ep' (and the batch over
    ``dp_axis`` when given), AdamW at a constant lr. Attention is the
    single-card pick on each rank, as the JAX step's default."""
    cfg = _einsum_cfg(cfg)
    attn = make_sharded_attn(mesh, cfg.ctx_len, cfg.d_head,
                             batch_axis=dp_axis, head_axis=None, cfg=cfg)
    specs = moe_param_specs(cfg)
    return _const_step(_loss_and_grads(_ep_loss(cfg, mesh, attn, dp_axis),
                                       specs, mesh), specs, mesh, lr,
                       weight_decay)


def make_ep_device_train_step(cfg: MoEGPTConfig, mesh, batch_size: int, *,
                              base_lr: float, min_lr: float, warmup: int,
                              max_steps: int, weight_decay: float,
                              lr_embed_scale: float = 1.0,
                              lr_head_scale: float = 1.0,
                              clip_norm: float = 0.0):
    """The trainer's dp x ep MoE step: ``step(rank_params, rank_opt,
    data_ids, generator) -> (rank_params, rank_opt, generator, loss)``,
    windows drawn on the corpus's device and split over dp."""
    cfg = _einsum_cfg(cfg)
    if batch_size % mesh.shape["dp"]:
        raise ValueError("batch_size must divide by dp")
    attn = make_sharded_attn(mesh, cfg.ctx_len, cfg.d_head, head_axis=None,
                             cfg=cfg)
    specs = moe_param_specs(cfg)
    return _device_step(
        _loss_and_grads(_ep_loss(cfg, mesh, attn, "dp"), specs, mesh), specs,
        mesh, batch_size, cfg.ctx_len, base_lr=base_lr, min_lr=min_lr,
        warmup=warmup, max_steps=max_steps, weight_decay=weight_decay,
        lr_embed_scale=lr_embed_scale, lr_head_scale=lr_head_scale,
        clip_norm=clip_norm)


def make_ep_eval(cfg: MoEGPTConfig, mesh, batch: int, batches: int):
    """``evaluate(rank_params, val_ids, generator)``: the mean dp x ep loss
    over ``batches`` windows, one device scalar."""
    cfg = _einsum_cfg(cfg)
    attn = make_sharded_attn(mesh, cfg.ctx_len, cfg.d_head, head_axis=None,
                             cfg=cfg)
    return _device_eval(_ep_loss(cfg, mesh, attn, "dp"), batch, batches,
                        cfg.ctx_len)
