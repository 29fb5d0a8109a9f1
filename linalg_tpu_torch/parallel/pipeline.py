"""Pipeline parallelism over a 'pp' mesh axis: the GPipe and 1F1B
microbatch schedules — the counterpart of
``linalg_tpu/parallel/pipeline.py``.

The layer stack (L, ...) is split over 'pp': stage s owns layers
[s L/S, (s+1) L/S). Embeddings and the weight-tied head are replicated:
stage 0 consumes the embedding, the last stage the head, and the sum of
the copies' gradients over 'pp' merges their tok_W contributions (the
JAX package's psum). The batch may be split over 'dp' too.

- GPipe (``make_pp_loss``, ``make_pp_train_step``, ``make_pp_eval``): at
  tick t, stage s runs microbatch t - s and hands its output to stage s+1
  with ``ppermute``; the last stage takes the CE of each microbatch as it
  retires. All M microbatches drain in M + S - 1 ticks, and autograd runs
  the mirrored schedule backward (a ppermute's adjoint is the reverse
  permutation).
- 1F1B (``make_pp_1f1b_grads``, ``make_pp_1f1b_train_step``,
  ``make_pp_device_train_step``): every tick has an explicit forward slot
  (stage s forwards microbatch t - s, under ``no_grad``, stashing its
  input in a ring of 2S - 1) and backward slot (stage s backwards
  microbatch t - (2S - 2 - s): its forward recomputed from the stash under
  ``torch.autograd.grad``, cotangents handed down with ``ppermute``); it
  drains in M + 2S - 2 ticks and keeps O(S) stage inputs, not O(M).

Where the JAX package runs every stage every tick and masks the idle slots
and the head of the non-last stages (an SPMD program is uniform), the
port skips them; no number changes. Layers run through the single-card
attention pick (``_pick_attn_cfg``: K2 at 512 <= T <= 1024 on the card);
as in the JAX package the pipeline takes neither K7 nor K8/K9.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.gpt import (GPTConfig, _embed, _head, _layer, _layer_params,
                          _pick_attn_cfg, _rope, _trunk_mask)
from .mesh import ppermute
from .sharding import (_const_step, _device_eval, _device_step, _each,
                       _first, _loss_and_grads, _mean_loss, _reduce_grads,
                       _split_batch)

__all__ = ["pp_param_specs", "make_pp_loss", "make_pp_train_step",
           "make_pp_1f1b_grads", "make_pp_1f1b_train_step",
           "make_pp_device_train_step", "make_pp_eval"]


def pp_param_specs(dp: Optional[str] = None) -> dict:
    """Spec tree of the GPT parameters under pipeline parallelism: the
    stacked layer axis split over 'pp', embeddings and head replicated.
    As in the JAX package it names the ReLU/GELU layer's leaves only."""
    layer = {k: ("pp", None) for k in ("ln1_g", "ln1_b", "ln2_g", "ln2_b",
                                       "b1", "b2")}
    layer.update({k: ("pp", None, None)
                  for k in ("Wq", "Wk", "Wv", "Wo", "W1", "W2")})
    return {"tok_W": (), "head_b": (), "layers": layer}


def _check(cfg: GPTConfig, mesh):
    if cfg.n_layers % mesh.shape["pp"]:
        raise ValueError("n_layers must divide by the pp axis size")


def _run_stage(cfg, p, h, mask, attn_fn, rope):
    dt = cfg.compute_dtype
    for lp in _layer_params(p, dt):
        h, _ = _layer(h, lp, mask, cfg.n_heads, cfg.kv_heads, cfg.ffn,
                      attn_fn, rope)
    return h


def _ce_sum(p, h, yb, dt):
    logits = _head(p, h, dt)
    gold = torch.gather(logits, -1, yb[..., None].long())[..., 0]
    return torch.sum(torch.logsumexp(logits, dim=-1) - gold)


def _microbatches(x, mesh, dp_axis, M):
    xs = _split_batch(x, mesh, dp_axis)
    if _first(xs).shape[0] % M:
        raise ValueError(f"each rank's batch {_first(xs).shape[0]} must "
                         f"divide into {M} microbatches")
    return _each(lambda t: t.chunk(M), xs)


def make_pp_loss(cfg: GPTConfig, mesh, n_microbatches: int, *,
                 dp_axis: Optional[str] = None):
    """``loss(rank_params, x, y)`` over a pipeline mesh (GPipe): the global
    mean CE, differentiable (autograd runs the mirrored schedule).
    ``mesh`` has a 'pp' axis whose size divides cfg.n_layers; the global
    batch divides by n_microbatches (times dp if given)."""
    _check(cfg, mesh)
    M = n_microbatches
    S = mesh.shape["pp"]
    stage = [c["pp"] for c in mesh.coords]
    up = [(i, i + 1) for i in range(S - 1)]
    dp = mesh.shape[dp_axis] if dp_axis else 1

    def loss(rank_params, x, y):
        x_mb = _microbatches(x, mesh, dp_axis, M)
        y_mb = _microbatches(y, mesh, dp_axis, M)
        mb, T = _first(x_mb)[0].shape
        dt = cfg.compute_dtype
        dev = _first(x_mb)[0].device
        attn_fn = _pick_attn_cfg(cfg, cfg.ctx_len, dev.type)
        devs = {mesh.rank_devices[r] for r in mesh.local_ranks}
        masks = {d: _trunk_mask(cfg, T, dt, d) for d in devs}
        ropes = {d: _rope(cfg, T, dt, d) for d in devs}
        state = [None] * mesh.size
        ce = [None] * mesh.size
        for t in range(M + S - 1):
            out = [None] * mesh.size
            for r, p in enumerate(rank_params):
                m = t - stage[r]
                if p is None or not 0 <= m < M:
                    continue
                d = mesh.rank_devices[r]
                h = (_embed(p, x_mb[r][m], cfg, T, dt)[0] if stage[r] == 0
                     else state[r])
                h = _run_stage(cfg, p, h, masks[d], attn_fn, ropes[d])
                if stage[r] == S - 1:
                    c = _ce_sum(p, h, y_mb[r][m], dt)
                    ce[r] = c if ce[r] is None else ce[r] + c
                else:
                    out[r] = h
            state = ppermute(out, mesh, "pp", up)
        return _mean_loss(ce, mesh, dp * M * mb * T)

    return loss


def make_pp_train_step(cfg: GPTConfig, mesh, n_microbatches: int, *,
                       lr: float = 3e-4, weight_decay: float = 0.01,
                       dp_axis: Optional[str] = None):
    """``step(rank_params, rank_opt, x, y) -> (rank_params, rank_opt,
    loss)``: the GPipe loss, its gradients through the schedule (the
    replicated leaves' summed over the stages and dp), AdamW at a
    constant lr."""
    specs = pp_param_specs(dp_axis)
    return _const_step(_loss_and_grads(make_pp_loss(
        cfg, mesh, n_microbatches, dp_axis=dp_axis), specs, mesh), specs,
        mesh, lr, weight_decay)


def make_pp_1f1b_grads(cfg: GPTConfig, mesh, n_microbatches: int, *,
                       dp_axis: Optional[str] = None):
    """``fn(rank_params, x, y) -> (loss, per-rank grads)`` by the explicit
    1F1B schedule (O(S) stage inputs kept; see the module docstring):
    layer grads summed over dp, tok_W/head_b over dp and the stages."""
    _check(cfg, mesh)
    M = n_microbatches
    S = mesh.shape["pp"]
    R = 2 * S - 1  # ring slots: the fwd -> bwd distance at stage 0 is 2S-2
    stage = [c["pp"] for c in mesh.coords]
    up = [(i, i + 1) for i in range(S - 1)]
    down = [(i + 1, i) for i in range(S - 1)]
    dp = mesh.shape[dp_axis] if dp_axis else 1
    specs = pp_param_specs(dp_axis)

    def fn(rank_params, x, y):
        x_mb = _microbatches(x, mesh, dp_axis, M)
        y_mb = _microbatches(y, mesh, dp_axis, M)
        mb, T = _first(x_mb)[0].shape
        n_tok = dp * M * mb * T
        dt = cfg.compute_dtype
        dev = _first(x_mb)[0].device
        attn_fn = _pick_attn_cfg(cfg, cfg.ctx_len, dev.type)
        devs = {mesh.rank_devices[r] for r in mesh.local_ranks}
        masks = {d: _trunk_mask(cfg, T, dt, d) for d in devs}
        ropes = {d: _rope(cfg, T, dt, d) for d in devs}
        # stage inputs, outputs and cotangents travel in float32, as the
        # JAX buffers do (or in the compute dtype when it is wider)
        buf = torch.promote_types(torch.float32, dt)
        # the ring of stashed stage inputs
        stash = [[None] * R for _ in rank_params]
        names = _each(lambda p: list(p["layers"]), rank_params)
        grads = _each(lambda p: {
            "tok_W": torch.zeros_like(p["tok_W"]),
            "head_b": torch.zeros_like(p["head_b"]),
            "layers": {k: torch.zeros_like(w)
                       for k, w in p["layers"].items()}}, rank_params)
        ce_sum = [None] * mesh.size
        state_f = [None] * mesh.size
        state_b = [None] * mesh.size

        def stage_fwd(r, p, h_in, m):
            """(stage output in ``buf``, the CE sum at the last stage, else
            None)."""
            d = mesh.rank_devices[r]
            h = _run_stage(cfg, p, h_in.to(dt), masks[d], attn_fn, ropes[d])
            ce = (_ce_sum(p, h, y_mb[r][m], dt) if stage[r] == S - 1
                  else None)
            return h.to(buf), ce

        def embed(p, ids):
            return _embed(p, ids, cfg, T, buf)[0]

        for t in range(M + 2 * S - 2):
            # forward slots: microbatch t - stage
            fwd_out = [None] * mesh.size
            with torch.no_grad():
                for r, p in enumerate(rank_params):
                    m = t - stage[r]
                    if p is None or not 0 <= m < M:
                        continue
                    h_in = (embed(p, x_mb[r][m]) if stage[r] == 0
                            else state_f[r])
                    stash[r][m % R] = h_in
                    if stage[r] < S - 1:  # the last stage's runs in its
                        fwd_out[r] = stage_fwd(r, p, h_in, m)[0]  # bwd slot
            state_f = ppermute(fwd_out, mesh, "pp", up)

            # backward slots: microbatch t - (2S - 2 - stage)
            bwd_out = [None] * mesh.size
            for r, p in enumerate(rank_params):
                m = t - (2 * S - 2 - stage[r])
                if p is None or not 0 <= m < M:
                    continue
                h = stash[r][m % R].detach().requires_grad_(True)
                stash[r][m % R] = None
                ws = ([p["layers"][k] for k in names[r]]
                      + ([p["tok_W"], p["head_b"]] if stage[r] == S - 1
                         else []))
                with torch.enable_grad():
                    for w in ws:
                        w.requires_grad_(True)
                    h_out, ce = stage_fwd(r, p, h, m)
                    if stage[r] == S - 1:
                        gs = torch.autograd.grad(ce / n_tok, ws + [h],
                                                 allow_unused=True)
                        c = ce.detach() / n_tok
                        ce_sum[r] = c if ce_sum[r] is None else ce_sum[r] + c
                    else:
                        gs = torch.autograd.grad(h_out, ws + [h],
                                                 grad_outputs=state_b[r],
                                                 allow_unused=True)
                g = grads[r]
                for k, gw in zip(names[r], gs):
                    if gw is not None:
                        g["layers"][k] += gw
                if stage[r] == S - 1:
                    n = len(names[r])
                    for k, gw in (("tok_W", gs[n]), ("head_b", gs[n + 1])):
                        if gw is not None:
                            g[k] += gw
                gH = gs[-1]
                if stage[r] == 0:  # the embedding's gradient from the ids
                    g["tok_W"].index_add_(0, x_mb[r][m].reshape(-1),
                                          gH.reshape(-1, gH.shape[-1]))
                else:
                    bwd_out[r] = gH
            state_b = ppermute(bwd_out, mesh, "pp", down)

        loss = _mean_loss(ce_sum, mesh, 1)
        for p in filter(None, rank_params):
            for w in [p["tok_W"], p["head_b"], *p["layers"].values()]:
                w.requires_grad_(False)
        return loss, _reduce_grads(grads, specs, mesh)

    return fn


def make_pp_1f1b_train_step(cfg: GPTConfig, mesh, n_microbatches: int, *,
                            lr: float = 3e-4, weight_decay: float = 0.01,
                            dp_axis: Optional[str] = None):
    """``step(rank_params, rank_opt, x, y) -> (rank_params, rank_opt,
    loss)`` on the 1F1B schedule's gradients, AdamW at a constant lr."""
    return _const_step(make_pp_1f1b_grads(cfg, mesh, n_microbatches,
                                          dp_axis=dp_axis),
                       pp_param_specs(dp_axis), mesh, lr, weight_decay)


def make_pp_device_train_step(cfg: GPTConfig, mesh, batch_size: int, *,
                              n_microbatches: int, base_lr: float,
                              min_lr: float, warmup: int, max_steps: int,
                              weight_decay: float,
                              lr_embed_scale: float = 1.0,
                              lr_head_scale: float = 1.0,
                              clip_norm: float = 0.0):
    """The trainer's pipeline step over a (dp, pp) mesh (the JAX package's
    takes 1F1B too): ``step(rank_params, rank_opt, data_ids, generator)
    -> (rank_params, rank_opt, generator, loss)``."""
    return _device_step(
        make_pp_1f1b_grads(cfg, mesh, n_microbatches, dp_axis="dp"),
        pp_param_specs("dp"),
        mesh, batch_size, cfg.ctx_len, base_lr=base_lr, min_lr=min_lr,
        warmup=warmup, max_steps=max_steps, weight_decay=weight_decay,
        lr_embed_scale=lr_embed_scale, lr_head_scale=lr_head_scale,
        clip_norm=clip_norm)


def make_pp_eval(cfg: GPTConfig, mesh, batch: int, batches: int, *,
                 n_microbatches: int):
    """``evaluate(rank_params, val_ids, generator)``: the GPipe
    forward-only loss (the cheaper schedule without a backward), mean over
    ``batches`` windows."""
    return _device_eval(make_pp_loss(cfg, mesh, n_microbatches, dp_axis="dp"),
                        batch, batches, cfg.ctx_len)

