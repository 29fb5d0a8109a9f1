"""Sequence-parallel GPT training — the sp subset of
``linalg_tpu/parallel/sharding.py``.

Context parallelism: the batch is split over (dp, sp) and every
activation carries its T axis split over ``sp``; the LayerNorms, the FFN
and the embeddings are pointwise over T, and attention runs the ring
(``parallel.ring``, or the ring kernels K10/K11 through
``parallel.ring_pallas`` with ``pallas=True``). Parameters are replicated.
In the JAX package GSPMD shards the pointwise ops over the devices; here
the mesh's ranks share one device, so the pointwise ops run on the whole
batch there and only attention is split into ranks. The dp x tp steps
(``make_sharded_*``) are ROADMAP.md queue 1, item 7.

Steps take the trainer's contract: windows drawn on the parameters'
device from a ``torch.Generator``, so an sp run draws the batches of the
single-device run with the same seed.
"""

from __future__ import annotations

from ..models.gpt import GPTConfig
from ..nn.positional import alibi_slopes
from ..train.optim import adamw_update, gpt_wd_mask
from ..train.trainer import (_eval_device, _value_and_grad,
                             make_device_train_step)
from .ring import make_ring_attention
from .ring_pallas import make_ring_attention_pallas

__all__ = ["make_sp_train_step", "make_sp_device_train_step", "make_sp_eval"]


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
