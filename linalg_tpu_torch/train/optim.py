"""AdamW from scratch and LR schedules — the counterpart of
``linalg_tpu/train/optim.py``.

Decoupled weight decay ``p -= lr*wd*p`` before the moment update, betas
(0.9, 0.95), bias correction, per-parameter weight-decay rules (decay on
matmul weights, none on LayerNorm/embedding/bias), per-parameter lr
scales, optional global-norm clipping. Parameters and moments are nested
dicts of tensors with the JAX package's keys. Where the JAX update returns
new arrays, ``adamw_update`` updates the parameters and moments IN PLACE
under ``torch.no_grad()`` (no second copy of the model and its moments)
and returns them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

__all__ = ["AdamWState", "adamw_init", "adamw_update", "clip_by_global_norm",
           "gpt_wd_mask", "gpt_lr_scales", "warmup_cosine", "tree_leaves",
           "tree_map", "tree_zip"]

_DECAY_KEYS = {"Wq", "Wk", "Wv", "Wo", "W1", "W2", "Wg"}


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (the parameter layout)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_zip(tree, *rest) -> List[Tuple]:
    """Tuples of corresponding leaves, matched by key, in ``tree``'s
    order."""
    if isinstance(tree, dict):
        return [t for k, v in tree.items()
                for t in tree_zip(v, *(r[k] for r in rest))]
    return [(tree, *rest)]


def tree_leaves(tree) -> List[Any]:
    """Leaves of nested dicts in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def _map_named(fn: Callable[[str], Any], tree):
    """{..., key: fn(key)} over the leaves, by each leaf's own key."""
    return {k: _map_named(fn, v) if isinstance(v, dict) else fn(k)
            for k, v in tree.items()}


def clip_by_global_norm(grads, max_norm: float, norm=None):
    """Scale the gradients so their global L2 norm is <= ``max_norm``.

    Returns (clipped, global_norm); the norm and the scale are float32
    whatever the gradients' dtype, and neither leaves the device. A
    sharded caller passes ``norm``, the norm of the whole gradient its
    shards belong to."""
    if norm is None:
        norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-12), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), norm


@dataclasses.dataclass
class AdamWState:
    m: Dict[str, Any]
    v: Dict[str, Any]
    t: int  # updates taken so far


def adamw_init(params) -> AdamWState:
    return AdamWState(m=tree_map(torch.zeros_like, params),
                      v=tree_map(torch.zeros_like, params), t=0)


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, lr: float, wd_tree,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 lr_scales=None, clip_norm: float = 0.0, grad_norm=None
                 ) -> Tuple[Any, AdamWState]:
    """One AdamW step, in place. ``wd_tree`` holds per-leaf weight-decay
    coefficients, ``lr_scales`` optional per-leaf lr multipliers (both
    nested dicts of floats shaped like ``params``); ``clip_norm`` > 0 clips
    the gradients to that global norm first (``grad_norm``: the global
    norm when ``grads`` are one rank's shards of it). Returns (params,
    state), the same objects, updated."""
    if clip_norm > 0.0:
        grads, _ = clip_by_global_norm(grads, clip_norm, grad_norm)
    t = state.t + 1
    # the JAX package forms the bias corrections in float32
    c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(t))
    c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(t))
    if lr_scales is None:
        lr_scales = tree_map(lambda _: 1.0, params)
    for p, g, m, v, wd, s in tree_zip(params, grads, state.m, state.v,
                                      wd_tree, lr_scales):
        lr_l = lr * s
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        if wd:  # decoupled decay (the JAX update's no-op when wd == 0)
            p.sub_(lr_l * wd * p)
        p.sub_(lr_l * (m / c1) / (torch.sqrt(v / c2) + eps))
    state.t = t
    return params, state


def gpt_wd_mask(params, wd: float):
    """Weight decay per leaf: ``wd`` on the attention/FFN matmul weights,
    0 on embeddings, the head bias, LayerNorm parameters and FFN biases."""
    return _map_named(lambda k: wd if k in _DECAY_KEYS else 0.0, params)


def gpt_lr_scales(params, *, embed: float = 1.0, head: float = 1.0):
    """Per-leaf lr multipliers: ``embed`` on the (tied) ``tok_W``,
    ``head`` on the head bias, 1 elsewhere."""
    return _map_named(
        lambda k: embed if k == "tok_W" else head if k == "head_b" else 1.0,
        params)


def warmup_cosine(step, *, base: float, min_lr: float, warmup: int,
                  max_steps: int) -> float:
    """Linear warmup then cosine decay to ``min_lr``, in float32 as the JAX
    package computes it. ``step`` is a host number."""
    f = np.float32
    step = f(step)
    if step < warmup:
        return float(f(base) * step / f(max(1, warmup)))
    t = (step - f(warmup)) / f(max(1, max_steps - warmup))
    return float(f(min_lr) + f(0.5 * (base - min_lr))
                 * (f(1.0) + np.cos(f(math.pi) * t)))
