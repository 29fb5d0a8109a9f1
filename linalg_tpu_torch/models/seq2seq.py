"""Functional encoder-decoder seq2seq — the counterpart of
``linalg_tpu/models/seq2seq.py``.

The architecture of ``models.transformer`` (pre-LN blocks, cross-attention
whose dMemory autograd sums over the decoder layers) as a parameter dict
with stacked (L, ...) layer weights, looped over in Python where JAX
scans. The weights are the JAX package's numpy draws in its order; the
LayerNorm, attention and ReLU underneath are ``nn.functional``'s
hand-derived ``autograd.Function``s. ``make_reverse_batch`` draws the
reversal task's batches from a numpy Generator, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch

from ..nn.functional import (causal_mask, layer_norm, relu, sdpa,
                             sinusoidal_encoding)
from .gpt import _unstack

__all__ = ["Seq2SeqConfig", "init_seq2seq_params", "seq2seq_apply",
           "seq2seq_loss", "make_reverse_batch"]

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Seq2SeqConfig:
    vocab_size: int
    d_model: int = 64
    n_heads: int = 4
    n_enc_layers: int = 2
    n_dec_layers: int = 2
    d_ff: int = 256
    max_len: int = 64


def _stack_block(t, he, L, D, F, cross: bool):
    blk = {
        "ln1_g": t(np.ones((L, D))),
        "ln1_b": t(np.zeros((L, D))),
        "sa_Wq": he(D, (L, D, D)),
        "sa_Wk": he(D, (L, D, D)),
        "sa_Wv": he(D, (L, D, D)),
        "sa_Wo": he(D, (L, D, D)),
        "lnf_g": t(np.ones((L, D))),
        "lnf_b": t(np.zeros((L, D))),
        "W1": he(D, (L, D, F)),
        "b1": t(np.zeros((L, F))),
        "W2": he(F, (L, F, D)),
        "b2": t(np.zeros((L, D))),
    }
    if cross:
        blk.update({
            "ln2_g": t(np.ones((L, D))),
            "ln2_b": t(np.zeros((L, D))),
            "ca_Wq": he(D, (L, D, D)),
            "ca_Wk": he(D, (L, D, D)),
            "ca_Wv": he(D, (L, D, D)),
            "ca_Wo": he(D, (L, D, D)),
        })
    return blk


def init_seq2seq_params(cfg: Seq2SeqConfig, seed: int = 0,
                        device=None) -> Params:
    """Embeddings N(0, 0.02), Glorot-normal head, He-init blocks: the JAX
    package's draws in its order, rounded to float32."""
    rng = np.random.default_rng(seed)
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    def he(fan_in, shape):
        return t(rng.normal(0.0, math.sqrt(2.0 / fan_in), size=shape))

    std = math.sqrt(2.0 / (D + V))
    return {
        "src_emb": t(rng.normal(0.0, 0.02, (V, D))),
        "tgt_emb": t(rng.normal(0.0, 0.02, (V, D))),
        "head_W": t(rng.normal(0.0, std, (D, V))),
        "head_b": t(np.zeros((V,))),
        "encoder": _stack_block(t, he, cfg.n_enc_layers, D, F, cross=False),
        "decoder": _stack_block(t, he, cfg.n_dec_layers, D, F, cross=True),
    }


def _heads(x, h):
    B, T, D = x.shape
    return x.reshape(B, T, h, D // h).transpose(1, 2)


def _unheads(x):
    B, h, T, d = x.shape
    return x.transpose(1, 2).reshape(B, T, h * d)


def _attn(lp, prefix, x_q, x_kv, mask, h):
    q = _heads(x_q @ lp[f"{prefix}_Wq"], h)
    k = _heads(x_kv @ lp[f"{prefix}_Wk"], h)
    v = _heads(x_kv @ lp[f"{prefix}_Wv"], h)
    return _unheads(sdpa(q, k, v, mask)) @ lp[f"{prefix}_Wo"]


def _ffn(lp, x):
    return relu(x @ lp["W1"] + lp["b1"]) @ lp["W2"] + lp["b2"]


def seq2seq_apply(params: Params, src_ids, tgt_ids, cfg: Seq2SeqConfig):
    """(src (B, Ts), tgt_in (B, Tt)) -> logits (B, Tt, V), in the
    parameters' dtype."""
    h = cfg.n_heads
    dev = params["src_emb"].device
    src_ids = torch.as_tensor(src_ids, device=dev).long()
    tgt_ids = torch.as_tensor(tgt_ids, device=dev).long()
    Ts, Tt = src_ids.shape[-1], tgt_ids.shape[-1]
    pe = sinusoidal_encoding(cfg.max_len, cfg.d_model, device=dev)
    src = params["src_emb"][src_ids] + pe[:Ts][None]
    tgt = params["tgt_emb"][tgt_ids] + pe[:Tt][None]
    tgt_mask = causal_mask(Tt, dtype=src.dtype, device=dev)
    memory = src
    for lp in _unstack(params["encoder"]):
        xn = layer_norm(memory, lp["ln1_g"], lp["ln1_b"])
        memory = memory + _attn(lp, "sa", xn, xn, None, h)
        memory = memory + _ffn(lp, layer_norm(memory, lp["lnf_g"],
                                              lp["lnf_b"]))
    x = tgt
    for lp in _unstack(params["decoder"]):
        xn = layer_norm(x, lp["ln1_g"], lp["ln1_b"])
        x = x + _attn(lp, "sa", xn, xn, tgt_mask, h)
        xc = layer_norm(x, lp["ln2_g"], lp["ln2_b"])
        x = x + _attn(lp, "ca", xc, memory, None, h)
        x = x + _ffn(lp, layer_norm(x, lp["lnf_g"], lp["lnf_b"]))
    return x @ params["head_W"] + params["head_b"]


def seq2seq_loss(params: Params, src_ids, tgt_in, tgt_out,
                 cfg: Seq2SeqConfig):
    """Mean teacher-forced cross-entropy."""
    logits = seq2seq_apply(params, src_ids, tgt_in, cfg)
    tgt_out = torch.as_tensor(tgt_out, device=logits.device).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tgt_out[..., None])[..., 0]
    return torch.mean(logz - gold)


def make_reverse_batch(B: int, T: int, V: int, bos_id: int = 0, rng=None):
    """Reversal-task batch: src random ints (no BOS), tgt = reversed src,
    teacher-forced input shifted right by BOS. numpy int32 arrays from
    ``rng`` (a numpy Generator), the JAX package's draws."""
    rng = np.random.default_rng() if rng is None else rng
    src = rng.integers(1, V, size=(B, T), dtype=np.int32)
    rev = np.flip(src, axis=1)
    tgt_out = rev.copy()
    tgt_in = np.concatenate(
        [np.full((B, 1), bos_id, dtype=np.int32), rev[:, :-1]], axis=1)
    return src, tgt_in, tgt_out
