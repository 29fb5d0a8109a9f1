"""Unbounded streaming decode for sliding-window models (ring-buffer KV) —
the counterpart of ``linalg_tpu/models/stream.py``.

With ``GPTConfig.window`` set, a token's attention reads only the last
``window`` positions, so decode needs a ring of ``R = window`` KV rows a
layer, each new token overwriting the row that just slid out of every
future window:

- KV state is O(window), whatever the stream's length;
- the absolute position is unbounded: generation runs past ``ctx_len``
  with no context rollover and no second prefill, and stays EXACTLY the
  windowed model's forward;
- ``pos`` must be "rope" or "alibi", relative encodings valid at any
  absolute position.

Keys are stored rotated at their absolute position j and the query at p;
the rotary dot depends only on p - j, so a ring row reused for a newer
position just works. RoPE angles are the float32 position times
``inv_freq`` (``rope_tables``), with no table bounded by ``ctx_len``.
ALiBi reads the per-row absolute positions ``rpos`` for its bias
``slope_h * (rpos - p)``. The masks ban rows with ``rpos <= p - window``
(stale) and ``rpos < 0`` (never written).

PyTorch idiom: the ring's K/V buffers and ``rpos`` are updated IN PLACE;
draws come from an explicit ``torch.Generator``; decode takes the ops of
``models.gpt._dt_decode_ops`` (ring mode is full precision and has no
adapters, as in the JAX engine).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..nn.cache import fkv_write_slots
from ..nn.functional import rope_rotate, rope_tables
from ..nn.positional import alibi_slopes
from .gpt import (GPTConfig, Params, _categorical, _dt_decode_ops,
                  _gqa_decode_attn, _heads, _unheads, filter_logits,
                  gpt_prefill)

__all__ = ["init_stream_cache", "stream_fill", "gpt_stream_prefill",
           "stream_chunk_slots", "gpt_stream_chunk"]


def _check_stream_cfg(cfg: GPTConfig) -> int:
    if cfg.window is None:
        raise ValueError("streaming decode needs GPTConfig.window")
    if cfg.pos not in ("rope", "alibi"):
        raise ValueError(
            "streaming decode supports pos in {'rope', 'alibi'} (relative "
            "encodings valid at unbounded absolute positions); "
            f"got {cfg.pos!r}")
    return cfg.window


def init_stream_cache(cfg: GPTConfig, batch: int = 1,
                      device=None) -> Dict[str, Any]:
    """Ring cache: {k, v: (L, B, hk, window, d), rpos: (window,) int32
    absolute position of each ring row (-1 = never written), pos: int32
    scalar, the next absolute position}. Positions are shared by the
    batch (the single-stream decode)."""
    R = _check_stream_cfg(cfg)
    shape = (cfg.n_layers, batch, cfg.kv_heads, R, cfg.d_head)
    dt = cfg.compute_dtype
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "rpos": torch.full((R,), -1, dtype=torch.int32, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def stream_fill(ring: Dict[str, Any], cache: Dict[str, Any], plen,
                cfg: GPTConfig) -> Dict[str, Any]:
    """Load the last ``min(window, plen)`` rows of a prefilled ctx-sized
    cache {k, v: (L, B, hk, ctx, d)} into the ring: absolute row j goes
    to ring row j % window, with rpos = j; ring rows before the prompt
    hold zeros and rpos -1. Returns a new ring dict."""
    R = _check_stream_cfg(cfg)
    dev = cache["k"].device
    plen = torch.as_tensor(plen, dtype=torch.int32, device=dev).reshape(())
    j = plen - R + torch.arange(R, dtype=torch.int32, device=dev)
    slot = torch.remainder(j, R)  # a permutation of 0..R-1
    j_for_slot = j[torch.argsort(slot)]
    ctx = cache["k"].shape[-2]
    gather = torch.clamp(j_for_slot, 0, ctx - 1).long()
    valid = (j_for_slot >= 0)[:, None]
    dt = ring["k"].dtype
    k = torch.where(valid, cache["k"][..., gather, :], 0).to(dt)
    v = torch.where(valid, cache["v"][..., gather, :], 0).to(dt)
    rpos = torch.where(j_for_slot >= 0, j_for_slot, -1).to(torch.int32)
    return dict(ring, k=k, v=v, rpos=rpos, pos=plen.clone())


def gpt_stream_prefill(params: Params, x_ids, cfg: GPTConfig, length=None):
    """Prompt prefill straight into a ring: (B, T) ids -> (logits, ring).
    The prompt itself is bounded by ctx_len; only the generation that
    follows is unbounded."""
    logits, cache = gpt_prefill(params, x_ids, cfg, length=length)
    ring = init_stream_cache(cfg, batch=x_ids.shape[0],
                             device=logits.device)
    return logits, stream_fill(ring, cache, cache["length"], cfg)


def _make_ring_step(cfg: GPTConfig, ops, per_slot: bool):
    """One-token ring decode step: ``decode_step(kbuf, vbuf, rpos, pos,
    token) -> (K, V, rpos', logits)``, the buffers and ``rpos`` updated in
    place. Single stream: ``pos`` a scalar, ``rpos`` (R,), every batch row
    writes ring row pos % R. Per slot: ``pos`` (B,), ``rpos`` (B, R), each
    slot its own row."""
    dt = cfg.compute_dtype
    D = cfg.d_model
    KD = cfg.kv_heads * cfg.d_head
    R = cfg.window
    attn = ops.get("attn") or _gqa_decode_attn
    dev = ops["device"]
    slopes = (alibi_slopes(cfg.n_heads, device=dev) if cfg.pos == "alibi"
              else None)

    def decode_step(kbuf, vbuf, rpos, pos, token):
        pos1 = pos.reshape(-1).to(torch.int32)  # (1,) or (B,)
        h = ops["embed"](token).to(dt)
        rope = None
        if cfg.pos == "rope":
            c, s_ = rope_tables(cfg.d_head, pos1[:, None])  # (B|1, 1, d/2)
            rope = (c[:, None].to(dt), s_[:, None].to(dt))
        slot = torch.remainder(pos1, R)
        rp = rpos.view(-1, R)  # (1|B, R), a view: writes reach ``rpos``
        rp[torch.arange(rp.shape[0], device=dev), slot] = pos1
        # live: written rows still inside the window ending at pos
        live = (rp >= 0) & (rp > pos1[:, None] - R)
        mask = torch.where(live, 0.0, -1e9).to(dt)[:, None, None, :]
        if slopes is not None:
            bias = (slopes[None, :, None, None]
                    * (rp - pos1[:, None]).float()[:, None, None, :])
            mask = mask + bias.to(dt)
        for i, lw in enumerate(ops["lws"]):
            qkv = ops["qkv"](lw, ops["ln1"](lw, h))
            q = _heads(qkv[..., :D], cfg.n_heads)
            k = _heads(qkv[..., D:D + KD], cfg.kv_heads)
            v = _heads(qkv[..., D + KD:], cfg.kv_heads)
            if rope is not None:
                q = rope_rotate(q, *rope)
                k = rope_rotate(k, *rope)
            k_l, v_l = kbuf[i], vbuf[i]
            if per_slot:
                fkv_write_slots(k_l, v_l, slot, k, v)
            else:
                k_l[:, :, slot] = k.to(k_l.dtype)
                v_l[:, :, slot] = v.to(v_l.dtype)
            h1 = h + ops["out"](lw, _unheads(attn(q, k_l, v_l, mask)))
            h = h1 + ops["ffn"](lw, ops["ln2"](lw, h1))
        return kbuf, vbuf, rpos, ops["head"](h[:, -1])

    return decode_step


def _make_stream_step(cfg: GPTConfig, ops):
    """The single-stream ring step (shared positions)."""
    return _make_ring_step(cfg, ops, per_slot=False)


def _make_stream_step_slots(cfg: GPTConfig, ops):
    """The per-slot ring step: positions, ring rows and row-position maps
    all per slot (``serve.engine``'s ring mode)."""
    return _make_ring_step(cfg, ops, per_slot=True)


def _stream_loop(decode_step, logits, kbuf, vbuf, rpos, pos, generator,
                 n_tokens: int, temperature, top_k, top_p):
    toks = []
    for _ in range(n_tokens):
        tok = _categorical(filter_logits(logits, temperature, top_k, top_p),
                           generator)
        kbuf, vbuf, rpos, logits = decode_step(kbuf, vbuf, rpos, pos, tok)
        pos = pos + 1
        toks.append(tok)
    return torch.stack(toks, dim=1), logits, kbuf, vbuf, rpos, pos


@torch.no_grad()
def stream_chunk_slots(ops, cache, logits, generator, temp, top_p, top_k,
                       cfg: GPTConfig, n_tokens: int):
    """Per-slot ring decode chunk, the ring-mode twin of
    ``serve.engine.decode_chunk_slots``. ``cache`` is {k, v: (L, B, hk,
    window, d), rpos: (B, window), pos: (B,)}; ``temp``/``top_p``/
    ``top_k`` are (B,) per-slot tensors. Positions are unbounded: slots
    generate past ctx_len with O(window) rows each. Updates ``cache`` in
    place; returns (tokens (B, n), logits, cache)."""
    _check_stream_cfg(cfg)
    step = _make_stream_step_slots(cfg, ops)
    toks, logits, K, V, rpos, pos = _stream_loop(
        step, logits, cache["k"], cache["v"], cache["rpos"], cache["pos"],
        generator, n_tokens, temp[:, None], top_k, top_p[:, None])
    return toks, logits, dict(cache, k=K, v=V, rpos=rpos, pos=pos)


@torch.no_grad()
def gpt_stream_chunk(params, ring, logits, generator, cfg: GPTConfig,
                     n_tokens: int, temperature=1.0, top_k: int = 0,
                     top_p=0.0):
    """Sample ``n_tokens`` through the ring: the unbounded twin of
    ``gpt_decode_chunk`` (no ctx_len ceiling, no rollover; chain chunks
    forever). Updates the ring in place; returns (tokens (B, n), logits,
    ring)."""
    _check_stream_cfg(cfg)
    step = _make_stream_step(cfg, _dt_decode_ops(params, cfg))
    toks, logits, K, V, rpos, pos = _stream_loop(
        step, logits, ring["k"], ring["v"], ring["rpos"], ring["pos"],
        generator, n_tokens, temperature, top_k, top_p)
    return toks, logits, dict(ring, k=K, v=V, rpos=rpos, pos=pos)
