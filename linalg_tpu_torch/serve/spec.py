"""Speculative decoding inside the continuous-batching engine — the
counterpart of ``linalg_tpu/serve/spec.py``.

``models.speculative`` verifies one stream; here every slot drafts from
its own token history and all slots verify together in one (B, S) block
forward at per-slot positions (``_block_step_slots``), each accepting its
own prefix under its own temperature / top-k / top-p. Slots advance by
different amounts; a (slot, round) ``valid`` count says how many of a
round's S token rows slot b emitted.

The budget gate runs on the device: a slot whose emitted count reached
its budget stops advancing (its rounds still run, at fixed shape, and
rewrite rows at its frozen position), so an active slot's rows stay below
plen + budget + 2S, the reservation ``ServeEngine.submit`` checks.

``decode_chunk_spec`` runs ``n_rounds`` rounds; the engine copies the
chunk's tokens and valid counts to the host together, once a chunk. The
paged engine passes its page table: the block's rows scatter through it
and attention reads the table gather (the JAX engine's paged speculative
path; the paged kernels stay with plain decode).

Precision: the (B, S) verify block and the (B, 1) decode step are GEMMs
of different M, so their sums may round differently; greedy tokens then
match the plain engine's except at near-ties of the top two logits.
"""

from __future__ import annotations

import torch

from ..models.gpt import GPTConfig, filter_logits
from ..models.speculative import _block_forward, _draft_lookup, _verify
from ..nn.cache import fkv_write_slots
from .paged import _gather_pages

__all__ = ["decode_chunk_spec", "spec_cache_fields"]


def spec_cache_fields(cfg: GPTConfig, n_slots: int, device=None):
    """Extra engine-cache entries of speculative mode: each slot's token
    history (the drafting source), its pending sampled-but-unprocessed
    token, and its emitted count (the device-side budget gate)."""
    return {
        "hist": torch.zeros((n_slots, cfg.ctx_len), dtype=torch.long,
                            device=device),
        "pending": torch.zeros((n_slots,), dtype=torch.long, device=device),
        "emitted": torch.zeros((n_slots,), dtype=torch.int32, device=device),
    }


def _block_step_slots(ops, cfg: GPTConfig, kbuf, vbuf, pos, tokens, S: int,
                      write_fn=None, read_fn=None):
    """One (B, S) block forward at per-slot positions ``pos`` (B,): slot
    b's rows land at cache rows [pos_b, pos_b + S) and row r attends to
    rows j <= pos_b + r. ``write_fn``/``read_fn`` re-seat the layout (the
    paged engine's table scatter and gather); the defaults are the dense
    slot layout (``fkv_write_slots``, the buffer itself). Returns (logits
    (B, S, V), K, V), the buffers updated in place."""
    if tokens.shape[1] != S:
        raise ValueError(f"tokens have {tokens.shape[1]} columns, S is {S}")
    zero = torch.zeros((1,), dtype=torch.int32, device=tokens.device)
    logits = _block_forward(cfg, ops, kbuf, vbuf, pos, zero, tokens,
                            write_fn or fkv_write_slots, read_fn)
    return logits, kbuf, vbuf


def _paged_io(cache, cfg: GPTConfig, S: int):
    """(write_fn, read_fn) of the paged spec engine: each slot's S rows
    scattered at (page, row) = (table[b, p // page], p % page), p clamped
    to ctx - 1 (idle slots write into the trash page), and the table
    gather (B, hk, ctx, d)."""
    table = cache["table"]
    B = table.shape[0]
    page = cache["pool_k"].shape[3]
    dev = table.device
    bidx = torch.arange(B, device=dev)[:, None]
    offs = torch.arange(S, device=dev)[None, :]
    heads = torch.arange(cfg.kv_heads, device=dev)[None, :, None]

    def write_fn(pk_l, pv_l, pos, k, v):
        n_pg, hk, pg, d = pk_l.shape
        p = torch.clamp(pos.long()[:, None] + offs, max=cfg.ctx_len - 1)
        pidx = table[bidx, p // page].long()  # (B, S)
        ridx = ((pidx[:, None, :] * hk + heads) * pg
                + (p % page)[:, None, :]).reshape(-1)  # (B * hk * S,)
        pk_l.view(n_pg * hk * pg, d)[ridx] = k.reshape(-1, d)
        pv_l.view(n_pg * hk * pg, d)[ridx] = v.reshape(-1, d)
        return pk_l, pv_l

    return write_fn, lambda pool: _gather_pages(pool, table)


@torch.no_grad()
def decode_chunk_spec(ops, cache, generator, temp, top_p, top_k, budget,
                      cfg: GPTConfig, n_rounds: int, n_draft: int):
    """Run ``n_rounds`` per-slot speculative rounds.

    ``ops``: ``models.gpt._dt_decode_ops(params, cfg)``; ``cache``: the
    slot cache {k, v, pos} or the paged one {pool_k, pool_v, table, pos},
    plus ``spec_cache_fields``; ``temp``/``top_p``/``top_k``/``budget``:
    (B,) per-slot tensors. A slot stops advancing once its emitted count
    reaches its budget. Returns (toks (B, n_rounds, S), valid (B,
    n_rounds), cache), ``valid[b, r]`` the rows of round r slot b really
    emitted (0 for gated and idle slots); the cache is updated in place.
    Greedy tokens equal the plain engine's up to near-ties."""
    S = n_draft + 1
    pos = cache["pos"]
    B = pos.shape[0]
    dev = pos.device
    if "table" in cache:
        write_fn, read_fn = _paged_io(cache, cfg, S)
        kbuf, vbuf = cache["pool_k"], cache["pool_v"]
    else:
        write_fn = read_fn = None
        kbuf, vbuf = cache["k"], cache["v"]
    temp = temp[:, None, None]  # against (B, S, V)
    top_p = top_p[:, None, None]
    hist, pending, emitted = cache["hist"], cache["pending"], cache["emitted"]
    C = cfg.ctx_len
    bidx = torch.arange(B, device=dev)
    cols = torch.arange(S, device=dev)[None, :]
    toks, valid = [], []
    for _ in range(n_rounds):
        gate = emitted < budget
        # hlen = pos + 1: pos rows processed, then the pending token
        drafts = _draft_lookup(hist, pos + 1, S - 1)  # (B, S-1)
        block = torch.cat([pending[:, None], drafts], 1)
        logits, kbuf, vbuf = _block_step_slots(ops, cfg, kbuf, vbuf, pos,
                                               block, S, write_fn, read_fn)
        n_acc, emit = _verify(filter_logits(logits, temp, top_k, top_p),
                              drafts, generator)
        adv = torch.where(gate, n_acc + 1, 0).to(torch.int32)
        # the emitted rows join the history at hlen; rows past adv stay
        widx = torch.clamp(pos.long()[:, None] + 1 + cols, max=C - 1)
        old = hist[bidx[:, None], widx]
        hist[bidx[:, None], widx] = torch.where(cols < adv[:, None], emit,
                                                old)
        pending = torch.where(gate, emit[bidx, n_acc], pending)
        pos = pos + adv
        emitted = emitted + adv
        toks.append(emit)
        valid.append(adv)
    cache.update(pos=pos, hist=hist, pending=pending, emitted=emitted)
    return torch.stack(toks, 1), torch.stack(valid, 1), cache
