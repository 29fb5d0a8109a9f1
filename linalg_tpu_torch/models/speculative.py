"""Prompt-lookup and draft-model speculative decoding — the counterpart of
``linalg_tpu/models/speculative.py``.

Draft S - 1 tokens cheaply, verify them in ONE block forward of S rows
(``gpt_decode_block``), keep the longest accepted prefix and resample on
the first rejection: each round emits 1..S tokens for one forward.

- ``gpt_generate_speculative``: prompt-lookup drafting (``_draft_lookup``
  copies the continuation of the most recent earlier occurrence of the
  trailing bigram, else unigram).
- ``gpt_generate_speculative_draft``: a smaller GPT drafts greedily with
  its own KV cache.

Verification is point-mass rejection sampling (``spec_accept_or_resample``):
accept draft d with probability p(d) under the filtered target, else draw
from p with d removed. The emitted stream follows the plain sampler's law
exactly; greedy output equals greedy decoding. Rejected drafts' K/V rows
stay past the position and are overwritten by later blocks, so rollback
costs nothing.

PyTorch idiom: the rounds are a Python loop whose accepted count is read
on the host once a round; draws come from an explicit ``torch.Generator``
on the model's device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..nn.cache import fkv_init, fkv_write_slots
from ..nn.functional import rope_tables
from ..nn.positional import alibi_slopes
from .gpt import (GPTConfig, _attn_out, _categorical, _dt_decode_ops,
                  _gqa_decode_attn, filter_logits, gpt_prefill)

__all__ = ["gpt_decode_block", "gpt_generate_speculative",
           "gpt_generate_speculative_draft", "spec_accept_or_resample"]


def spec_accept_or_resample(generator, z, draft):
    """One point-mass rejection step on a FILTERED logits row ``z`` (V,):
    returns (token, accepted). The draft is accepted with probability
    softmax(z)[draft]; otherwise the token is drawn from softmax(z) with
    the draft removed. The returned token's marginal law is softmax(z)."""
    u = torch.rand((), generator=generator, device=z.device)
    accept = u < torch.softmax(z, -1)[draft]
    z_res = z.clone()
    z_res[draft] = -torch.inf
    other = _categorical(z_res[None], generator)[0]
    return torch.where(accept, torch.as_tensor(draft, device=z.device),
                       other), accept


def _block_forward(cfg: GPTConfig, ops, kbuf, vbuf, pos, start, tokens,
                   write_fn=fkv_write_slots, read_fn=None):
    """S rows of each of B sequences in one cached forward.

    ``tokens`` (B, S) sit at cache rows [pos_b, pos_b + S) (``pos`` (B,)
    int tensor) with logical positions row - ``start`` (a (B|1,) tensor);
    row r attends to cache rows j with start_b <= j <= pos_b + r (and
    within the window), RoPE rotates at each row's logical position,
    ALiBi biases slope_h * (j - (pos_b + r)). ``ops`` are
    ``_dt_decode_ops``; ``write_fn(k_l, v_l, pos, k, v)`` writes a layer's
    S new rows in place (default: ``fkv_write_slots``, contiguous per
    slot), ``read_fn`` maps a layer's buffer to the (B, hk, T, d) keys the
    attention reads (default: the buffer itself). The mask spans the T
    rows ``read_fn`` returns, which the buffers set, not ``cfg.ctx_len``.
    Returns float32 logits (B, S, V); the buffers are updated in place.
    With S = 1 this is ``gpt_decode_step``'s arithmetic. ``ops["layers"]``
    replaces the layer loop as in ``models.gpt._make_decode_step``
    (tensor-parallel serving: ``kbuf``/``vbuf`` are then per-rank lists of
    buffers)."""
    dt = cfg.compute_dtype
    D = cfg.d_model
    B, S = tokens.shape
    dev = tokens.device
    read = read_fn if read_fn is not None else (lambda x: x)
    offs = torch.arange(S, device=dev)
    absr = pos[:, None].long() + offs[None, :]  # (B, S) cache rows
    rel = absr - start.long()[:, None]          # logical positions
    flat = tokens.reshape(-1)
    rope = None
    if cfg.pos == "rope":
        c, s_ = rope_tables(cfg.d_head, rel)  # (B, S, d/2)
        rope = (c[:, None].to(dt), s_[:, None].to(dt))
        h = ops["embed"](flat).reshape(B, S, D).to(dt)
    elif cfg.pos == "alibi":
        h = ops["embed"](flat).reshape(B, S, D).to(dt)
    else:
        h = (ops["embed"](flat) + ops["pe"](rel.reshape(-1))).reshape(
            B, S, D).to(dt)
    T = (kbuf[0][0] if isinstance(kbuf, list) else read(kbuf[0])).shape[2]
    t_ids = torch.arange(T, device=dev)
    live = ((t_ids[None, None, :] <= absr[:, :, None])
            & (t_ids[None, None, :] >= start.long()[:, None, None]))
    if cfg.window is not None:
        live &= t_ids[None, None, :] > absr[:, :, None] - cfg.window
    mask = torch.where(live, 0.0, -1e9).to(dt)[:, None]  # (B, 1, S, T)
    if cfg.pos == "alibi":
        slopes = alibi_slopes(cfg.n_heads, device=dev)
        mask = mask + (slopes[None, :, None, None] * (
            t_ids[None, None, :] - absr[:, :, None]).float()[:, None]).to(dt)
    if ops.get("layers") is not None:
        return ops["head"](ops["layers"](h, rope, mask, kbuf, vbuf, pos,
                                         write_fn))
    heads = (cfg.n_heads, cfg.kv_heads, cfg.d_head)

    def attn(q, k, v, m):
        return _gqa_decode_attn(q, read(k), read(v), m)

    for i, lw in enumerate(ops["lws"]):
        h1 = h + _attn_out(ops, lw, h, rope, mask, kbuf[i], vbuf[i], pos,
                           write_fn, attn, heads)
        h = h1 + ops["ffn"](lw, ops["ln2"](lw, h1))
    return ops["head"](h)


def _as_rows(x, B: int, dev):
    """A scalar or per-row position as a (B,) int32 tensor on ``dev``."""
    t = torch.as_tensor(x, dtype=torch.int32, device=dev).reshape(-1)
    return t.expand(B) if t.numel() == 1 else t


@torch.no_grad()
def gpt_decode_block(params, cache, tokens, cfg: GPTConfig, S: int):
    """S tokens in one cached forward: ids (B, S) -> float32 logits
    (B, S, V), row r's logits the next-token distribution after
    ``tokens[:, r]``. Their K/V land in the cache buffers at rows
    [length, length + S), in place; ``length`` is NOT advanced (the
    caller advances by the rows it accepts). The attention spans the
    buffers' own rows, so callers may pass buffers padded past ctx_len.
    Returns (logits, cache)."""
    ops = _dt_decode_ops(params, cfg)
    tokens = torch.as_tensor(tokens, device=cache["k"].device).long()
    B = tokens.shape[0]
    if tokens.shape[1] != S:
        raise ValueError(f"tokens have {tokens.shape[1]} columns, S is {S}")
    dev = tokens.device
    logits = _block_forward(cfg, ops, cache["k"], cache["v"],
                            _as_rows(cache["length"], B, dev),
                            _as_rows(cache.get("start", 0), B, dev), tokens)
    return logits, cache


def _draft_lookup(hist, hist_len, S: int):
    """Prompt-lookup drafting, batched: (B, C) id histories with (B,)
    lengths -> (B, S) draft ids. Each row takes the most recent earlier
    occurrence of its trailing bigram (else its trailing unigram) and
    copies the S ids that followed it; ids past the known history repeat
    the last id. Fixed-shape tensor ops: no host sync."""
    B, C = hist.shape
    dev = hist.device
    idx = torch.arange(C, device=dev)[None, :]
    hlen = hist_len.long().reshape(-1)[:, None]  # (B, 1)
    rows = torch.arange(B, device=dev)
    last = hist[rows, (hlen[:, 0] - 1).clamp(0, C - 1)][:, None]
    prev = hist[rows, (hlen[:, 0] - 2).clamp(0, C - 1)][:, None]
    nxt = torch.roll(hist, -1, dims=1)
    big = (hist == prev) & (nxt == last) & (idx + 2 < hlen) & (hlen >= 2)
    uni = (hist == last) & (idx + 1 < hlen)
    j_big = torch.where(big, idx, -1).amax(1, keepdim=True)
    j_uni = torch.where(uni, idx, -1).amax(1, keepdim=True)
    src = torch.where(j_big >= 0, j_big + 2,
                      torch.where(j_uni >= 0, j_uni + 1, hlen - 1))
    dpos = src.clamp(0, C - S) + torch.arange(S, device=dev)[None, :]
    return torch.where(dpos < hlen, torch.gather(hist, 1, dpos), last)


def _verify(z, drafts, generator):
    """Point-mass rejection over a block: ``z`` (B, S, V) filtered logits
    of the S rows, ``drafts`` (B, S-1). Draft i is accepted iff u_i <
    p_i(draft_i) and every earlier one was; row n_acc supplies one more
    token, a bonus draw when all were accepted, else a draw with the
    rejected draft removed. Returns (n_acc (B,), emit (B, S)): emit holds
    the n_acc accepted drafts, then the drawn token, then zeros."""
    B, S, _ = z.shape
    dev = z.device
    bidx = torch.arange(B, device=dev)
    u = torch.rand((B, S - 1), generator=generator, device=dev)
    probs = torch.softmax(z[:, :-1], -1)
    ok = (u < torch.gather(probs, 2, drafts[..., None])[..., 0]).int()
    n_acc = torch.argmin(torch.cat(
        [ok, torch.zeros((B, 1), dtype=ok.dtype, device=dev)], 1), dim=1)
    d_rej = drafts[bidx, n_acc.clamp(max=S - 2)]
    z_fix = z[bidx, n_acc].clone()  # (B, V)
    z_fix[bidx, d_rej] = torch.where(n_acc == S - 1, z_fix[bidx, d_rej],
                                     -torch.inf)
    extra = _categorical(z_fix, generator)
    cols = torch.arange(S, device=dev)[None, :]
    emit = torch.cat([drafts, extra[:, None]], 1)
    emit = torch.where(cols > n_acc[:, None], 0, emit)
    emit[bidx, n_acc] = extra
    return n_acc, emit


def _check_spec_args(cfg: GPTConfig, prompt, n_tokens: int, S: int):
    prompt = np.asarray(prompt, dtype=np.int64).ravel()
    P = int(prompt.shape[0])
    if P < 1:
        raise ValueError("prompt must be non-empty")
    if P + n_tokens + S > cfg.ctx_len:
        raise ValueError(
            f"prompt ({P}) + n_tokens ({n_tokens}) + draft block ({S}) "
            f"must fit ctx_len ({cfg.ctx_len}); the speculative path does "
            "not roll the context window")
    return prompt, P


def _spec_cache(params, cfg: GPTConfig, prompt, P: int, dev):
    """Prefill of prompt[:-1] (a zeroed cache for a one-id prompt): the
    last prompt id is the first round's unprocessed token."""
    if P > 1:
        return gpt_prefill(params, torch.tensor(prompt[None, :-1],
                                                device=dev), cfg)[1]
    return fkv_init(cfg.n_layers, 1, cfg.kv_heads, cfg.ctx_len, cfg.d_head,
                    dtype=cfg.compute_dtype, device=dev)


@torch.no_grad()
def gpt_generate_speculative(params, cfg: GPTConfig, prompt, n_tokens: int,
                             *, n_draft: int = 8, temperature: float = 1.0,
                             top_k: int = 0, top_p: float = 0.0,
                             seed: int = 0,
                             generator: Optional[torch.Generator] = None):
    """Single-stream generation with prompt-lookup speculative decoding.

    Returns (tokens (n_tokens,) numpy, rounds): ``rounds`` block forwards
    were used, so ``n_tokens / rounds`` is the tokens a round (1 when no
    draft is ever accepted, n_draft + 1 at most). The emitted stream
    follows the plain sampler's law exactly; greedy output equals greedy
    decoding. Requires ``len(prompt) + n_tokens + n_draft + 1 <=
    ctx_len`` (no context rollover). Draws come from ``generator``, by
    default one on the parameters' device seeded with ``seed``."""
    S = n_draft + 1
    prompt, P = _check_spec_args(cfg, prompt, n_tokens, S)
    dev = params["tok_W"].device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    cache = _spec_cache(params, cfg, prompt, P, dev)
    return _spec_loop(cfg, _dt_decode_ops(params, cfg), cache, S, prompt,
                      n_tokens, temperature, top_k, top_p, generator)


def _spec_loop(cfg: GPTConfig, ops, cache, S: int, prompt, n_tokens: int,
               temperature, top_k, top_p, generator, draft=None):
    """The rounds of both single-stream generators. ``draft`` is None
    (prompt lookup) or (draft ops, draft cfg, draft cache). One host read
    a round: the accepted count."""
    dev = cache["k"].device
    C, P = cfg.ctx_len, prompt.shape[0]
    hist = torch.zeros((1, C), dtype=torch.long, device=dev)
    hist[0, :P] = torch.as_tensor(prompt, device=dev)
    hlen, count, rounds = P, 0, 0
    zero = torch.zeros((1,), dtype=torch.int32, device=dev)
    while count < n_tokens:
        pending = hist[:, hlen - 1]  # (1,) the unprocessed token
        if draft is None:
            drafts = _draft_lookup(hist, torch.tensor([hlen], device=dev),
                                   S - 1)
        else:
            dops, dcfg, dcache = draft
            tok, cols = pending, []
            for r in range(S - 1):  # greedy single-row steps of the draft
                lg = _block_forward(dcfg, dops, dcache["k"], dcache["v"],
                                    zero + (hlen - 1 + r), zero, tok[:, None])
                tok = lg[:, 0].argmax(-1)
                cols.append(tok)
            drafts = torch.stack(cols, 1)
        block = torch.cat([pending[:, None], drafts], 1)  # (1, S)
        logits = _block_forward(cfg, ops, cache["k"], cache["v"],
                                zero + (hlen - 1), zero, block)
        z = filter_logits(logits, temperature, top_k, top_p)  # (1, S, V)
        n_acc, emit = _verify(z, drafts, generator)
        n = int(n_acc[0]) + 1
        end = min(hlen + n, C)
        hist[0, hlen:end] = emit[0, :end - hlen]
        hlen, count, rounds = hlen + n, count + n, rounds + 1
    return hist[0, P:P + n_tokens].cpu().numpy(), rounds


@torch.no_grad()
def gpt_generate_speculative_draft(params, cfg: GPTConfig, draft_params,
                                   draft_cfg: GPTConfig, prompt,
                                   n_tokens: int, *, n_draft: int = 4,
                                   temperature: float = 1.0, top_k: int = 0,
                                   top_p: float = 0.0, seed: int = 0,
                                   generator: Optional[
                                       torch.Generator] = None):
    """Draft-MODEL speculative decoding: ``draft_params`` (a smaller GPT
    of the same vocabulary, ctx_len at least the target's) proposes
    n_draft tokens greedily with its own KV cache, the target verifies
    them in one block. The draft cache keeps every row it processed; rows
    past the accepted history are overwritten by the next round's steps,
    which start at the target's position. Returns (tokens, rounds) as
    ``gpt_generate_speculative``."""
    if draft_cfg.vocab_size != cfg.vocab_size:
        raise ValueError(
            f"draft vocab {draft_cfg.vocab_size} != target vocab "
            f"{cfg.vocab_size}")
    if draft_cfg.ctx_len < cfg.ctx_len:
        raise ValueError(
            f"draft ctx_len {draft_cfg.ctx_len} must cover the target's "
            f"{cfg.ctx_len} (both caches index the same positions)")
    S = n_draft + 1
    prompt, P = _check_spec_args(cfg, prompt, n_tokens, S)
    dev = params["tok_W"].device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    cache = _spec_cache(params, cfg, prompt, P, dev)
    dcache = _spec_cache(draft_params, draft_cfg, prompt, P, dev)
    return _spec_loop(cfg, _dt_decode_ops(params, cfg), cache, S, prompt,
                      n_tokens, temperature, top_k, top_p, generator,
                      draft=(_dt_decode_ops(draft_params, draft_cfg),
                             draft_cfg, dcache))
