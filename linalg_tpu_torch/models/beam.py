"""Beam-search decoding for the decoder-only GPT — the counterpart of
``linalg_tpu/models/beam.py``.

Deterministic length-``n_new`` search over the KV-cached decode step:
each step expands every beam over the vocabulary, keeps the ``beam``
highest-scoring prefixes (sums of token log-probabilities, one top-k over
beam x V candidates), gathers the parent beams' KV rows once into the
second of two preallocated caches, and runs one batched decode step.
Beams 1..beam-1 start at -inf, so the first top-k does not pick ``beam``
copies of the best token from identical caches.

With a ``stop_token``, a beam that emits it is frozen: its only
continuation is the stop token again at log-probability 0, so its score
stays fixed while live beams compete; the result is cut after the first
stop token. With ``beam`` >= V**n the search is exhaustive and returns the
global argmax sequence.
"""

from __future__ import annotations

import numpy as np
import torch

from ..nn.cache import fkv_write
from .gpt import GPTConfig, _dt_decode_ops, _make_decode_step, gpt_prefill

__all__ = ["gpt_generate_beam"]


@torch.no_grad()
def _beam_search(params, logits, cache, cfg: GPTConfig, n_new: int,
                 beam: int, stop_token: int):
    """Device side: (tokens (beam, n_new), scores (beam,), lengths
    (beam,)) in the last top-k's order."""
    ops = _dt_decode_ops(params, cfg)
    step = _make_decode_step(cfg, ops, 0, fkv_write)
    V = cfg.vocab_size
    dev = logits.device
    kb = cache["k"].repeat_interleave(beam, dim=1)  # (L, beam, hk, S, d)
    vb = cache["v"].repeat_interleave(beam, dim=1)
    kb_alt, vb_alt = torch.empty_like(kb), torch.empty_like(vb)
    lg = logits.repeat_interleave(beam, dim=0)  # (beam, V)
    scores = torch.full((beam,), -torch.inf, dtype=lg.dtype, device=dev)
    scores[0] = 0.0
    toks = torch.zeros((beam, n_new), dtype=torch.long, device=dev)
    done = torch.zeros((beam,), dtype=torch.bool, device=dev)
    lengths = torch.full((beam,), n_new, dtype=torch.long, device=dev)
    frozen = None
    if stop_token >= 0:
        frozen = torch.full((V,), -torch.inf, dtype=lg.dtype, device=dev)
        frozen[stop_token] = 0.0
    pos = int(cache["length"])
    for t in range(n_new):
        logp = torch.log_softmax(lg, dim=-1)
        if frozen is not None:
            logp = torch.where(done[:, None], frozen[None, :], logp)
        scores, idx = torch.topk((scores[:, None] + logp).reshape(-1), beam)
        bsel = torch.div(idx, V, rounding_mode="floor")
        tsel = idx % V
        torch.index_select(kb, 1, bsel, out=kb_alt)
        torch.index_select(vb, 1, bsel, out=vb_alt)
        kb, kb_alt, vb, vb_alt = kb_alt, kb, vb_alt, vb
        toks = toks[bsel]
        toks[:, t] = tsel
        prev_done = done[bsel]
        lengths = lengths[bsel]
        if frozen is not None:
            stopped_now = ~prev_done & (tsel == stop_token)
            lengths = torch.where(stopped_now, t + 1, lengths)
            done = prev_done | stopped_now
        else:
            done = prev_done
        kb, vb, lg = step(kb, vb, pos, tsel)
        pos += 1
    return toks, scores, lengths


def gpt_generate_beam(params, cfg: GPTConfig, prompt_ids, n_new: int,
                      beam: int = 4, stop_token: int = -1,
                      length_penalty: float = 0.0):
    """Beam-search-decode ``n_new`` tokens after ``prompt_ids``.

    Returns ``(tokens, score)``: the best beam's new tokens as a 1-D int32
    numpy array (cut at the first ``stop_token`` if one fired) and its
    total log-probability (the raw sum). ``length_penalty`` > 0 ranks the
    final beams by ``score / len**penalty`` (meaningful with a
    ``stop_token``, where beams end at different lengths); the returned
    score is still the raw sum."""
    if beam < 1:
        raise ValueError("beam must be >= 1")
    if n_new < 1:
        raise ValueError("n_new must be >= 1")
    ids = np.asarray(prompt_ids, np.int64).reshape(-1)
    if ids.size == 0:
        raise ValueError("empty prompt")
    if ids.size + n_new > cfg.ctx_len:
        raise ValueError(
            f"prompt ({ids.size}) + n_new ({n_new}) exceeds ctx_len "
            f"{cfg.ctx_len}")
    dev = params["tok_W"].device
    logits, cache = gpt_prefill(params, torch.as_tensor(ids[None],
                                                        device=dev), cfg)
    toks, scores, lengths = _beam_search(params, logits, cache, cfg, n_new,
                                         beam, int(stop_token))
    toks = toks.cpu().numpy().astype(np.int32)
    scores = scores.cpu().numpy()
    lengths = lengths.cpu().numpy()
    if length_penalty > 0.0:
        ranked = scores / np.maximum(lengths, 1) ** length_penalty
    else:
        ranked = scores
    best = int(np.argmax(ranked))
    return toks[best, :int(lengths[best])], float(scores[best])
