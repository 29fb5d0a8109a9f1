"""Continuous-batching serving engine — the counterpart of
``linalg_tpu/serve/engine.py`` in slot mode and paged mode.

- The engine owns the KV of ``n_slots`` sequences with a PER-SLOT position
  vector: requests sit at different lengths, join when a slot frees and
  leave when done. Slot mode keeps (L, n_slots, kv_heads, ctx, d) buffers;
  paged mode keeps a page pool with per-slot page tables
  (``serve.paged``), reserves pages at admission and queues a request
  while the pool cannot hold it.
- Decode runs in chunks of ``chunk`` tokens for every slot at once; idle
  slots keep decoding (their writes are clamped into their own rows, or
  the trash page) and their tokens are discarded.
- Admission = one prefill of the prompt right-padded to
  ``prefill_window``, copied into the slot's rows (or the slot's pages).
- Sampling parameters are per-slot tensors (temperature, top_p, top_k),
  rebuilt from host vectors when an admission changes them. The host
  vectors are mutated in place, so the device copies are COPIES
  (``torch.tensor``), never views that a later mutation would change
  under a queued chunk.

Host and device meet once per chunk: the chunk's (n_slots, chunk) tokens
come to the host, where budgets and stop tokens are checked.

Not ported yet (each raises ``NotImplementedError`` naming ROADMAP.md's
item): prompts longer than ``prefill_window`` (chunked prefill),
registered prefixes, ``auto_prefix``, ``page_cache``, LoRA, speculative
decoding, int8 weights (``quant``), int8 KV pages (``kv8``), mesh serving,
and ring mode: a window combined with RoPE or ALiBi, which the JAX engine
serves from an O(window) KV ring. Every other RoPE, ALiBi, window and
SwiGLU/GeGLU config is served in slot and paged mode, as the JAX engine
serves it.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.gpt import (GPTConfig, _decode_chunk_core, _dt_decode_ops,
                          gpt_prefill)
from ..nn.cache import fkv_write_slots
from ..utils.device import resolve_device
from .paged import SUPPORTED_KERNEL_D

__all__ = ["Request", "Completion", "ServeEngine", "serve",
           "decode_chunk_slots", "pick_paged_kernel"]

_ROADMAP_SERVE = "ROADMAP.md queue 1, item 3 (engine: chunked prefill, " \
                 "prefixes)"
_ROADMAP_LATER = "ROADMAP.md queue 1, item 5 (serving features)"


@dataclasses.dataclass
class Request:
    """One generation request. ``stop_token`` < 0 disables early stop;
    ``top_k`` None inherits the engine-wide default (0 = disabled).
    ``prefix_id`` and ``lora_id`` are the JAX engine's fields; this port
    accepts only their defaults."""

    prompt: Sequence[int]
    max_new_tokens: int
    temperature: float = 1.0
    top_p: float = 0.0
    top_k: Optional[int] = None
    stop_token: int = -1
    prefix_id: Optional[int] = None
    lora_id: int = 0
    request_id: int = -1  # assigned by the engine at submit()


@dataclasses.dataclass
class Completion:
    request_id: int
    tokens: List[int]
    prompt_len: int
    finish_reason: str  # "length" | "stop"
    submitted_at: float = 0.0
    admitted_at: float = 0.0  # when the request left the queue for a slot
    finished_at: float = 0.0

    @property
    def queue_s(self) -> float:
        """Seconds spent waiting for a slot (and, in paged mode, pages)."""
        return self.admitted_at - self.submitted_at

    @property
    def latency_s(self) -> float:
        return self.finished_at - self.submitted_at

    @property
    def decode_tok_s(self) -> float:
        """Generated tokens per second of post-admission time."""
        return len(self.tokens) / max(self.finished_at - self.admitted_at,
                                      1e-9)


@torch.no_grad()
def decode_chunk_slots(ops, cache, logits, generator, temp, top_p, top_k,
                       cfg: GPTConfig, n_tokens: int):
    """Sample ``n_tokens`` for every slot of a slot cache
    {k, v: (L, B, hk, ctx, d), pos: (B,) int32}, with per-slot positions
    and per-slot (B,) sampling tensors. ``ops`` are the decode ops
    ``models.gpt._dt_decode_ops(params, cfg)``. Writes clamp to ctx-1, so
    idle slots never overflow their rows. Updates ``cache`` in place;
    returns (tokens (B, n), logits, cache)."""

    def write_slots(k_l, v_l, pos, k, v):
        return fkv_write_slots(k_l, v_l, torch.clamp(pos, max=cfg.ctx_len - 1),
                               k, v)

    toks, logits, K, V, pos = _decode_chunk_core(
        cfg, ops, logits, cache["k"], cache["v"], cache["pos"], 0, generator,
        n_tokens, temp[:, None], top_k, top_p[:, None], write_slots)
    return toks, logits, dict(cache, k=K, v=V, pos=pos)


def _admit_slot(cache, logits, slot_k, slot_v, plen, slot_logits, b):
    """Copy one prefilled sequence (L, 1, hk, ctx, d) into slot ``b`` (the
    whole row: the previous occupant's rows die here) and set its position
    and logits row."""
    cache["k"][:, b] = slot_k[:, 0]
    cache["v"][:, b] = slot_v[:, 0]
    cache["pos"][b] = plen
    logits[b] = slot_logits[0]
    return cache, logits


def _params_to(params, device):
    if isinstance(params, dict):
        return {k: _params_to(v, device) for k, v in params.items()}
    return params.to(device)


def pick_paged_kernel(paged_attn: str, device_type: str, page: int,
                      ctx_len: int, d_head: int) -> bool:
    """Whether a paged engine reads its pool through the kernel: always for
    ``"kernel"``; for ``"auto"`` the JAX engine's rule
    (``linalg_tpu/serve/engine.py:517-523``: its accelerator, page % 8 ==
    0, ctx_len >= 2048, d_head % 128 == 0), with the CUDA card as the
    accelerator and d_head within the kernel's widths."""
    return paged_attn == "kernel" or (
        paged_attn == "auto" and device_type == "cuda" and page % 8 == 0
        and ctx_len >= 2048 and d_head % 128 == 0
        and d_head in SUPPORTED_KERNEL_D)


class ServeEngine:
    """Slot-based continuous-batching engine over one GPT.

    Usage::

        eng = ServeEngine(params, cfg, n_slots=8, chunk=32, device="cuda")
        eng.submit(Request(prompt, max_new_tokens=100))
        done = eng.run()          # drain queue + in-flight, list[Completion]

    or incrementally: ``submit()`` any time, ``step()`` to advance one
    decode chunk (admitting queued requests into free slots first).

    ``paged=True`` keeps the KV in a page pool. ``paged_attn`` picks its
    read: ``"kernel"`` (the CUDA paged-attention kernel), ``"gather"``
    (table gather + grouped attention) or ``"auto"`` (``pick_paged_kernel``:
    the kernel on a CUDA device from ctx 2048 at d_head % 128 == 0 — the
    JAX engine's TPU rule, kept until the port measures its own
    crossover).

    ``schedule`` picks admission under page pressure: ``"fifo"`` admits in
    arrival order (a large request blocks the ones behind it, and nothing
    starves); ``"best-fit"`` admits the first queued request whose pages
    fit, so small requests flow past a blocked large one — which can then
    starve without bound under a steady stream of small ones, as in the
    JAX reference (``linalg_tpu/serve/engine.py:443-447``).
    """

    def __init__(self, params, cfg: GPTConfig, n_slots: int = 8,
                 chunk: int = 32, top_k: int = 0,
                 prefill_window: Optional[int] = None, seed: int = 0,
                 quant: str = "none", mesh=None, paged: bool = False,
                 page: int = 64, n_pages: Optional[int] = None,
                 paged_attn: str = "auto", max_loras: int = 0,
                 lora_rank: int = 8, speculative: int = 0,
                 kv8: bool = False, schedule: str = "fifo",
                 auto_prefix: bool = False, page_cache: bool = False,
                 device=None):
        del lora_rank  # meaningful only with max_loras
        for name, on, item in (
                ("quant", quant not in ("", "none"), _ROADMAP_LATER),
                ("mesh", mesh is not None, _ROADMAP_LATER),
                ("max_loras", bool(max_loras), _ROADMAP_LATER),
                ("speculative", bool(speculative), _ROADMAP_LATER),
                ("kv8", bool(kv8), _ROADMAP_LATER),
                ("auto_prefix", bool(auto_prefix), _ROADMAP_SERVE),
                ("page_cache", bool(page_cache), _ROADMAP_SERVE)):
            if on:
                raise NotImplementedError(
                    f"{name} serving is not ported yet ({item})")
        if cfg.window is not None and cfg.pos in ("rope", "alibi"):
            # the JAX engine's ring mode (linalg_tpu/serve/engine.py:427):
            # an O(window) KV ring with unbounded positions
            raise NotImplementedError(
                f"serving a window with pos={cfg.pos!r} takes the JAX "
                f"engine's ring mode, which is not ported yet "
                f"({_ROADMAP_LATER})")
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        self.device = resolve_device(device)
        self.params = _params_to(params, self.device)
        self.cfg = cfg
        self.n_slots = n_slots
        self.chunk = chunk
        self.top_k = top_k
        self.prefill_window = (min(cfg.ctx_len - chunk, 256)
                               if prefill_window is None else prefill_window)
        if not (0 < self.prefill_window <= cfg.ctx_len - chunk):
            raise ValueError(
                f"prefill_window must be in (0, ctx_len - chunk]; got "
                f"{self.prefill_window} (ctx_len={cfg.ctx_len}, "
                f"chunk={chunk})")
        if schedule not in ("fifo", "best-fit"):
            raise ValueError("schedule must be 'fifo' or 'best-fit'")
        self.schedule = schedule
        self._paged = bool(paged)
        self._allocator = None
        self._slot_pages: List[List[int]] = [[] for _ in range(n_slots)]
        dt = cfg.compute_dtype
        if self._paged:
            from .paged import PageAllocator, init_paged_cache

            if n_pages is None:  # dense-equivalent capacity + trash page
                n_pages = 1 + n_slots * (cfg.ctx_len // page)
            self._cache = init_paged_cache(cfg, n_slots, n_pages, page,
                                           device=self.device)
            self._page = page
            self._allocator = PageAllocator(n_pages)
            if paged_attn not in ("auto", "kernel", "gather"):
                raise ValueError("paged_attn must be auto|kernel|gather")
            if paged_attn == "kernel" and page % 8:
                raise ValueError("the paged-attention kernel needs "
                                 "page % 8 == 0")
            if (paged_attn == "kernel"
                    and cfg.d_head not in SUPPORTED_KERNEL_D):
                raise ValueError(
                    f"the paged-attention kernel takes d_head a multiple "
                    f"of 8 from 8 to 256; got {cfg.d_head}")
            self._paged_kernel = pick_paged_kernel(
                paged_attn, self.device.type, page, cfg.ctx_len, cfg.d_head)
        else:
            shape = (cfg.n_layers, n_slots, cfg.kv_heads, cfg.ctx_len,
                     cfg.d_head)
            self._cache = {
                "k": torch.zeros(shape, dtype=dt, device=self.device),
                "v": torch.zeros(shape, dtype=dt, device=self.device),
                "pos": torch.zeros((n_slots,), dtype=torch.int32,
                                   device=self.device),
            }
        # weights cast to the compute dtype once per engine, not per chunk
        self._ops = _dt_decode_ops(self.params, cfg)
        self._logits = torch.full((n_slots, cfg.vocab_size), -1e9,
                                  dtype=torch.float32, device=self.device)
        self._temp = np.ones((n_slots,), np.float32)
        self._top_p = np.zeros((n_slots,), np.float32)
        self._top_k = np.full((n_slots,), top_k, np.int32)
        self._samp_dev = None  # device copies of the three, admission-dirty
        self._slot_req: List[Optional[Request]] = [None] * n_slots
        self._slot_toks: List[List[np.ndarray]] = [[] for _ in range(n_slots)]
        self._count = [0] * n_slots       # tokens decoded per slot
        self._scanned = [0] * n_slots     # tokens already checked for stop
        self._queue: Deque[Request] = deque()
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._ids = itertools.count()
        self._submit_ts: Dict[int, float] = {}
        self._admit_ts: Dict[int, float] = {}
        self.completions: List[Completion] = []
        self.stats = {"chunks": 0, "decode_tokens": 0, "emitted_tokens": 0,
                      "prefills": 0, "syncs": 0}

    # -- submission ---------------------------------------------------------

    def register_prefix(self, tokens: Sequence[int], lora_id: int = 0) -> int:
        raise NotImplementedError(
            f"registered prefixes are not ported yet ({_ROADMAP_SERVE})")

    def register_lora(self, adapters, lcfg) -> int:
        raise NotImplementedError(
            f"LoRA serving is not ported yet ({_ROADMAP_LATER})")

    def submit(self, req: Request) -> int:
        """Queue a request; returns its assigned request_id."""
        plen = len(req.prompt)
        if plen == 0:
            raise ValueError("empty prompt")
        if req.prefix_id is not None:
            raise NotImplementedError(
                f"prefix_id is not ported yet ({_ROADMAP_SERVE})")
        if req.lora_id:
            raise NotImplementedError(
                f"lora_id is not ported yet ({_ROADMAP_LATER})")
        if plen > self.prefill_window:
            raise ValueError(
                f"prompt length {plen} exceeds prefill_window "
                f"{self.prefill_window}: chunked prefill is not ported yet "
                f"({_ROADMAP_SERVE})")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        reserved = self._reserved(req)
        if plen + reserved > self.cfg.ctx_len:
            raise ValueError(
                f"prefix (0) + prompt ({plen}) + reserved decode budget "
                f"({reserved} = max_new_tokens rounded up to the "
                f"{self.chunk}-token chunk) exceeds ctx_len "
                f"{self.cfg.ctx_len}")
        if self._paged:
            need = -(-(plen + reserved) // self._page)
            cap = self._allocator.n_pages - 1
            if need > cap:
                raise ValueError(
                    f"request needs {need} private pages but the pool can "
                    f"free at most {cap} (raise n_pages or lower "
                    f"max_new_tokens)")
        req = dataclasses.replace(req, request_id=next(self._ids))
        self._submit_ts[req.request_id] = time.perf_counter()
        self._queue.append(req)
        return req.request_id

    # -- engine loop --------------------------------------------------------

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self._slot_req)

    @property
    def pending(self) -> int:
        return len(self._queue)

    def _reserved(self, req: Request) -> int:
        """Decode-budget cache rows an admission reserves: the budget
        rounded up to the chunk size."""
        return -(-req.max_new_tokens // self.chunk) * self.chunk

    def _admit(self, slot: int, req: Request) -> bool:
        cfg, W = self.cfg, self.prefill_window
        plen = len(req.prompt)
        if self._paged:
            # admission control by memory: reserve every page the request
            # can touch; if the pool cannot cover it the request waits
            need = -(-(plen + self._reserved(req)) // self._page)
            if need > self._allocator.n_free:
                return False
            pages = self._allocator.alloc(need)
            self._slot_pages[slot] = pages  # retire frees these
            full = np.zeros((cfg.ctx_len // self._page,), np.int32)
            full[:need] = pages  # tail entries stay 0 (trash)
            table_ids = torch.tensor(full, device=self.device)
        ids = np.zeros((1, W), np.int64)
        ids[0, :plen] = np.asarray(req.prompt, np.int64)
        logits, cache = gpt_prefill(self.params,
                                    torch.tensor(ids, device=self.device),
                                    cfg, length=plen)
        if self._paged:
            from .paged import _admit_slot_paged

            self._cache, self._logits = _admit_slot_paged(
                self._cache, self._logits, cache["k"], cache["v"], plen,
                logits, slot, table_ids, table_ids, cfg)
        else:
            self._cache, self._logits = _admit_slot(
                self._cache, self._logits, cache["k"], cache["v"], plen,
                logits, slot)
        req_k = self.top_k if req.top_k is None else req.top_k
        if (self._temp[slot] != req.temperature
                or self._top_p[slot] != req.top_p
                or self._top_k[slot] != req_k):
            self._temp[slot] = req.temperature
            self._top_p[slot] = req.top_p
            self._top_k[slot] = req_k
            self._samp_dev = None
        self._slot_req[slot] = req
        self._admit_ts[req.request_id] = time.perf_counter()
        self._count[slot] = 0
        self._scanned[slot] = 0
        self.stats["prefills"] += 1
        return True

    def _free_pages(self, slot: int) -> None:
        """Paged retire: point the slot's table row at the trash page and
        return its pages to the pool."""
        if self._paged and self._slot_pages[slot]:
            from .paged import _reset_table_row

            self._cache = _reset_table_row(self._cache, slot)
            self._allocator.release(self._slot_pages[slot])
            self._slot_pages[slot] = []

    def _slot_tokens(self, slot: int) -> np.ndarray:
        rows = self._slot_toks[slot]
        return np.concatenate(rows) if rows else np.zeros((0,), np.int64)

    def _finish(self, slot: int, tokens: List[int], reason: str) -> None:
        req = self._slot_req[slot]
        self.completions.append(Completion(
            request_id=req.request_id,
            tokens=tokens,
            prompt_len=len(req.prompt),
            finish_reason=reason,
            submitted_at=self._submit_ts.pop(req.request_id),
            admitted_at=self._admit_ts.pop(req.request_id, 0.0),
            finished_at=time.perf_counter(),
        ))
        self.stats["emitted_tokens"] += len(tokens)
        self._slot_req[slot] = None
        self._slot_toks[slot] = []
        self._free_pages(slot)

    def step(self) -> bool:
        """Admit queued requests into free slots, then advance every active
        slot by one decode chunk. Returns False when fully idle."""
        for slot in range(self.n_slots):
            if self._slot_req[slot] is None and self._queue:
                if self.schedule == "fifo":
                    # a paged admit can fail on page pressure: the head
                    # request stays first and later slots wait too
                    if not self._admit(slot, self._queue[0]):
                        break
                    self._queue.popleft()
                else:
                    # best-fit: the first queued request that fits (it can
                    # starve a large one; see the class docstring)
                    for i, req in enumerate(self._queue):
                        if self._admit(slot, req):
                            del self._queue[i]
                            break
                    else:
                        break
        # finished requests free their pages at once, so an idle engine has
        # the whole pool free and submit()'s check guarantees the head fits
        if self.n_active == 0 and self._queue:
            raise RuntimeError("queued request cannot be admitted with an "
                               "idle engine")
        if self.n_active == 0:
            return False
        if self._samp_dev is None:
            # torch.tensor COPIES: the host vectors are mutated in place at
            # admission, and a view would change under a queued chunk
            self._samp_dev = (torch.tensor(self._temp, device=self.device),
                              torch.tensor(self._top_p, device=self.device),
                              torch.tensor(self._top_k, device=self.device))
        if self._paged:
            from .paged import decode_chunk_paged

            toks, self._logits, self._cache = decode_chunk_paged(
                self._ops, self._cache, self._logits, self._gen,
                *self._samp_dev, self.cfg, self.chunk,
                use_kernel=self._paged_kernel)
        else:
            toks, self._logits, self._cache = decode_chunk_slots(
                self._ops, self._cache, self._logits, self._gen,
                *self._samp_dev, self.cfg, self.chunk)
        toks = toks.cpu().numpy()  # the one host sync per chunk
        self.stats["syncs"] += 1
        self.stats["chunks"] += 1
        self.stats["decode_tokens"] += self.n_slots * self.chunk
        for slot in range(self.n_slots):
            req = self._slot_req[slot]
            if req is None:
                continue
            self._slot_toks[slot].append(toks[slot])
            self._count[slot] += self.chunk
            budget = req.max_new_tokens
            if req.stop_token >= 0:
                seq = self._slot_tokens(slot)
                new = seq[self._scanned[slot]:min(self._count[slot], budget)]
                hits = np.nonzero(new == req.stop_token)[0]
                if hits.size:
                    end = self._scanned[slot] + int(hits[0]) + 1
                    self._finish(slot, seq[:end].tolist(), "stop")
                    continue
                self._scanned[slot] = min(self._count[slot], budget)
            if self._count[slot] >= budget:
                self._finish(slot, self._slot_tokens(slot)[:budget].tolist(),
                             "length")
        return True

    def run(self) -> List[Completion]:
        """Drain the queue and all in-flight slots; returns completions in
        finish order (also accumulated on ``self.completions``)."""
        start = len(self.completions)
        while self.step():
            pass
        return self.completions[start:]


def serve(params, cfg: GPTConfig, requests: Sequence[Request],
          n_slots: int = 8, chunk: int = 32, top_k: int = 0,
          prefill_window: Optional[int] = None, seed: int = 0,
          quant: str = "none", device=None) -> List[Completion]:
    """One-shot convenience: submit ``requests``, run to completion, return
    completions ordered by request_id."""
    eng = ServeEngine(params, cfg, n_slots=n_slots, chunk=chunk, top_k=top_k,
                      prefill_window=prefill_window, seed=seed, quant=quant,
                      device=device)
    for r in requests:
        eng.submit(r)
    return sorted(eng.run(), key=lambda c: c.request_id)
