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
  Longer prompts admit by CHUNKED PREFILL: the first window prefills, the
  rest block-extends a window at a time (``_extend_prefix``, the
  speculative verifier's block forward), so any prompt within the ctx
  budget admits.
- Prefix reuse: ``register_prefix`` prefills a shared prefix once and
  ``Request(prefix_id=...)`` block-extends it by the request's suffix;
  ``auto_prefix=True`` matches full prompts against the registered
  prefixes; ``page_cache=True`` (paged) keeps retired requests' full
  prompt pages under content-addressed chain keys and reuses the longest
  cached run. In paged mode shared pages stand in several slots' tables,
  and the paged kernels read them in place.
- ``speculative=K`` turns each chunk into per-slot draft + verify rounds
  (``serve.spec``) in slot mode or paged mode with the table gather.
- Sampling parameters are per-slot tensors (temperature, top_p, top_k),
  rebuilt from host vectors when an admission changes them. The host
  vectors are mutated in place, so the device copies are COPIES
  (``torch.tensor``), never views that a later mutation would change
  under a queued chunk.

Host and device meet once per chunk: the chunk's (n_slots, chunk) tokens
(with a speculative chunk's valid counts, in the same copy) come to the
host, where budgets and stop tokens are checked. The JAX engine drains
these copies lazily; the port copies each chunk at once.

Weights, KV layout and adapters meet at one seam, ``select_decode_ops``:
int8 weight-only decode (``quant="int8"``, admission prefill in the
compute dtype), the per-slot LoRA side-path (``max_loras``,
``register_lora``, ``Request.lora_id``) or the plain cast weights; the
slot, paged and speculative chunks all take their ops from it. Paged
engines may store the pool int8 (``kv8=True``, read by the gather).

The MoE GPT (``models.moe``) serves on the slot cache: admission prefills
through ``moe_prefill`` and the chunks decode through ``_moe_decode_ops``,
one routing group a slot, so an idle slot's tokens take no expert
capacity from another. Its refusals are the JAX engine's ``ValueError``s:
quant, mesh, paged KV, multi-LoRA, speculative decoding, registered
prefixes, and a prompt past ``prefill_window`` (chunked prefill needs the
dense block-extend forward). A windowed MoE serves in slot mode, not in
ring mode.

Ring mode: a window with RoPE or ALiBi (full precision, no mesh) keeps
each slot's KV as an O(window) ring with unbounded positions
(``models.stream``): only prefix + prompt must fit ``ctx_len``, and a
request generates past it with no second prefill. It composes with
chunked prefill, registered prefixes and ``auto_prefix``; paged KV, LoRA
and speculative decoding raise the JAX engine's ``ValueError``s.

Mesh serving (``mesh=`` with a ``'tp'`` axis): the full-precision dense
GPT on the slot cache, token-identical to the unsharded engine. Each tp
rank holds its megatron shard (``parallel.sharding.tp_serve_params``) and
the KV heads its query heads read (``tp_kv_heads``: replicated over the
ranks that share one when tp does not divide kv_heads) in a slot cache of
its own on its mesh device. Prefill (``tp_prefill``), the admission
extensions and every decode step run each rank's heads and FFN columns,
with one ``all_reduce`` over ``tp`` after Wo and one after W2
(``tp_serve_ops``); the head, sampling and the per-slot state run once, on
tp rank 0's device. A windowed RoPE/ALiBi model stays on the slot cache,
as in JAX; quant, MoE, paged KV, multi-LoRA and speculative decoding raise
the JAX engine's ``ValueError``s.

While a profiler records, a step is traced as ``serve.step``, holding a
``serve.admit`` per admission (its request id and prompt length in its
args; inside it ``serve.prefill``, the first window, and a ``serve.extend``
per further window), ``serve.decode`` (the host dispatching the chunk),
``serve.fetch`` (the host waiting for the chunk's tokens) and
``serve.account`` (taking them, finishing requests, freeing pages).
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import time
from collections import OrderedDict, deque
from typing import Deque, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..models.gpt import (GPTConfig, _decode_chunk_core, _dt_decode_ops,
                          gpt_prefill)
from ..models.moe import MoEGPTConfig, _moe_decode_ops, moe_prefill
from ..models.speculative import _block_forward
from ..nn.cache import fkv_write_slots
from ..utils.device import resolve_device
from ..utils.profiling import span
from .paged import SUPPORTED_KERNEL_D

__all__ = ["Request", "Completion", "ServeEngine", "serve",
           "decode_chunk_slots", "pick_paged_kernel"]

@dataclasses.dataclass
class Request:
    """One generation request. ``stop_token`` < 0 disables early stop;
    ``top_k`` None inherits the engine-wide default (0 = disabled).
    ``prefix_id`` (from ``ServeEngine.register_prefix``): the effective
    prompt is prefix + prompt, and admission reuses the prefix's cached
    KV and prefills only ``prompt``. ``lora_id`` (from
    ``ServeEngine.register_lora``): the request decodes through that
    adapter (0 = the base model); slots wearing different adapters batch
    in one decode chunk."""

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
    and per-slot (B,) sampling tensors. ``ops`` are the engine's decode
    ops (``select_decode_ops``). Writes clamp to ctx-1, so
    idle slots never overflow their rows. Updates ``cache`` in place;
    returns (tokens (B, n), logits, cache)."""

    def write_slots(k_l, v_l, pos, k, v):
        return fkv_write_slots(k_l, v_l, torch.clamp(pos, max=cfg.ctx_len - 1),
                               k, v)

    toks, logits, K, V, pos = _decode_chunk_core(
        cfg, ops, logits, cache["k"], cache["v"], cache["pos"], 0, generator,
        n_tokens, temp[:, None], top_k, top_p[:, None], write_slots)
    return toks, logits, dict(cache, k=K, v=V, pos=pos)


def select_decode_ops(params, cfg: GPTConfig, cache, dense_ops=None):
    """The weight-representation dispatch shared by the slot, paged and
    speculative chunks (the JAX engine's ``select_decode_ops``): the MoE
    routing ops for an MoE config (``dense_ops`` when the caller already
    built them), int8 weight-only ops when ``params`` holds ``tok_W_q``
    (``quant="int8"``), else the cast dense ops (``dense_ops`` when given),
    wrapped in the per-slot LoRA side-path when ``params`` carries
    ``_lora`` stacks (the adapter ids are ``cache["lora_ids"]``). The ops
    never touch the KV layout; the layout never touches the weights."""
    from ..models.lora import lora_decode_ops
    from ..models.quant import _q_decode_ops

    if isinstance(cfg, MoEGPTConfig):
        return (dense_ops if dense_ops is not None
                else _moe_decode_ops(params, cfg))
    lora = params.get("_lora")
    base = {k: v for k, v in params.items() if k != "_lora"}
    if "tok_W_q" in base:
        ops = _q_decode_ops(base, cfg)
    else:
        ops = dense_ops if dense_ops is not None else _dt_decode_ops(base,
                                                                     cfg)
    if lora is not None:
        ops = lora_decode_ops(ops, lora, cache["lora_ids"], cfg)
    return ops


def _admit_slot_ring(cache, logits, slot_k, slot_v, plen, slot_logits, b,
                     cfg: GPTConfig):
    """Ring-mode admission: compress a ctx-sized prefill (or prefix
    extension) (L, 1, hk, ctx, d) to its last ``window`` rows
    (``models.stream.stream_fill``) and copy them into ring slot ``b``
    with their absolute positions."""
    from ..models.stream import init_stream_cache, stream_fill

    ring1 = stream_fill(init_stream_cache(cfg, 1, device=slot_k.device),
                        {"k": slot_k, "v": slot_v}, plen, cfg)
    cache["k"][:, b] = ring1["k"][:, 0]
    cache["v"][:, b] = ring1["v"][:, 0]
    cache["rpos"][b] = ring1["rpos"]
    cache["pos"][b] = plen
    logits[b] = slot_logits[0]
    return cache, logits


def _set_slot_lora(cache, b, lora_id):
    """Point slot ``b`` at adapter ``lora_id`` (0 = the base model)."""
    cache["lora_ids"][b] = lora_id
    return cache


class _Prefix(NamedTuple):
    """A registered prefix: its prefilled (L, 1, hk, ctx, d) K/V, length,
    pinned pool pages (paged mode), adapter id and tokens."""

    k: torch.Tensor
    v: torch.Tensor
    plen: int
    shared: List[int]
    lora_id: int
    tokens: List[int]


def _admit_slot(cache, logits, slot_k, slot_v, plen, slot_logits, b):
    """Copy one prefilled sequence (L, 1, hk, ctx, d) into slot ``b`` (the
    whole row: the previous occupant's rows die here) and set its position
    and logits row. Per-rank lists (mesh serving) copy each rank's rows."""
    pairs = ((cache["k"], slot_k), (cache["v"], slot_v))
    if isinstance(slot_k, list):
        pairs = [p for bufs, xs in pairs for p in zip(bufs, xs)]
    for buf, x in pairs:
        buf[:, b] = x[:, 0]
    cache["pos"][b] = plen
    logits[b] = slot_logits[0]
    return cache, logits


def _set_slot_spec(cache, b, hist_row, pending):
    """Speculative admission extras for slot ``b``: its token history (the
    drafting source), its pending unprocessed token and a zeroed emitted
    count (``serve.spec``)."""
    cache["hist"][b] = hist_row
    cache["pending"][b] = pending
    cache["emitted"][b] = 0
    return cache


@torch.no_grad()
def _extend_prefix(ops, cfg: GPTConfig, pk, pv, plen: int, suffix_ids):
    """Extend a cached prefix KV by a suffix in one block forward.

    ``pk``/``pv`` are (L, 1, hk, ctx, d) buffers with rows [0, plen) live;
    ``suffix_ids`` (1, S) the suffix's ids. The block forward of the
    speculative verifier (``models.speculative._block_forward``) writes
    the suffix's K/V at rows [plen, plen + S), each suffix row attending
    over the prefix and the earlier suffix rows at their absolute
    positions. A block write past the buffer's end would clamp its start
    and overwrite prefix rows, so the buffers are padded by S rows for the
    extend and sliced back (rows past ctx are dropped; the submit-time
    budget keeps real rows inside). The JAX engine pads the suffix to the
    window for one compiled shape; eager PyTorch takes the suffix's own
    length. ``pk``/``pv`` are not modified (mesh serving: per-rank lists of
    them). Returns the next-token logits after the suffix (1, V) and the
    extended (L, 1, hk, ctx, d) buffers."""
    def each(f, x):
        return [f(t) for t in x] if isinstance(x, list) else f(x)

    S = suffix_ids.shape[1]
    ctx = (pk[0] if isinstance(pk, list) else pk).shape[-2]
    kb, vb = (each(lambda t: F.pad(t, (0, 0, 0, S)), x) for x in (pk, pv))
    rows = torch.full((1,), plen, dtype=torch.int32,
                      device=suffix_ids.device)
    logits = _block_forward(cfg, ops, kb, vb, rows, torch.zeros_like(rows),
                            suffix_ids)
    return (logits[:, -1],) + tuple(each(lambda t: t[..., :ctx, :], x)
                                    for x in (kb, vb))


def _params_to(params, device):
    if isinstance(params, dict):
        return {k: _params_to(v, device) for k, v in params.items()}
    return params.to(device)


def pick_paged_kernel(paged_attn: str, device_type: str, page: int,
                      ctx_len: int, d_head: int,
                      speculative: int = 0) -> bool:
    """Whether a paged engine reads its pool through the kernel: always for
    ``"kernel"``; for ``"auto"`` the JAX engine's rule
    (``linalg_tpu/serve/engine.py:517-523``: its accelerator, no
    speculative decoding (whose chunk reads the table gather), page % 8 ==
    0, ctx_len >= 2048, d_head % 128 == 0), with the CUDA card as the
    accelerator and d_head within the kernel's widths."""
    return paged_attn == "kernel" or (
        paged_attn == "auto" and not speculative and device_type == "cuda"
        and page % 8 == 0 and ctx_len >= 2048 and d_head % 128 == 0
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

    Prefix reuse, from explicit to automatic: ``register_prefix(tokens)``
    and ``Request(prefix_id=...)``; ``auto_prefix=True`` (``submit()``
    matches full prompts against the registered prefixes: the longest
    proper prefix); ``page_cache=True`` (paged): retired requests leave
    their full prompt pages in the pool under content-addressed chain
    keys, admissions reuse the longest cached run, refcounted while in
    use, refs-0 entries evicted LRU under page pressure.

    ``speculative=K`` drafts K tokens a slot and round by prompt lookup
    and verifies them in one block forward (``serve.spec``), in slot mode
    or paged mode with ``paged_attn`` "gather" (or "auto", which then
    never picks the kernel), with or without multi-LoRA.

    ``quant="int8"`` decodes through int8 weights (the admission prefill
    stays in the compute dtype); ``kv8=True`` (paged, gather read) keeps
    the pool int8 with a per-row scale; ``max_loras=N`` with
    ``register_lora`` and ``Request(lora_id=...)`` serves N adapters at
    once, each slot through its own (prefixes and page-cache chains are
    per adapter). A window with RoPE or ALiBi serves in ring mode. The
    compositions and refusals are PARITY.md's slot, paged and ring
    columns.

    ``mesh`` (a ``parallel.make_mesh`` mesh with a ``'tp'`` axis) serves
    tensor-parallel over its first tp group, token-identical to the
    unsharded engine: each rank's shard and KV heads on its mesh device,
    two ``all_reduce``s a layer, sampling on tp rank 0's device (which
    then is the engine's ``device``; ``params`` becomes the per-rank
    shards). Slot cache only; registered prefixes, ``auto_prefix``,
    chunked prefill and top-k sampling compose.

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
        moe = isinstance(cfg, MoEGPTConfig)
        if mesh is not None:
            # the JAX engine's checks (linalg_tpu/serve/engine.py:372-376)
            if moe or quant not in ("", "none"):
                raise ValueError(
                    "mesh serving supports the full-precision dense GPT")
            if "tp" not in getattr(mesh, "axis_names", ()):
                raise ValueError("serving mesh needs a 'tp' axis")
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        if quant not in ("", "none", "int8"):
            raise ValueError(f"unknown quant mode: {quant!r}")
        quant_on = quant == "int8"
        if quant_on and moe:
            raise ValueError("quant decode supports the dense GPT only")
        self._moe = moe
        self._tp_mesh = None
        if mesh is not None:
            # serve on the first tp group (the other axes' ranks would
            # hold replicas of it); rank 0's device holds the head, the
            # sampling and the per-slot state
            from ..parallel.mesh import make_mesh
            from ..parallel.sharding import tp_serve_params

            group = mesh.groups("tp")[0]
            if not all(mesh.is_local(x) for x in group):
                raise ValueError(
                    "ServeEngine(mesh=...) serves a tp group of this "
                    "process's ranks; this mesh's tp group spans processes "
                    f"{sorted({mesh.rank_process[x] for x in group})} (the "
                    "JAX engine reads sharded values back on the host, "
                    "which a mesh across processes cannot give): build the "
                    "serving mesh with make_mesh(..., local=True)")
            devs = [mesh.rank_devices[x] for x in group]
            self._tp_mesh = make_mesh((len(devs),), ("tp",), devs)
            self.device = devs[0]
            params = tp_serve_params(params, cfg, self._tp_mesh)
            self.params = params
        else:
            self.device = resolve_device(device)
            self.params = _params_to(params, self.device)
        self.mesh = mesh
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
        # ring mode: a windowed model with a relative positional encoding
        # keeps each slot's KV as an O(window) ring with unbounded
        # positions (the JAX engine's rule: full precision, no mesh)
        self._ring = (cfg.window is not None and cfg.pos in ("rope", "alibi")
                      and not moe and not quant_on and mesh is None)
        self._paged = bool(paged)
        self._allocator = None
        self._slot_pages: List[List[int]] = [[] for _ in range(n_slots)]
        if kv8 and not self._paged:
            raise ValueError("kv8 (int8 KV pages) requires paged=True")
        if schedule not in ("fifo", "best-fit"):
            raise ValueError("schedule must be 'fifo' or 'best-fit'")
        self.schedule = schedule
        self._auto_prefix = bool(auto_prefix)
        self._page_cache = bool(page_cache)
        dt = cfg.compute_dtype
        if self._paged:
            if self._ring or moe or mesh is not None:
                raise ValueError("paged KV supports the dense GPT without "
                                 "--window/mesh")
            from .paged import PageAllocator, init_paged_cache

            if n_pages is None:  # dense-equivalent capacity + trash page
                n_pages = 1 + n_slots * (cfg.ctx_len // page)
            self._cache = init_paged_cache(cfg, n_slots, n_pages, page,
                                           kv8=kv8, device=self.device)
            self._page = page
            self._allocator = PageAllocator(n_pages)
            self._shared_held = 0  # pages pinned by registered prefixes
            if self._page_cache and kv8:
                raise ValueError(
                    "page_cache requires kv8=False: reused pages would be "
                    "DEQUANTIZED into the extend forward, so warm "
                    "admissions would drift off the cold path's exact "
                    "tokens")
            # page cache: chain key -> [page id, refs], in LRU order (a
            # hit moves its key to the end); per slot, the admission's hit
            # keys and its (key, page) insert candidates for retirement
            self._pcache: "OrderedDict[bytes, list]" = OrderedDict()
            self._slot_pc: List = [None] * n_slots
            if paged_attn not in ("auto", "kernel", "gather"):
                raise ValueError("paged_attn must be auto|kernel|gather")
            if paged_attn == "kernel" and page % 8:
                raise ValueError("the paged-attention kernel needs "
                                 "page % 8 == 0")
            if paged_attn == "kernel" and kv8:
                raise ValueError("the paged kernels read plain pools; kv8 "
                                 "serves via paged_attn='gather'")
            if (paged_attn == "kernel"
                    and cfg.d_head not in SUPPORTED_KERNEL_D):
                raise ValueError(
                    f"the paged-attention kernel takes d_head a multiple "
                    f"of 8 from 8 to 256; got {cfg.d_head}")
            self._paged_kernel = not kv8 and pick_paged_kernel(
                paged_attn, self.device.type, page, cfg.ctx_len, cfg.d_head,
                speculative)
        else:
            if self._page_cache:
                raise ValueError("page_cache requires paged=True (the cache "
                                 "lives in the page pool)")
            rows = cfg.window if self._ring else cfg.ctx_len
            shape = (cfg.n_layers, n_slots, cfg.kv_heads, rows, cfg.d_head)
            self._cache = {
                "k": torch.zeros(shape, dtype=dt, device=self.device),
                "v": torch.zeros(shape, dtype=dt, device=self.device),
                "pos": torch.zeros((n_slots,), dtype=torch.int32,
                                   device=self.device),
            } if mesh is None else self._tp_cache(shape)
        if self._ring:
            self._cache["rpos"] = torch.full((n_slots, cfg.window), -1,
                                             dtype=torch.int32,
                                             device=self.device)
        # weights cast to the compute dtype once per engine: the admission
        # extensions' ops, and the decode ops unless the weights are int8
        # (the int8 decode keeps prefill in the compute dtype)
        if mesh is not None:
            from ..parallel.sharding import tp_serve_ops

            self._dense_ops = tp_serve_ops(self.params, cfg, self._tp_mesh)
        else:
            self._dense_ops = (_moe_decode_ops if moe else _dt_decode_ops)(
                self.params, cfg)
        self._decode_params = self.params
        if quant_on:
            from ..models.quant import quantize_gpt_params

            self._decode_params = quantize_gpt_params(self.params, cfg)
        # multi-LoRA: fixed-shape adapter stacks and a per-slot adapter id;
        # requests wearing different adapters batch in one decode chunk
        self._max_loras = int(max_loras)
        self._n_loras = 0  # adapters registered so far
        if self._max_loras:
            if self._ring or moe or mesh is not None:
                raise ValueError("multi-LoRA serving supports the dense "
                                 "slot/paged engine (no ring/mesh)")
            from ..models.lora import init_lora_stacks

            self._lora_stacks = init_lora_stacks(
                self.params, self._max_loras, lora_rank, dtype=dt)
            self._cache["lora_ids"] = torch.zeros(
                (n_slots,), dtype=torch.long, device=self.device)
            self._decode_params = dict(self._decode_params,
                                       _lora=self._lora_stacks)
        # speculative decoding: each chunk runs rounds of (1 + K)-row
        # draft + verify blocks (serve.spec); slots advance independently
        self._spec = int(speculative)
        if self._spec:
            if (self._ring or mesh is not None or quant_on or kv8 or moe
                    or (self._paged and self._paged_kernel)):
                # the JAX engine's refusal
                # (linalg_tpu/serve/engine.py:570-590)
                raise ValueError(
                    "speculative serving supports the full-precision "
                    "dense slot or paged(gather) engine, with or without "
                    "multi-LoRA (no ring/mesh/quant/kv8: quant would "
                    "recompute the pending prompt token through int8 ops "
                    "that admission prefilled in f32)")
            from .spec import spec_cache_fields

            self._cache.update(spec_cache_fields(cfg, n_slots, self.device))
            self._spec_rounds = max(1, chunk // (self._spec + 1))
            self._budget = np.zeros((n_slots,), np.int32)
        self._ops = (self._dense_ops if mesh is not None else
                     select_decode_ops(self._decode_params, cfg, self._cache,
                                       self._dense_ops))
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
        self._prefixes: Dict[int, _Prefix] = {}
        self._prefix_ids = itertools.count()
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._ids = itertools.count()
        self._submit_ts: Dict[int, float] = {}
        self._admit_ts: Dict[int, float] = {}
        self.completions: List[Completion] = []
        self.stats = {"chunks": 0, "emitted_tokens": 0, "prefills": 0,
                      "page_cache_hits": 0, "page_cache_evicted": 0}

    # -- submission ---------------------------------------------------------

    def register_prefix(self, tokens: Sequence[int], lora_id: int = 0) -> int:
        """Prefill a shared prompt prefix once and cache its KV.

        Requests submitted with ``prefix_id=<returned id>`` behave as if
        their prompt were ``tokens + prompt``, but admission copies the
        cached prefix KV into the slot and block-extends it with the
        suffix only. In paged mode the prefix's full pages are scattered
        into the pool once and pinned for the engine's lifetime: every
        admission points its table at them and owns privately only the
        partial boundary page onward. ``lora_id`` prefills the prefix
        through that adapter's merged weights; only requests wearing the
        same adapter may then use it. Dense GPT only (the block-extend
        forward has no expert routing)."""
        if self._moe:
            raise ValueError("prefix caching supports the dense GPT only")
        self._check_lora_id(lora_id)
        plen = len(tokens)
        limit = self.cfg.ctx_len - self.chunk - 1
        if not (0 < plen <= limit):
            raise ValueError(
                f"prefix length must be in (0, ctx_len - chunk - 1] = "
                f"(0, {limit}]; got {plen}")
        ids = torch.tensor([list(tokens)], dtype=torch.long,
                           device=self.device)
        _, cache = self._run_prefill(self._prefill_params(lora_id), ids)
        shared: List[int] = []
        if self._paged:
            nfull = plen // self._page
            if nfull > self._allocator.n_free:
                raise ValueError(
                    f"prefix needs {nfull} pages, "
                    f"{self._allocator.n_free} free")
            shared = self._allocator.alloc(nfull)
            self._shared_held += nfull
            if nfull:
                from .paged import _scatter_pages

                full = np.zeros((self.cfg.ctx_len // self._page,), np.int32)
                full[:nfull] = shared
                self._cache = _scatter_pages(
                    self._cache, cache["k"], cache["v"],
                    torch.tensor(full, device=self.device))
        pid = next(self._prefix_ids)
        self._prefixes[pid] = _Prefix(cache["k"], cache["v"], plen, shared,
                                      lora_id, list(tokens))
        return pid

    def _tp_cache(self, shape):
        """Mesh serving's slot cache: per tp rank, (L, n_slots, its KV
        heads, ctx, d) on its device; ``pos`` on rank 0's."""
        from ..parallel.sharding import tp_kv_heads

        mesh, cfg = self._tp_mesh, self.cfg
        dt = cfg.compute_dtype

        def bufs():
            return [torch.zeros(shape[:2] + (len(tp_kv_heads(
                cfg, mesh.size, r)),) + shape[3:], dtype=dt, device=dev)
                    for r, dev in enumerate(mesh.rank_devices)]

        return {"k": bufs(), "v": bufs(),
                "pos": torch.zeros((shape[1],), dtype=torch.int32,
                                   device=self.device)}

    def _run_prefill(self, params, ids, length=None):
        """The admission prefill: tensor-parallel over the mesh, MoE or
        dense (``params``: the weights the admission reads)."""
        if self._tp_mesh is not None:
            from ..parallel.sharding import tp_prefill

            return tp_prefill(self.params, ids, self.cfg, self._tp_mesh,
                              length)
        prefill = moe_prefill if self._moe else gpt_prefill
        return prefill(params, ids, self.cfg, length=length)

    def _match_prefix(self, prompt, lora_id: int):
        """The longest registered prefix (same adapter) that is a PROPER
        prefix of ``prompt``, as (prefix_id, length), or None: admission
        needs at least one suffix token (in speculative mode the suffix
        supplies the pending token)."""
        best = None
        plen = len(prompt)
        for pid, entry in self._prefixes.items():
            toks = entry.tokens
            n = len(toks)
            if (entry.lora_id != lora_id or not 0 < n < plen
                    or (best is not None and n <= best[1])):
                continue
            if list(prompt[:n]) == list(toks):
                best = (pid, n)
        return best

    # -- the page cache (content-addressed pooled prompt pages) -------------

    def _pc_chain(self, tokens, lora_id: int) -> List[bytes]:
        """Chain keys of the FULL ``page``-sized blocks of ``tokens``: key
        i is a running sha1 over the adapter id and blocks 0..i, so a hit
        means the whole token prefix up to that block matches, and the
        pooled rows are the ones a cold prefill would write."""
        h = hashlib.sha1(str(int(lora_id)).encode())
        arr = np.asarray(tokens, np.int32)
        keys = []
        for i in range(len(arr) // self._page):
            h.update(arr[i * self._page:(i + 1) * self._page].tobytes())
            keys.append(h.digest())
        return keys

    def _pc_evict(self, need: int) -> None:
        """Release up to ``need`` pages of refs-0 cache entries, the least
        recently hit first."""
        freed = 0
        for key in list(self._pcache):
            if freed >= need:
                break
            page, refs = self._pcache[key]
            if refs:
                continue
            del self._pcache[key]
            self._allocator.release([page])
            self.stats["page_cache_evicted"] += 1
            freed += 1

    def _check_lora_id(self, lora_id: int) -> None:
        if lora_id and (not self._max_loras or lora_id > self._n_loras):
            raise ValueError(f"unknown lora_id {lora_id} "
                             f"({self._n_loras} registered)")

    def _prefill_params(self, lora_id: int):
        """The dense weights an admission of adapter ``lora_id`` prefills
        and extends with: the base, or the base merged with the adapter's
        stack row for this admission only (``lora_merge_stacks``)."""
        if not lora_id:
            return self.params
        from ..models.lora import lora_merge_stacks

        return lora_merge_stacks(self.params, self._lora_stacks, lora_id)

    def register_lora(self, adapters, lcfg) -> int:
        """Register a LoRA adapter (``models.lora`` dict and config) for
        per-request serving; returns its ``lora_id``. Requests wearing
        different adapters still batch in one decode chunk (the per-slot
        low-rank side-path). Registration writes one row of the stacks
        allocated at construction (``max_loras``): N adapters cost N stack
        rows, never N model copies."""
        from ..models.lora import stack_lora

        if not self._max_loras:
            raise ValueError(
                "construct the engine with max_loras=N to serve adapters")
        if self._n_loras >= self._max_loras:
            raise ValueError(
                f"all {self._max_loras} adapter slots are registered")
        idx = self._n_loras + 1
        stack_lora(self._lora_stacks, adapters, lcfg, idx)
        self._n_loras = idx
        return idx

    def submit(self, req: Request) -> int:
        """Queue a request; returns its assigned request_id. Any prompt
        within the ctx budget admits: longer than ``prefill_window`` it is
        prefilled a window at a time (chunked prefill). MoE engines keep
        ``prefill_window`` as a cap: the block-extend forward has no
        expert routing."""
        plen = len(req.prompt)
        if plen == 0:
            raise ValueError("empty prompt")
        if self._auto_prefix and req.prefix_id is None:
            hit = self._match_prefix(req.prompt, req.lora_id)
            if hit is not None:
                pid, n = hit
                req = dataclasses.replace(
                    req, prefix_id=pid, prompt=list(req.prompt[n:]))
                plen = len(req.prompt)
        if plen > self.prefill_window and self._moe:
            raise ValueError(
                f"prompt length {plen} exceeds prefill_window "
                f"{self.prefill_window} (chunked prefill needs the dense "
                "block-extend forward; MoE prompts are capped)")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        pref_len = 0
        if req.prefix_id is not None:
            if req.prefix_id not in self._prefixes:
                raise ValueError(f"unknown prefix_id {req.prefix_id}")
            pref_len = self._prefixes[req.prefix_id].plen
        self._check_lora_id(req.lora_id)
        if req.prefix_id is not None:
            # a cached prefix KV bakes in the projections it was prefilled
            # with: usable only by the same adapter
            pref_lora = self._prefixes[req.prefix_id].lora_id
            if pref_lora != req.lora_id:
                raise ValueError(
                    f"prefix {req.prefix_id} was prefilled with adapter "
                    f"{pref_lora}; request wears {req.lora_id} — register "
                    f"a per-adapter prefix (register_prefix(..., "
                    f"lora_id={req.lora_id}))")
        if self._ring:
            # ring slots have unbounded positions: only the prompt must
            # fit the bounded prefill
            if pref_len + plen > self.cfg.ctx_len:
                raise ValueError(
                    f"prefix ({pref_len}) + prompt ({plen}) exceeds "
                    f"ctx_len {self.cfg.ctx_len} (the prefill is bounded "
                    f"even in ring mode)")
        else:
            self._check_budget(req, pref_len, plen)
        req = dataclasses.replace(req, request_id=next(self._ids))
        self._submit_ts[req.request_id] = time.perf_counter()
        self._queue.append(req)
        return req.request_id

    def _check_budget(self, req: Request, pref_len: int, plen: int):
        """The bounded engines' submit check: prefix + prompt + the
        reserved decode budget fit ``ctx_len``, and in paged mode the
        private pages fit a pool an idle engine can free."""
        reserved = self._reserved(req)
        if pref_len + plen + reserved > self.cfg.ctx_len:
            how = ("max_new_tokens + 2(n_draft+1) speculative slack"
                   if self._spec else
                   f"max_new_tokens rounded up to the {self.chunk}-token "
                   f"chunk")
            raise ValueError(
                f"prefix ({pref_len}) + prompt ({plen}) + reserved decode "
                f"budget ({reserved} = {how}) exceeds ctx_len "
                f"{self.cfg.ctx_len}")
        if self._paged:
            need = -(-(pref_len + plen + reserved) // self._page)
            if req.prefix_id is not None:
                need -= len(self._prefixes[req.prefix_id].shared)
            # pages an idle engine can hand out: all but the trash page
            # and the prefix-pinned shared pages
            cap = self._allocator.n_pages - 1 - self._shared_held
            if need > cap:
                raise ValueError(
                    f"request needs {need} private pages but the pool can "
                    f"free at most {cap} (raise n_pages or lower "
                    f"max_new_tokens)")

    # -- engine loop --------------------------------------------------------

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self._slot_req)

    @property
    def pending(self) -> int:
        return len(self._queue)

    def _reserved(self, req: Request) -> int:
        """Decode-budget cache rows an admission reserves: speculative
        rounds advance up to S = K + 1 rows past the budget gate and the
        block write needs S rows of headroom (2S slack); plain chunks round
        the budget up to the chunk size."""
        if self._spec:
            return req.max_new_tokens + 2 * (self._spec + 1)
        return -(-req.max_new_tokens // self.chunk) * self.chunk

    def _page_cache_hits(self, req: Request):
        """(hits [(key, entry)], chain keys) of a page-cache admission:
        the longest run of cached full blocks of the prefill's tokens
        (speculative mode leaves the pending token out), capped so that a
        plain admission keeps at least one token to prefill."""
        pf_len = len(req.prompt) - 1 if self._spec else len(req.prompt)
        keys = self._pc_chain(req.prompt[:pf_len], req.lora_id)
        cap = (pf_len if self._spec else pf_len - 1) // self._page
        hits = []
        for key in keys[:cap]:
            ent = self._pcache.get(key)
            if ent is None:
                break
            hits.append((key, ent))
        return hits, keys

    def _reserve_pages(self, slot: int, req: Request, shared: List[int],
                       hits):
        """Paged admission control: reserve every page the request can
        touch less the shared ones it reads in place, evicting refs-0
        page-cache entries (this request's hits protected) when the pool
        is short. Returns (private pages, table ids, scatter ids) or None
        when the request must wait. Shared entries scatter into the trash
        page: no admission rewrites a shared page."""
        pref_len = (self._prefixes[req.prefix_id].plen
                    if req.prefix_id is not None else 0)
        need = -(-(pref_len + len(req.prompt) + self._reserved(req))
                 // self._page)
        npriv = need - len(shared)
        if npriv > self._allocator.n_free and self._page_cache:
            for _, ent in hits:
                ent[1] += 1
            self._pc_evict(npriv - self._allocator.n_free)
            for _, ent in hits:
                ent[1] -= 1
        if npriv > self._allocator.n_free:
            return None
        pages = self._allocator.alloc(npriv)
        self._slot_pages[slot] = pages  # retire frees only these
        full = np.zeros((self.cfg.ctx_len // self._page,), np.int32)
        full[:need] = shared + pages  # tail entries stay 0 (trash)
        scatter = full.copy()
        scatter[:len(shared)] = 0
        return pages, full, scatter

    def _prefill_kv(self, req: Request, prompt, hit_ids):
        """The admission's dense KV: (k, v, next-token logits or None,
        rows). From the registered prefix, the gathered page-cache hits
        (``hit_ids``), or a prefill of the first window; then the rest of
        ``prompt`` block-extends a window at a time. All of it in the
        compute dtype, through the request's adapter merged into the
        weights when it wears one (int8 engines prefill in full
        precision too)."""
        cfg, W, dev = self.cfg, self.prefill_window, self.device
        params = self._prefill_params(req.lora_id)
        if req.prefix_id is not None:
            entry = self._prefixes[req.prefix_id]
            pk, pv, pos = entry.k, entry.v, entry.plen
            rest, logits = prompt, None
        elif hit_ids is not None:
            from .paged import _gather_prefix_pages

            pk, pv = _gather_prefix_pages(
                self._cache, torch.tensor(hit_ids, device=dev))
            pos = int(np.count_nonzero(hit_ids)) * self._page
            rest, logits = prompt[pos:], None
        else:
            first = min(len(prompt), W)
            ids = np.zeros((1, W), np.int64)
            ids[0, :first] = prompt[:first]
            with span("serve.prefill"):
                logits, cache = self._run_prefill(
                    params, torch.tensor(ids, device=dev), length=first)
            pk, pv = cache["k"], cache["v"]
            pos, rest = first, prompt[first:]
        ops = None
        for off in range(0, len(rest), W):
            if ops is None:
                ops = (_dt_decode_ops(params, cfg) if req.lora_id
                       else self._dense_ops)
            with span("serve.extend"):
                ids = torch.tensor(rest[off:off + W][None],
                                   dtype=torch.long, device=dev)
                logits, pk, pv = _extend_prefix(ops, cfg, pk, pv, pos, ids)
            pos += ids.shape[1]
        return pk, pv, logits, pos

    def _admit(self, slot: int, req: Request) -> bool:
        """Admit ``req`` into the free ``slot``; False when the page pool
        cannot hold it yet."""
        with span("serve.admit", args={"request": req.request_id,
                                       "prompt": len(req.prompt)}):
            return self._admit_into(slot, req)

    def _admit_into(self, slot: int, req: Request) -> bool:
        cfg = self.cfg
        shared: List[int] = []
        if req.prefix_id is not None:
            shared = self._prefixes[req.prefix_id].shared
        hits, keys = [], None
        if self._page_cache and req.prefix_id is None:
            hits, keys = self._page_cache_hits(req)
            shared = [ent[0] for _, ent in hits]
        if self._paged:
            got = self._reserve_pages(slot, req, shared, hits)
            if got is None:
                return False
            pages, table_ids, scatter_ids = got
        prompt = np.asarray(req.prompt, np.int64)
        if self._spec:
            # the last prompt token stays unprocessed: the pending token of
            # the first round (admission logits are never sampled from)
            pending_tok, prompt = int(prompt[-1]), prompt[:-1]
        hit_ids = None
        if hits:  # the gather reads the hit pages only
            hit_ids = table_ids.copy()
            hit_ids[len(hits):] = 0
        pk, pv, logits, total = self._prefill_kv(req, prompt, hit_ids)
        if logits is None:  # speculative prefix + a one-token prompt
            logits = torch.zeros((1, cfg.vocab_size), dtype=torch.float32,
                                 device=self.device)
        if self._paged:
            from .paged import _admit_slot_paged

            self._cache, self._logits = _admit_slot_paged(
                self._cache, self._logits, pk, pv, total, logits, slot,
                torch.tensor(scatter_ids, device=self.device),
                torch.tensor(table_ids, device=self.device), cfg)
        elif self._ring:
            self._cache, self._logits = _admit_slot_ring(
                self._cache, self._logits, pk, pv, total, logits, slot, cfg)
        else:
            self._cache, self._logits = _admit_slot(
                self._cache, self._logits, pk, pv, total, logits, slot)
        if self._max_loras:
            # a reused slot drops its previous occupant's adapter
            self._cache = _set_slot_lora(self._cache, slot, req.lora_id)
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
        if self._spec:
            # history = prefix tokens + the full prompt (the pending token
            # included): drafting copies continuations of earlier n-grams
            full = list(req.prompt)
            if req.prefix_id is not None:
                full = self._prefixes[req.prefix_id].tokens + full
            hist = torch.zeros((cfg.ctx_len,), dtype=torch.long)
            hist[:len(full)] = torch.tensor(full, dtype=torch.long)
            self._cache = _set_slot_spec(self._cache, slot,
                                         hist.to(self.device), pending_tok)
            self._budget[slot] = req.max_new_tokens
            self._samp_dev = None  # the budget vector rides with sampling
        if keys is not None:
            # pin the hits for the slot's lifetime; the private pages that
            # hold full prompt blocks are insert candidates at retirement
            # (logical block j >= len(hits) lives in pages[j - len(hits)])
            for key, ent in hits:
                ent[1] += 1
                self._pcache.move_to_end(key)
            ins = [(keys[j], pages[j - len(hits)])
                   for j in range(len(hits), len(keys))]
            self._slot_pc[slot] = ([k for k, _ in hits], ins)
            self.stats["page_cache_hits"] += len(hits)
        self.stats["prefills"] += 1
        return True

    def _free_pages(self, slot: int) -> None:
        """Paged retire: point the slot's table row at the trash page and
        return its private pages to the pool. With the page cache, first
        unpin the admission's hits and move the slot's full prompt pages
        into the cache (refs 0: reusable, reclaimable) instead of freeing
        them; a key already cached (an identical request retired first)
        frees its page as usual."""
        if self._paged and self._slot_pages[slot]:
            from .paged import _reset_table_row

            self._cache = _reset_table_row(self._cache, slot)
            pages = self._slot_pages[slot]
            if self._page_cache and self._slot_pc[slot] is not None:
                hit_keys, ins = self._slot_pc[slot]
                self._slot_pc[slot] = None
                for k in hit_keys:
                    self._pcache[k][1] -= 1
                kept = set()
                for key, page in ins:
                    if key not in self._pcache:
                        self._pcache[key] = [page, 0]
                        kept.add(page)
                pages = [p for p in pages if p not in kept]
            self._allocator.release(pages)
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
        if self._spec:  # the device gate freezes the slot from now on
            self._budget[slot] = 0
            self._samp_dev = None
        self._free_pages(slot)

    def _account(self, slot: int, rows: np.ndarray) -> None:
        """Take one chunk's emitted tokens of ``slot``: extend its stream,
        scan for the stop token, finish at the budget."""
        req = self._slot_req[slot]
        self._slot_toks[slot].append(rows)
        self._count[slot] += len(rows)
        budget = req.max_new_tokens
        if req.stop_token >= 0:
            seq = self._slot_tokens(slot)
            new = seq[self._scanned[slot]:min(self._count[slot], budget)]
            hits = np.nonzero(new == req.stop_token)[0]
            if hits.size:
                end = self._scanned[slot] + int(hits[0]) + 1
                self._finish(slot, seq[:end].tolist(), "stop")
                return
            self._scanned[slot] = min(self._count[slot], budget)
        if self._count[slot] >= budget:
            self._finish(slot, self._slot_tokens(slot)[:budget].tolist(),
                         "length")

    def step(self) -> bool:
        """Admit queued requests into free slots, then advance every active
        slot by one decode chunk. Returns False when fully idle."""
        with span("serve.step"):
            return self._step()

    def _step(self) -> bool:
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
            if self._spec:
                self._samp_dev += (torch.tensor(self._budget,
                                                device=self.device),)
        active = [s for s in range(self.n_slots)
                  if self._slot_req[s] is not None]
        self.stats["chunks"] += 1
        if self._spec:
            self._step_spec(active)
            return True
        with span("serve.decode"):
            if self._paged:
                from .paged import decode_chunk_paged

                toks, self._logits, self._cache = decode_chunk_paged(
                    self._ops, self._cache, self._logits, self._gen,
                    *self._samp_dev, self.cfg, self.chunk,
                    use_kernel=self._paged_kernel)
            elif self._ring:
                from ..models.stream import stream_chunk_slots

                toks, self._logits, self._cache = stream_chunk_slots(
                    self._ops, self._cache, self._logits, self._gen,
                    *self._samp_dev, self.cfg, self.chunk)
            else:
                toks, self._logits, self._cache = decode_chunk_slots(
                    self._ops, self._cache, self._logits, self._gen,
                    *self._samp_dev, self.cfg, self.chunk)
        with span("serve.fetch"):
            toks = toks.cpu().numpy()  # the one host sync per chunk
        with span("serve.account"):
            for slot in active:
                self._account(slot, toks[slot])
        return True

    def _step_spec(self, active: List[int]) -> None:
        """One speculative chunk (``_spec_rounds`` draft + verify rounds)
        for the ``active`` slots; its tokens and valid counts come to the
        host in one copy, and each slot takes its valid rows."""
        from .spec import decode_chunk_spec

        with span("serve.decode"):
            toks, valid, self._cache = decode_chunk_spec(
                self._ops, self._cache, self._gen, *self._samp_dev,
                self.cfg, self._spec_rounds, self._spec)
            B, R, S = toks.shape
            host = torch.cat([toks.reshape(B, R * S).long(), valid.long()],
                             1)
        with span("serve.fetch"):
            host = host.cpu().numpy()
        rows, v = host[:, :R * S].reshape(B, R, S), host[:, R * S:]
        # rounds of the engine, and rounds a request was in a slot
        self.stats["spec_rounds"] = self.stats.get("spec_rounds", 0) + R
        self.stats["spec_slot_rounds"] = (
            self.stats.get("spec_slot_rounds", 0) + R * len(active))
        with span("serve.account"):
            for slot in active:
                self._account(slot, np.concatenate(
                    [rows[slot, r, :n] for r, n in enumerate(v[slot])]))

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
