"""Continuous-batching serving for the GPT: the slot engine, the paged KV
pool (plain or int8) and ring mode, with chunked prefill, shared
prefixes, the page cache, speculative decoding, int8 weights and
multi-LoRA."""

from .engine import Completion, Request, ServeEngine, serve
from .paged import PageAllocator, decode_chunk_paged, init_paged_cache
from .spec import decode_chunk_spec, spec_cache_fields

__all__ = ["Request", "Completion", "ServeEngine", "serve",
           "PageAllocator", "decode_chunk_paged", "init_paged_cache",
           "decode_chunk_spec", "spec_cache_fields"]
