"""Continuous-batching serving for the GPT: slot engine and paged KV pool."""

from .engine import Completion, Request, ServeEngine, serve
from .paged import PageAllocator, decode_chunk_paged, init_paged_cache

__all__ = ["Request", "Completion", "ServeEngine", "serve",
           "PageAllocator", "decode_chunk_paged", "init_paged_cache"]
