"""The port's paged KV layer (linalg_tpu_torch/serve/paged.py) against the
JAX package's.

``paged_attention_ref`` — the plain PyTorch version of the CUDA
paged-attention kernel, and what ``paged_attention`` computes for CPU
tensors — is held against both Pallas kernels it replaces
(``paged_attn_pallas_dma`` and ``paged_attn_pallas``), run in interpret
mode on the CPU as tests/test_paged.py runs them. The kernel itself is
held against ``paged_attention_ref`` on a CUDA card by
tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_tpu.serve.paged import paged_attn_pallas, paged_attn_pallas_dma
from linalg_tpu_torch.models.gpt import GPTConfig
from linalg_tpu_torch.serve.paged import (PageAllocator, _pages_of,
                                          _scatter_pages, init_paged_cache,
                                          paged_attention_ref)
from test_torch_kernels import ATOL, RTOL, SHAPES, paged_inputs

torch.set_num_threads(2)


@pytest.mark.parametrize("pallas", [paged_attn_pallas_dma, paged_attn_pallas],
                         ids=["dma", "grid"])
@pytest.mark.parametrize("H,hk,d", SHAPES)
def test_ref_matches_pallas(pallas, H, hk, d):
    args = paged_inputs(H, hk, d, seed=H * 100 + hk * 10 + d)
    want = np.asarray(pallas(*(jnp.asarray(a) for a in args)))
    got = paged_attention_ref(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


class TestPagedCache:
    CFG_KW = dict(vocab_size=31, d_model=32, n_heads=2, n_layers=2,
                  ctx_len=64)
    CFG = GPTConfig(**CFG_KW)

    def test_allocator_roundtrip_and_overflow(self):
        a = PageAllocator(8)
        assert a.n_free == 7  # page 0 is trash
        got = a.alloc(3)
        assert len(set(got)) == 3 and all(0 < p < 8 for p in got)
        with pytest.raises(MemoryError):
            a.alloc(5)
        a.release(got)
        assert a.n_free == 7
        with pytest.raises(ValueError):
            a.release([0])

    def test_init_validation(self):
        with pytest.raises(ValueError, match="divide"):
            init_paged_cache(self.CFG, 2, 8, 24)
        with pytest.raises(ValueError, match="trash"):
            init_paged_cache(self.CFG, 2, 1, 16)

    def test_pages_of_and_scatter_match_jax(self):
        from linalg_tpu.serve import paged as jpaged

        rng = np.random.default_rng(0)
        L, hk, ctx, d, page = 2, 2, 64, 16, 16
        x = rng.normal(size=(L, 1, hk, ctx, d)).astype(np.float32)
        np.testing.assert_array_equal(
            _pages_of(torch.from_numpy(x), page).numpy(),
            np.asarray(jpaged._pages_of(jnp.asarray(x), page)))
        cfg = self.CFG
        ids = np.array([3, 1, 0, 0], np.int32)
        cache = init_paged_cache(cfg, 2, 5, page)
        _scatter_pages(cache, torch.from_numpy(x), torch.from_numpy(-x),
                       torch.from_numpy(ids))
        jcache = jpaged._scatter_pages(
            jpaged.init_paged_cache(jpaged.GPTConfig(**self.CFG_KW), 2, 5,
                                    page),
            jnp.asarray(x), jnp.asarray(-x), jnp.asarray(ids))
        for key in ("pool_k", "pool_v"):  # page 0 is trash: not compared
            np.testing.assert_array_equal(
                cache[key][:, 1:].numpy(),
                np.asarray(jcache[key])[:, 1:])
