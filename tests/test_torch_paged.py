"""The port's paged KV layer (linalg_tpu_torch/serve/paged.py) against the
JAX package's.

``paged_attention_ref`` — the plain PyTorch version of the CUDA
paged-attention kernel, and what ``paged_attention`` computes for CPU
tensors — is held against both Pallas kernels it replaces
(``paged_attn_pallas_dma`` and ``paged_attn_pallas``), run in interpret
mode on the CPU as tests/test_paged.py runs them; the grid kernel also at
d 256, 96 and 8 (the DMA kernel folds rows for d < 128). The plain
versions of the CUDA kernel's two halves, ``paged_attention_partials_ref``
(split-K over each slot's live tiles) and ``paged_attention_combine_ref``,
composed at several split counts (empty splits included), must give the
same attention. The kernel itself is held against ``paged_attention_ref``
on a CUDA card by tests/test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_tpu.models.gpt import GPTConfig as JCfg
from linalg_tpu.models.gpt import init_gpt_params as jinit
from linalg_tpu.serve import ServeEngine as JEngine
from linalg_tpu.serve.paged import paged_attn_pallas, paged_attn_pallas_dma
from linalg_tpu_torch.kernels.paged_attention import (TILE_ROWS, head_block,
                                                      paged_splits)
from linalg_tpu_torch.models.gpt import GPTConfig
from linalg_tpu_torch.serve.engine import pick_paged_kernel
from linalg_tpu_torch.serve.paged import (NEG_INIT, PageAllocator, _pages_of,
                                          _scatter_pages, init_paged_cache,
                                          paged_attention_combine_ref,
                                          paged_attention_partials_ref,
                                          paged_attention_ref, split_rows)
from test_torch_kernels import ATOL, EXTRA_SHAPES, RTOL, SHAPES, paged_inputs

torch.set_num_threads(2)


def _pallas_cases():
    cases = [pytest.param(pallas, H, hk, d, id=f"{H}-{hk}-{d}-{name}")
             for H, hk, d in SHAPES
             for name, pallas in (("dma", paged_attn_pallas_dma),
                                  ("grid", paged_attn_pallas))]
    return cases + [pytest.param(paged_attn_pallas, H, hk, d,
                                 id=f"{H}-{hk}-{d}-grid")
                    for H, hk, d in EXTRA_SHAPES]


@pytest.mark.parametrize("pallas,H,hk,d", _pallas_cases())
def test_ref_matches_pallas(pallas, H, hk, d):
    args = paged_inputs(H, hk, d, seed=H * 100 + hk * 10 + d)
    want = np.asarray(pallas(*(jnp.asarray(a) for a in args)))
    got = paged_attention_ref(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


# split counts: one, two, Pmax (4) and more than the live tiles (empty
# splits); page 16 makes a tile shorter than TILE_ROWS, page 80 gives a
# page of three tiles, the last one short
SPLITS = (1, 2, 4, 11)


@pytest.mark.parametrize("page", [16, 80])
@pytest.mark.parametrize("S", SPLITS)
@pytest.mark.parametrize("H,hk,d", SHAPES + EXTRA_SHAPES)
def test_split_and_combine_match_ref_and_pallas(H, hk, d, S, page):
    """The partials plain version over S splits, merged by the combine
    plain version, is the attention of ``paged_attention_ref`` and of
    JAX's grid kernel (interpret mode), in float32."""
    args = paged_inputs(H, hk, d, seed=H * 100 + hk * 10 + d + S, page=page)
    targs = [torch.from_numpy(a) for a in args]
    m, l, acc = paged_attention_partials_ref(*targs, S)
    B = targs[0].shape[0]
    assert m.shape == l.shape == (B, H, S) and acc.shape == (B, H, S, d)
    got = paged_attention_combine_ref(m, l, acc, torch.float32)
    assert got.shape == (B, H, 1, d)
    np.testing.assert_allclose(got.numpy(),
                               paged_attention_ref(*targs).numpy(),
                               rtol=RTOL, atol=ATOL)
    want = np.asarray(paged_attn_pallas(*(jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_split_rule_covers_the_live_tiles_once():
    """Splits are contiguous row ranges, in order, ending at the last
    live page; an empty split holds NEG_INIT, 0 and 0."""
    page, Pmax, S = 80, 3, 7
    pos = torch.tensor([0, 79, 80, 200, 10_000], dtype=torch.int32)
    lo, hi = split_rows(pos, page, Pmax, S)
    n_live = torch.tensor([1, 1, 2, 3, 3])
    assert torch.equal(lo[:, 0], torch.zeros(5, dtype=torch.long))
    assert torch.equal(hi[:, -1], n_live * page)
    assert torch.equal(lo[:, 1:], hi[:, :-1]) and bool((hi >= lo).all())
    # every split is whole tiles: starts at a tile edge of its page
    assert bool(((lo % page) % TILE_ROWS == 0).all())
    args = [torch.from_numpy(a) for a in
            paged_inputs(4, 2, 16, seed=9, B=5, page=page, Pmax=Pmax)]
    args[-1] = pos
    m, l, acc = paged_attention_partials_ref(*args, S)
    empty = (hi == lo)[:, None].expand_as(m)
    assert bool(empty.any())
    assert bool((m[empty] == NEG_INIT).all() and (l[empty] == 0).all())
    assert bool((acc[empty] == 0).all())


@pytest.mark.parametrize("B,H,hk,page,Pmax,n_sm,want", [
    (8, 4, 2, 256, 16, 132, 17),    # the serving shape: 2 waves of 132
    (8, 8, 1, 256, 16, 132, 33),    # K6's shape (g 8)
    (1, 4, 2, 256, 16, 132, 128),   # B 1: capped at the tiles in ctx
    (64, 32, 8, 256, 16, 132, 1),   # many slots: one split
    (2, 16, 1, 16, 4, 132, 4),      # g 16: two blocks per KV head
])
def test_paged_splits(B, H, hk, page, Pmax, n_sm, want):
    assert paged_splits(B, H, hk, page, Pmax, n_sm) == want


def test_head_block():
    assert [head_block(g) for g in (1, 2, 3, 4, 5, 8, 9, 16)] == [
        1, 2, 4, 4, 8, 8, 8, 8]


@pytest.mark.parametrize("d_head", [64, 128, 256])
def test_auto_rule_matches_jax(monkeypatch, d_head):
    """``pick_paged_kernel`` for "auto" on the card against the JAX
    engine's rule on its TPU backend, for ctx 2048 and 1024 and a page
    that is not a multiple of 8; never off CUDA; "kernel" always."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for ctx, page in ((2048, 256), (1024, 256), (2048, 4)):
        cfg = JCfg(vocab_size=8, d_model=2 * d_head, n_heads=2, n_layers=1,
                   ctx_len=ctx)
        want = JEngine(jinit(cfg, seed=0), cfg, n_slots=1, chunk=4,
                       paged=True, page=page,
                       paged_attn="auto")._paged_kernel
        assert pick_paged_kernel("auto", "cuda", page, ctx,
                                 d_head) == want, (ctx, page)
        assert not pick_paged_kernel("auto", "cpu", page, ctx, d_head)
        assert pick_paged_kernel("kernel", "cpu", page, ctx, d_head)


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
