"""Chunked prefill, registered prefixes, ``auto_prefix`` and the page cache
of the port's serving engine (linalg_tpu_torch/serve/engine.py,
serve/paged.py) and CLI against the JAX package's, end to end on the CPU.

The same requests go through the JAX ``ServeEngine`` and the port's, in
slot mode and in paged mode with both attention reads (on CPU tensors the
kernel read computes its plain version): float32 greedy tokens must be
EQUAL, and so must the completions' prompt lengths (which show what an
admission reused) and the page cache's hit and eviction counts. Every
page not pinned by a registered prefix or held by the page cache must be
back in the pool after ``run()``. Widths are small (2 layers, d 64, 2 KV
heads of d 16, ctx 128, page 8, prefill window 16).
"""

import json

import numpy as np
import pytest
import torch

from linalg_tpu.models.gpt import GPTConfig as JCfg
from linalg_tpu.models.gpt import init_gpt_params as jinit
from linalg_tpu.serve import Request as JRequest
from linalg_tpu.serve import ServeEngine as JEngine
from linalg_tpu_torch.models.gpt import GPTConfig, init_gpt_params
from linalg_tpu_torch.serve import Request, ServeEngine
from linalg_tpu_torch.serve.paged import (_gather_prefix_pages,
                                          _scatter_pages, init_paged_cache)

torch.set_num_threads(2)

CFG_KW = dict(vocab_size=31, d_model=64, n_heads=4, n_kv_heads=2,
              n_layers=2, ctx_len=128)
CFG = GPTConfig(**CFG_KW)
PARAMS = init_gpt_params(CFG, seed=7)
JPARAMS = jinit(JCfg(**CFG_KW), seed=7)
ENGINE_KW = dict(n_slots=3, chunk=4, top_k=1, prefill_window=16)
MODES = {
    "slot": dict(),
    "paged-gather": dict(paged=True, page=8, paged_attn="gather"),
    "paged-kernel": dict(paged=True, page=8, paged_attn="kernel"),
}
_JAX = {}


def ids(rng, lo, hi):
    return rng.integers(0, CFG.vocab_size, int(rng.integers(lo, hi + 1))
                        ).tolist()


def run(make, request, reqs, prefixes=(), **kw):
    """Register ``prefixes``, submit ``reqs`` ((prompt, budget, prefix
    index or None)), run; returns ([(tokens, prompt_len)], engine)."""
    eng = make(**kw)
    pids = [eng.register_prefix(p) for p in prefixes]
    rids = [eng.submit(request(p, n, prefix_id=None if i is None
                               else pids[i])) for p, n, i in reqs]
    done = {c.request_id: c for c in eng.run()}
    return [(done[r].tokens, done[r].prompt_len) for r in rids], eng


def port(reqs, prefixes=(), **kw):
    out, eng = run(lambda **k: ServeEngine(PARAMS, CFG, device="cpu", **k),
                   Request, reqs, prefixes, **dict(ENGINE_KW, **kw))
    if eng._allocator is not None:
        held = eng._shared_held + len(eng._pcache)
        assert eng._allocator.n_free == eng._allocator.n_pages - 1 - held
    return out, eng


def jax(name, reqs, prefixes=(), **kw):
    """The JAX engine's result for scenario ``name``, computed once."""
    if name not in _JAX:
        _JAX[name] = run(lambda **k: JEngine(JPARAMS, JCfg(**CFG_KW), **k),
                         JRequest, reqs, prefixes, **dict(ENGINE_KW, **kw))
    return _JAX[name]


def prefix_scenario():
    rng = np.random.default_rng(0)
    # a prefix of whole pages and one ending inside a page
    prefixes = [ids(rng, 24, 24), ids(rng, 29, 29)]
    reqs = [(ids(rng, 1, 5), 6, 0), (ids(rng, 3, 40), 9, 1),
            (ids(rng, 3, 12), 5, None), (ids(rng, 17, 17), 7, 0),
            (ids(rng, 2, 9), 8, 1), (ids(rng, 30, 60), 4, 0)]
    return reqs, prefixes


@pytest.mark.parametrize("mode", sorted(MODES))
def test_registered_prefixes_match_jax(mode):
    """Requests with and without a prefix_id, suffixes of 1 to 60 ids
    (past the window: the suffix block-extends a window at a time)."""
    reqs, prefixes = prefix_scenario()
    want, _ = jax("prefix", reqs, prefixes)
    got, eng = port(reqs, prefixes, **MODES[mode])
    assert got == want
    if eng._paged:  # the full pages of both prefixes, pinned
        assert eng._shared_held == 24 // 8 + 29 // 8


@pytest.mark.parametrize("mode", sorted(MODES))
def test_prefix_equals_the_full_prompt(mode):
    """A prefix_id request's tokens equal those of its full prompt served
    without a prefix (the port alone)."""
    reqs, prefixes = prefix_scenario()
    got, _ = port(reqs, prefixes, **MODES[mode])
    full = [(p if i is None else prefixes[i] + p, n, None)
            for p, n, i in reqs]
    plain, _ = port(full, **MODES[mode])
    assert [t for t, _ in got] == [t for t, _ in plain]


def auto_scenario():
    rng = np.random.default_rng(1)
    p1 = ids(rng, 10, 10)
    p2 = p1 + ids(rng, 9, 9)  # nests p1
    reqs = [(p2 + ids(rng, 2, 5), 6, None),   # the longer prefix wins
            (p1 + ids(rng, 2, 5), 6, None),   # the shorter one
            (list(p2), 5, None),              # equal to p2: matches p1
            (list(p1), 5, None),              # equal to p1: no match
            (ids(rng, 5, 9), 6, None),        # no prefix
            (p2 + ids(rng, 20, 30), 4, None)]  # a chunked suffix
    return reqs, [p1, p2]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_auto_prefix_matches_jax(mode):
    """``auto_prefix``: full prompts, no prefix_id; the engine matches the
    longest registered PROPER prefix (the completion's prompt_len is the
    suffix's), and a prompt equal to a prefix matches nothing."""
    reqs, prefixes = auto_scenario()
    want, _ = jax("auto", reqs, prefixes, auto_prefix=True)
    got, _ = port(reqs, prefixes, auto_prefix=True, **MODES[mode])
    assert got == want
    assert [n for _, n in got] == [len(reqs[0][0]) - 19,
                                   len(reqs[1][0]) - 10, 9, 10,
                                   len(reqs[4][0]), len(reqs[5][0]) - 19]


def chunked_scenario():
    rng = np.random.default_rng(2)
    # 1, exactly the window, one past it, a multiple, the longest prompt
    # the budget admits (128 - 8 reserved)
    return [(rng.integers(0, 31, n).tolist(), 8, None)
            for n in (1, 16, 17, 48, 120)]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_chunked_prefill_matches_jax(mode):
    reqs = chunked_scenario()
    want, _ = jax("chunked", reqs)
    got, eng = port(reqs, **MODES[mode])
    assert got == want
    assert eng.stats["prefills"] == len(reqs)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_chunked_prefill_equals_one_shot(mode):
    """The same prompts with a window that holds each one whole."""
    reqs = chunked_scenario()
    got, _ = port(reqs, **MODES[mode])
    one, _ = port(reqs, **dict(MODES[mode], prefill_window=124))
    assert got == one


def page_cache_scenario():
    """Two waves over a shared 24-id head (three pages): the second wave's
    admissions hit the first wave's retired pages; then unrelated
    requests on a small pool evict them."""
    rng = np.random.default_rng(3)
    head = ids(rng, 24, 24)
    wave = [(head + ids(rng, 3, 12), 5, None) for _ in range(3)]
    wave2 = [(head + ids(rng, 3, 12), 5, None) for _ in range(3)]
    other = [(ids(rng, 20, 40), 6, None) for _ in range(3)]
    return wave + wave2 + other + [(list(wave[0][0]), 5, None)]


@pytest.mark.parametrize("mode", ["paged-gather", "paged-kernel"])
def test_page_cache_matches_jax(mode):
    """Tokens, hits and evictions equal the JAX engine's; warm admissions'
    tokens equal cold ones' (the same requests without the cache)."""
    reqs = page_cache_scenario()
    kw = dict(page_cache=True, n_pages=16)
    want, jeng = jax("page_cache", reqs, paged=True, page=8, **kw)
    got, eng = port(reqs, **dict(MODES[mode], **kw))
    assert got == want
    for key in ("page_cache_hits", "page_cache_evicted", "prefills"):
        assert eng.stats[key] == jeng.stats[key], key
    assert eng.stats["page_cache_hits"] > 0
    assert eng.stats["page_cache_evicted"] > 0
    cold, _ = port(reqs, **dict(MODES[mode], n_pages=16))
    assert got == cold


def test_page_cache_hits_a_repeat_and_keeps_one_token():
    """One slot, the same prompt twice: the second admission reuses every
    full page but the last block's worth (a plain admission keeps at least
    one token to prefill): 24 ids -> 2 of 3 pages."""
    rng = np.random.default_rng(4)
    p = ids(rng, 24, 24)
    got, eng = port([(p, 4, None), (p, 4, None)], paged=True, page=8,
                    page_cache=True, n_slots=1)
    assert got[0] == got[1] and eng.stats["page_cache_hits"] == 2


def test_shared_prefix_pages_fit_where_copies_cannot():
    """Prefix pages stand in every slot's table once: a pool that could
    not hold three private copies of the prefix serves three prefix
    requests at once, every slot's table starting with the same page ids,
    with the tokens of the slot engine."""
    rng = np.random.default_rng(5)
    prefix = ids(rng, 64, 64)  # 8 pages
    reqs = [(ids(rng, 2, 6), 6, 0) for _ in range(3)]
    # 8 shared + 3 x 2 private pages (suffix + budget) + trash: 15 < 3 x 9
    eng = ServeEngine(PARAMS, CFG, device="cpu", paged=True, page=8,
                      n_pages=16, paged_attn="kernel", **ENGINE_KW)
    pid = eng.register_prefix(prefix)
    for p, n, _ in reqs:
        eng.submit(Request(p, n, prefix_id=pid))
    eng.step()
    table = eng._cache["table"].numpy()
    shared = eng._prefixes[pid].shared
    assert eng.n_active == 3 and all(row[:8].tolist() == shared
                                     for row in table)
    done = {c.request_id: c.tokens for c in eng.run()}
    want, _ = port(reqs, [prefix])
    assert [done[i] for i in range(3)] == [t for t, _ in want]


def test_gather_prefix_pages_inverts_scatter():
    cache = init_paged_cache(CFG, 2, 40, 8)
    rng = np.random.default_rng(6)
    k = torch.tensor(rng.normal(size=(2, 1, 2, 128, 16)), dtype=torch.float32)
    v = torch.tensor(rng.normal(size=(2, 1, 2, 128, 16)), dtype=torch.float32)
    page_ids = torch.tensor(rng.permutation(np.arange(1, 40))[:16])
    _scatter_pages(cache, k, v, page_ids)
    gk, gv = _gather_prefix_pages(cache, page_ids)
    assert torch.equal(gk, k) and torch.equal(gv, v)
    gk[:] = 0  # a new tensor: the pool is untouched
    assert torch.equal(_gather_prefix_pages(cache, page_ids)[0], k)


class TestValidation:
    def test_prefix_refusals_match_jax(self):
        """Unknown prefix_id, a prefix past the length limit or too large
        for the pool, and an empty suffix: ValueErrors, as in JAX."""
        for make, req in ((lambda **k: ServeEngine(PARAMS, CFG, device="cpu",
                                                   **k), Request),
                          (lambda **k: JEngine(JPARAMS, JCfg(**CFG_KW), **k),
                           JRequest)):
            eng = make(**ENGINE_KW)
            with pytest.raises(ValueError, match="unknown prefix_id"):
                eng.submit(req([1, 2], 4, prefix_id=3))
            with pytest.raises(ValueError, match="prefix length"):
                eng.register_prefix(list(range(124)))
            pid = eng.register_prefix([1, 2, 3])
            with pytest.raises(ValueError, match="empty prompt"):
                eng.submit(req([], 4, prefix_id=pid))
            with pytest.raises(ValueError, match=r"prefix \(3\)"):
                eng.submit(req([1] * 118, 8, prefix_id=pid))
            small = make(paged=True, page=8, n_pages=4, **ENGINE_KW)
            with pytest.raises(ValueError, match="prefix needs 4 pages"):
                small.register_prefix([1] * 32)


def test_serve_cli_prefix_flags_match_jax_cli(tmp_path, capsys):
    """--prefix_file (with and without --auto_prefix) and --page_cache on
    a JAX-saved checkpoint: the port's --out lines equal the JAX CLI's,
    and the stats lines name the same page-cache hits."""
    from linalg_tpu.apps.gpt import build_parser as jparser
    from linalg_tpu.apps.gpt import serve_cli as jserve
    from linalg_tpu.nn.tokenizers import CharTokenizer
    from linalg_tpu.train.checkpoint import save_ckpt
    from linalg_tpu_torch.apps.gpt import build_parser, serve_cli

    tok = CharTokenizer("abcdefghijklmnopqrstuvwxyz .,'\n")
    cfg = JCfg(**dict(CFG_KW, vocab_size=tok.vocab_size))
    save_ckpt(tmp_path, jinit(cfg, seed=3), cfg, tok.stoi, tok.itos)
    (tmp_path / "prompts.txt").write_text(
        "the one\nand the other, at last\n\nz\nthe one\n", encoding="utf-8")
    (tmp_path / "prefix.txt").write_text("once upon a time, there was\n",
                                         encoding="utf-8")
    common = ["--serve", "--ckpt_dir", str(tmp_path), "--prompts",
              str(tmp_path / "prompts.txt"), "--gen_tokens", "10",
              "--n_slots", "2", "--chunk", "4", "--top_k", "1"]
    runs = {"prefix": ["--prefix_file", str(tmp_path / "prefix.txt")],
            "auto": ["--prefix_file", str(tmp_path / "prefix.txt"),
                     "--auto_prefix", "--paged", "--page", "8",
                     "--paged_attn", "kernel"],
            "page_cache": ["--paged", "--page", "8", "--page_cache",
                           "--n_slots", "1"]}

    def read(name):
        return [json.loads(ln) for ln in
                (tmp_path / name).read_text().splitlines()]

    for name, extra in runs.items():
        jserve(jparser().parse_args(common + extra + [
            "--out", str(tmp_path / f"j_{name}")]))
        jout = capsys.readouterr().out
        serve_cli(build_parser().parse_args(common + extra + [
            "--out", str(tmp_path / f"t_{name}"), "--device", "cpu"]))
        tout = capsys.readouterr().out
        assert read(f"t_{name}") == read(f"j_{name}"), name
        if name == "page_cache":
            line = [ln for ln in jout.splitlines() if "page cache" in ln]
            assert line and line[0] in tout
