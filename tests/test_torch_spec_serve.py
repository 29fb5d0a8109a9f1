"""Speculative decoding inside the port's serving engine
(linalg_tpu_torch/serve/spec.py, ``ServeEngine(speculative=K)``) and the
CLI's ``--speculative``/``--draft_ckpt`` against the JAX package's, end
to end on the CPU.

The same weights (``init_gpt_params``) and requests go through both
packages in float32. Greedy (top_k 1) tokens must be EQUAL: one chunk of
``decode_chunk_spec`` (tokens, valid counts, positions), whole engines in
slot mode and in paged mode with the table gather (with prefixes,
chunked prefill, stop tokens and the page cache), the plain engine's
tokens, and the CLI's output. Widths are small (2 layers, d 64, 2 KV
heads, ctx 128, page 16).
"""

import builtins
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_tpu.models.gpt import GPTConfig as JCfg
from linalg_tpu.models.gpt import init_gpt_params as jinit
from linalg_tpu.serve import Request as JRequest
from linalg_tpu.serve import ServeEngine as JEngine
from linalg_tpu.serve.spec import decode_chunk_spec as jchunk
from linalg_tpu_torch.models.gpt import GPTConfig, init_gpt_params
from linalg_tpu_torch.serve import Request, ServeEngine
from linalg_tpu_torch.serve.spec import decode_chunk_spec

torch.set_num_threads(2)

CFG_KW = dict(vocab_size=31, d_model=64, n_heads=4, n_kv_heads=2,
              n_layers=2, ctx_len=128)
CFG = GPTConfig(**CFG_KW)
PARAMS = init_gpt_params(CFG, seed=7)
JPARAMS = jinit(JCfg(**CFG_KW), seed=7)
ENGINE_KW = dict(n_slots=3, chunk=8, top_k=1, prefill_window=16)
MODES = {"slot": dict(),
         "paged-gather": dict(paged=True, page=16, paged_attn="gather")}
_JAX = {}


def reqs_of(seed, budgets, lo=3, hi=12):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 31, int(rng.integers(lo, hi))).tolist(), int(n))
            for n in budgets]


def run(make, request, reqs, prefixes=(), stop=-1, **kw):
    eng = make(**kw)
    pids = [eng.register_prefix(p) for p in prefixes]
    rids = [eng.submit(request(r[0], r[1], stop_token=stop,
                               prefix_id=pids[r[2]] if len(r) > 2 else None))
            for r in reqs]
    done = {c.request_id: c for c in eng.run()}
    return [(done[i].tokens, done[i].finish_reason) for i in rids], eng


def port(reqs, prefixes=(), stop=-1, **kw):
    return run(lambda **k: ServeEngine(PARAMS, CFG, device="cpu", **k),
               Request, reqs, prefixes, stop, **dict(ENGINE_KW, **kw))


def jax_run(name, reqs, prefixes=(), stop=-1, **kw):
    if name not in _JAX:
        _JAX[name] = run(lambda **k: JEngine(JPARAMS, JCfg(**CFG_KW), **k),
                         JRequest, reqs, prefixes, stop,
                         **dict(ENGINE_KW, **kw))
    return _JAX[name]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_one_chunk_matches_jax(mode):
    """Both engines admit the same three requests (one repetitive, so
    drafts are accepted); one ``decode_chunk_spec`` chunk of 3 rounds at
    K 2 on each engine's cache gives the same tokens, valid counts and
    positions. One slot's budget gates it mid-chunk."""
    kw = dict(ENGINE_KW, speculative=2, **MODES[mode])
    teng = ServeEngine(PARAMS, CFG, device="cpu", **kw)
    jeng = JEngine(JPARAMS, JCfg(**CFG_KW), **kw)
    reqs = reqs_of(0, (20, 3, 20))
    reqs[2] = ([1, 2, 3, 4] * 4, 20)
    for slot, (p, n) in enumerate(reqs):
        for eng, req in ((teng, Request), (jeng, JRequest)):
            eng.submit(req(p, n))
            assert eng._admit(slot, eng._queue.popleft())
    budget = np.array([n for _, n in reqs], np.int32)
    ones, zeros = np.ones(3, np.float32), np.zeros(3, np.float32)
    topk = np.ones(3, np.int32)
    jt, jv, jc = jchunk(jeng._decode_params, jeng._cache,
                        jax.random.PRNGKey(0), jnp.asarray(ones),
                        jnp.asarray(zeros), jnp.asarray(topk),
                        jnp.asarray(budget), JCfg(**CFG_KW), 3, 2)
    tt, tv, tc = decode_chunk_spec(
        teng._ops, teng._cache, torch.Generator().manual_seed(0),
        torch.tensor(ones), torch.tensor(zeros), torch.tensor(topk),
        torch.tensor(budget), CFG, 3, 2)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    np.testing.assert_array_equal(tc["hist"].numpy(), np.asarray(jc["hist"]))
    assert tv[1].sum() == 3 and tv[2].sum() > 3  # gated; drafts accepted


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("K", [1, 3])
def test_engine_matches_jax_and_plain(mode, K):
    """Six requests through three slots (staggered admission), one with a
    one-id prompt and one repetitive: tokens equal the JAX speculative
    engine's and the port's plain engine's. (Rounds are not compared: the
    JAX engine learns of finished budgets as its asynchronous copies
    land, so it runs extra gated rounds; the port copies every chunk.)"""
    reqs = reqs_of(1, (5, 12, 7, 20, 9, 13))
    reqs[1] = ([3], 12)
    reqs[3] = ([1, 2, 3, 4] * 6, 20)
    want, _ = jax_run(f"mixed{K}{mode}", reqs, speculative=K,
                         **MODES[mode])
    got, eng = port(reqs, speculative=K, **MODES[mode])
    plain, _ = port(reqs, **MODES[mode])
    assert got == want == plain
    assert eng.stats["spec_rounds"] == (eng.stats["chunks"]
                                        * eng._spec_rounds)
    assert eng.stats["emitted_tokens"] == sum(n for _, n in reqs)
    assert eng.stats["spec_rounds"] < sum(n for _, n in reqs)
    if eng._paged:
        assert eng._allocator.n_free == eng._allocator.n_pages - 1


@pytest.mark.parametrize("mode", sorted(MODES))
def test_stop_token_prefix_and_chunked_prefill(mode):
    """A stop token, a registered prefix and a prompt past the window: the
    JAX speculative engine's tokens and finish reasons."""
    reqs = reqs_of(2, (16, 10, 12))
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, 31, 20).tolist()
    reqs[1] = (rng.integers(0, 31, 40).tolist(), 10)   # > prefill_window
    reqs[2] = (reqs[2][0], 12, 0)                      # with the prefix
    stop = 7
    want, _ = jax_run(f"stop{mode}", reqs, [prefix], stop=stop,
                      speculative=3, **MODES[mode])
    got, _ = port(reqs, [prefix], stop=stop, speculative=3, **MODES[mode])
    assert got == want
    plain, _ = port(reqs, [prefix], stop=stop, **MODES[mode])
    assert got == plain


def test_page_cache_with_speculation_matches_jax():
    """Speculation with the page cache: a repeated prompt reuses its pages
    (the pending token left out of the cached run); tokens and hits equal
    the JAX engine's and the cold engine's."""
    rng = np.random.default_rng(4)
    head = rng.integers(0, 31, 40).tolist()
    reqs = [(head + rng.integers(0, 31, 5).tolist(), 8) for _ in range(2)]
    reqs += [(list(reqs[0][0]), 8), (list(reqs[1][0]), 6)]
    kw = dict(MODES["paged-gather"], page_cache=True, speculative=3,
              n_slots=1)
    want, jeng = jax_run("pc", reqs, **kw)
    got, eng = port(reqs, **kw)
    assert got == want
    assert eng.stats["page_cache_hits"] == jeng.stats["page_cache_hits"] > 0
    cold, _ = port(reqs, **dict(kw, page_cache=False))
    assert got == cold


def test_sampled_run_is_seeded_and_complete():
    reqs = reqs_of(5, (9, 14, 6))
    out = [port(reqs, speculative=2, seed=s, top_k=0)[0] for s in (0, 0, 1)]
    assert out[0] == out[1]
    assert [len(t) for t, _ in out[0]] == [n for _, n in reqs]
    assert all(0 <= t < 31 for toks, _ in out[2] for t in toks)


def test_reservation_and_refusals_match_jax():
    """The 2(K + 1) rows of slack a speculative request reserves, and the
    JAX engine's ValueErrors for speculation with the paged kernel."""
    for make, req in ((lambda **k: ServeEngine(PARAMS, CFG, device="cpu",
                                               **k), Request),
                      (lambda **k: JEngine(JPARAMS, JCfg(**CFG_KW), **k),
                       JRequest)):
        eng = make(speculative=3, **ENGINE_KW)
        eng.submit(req([1] * 100, 20))  # 100 + 20 + 8 = 128
        with pytest.raises(ValueError, match="speculative slack"):
            eng.submit(req([1] * 101, 20))
        with pytest.raises(ValueError, match="speculative"):
            make(speculative=2, paged=True, page=16, paged_attn="kernel")


def test_auto_never_picks_the_kernel_for_speculation():
    from linalg_tpu_torch.serve.engine import pick_paged_kernel

    assert pick_paged_kernel("auto", "cuda", 256, 4096, 128)
    assert not pick_paged_kernel("auto", "cuda", 256, 4096, 128,
                                 speculative=4)
    eng = ServeEngine(PARAMS, CFG, device="cpu", paged=True, page=16,
                      speculative=2, **ENGINE_KW)
    assert eng._spec and not eng._paged_kernel


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """A target and a smaller draft checkpoint saved by the JAX package."""
    from linalg_tpu.nn.tokenizers import CharTokenizer
    from linalg_tpu.train.checkpoint import save_ckpt

    root = tmp_path_factory.mktemp("spec_ckpt")
    tok = CharTokenizer("abcdefghijklmnopqrstuvwxyz .,'\n")
    cfg = JCfg(**dict(CFG_KW, vocab_size=tok.vocab_size))
    dcfg = JCfg(**dict(CFG_KW, vocab_size=tok.vocab_size, d_model=32,
                       n_layers=1))
    save_ckpt(root / "t", jinit(cfg, seed=3), cfg, tok.stoi, tok.itos)
    save_ckpt(root / "d", jinit(dcfg, seed=4), dcfg, tok.stoi, tok.itos)
    return root


def test_serve_cli_speculative_matches_jax_cli(ckpts, capsys):
    from linalg_tpu.apps.gpt import build_parser as jparser
    from linalg_tpu.apps.gpt import serve_cli as jserve
    from linalg_tpu_torch.apps.gpt import build_parser, serve_cli

    (ckpts / "prompts.txt").write_text(
        "the one\nabab abab abab\n\nz\n", encoding="utf-8")
    common = ["--serve", "--ckpt_dir", str(ckpts / "t"), "--prompts",
              str(ckpts / "prompts.txt"), "--gen_tokens", "12",
              "--n_slots", "2", "--chunk", "8", "--top_k", "1",
              "--speculative", "3"]

    def read(name):
        return [json.loads(ln) for ln in
                (ckpts / name).read_text().splitlines()]

    for extra in ([], ["--paged", "--page", "16"]):
        jserve(jparser().parse_args(common + extra + ["--out", str(
            ckpts / "j")]))
        capsys.readouterr()
        serve_cli(build_parser().parse_args(common + extra + [
            "--out", str(ckpts / "t.jsonl"), "--device", "cpu"]))
        tout = capsys.readouterr().out
        assert read("t.jsonl") == read("j")
        # the rounds differ: the JAX engine's asynchronous copies let it
        # run gated rounds past finished budgets
        assert "[speculative K=3: " in tout and "(ceiling 4)]" in tout


def test_repl_speculative_matches_jax_repl(ckpts, capsys, monkeypatch):
    """``--repl --speculative 3``, with prompt lookup and with
    ``--draft_ckpt``, greedy: the completions the JAX REPL prints, with
    the same rounds."""
    from linalg_tpu.apps.gpt import build_parser as jparser
    from linalg_tpu.apps.gpt import repl as jrepl
    from linalg_tpu_torch.apps.gpt import build_parser, repl

    def lines(fn, argv):
        feed = iter(["the one and the", "abab abab ab"])

        def fake_input(prompt=""):
            try:
                return next(feed)
            except StopIteration:
                raise EOFError from None

        monkeypatch.setattr(builtins, "input", fake_input)
        fn(argv)
        out = capsys.readouterr().out.splitlines()
        return [ln for ln in out if ln and "REPL" not in ln]

    common = ["--repl", "--ckpt_dir", str(ckpts / "t"), "--top_k", "1",
              "--gen_tokens", "24", "--speculative", "3"]
    for extra in ([], ["--draft_ckpt", str(ckpts / "d")]):
        want = lines(lambda a: jrepl(jparser().parse_args(a)),
                     common + extra)
        got = lines(lambda a: repl(build_parser().parse_args(a)),
                    common + extra + ["--device", "cpu"])
        assert got == want
        assert sum("[speculative: 24 tokens" in ln for ln in got) == 2
