"""The port's serving slice (linalg_tpu_torch/serve, apps/gpt.py --serve)
against the JAX package's, end to end on the CPU.

The same requests go through the JAX ``ServeEngine`` and the port's, in
slot mode and in paged mode with both attention reads (on CPU tensors the
kernel read computes its plain version): greedy tokens must be EQUAL, and
every page must be back in the pool after ``run()``. The port's serve CLI
must print the same completions as the JAX CLI for one JAX-saved
checkpoint. float32 throughout.
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
from linalg_tpu_torch.serve import Request, ServeEngine, serve

torch.set_num_threads(2)

# d_head 32: a shape the CUDA kernel takes; GQA groups of 2
CFG_KW = dict(vocab_size=31, d_model=128, n_heads=4, n_kv_heads=2,
              n_layers=2, ctx_len=64)
CFG = GPTConfig(**CFG_KW)
PARAMS = init_gpt_params(CFG, seed=7)
ENGINE_KW = dict(n_slots=3, chunk=4, top_k=1)


def requests(seed=0, n=7, stop_token=-1):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, CFG.vocab_size,
                          size=int(rng.integers(3, 14))).tolist(),
             int(rng.integers(3, 15))) for _ in range(n)], stop_token


def run_port(reqs, **kw):
    prompts, stop = reqs
    eng = ServeEngine(PARAMS, CFG, device="cpu", **ENGINE_KW, **kw)
    ids = [eng.submit(Request(p, n, stop_token=stop)) for p, n in prompts]
    done = {c.request_id: c for c in eng.run()}
    if eng._allocator is not None:
        assert eng._allocator.n_free == eng._allocator.n_pages - 1
    return [(done[i].tokens, done[i].finish_reason) for i in ids], eng


@pytest.fixture(scope="module")
def jax_tokens():
    """The JAX slot engine's greedy tokens for each request set (the JAX
    paged engine is pinned equal to it by tests/test_paged.py)."""
    jp = jinit(JCfg(**CFG_KW), seed=7)
    out = {}
    for seed, stop in ((0, -1), (1, 10)):
        prompts, _ = requests(seed, stop_token=stop)
        eng = JEngine(jp, JCfg(**CFG_KW), **ENGINE_KW)
        ids = [eng.submit(JRequest(p, n, stop_token=stop))
               for p, n in prompts]
        done = {c.request_id: c for c in eng.run()}
        out[seed] = [(done[i].tokens, done[i].finish_reason) for i in ids]
    assert {r for _, r in out[1]} == {"stop", "length"}
    return out


@pytest.mark.parametrize("mode", [
    dict(),
    dict(paged=True, page=16, paged_attn="gather"),
    dict(paged=True, page=16, paged_attn="kernel"),
    dict(paged=True, page=8, n_pages=7, paged_attn="kernel",
         schedule="best-fit"),
], ids=["slot", "paged-gather", "paged-kernel", "paged-pressure-bestfit"])
@pytest.mark.parametrize("seed,stop", [(0, -1), (1, 10)],
                         ids=["length", "stop"])
def test_engine_matches_jax(jax_tokens, mode, seed, stop):
    got, _ = run_port(requests(seed, stop_token=stop), **mode)
    assert got == jax_tokens[seed]


# RoPE, ALiBi, a window and the gated FFNs: the slot and paged engines
# serve each as the JAX slot engine does (a window WITH RoPE or ALiBi is
# the ring mode, tests/test_torch_stream_cache.py). RoPE at d_head 128, as
# tests/test_paged.py:269 holds its kernel; d_head 8 as
# tests/test_paged.py:288 serves through its kernels; the others at
# CFG_KW's d 32
FEATURES = {
    "rope_d128": dict(vocab_size=31, d_model=256, n_heads=2, n_kv_heads=1,
                      n_layers=2, ctx_len=64, pos="rope"),
    "d8": dict(vocab_size=31, d_model=32, n_heads=4, n_kv_heads=2,
               n_layers=2, ctx_len=64),
    "alibi": dict(CFG_KW, pos="alibi"),
    "window7": dict(CFG_KW, window=7),
    "swiglu": dict(CFG_KW, ffn="swiglu"),
    "geglu": dict(CFG_KW, ffn="geglu", n_kv_heads=None),
}
_FEATURE_TOKENS = {}


def feature_requests(name):
    rng = np.random.default_rng(len(name))
    V = FEATURES[name]["vocab_size"]
    return [(rng.integers(0, V, size=int(rng.integers(3, 14))).tolist(),
             int(rng.integers(4, 12))) for _ in range(5)]


def jax_feature_tokens(name):
    """The JAX slot engine's greedy tokens for FEATURES[name] (seed-4
    weights), computed once per config."""
    if name not in _FEATURE_TOKENS:
        cfg = JCfg(**FEATURES[name])
        eng = JEngine(jinit(cfg, seed=4), cfg, **ENGINE_KW)
        ids = [eng.submit(JRequest(p, n)) for p, n in feature_requests(name)]
        done = {c.request_id: c.tokens for c in eng.run()}
        _FEATURE_TOKENS[name] = [done[i] for i in ids]
    return _FEATURE_TOKENS[name]


def port_feature_tokens(name, **mode):
    cfg = GPTConfig(**FEATURES[name])
    eng = ServeEngine(init_gpt_params(cfg, seed=4), cfg, device="cpu",
                      **ENGINE_KW, **mode)
    ids = [eng.submit(Request(p, n)) for p, n in feature_requests(name)]
    done = {c.request_id: c.tokens for c in eng.run()}
    return [done[i] for i in ids]


@pytest.mark.parametrize("mode", [
    dict(),
    dict(paged=True, page=16, paged_attn="gather"),
    dict(paged=True, page=16, paged_attn="kernel"),
], ids=["slot", "paged-gather", "paged-kernel"])
@pytest.mark.parametrize("name", sorted(FEATURES))
def test_feature_configs_match_jax_slot_engine(name, mode):
    """float32 greedy tokens equal to the JAX slot engine's, in slot mode
    and in paged mode with both reads (the kernel read runs its plain
    version on the CPU)."""
    assert port_feature_tokens(name, **mode) == jax_feature_tokens(name)


@pytest.mark.parametrize("name", ["rope_d128", "alibi", "d8"])
def test_kernel_engine_matches_gather_engine(name):
    """tests/test_paged.py:269-305 for the port: the paged engine reads
    its pool through the kernel's path and through the table gather with
    the same tokens, at RoPE d_head 128, under ALiBi's per-head bias and
    at d_head 8."""
    assert port_feature_tokens(name, paged=True, page=16,
                               paged_attn="kernel") == port_feature_tokens(
        name, paged=True, page=16, paged_attn="gather")


def test_ring_configs_raise_naming_the_roadmap():
    """A window with RoPE or ALiBi (once refused, naming the ROADMAP)
    takes ring mode: O(window) slot rows, any position; the paged engine
    refuses it with the JAX engine's ValueError, in both packages."""
    for pos in ("rope", "alibi"):
        kw = dict(CFG_KW, pos=pos, window=7)
        cfg = GPTConfig(**kw)
        eng = ServeEngine(init_gpt_params(cfg), cfg, device="cpu",
                          **ENGINE_KW)
        assert eng._ring and eng._cache["k"].shape[3] == 7
        assert eng._cache["rpos"].shape == (ENGINE_KW["n_slots"], 7)
        for make, c in ((lambda c, **k: ServeEngine(
                init_gpt_params(c), c, device="cpu", **k), cfg),
                        (lambda c, **k: JEngine(jinit(c), c, **k),
                         JCfg(**kw))):
            with pytest.raises(ValueError, match="paged KV supports"):
                make(c, paged=True, page=16, **ENGINE_KW)


def test_jax_paged_engine_matches_port():
    """One direct paged-vs-paged check (JAX gather engine, port kernel
    engine), on a small pool that makes requests queue for pages."""
    reqs = requests(2, n=5)
    jeng = JEngine(jinit(JCfg(**CFG_KW), seed=7), JCfg(**CFG_KW),
                   paged=True, page=16, n_pages=6, **ENGINE_KW)
    ids = [jeng.submit(JRequest(p, n)) for p, n in reqs[0]]
    done = {c.request_id: c for c in jeng.run()}
    want = [(done[i].tokens, done[i].finish_reason) for i in ids]
    got, eng = run_port(reqs, paged=True, page=16, n_pages=6,
                        paged_attn="kernel")
    assert got == want
    assert eng.stats["prefills"] == 5


def test_sampling_vectors_are_copies():
    """The engine mutates its host sampling vectors in place; the device
    tensors a chunk reads must not change with them."""
    eng = ServeEngine(PARAMS, CFG, device="cpu", **ENGINE_KW)
    eng.submit(Request([1, 2, 3], 8, temperature=0.5))
    eng.step()
    temp_dev = eng._samp_dev[0]
    eng._temp[0] = 123.0
    assert float(temp_dev[0]) == 0.5


def test_sampled_run_is_seeded_and_complete():
    prompts, _ = requests(3, n=4)

    def run(seed):
        done = serve(PARAMS, CFG, [Request(p, n, temperature=0.9, top_p=0.9)
                                   for p, n in prompts], n_slots=2, chunk=4,
                     seed=seed, device="cpu")
        return [c.tokens for c in done]

    a, b = run(0), run(0)
    assert a == b
    assert [len(t) for t in a] == [n for _, n in prompts]


class TestErrors:
    def test_unported_features_raise(self):
        """The features this port serves refuse the combinations the JAX
        engine refuses, with its ValueErrors (quant, LoRA, kv8 and mesh
        serving, once refused as unported, now serve:
        tests/test_torch_quant.py, tests/test_torch_lora.py,
        tests/test_torch_serve_tp.py); a mesh without a 'tp' axis meets
        the JAX engine's check."""
        with pytest.raises(ValueError, match="'tp' axis"):
            ServeEngine(PARAMS, CFG, mesh=object(), device="cpu")
        for kw in (dict(quant="int8"), dict(max_loras=2),
                   dict(paged=True, kv8=True, paged_attn="gather")):
            ServeEngine(PARAMS, CFG, device="cpu", **kw)
        with pytest.raises(ValueError, match="speculative"):
            ServeEngine(PARAMS, CFG, paged=True, page=16, speculative=2,
                        paged_attn="kernel", device="cpu")
        with pytest.raises(ValueError, match="page_cache requires paged"):
            ServeEngine(PARAMS, CFG, page_cache=True, device="cpu")
        eng = ServeEngine(PARAMS, CFG, device="cpu", **ENGINE_KW)
        with pytest.raises(ValueError, match="unknown lora_id"):
            eng.register_prefix([1, 2, 3], lora_id=1)
        with pytest.raises(ValueError, match="unknown lora_id"):
            eng.submit(Request([1, 2], 4, lora_id=1))

    def test_submit_validation(self):
        eng = ServeEngine(PARAMS, CFG, prefill_window=8, device="cpu",
                          **ENGINE_KW)
        # past prefill_window a prompt admits by chunked prefill; past the
        # ctx budget (57 + 8 reserved > 64) it is refused
        with pytest.raises(ValueError, match="ctx_len"):
            eng.submit(Request(list(range(57)), 8))
        with pytest.raises(ValueError, match="empty"):
            eng.submit(Request([], 4))
        with pytest.raises(ValueError, match="ctx_len"):
            eng.submit(Request([1, 2], 61))
        with pytest.raises(ValueError, match="pages"):
            ServeEngine(PARAMS, CFG, paged=True, page=16, n_pages=3,
                        device="cpu", **ENGINE_KW).submit(
                            Request([1, 2, 3], 40))

    def test_kernel_mode_rejects_unsupported_shapes(self):
        with pytest.raises(ValueError, match="page % 8"):
            ServeEngine(PARAMS, CFG, paged=True, page=4,
                        paged_attn="kernel", device="cpu")
        # d_head 12: not a multiple of 8
        cfg = GPTConfig(vocab_size=8, d_model=24, n_heads=2, ctx_len=32)
        with pytest.raises(ValueError, match="d_head"):
            ServeEngine(init_gpt_params(cfg), cfg, paged=True, page=8,
                        chunk=4, paged_attn="kernel", device="cpu")


def test_serve_cli_matches_jax_cli(tmp_path, capsys):
    """The port's CLI on a JAX-saved checkpoint writes the JAX CLI's
    completions, in slot mode and in paged kernel mode."""
    from linalg_tpu.apps.gpt import build_parser as jparser
    from linalg_tpu.apps.gpt import serve_cli as jserve
    from linalg_tpu.nn.tokenizers import CharTokenizer
    from linalg_tpu.train.checkpoint import save_ckpt
    from linalg_tpu_torch.apps.gpt import build_parser, serve_cli

    tok = CharTokenizer("abcdefghijklmnopqrstuvwxyz .,'\n")
    cfg = JCfg(**dict(CFG_KW, vocab_size=tok.vocab_size))
    save_ckpt(tmp_path, jinit(cfg, seed=3), cfg, tok.stoi, tok.itos)
    (tmp_path / "prompts.txt").write_text(
        "the one\nand the other, at last\n\n???\nz\n", encoding="utf-8")
    common = ["--serve", "--ckpt_dir", str(tmp_path), "--prompts",
              str(tmp_path / "prompts.txt"), "--gen_tokens", "10",
              "--n_slots", "2", "--chunk", "4", "--top_k", "1"]

    def read(name):
        return [json.loads(ln) for ln in
                (tmp_path / name).read_text().splitlines()]

    jserve(jparser().parse_args(common + ["--out", str(tmp_path / "j")]))
    want = read("j")
    assert [r["finish_reason"] for r in want] == [
        "length", "length", "empty", "length"]
    for extra in ([], ["--paged", "--page", "16", "--paged_attn", "kernel"]):
        serve_cli(build_parser().parse_args(
            common + extra + ["--out", str(tmp_path / "t"), "--device",
                              "cpu"]))
        assert read("t") == want
    assert "device=cpu" in capsys.readouterr().out


def test_engine_without_device_raises_on_a_machine_without_a_card(
        monkeypatch):
    """No device asked for means the card: without one the engine refuses
    at construction, naming --device cpu, instead of serving on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        ServeEngine(PARAMS, CFG, **ENGINE_KW)
