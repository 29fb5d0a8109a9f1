"""The port's MoE checkpoints, sampling, serving engine and CLI against
the JAX package's (the model-level comparisons, and the float64 setup
shared here, are in tests/test_torch_moe.py).

Checkpoints and configs exactly; ``sample`` and the engine greedy, token
for token; the engine's refusals with the JAX engine's ``ValueError``
texts.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from linalg_tpu.models import moe as jmoe
from linalg_tpu.train import checkpoint as jckpt
from linalg_tpu.train import trainer as jtrainer
from linalg_tpu_torch.apps import gpt as tapp
from linalg_tpu_torch.models import moe as tmoe
from linalg_tpu_torch.serve import Request, ServeEngine
from linalg_tpu_torch.train import checkpoint as tckpt
from linalg_tpu_torch.train import optim as toptim
from linalg_tpu_torch.train import trainer as ttrainer
from test_torch_moe import TINY, PortMoE64, cfgs64, f64, flat  # noqa: F401
from torch_config_common import jax_fields

torch.set_num_threads(2)


def f32_both(**over):
    kw = dict(TINY, **over)
    jc, tc = jmoe.MoEGPTConfig(**kw), tmoe.MoEGPTConfig(**kw)
    return jc, jmoe.init_moe_params(jc, seed=7), tc, tmoe.init_moe_params(
        tc, seed=7)


@pytest.mark.parametrize("over", [dict(), dict(
    ffn="swiglu", router_top_k=2, capacity_factor=2.0, aux_weight=0.1,
    dispatch="gather")])
def test_checkpoints_both_ways(tmp_path, over):
    """The port's MoE checkpoint loads in the JAX package and JAX's in the
    port: configs (``dispatch`` not saved: the default comes back) and
    arrays equal."""
    from linalg_tpu.nn.tokenizers import CharTokenizer

    jc, jp, tc, tp = f32_both(**over)
    tok = CharTokenizer("abcdefghijklmnopqrs")
    tckpt.save_ckpt(tmp_path / "t", tp, tc, tok.stoi, tok.itos)
    jckpt.save_ckpt(tmp_path / "j", jp, jc, tok.stoi, tok.itos)
    back_j, jc2, _, _ = jckpt.load_ckpt(tmp_path / "t")
    back_t, tc2, _, _ = tckpt.load_ckpt(tmp_path / "j")
    want = dataclasses.asdict(jc)
    want["dispatch"] = "einsum"
    assert dataclasses.asdict(jc2) == want == jax_fields(tc2)
    assert isinstance(tc2, tmoe.MoEGPTConfig)
    for back in (back_j, back_t):
        got = flat(back)
        assert got.keys() == flat(tp).keys()
        for key, val in flat(tp).items():
            np.testing.assert_array_equal(got[key], val, err_msg=key)
    # the key order of init (tree_leaves order) survives a reload
    assert list(back_t["layers"]) == list(tp["layers"])


def test_sample_serves_moe(f64):
    """``sample`` through ``moe_prefill`` and ``moe_decode_chunk`` with
    context rollovers, greedy, against JAX's ``sample``; quant raises the
    JAX ValueError; a windowed MoE re-prefills instead of the ring."""
    for over in (dict(), dict(pos="rope", window=8)):
        jc, jp, tc, tp = cfgs64(**over)
        itos = {i: chr(97 + i) for i in range(jc.vocab_size)}
        kw = dict(steps=40, top_k=1, chunk=8)
        want = "".join(jtrainer.sample(jp, jc, [1, 2, 3], itos, **kw))
        got = "".join(ttrainer.sample(tp, tc, [1, 2, 3], itos, **kw))
        assert got == want and len(got) == 40
    with pytest.raises(ValueError, match="dense GPT only"):
        next(ttrainer.sample(tp, tc, [1], itos, quant="int8"))


def single_stream(params, cfg, prompt, n, window):
    """Greedy tokens of one request through the window-padded
    ``moe_prefill`` and ``moe_decode_chunk``."""
    buf = np.zeros((1, window), np.int64)
    buf[0, :len(prompt)] = prompt
    logits, cache = tmoe.moe_prefill(params, torch.from_numpy(buf), cfg,
                                     len(prompt))
    toks, _, _ = tmoe.moe_decode_chunk(params, cache, logits,
                                       torch.Generator(), cfg, n, 1.0, 1)
    return toks[0].tolist()


class TestEngine:
    @pytest.mark.parametrize("over", [dict(), dict(router_top_k=2,
                                                   dispatch="gather")])
    def test_concurrent_requests_equal_single_streams(self, over):
        """Seven greedy requests through 3 slots (slot reuse): every
        request's tokens equal its own window-padded single stream (each
        slot routes its token alone, so batching changes nothing)."""
        kw = dict(TINY, ctx_len=48, **over)
        tc = PortMoE64(**kw)
        tp = tmoe.init_moe_params(tc, seed=5)
        rng = np.random.default_rng(4)
        eng = ServeEngine(tp, tc, n_slots=3, chunk=4, top_k=1,
                          device="cpu")
        assert eng.prefill_window == 44
        reqs = [(rng.integers(0, 19, int(rng.integers(2, 20))).tolist(),
                 int(rng.integers(3, 13))) for _ in range(7)]
        rids = [eng.submit(Request(p, n, temperature=1.0)) for p, n in reqs]
        done = {c.request_id: c.tokens for c in eng.run()}
        assert eng.stats["prefills"] == 7
        for rid, (p, n) in zip(rids, reqs):
            assert len(done[rid]) == n
            assert done[rid] == single_stream(tp, tc, p, n,
                                              eng.prefill_window)

    def test_refusals_are_jax_value_errors(self):
        """Every composition the JAX engine refuses for an MoE raises the
        same ValueError in the port (PARITY.md's MoE column)."""
        from linalg_tpu.serve import Request as JRequest
        from linalg_tpu.serve import ServeEngine as JEngine

        jc, jp, tc, tp = f32_both(ctx_len=48)
        cases = [dict(quant="int8"), dict(paged=True, page=8),
                 dict(max_loras=2), dict(speculative=2)]
        for kw in cases:
            with pytest.raises(ValueError) as je:
                JEngine(jp, jc, n_slots=2, chunk=4, **kw)
            with pytest.raises(ValueError) as te:
                ServeEngine(tp, tc, n_slots=2, chunk=4, device="cpu", **kw)
            assert str(te.value) == str(je.value), kw
        with pytest.raises(ValueError, match="full-precision dense GPT"):
            ServeEngine(tp, tc, mesh=object(), device="cpu")
        jeng = JEngine(jp, jc, n_slots=2, chunk=4, prefill_window=8)
        teng = ServeEngine(tp, tc, n_slots=2, chunk=4, prefill_window=8,
                           device="cpu")
        with pytest.raises(ValueError) as je:
            jeng.register_prefix([1, 2, 3])
        with pytest.raises(ValueError) as te:
            teng.register_prefix([1, 2, 3])
        assert str(te.value) == str(je.value)
        with pytest.raises(ValueError) as je:
            jeng.submit(JRequest(list(range(9)), 4))
        with pytest.raises(ValueError) as te:
            teng.submit(Request(list(range(9)), 4))
        assert str(te.value) == str(je.value)
        teng.submit(Request(list(range(8)), 4))  # the window itself admits

    def test_windowed_moe_serves_in_slot_mode(self):
        tc = tmoe.MoEGPTConfig(**dict(TINY, ctx_len=48, pos="rope",
                                      window=8))
        eng = ServeEngine(tmoe.init_moe_params(tc), tc, n_slots=2, chunk=4,
                          device="cpu")
        assert not eng._ring and eng._cache["k"].shape[-2] == 48


class TestCLI:
    def test_train_serve_repl(self, tmp_path, capsys, monkeypatch):
        """``--train --experts 4`` (top-2, gather) writes an MoE
        checkpoint the JAX package loads; ``--serve`` with --quant int8
        --paged --speculative 4 --prefix_file and ``--repl`` with --beam 2
        --speculative 4 --quant int8 print the JAX CLI's fallbacks and
        finish."""
        ck = tmp_path / "ck"
        tapp.main(["--train", "--steps", "2", "--eval_every", "1",
                   "--d_model", "32", "--layers", "2", "--heads", "2",
                   "--ctx_len", "32", "--batch_size", "2", "--device", "cpu",
                   "--ckpt_dir", str(ck), "--experts", "4",
                   "--router_top_k", "2", "--dispatch", "gather"])
        _, cfg, _, _ = tckpt.load_ckpt(ck)
        _, jcfg, _, _ = jckpt.load_ckpt(ck)
        assert (cfg.n_experts, cfg.router_top_k) == (4, 2)
        assert dataclasses.asdict(jcfg) == jax_fields(cfg)
        prompts = tmp_path / "p.txt"
        prompts.write_text("FIRST CITIZEN:\nALL:\n", encoding="utf-8")
        out = tmp_path / "out.jsonl"
        capsys.readouterr()
        tapp.main(["--serve", "--ckpt_dir", str(ck), "--prompts",
                   str(prompts), "--gen_tokens", "6", "--chunk", "4",
                   "--device", "cpu", "--out", str(out), "--quant", "int8",
                   "--paged", "--speculative", "4", "--prefix_file",
                   str(prompts)])
        said = capsys.readouterr().out
        for note in ("--quant supports the dense GPT only",
                     "--paged supports the dense GPT",
                     "--speculative serving supports",
                     "--prefix_file supports the dense GPT only"):
            assert note in said
        rows = out.read_text(encoding="utf-8").splitlines()
        assert len(rows) == 2 and all('"new_tokens": 6' in r for r in rows)
        feed = iter(["FIRST", "ALL"])

        def fake_input(_):
            try:
                return next(feed)
            except StopIteration:
                raise EOFError

        monkeypatch.setattr("builtins.input", fake_input)
        tapp.main(["--repl", "--ckpt_dir", str(ck), "--gen_tokens", "6",
                   "--device", "cpu", "--beam", "2", "--speculative", "4",
                   "--quant", "int8", "--top_k", "1"])
        said = capsys.readouterr().out
        assert said.count("using plain decode") == 4
        assert said.count("--quant supports the dense GPT only") == 2
        assert said.rstrip().endswith("bye")

    @pytest.mark.parametrize("flag", ["--tp", "--pp", "--fsdp",
                                      "--microbatches"])
    def test_parallel_flags_still_name_item_7(self, flag, tmp_path):
        """The parallel flags with --experts, once refused naming item 7,
        which ported them: --tp shards the experts (dp x ep) and
        --microbatches (without --pp) is ignored, each training one CPU
        step; --pp and --fsdp raise the JAX trainer's refusals."""
        argv = ["--train", "--experts", "4", flag, "2", "--steps", "1",
                "--eval_every", "1", "--d_model", "16", "--layers", "2",
                "--heads", "2", "--ctx_len", "16", "--batch_size", "2",
                "--device", "cpu", "--ckpt_dir", str(tmp_path / "ck")]
        if flag in ("--pp", "--fsdp"):
            with pytest.raises(AssertionError, match=f"{flag} with "
                               "--experts is not supported"):
                tapp.main(argv)
            return
        tapp.main(argv)
        params, cfg, _, _ = tckpt.load_ckpt(tmp_path / "ck")
        assert cfg.n_experts == 4 and params["layers"]["W1"].shape[1] == 4


def test_moe_weights_decay_like_jax():
    """The name-keyed weight-decay and lr masks give the router no decay
    and the expert matrices the GPT's, in both packages."""
    from linalg_tpu.train import optim as joptim

    jc, jp, tc, tp = f32_both(ffn="swiglu")
    want = flat(joptim.gpt_wd_mask(jp, 0.01))
    got = flat(toptim.gpt_wd_mask(tp, 0.01))
    assert {k: float(v) for k, v in got.items()} == {
        k: float(v) for k, v in want.items()}
    assert math.isclose(float(got["layers/W1"]), 0.01)
    assert float(got["layers/Wr"]) == 0.0
