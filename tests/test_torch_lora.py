"""LoRA in the port (linalg_tpu_torch/models/lora.py, ``train_lora`` and
``make_device_train_step(lora=...)`` in train/trainer.py, multi-LoRA
serving in serve/engine.py, the ``--lora_*`` flags of apps/gpt.py)
against the JAX package's, on the CPU.

- ``init_lora_params``: adapters BIT-equal (one NumPy generator, one
  order). ``lora_merge``, ``stack_lora`` and ``lora_merge_stacks`` in
  float64: atol 1e-12 (float64 sums in another order), the stacks
  bit-equal, ``lora_merge_stacks`` atol 1e-6 (both packages form its
  delta in float32); rank padding (a rank-3 adapter in rank-4 stacks)
  exact zeros.
- A 3-step LoRA finetune in float64 (the JAX step's windows fed to the
  port's step): losses rtol 1e-6 and adapters atol 1e-7, 1e-4 of the
  lr (both packages' logits and loss are float32 whatever the compute
  dtype, and AdamW's normalised step carries that rounding in full on
  gradient elements near its eps); the base weights never move.
- Adapter checkpoints load both ways, arrays and configs equal.
- Engines, float32 greedy: mixed adapters in one batch equal an engine
  serving each adapter's merged weights, in slot mode and paged mode
  (gather and the kernel's plain version here), and equal the JAX
  engine's tokens; so do quant x LoRA, speculative x LoRA and paged x
  LoRA x speculative, and per-adapter prefixes.
- The CLI: ``--train --lora_rank`` on a trained checkpoint, then
  ``--serve`` and ``--repl`` with ``--lora_dir`` (and ``--quant int8kv``,
  ``--paged --kv8``) against the JAX CLI on the same files.

K5/K6 under the LoRA side-path on the card: tests/test_torch_kernels.py.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_tpu.models import gpt as jgpt
from linalg_tpu.models import lora as jl
from linalg_tpu.nn import functional as jF
from linalg_tpu.serve import Request as JRequest
from linalg_tpu.serve import ServeEngine as JEngine
from linalg_tpu.train import optim as joptim
from linalg_tpu.train import trainer as jtrainer
from linalg_tpu_torch.models import gpt as tgpt
from linalg_tpu_torch.models import lora as tl
from linalg_tpu_torch.serve import Request, ServeEngine
from linalg_tpu_torch.train import optim as toptim
from linalg_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(2)

CFG_KW = dict(vocab_size=31, d_model=64, n_heads=4, n_kv_heads=2,
              n_layers=2, ctx_len=64)
ENGINE_KW = dict(n_slots=3, chunk=4, top_k=1, prefill_window=16)


@dataclasses.dataclass(frozen=True)
class JaxCfg64(jgpt.GPTConfig):
    @property
    def compute_dtype(self):
        return jnp.float64


@dataclasses.dataclass(frozen=True)
class PortCfg64(tgpt.GPTConfig):
    @property
    def compute_dtype(self):
        return torch.float64


def npy(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x)


def jax_adapters(params, rank, seed, rng, targets="attn"):
    """A JAX adapter tree with nonzero B (a trained adapter's shape)."""
    lcfg = jl.LoRAConfig(rank=rank, targets=targets)
    ad = jl.init_lora_params(params, lcfg, seed=seed)
    ad["layers"] = {k: (v if k.endswith("_A") else jnp.asarray(
        rng.normal(0, 0.05, v.shape), v.dtype))
        for k, v in ad["layers"].items()}
    return ad, lcfg


def to_port(ad, lcfg):
    return (tl.lora_from_numpy(jax.tree.map(np.asarray, ad)),
            tl.LoRAConfig(lcfg.rank, lcfg.alpha, lcfg.targets))


class TestAlgebra:
    @pytest.mark.parametrize("targets,ffn", [("attn", "relu"),
                                             ("all", "swiglu")])
    def test_init_bit_equal_and_merge_f64(self, targets, ffn):
        kw = dict(CFG_KW, ffn=ffn)
        jp = jgpt.init_gpt_params(jgpt.GPTConfig(**kw), seed=1)
        tp = tgpt.init_gpt_params(tgpt.GPTConfig(**kw), seed=1)
        lj = jl.LoRAConfig(rank=4, targets=targets)
        lt = tl.LoRAConfig(rank=4, targets=targets)
        ja, ta = jl.init_lora_params(jp, lj, seed=3), tl.init_lora_params(
            tp, lt, seed=3)
        assert ta["layers"].keys() == ja["layers"].keys()
        for k, v in ja["layers"].items():
            np.testing.assert_array_equal(npy(ta["layers"][k]), npy(v))
        # float64 merge of a nonzero-B adapter
        rng = np.random.default_rng(2)
        ja64, _ = jax_adapters(jp, 4, 3, rng, targets)
        ja64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), ja64)
        jp64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jp)
        want = jl.lora_merge(jp64, ja64, lj)
        got = tl.lora_merge(tgpt.params_from_numpy(jax.tree.map(
            np.asarray, jp64)), tl.lora_from_numpy(jax.tree.map(
                np.asarray, ja64)), lt)
        for k, v in want["layers"].items():
            np.testing.assert_allclose(npy(got["layers"][k]), npy(v),
                                       rtol=0, atol=1e-12, err_msg=k)

    def test_stacks_pad_and_merge_f64(self):
        jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                          jgpt.init_gpt_params(jgpt.GPTConfig(**CFG_KW)))
        tp = tgpt.params_from_numpy(jax.tree.map(np.asarray, jp))
        rng = np.random.default_rng(4)
        js = jl.init_lora_stacks(jp, 2, 4)
        ts = tl.init_lora_stacks(tp, 2, 4)
        for idx, rank in ((1, 4), (2, 3)):  # adapter 2 is rank-padded
            ad, lcfg = jax_adapters(jp, rank, idx, rng)
            ad = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), ad)
            js = jl.stack_lora(js, ad, lcfg, idx)
            tl.stack_lora(ts, *to_port(ad, lcfg), idx)
        for k, v in js.items():
            np.testing.assert_array_equal(npy(ts[k]), npy(v), err_msg=k)
        assert not ts["Wq_A"][:, 2, :, 3].any()  # the padding
        assert not ts["Wo_B"][:, 2, 3].any()
        assert not ts["Wk_A"][:, 0].any()  # row 0 stays the base
        for idx in (0, 1, 2):  # both form the delta in float32
            want = jl.lora_merge_stacks(jp, js, idx)
            got = tl.lora_merge_stacks(tp, ts, idx)
            for k, v in want["layers"].items():
                np.testing.assert_allclose(npy(got["layers"][k]), npy(v),
                                           rtol=0, atol=1e-6)
        with pytest.raises(ValueError, match="exceeds"):
            tl.stack_lora(ts, *to_port(*jax_adapters(jp, 5, 0, rng)), 1)
        with pytest.raises(ValueError, match="targets='attn'"):
            tl.stack_lora(ts, *to_port(*jax_adapters(jp, 2, 0, rng, "all")),
                          1)

    def test_config_validation(self):
        for kw, key in ((dict(rank=0), "rank"), (dict(targets="ffn"),
                                                 "targets")):
            with pytest.raises(ValueError, match=key):
                jl.LoRAConfig(**kw)
            with pytest.raises(ValueError, match=key):
                tl.LoRAConfig(**kw)
        assert tl.LoRAConfig(rank=8, alpha=16.0).scale == 2.0


def test_checkpoints_load_both_ways(tmp_path):
    jp = jgpt.init_gpt_params(jgpt.GPTConfig(**CFG_KW))
    ad, lcfg = jax_adapters(jp, 4, 0, np.random.default_rng(5))
    jl.save_lora(tmp_path / "jax", ad, lcfg)
    got, gcfg = tl.load_lora(tmp_path / "jax")
    assert dataclasses.asdict(gcfg) == dataclasses.asdict(lcfg)
    for k, v in ad["layers"].items():
        np.testing.assert_array_equal(npy(got["layers"][k]), npy(v))
    tl.save_lora(tmp_path / "port", got, gcfg)
    back, bcfg = jl.load_lora(tmp_path / "port")
    assert bcfg == lcfg
    for k, v in ad["layers"].items():
        np.testing.assert_array_equal(npy(back["layers"][k]), npy(v))


def test_three_step_finetune_matches_jax(monkeypatch):
    """Three LoRA steps in float64 (RoPE, GQA, window): the JAX device
    step draws its windows from its key; the port's step is fed the same
    windows. Losses and adapters agree; the base never moves."""
    kw = dict(CFG_KW, vocab_size=37, ctx_len=32, pos="rope", window=12,
              ffn="swiglu")
    jc, tc = JaxCfg64(**kw), PortCfg64(**kw)
    host = jax.tree.map(lambda a: np.asarray(a, np.float64),
                        jgpt.init_gpt_params(jc, seed=2))
    monkeypatch.setattr(tgpt, "rope_tables", lambda d, pos: tuple(
        torch.tensor(np.asarray(t)) for t in jF.rope_tables(
            d, np.asarray(pos))))
    jp, tp = jax.tree.map(jnp.asarray, host), tgpt.params_from_numpy(host)
    lj = jl.LoRAConfig(rank=4, alpha=8.0)
    ja = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                      jl.init_lora_params(jp, lj, seed=0))
    ta = tl.lora_from_numpy(jax.tree.map(np.asarray, ja))
    lt = tl.LoRAConfig(rank=4, alpha=8.0)
    step_kw = dict(base_lr=1e-3, min_lr=1e-4, warmup=1, max_steps=10,
                   weight_decay=0.01, clip_norm=1.0)
    B = 3
    jstep = jtrainer.make_device_train_step(jc, B, lora=(jp, lj), **step_kw)
    tstep = ttrainer.make_device_train_step(tc, B, lora=(tp, lt), **step_kw)
    data = np.random.default_rng(6).integers(0, 37, 400)
    key = jax.random.PRNGKey(0)
    js, ts = joptim.adamw_init(ja), toptim.adamw_init(ta)
    base = {k: v.clone() for k, v in tp["layers"].items()}
    for _ in range(3):
        _, sub = jax.random.split(key)  # the JAX step's draw
        ix = np.asarray(jax.random.randint(sub, (B,), 0,
                                           len(data) - kw["ctx_len"] - 1))
        offs = ix[:, None] + np.arange(kw["ctx_len"])[None]
        win = (torch.from_numpy(data[offs]), torch.from_numpy(data[offs + 1]))
        monkeypatch.setattr(ttrainer, "_windows", lambda *a: win)
        ja, js, key, jloss = jstep(ja, js, jnp.asarray(data), key)
        ta, ts, _, tloss = tstep(ta, ts, torch.from_numpy(data), None)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    for k, v in ja["layers"].items():
        np.testing.assert_allclose(npy(ta["layers"][k]), npy(v), rtol=0,
                                   atol=1e-7, err_msg=k)
    assert float(ta["layers"]["Wq_B"].detach().abs().max()) > 0
    for k, v in base.items():
        assert torch.equal(tp["layers"][k], v)


# -- engines ------------------------------------------------------------------

def engine_setup(seed=7):
    jc = jgpt.GPTConfig(**CFG_KW)
    tc = tgpt.GPTConfig(**CFG_KW)
    jp = jgpt.init_gpt_params(jc, seed=seed)
    tp = tgpt.init_gpt_params(tc, seed=seed)
    rng = np.random.default_rng(8)
    ads = [jax_adapters(jp, r, s, rng) for r, s in ((4, 1), (3, 2))]
    return jc, jp, tc, tp, ads


def mixed_requests():
    rng = np.random.default_rng(9)
    return [(rng.integers(0, 31, int(n)).tolist(), int(b), i % 3)
            for i, (n, b) in enumerate(((3, 20), (30, 9), (12, 16), (5, 6),
                                        (20, 14), (8, 11)))]


def serve_mixed(make, request, ads, reqs, register=True, prefix_len=0,
                **kw):
    eng = make(**dict(ENGINE_KW, max_loras=2, lora_rank=4, **kw))
    if register:
        for a in ads:
            eng.register_lora(*a)
    pid = None
    if prefix_len:
        pid = eng.register_prefix(reqs[1][0][:prefix_len], lora_id=1)
    ids = [eng.submit(request(p, n, lora_id=l,
                              prefix_id=pid if (pid is not None and l == 1)
                              else None))
           for p, n, l in reqs]
    done = {c.request_id: c for c in eng.run()}
    return [done[i].tokens for i in ids]


LORA_MODES = {
    "slot": {},
    "paged gather": dict(paged=True, page=8, paged_attn="gather"),
    "paged kernel": dict(paged=True, page=8, paged_attn="kernel"),
    "quant": dict(quant="int8"),
    "speculative": dict(speculative=2),
    "paged speculative": dict(paged=True, page=8, paged_attn="gather",
                              speculative=2),
}
_JAX = {}


@pytest.mark.parametrize("mode", sorted(LORA_MODES))
def test_mixed_adapter_engine_matches_jax(mode):
    """Six requests over adapters 0, 1, 2 (adapter 2 of rank 3, padded to
    the stacks' 4) batched in one engine, and a prefix registered through
    adapter 1: tokens equal to the JAX engine's."""
    jc, jp, tc, tp, ads = engine_setup()
    kw = LORA_MODES[mode]
    jkw = dict(kw, paged_attn="gather") if "paged" in kw else kw
    key = tuple(sorted(jkw.items()))
    reqs = mixed_requests()
    if key not in _JAX:
        _JAX[key] = serve_mixed(lambda **k: JEngine(jp, jc, **k), JRequest,
                                ads, reqs, prefix_len=10, **jkw)
    got = serve_mixed(lambda **k: ServeEngine(tp, tc, device="cpu", **k),
                      Request, [to_port(*a) for a in ads], reqs,
                      prefix_len=10, **kw)
    assert got == _JAX[key]


@pytest.mark.parametrize("mode", ["slot", "paged kernel"])
def test_mixed_adapters_equal_merged_engines(mode):
    """Each adapter's requests, served mixed, equal an engine serving
    that adapter's merged weights (the side-path against the merge)."""
    _, _, tc, tp, ads = engine_setup()
    pads = [to_port(*a) for a in ads]
    reqs = mixed_requests()
    kw = LORA_MODES[mode]
    got = serve_mixed(lambda **k: ServeEngine(tp, tc, device="cpu", **k),
                      Request, pads, reqs, **kw)
    for lid in (0, 1, 2):
        params = tp if lid == 0 else tl.lora_merge(tp, *pads[lid - 1])
        sub = [(p, n, 0) for p, n, l in reqs if l == lid]
        want = serve_mixed(lambda **k: ServeEngine(params, tc, device="cpu",
                                                   **k),
                           Request, [], sub, register=False, **kw)
        assert [t for t, (_, _, l) in zip(got, reqs) if l == lid] == want
    assert len({tuple(t) for t in got[:3]}) == 3  # the adapters differ


def test_lora_refusals_match_jax():
    jc, jp, tc, tp, ads = engine_setup()
    pad = to_port(*ads[0])
    for make, req, ad in ((lambda **k: JEngine(jp, jc, **k), JRequest,
                           ads[0]),
                          (lambda **k: ServeEngine(tp, tc, device="cpu",
                                                   **k), Request, pad)):
        with pytest.raises(ValueError, match="max_loras=N"):
            make().register_lora(*ad)
        eng = make(max_loras=1, lora_rank=4)
        with pytest.raises(ValueError, match="unknown lora_id"):
            eng.submit(req([1, 2], 4, lora_id=1))
        eng.register_lora(*ad)
        with pytest.raises(ValueError, match="adapter slots"):
            eng.register_lora(*ad)
        pid = eng.register_prefix([1, 2, 3], lora_id=1)
        with pytest.raises(ValueError, match="per-adapter prefix"):
            eng.submit(req([4, 5], 4, prefix_id=pid))


# -- the CLI ------------------------------------------------------------------

def test_cli_lora_then_serve_and_repl_match_jax(tmp_path, capsys,
                                                monkeypatch):
    """``--train`` a small model, ``--train --lora_rank 4`` on it (adapter
    checkpoint in ``--lora_dir``), then ``--serve --paged --kv8`` and
    ``--repl --quant int8kv`` merging the adapters: each output equals
    the JAX CLI's on the same files."""
    from linalg_tpu.apps import gpt as japp
    from linalg_tpu_torch.apps import gpt as tapp

    ck, lora = tmp_path / "ck", tmp_path / "adapters"
    small = ["--d_model", "32", "--layers", "2", "--heads", "4", "--ctx_len",
             "32", "--batch_size", "2", "--device", "cpu", "--ckpt_dir",
             str(ck)]
    tapp.main(["--train", "--steps", "1", "--eval_every", "1", *small])
    tapp.main(["--train", "--lora_rank", "4", "--lora_alpha", "8",
               "--lora_dir", str(lora), "--steps", "2", "--eval_every", "2",
               *small])
    out = capsys.readouterr().out
    assert "fresh LoRA adapters: rank 4, targets attn" in out
    adapters, lcfg = jl.load_lora(lora)
    assert (lcfg.rank, lcfg.alpha) == (4, 8.0)
    assert float(jnp.abs(adapters["layers"]["Wq_B"]).max()) > 0
    (tmp_path / "p.txt").write_text("the cat\nsat on\n", encoding="utf-8")
    serve = ["--serve", "--ckpt_dir", str(ck), "--lora_dir", str(lora),
             "--prompts", str(tmp_path / "p.txt"), "--gen_tokens", "8",
             "--chunk", "4", "--n_slots", "2", "--top_k", "1"]
    for extra in (["--paged", "--page", "8", "--kv8", "--paged_attn",
                   "gather"],):
        japp.serve_cli(japp.build_parser().parse_args(
            serve + extra + ["--out", str(tmp_path / "j.jsonl")]))
        tapp.main(serve + extra + ["--device", "cpu", "--out",
                                   str(tmp_path / "t.jsonl")])
        out = capsys.readouterr().out
        assert out.count("merged LoRA adapters") == 2
        rows = [(tmp_path / n).read_text().splitlines()
                for n in ("j.jsonl", "t.jsonl")]
        assert [json.loads(r) for r in rows[0]] == [json.loads(r)
                                                    for r in rows[1]]
    repl = ["--repl", "--ckpt_dir", str(ck), "--lora_dir", str(lora),
            "--gen_tokens", "20", "--top_k", "1", "--quant", "int8kv"]
    texts = []
    for run in (lambda: japp.repl(japp.build_parser().parse_args(repl)),
                lambda: tapp.main(repl + ["--device", "cpu"])):
        feed = iter(["the cat"])

        def fake_input(_=""):
            for line in feed:
                return line
            raise EOFError

        monkeypatch.setattr("builtins.input", fake_input)
        run()
        out = capsys.readouterr().out
        texts.append(out.split("exit.\n\n")[1].split("\nbye")[0])
    assert texts[0] == texts[1] and len(texts[0].strip()) > 0
