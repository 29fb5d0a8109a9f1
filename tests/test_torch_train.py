"""The port's training slice (linalg_tpu_torch/models/gpt.py gpt_loss,
train/{optim,data,checkpoint,trainer}.py, apps/gpt.py --train) against the
JAX package's.

Same weights (``init_gpt_params``, one seed), numpy-made batches, gradients
and optimizer states go through both packages in float32 on the CPU.
Tolerances: loss and gradients rtol 1e-4 / atol 1e-6 (float32 sums of a
2-layer model taken in another order); optimizer updates atol 1e-7 (a few
float32 roundings of parameters of size ~1); the 3-step trajectory loss
rtol 1e-4 and parameters atol 1e-5 (the warmup lr at steps <= 3 is at most
4.5e-6, which bounds what an AdamW sign flip on a near-zero gradient can
move); texts, checkpoints and configs exactly.
"""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_tpu.models import gpt as jgpt
from linalg_tpu.nn import functional as jF
from linalg_tpu.train import checkpoint as jckpt
from linalg_tpu.train import data as jdata
from linalg_tpu.train import optim as joptim
from linalg_tpu.train import trainer as jtrainer
from linalg_tpu_torch.apps import gpt as tapp
from linalg_tpu_torch.models import gpt as tgpt
from linalg_tpu_torch.nn.flash import flash_attention
from linalg_tpu_torch.train import checkpoint as tckpt
from linalg_tpu_torch.train import data as tdata
from linalg_tpu_torch.train import optim as toptim
from linalg_tpu_torch.train import trainer as ttrainer
from torch_config_common import jax_fields

torch.set_num_threads(2)

SMALL = dict(vocab_size=65, d_model=64, n_heads=4, n_layers=2, ctx_len=64)
B = 3


def both(seed=123, **over):
    kw = dict(SMALL, **over)
    jc, tc = jgpt.GPTConfig(**kw), tgpt.GPTConfig(**kw)
    return (jc, jgpt.init_gpt_params(jc, seed=seed), tc,
            tgpt.init_gpt_params(tc, seed=seed))


def flat(tree):
    """{'a/b': numpy leaf} of a JAX pytree or the port's nested dicts."""
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor)
                       else v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def batch(seed, T=SMALL["ctx_len"], V=SMALL["vocab_size"]):
    rng = np.random.default_rng(seed)
    return rng.integers(0, V, (B, T)), rng.integers(0, V, (B, T))


@dataclasses.dataclass(frozen=True)
class JaxCfg64(jgpt.GPTConfig):
    """The JAX config computing in float64."""

    @property
    def compute_dtype(self):
        return jnp.float64


@dataclasses.dataclass(frozen=True)
class PortCfg64(tgpt.GPTConfig):
    """The port's config computing in float64."""

    @property
    def compute_dtype(self):
        return torch.float64


# RoPE + SwiGLU + GQA + a window; ALiBi + GeGLU; sinusoidal ReLU + a window
LONG_CFGS = {
    "rope_swiglu_gqa_window": dict(pos="rope", ffn="swiglu", n_kv_heads=2,
                                   window=24),
    "alibi_geglu": dict(pos="alibi", ffn="geglu"),
    "relu_window": dict(window=24),
}


def long_cfgs(name, monkeypatch):
    """(jax cfg, jax params, port cfg, port params) in float64 for
    ``LONG_CFGS[name]``; the port's float32 init is checked bit-equal to
    the JAX package's first."""
    kw = dict(SMALL, **LONG_CFGS[name])
    jc, tc = JaxCfg64(**kw), PortCfg64(**kw)
    jp32 = jgpt.init_gpt_params(jc, seed=123)
    want = flat(jp32)
    got = flat(tgpt.init_gpt_params(tc, seed=123))
    assert want.keys() == got.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    host = jax.tree.map(lambda a: np.asarray(a, np.float64), jp32)
    # the float32 position tables of the JAX package (see the tests)
    monkeypatch.setattr(tgpt, "rope_tables", lambda d, pos: tuple(
        torch.tensor(np.asarray(t)) for t in jF.rope_tables(d, pos.numpy())))
    monkeypatch.setattr(tgpt, "sinusoidal_encoding", lambda n, d, device: (
        torch.tensor(np.asarray(jF.sinusoidal_encoding(n, d)))))
    return (jc, jax.tree.map(jnp.asarray, host), tc,
            tgpt.params_from_numpy(host))


class TestLoss:
    @pytest.mark.parametrize("attn", ["default", "flash"])
    def test_loss_and_every_gradient(self, attn):
        """The port's loss and gradients (autograd through the hand-derived
        backwards) against ``jax.value_and_grad(gpt_loss)``; once with the
        default attention (sdpa on the CPU) and once through the port's
        flash_attention (its plain versions on the CPU)."""
        jc, jp, tc, tp = both()
        x, y = batch(0)
        jl, jg = jax.value_and_grad(jgpt.gpt_loss)(jp, jnp.asarray(x),
                                                   jnp.asarray(y), jc)
        attn_fn = None if attn == "default" else (
            lambda q, k, v, mask: flash_attention(q, k, v, True))
        leaves = toptim.tree_leaves(tp)
        for p in leaves:
            p.requires_grad_(True)
        tl = tgpt.gpt_loss(tp, torch.from_numpy(x), torch.from_numpy(y), tc,
                           attn_fn=attn_fn)
        grads = iter(torch.autograd.grad(tl, leaves))
        tg = toptim.tree_map(lambda _: next(grads), tp)
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
        want, got = flat(jg), flat(tg)
        assert want.keys() == got.keys()
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                       atol=1e-6, err_msg=key)

    @pytest.mark.parametrize("name", sorted(LONG_CFGS))
    def test_trunk_and_every_gradient_f64(self, name, monkeypatch):
        """The layer stack in float64 through both packages (a config whose
        compute dtype is float64; x64 is on for JAX): the hidden states and
        the gradients of <trunk, cot> for every parameter it reads, rtol
        1e-10. Weights are ``init_gpt_params``'s, bit-equal in the two
        packages (the gated draws included) and handed to the port through
        ``params_from_numpy``. The RoPE and sinusoidal tables are float32
        in both packages, and PyTorch's float32 cos/sin differ from XLA's
        by an ulp (tests/test_torch_flash.py, test_torch_gpt.py), so the
        port gets the JAX package's tables."""
        jc, jp, tc, tp = long_cfgs(name, monkeypatch)
        x, _ = batch(7)
        cot = np.random.default_rng(8).standard_normal((B, jc.ctx_len,
                                                        jc.d_model))
        jh, vjp = jax.vjp(lambda p: jgpt._gpt_trunk(p, jnp.asarray(x), jc),
                          jp)
        (jg,) = vjp(jnp.asarray(cot))
        leaves = toptim.tree_leaves(tp)
        for p in leaves:
            p.requires_grad_(True)
        th = tgpt._gpt_trunk(tp, torch.from_numpy(x), tc)
        grads = torch.autograd.grad(th, leaves, torch.from_numpy(cot),
                                    allow_unused=True)
        # the head (head_b) is outside the trunk: a zero gradient in JAX
        grads = iter([torch.zeros_like(p) if g is None else g
                      for p, g in zip(leaves, grads)])
        got = flat(toptim.tree_map(lambda _: next(grads), tp))
        assert th.dtype == torch.float64
        np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh),
                                   rtol=1e-10, atol=1e-12)
        want = flat(jg)
        assert want.keys() == got.keys()
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-10,
                                       atol=1e-12, err_msg=key)

    @pytest.mark.parametrize("name", sorted(LONG_CFGS))
    def test_loss_and_every_gradient_long_cfgs(self, name, monkeypatch):
        """``gpt_loss`` and every gradient with the float64 trunk of the
        test above. Both packages cast the logits to float32 and take the
        cross-entropy there, so the loss and the gradients agree to float32
        rounding of the softmax, not to float64's: rtol 1e-5, and atol
        1e-7 for the tied embedding's entries, sums over all B*T positions
        of float32 logit gradients (~1e-6 of their typical size)."""
        jc, jp, tc, tp = long_cfgs(name, monkeypatch)
        x, y = batch(9)
        jl, jg = jax.value_and_grad(jgpt.gpt_loss)(jp, jnp.asarray(x),
                                                   jnp.asarray(y), jc)
        leaves = toptim.tree_leaves(tp)
        for p in leaves:
            p.requires_grad_(True)
        tl = tgpt.gpt_loss(tp, torch.from_numpy(x), torch.from_numpy(y), tc)
        grads = iter(torch.autograd.grad(tl, leaves))
        got = flat(toptim.tree_map(lambda _: next(grads), tp))
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
        want = flat(jg)
        assert want.keys() == got.keys()
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       atol=1e-7, err_msg=key)

    def test_bf16_drift_no_larger_than_jax(self):
        """bfloat16 against float32 at the RoPE + SwiGLU + GQA + window
        config: each package's relative gradient distance
        ||g_bf16 - g_f32|| / ||g_f32|| over all parameters, from the same
        ``init_gpt_params`` weights and numpy batch. The port's drift may
        exceed the JAX package's by at most 25% (bf16 rounds at other
        places in the two frameworks); both sit near 4e-2 at this size."""
        kw = dict(SMALL, **LONG_CFGS["rope_swiglu_gqa_window"])
        x, y = batch(11)

        def jax_grads(dtype):
            c = jgpt.GPTConfig(dtype=dtype, **kw)
            p = jgpt.init_gpt_params(c, seed=123)
            return flat(jax.grad(jgpt.gpt_loss)(p, jnp.asarray(x),
                                                jnp.asarray(y), c))

        def port_grads(dtype):
            c = tgpt.GPTConfig(dtype=dtype, **kw)
            p = tgpt.init_gpt_params(c, seed=123)
            leaves = toptim.tree_leaves(p)
            for leaf in leaves:
                leaf.requires_grad_(True)
            g = iter(torch.autograd.grad(tgpt.gpt_loss(
                p, torch.from_numpy(x), torch.from_numpy(y), c), leaves))
            return flat(toptim.tree_map(lambda _: next(g), p))

        def drift(g16, g32):
            num = sum(np.sum((g16[k].astype(np.float64) - g32[k]) ** 2)
                      for k in g32)
            den = sum(np.sum(g32[k].astype(np.float64) ** 2) for k in g32)
            return float(np.sqrt(num / den))

        jax_d = drift(jax_grads("bfloat16"), jax_grads("float32"))
        port_d = drift(port_grads("bfloat16"), port_grads("float32"))
        print(f"bf16 drift from f32: port {port_d:.4e}, jax {jax_d:.4e}")
        assert 0.0 < port_d <= 1.25 * jax_d

    def test_wide_vocab_matches_jax(self):
        """``gpt_loss`` at vocab_size 8192, the chunked CE in both packages
        (``nn.losses.chunked_softmax_ce``), and every gradient, float32;
        the float64 comparison is in tests/test_torch_losses.py."""
        jc, jp, tc, tp = both(vocab_size=8192)
        x, y = batch(1, V=8192)
        jl, jg = jax.value_and_grad(jgpt.gpt_loss)(jp, jnp.asarray(x),
                                                   jnp.asarray(y), jc)
        leaves = toptim.tree_leaves(tp)
        for p in leaves:
            p.requires_grad_(True)
        tl = tgpt.gpt_loss(tp, torch.from_numpy(x), torch.from_numpy(y), tc)
        grads = iter(torch.autograd.grad(tl, leaves))
        got = flat(toptim.tree_map(lambda _: next(grads), tp))
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
        want = flat(jg)
        assert want.keys() == got.keys()
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                       atol=1e-6, err_msg=key)


def rand_tree(jp, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (scale * rng.standard_normal(a.shape))
                        .astype(np.float32), jp)


class TestOptim:
    def test_masks_and_schedule(self):
        jc, jp, tc, tp = both()
        assert flat(toptim.gpt_wd_mask(tp, 0.1)) == flat(
            joptim.gpt_wd_mask(jp, 0.1))
        assert flat(toptim.gpt_lr_scales(tp, embed=2.0, head=0.5)) == flat(
            joptim.gpt_lr_scales(jp, embed=2.0, head=0.5))
        # float32 both ways; XLA's cos and numpy's differ by an ulp
        kw = dict(base=3e-4, min_lr=3e-5, warmup=200, max_steps=1000)
        for step in (0, 1, 3, 199, 200, 201, 640, 1000, 1200):
            np.testing.assert_allclose(
                toptim.warmup_cosine(step, **kw),
                float(joptim.warmup_cosine(step, **kw)), rtol=1e-6)

    @pytest.mark.parametrize("max_norm", [0.5, 1e6])
    def test_clip_by_global_norm(self, max_norm):
        jc, jp, tc, tp = both()
        g = rand_tree(jp, 1, 0.01)
        jg, jn = joptim.clip_by_global_norm(g, max_norm)
        tg, tn = toptim.clip_by_global_norm(
            tgpt.params_from_numpy(g), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for key, val in flat(jg).items():
            np.testing.assert_allclose(flat(tg)[key], val, rtol=1e-6,
                                       atol=1e-12, err_msg=key)

    @pytest.mark.parametrize("clip_norm", [0.0, 0.3])
    def test_adamw_three_updates(self, clip_norm):
        """Three updates from the same params, gradients and zero state;
        wd, lr scales and clipping on."""
        jc, jp, tc, tp = both()
        wd_j, wd_t = joptim.gpt_wd_mask(jp, 0.01), toptim.gpt_wd_mask(tp, 0.01)
        sc_j = joptim.gpt_lr_scales(jp, embed=0.5, head=2.0)
        sc_t = toptim.gpt_lr_scales(tp, embed=0.5, head=2.0)
        js, ts = joptim.adamw_init(jp), toptim.adamw_init(tp)
        for i, lr in enumerate((1e-3, 2e-3, 5e-4)):
            g = rand_tree(jp, 10 + i, 0.05)
            jp, js = joptim.adamw_update(jp, g, js, jnp.float32(lr), wd_j,
                                         lr_scales=sc_j, clip_norm=clip_norm)
            tp, ts = toptim.adamw_update(tp, tgpt.params_from_numpy(g), ts,
                                         lr, wd_t, lr_scales=sc_t,
                                         clip_norm=clip_norm)
        assert ts.t == int(js.t) == 3
        for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
            for key, val in flat(want).items():
                np.testing.assert_allclose(flat(got)[key], val, rtol=1e-5,
                                           atol=1e-7, err_msg=key)


class TestTrainStep:
    def test_three_step_trajectory(self):
        """``make_train_step`` of both packages from the same weights over
        the same numpy batches at steps 1..3."""
        jc, jp, tc, tp = both()
        kw = dict(base_lr=3e-4, min_lr=3e-5, warmup=200, max_steps=1000,
                  weight_decay=0.01)
        jstep = jtrainer.make_train_step(jc, **kw)
        tstep = ttrainer.make_train_step(tc, **kw)
        js, ts = joptim.adamw_init(jp), toptim.adamw_init(tp)
        for step in (1, 2, 3):
            x, y = batch(100 + step)
            jp, js, jl = jstep(jp, js, jnp.asarray(x), jnp.asarray(y), step)
            tp, ts, tl = tstep(tp, ts, torch.from_numpy(x),
                               torch.from_numpy(y), step)
            np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
        for key, val in flat(jp).items():
            np.testing.assert_allclose(flat(tp)[key], val, atol=1e-5,
                                       err_msg=key)

    def test_grad_accum_is_the_full_batch_step(self):
        """Two microbatches of 2 and one batch of 4 from the same generator
        seed give the same loss and update; the clip runs inside. Params
        atol 2e-6, 1.3% of the step's lr 1.5e-4: the first AdamW step
        moves each weight by lr * g / (|g| + 1e-8), which for a gradient
        element near 1e-8 follows the order of the microbatch sums."""
        _, _, tc, _ = both(n_layers=1, ctx_len=16)
        data = torch.as_tensor(np.random.default_rng(0).integers(
            0, 65, 500))
        out = []
        for accum in (1, 2):
            tp = tgpt.init_gpt_params(tc, seed=1)
            step = ttrainer.make_device_train_step(
                tc, 4, base_lr=3e-4, min_lr=3e-5, warmup=2, max_steps=10,
                weight_decay=0.01, grad_accum=accum, clip_norm=1.0)
            tp, st, _, loss = step(tp, toptim.adamw_init(tp), data,
                                   torch.Generator().manual_seed(3))
            out.append((float(loss), flat(tp)))
        np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-6)
        for key, val in out[0][1].items():
            np.testing.assert_allclose(out[1][1][key], val, atol=2e-6,
                                       err_msg=key)
        with pytest.raises(ValueError, match="divide"):
            ttrainer.make_device_train_step(
                tc, 4, base_lr=1.0, min_lr=0.1, warmup=1, max_steps=2,
                weight_decay=0.0, grad_accum=3)

    def test_eval_avg_matches_jax(self):
        jc, jp, tc, tp = both()
        ids = np.random.default_rng(4).integers(0, 65, 2000)
        want = jtrainer.eval_avg(jp, jc, jdata.batch_stream(
            ids, B, jc.ctx_len, np.random.default_rng(5)), batches=2)
        got = ttrainer.eval_avg(tp, tc, tdata.batch_stream(
            ids, B, tc.ctx_len, np.random.default_rng(5)), batches=2)
        np.testing.assert_allclose(got, want, rtol=1e-5)


class TestData:
    def test_synthetic_corpus_equal(self):
        assert tdata.synthetic_corpus() == jdata.synthetic_corpus()
        assert tdata.synthetic_corpus(5000, seed=3) == \
            jdata.synthetic_corpus(5000, seed=3)

    def test_vocab_encode_and_windows(self):
        text = tdata.synthetic_corpus(20_000)
        assert tdata.build_char_vocab(text) == jdata.build_char_vocab(text)
        stoi, itos = tdata.build_char_vocab(text)
        s = text[:500] + "é~"  # two characters outside the vocabulary
        np.testing.assert_array_equal(tdata.encode(s, stoi),
                                      jdata.encode(s, stoi))
        ids = tdata.encode(text, stoi)
        assert tdata.decode(ids[:300], itos) == text[:300]
        tx = next(tdata.batch_stream(ids, 4, 16, np.random.default_rng(9)))
        jx = next(jdata.batch_stream(ids, 4, 16, np.random.default_rng(9)))
        for a, b in zip(tx, jx):
            np.testing.assert_array_equal(a, b)

    def test_load_text_can_refuse_the_synthetic_corpus(self, tmp_path,
                                                       monkeypatch):
        """``allow_synthetic=False`` with no corpus raises
        FileNotFoundError, as the JAX package's does; the default still
        falls back to the synthetic corpus."""
        from linalg_tpu_torch.train import data as tdata

        monkeypatch.delenv("LINALG_TPU_DATA", raising=False)
        monkeypatch.setattr(tdata, "_LOCAL_CANDIDATES", ())
        missing = str(tmp_path / "none.txt")
        with pytest.raises(FileNotFoundError, match="corpus"):
            tdata.load_text(missing, allow_synthetic=False)
        assert tdata.load_text(missing) == tdata.synthetic_corpus()
        (tmp_path / "c.txt").write_text("x" * 2000, encoding="utf-8")
        assert tdata.load_text(str(tmp_path / "c.txt"),
                               allow_synthetic=False) == "x" * 2000

    def test_load_text_prefers_a_local_file(self, tmp_path, monkeypatch):
        corpus = tmp_path / "corpus.txt"
        corpus.write_text("to be or not to be\n" * 100, encoding="utf-8")
        monkeypatch.setenv("LINALG_TPU_DATA", str(corpus))
        assert tdata.load_text() == corpus.read_text(encoding="utf-8")


def test_checkpoint_loads_in_jax(tmp_path):
    """A checkpoint saved by the port loads in the JAX package with equal
    arrays and config (and back in the port)."""
    jc, jp, tc, tp = both(n_kv_heads=2, pos="learned", d_ff=96)
    text = tdata.synthetic_corpus(3000)
    stoi, itos = tdata.build_char_vocab(text)
    tckpt.save_ckpt(tmp_path, tp, tc, stoi, itos)
    params, cfg, jstoi, jitos = jckpt.load_ckpt(tmp_path)
    assert cfg == jc and jstoi == stoi and jitos == itos
    want = flat(tp)
    assert flat(params).keys() == want.keys()
    for key, val in flat(params).items():
        np.testing.assert_array_equal(val, want[key], err_msg=key)
    back, cfg2, _, _ = tckpt.load_ckpt(tmp_path)
    assert cfg2 == tc
    for key, val in flat(back).items():
        np.testing.assert_array_equal(val, want[key], err_msg=key)


class TestCLI:
    def test_train_then_serve(self, tmp_path, capsys):
        """``--train`` on the CPU writes a checkpoint that ``--serve`` of
        the same package loads and serves from."""
        ck = tmp_path / "ck"
        prompts = tmp_path / "prompts.txt"
        prompts.write_text("FIRST CITIZEN:\nALL:\n", encoding="utf-8")
        out = tmp_path / "out.jsonl"
        tapp.main(["--train", "--steps", "3", "--eval_every", "2",
                   "--d_model", "32", "--layers", "2", "--heads", "2",
                   "--ctx_len", "32", "--batch_size", "4", "--device", "cpu",
                   "--ckpt_dir", str(ck), "--log_file",
                   str(tmp_path / "log.jsonl")])
        said = capsys.readouterr().out
        assert "step      1  loss" in said and "saved best" in said
        params, cfg, _, _ = tckpt.load_ckpt(ck)
        assert (cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.ctx_len) == (
            32, 2, 2, 32)
        tapp.main(["--serve", "--ckpt_dir", str(ck), "--prompts",
                   str(prompts), "--gen_tokens", "8", "--chunk", "4",
                   "--device", "cpu", "--out", str(out)])
        rows = out.read_text(encoding="utf-8").splitlines()
        assert len(rows) == 2 and all('"new_tokens": 8' in r for r in rows)
        events = (tmp_path / "log.jsonl").read_text().splitlines()
        assert [e.split('"event": "')[1].split('"')[0] for e in events] == [
            "train", "eval", "done"]

    @pytest.mark.parametrize("argv,item", [
        (["--train", "--dp", "2"], "item 7"),
        (["--train", "--tp", "2"], "item 7"),
        (["--train", "--pp", "2"], "item 7"),
        (["--train", "--sp", "2", "--pp", "2"], "item 7"),
        (["--train", "--fsdp", "2"], "item 7"),
        (["--train", "--experts", "4"], "item 6"),
        (["--train", "--microbatches", "4"], "item 7"),
        (["--train", "--router_top_k", "2"], "item 6"),
        (["--train", "--dispatch", "gather"], "item 6"),
    ])
    def test_unported_flags_raise(self, argv, item, tmp_path):
        """The flags once refused, labelled by the ROADMAP item that
        ported them. Item 7's parallel axes (and --microbatches) each
        train one CPU step over ranks sharing the CPU, the checkpoint
        whole; --sp 2 --pp 2, which the JAX trainer refuses, raises its
        AssertionError in both packages. Item 6's MoE flags train an MoE
        model (with --experts 4 added where the case leaves it out) whose
        checkpoint carries them."""
        small = ["--steps", "1", "--eval_every", "1", "--d_model", "16",
                 "--layers", "2", "--heads", "2", "--ctx_len", "16",
                 "--batch_size", "2", "--device", "cpu", "--ckpt_dir",
                 str(tmp_path / "ck")]
        if item == "item 7":
            if "--sp" in argv:
                match = "--pp composes with --dp only"
                with pytest.raises(AssertionError, match=match):
                    tapp.main(argv + small)
                from linalg_tpu.apps import gpt as japp

                jargs = japp.build_parser().parse_args(
                    argv + small[:-4] + ["--ckpt_dir", str(tmp_path / "j")])
                with pytest.raises(AssertionError, match=match):
                    jtrainer.train(jargs)
                return
            tapp.main(argv + small)
            params, cfg, _, _ = tckpt.load_ckpt(tmp_path / "ck")
            assert params["layers"]["Wq"].shape == (2, 16, 16)
            return
        if "--experts" not in argv:
            argv = argv + ["--experts", "4"]
        ck = tmp_path / "ck"
        tapp.main(argv + ["--steps", "1", "--eval_every", "1", "--d_model",
                          "16", "--layers", "1", "--heads", "2", "--ctx_len",
                          "16", "--batch_size", "2", "--device", "cpu",
                          "--ckpt_dir", str(ck)])
        _, cfg, _, _ = tckpt.load_ckpt(ck)
        args = tapp.build_parser().parse_args(argv)
        assert (cfg.n_experts, cfg.router_top_k) == (args.experts,
                                                     args.router_top_k)

    @pytest.mark.parametrize("flag", [
        "--pos rope", "--ffn swiglu", "--window 8",
        "--pos rope --ffn swiglu --kv_heads 2 --window 8",
        "--pos alibi --ffn geglu"])
    def test_unported_model_flags_raise(self, flag, tmp_path):
        """Each long-context flag (once refused) trains one CPU step; the
        checkpoint loads in the JAX package with the same config (window
        and gate included) and equal arrays, and a checkpoint the JAX
        package saves from them loads back in the port."""
        ck = tmp_path / "ck"
        tapp.main(["--train", "--steps", "1", "--eval_every", "1",
                   "--d_model", "32", "--layers", "2", "--heads", "4",
                   "--ctx_len", "32", "--batch_size", "2", "--device",
                   "cpu", "--ckpt_dir", str(ck), *flag.split()])
        params, cfg, stoi, itos = tckpt.load_ckpt(ck)
        args = tapp.build_parser().parse_args(flag.split())
        assert (cfg.pos, cfg.ffn, cfg.window, cfg.n_kv_heads) == (
            args.pos, args.ffn, args.window, args.kv_heads)
        jparams, jcfg, jstoi, jitos = jckpt.load_ckpt(ck)
        assert dataclasses.asdict(jcfg) == jax_fields(cfg)
        assert (jstoi, jitos) == (stoi, itos)
        want = flat(params)
        assert flat(jparams).keys() == want.keys()
        for key, val in flat(jparams).items():
            np.testing.assert_array_equal(val, want[key], err_msg=key)
        jckpt.save_ckpt(tmp_path / "jax", jparams, jcfg, jstoi, jitos)
        back, cfg2, _, _ = tckpt.load_ckpt(tmp_path / "jax")
        assert cfg2 == cfg
        for key, val in flat(back).items():
            np.testing.assert_array_equal(val, want[key], err_msg=key)

    def test_trainer_refuses_sharding_and_lora(self):
        """The JAX trainer's refusals of a mesh: --tp with --sp (the
        sharded trainer's assert, after the model is built); then LoRA's
        two ValueErrors."""
        args = tapp.build_parser().parse_args(
            ["--tp", "2", "--sp", "2", "--device", "cpu", "--ckpt_dir",
             "/nonexistent/ck"])
        with pytest.raises(AssertionError, match="--sp composes with --dp "
                           "only"):
            ttrainer.train(args)
        # LoRA (once refused as unported) adapts a trained checkpoint on
        # one device: the JAX trainer's two ValueErrors
        args = tapp.build_parser().parse_args(["--lora_rank", "2", "--tp",
                                               "2"])
        with pytest.raises(ValueError, match="single-device"):
            ttrainer.train(args)
        args = tapp.build_parser().parse_args(
            ["--lora_rank", "2", "--ckpt_dir", "/nonexistent/ck",
             "--device", "cpu"])
        with pytest.raises(ValueError, match="TRAINED base"):
            ttrainer.train(args)


def test_training_modules_import_no_jax():
    code = ("import sys\n"
            "import linalg_tpu_torch.train.trainer, linalg_tpu_torch.nn.flash"
            ", linalg_tpu_torch.nn.flash_long, linalg_tpu_torch.apps.gpt"
            ", linalg_tpu_torch.nn.flash_stream, linalg_tpu_torch.nn.positional"
            "\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'linalg_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
