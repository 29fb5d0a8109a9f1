"""The port's sequence parallelism (linalg_tpu_torch/parallel) against the
JAX package's, on the CPU.

The JAX side runs its own functions on (n,) and (2, 4) meshes of the
conftest's virtual CPU devices; where it reaches the ring kernels K10/K11
it runs them in Pallas interpret mode (on a (2, 4) mesh it takes its
documented XLA-ring fallback). The port's ranks share the CPU: its plain
ring (``--ring xla``) and its kernel ring (``--ring pallas``), whose
steps run the kernels' plain versions through the same slots, rotations
and bundle lap as on the card. Inputs come from numpy seeds. Tolerance:
float32 atol 1e-5, as tests/test_parallel.py holds the JAX rings (sums in
another order); losses rel 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_tpu.models.gpt import GPTConfig as JCfg
from linalg_tpu.models.gpt import init_gpt_params as jinit
from linalg_tpu.nn.positional import alibi_slopes as jslopes
from linalg_tpu.parallel import make_mesh as jmake_mesh
from linalg_tpu.parallel import make_ring_attention as jring
from linalg_tpu.parallel import make_ring_attention_pallas as jring_pallas
from linalg_tpu.parallel import make_sp_train_step as jsp_step
from linalg_tpu.train.optim import adamw_init as jadamw_init
from linalg_tpu_torch.models.gpt import GPTConfig, init_gpt_params
from linalg_tpu_torch.parallel import (make_mesh, make_ring_attention,
                                       make_ring_attention_pallas,
                                       make_sp_train_step, pick_dp_tp)
from linalg_tpu_torch.train.optim import adamw_init

torch.set_num_threads(2)

ATOL = 1e-5
SLOPES = tuple(float(s) for s in jslopes(2))
# name: make_* keyword arguments (T 32 over 4 ranks is Tl 8: window 12
# reaches one chunk back and leaves the older ones dead)
CASES = {
    "causal": dict(),
    "full": dict(causal=False),
    "window12": dict(window=12),
    "alibi": dict(slopes=SLOPES),
}


def qkvw(B=2, h=2, T=32, d=8, seed=0):
    """q, k, v and a cotangent, float32 numpy."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, h, T, d)).astype(np.float32)
            for _ in range(4)]


def jax_mesh(shape):
    names = ("sp",) if len(shape) == 1 else ("dp", "sp")
    n = int(np.prod(shape))
    return jmake_mesh(shape, names, jax.devices()[:n])


def port_mesh(shape):
    names = ("sp",) if len(shape) == 1 else ("dp", "sp")
    return make_mesh(shape, names, ["cpu"] * int(np.prod(shape)))


def jax_out_grads(attn, arrs):
    """attn's output and the gradients of sum(out * w) in q, k, v, in one
    jitted call."""
    def f(q, k, v, w):
        out, vjp = jax.vjp(attn, q, k, v)
        return (out,) + vjp(w)

    return [np.asarray(x) for x in jax.jit(f)(*(jnp.asarray(a)
                                                for a in arrs))]


def port_out_grads(attn, arrs, dtype=torch.float32):
    q, k, v = (torch.tensor(a, dtype=dtype, requires_grad=True)
               for a in arrs[:3])
    out = attn(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), torch.tensor(
        arrs[3], dtype=dtype))
    return [x.detach().float().numpy() for x in (out,) + grads]


def assert_close(got, want, atol=ATOL):
    for what, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=atol, err_msg=what)


class TestMesh:
    def test_pick_dp_tp_matches_jax(self):
        from linalg_tpu.parallel import pick_dp_tp as jpick

        for n, h in ((8, 4), (8, 8), (8, 3), (4, 4), (1, 4), (6, 4)):
            assert pick_dp_tp(n, h) == jpick(n, h)

    def test_ranks_may_share_a_device_but_not_be_missing(self):
        mesh = make_mesh((2, 4), ("dp", "sp"), ["cpu"] * 8)
        assert mesh.shape == {"dp": 2, "sp": 4}
        assert mesh.devices.shape == (2, 4)
        assert all(d == torch.device("cpu") for d in mesh.devices.flat)
        with pytest.raises(ValueError, match="needs 8 devices"):
            make_mesh((2, 4), ("dp", "sp"), ["cpu"] * 4)

    def test_default_devices_are_cards_and_raise_without_one(self,
                                                            monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh((1,), ("sp",))
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        mesh = make_mesh(None, ("dp", "sp"))
        assert mesh.shape == {"dp": 2, "sp": 1}
        assert list(mesh.devices.flat) == [torch.device("cuda", 0),
                                           torch.device("cuda", 1)]


class TestPlainRing:
    """``make_ring_attention`` (``--ring xla``) against JAX's ppermute
    ring, forward and gradients (torch autograd vs ``jax.grad``)."""

    @pytest.mark.parametrize("name", sorted(CASES))
    def test_matches_jax_ring(self, name):
        arrs = qkvw(seed=1)
        kw = CASES[name]
        want = jax_out_grads(jring(jax_mesh((4,)), **kw), arrs)
        got = port_out_grads(make_ring_attention(port_mesh((4,)), **kw),
                             arrs)
        assert_close(got, want)

    def test_dp_x_sp_mesh(self):
        arrs = qkvw(seed=2)
        want = jax_out_grads(jring(jax_mesh((2, 4)), batch_axis="dp"), arrs)
        got = port_out_grads(make_ring_attention(port_mesh((2, 4)),
                                                 batch_axis="dp"), arrs)
        assert_close(got, want)


class TestKernelRing:
    """``make_ring_attention_pallas`` against JAX's Pallas ring (K10/K11
    in interpret mode): the forward and all three gradients."""

    @pytest.mark.parametrize("name", sorted(CASES))
    @pytest.mark.parametrize("n", [2, 4, 8])
    def test_matches_jax_pallas_ring(self, n, name):
        arrs = qkvw(T=32 if n < 8 else 64, seed=10 + n)
        kw = CASES[name]
        want = jax_out_grads(jring_pallas(jax_mesh((n,)), **kw), arrs)
        got = port_out_grads(
            make_ring_attention_pallas(port_mesh((n,)), **kw), arrs)
        assert_close(got, want)

    def test_dp_x_sp_mesh(self):
        arrs = qkvw(seed=3)
        want = jax_out_grads(jring_pallas(jax_mesh((2, 4)), batch_axis="dp",
                                          window=12), arrs)
        got = port_out_grads(make_ring_attention_pallas(
            port_mesh((2, 4)), batch_axis="dp", window=12), arrs)
        assert_close(got, want)

    @pytest.mark.parametrize("d", [16, 40])
    def test_padded_head_widths_match_the_plain_ring(self, d):
        """Heads narrower than a kernel width are zero-padded to it with
        the scale of the true width."""
        arrs = qkvw(d=d, seed=4)
        want = port_out_grads(make_ring_attention(port_mesh((4,)),
                                                  window=12), arrs)
        got = port_out_grads(make_ring_attention_pallas(port_mesh((4,)),
                                                        window=12), arrs)
        assert_close(got, want)

    def test_bf16_tracks_f32(self):
        """bf16 in and out, float32 inside: within bf16 resolution of the
        f32 result, gradients finite (tests/test_parallel.py:488-507)."""
        arrs = qkvw(B=1, seed=11)
        attn = make_ring_attention_pallas(port_mesh((4,)))
        o32 = port_out_grads(attn, arrs)
        o16 = port_out_grads(attn, arrs, dtype=torch.bfloat16)
        assert float(np.max(np.abs(o16[0] - o32[0]))) < 0.1
        assert all(np.isfinite(g).all() for g in o16[1:])
        want = jax_out_grads(jring_pallas(jax_mesh((4,))), arrs)
        assert float(np.max(np.abs(o16[0] - want[0]))) < 0.1

    def test_refusals(self):
        with pytest.raises(ValueError, match="causal"):
            make_ring_attention_pallas(port_mesh((4,)), causal=False,
                                       window=4)
        attn = make_ring_attention_pallas(port_mesh((4,)))
        q = torch.zeros(1, 1, 30, 8)
        with pytest.raises(ValueError, match="divide"):
            attn(q, q, q)


# AdamW's first steps move each weight by ~lr whatever the size of its
# gradient, so a weight whose gradient is near 0 turns the gradients'
# float32 rounding (sums in another order) into a change of up to ~lr: at
# lr 1e-3 that stays inside the 1e-5 atol
LR = 1e-3


class TestSequenceParallelStep:
    """``make_sp_train_step`` against JAX's on a (2, 4) mesh: the same
    weights (one numpy draw) and batches; losses of six steps and the
    parameters after two."""

    CFG = dict(vocab_size=17, d_model=32, n_heads=4, n_layers=2, d_ff=64,
               ctx_len=32)

    @pytest.fixture(scope="class")
    def jax_run(self):
        cfg = JCfg(**self.CFG)
        rng = np.random.default_rng(0)
        x, y = (rng.integers(0, 17, (4, 32), np.int32) for _ in range(2))
        step = jsp_step(cfg, jax_mesh((2, 4)), lr=LR, weight_decay=0.0)
        p = jinit(cfg, seed=0)
        o = jadamw_init(p)
        losses, after2 = [], None
        for i in range(6):
            p, o, loss = step(p, o, jnp.asarray(x), jnp.asarray(y))
            losses.append(float(loss))
            if i == 1:
                after2 = {path: np.asarray(a) for path, a in
                          jax.tree_util.tree_flatten_with_path(p)[0]}
        return x, y, losses, after2

    @pytest.mark.parametrize("pallas", [False, True], ids=["plain", "kernels"])
    def test_matches_jax(self, jax_run, pallas):
        x, y, want_losses, want_params = jax_run
        cfg = GPTConfig(**self.CFG)
        step = make_sp_train_step(cfg, port_mesh((2, 4)), lr=LR,
                                  weight_decay=0.0, pallas=pallas)
        p = init_gpt_params(cfg, seed=0)
        o = adamw_init(p)
        xt, yt = torch.tensor(x), torch.tensor(y)
        losses = []
        for i in range(6):
            p, o, loss = step(p, o, xt, yt)
            losses.append(float(loss))
            if i == 1:
                for path, want in want_params.items():
                    got = p
                    for key in path:
                        got = got[key.key]
                    np.testing.assert_allclose(got.detach().numpy(), want,
                                               atol=ATOL, err_msg=str(path))
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
        assert losses[-1] < losses[0]


class TestSequenceParallelCLI:
    """The CLI cases of tests/test_parallel.py:427-450, on the CPU."""

    def test_train_sp_via_cli_flags(self, tmp_path):
        from linalg_tpu_torch.apps.gpt import build_parser
        from linalg_tpu_torch.train.trainer import train

        args = build_parser().parse_args([
            "--train", "--steps", "10", "--eval_every", "10",
            "--batch_size", "8", "--ctx_len", "32", "--d_model", "32",
            "--heads", "4", "--layers", "1", "--ckpt_dir", str(tmp_path),
            "--dp", "2", "--sp", "4", "--device", "cpu",
        ])
        params, cfg, stoi, itos = train(args)
        assert (tmp_path / "chars_gpt_best.npz").exists()

    @pytest.mark.parametrize("extra,match", [
        (["--tp", "2"], "composes with --dp"),
        (["--experts", "2"], "--experts"),
        (["--ctx_len", "30"], "ctx_len must divide by sp"),
    ])
    def test_sp_refusals(self, tmp_path, extra, match):
        from linalg_tpu_torch.apps.gpt import build_parser
        from linalg_tpu_torch.train.trainer import train

        args = build_parser().parse_args([
            "--train", "--steps", "1", "--ctx_len", "32", "--d_model", "32",
            "--heads", "4", "--layers", "1", "--ckpt_dir",
            str(tmp_path / "x"), "--sp", "4", "--device", "cpu", *extra,
        ])
        with pytest.raises(AssertionError, match=match):
            train(args)

    @pytest.mark.parametrize("ring", ["xla", "pallas"])
    def test_sp_run_draws_the_single_device_batches(self, tmp_path, capsys,
                                                    ring):
        """Same seed, same windows: the sp run's step-1 loss equals the
        single-device run's, and its mesh line names the shared device."""
        from linalg_tpu_torch.apps import gpt as tapp

        common = ["--train", "--steps", "1", "--eval_every", "5",
                  "--batch_size", "4", "--ctx_len", "32", "--d_model",
                  "32", "--heads", "2", "--layers", "2", "--pos", "alibi",
                  "--window", "12", "--device", "cpu"]

        def loss1(extra, ck):
            tapp.main(common + ["--ckpt_dir", str(tmp_path / ck), *extra])
            out = capsys.readouterr().out
            line = next(ln for ln in out.splitlines() if "step      1" in ln)
            return float(line.split("loss")[1].split()[0]), out

        single, _ = loss1([], "one")
        sharded, out = loss1(["--sp", "4", "--dp", "2", "--ring", ring],
                             "sp")
        assert "mesh dp=2 sp=4: 8 ranks share cpu" in out
        assert sharded == pytest.approx(single, rel=1e-5)
