"""The port's chunked softmax cross-entropy (linalg_tpu_torch/nn/losses.py)
and the wide-vocabulary ``gpt_loss`` against the JAX package's.

Same numpy-seeded inputs go through both packages on the CPU. The JAX
package casts h, W and b to float32 before its chunk products whatever
their type; its float64 comparisons here run the same closed form with
float64 as the working type (the module's ``jnp.float32`` and its float32
padding logit redirected to float64 for the test's duration, nothing of
the package edited), so they
measure the algorithm, not float32 rounding. Tolerances: float64 loss and
gradients rtol 1e-10 (chunked CE) and 1e-9 (``gpt_loss`` through a
2-layer trunk); float32 rtol 1e-5. Gradient entries that are sums of
cancelling terms (a dW entry near 1e-20 beside entries of 1e-4) also get
an atol of 1e-12 x max|want| in float64 and 1e-6 x max|want| in float32:
sums taken in another order. The bf16 tensor-core path (a bfloat16 h on a
card) is held on the card by ``tests/test_torch_losses_card.py``; here a
profiled run shows that a CPU h, bfloat16 included, takes the products in
the working type.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from linalg_tpu.models import gpt as jgpt
from linalg_tpu.nn import losses as jlosses
from linalg_tpu_torch.models import gpt as tgpt
from linalg_tpu_torch.nn.losses import DEFAULT_CHUNK, chunked_softmax_ce
from linalg_tpu_torch.train import optim as toptim

torch.set_num_threads(2)


class _Jnp64:
    """``jax.numpy`` with ``float32`` meaning float64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def jax_ce_f64(monkeypatch):
    monkeypatch.setattr(jlosses, "jnp", _Jnp64())
    monkeypatch.setattr(jlosses, "_NEG", jnp.float64(-1e30))


def args(N, D, V, dtype, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((N, D)).astype(dtype),
            scale * (0.3 * rng.standard_normal((V, D))).astype(dtype),
            (0.1 * rng.standard_normal((V,))).astype(dtype),
            rng.integers(0, V, (N,)).astype(np.int32))


def jax_ce(h, W, b, y, chunk):
    f = lambda h, W, b: jlosses.chunked_softmax_ce(h, W, b, jnp.asarray(y),
                                                   chunk)
    loss, grads = jax.value_and_grad(f, argnums=(0, 1, 2))(
        jnp.asarray(h), jnp.asarray(W), jnp.asarray(b))
    return [np.asarray(loss)] + [np.asarray(g) for g in grads]


def port_ce(h, W, b, y, chunk):
    ts = [torch.tensor(a, requires_grad=True) for a in (h, W, b)]
    loss = chunked_softmax_ce(*ts, torch.from_numpy(y), chunk)
    grads = torch.autograd.grad(loss, ts)
    return [loss.detach().numpy()] + [g.numpy() for g in grads]


def assert_close(got, want, rtol, atol_of_max=0.0, what=""):
    for g, w, name in zip(got, want, ("loss", "dh", "dW", "db")):
        assert g.dtype == w.dtype, (what, name, g.dtype, w.dtype)
        np.testing.assert_allclose(
            g, w, rtol=rtol, atol=atol_of_max * float(np.abs(w).max()),
            err_msg=f"{what} {name}")


CASES = [(8192, 4096), (8200, 4096), (8192, 1000), (8200, 1000)]


@pytest.mark.parametrize("V,chunk", CASES)
def test_chunked_ce_f64_matches_jax(V, chunk, jax_ce_f64):
    """Loss and dh, dW, db in float64 at V 8192 and 8200 (the vocabulary
    padded to a chunk multiple) and chunks 4096 and 1000."""
    a = args(48, 32, V, np.float64)
    assert_close(port_ce(*a, chunk), jax_ce(*a, chunk), rtol=1e-10,
                 atol_of_max=1e-12, what=f"V {V} chunk {chunk}")


@pytest.mark.parametrize("V,chunk", CASES)
def test_chunked_ce_f32_matches_jax(V, chunk):
    a = args(48, 32, V, np.float32)
    assert_close(port_ce(*a, chunk), jax_ce(*a, chunk), rtol=1e-5,
                 atol_of_max=1e-6, what=f"V {V} chunk {chunk}")


def test_chunked_ce_matches_full_logits():
    """The chunked loss and gradients against autograd through the full
    float64 logits and logsumexp (the small-vocabulary path)."""
    h, W, b, y = args(40, 16, 5000, np.float64, seed=3)
    got = port_ce(h, W, b, y, 1024)
    ts = [torch.tensor(a, requires_grad=True) for a in (h, W, b)]
    logits = ts[0] @ ts[1].T + ts[2]
    loss = torch.mean(torch.logsumexp(logits, -1)
                      - logits[torch.arange(40), torch.from_numpy(y).long()])
    want = [loss.detach().numpy()] + [g.numpy() for g in
                                      torch.autograd.grad(loss, ts)]
    assert_close(got, want, rtol=1e-10, atol_of_max=1e-14)


def test_extreme_logits_stay_finite():
    """Logits of order 1e4 (h and W scaled by 100): the online max keeps
    the loss and every gradient finite and equal to the direct float64
    computation."""
    h, W, b, y = args(64, 32, 300, np.float32, scale=100.0)
    got = port_ce(h, W, b, y, 128)
    logits = h.astype(np.float64) @ W.T.astype(np.float64) + b
    assert np.abs(logits).max() > 1e4
    m = logits.max(-1)
    ref = np.mean(np.log(np.exp(logits - m[:, None]).sum(-1)) + m
                  - logits[np.arange(64), y])
    assert all(np.isfinite(g).all() for g in got)
    assert abs(float(got[0]) - ref) < 1e-3 * max(1.0, ref)
    assert_close(got, jax_ce(h, W, b, y, 128), rtol=1e-4, atol_of_max=1e-5)


def test_bf16_hidden_keeps_its_dtype():
    """A bfloat16 h is cast to float32 for the products; dh comes back in
    bfloat16, as in the JAX package."""
    h, W, b, y = args(16, 32, 300, np.float32)
    th = torch.tensor(h).bfloat16().requires_grad_(True)
    loss = chunked_softmax_ce(th, torch.tensor(W), torch.tensor(b),
                              torch.from_numpy(y), 128)
    (dh,) = torch.autograd.grad(loss, [th])
    assert loss.dtype == torch.float32 and dh.dtype == torch.bfloat16
    jl = jlosses.chunked_softmax_ce(jnp.asarray(h, jnp.bfloat16),
                                    jnp.asarray(W), jnp.asarray(b),
                                    jnp.asarray(y), 128)
    assert abs(float(loss.detach()) - float(jl)) < 1e-5 * abs(float(jl))


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


def flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor)
                       else v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_gpt_loss_wide_vocab_f64_matches_jax(jax_ce_f64, monkeypatch):
    """``gpt_loss`` at vocab_size 8192 (the chunked path in both packages)
    and every gradient, float64 trunk and CE, rtol 1e-9."""
    kw = dict(vocab_size=8192, d_model=32, n_heads=2, n_layers=2,
              ctx_len=16)
    jc, tc = JaxCfg64(**kw), PortCfg64(**kw)
    host = jax.tree.map(lambda a: np.asarray(a, np.float64),
                        jgpt.init_gpt_params(jc, seed=4))
    from linalg_tpu.nn import functional as jF
    monkeypatch.setattr(tgpt, "sinusoidal_encoding", lambda n, d, device: (
        torch.tensor(np.asarray(jF.sinusoidal_encoding(n, d)))))
    rng = np.random.default_rng(5)
    x, y = rng.integers(0, 8192, (2, 16)), rng.integers(0, 8192, (2, 16))
    jl, jg = jax.value_and_grad(jgpt.gpt_loss)(
        jax.tree.map(jnp.asarray, host), jnp.asarray(x), jnp.asarray(y), jc)
    tp = tgpt.params_from_numpy(host)
    leaves = toptim.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tl = tgpt.gpt_loss(tp, torch.from_numpy(x), torch.from_numpy(y), tc)
    grads = iter(torch.autograd.grad(tl, leaves))
    got = flat(toptim.tree_map(lambda _: next(grads), tp))
    assert tl.dtype == torch.float64
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-9)
    want = flat(jg)
    assert want.keys() == got.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-9,
                                   atol=1e-13, err_msg=key)


def test_default_chunk_is_jax_s():
    assert DEFAULT_CHUNK == jlosses.DEFAULT_CHUNK == 4096
    assert tgpt.CE_CHUNK_THRESHOLD == jgpt.CE_CHUNK_THRESHOLD == 8192


@pytest.mark.parametrize("dtype,path", [(torch.bfloat16, "f32"),
                                        (torch.float32, "f32"),
                                        (torch.float64, "f64")])
def test_ce_spans_name_the_cpu_path(dtype, path):
    """Under a profiler the forward's and the backward's chunk loops run in
    ``ce.forward`` / ``ce.backward`` spans whose args name the products'
    precision: on the CPU a bfloat16 h takes float32 products, as in the
    JAX package. V 300 in chunks of 128 is 3 chunks."""
    h, W, b, y = args(16, 32, 300, np.float64)
    th = torch.tensor(h).to(dtype).requires_grad_(True)
    tW, tb = (torch.tensor(a).to(torch.promote_types(dtype, torch.float32))
              for a in (W, b))
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        loss = chunked_softmax_ce(th, tW, tb, torch.from_numpy(y), 128)
        torch.autograd.grad(loss, [th])
    for name in ("ce.forward", "ce.backward"):
        (ev,) = [e for e in prof.events() if e.name == name]
        assert ev.kwinputs == {"path": path, "chunks": 3}, name
