"""The port's routed MoE GPT (linalg_tpu_torch/models/moe.py, its
training, checkpoints, sampling, serving and CLI) against the JAX
package's ``linalg_tpu.models.moe``.

Tiny configs (d 32, 2 heads, 2 layers, 4 experts), inputs from numpy
seeds, JAX with x64 and the port in float64. Both packages keep the
router, the slot counts, the aux loss and the logits in float32 whatever
the compute dtype; the float64 comparisons redirect those casts to
float64 in both (the JAX module's ``jnp.float32``, the port's
``_ROUTER_DTYPE`` and ``_head``), take the RoPE tables in float64 in
both and hand the port the JAX package's float32 sinusoidal table
(PyTorch's float32 cos/sin differ from XLA's by an ulp, and so do XLA's
own inside and outside a jit). Tolerances: ``moe_ffn`` outputs and aux
rtol 1e-9, routing (expert ids, slots, drops) exactly; ``moe_gpt_loss``
and every gradient rtol 1e-8; decode logits rtol 1e-9 and greedy tokens
exactly. Checkpoints, sampling, the engine and the CLI are in
tests/test_torch_moe_serve.py.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_tpu.models import gpt as jgpt
from linalg_tpu.models import moe as jmoe
from linalg_tpu.nn import functional as jF
from linalg_tpu.train import trainer as jtrainer
from linalg_tpu_torch.models import gpt as tgpt
from linalg_tpu_torch.models import moe as tmoe
from linalg_tpu_torch.train import optim as toptim
from linalg_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(2)

TINY = dict(vocab_size=19, d_model=32, n_heads=2, n_layers=2, ctx_len=32,
            n_experts=4)


@dataclasses.dataclass(frozen=True)
class JaxMoE64(jmoe.MoEGPTConfig):
    @property
    def compute_dtype(self):
        return jnp.float64


@dataclasses.dataclass(frozen=True)
class PortMoE64(tmoe.MoEGPTConfig):
    @property
    def compute_dtype(self):
        return torch.float64


def flat(tree):
    """{'a/b': numpy leaf} of a JAX pytree or the port's nested dicts."""
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor)
                       else v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture
def f64(monkeypatch):
    """Both packages' float32 router/count/logit casts in float64, RoPE
    tables in float64 in both, and the JAX package's sinusoidal table in
    the port."""
    proxy = types.SimpleNamespace(
        **{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")})
    proxy.float32 = jnp.float64
    monkeypatch.setattr(jmoe, "jnp", proxy)
    monkeypatch.setattr(tmoe, "_ROUTER_DTYPE", torch.float64)
    monkeypatch.setattr(tmoe, "_head", lambda p, h, dt: (
        h @ p["tok_W"].to(dt).T + p["head_b"].to(dt)))
    def jtables(d, pos):
        ang = jnp.asarray(pos, jnp.float64)[..., None] / (
            10000.0 ** (jnp.arange(0, d, 2, dtype=jnp.float64) / d))
        return jnp.cos(ang), jnp.sin(ang)

    def ttables(d, pos):
        ang = torch.as_tensor(pos).double()[..., None] / (
            10000.0 ** (torch.arange(0, d, 2, dtype=torch.float64) / d))
        return torch.cos(ang), torch.sin(ang)

    sinus = lambda n, d, device=None: torch.tensor(  # noqa: E731
        np.asarray(jF.sinusoidal_encoding(n, d)))
    for mod in (jgpt, jmoe):
        monkeypatch.setattr(mod, "rope_tables", jtables)
    for mod in (tgpt, tmoe):
        monkeypatch.setattr(mod, "rope_tables", ttables)
        monkeypatch.setattr(mod, "sinusoidal_encoding", sinus)


def jax_init(cfg, seed):
    """JAX's float32 ``init_moe_params``, also under the ``f64`` fixture."""
    proxy, jmoe.jnp = jmoe.jnp, jnp
    try:
        return jmoe.init_moe_params(cfg, seed=seed)
    finally:
        jmoe.jnp = proxy


def cfgs64(**over):
    """(jax cfg, jax f64 params, port cfg, port f64 params): float32 inits
    checked bit-equal first."""
    kw = dict(TINY, **over)
    jc, tc = JaxMoE64(**kw), PortMoE64(**kw)
    jp = jax_init(jc, 123)
    tp = tmoe.init_moe_params(tc, seed=123)
    want, got = flat(jp), flat(tp)
    assert want.keys() == got.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    host = jax.tree.map(lambda a: np.asarray(a, np.float64), jp)
    return (jc, jax.tree.map(jnp.asarray, host), tc,
            tgpt.params_from_numpy(host))


def close(got, want, rtol=1e-9, atol=1e-12, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------


def ffn_inputs(B, T, D, E, Fd, seed, gated=False):
    rng = np.random.default_rng(seed)
    shapes = [(B, T, D), (D, E), (E, D, Fd), (E, Fd), (E, Fd, D), (E, D)]
    if gated:
        shapes += [(E, D, Fd), (E, Fd)]
    return [rng.standard_normal(s) * (1.0 if i == 0 else 0.3)
            for i, s in enumerate(shapes)]


def run_ffn(args, cap, top_k, mode, valid=None, ffn="relu", dtype=None):
    """(port out, port aux, jax out, jax aux) of moe_ffn on numpy args."""
    gated = len(args) == 8
    t = [torch.tensor(a) for a in args]
    j = [jnp.asarray(a) for a in args]
    if dtype is not None:
        t = [a.to(dtype) for a in t]
    kw = dict(capacity=cap, top_k=top_k, mode=mode, ffn=ffn)
    to, ta = tmoe.moe_ffn(*t[:6], valid=None if valid is None else
                          torch.tensor(valid), Wg=t[6] if gated else None,
                          bg=t[7] if gated else None, **kw)
    jo, ja = jmoe.moe_ffn(*j[:6], valid=None if valid is None else
                          jnp.asarray(valid), Wg=j[6] if gated else None,
                          bg=j[7] if gated else None, **kw)
    return to, ta, jo, ja


def queue_reference(ids, C, valid=None):
    """{(b, t): [(expert, slot), ...]} of the routing rule in plain
    Python: every first choice queues ahead of any second choice,
    positional order within a level, slots past C dropped, invalid tokens
    not routed."""
    B, T, K = ids.shape
    out = {}
    for b in range(B):
        count = {}
        for lvl in range(K):
            for t in range(T):
                if valid is not None and not valid[b, t]:
                    continue
                e = int(ids[b, t, lvl])
                pos = count.get(e, 0)
                count[e] = pos + 1
                if pos < C:
                    out.setdefault((b, t), []).append((e, pos))
    return out


def slot_pattern(out, E, C):
    """{(b, t): [(expert, slot), ...]} read back from a moe_ffn run whose
    experts return the one-hot code of their (expert, slot)."""
    out = np.asarray(out.detach().float().numpy() if isinstance(
        out, torch.Tensor) else out, np.float64)
    got = {}
    for b, t, j in zip(*np.nonzero(out)):
        got.setdefault((int(b), int(t)), []).append((int(j) // C,
                                                     int(j) % C))
    return {k: sorted(v) for k, v in got.items()}


@pytest.fixture
def slot_code(monkeypatch):
    """Experts whose output at (e, c) is the one-hot of e*C + c: a token's
    output row then names the slots it reached, times its gates."""

    def install(E, C):
        code = np.eye(E * C).reshape(E, C, E * C)
        monkeypatch.setattr(tmoe, "_expert_mlp", lambda xin, *a: (
            torch.tensor(code, dtype=xin.dtype).expand(xin.shape)))
        monkeypatch.setattr(jmoe, "_expert_mlp", lambda xin, *a: (
            jnp.broadcast_to(jnp.asarray(code, xin.dtype), xin.shape)))

    return install


class TestMoEFFN:
    @pytest.mark.parametrize("mode", ["einsum", "gather"])
    @pytest.mark.parametrize("top_k,cap", [(1, 8), (1, 2), (2, 6), (2, 3)])
    @pytest.mark.parametrize("masked", [False, True])
    def test_outputs_and_aux(self, f64, mode, top_k, cap, masked):
        """Outputs and aux against JAX's, rtol 1e-9, relu experts, with
        and without a left-pad ``valid`` mask."""
        args = ffn_inputs(3, 12, 16, 4, 24, seed=top_k * 10 + cap)
        valid = None
        if masked:
            valid = np.arange(12)[None, :] >= np.array([0, 3, 7])[:, None]
        to, ta, jo, ja = run_ffn(args, cap, top_k, mode, valid)
        close(to, jo)
        close(ta, ja)
        if masked:  # pads get a zero output
            assert not to[~torch.tensor(valid)].any()

    @pytest.mark.parametrize("ffn", ["swiglu", "geglu", "gelu"])
    def test_gated_and_gelu_experts(self, f64, ffn):
        args = ffn_inputs(2, 10, 16, 4, 24, seed=3,
                          gated=ffn in ("swiglu", "geglu"))
        for mode in ("einsum", "gather"):
            to, ta, jo, ja = run_ffn(args, 4, 2, mode, ffn=ffn)
            close(to, jo, msg=mode)
            close(ta, ja, msg=mode)

    @pytest.mark.parametrize("mode", ["einsum", "gather"])
    @pytest.mark.parametrize("top_k,cap", [(1, 8), (1, 2), (2, 3)])
    def test_expert_ids_and_slots_exact(self, f64, slot_code, mode, top_k,
                                        cap):
        """Each token reaches the same (expert, slot) pairs in both
        packages, the pairs the plain queue rule gives; over capacity the
        same tokens drop."""
        E = 4
        slot_code(E, cap)
        args = ffn_inputs(2, 16, E * cap, E, 8, seed=cap + 5 * top_k)
        valid = np.arange(16)[None, :] >= np.array([0, 5])[:, None]
        to, _, jo, _ = run_ffn(args, cap, top_k, mode, valid)
        _, ids, _ = tmoe._route(torch.tensor(args[0]),
                                torch.tensor(args[1]), top_k)
        want = {k: sorted(v) for k, v in queue_reference(
            ids.numpy(), cap, valid).items()}
        assert slot_pattern(to, E, cap) == want
        assert slot_pattern(jo, E, cap) == want
        close(to, jo)
        routed = sum(len(v) for v in want.values())
        if cap == 2:  # the small capacity must drop some assignments
            assert routed < top_k * int(valid.sum())

    @pytest.mark.parametrize("top_k", [1, 2])
    def test_ties_go_to_the_lower_expert(self, f64, top_k):
        """Router columns 1 and 2 equal: every tie between them goes to
        expert 1 first, in both packages (``lax.top_k``'s rule, which the
        port keeps by a stable sort)."""
        args = ffn_inputs(2, 12, 16, 4, 24, seed=11)
        args[1][:, 2] = args[1][:, 1]
        args[1][:, 1] += 0.0  # the same values, bit for bit
        x, Wr = (jnp.asarray(a) for a in args[:2])
        probs = jax.nn.softmax((x @ Wr).astype(jnp.float64), axis=-1)
        _, jids = jax.lax.top_k(probs, top_k)
        _, tids, _ = tmoe._route(torch.tensor(args[0]),
                                 torch.tensor(args[1]), top_k)
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
        first = tids[..., 0].numpy()
        assert (first == 1).any() and not (first == 2).any()
        to, ta, jo, ja = run_ffn(args, 6, top_k, "gather")
        close(to, jo)

    @pytest.mark.parametrize("mode", ["einsum", "gather"])
    def test_exact_routing_at_long_T_bf16(self, slot_code, mode):
        """bf16 compute at T 600 past the 256 a bf16 count can hold: the
        slots equal the plain queue rule on the port's own expert ids, and
        (relu experts) the output stays within JAX's bf16 tolerance of the
        float32 routing of the same rounded inputs (its
        ``TestDispatchModes::test_exact_routing_at_long_T_bf16``)."""
        B, T, D, E, Fd, C = 1, 600, 8, 4, 16, 200
        rng = np.random.default_rng(9)  # JAX's ``_rand``
        args = [rng.standard_normal((B, T, D))] + [
            rng.standard_normal(s) * 0.1
            for s in ((D, E), (E, D, Fd), (E, Fd), (E, Fd, D), (E, D))]
        args = [torch.tensor(a, dtype=torch.float32) for a in args]
        xb = args[0].to(torch.bfloat16)
        to, _ = tmoe.moe_ffn(xb, *[a.to(torch.bfloat16) for a in args[1:]],
                             capacity=C, top_k=1, mode=mode)
        t32, _ = tmoe.moe_ffn(xb.float(), *args[1:], capacity=C, top_k=1,
                              mode="einsum")
        np.testing.assert_allclose(to.float().numpy(), t32.numpy(),
                                   atol=0.15)
        # slots past 256: expert 0 favoured by a constant feature, and a
        # capacity of 400 (a bf16 count cannot name slot 257)
        C = 400
        slot_code(E, C)
        code_args = ffn_inputs(B, T, E * C, E, Fd, seed=9)
        code_args[0][..., 0] = 3.0
        code_args[1] *= 0.01
        code_args[1][0, 0] = 0.2
        xb = torch.tensor(code_args[0]).to(torch.bfloat16)
        Wrb = torch.tensor(code_args[1]).to(torch.bfloat16)
        out, _ = tmoe.moe_ffn(xb, Wrb, None, None, None, None, capacity=C,
                              top_k=1, mode=mode)
        _, ids, _ = tmoe._route(xb, Wrb, 1)
        want = {k: sorted(v) for k, v in queue_reference(
            ids.numpy(), C).items()}
        assert max(np.bincount(ids.numpy().ravel())) > 300
        assert slot_pattern(out, E, C) == want

    def test_capacity_copies_jax(self):
        for top_k, T, E, cf in [(1, 32, 4, 1.25), (2, 1, 8, 1.25),
                                (2, 600, 8, 1.0), (1, 7, 3, 2.5)]:
            kw = dict(TINY, n_experts=E, router_top_k=top_k,
                      capacity_factor=cf)
            assert tmoe._capacity(tmoe.MoEGPTConfig(**kw), T) == \
                jmoe._capacity(jmoe.MoEGPTConfig(**kw), T)

    def test_config_validation(self):
        for bad in (dict(router_top_k=3), dict(dispatch="scatter"),
                    dict(n_experts=1, router_top_k=2)):
            with pytest.raises(ValueError) as je:
                jmoe.MoEGPTConfig(**dict(TINY, **bad))
            with pytest.raises(ValueError) as te:
                tmoe.MoEGPTConfig(**dict(TINY, **bad))
            assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# the model: loss, gradients, decode, generation
# ---------------------------------------------------------------------------


MODELS = {
    "relu_top1_einsum": dict(),
    "swiglu_rope_top2_gather": dict(ffn="swiglu", pos="rope",
                                    router_top_k=2, dispatch="gather"),
    "geglu_learned_top2_einsum": dict(ffn="geglu", pos="learned",
                                      router_top_k=2),
}


def ids(seed, B=3, T=TINY["ctx_len"], V=TINY["vocab_size"]):
    rng = np.random.default_rng(seed)
    return rng.integers(0, V, (B, T)), rng.integers(0, V, (B, T))


class TestModel:
    @pytest.mark.parametrize("name", sorted(MODELS))
    def test_loss_and_every_gradient(self, f64, name):
        """``moe_gpt_loss`` and the gradient of every parameter (router,
        experts, gates, attention, embeddings) against
        ``jax.value_and_grad``, rtol 1e-8."""
        jc, jp, tc, tp = cfgs64(**MODELS[name])
        x, y = ids(1)
        jl, jg = jax.value_and_grad(jmoe.moe_gpt_loss)(
            jp, jnp.asarray(x), jnp.asarray(y), jc)
        leaves = toptim.tree_leaves(tp)
        for p in leaves:
            p.requires_grad_(True)
        tl = tmoe.moe_gpt_loss(tp, torch.from_numpy(x), torch.from_numpy(y),
                               tc)
        grads = iter(torch.autograd.grad(tl, leaves))
        got = flat(toptim.tree_map(lambda _: next(grads), tp))
        close(tl, jl, rtol=1e-10)
        want = flat(jg)
        assert want.keys() == got.keys()
        for key in want:
            scale = np.abs(want[key]).max()
            close(got[key], want[key], rtol=1e-8, atol=1e-12 * max(scale, 1),
                  msg=key)
        # the aux term is in the loss
        _, aux = tmoe.moe_gpt_apply(tp, torch.from_numpy(x), tc)
        _, jaux = jmoe.moe_gpt_apply(jp, jnp.asarray(x), jc)
        close(aux, jaux)

    @pytest.mark.parametrize("name", sorted(MODELS))
    def test_prefill_and_decode(self, f64, name):
        """``moe_prefill`` (right-padded to a window, with ``length``),
        ``moe_decode_step`` on forced tokens and ``moe_decode_chunk``
        greedy: logits rtol 1e-9, caches, and tokens equal."""
        jc, jp, tc, tp = cfgs64(**MODELS[name])
        rng = np.random.default_rng(2)
        prompt = rng.integers(0, jc.vocab_size, (1, 9))
        buf = np.zeros((1, 16), np.int64)
        buf[0, :9] = prompt
        jl, jcache = jmoe.moe_prefill(jp, jnp.asarray(buf), jc, 9)
        tl, tcache = tmoe.moe_prefill(tp, torch.from_numpy(buf), tc, 9)
        close(tl, jl)
        close(tcache["k"], jcache["k"])
        assert int(tcache["length"]) == int(jcache["length"]) == 9
        for tok in rng.integers(0, jc.vocab_size, 3):
            jl, jcache = jmoe.moe_decode_step(jp, jcache, jnp.asarray([tok]),
                                              jc)
            tl, tcache = tmoe.moe_decode_step(tp, tcache, torch.tensor([tok]),
                                              tc)
            close(tl, jl)
        jt, jl2, _ = jmoe.moe_decode_chunk(jp, jcache, jl,
                                           jax.random.PRNGKey(0), jc, 8,
                                           1.0, 1)
        tt, tl2, tcache = tmoe.moe_decode_chunk(
            tp, tcache, tl, torch.Generator().manual_seed(0), tc, 8, 1.0, 1)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        close(tl2, jl2)
        assert int(tcache["length"]) == 9 + 3 + 8

    @pytest.mark.parametrize("name", sorted(MODELS))
    def test_batched_prefill_left_pads(self, f64, name):
        """``moe_prefill_batched`` with left pads (kept out of routing by
        ``valid``) against JAX's, and each row against its prompt alone
        prefilled unpadded; then decode steps of the batch."""
        jc, jp, tc, tp = cfgs64(**MODELS[name])
        rng = np.random.default_rng(3)
        W = 12
        lens = [4, 12, 7]
        buf = np.zeros((3, W), np.int64)
        start = np.array([W - n for n in lens], np.int32)
        for b, n in enumerate(lens):
            buf[b, W - n:] = rng.integers(0, jc.vocab_size, n)
        jl, jcache = jmoe.moe_prefill_batched(jp, jnp.asarray(buf),
                                              jnp.asarray(start), jc)
        tl, tcache = tmoe.moe_prefill_batched(tp, torch.from_numpy(buf),
                                              torch.from_numpy(start), tc)
        close(tl, jl)
        forced = rng.integers(0, jc.vocab_size, (3, 3))
        for t in range(3):
            jl, jcache = jmoe.moe_decode_step(jp, jcache,
                                              jnp.asarray(forced[:, t]), jc)
            tl, tcache = tmoe.moe_decode_step(tp, tcache,
                                              torch.from_numpy(forced[:, t]),
                                              tc)
            close(tl, jl)

    @pytest.mark.parametrize("name", ["relu_top1_einsum",
                                      "swiglu_rope_top2_gather"])
    def test_gpt_generate_dispatches_moe(self, f64, name):
        """``gpt_generate`` on an MoE config: greedy tokens equal JAX's."""
        jc, jp, tc, tp = cfgs64(**MODELS[name])
        prompts = [np.array([1, 2, 3]), np.array([4, 5, 6, 7, 8, 9, 10]),
                   np.array([11])]
        jt = jgpt.gpt_generate(jp, jc, prompts, 10, top_k=1)
        tt = tgpt.gpt_generate(tp, tc, prompts, 10, top_k=1)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))

    def test_three_step_training(self, f64):
        """``make_train_step`` (AdamW, warmup-cosine) on an MoE config: a
        3-step trajectory on the same host batches, losses rtol 1e-9 and
        parameters atol 1e-10 (updates of at most the warmup lr)."""
        jc, jp, tc, tp = cfgs64(**MODELS["swiglu_rope_top2_gather"])
        kw = dict(base_lr=3e-4, min_lr=3e-5, warmup=200, max_steps=10,
                  weight_decay=0.01)
        jstep = jtrainer.make_train_step(jc, **kw)
        tstep = ttrainer.make_train_step(tc, **kw)
        from linalg_tpu.train import optim as joptim

        jst, tst = joptim.adamw_init(jp), toptim.adamw_init(tp)
        for step in range(1, 4):
            x, y = ids(10 + step)
            jp, jst, jl = jstep(jp, jst, jnp.asarray(x), jnp.asarray(y), step)
            tp, tst, tl = tstep(tp, tst, torch.from_numpy(x),
                                torch.from_numpy(y), step)
            close(tl, jl)
        want, got = flat(jp), flat(tp)
        for key in want:
            close(got[key], want[key], rtol=0, atol=1e-10, msg=key)
