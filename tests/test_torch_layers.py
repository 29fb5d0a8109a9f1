"""The port's L2 component stack (linalg_tpu_torch/nn/{activations,
normalization,attention,positional,cache}.py, models/{transformer,
gpt_modules,seq2seq}.py, apps/reverse_demo.py) against the JAX package's
classes of the same names.

Same seeds give the same weights (numpy draws rounded to float32, checked
bit-equal); then both sides run in float64: the JAX objects' arrays cast
to float64 and the float32 casts of their backwards redirected to float64
(a proxy for the modules' ``jnp``), the port's modules ``.double()``.
Forward outputs, the gradients ``backward`` returns, every ``grads``
entry and the parameters after one ``step`` agree to rtol 1e-9. The RoPE
caches are float32 in both packages (PyTorch's cos/sin and XLA's differ
by an ulp: rtol 2e-7); the rotation itself is compared on the same
tables. The 5-epoch reversal-task trajectory is float32 in both (rtol
1e-5 on the losses; the parameters as ``test_reverse_demo_trajectory``
says).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linalg_tpu.models.gpt_modules as jgm
import linalg_tpu.models.seq2seq as js2s
import linalg_tpu.models.transformer as jtr
import linalg_tpu.nn.activations as jact
import linalg_tpu.nn.attention as jatt
import linalg_tpu.nn.cache as jcache
import linalg_tpu.nn.functional as jF
import linalg_tpu.nn.normalization as jnorm
import linalg_tpu.nn.positional as jpos
from linalg_tpu.apps import reverse_demo as jdemo
from linalg_tpu.train import optim as joptim
import linalg_tpu_torch.models.gpt_modules as tgm
import linalg_tpu_torch.models.seq2seq as ts2s
import linalg_tpu_torch.models.transformer as ttr
import linalg_tpu_torch.nn.activations as tact
import linalg_tpu_torch.nn.attention as tatt
import linalg_tpu_torch.nn.cache as tcache
import linalg_tpu_torch.nn.functional as tF
import linalg_tpu_torch.nn.normalization as tnorm
import linalg_tpu_torch.nn.positional as tpos
from linalg_tpu_torch.apps import reverse_demo as tdemo
from linalg_tpu_torch.nn.stateful import Stateful

torch.set_num_threads(2)

RTOL = 1e-9


@pytest.fixture
def arm(monkeypatch):
    """``arm()``: the JAX classes cast cotangents to float32; once their
    weights are drawn (in float32) and cast to float64, those casts become
    float64."""
    proxy = types.SimpleNamespace(
        **{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")})
    proxy.float32 = jnp.float64

    def install():
        for mod in (jnorm, jatt, jtr, jpos):
            monkeypatch.setattr(mod, "jnp", proxy)

    return install


def to64(obj, seen=None):
    """Cast every float32 array held by a JAX L2 object (recursively:
    sub-objects, lists, dicts) to float64, in place; returns obj."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return obj
    seen.add(id(obj))

    def conv(v):
        if isinstance(v, jax.Array) and v.dtype == jnp.float32:
            return v.astype(jnp.float64)
        if isinstance(v, list):
            return [conv(x) for x in v]
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if type(v).__module__.startswith("linalg_tpu."):
            return to64(v, seen)
        return v

    for k, v in list(vars(obj).items()):
        setattr(obj, k, conv(v))
    return obj


def jget(obj, path):
    """The JAX object's attribute at a port module/parameter path
    ("encoder.layers.0.mha"): list indices for digits."""
    for part in path.split(".") if path else []:
        obj = obj[int(part)] if part.isdigit() else getattr(obj, part)
    return obj


def np_(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def close(got, want, rtol=RTOL, atol=1e-13, msg=""):
    np.testing.assert_allclose(np_(got), np_(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def jax_grads(jobj):
    """A JAX component's parameter gradients by the port's names."""
    if isinstance(jobj, (jtr.TokenEmbedding, jpos.LearnedPositionalEmbedding)):
        return {"W": jobj.gradW}
    if isinstance(jobj, jtr.OutputHead):
        return {"W": jobj.gradW, "b": jobj.gradb}
    return dict(jobj.grads)


def check_weights_equal(tmod, jobj):
    """Every parameter of the port module equals the JAX object's (the
    same draws), before any cast."""
    for name, p in tmod.named_parameters():
        np.testing.assert_array_equal(np_(p), np.asarray(jget(jobj, name)),
                                      err_msg=name)


def check_grads_and_step(tmod, jobj, lr=0.05, wd=0.01):
    """Every ``grads`` entry of every stateful component, then one
    ``step`` and every parameter."""
    n = 0
    for path, sub in tmod.named_modules():
        if isinstance(sub, Stateful):
            want = jax_grads(jget(jobj, path))
            got = sub.grads
            assert want.keys() == got.keys(), path
            for k in want:
                close(got[k], want[k], msg=f"{path}.{k}")
                n += 1
    assert n
    tmod.step(lr, wd)
    jobj.step(lr, wd)
    for name, p in tmod.named_parameters():
        close(p, jget(jobj, name), msg=name)


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape)


# ---------------------------------------------------------------------------
# functional pieces
# ---------------------------------------------------------------------------


def test_he_init_and_mha_init_bit_equal():
    a = tF.he_init(7, 5, np.random.default_rng(3))
    b = jF.he_init(7, 5, np.random.default_rng(3))
    assert a.dtype == torch.float32
    np.testing.assert_array_equal(np_(a), np.asarray(b))
    ta, ja = tatt.mha_init(16, 4, seed=2), jatt.mha_init(16, 4, seed=2)
    for k in ja:
        np.testing.assert_array_equal(np_(ta[k]), np.asarray(ja[k]))


@pytest.mark.parametrize("name", ["relu", "gelu", "silu", "swiglu",
                                  "geglu"])
def test_activations_and_their_backwards(name):
    fj, bj = jact.get_activation(name)
    ft, bt = tact.get_activation(name)
    a, g = rand(0, 4, 6), rand(1, 4, 6)
    gated = name in tact.GATED_ACTIVATIONS
    ta, tg = torch.tensor(a), torch.tensor(g)
    if gated:
        close(ft(ta, tg), fj(a, g))
        for x, y in zip(bt(ta, tg), bj(a, g)):
            close(x, y)
    else:
        close(ft(ta), fj(a))
        close(bt(ta), bj(a))
    assert set(tact.ACTIVATIONS) == set(jact.ACTIVATIONS)
    assert set(tact.GATED_ACTIVATIONS) == set(jact.GATED_ACTIVATIONS)
    with pytest.raises(KeyError):
        tact.get_activation("tanh")


# ---------------------------------------------------------------------------
# normalization, attention, positional
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_norms(kind, arm):
    t, j = tnorm.get_norm(kind, 8), jnorm.get_norm(kind, 8)
    check_weights_equal(t, j)
    t.double()
    to64(j)
    arm()
    x, dy = rand(0, 2, 3, 8), rand(1, 2, 3, 8)
    # a non-trivial gamma (and beta): one SGD step first
    for mod in (t, j):
        mod.forward(x)
        mod.backward(dy)
        mod.step(0.1, 0.0)
    close(t.forward(x), j.forward(x))
    close(t.backward(dy), j.backward(dy))
    check_grads_and_step(t, j)
    close(t.functional(t.init(), torch.tensor(x)), j(j.init(), x))
    with pytest.raises(KeyError):
        tnorm.get_norm("batchnorm", 8)


@pytest.mark.parametrize("masked", [False, True])
def test_scaled_dot_product_attention(masked):
    Q, K, V, dO = (rand(i, 6, 5, 4) for i in range(4))
    mask = np.asarray(jF.causal_mask(5)) if masked else None
    to, tc = tatt.Attention().forward(*(torch.tensor(a) for a in (Q, K, V)),
                                      None if mask is None else
                                      torch.tensor(mask))
    jo, jc = jatt.Attention().forward(Q, K, V, mask)
    close(to, jo)
    for a, b in zip(tatt.Attention().backward(torch.tensor(dO), tc),
                    jatt.Attention().backward(dO, jc)):
        close(a, b)


@pytest.mark.parametrize("cross", [False, True])
def test_multi_head_attention(cross, arm):
    """Self-attention with a causal mask, and cross-attention (keys and
    values from a memory of another length), whose backward returns
    dKV."""
    t, j = tatt.MHA(16, 4, seed=5), jatt.MHA(16, 4, seed=5)
    check_weights_equal(t, j)
    t.double()
    to64(j)
    arm()
    X, dY = rand(0, 2, 6, 16), rand(1, 2, 6, 16)
    KV = rand(2, 2, 9, 16) if cross else None
    mask = None if cross else np.asarray(jF.causal_mask(6))
    close(t.forward(torch.tensor(X), mask=None if mask is None else
                    torch.tensor(mask), KV=None if KV is None else
                    torch.tensor(KV)), j.forward(X, mask=mask, KV=KV))
    (tdx, tdkv), (jdx, jdkv) = t.backward(torch.tensor(dY)), j.backward(dY)
    close(tdx, jdx)
    if cross:
        close(tdkv, jdkv)
    else:
        assert tdkv is None and jdkv is None
    check_grads_and_step(t, j)
    H = tatt.MHA.split_heads(torch.tensor(X), 4)
    close(H, jatt.MHA.split_heads(X, 4))
    close(tatt.MHA.combine_heads(H), X)


def test_mha_apply_takes_an_attention_kernel():
    p = {k: v.double() for k, v in tatt.mha_init(16, 2, seed=1).items()}
    X = torch.tensor(rand(0, 2, 5, 16))
    calls = []

    def spy(q, k, v, mask):
        calls.append(q.shape)
        return tF.sdpa(q, k, v, mask)

    close(tatt.mha_apply(p, X, n_heads=2, attn_fn=spy),
          jatt.mha_apply({k: np_(v) for k, v in p.items()}, np_(X),
                         n_heads=2))
    assert calls == [(2, 2, 5, 8)]


def test_learned_positional_embedding(arm):
    t = tpos.get_positional_encoding("learned", 12, 8, seed=3)
    j = jpos.get_positional_encoding("learned", 12, 8, seed=3)
    check_weights_equal(t, j)
    t.double()
    to64(j)
    arm()
    close(t.forward(7), j.forward(7))
    for dpe in (rand(0, 3, 7, 8), rand(1, 7, 8)):  # accumulates
        t.backward(torch.tensor(dpe))
        j.backward(dpe)
    close(t.gradW, j.gradW)
    t.step(0.1, 0.01)
    j.step(0.1, 0.01)
    close(t.W, j.W)
    assert not t.gradW.any()


def test_rotary_and_sinusoidal():
    t = tpos.get_positional_encoding("rope", 64, 8)
    j = jpos.get_positional_encoding("rope", 64, 8)
    for a, b in zip(t.tables(5, offset=9), j.tables(5, offset=9)):
        close(a, b, rtol=2e-7, atol=2e-7)
    # the rotation on the same tables
    j_tabs = j.tables(5, offset=9)
    t._cos_cache[9:14] = torch.tensor(np.asarray(j_tabs[0]))
    t._sin_cache[9:14] = torch.tensor(np.asarray(j_tabs[1]))
    q, k = rand(0, 2, 3, 5, 8), rand(1, 2, 3, 5, 8)
    for a, b in zip(t.forward(torch.tensor(q), torch.tensor(k), offset=9),
                    j.forward(q, k, offset=9)):
        close(a, b)
    close(tpos.get_positional_encoding("sinusoidal", 16, 8),
          jpos.get_positional_encoding("sinusoidal", 16, 8), rtol=2e-7,
          atol=2e-7)
    with pytest.raises(KeyError):
        tpos.get_positional_encoding("alibi", 16, 8)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def test_object_caches():
    """Updates return the live prefix, overflow raises, reset zeroes; the
    layered cache shares its length; ``fkv_update`` writes one layer."""
    t = tcache.LayerKVCache(2, 1, 2, 6, 4, dtype=torch.float64)
    j = jcache.LayerKVCache(2, 1, 2, 6, 4, dtype=jnp.float64)
    for step, n in enumerate((3, 2)):
        k, v = rand(step, 1, 2, n, 4), rand(step + 9, 1, 2, n, 4)
        for layer in range(2):
            got = t[layer].update(torch.tensor(k), torch.tensor(v))
            want = j[layer].update(k, v)
            for a, b in zip(got, want):
                close(a, b, rtol=0, atol=0)
    assert t.seq_len == j.seq_len == 5
    with pytest.raises(ValueError, match="overflow") as te:
        t[0].update(torch.zeros(1, 2, 2, 4, dtype=torch.float64),
                    torch.zeros(1, 2, 2, 4, dtype=torch.float64))
    with pytest.raises(ValueError) as je:
        j[0].update(np.zeros((1, 2, 2, 4)), np.zeros((1, 2, 2, 4)))
    assert str(te.value) == str(je.value)
    t.reset()
    j.reset()
    assert t[1].is_empty and j[1].is_empty
    assert not t[1].k_cache.any()
    kk = torch.ones(1, 2, 1, 4)
    assert tcache.apply_kv_cache(kk, kk, None)[0] is kk
    tc = tcache.fkv_init(2, 1, 2, 6, 4)
    jc = jcache.fkv_init(2, 1, 2, 6, 4)
    tc["length"] = torch.tensor(2, dtype=torch.int32)
    jc = dict(jc, length=jnp.int32(2))
    k = rand(3, 1, 2, 2, 4).astype(np.float32)
    tc, tk, tv = tcache.fkv_update(tc, 1, torch.tensor(k), torch.tensor(k))
    jc, jk, jv = jcache.fkv_update(jc, 1, k, k)
    close(tk, jk, rtol=0, atol=0)
    close(tc["k"], jc["k"], rtol=0, atol=0)
    assert int(tcache.fkv_advance(tc, 2)["length"]) == 4


# ---------------------------------------------------------------------------
# the transformer stack
# ---------------------------------------------------------------------------


def run_both(tmod, jobj, fwd_args, dy):
    """Forward both (numpy args; the port gets float64 tensors), then
    backward with ``dy``; returns (port outs, jax outs, port grads, jax
    grads) as tuples."""
    targs = [None if a is None else torch.tensor(a) for a in fwd_args]
    tout, jout = tmod.forward(*targs), jobj.forward(*fwd_args)
    tg, jg = tmod.backward(torch.tensor(dy)), jobj.backward(dy)
    as_tuple = lambda x: x if isinstance(x, tuple) else (x,)  # noqa: E731
    return as_tuple(tout), as_tuple(jout), as_tuple(tg), as_tuple(jg)


LAYERS = {
    "ffn": (lambda m: m.FFN(16, 24, seed=3), lambda r: [r(0, 2, 5, 16)]),
    "encoder_layer": (lambda m: m.EncoderLayer(16, 4, 24, seed=1),
                      lambda r: [r(0, 2, 5, 16), None]),
    "decoder_layer": (lambda m: m.DecoderLayer(16, 4, 24, seed=2),
                      lambda r: [r(0, 2, 5, 16), r(1, 2, 7, 16),
                                 np.asarray(jF.causal_mask(5)), None]),
    "encoder": (lambda m: m.Encoder(2, 16, 4, 24, seed=4),
                lambda r: [r(0, 2, 5, 16), None]),
    "decoder": (lambda m: m.Decoder(2, 16, 4, 24, seed=5),
                lambda r: [r(0, 2, 5, 16), r(1, 2, 7, 16),
                           np.asarray(jF.causal_mask(5)), None]),
    "transformer": (lambda m: m.Transformer(2, 2, 16, 4, 24, seed=6),
                    lambda r: [r(0, 2, 7, 16), r(1, 2, 5, 16), None,
                               np.asarray(jF.causal_mask(5)), None]),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_transformer_stack(name, arm):
    """Forward, the gradients backward returns (the decoder's dMemory
    summed over its layers, the transformer's (dsrc, dtgt)), every grads
    entry and one step."""
    make, args = LAYERS[name]
    t, j = make(ttr), make(jtr)
    check_weights_equal(t, j)
    t.double()
    to64(j)
    arm()
    fwd = args(rand)
    T = fwd[1].shape[1] if name == "transformer" else fwd[0].shape[1]
    dy = rand(9, 2, T, 16)
    tout, jout, tg, jg = run_both(t, j, fwd, dy)
    for a, b in zip(tout, jout):
        close(a, b)
    assert len(tg) == len(jg)
    for a, b in zip(tg, jg):
        close(a, b)
    check_grads_and_step(t, j)


def test_token_embedding_and_output_head(arm):
    """Embedding lookup and its scatter-add backward (repeated ids), the
    head's fused CE (loss, dZ = (P - onehot) / N), its backward and step."""
    te, je = ttr.TokenEmbedding(11, 8, seed=2), jtr.TokenEmbedding(11, 8,
                                                                   seed=2)
    th, jh = ttr.OutputHead(8, 11, seed=3), jtr.OutputHead(8, 11, seed=3)
    for t, j in ((te, je), (th, jh)):
        check_weights_equal(t, j)
        t.double()
        to64(j)
        arm()
    idx = np.array([[1, 3, 3, 0], [10, 1, 1, 1]])
    y = np.array([[2, 2, 5, 0], [9, 1, 0, 4]])
    X = te.forward(torch.tensor(idx))
    close(X, je.forward(idx))
    Z = th.logits(X)
    close(Z, jh.logits(je.forward(idx)))
    tl, tdz = th.loss_and_dlogits(Z, torch.tensor(y))
    jl, jdz = jh.loss_and_dlogits(np_(Z), y)
    assert abs(tl - jl) <= RTOL * abs(jl)
    close(tdz, jdz)
    tdx, jdx = th.backward(tdz), jh.backward(jdz)
    close(tdx, jdx)
    te.backward(tdx)
    je.backward(jdx)
    check_grads_and_step(th, jh)
    check_grads_and_step(te, je)


def test_gpt_modules_and_param_group_adamw(arm):
    """``GPT`` (a stack of ``DecoderOnlyLayer``s): forward with a causal
    mask, backward, every grads entry, step; then ``AdamW`` over param
    groups, three steps, keyed by group order."""
    t, j = tgm.GPT(2, 16, 4, seed=7), jgm.GPT(2, 16, 4, seed=7)
    check_weights_equal(t, j)
    t.double()
    to64(j)
    arm()
    X, dy = rand(0, 2, 6, 16), rand(1, 2, 6, 16)
    mask = np.asarray(jF.causal_mask(6))
    close(t.forward(torch.tensor(X), torch.tensor(mask)), j.forward(X, mask))
    close(t.backward(torch.tensor(dy)), j.backward(dy))
    check_grads_and_step(t, j, lr=3e-3, wd=1e-4)
    topt, jopt = tgm.AdamW(lr=1e-2), jgm.AdamW(lr=1e-2)
    ps = [rand(i, 4, 3) for i in range(2)]
    tps, jps = [torch.tensor(p) for p in ps], [jnp.asarray(p) for p in ps]
    for step in range(3):
        gs = [rand(10 + step + i, 4, 3) for i in range(2)]
        groups = [dict(weight_decay=0.0), dict()]
        tps = topt.step([dict(g, p=p, g=torch.tensor(gr))
                         for g, p, gr in zip(groups, tps, gs)])
        jps = jopt.step([dict(g, p=p, g=gr)
                         for g, p, gr in zip(groups, jps, gs)])
    for a, b in zip(tps, jps):
        close(a, b)


# ---------------------------------------------------------------------------
# seq2seq and the reversal demo
# ---------------------------------------------------------------------------


S2S = dict(vocab_size=12, d_model=16, n_heads=2, n_enc_layers=2,
           n_dec_layers=2, d_ff=32, max_len=16)


def flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np_(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_seq2seq_loss_and_gradients(monkeypatch):
    """``init_seq2seq_params`` bit-equal; ``seq2seq_loss`` and the gradient
    of every parameter in float64 (the port handed the JAX package's
    float32 sinusoidal table) to rtol 1e-9; ``make_reverse_batch`` draws
    the same batches."""
    tcfg, jcfg = ts2s.Seq2SeqConfig(**S2S), js2s.Seq2SeqConfig(**S2S)
    tp = ts2s.init_seq2seq_params(tcfg, seed=4)
    jp = js2s.init_seq2seq_params(jcfg, seed=4)
    want = flat(jp)
    assert want.keys() == flat(tp).keys()
    for key, val in flat(tp).items():
        np.testing.assert_array_equal(val, want[key], err_msg=key)
    monkeypatch.setattr(ts2s, "sinusoidal_encoding", lambda n, d, device: (
        torch.tensor(np.asarray(jF.sinusoidal_encoding(n, d)))))
    batches = [fn(3, 7, 12, rng=np.random.default_rng(5))
               for fn in (ts2s.make_reverse_batch, js2s.make_reverse_batch)]
    for a, b in zip(*batches):
        np.testing.assert_array_equal(a, b)
    src, tin, tout = batches[0]
    jp64 = jax.tree.map(lambda a: a.astype(jnp.float64), jp)
    jl, jg = jax.jit(jax.value_and_grad(js2s.seq2seq_loss),
                     static_argnums=4)(jp64, src, tin, tout, jcfg)
    tp64 = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), jp64)
    leaves = jax.tree_util.tree_leaves(tp64)
    for p in leaves:
        p.requires_grad_(True)
    tl = ts2s.seq2seq_loss(tp64, src, tin, tout, tcfg)
    grads = torch.autograd.grad(tl, leaves)
    close(tl, jl)
    for (path, want_g), got_g in zip(
            jax.tree_util.tree_flatten_with_path(jg)[0], grads):
        close(got_g, want_g, atol=1e-12, msg=str(path))
    for p in leaves:
        p.requires_grad_(False)
    np.testing.assert_array_equal(
        tdemo.greedy_decode(tp64, tcfg, src),
        np.asarray(jdemo.greedy_decode(jp64, jcfg, src)))


def test_reverse_demo_trajectory(capsys):
    """Five epochs of ``train_reverse_demo`` in float32 on the numpy
    stream both packages draw, against the JAX package's step (the loss
    and AdamW of its ``train_reverse_demo``, jitted, on the same batches):
    every epoch's loss rtol 1e-5, the printed epoch lines, the final
    parameters."""
    losses = []
    tp, tcfg, _ = tdemo.train_reverse_demo(epochs=5, B=8, device="cpu",
                                           losses=losses)
    tsaid = capsys.readouterr().out
    jcfg = js2s.Seq2SeqConfig(vocab_size=12, d_model=64, n_heads=4,
                              n_enc_layers=2, n_dec_layers=2, d_ff=256,
                              max_len=16)
    jp = js2s.init_seq2seq_params(jcfg, seed=0)
    state = joptim.adamw_init(jp)
    wd = jax.tree.map(lambda _: 0.0, jp)

    @jax.jit
    def step(params, state, src, tgt_in, tgt_out):
        loss, g = jax.value_and_grad(js2s.seq2seq_loss)(
            params, src, tgt_in, tgt_out, jcfg)
        return (*joptim.adamw_update(params, g, state, 3e-4, wd), loss)

    rng = np.random.default_rng(0)
    want = []
    for _ in range(5):
        jp, state, loss = step(jp, state,
                               *js2s.make_reverse_batch(8, 10, 12, rng=rng))
        want.append(float(loss))
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    lines = [ln.split("  token-acc")[0] for ln in tsaid.splitlines()
             if ln.startswith("epoch")]
    assert lines == [f"epoch {ep:4d}  loss {want[ep]:.4f}" for ep in (0, 4)]
    # Adam moves a parameter by up to lr a step whatever its gradient's
    # size, so a float32 gradient near zero whose sign the two packages'
    # sums round apart moves it the other way: at most 2 * 5 * lr after
    # five steps, and only on a few entries
    got, want_p = flat(tp), flat(jp)
    for key in want_p:
        diff = np.abs(got[key] - want_p[key])
        assert diff.max() <= 2 * 5 * 3e-4, key
        assert np.mean(diff > 1e-6 + 1e-4 * np.abs(want_p[key])) < 1e-3, key
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


@pytest.mark.cuda
def test_transformer_on_the_card_matches_the_cpu():
    """A Transformer's forward and backward on the card against the same
    module on the CPU, float32 with TF32 off, to 1e-5 of max|.|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = ttr.Transformer(2, 2, 64, 4, 256, seed=0)
    gpu = ttr.Transformer(2, 2, 64, 4, 256, seed=0).to("cuda")
    src, tgt, dy = (torch.tensor(rand(i, 4, 10, 64), dtype=torch.float32)
                    for i in range(3))
    mask = tF.causal_mask(10)
    outs = [m.forward(s, t, None, mk, None) for m, s, t, mk in (
        (cpu, src, tgt, mask), (gpu, src.cuda(), tgt.cuda(), mask.cuda()))]
    grads = [cpu.backward(dy), gpu.backward(dy.cuda())]
    for a, b in zip(outs[0] + grads[0], outs[1] + grads[1]):
        assert float((a - b.cpu()).abs().max()) <= 1e-5 * float(
            a.abs().max())
