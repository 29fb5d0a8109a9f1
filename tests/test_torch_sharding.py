"""The port's mesh collectives and dp x tp training
(linalg_tpu_torch/parallel/{mesh,sharding}.py) against the JAX package's
``parallel/sharding.py``, on the CPU.

The JAX side runs its jitted functions with their shardings on (dp, tp)
meshes of the conftest's 8 virtual devices; the port's ranks share the
CPU. Both run in float64 (x64 on; ``torch_parallel_common.f64`` keeps the
float32 logit casts out): the loss and every gradient leaf agree within
1e-9 relative. Inputs come from numpy seeds; the same host batches go to
both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from linalg_tpu.models import gpt as jgpt
from linalg_tpu.parallel import sharding as jsh
from linalg_tpu.train import checkpoint as jckpt
from linalg_tpu.train.optim import adamw_init as jadamw_init
from linalg_tpu_torch.models import gpt as tgpt
from linalg_tpu_torch.parallel import mesh as tmesh_mod
from linalg_tpu_torch.parallel import sharding as tsh
from linalg_tpu_torch.parallel import (all_gather, all_reduce, all_to_all,
                                       collectives, gpt_param_specs,
                                       make_sharded_attn,
                                       make_sharded_device_train_step,
                                       make_sharded_train_step, ppermute,
                                       reduce_scatter, shard_tree,
                                       unshard_tree)
from linalg_tpu_torch.train import checkpoint as tckpt
from linalg_tpu_torch.train import optim as toptim
from linalg_tpu_torch.train.trainer import make_device_train_step
from torch_parallel_common import (assert_trees_close, both64, f64,  # noqa
                                   flat, ids, jmesh, port_grads, tmesh)

torch.set_num_threads(2)

TINY = dict(vocab_size=19, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            ctx_len=16)
# name: (mesh shape (dp, tp), config overrides)
CASES = {
    "relu_dp2_tp4": ((2, 4), {}),
    "rope_swiglu_gqa_dp2_tp2": ((2, 2), dict(pos="rope", ffn="swiglu",
                                             n_kv_heads=2)),
    "alibi_window_tp4": ((1, 4), dict(pos="alibi", window=6)),
    "learned_window_dp4_tp2": ((4, 2), dict(pos="learned", window=6)),
}


# -- the collectives ---------------------------------------------------------


def _vals(n, shape=(4, 6), seed=0):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(shape), requires_grad=True)
            for _ in range(n)]


def _cots(n, shape, seed=1):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(shape)) for _ in range(n)]


def _backward(outs, cots, xs):
    return torch.autograd.grad(
        sum(torch.sum(o * c) for o, c in zip(outs, cots)), xs)


class TestCollectives:
    """Each collective over the (2, 4) mesh's 'tp' groups against its
    definition, forward and backward (the adjoint collective), and its
    calls counted by kind."""

    MESH = ((2, 4), ("dp", "tp"))

    def test_all_reduce_sum_and_mean(self):
        mesh = tmesh(*self.MESH)
        xs = _vals(8)
        collectives.clear()
        for op, scale in (("sum", 1.0), ("mean", 0.25)):
            outs = all_reduce(xs, mesh, "tp", op)
            for r, o in enumerate(outs):
                g = r // 4
                want = sum(xs[4 * g + i] for i in range(4)) * scale
                torch.testing.assert_close(o, want, rtol=0, atol=1e-15)
            cots = _cots(8, (4, 6))
            got = _backward(outs, cots, xs)
            for r, gr in enumerate(got):
                g = r // 4
                want = sum(cots[4 * g + i] for i in range(4)) * scale
                torch.testing.assert_close(gr, want, rtol=0, atol=1e-15)
        # 2 ops x 2 groups, forward and backward
        assert collectives["all_reduce"] == 8

    def test_all_gather_and_reduce_scatter_are_adjoint(self):
        mesh = tmesh(*self.MESH)
        xs = _vals(8)
        collectives.clear()
        outs = all_gather(xs, mesh, "tp", dim=1)
        for r, o in enumerate(outs):
            g = r // 4
            assert torch.equal(o, torch.cat(xs[4 * g:4 * g + 4], dim=1))
        cots = _cots(8, (4, 24))
        got = _backward(outs, cots, xs)
        for r, gr in enumerate(got):
            g, i = divmod(r, 4)
            want = sum(cots[4 * g + j] for j in range(4))[:, 6 * i:6 * i + 6]
            torch.testing.assert_close(gr, want, rtol=0, atol=1e-15)
        assert (collectives["all_gather"], collectives["reduce_scatter"]) == (
            2, 2)
        xs = _vals(8, shape=(4, 8))
        outs = reduce_scatter(xs, mesh, "tp", dim=1, op="mean")
        for r, o in enumerate(outs):
            g, i = divmod(r, 4)
            want = sum(xs[4 * g + j] for j in range(4)) / 4
            torch.testing.assert_close(o, want[:, 2 * i:2 * i + 2], rtol=0,
                                       atol=1e-15)
        cots = _cots(8, (4, 2))
        got = _backward(outs, cots, xs)
        for r, gr in enumerate(got):
            g = r // 4
            want = torch.cat(cots[4 * g:4 * g + 4], dim=1) / 4
            torch.testing.assert_close(gr, want, rtol=0, atol=1e-15)

    def test_all_to_all_and_its_adjoint(self):
        mesh = tmesh(*self.MESH)
        xs = _vals(8, shape=(8, 3))
        outs = all_to_all(xs, mesh, "tp", split_dim=0, concat_dim=1)
        for r, o in enumerate(outs):
            g, i = divmod(r, 4)
            want = torch.cat([xs[4 * g + j][2 * i:2 * i + 2]
                              for j in range(4)], dim=1)
            assert torch.equal(o, want)
        cots = _cots(8, (2, 12))
        got = _backward(outs, cots, xs)
        for r, gr in enumerate(got):
            g, j = divmod(r, 4)
            want = torch.cat([cots[4 * g + i][:, 3 * j:3 * j + 3]
                              for i in range(4)], dim=0)
            assert torch.equal(gr, want)

    def test_ppermute_and_its_inverse(self):
        mesh = tmesh(*self.MESH)
        xs = _vals(8)
        up = [(i, i + 1) for i in range(3)]
        collectives.clear()
        outs = ppermute(xs, mesh, "tp", up)
        for r, o in enumerate(outs):
            if r % 4 == 0:
                assert o is None
            else:
                assert torch.equal(o, xs[r - 1])
        live = [(o, c) for o, c in zip(outs, _cots(8, (4, 6)))
                if o is not None]
        got = torch.autograd.grad(sum(torch.sum(o * c) for o, c in live),
                                  xs, allow_unused=True)
        cots = dict(zip([r for r in range(8) if r % 4], [c for _, c in live]))
        for r, gr in enumerate(got):
            if r % 4 == 3:  # its value went nowhere
                assert gr is None or not torch.any(gr)
            else:
                assert torch.equal(gr, cots[r + 1])
        assert collectives["ppermute"] == 4  # 2 groups, fwd and bwd

    def test_shared_device_results_are_one_tensor(self):
        """Ranks on one device share the group's result: one sum, no
        copy per rank."""
        mesh = tmesh(*self.MESH)
        xs = [x.detach() for x in _vals(8)]
        outs = all_reduce(xs, mesh, "tp")
        assert outs[0].data_ptr() == outs[3].data_ptr()
        assert outs[0].data_ptr() != outs[4].data_ptr()

    def test_groups_of_one_pass_through_uncounted(self):
        mesh = tmesh((1, 4), ("dp", "tp"))
        xs = _vals(4)
        collectives.clear()
        assert all_reduce(xs, mesh, "dp") == xs
        assert not collectives

    def test_shard_unshard_round_trip(self):
        cfg = tgpt.GPTConfig(**TINY, ffn="swiglu", pos="learned")
        params = tgpt.init_gpt_params(cfg, seed=0)
        specs = gpt_param_specs(None, cfg)
        mesh = tmesh((2, 4), ("dp", "tp"))
        ranks = shard_tree(params, specs, mesh)
        assert ranks[1]["layers"]["Wq"].shape == (2, 32, 8)
        assert ranks[1]["layers"]["Wo"].shape == (2, 8, 32)
        # every rank's replicated leaf is a copy of its own
        assert ranks[0]["tok_W"].data_ptr() != ranks[1]["tok_W"].data_ptr()
        back = unshard_tree(ranks, specs, mesh)
        for k, v in flat(params).items():
            np.testing.assert_array_equal(flat(back)[k], v, err_msg=k)


# -- dp x tp against the JAX package ----------------------------------------


@pytest.mark.parametrize("kw", [{}, dict(ffn="swiglu"), dict(pos="learned")],
                         ids=["relu", "swiglu", "learned"])
def test_param_specs_match_jax(kw):
    jc = jgpt.GPTConfig(**TINY, **kw)
    tc = tgpt.GPTConfig(**TINY, **kw)
    want = jsh.gpt_param_specs(None, jc)
    got = gpt_param_specs(None, tc)
    wf = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda v: isinstance(v, P))[0]
    assert {jax.tree_util.keystr(p): tuple(s) for p, s in wf} == {
        jax.tree_util.keystr(p): s for p, s in
        jax.tree_util.tree_flatten_with_path(
            got, is_leaf=lambda v: isinstance(v, tuple))[0]}


@pytest.mark.parametrize("kw", [{}, dict(pos="alibi"), dict(window=5),
                                dict(pos="alibi", window=5)],
                         ids=["causal", "alibi", "window", "alibi_window"])
def test_sharded_attn_matches_jax(kw, f64):
    """``make_sharded_attn`` over global (B, H, T, d) blocks of a (2, 4)
    mesh: each rank's ALiBi slope slice and window band as JAX's, the
    output and the q/k/v gradients."""
    jc, _, tc, _ = both64(**TINY, **kw)
    rng = np.random.default_rng(3)
    q, k, v, cot = (rng.standard_normal((4, 4, 16, 8)) for _ in range(4))
    jfa = jsh.make_sharded_attn(jmesh((2, 4), ("dp", "tp")), 16, 8, cfg=jc)
    jout, vjp = jax.vjp(lambda *a: jfa(*a, None),
                        *map(jnp.asarray, (q, k, v)))
    jg = vjp(jnp.asarray(cot))
    tfa = make_sharded_attn(tmesh((2, 4), ("dp", "tp")), 16, 8, cfg=tc)
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    tout = tfa(*ts)
    tg = torch.autograd.grad(tout, ts, torch.tensor(cot))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=1e-10, atol=1e-13)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-13)


def _jax_grads(jc, jp, x, y, shape):
    mesh = jmesh(shape, ("dp", "tp"))
    attn = jsh.make_sharded_attn(mesh, jc.ctx_len, jc.d_head, cfg=jc)
    param_sh = jsh._shardings(mesh, jsh.gpt_param_specs(None, jc))
    batch_sh = NamedSharding(mesh, P("dp", None))
    fn = jax.jit(jax.value_and_grad(
        lambda p, xx, yy: jgpt.gpt_loss(p, xx, yy, jc, attn_fn=attn)),
        in_shardings=(param_sh, batch_sh, batch_sh))
    loss, grads = fn(jp, jnp.asarray(x), jnp.asarray(y))
    return float(loss), grads


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_and_every_gradient_match_jax(name, f64):
    """The dp x tp loss and every gradient leaf (gathered from the ranks'
    shards, copies summed) against JAX's ``gpt_loss`` jitted with the
    dp x tp shardings and ``make_sharded_attn``: rel 1e-9."""
    shape, kw = CASES[name]
    jc, jp, tc, tp = both64(**TINY, **kw)
    x, y = ids(0, 8, 16, 19)
    jl, jg = _jax_grads(jc, jp, x, y, shape)
    mesh = tmesh(shape, ("dp", "tp"))
    specs = gpt_param_specs(None, tc)
    attn = make_sharded_attn(mesh, 16, tc.d_head, cfg=tc)
    fn = tsh._loss_and_grads(tsh._tp_loss(tc, mesh, attn), specs, mesh)
    tl, tg = port_grads(fn, shard_tree(tp, specs, mesh), x, y, specs, mesh)
    np.testing.assert_allclose(tl, jl, rtol=1e-9)
    assert_trees_close(tg, jg)


def test_steps_match_make_sharded_train_step(f64):
    """Three steps of ``make_sharded_train_step`` on a (2, 4) mesh: the
    losses and the parameters after them, gathered, as JAX's."""
    jc, jp, tc, tp = both64(**TINY)
    batches = [ids(s, 8, 16, 19) for s in range(3)]
    jstep = jsh.make_sharded_train_step(jc, jmesh((2, 4), ("dp", "tp")),
                                        lr=1e-2, weight_decay=0.01)
    jo = jadamw_init(jp)
    jl = []
    for x, y in batches:
        jp, jo, loss = jstep(jp, jo, jnp.asarray(x), jnp.asarray(y))
        jl.append(float(loss))
    mesh = tmesh((2, 4), ("dp", "tp"))
    specs = gpt_param_specs(None, tc)
    rp = shard_tree(tp, specs, mesh)
    ro = [toptim.adamw_init(p) for p in rp]
    step = make_sharded_train_step(tc, mesh, lr=1e-2, weight_decay=0.01)
    tl = []
    for x, y in batches:
        rp, ro, loss = step(rp, ro, torch.as_tensor(x).long(),
                            torch.as_tensor(y).long())
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-9)
    assert_trees_close(unshard_tree(rp, specs, mesh), jp)


def _device_steps(cfg, params, mesh, n, clip, wd=0.01, B=8):
    data = torch.as_tensor(np.random.default_rng(5).integers(0, 19, 2048))
    kw = dict(base_lr=1e-2, min_lr=1e-3, warmup=2, max_steps=10,
              weight_decay=wd, clip_norm=clip)
    gen = torch.Generator().manual_seed(0)
    losses = []
    if mesh is None:
        step = make_device_train_step(cfg, B, **kw)
        opt = toptim.adamw_init(params)
        for _ in range(n):
            params, opt, gen, loss = step(params, opt, data, gen)
            losses.append(float(loss))
        return params, losses
    specs = gpt_param_specs(None, cfg)
    rp = shard_tree(params, specs, mesh)
    ro = [toptim.adamw_init(p) for p in rp]
    step = make_sharded_device_train_step(cfg, mesh, B, **kw)
    for _ in range(n):
        rp, ro, gen, loss = step(rp, ro, data, gen)
        losses.append(float(loss))
    return rp, losses


def test_clipped_dp_step_matches_unsharded(f64):
    """The clip reaches the sharded step through the global norm (each
    shard once, each replicated leaf once): two clipped dp x tp steps
    equal two clipped single-device steps drawing the same windows (the
    JAX package's tests/test_parallel.py:510-530, here with tp too)."""
    _, _, tc, tp = both64(**TINY)
    mesh = tmesh((2, 2), ("dp", "tp"))
    one, l1 = _device_steps(tc, toptim.tree_map(torch.clone, tp), None, 2,
                            0.25)
    rp, ls = _device_steps(tc, tp, mesh, 2, 0.25)
    np.testing.assert_allclose(ls, l1, rtol=1e-9)
    assert_trees_close(unshard_tree(rp, gpt_param_specs(None, tc), mesh),
                       one)
    # the clip was active: unclipped steps end elsewhere
    free, _ = _device_steps(tc, toptim.tree_map(torch.clone, tp), None, 2,
                            0.0)
    assert not np.allclose(flat(free)["layers/Wq"], flat(one)["layers/Wq"])


def test_replicated_copies_stay_equal_after_three_steps():
    """Every rank's copy of a replicated leaf (and every dp copy of a tp
    shard) is bit-equal to the others after 3 clipped, decayed steps."""
    cfg = tgpt.GPTConfig(**TINY)
    params = tgpt.init_gpt_params(cfg, seed=1)
    mesh = tmesh((2, 4), ("dp", "tp"))
    rp, _ = _device_steps(cfg, params, mesh, 3, 0.5)
    specs = gpt_param_specs(None, cfg)
    for key in ("tok_W", "head_b"):
        assert all(torch.equal(rp[0][key], p[key]) for p in rp[1:]), key
    for key, spec in specs["layers"].items():
        for r, p in enumerate(rp):
            twin = rp[r % 4] if spec else rp[0]  # dp 0's copy
            assert torch.equal(p["layers"][key], twin["layers"][key]), key
    # and the parameters moved
    assert not torch.equal(rp[0]["tok_W"], params["tok_W"])


def test_b2_counted_once_through_the_fused_path(monkeypatch):
    """With K8/K9 forced on (their plain versions on the CPU), a tp 4
    forward adds b2 once: the loss and the b2/W2 gradients equal the
    single-device fused forward's with a nonzero b2. K8's zero-padded
    column blocks give the same projections as the unpadded ones."""
    cfg = tgpt.GPTConfig(vocab_size=19, d_model=128, n_heads=4, n_layers=2,
                         d_ff=512, ctx_len=16)
    params = tgpt.init_gpt_params(cfg, seed=2)
    rng = np.random.default_rng(4)
    params["layers"]["b2"] = torch.tensor(
        rng.standard_normal((2, 128)), dtype=torch.float32)
    x, y = (torch.as_tensor(a).long() for a in ids(6, 16, 16, 19))
    calls = []
    real_ffn = tgpt.ln_ffn
    monkeypatch.setattr(tgpt, "ln_ffn", lambda *a: calls.append(1)
                        or real_ffn(*a))
    monkeypatch.setattr(tgpt, "_pick_fused", lambda *a: True)
    monkeypatch.setattr(tsh, "_pick_fused", lambda *a: True)
    leaves = toptim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    want = tgpt.gpt_loss(params, x, y, cfg)
    wg = dict(zip(flat(params), torch.autograd.grad(want, leaves)))
    n_single = len(calls)
    mesh = tmesh((1, 4), ("dp", "tp"))
    specs = gpt_param_specs(None, cfg)
    fn = tsh._loss_and_grads(tsh._tp_loss(
        cfg, mesh, make_sharded_attn(mesh, 16, 32, cfg=cfg)), specs, mesh)
    got, g = fn(shard_tree(params, specs, mesh), x, y)
    assert len(calls) - n_single == 4 * 2  # every tp rank, every layer
    whole = flat(unshard_tree(g, specs, mesh))
    np.testing.assert_allclose(float(got), float(want.detach()), rtol=1e-5)
    for key in ("layers/b2", "layers/W2", "layers/Wq", "tok_W"):
        np.testing.assert_allclose(whole[key], wg[key].numpy(), rtol=2e-4,
                                   atol=2e-6, err_msg=key)
    # with b2 on every rank the loss would move by the extra 3 * b2
    params_b = toptim.tree_map(lambda t: t.detach(), params)
    params_b["layers"]["b2"] = 4 * params_b["layers"]["b2"]
    with torch.no_grad():
        wrong = tgpt.gpt_loss(params_b, x, y, cfg)
    assert abs(float(wrong) - float(want.detach())) > 1e-2


def test_dryrun_multichip_on_cpu_ranks(capsys):
    tsh.dryrun_multichip(8, ["cpu"] * 8)
    out = capsys.readouterr().out
    assert "MISMATCH" not in out and "dryrun_multichip ok" in out


@pytest.mark.parametrize("flags", [["--dp", "2"], ["--tp", "2"],
                                   ["--dp", "2", "--tp", "2"]],
                         ids=["dp", "tp", "dp_tp"])
def test_cli_run_checkpoint_loads_in_both_packages(flags, tmp_path, capsys):
    """``--train`` with the flags trains on CPU ranks; the best checkpoint
    (gathered to whole arrays) loads in the port and in the JAX package
    with equal arrays, and equals what ``train`` returned at the last
    eval; the mesh line names the shared device."""
    from linalg_tpu_torch.apps import gpt as tapp
    from linalg_tpu_torch.train.trainer import train

    ck = tmp_path / "ck"
    args = tapp.build_parser().parse_args([
        "--train", "--steps", "2", "--eval_every", "2", "--d_model", "32",
        "--layers", "2", "--heads", "2", "--ctx_len", "16", "--batch_size",
        "4", "--device", "cpu", "--ckpt_dir", str(ck), *flags])
    params, cfg, _, _ = train(args)
    out = capsys.readouterr().out
    assert "ranks share cpu" in out
    tparams, tcfg, _, _ = tckpt.load_ckpt(ck)
    jparams, jcfg, _, _ = jckpt.load_ckpt(ck)
    assert tcfg == cfg
    want = flat(params)
    for got in (flat(tparams), flat(jparams)):
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("flags,match", [
    (["--tp", "3"], "n_heads must divide by tp"),
    (["--dp", "3"], "batch_size must divide by dp"),
    (["--tp", "2", "--grad_accum", "2"], "--grad_accum composes"),
], ids=["heads", "batch", "grad_accum"])
def test_cli_refusals_match_jax(flags, match, tmp_path):
    """The JAX trainer's refusals, with its messages (AssertionError for
    its asserts, ValueError for --grad_accum)."""
    from linalg_tpu_torch.apps import gpt as tapp

    err = ValueError if "grad_accum" in match else AssertionError
    with pytest.raises(err, match=match):
        tapp.main(["--train", "--steps", "1", "--d_model", "32", "--layers",
                   "1", "--heads", "4", "--ctx_len", "16", "--batch_size",
                   "4", "--device", "cpu", "--ckpt_dir",
                   str(tmp_path / "ck"), *flags])


def test_sharded_steps_import_no_cuda_and_default_to_the_card(monkeypatch):
    """Without a card the default mesh raises instead of running on the
    CPU (the trainer asks for the card unless --device cpu)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh_mod.make_mesh((2, 2), ("dp", "tp"))


def test_serve_tp_serves_on_the_cpu(tmp_path):
    """``--serve --tp 2`` serves through the tensor-parallel engine, both
    ranks on the CPU, with the unsharded ``--serve``'s text."""
    import json

    from linalg_tpu_torch.apps import gpt as tapp

    cfg = tgpt.GPTConfig(**TINY)
    chars = "abcdefghijklmnopqrs"
    tckpt.save_ckpt(tmp_path, tgpt.init_gpt_params(cfg, seed=5), cfg,
                    {c: i for i, c in enumerate(chars)},
                    dict(enumerate(chars)))
    (tmp_path / "p.txt").write_text("abcab\nsrq\n", encoding="utf-8")
    out = {}
    for tp in (1, 2):
        tapp.main(["--serve", "--ckpt_dir", str(tmp_path), "--prompts",
                   str(tmp_path / "p.txt"), "--out",
                   str(tmp_path / f"o{tp}.jsonl"), "--gen_tokens", "6",
                   "--n_slots", "2", "--chunk", "4", "--top_k", "1", "--tp",
                   str(tp), "--device", "cpu"])
        out[tp] = [json.loads(ln)["text"] for ln in
                   (tmp_path / f"o{tp}.jsonl").read_text().splitlines()]
    assert out[2] == out[1] and all(len(t) == 6 for t in out[2])


def test_parallel_and_apps_import_no_jax():
    """The sharded trainers and the small apps import torch, never jax or
    the JAX package."""
    import subprocess
    import sys

    code = ("import sys\n"
            "import linalg_tpu_torch.parallel, linalg_tpu_torch.apps.gpt, "
            "linalg_tpu_torch.apps.logic_gates, "
            "linalg_tpu_torch.apps.glovecompare, "
            "linalg_tpu_torch.apps.vectors\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'linalg_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
