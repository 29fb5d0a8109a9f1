"""The port's expert parallelism (linalg_tpu_torch/parallel/expert.py)
against the JAX package's ``parallel/expert.py``, on the CPU.

The experts split over 'ep' (and the batch over 'dp'): the JAX functions
on the conftest's virtual devices with their shardings, the port's ranks
sharing the CPU, both in float64 (``torch_parallel_common.f64`` also
takes both packages' float32 router math to float64): the loss and every
gradient leaf within 1e-9 relative. The dp split keeps the load-balance
loss's statistics global (their all-reduce mean over 'dp').
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from linalg_tpu.models import moe as jmoe
from linalg_tpu.parallel import expert as jexp
from linalg_tpu.train.optim import adamw_init as jadamw_init
from linalg_tpu_torch.parallel import (collectives, make_ep_device_train_step,
                                       make_ep_eval, make_ep_train_step,
                                       moe_param_specs, shard_tree,
                                       unshard_tree)
from linalg_tpu_torch.parallel import expert as texp
from linalg_tpu_torch.parallel import sharding as tsh
from linalg_tpu_torch.train import optim as toptim
from linalg_tpu_torch.train.trainer import make_device_train_step
from torch_parallel_common import (assert_trees_close, both64, f64,  # noqa
                                   ids, jmesh, port_grads, tmesh)

torch.set_num_threads(2)

TINY = dict(vocab_size=19, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            ctx_len=16)
# name: (mesh shape (dp, ep), config overrides)
CASES = {
    "top1_dp2_ep4": ((2, 4), dict(n_experts=8)),
    "top2_ep4": ((1, 4), dict(n_experts=4, router_top_k=2)),
    "swiglu_rope_dp4_ep2": ((4, 2), dict(n_experts=4, ffn="swiglu",
                                         pos="rope")),
}


@pytest.mark.parametrize("ffn", ["relu", "swiglu"])
def test_specs_match_jax(ffn):
    from linalg_tpu_torch.models.moe import MoEGPTConfig

    want = jax.tree_util.tree_flatten_with_path(
        jexp.moe_param_specs(jmoe.MoEGPTConfig(**TINY, ffn=ffn)),
        is_leaf=lambda v: isinstance(v, P))[0]
    got = jax.tree_util.tree_flatten_with_path(
        moe_param_specs(MoEGPTConfig(**TINY, ffn=ffn)),
        is_leaf=lambda v: isinstance(v, tuple))[0]
    assert {jax.tree_util.keystr(p): tuple(s) for p, s in want} == {
        jax.tree_util.keystr(p): s for p, s in got}


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_and_every_gradient_match_jax(name, f64):
    """The dp x ep loss and every gradient leaf against
    ``moe_gpt_loss``'s jitted with the ep shardings: rel 1e-9."""
    shape, kw = CASES[name]
    jc, jp, tc, tp = both64(moe=True, **TINY, **kw)
    x, y = ids(0, 8, 16, 19)
    mesh = jmesh(shape, ("dp", "ep"))
    param_sh = jax.tree.map(lambda s: NamedSharding(mesh, s),
                            jexp.moe_param_specs(jc),
                            is_leaf=lambda v: isinstance(v, P))
    batch_sh = NamedSharding(mesh, P("dp", None))
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, xx, yy: jmoe.moe_gpt_loss(p, xx, yy, jc)),
        in_shardings=(param_sh, batch_sh, batch_sh))(
            jp, jnp.asarray(x), jnp.asarray(y))
    tm = tmesh(shape, ("dp", "ep"))
    specs = moe_param_specs(tc)
    attn = tsh.make_sharded_attn(tm, 16, tc.d_head, head_axis=None, cfg=tc)
    fn = tsh._loss_and_grads(texp._ep_loss(tc, tm, attn, "dp"), specs, tm)
    tl, tg = port_grads(fn, shard_tree(tp, specs, tm), x, y, specs, tm)
    np.testing.assert_allclose(tl, float(jl), rtol=1e-9)
    assert_trees_close(tg, jg)


def test_train_steps_match_make_ep_train_step(f64):
    """Two constant-lr steps of ``make_ep_train_step`` on a (2, 2) mesh
    (gather dispatch asked for: both force the einsum one): losses and
    gathered parameters as JAX's."""
    jc, jp, tc, tp = both64(moe=True, **TINY, n_experts=4, dispatch="gather")
    jstep = jexp.make_ep_train_step(jc, jmesh((2, 2), ("dp", "ep")),
                                    lr=1e-2, weight_decay=0.01, dp_axis="dp")
    tm = tmesh((2, 2), ("dp", "ep"))
    tstep = make_ep_train_step(tc, tm, lr=1e-2, weight_decay=0.01,
                               dp_axis="dp")
    specs = moe_param_specs(tc)
    rp = shard_tree(tp, specs, tm)
    ro = [toptim.adamw_init(p) for p in rp]
    jo = jadamw_init(jp)
    for s in range(2):
        x, y = ids(20 + s, 8, 16, 19)
        jp, jo, jl = jstep(jp, jo, jnp.asarray(x), jnp.asarray(y))
        rp, ro, tl = tstep(rp, ro, torch.as_tensor(x).long(),
                           torch.as_tensor(y).long())
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-9)
    assert_trees_close(unshard_tree(rp, specs, tm), jp)


def test_device_step_matches_single_device(f64):
    """The trainer's dp x ep step equals the single-device MoE step on the
    same windows (losses rel 1e-9; parameters within AdamW's conditioning,
    see test_torch_pipeline.py); one all-reduce over 'ep' per layer
    forward (and its adjoint backward) sums the experts' shares."""
    _, _, tc, tp = both64(moe=True, **TINY, n_experts=4)
    data = torch.as_tensor(np.random.default_rng(6).integers(0, 19, 1024))
    kw = dict(base_lr=1e-2, min_lr=1e-3, warmup=2, max_steps=16,
              weight_decay=0.01, clip_norm=0.5)
    one = toptim.tree_map(torch.clone, tp)
    step1 = make_device_train_step(tc, 8, **kw)
    opt1 = toptim.adamw_init(one)
    gen = torch.Generator().manual_seed(2)
    l1 = []
    for _ in range(2):
        one, opt1, gen, loss = step1(one, opt1, data, gen)
        l1.append(float(loss))
    tm = tmesh((2, 2), ("dp", "ep"))
    specs = moe_param_specs(tc)
    rp = shard_tree(tp, specs, tm)
    ro = [toptim.adamw_init(p) for p in rp]
    step = make_ep_device_train_step(tc, tm, 8, **kw)
    gen = torch.Generator().manual_seed(2)
    ls = []
    collectives.clear()
    for _ in range(2):
        rp, ro, gen, loss = step(rp, ro, data, gen)
        ls.append(float(loss))
    np.testing.assert_allclose(ls, l1, rtol=1e-9)
    assert_trees_close(unshard_tree(rp, specs, tm), one, atol=1e-9)
    ev = make_ep_eval(tc, tm, 8, 2)(rp, data, torch.Generator().manual_seed(1))
    assert np.isfinite(float(ev))
    assert collectives["all_reduce"] > 0


def test_cli_experts_tp_trains(tmp_path, capsys):
    from linalg_tpu_torch.apps import gpt as tapp
    from linalg_tpu_torch.train import checkpoint as tckpt

    tapp.main(["--train", "--steps", "2", "--eval_every", "2",
               "--batch_size", "4", "--ctx_len", "16", "--d_model", "32",
               "--heads", "2", "--layers", "2", "--device", "cpu",
               "--ckpt_dir", str(tmp_path), "--experts", "4", "--tp", "2",
               "--dp", "2"])
    out = capsys.readouterr().out
    assert "mesh dp=2 ep=2: 4 ranks share cpu; experts sharded" in out
    params, cfg, _, _ = tckpt.load_ckpt(tmp_path)
    assert params["layers"]["W1"].shape == (2, 4, 32, 128)


def test_cli_refuses_experts_not_dividing(tmp_path):
    from linalg_tpu_torch.apps import gpt as tapp

    with pytest.raises(AssertionError, match="n_experts must divide by tp"):
        tapp.main(["--train", "--steps", "1", "--batch_size", "4",
                   "--ctx_len", "16", "--d_model", "32", "--heads", "2",
                   "--layers", "1", "--device", "cpu", "--ckpt_dir",
                   str(tmp_path / "ck"), "--experts", "3", "--tp", "2"])
