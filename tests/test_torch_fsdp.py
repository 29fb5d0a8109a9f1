"""The port's FSDP (linalg_tpu_torch/parallel/fsdp.py) against the JAX
package's ``parallel/fsdp.py``, on the CPU.

The JAX side jits ``gpt_loss``'s gradients with ``fsdp_shardings`` on the
conftest's virtual devices (as tests/test_fsdp.py does); the port's ranks
share the CPU, each storing 1/N of every large leaf and its moments. Both
in float64 (``torch_parallel_common.f64``): the loss and every gradient
leaf within 1e-9 relative. The widths (d 64, d_ff 256) put W1, W2 and
friends over the 2^14-element threshold, so leaves shard.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from linalg_tpu.models import gpt as jgpt
from linalg_tpu.nn.functional import sdpa as jsdpa
from linalg_tpu.parallel import fsdp as jfsdp
from linalg_tpu_torch.models import gpt as tgpt
from linalg_tpu_torch.models import moe as tmoe
from linalg_tpu_torch.parallel import (collectives, fsdp_param_specs,
                                       make_fsdp_device_train_step,
                                       make_fsdp_eval, shard_tree,
                                       unshard_tree)
from linalg_tpu_torch.parallel import fsdp as tfsdp
from linalg_tpu_torch.parallel import sharding as tsh
from linalg_tpu_torch.train import optim as toptim
from linalg_tpu_torch.train.trainer import make_device_train_step
from torch_parallel_common import (assert_trees_close, both64, f64,  # noqa
                                   flat, ids, jmesh, port_grads, tmesh)

torch.set_num_threads(2)

WIDE = dict(vocab_size=17, d_model=64, n_heads=4, n_layers=2, d_ff=256,
            ctx_len=16)


@pytest.mark.parametrize("kw", [
    dict(vocab_size=65, d_model=256, n_heads=4, n_layers=2, ctx_len=64),
    dict(vocab_size=65, d_model=256, n_heads=8, n_kv_heads=2, n_layers=2,
         ctx_len=64, pos="learned"),
    dict(WIDE, ffn="swiglu")], ids=["dense", "gqa_learned", "swiglu"])
@pytest.mark.parametrize("n", [4, 8])
def test_specs_match_jax(kw, n):
    """The same leaf-shape rule (largest dividing dim, earlier on ties,
    small leaves replicated) gives JAX's specs, entry for entry."""
    tc = tgpt.GPTConfig(**kw)
    params = tgpt.init_gpt_params(tc, seed=0)
    want = jfsdp.fsdp_param_specs(
        jax.tree.map(lambda t: jax.ShapeDtypeStruct(tuple(t.shape),
                                                    jnp.float32), params), n)
    got = fsdp_param_specs(params, n)
    assert {k: tuple(v) for k, v in flat_specs(want).items()} == \
        flat_specs(got)


def test_moe_stack_specs_match_jax():
    tc = tmoe.MoEGPTConfig(**WIDE, n_experts=4)
    params = tmoe.init_moe_params(tc, seed=0)
    want = jfsdp.fsdp_param_specs(jax.tree.map(
        lambda t: jax.ShapeDtypeStruct(tuple(t.shape), jnp.float32),
        params), 4)
    assert {k: tuple(v) for k, v in flat_specs(want).items()} == \
        flat_specs(fsdp_param_specs(params, 4))


def flat_specs(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_specs(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("n,kw", [(4, {}), (8, dict(pos="rope")),
                                  (2, dict(pos="alibi", ffn="geglu"))],
                         ids=["fsdp4", "fsdp8_rope", "fsdp2_alibi_geglu"])
def test_loss_and_every_gradient_match_jax(n, kw, f64):
    """Each rank's forward with its layers gathered one at a time, the
    gradients reduce-scattered back: the loss and every gradient leaf
    (gathered) against ``jax.grad(gpt_loss)`` jitted with
    ``fsdp_shardings`` (tests/test_fsdp.py:86): rel 1e-9."""
    jc, jp, tc, tp = both64(**WIDE, **kw)
    x, y = ids(1, 8, 16, 17)
    mesh = jmesh((n,), ("fsdp",))
    param_sh = jfsdp.fsdp_shardings(jp, mesh)
    batch_sh = NamedSharding(mesh, P("fsdp", None))
    attn = None if kw.get("pos") == "alibi" else jsdpa
    jl, jg = jax.jit(
        jax.value_and_grad(lambda p, xx, yy: jgpt.gpt_loss(
            p, xx, yy, jc, attn_fn=attn)),
        in_shardings=(param_sh, batch_sh, batch_sh))(
            jax.device_put(jp, param_sh), jnp.asarray(x), jnp.asarray(y))
    tm = tmesh((n,), ("fsdp",))
    specs = fsdp_param_specs(tp, n)
    assert any(s for s in flat_specs(specs).values())
    fn = tsh._loss_and_grads(tfsdp._fsdp_loss(tc, tm, specs), specs, tm)
    tl, tg = port_grads(fn, shard_tree(tp, specs, tm), x, y, specs, tm)
    np.testing.assert_allclose(tl, float(jl), rtol=1e-9)
    assert_trees_close(tg, jg)


def test_leaves_split_along_the_layer_axis(f64):
    """A spec that splits stacked layer leaves along their layer axis (the
    rule's pick when L is their largest dividing dimension) gathers them
    once a step and gives the unsharded gradients: rel 1e-9 against the
    single-device ``gpt_loss``."""
    _, _, tc, tp = both64(**WIDE)
    mesh = tmesh((2,), ("fsdp",))
    specs = fsdp_param_specs(tp, 2)
    for k in ("ln1_g", "b2", "Wq"):
        specs["layers"][k] = ("fsdp",) + (None,) * (tp["layers"][k].dim() - 1)
    x, y = ids(3, 8, 16, 17)
    fn = tsh._loss_and_grads(tfsdp._fsdp_loss(tc, mesh, specs), specs, mesh)
    tl, tg = port_grads(fn, shard_tree(tp, specs, mesh), x, y, specs, mesh)
    leaves = toptim.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    want = tgpt.gpt_loss(tp, torch.as_tensor(x).long(),
                         torch.as_tensor(y).long(), tc)
    grads = iter(torch.autograd.grad(want, leaves))
    np.testing.assert_allclose(tl, float(want.detach()), rtol=1e-9)
    assert_trees_close(tg, toptim.tree_map(lambda _: next(grads), tp))


def test_collectives_one_layer_at_a_time():
    """One all-gather per sharded layer leaf per layer (and one for the
    sharded embedding) in the forward, as many reduce-scatters in the
    backward, one all-reduce per replicated leaf's gradient and one for
    the loss."""
    cfg = tgpt.GPTConfig(**WIDE)
    params = tgpt.init_gpt_params(cfg, seed=0)
    mesh = tmesh((4,), ("fsdp",))
    specs = fsdp_param_specs(params, 4)
    fs = flat_specs(specs)
    n_layer = sum(1 for k, s in fs.items() if k.startswith("layers/") and s)
    n_top = sum(1 for k, s in fs.items() if not k.startswith("layers/") and s)
    n_repl = sum(1 for s in fs.values() if not s)
    fn = tsh._loss_and_grads(tfsdp._fsdp_loss(cfg, mesh, specs), specs,
                             mesh)
    x, y = (torch.as_tensor(a).long() for a in ids(2, 8, 16, 17))
    collectives.clear()
    fn(shard_tree(params, specs, mesh), x, y)
    gathers = n_layer * cfg.n_layers + n_top
    assert collectives["all_gather"] == gathers
    assert collectives["reduce_scatter"] == gathers
    assert collectives["all_reduce"] == n_repl + 2  # + the loss, fwd/bwd


def test_rank_bytes_are_one_nth_and_steps_match_single_device(f64):
    """Two FSDP steps equal two single-device steps drawing the same
    windows (rel 1e-9); each rank stores 1/4 of every sharded leaf and of
    its moments, and the eval runs sharded."""
    _, _, tc, tp = both64(**WIDE)
    data = torch.as_tensor(np.random.default_rng(4).integers(0, 17, 512))
    kw = dict(base_lr=1e-2, min_lr=1e-3, warmup=2, max_steps=32,
              weight_decay=0.01, clip_norm=0.5)
    one = toptim.tree_map(torch.clone, tp)
    step1 = make_device_train_step(tc, 8, **kw)
    opt1 = toptim.adamw_init(one)
    gen = torch.Generator().manual_seed(7)
    l1 = []
    for _ in range(2):
        one, opt1, gen, loss = step1(one, opt1, data, gen)
        l1.append(float(loss))
    mesh = tmesh((4,), ("fsdp",))
    specs = fsdp_param_specs(tp, 4)
    rp = shard_tree(tp, specs, mesh)
    ro = [toptim.adamw_init(p) for p in rp]
    step = make_fsdp_device_train_step(tc, mesh, tp, 8, **kw)
    gen = torch.Generator().manual_seed(7)
    ls = []
    for _ in range(2):
        rp, ro, gen, loss = step(rp, ro, data, gen)
        ls.append(float(loss))
    np.testing.assert_allclose(ls, l1, rtol=1e-9)
    assert_trees_close(unshard_tree(rp, specs, mesh), one)
    for k, s in flat_specs(specs).items():
        whole = flat(tp)[k].size
        got = flat(rp[1])[k].size
        assert got * (4 if s else 1) == whole, k
        assert flat(ro[1].m)[k].size == got and flat(ro[1].v)[k].size == got
    ev = make_fsdp_eval(tc, mesh, tp, 8, 2)(rp, data,
                                             torch.Generator().manual_seed(1))
    assert np.isfinite(float(ev))


def test_cli_fsdp_trains_and_saves_whole_arrays(tmp_path, capsys):
    from linalg_tpu_torch.apps import gpt as tapp
    from linalg_tpu_torch.train import checkpoint as tckpt

    tapp.main(["--train", "--steps", "2", "--eval_every", "2",
               "--batch_size", "8", "--ctx_len", "16", "--d_model", "64",
               "--heads", "4", "--layers", "1", "--device", "cpu",
               "--ckpt_dir", str(tmp_path), "--fsdp", "4"])
    assert "mesh fsdp=4: 4 ranks share cpu" in capsys.readouterr().out
    params, cfg, _, _ = tckpt.load_ckpt(tmp_path)
    assert params["layers"]["W1"].shape == (1, 64, 256)


@pytest.mark.parametrize("flags,match", [
    (["--dp", "2"], "--fsdp is itself the data axis"),
    (["--pp", "2"], "--fsdp is itself the data axis"),
    (["--experts", "4"], "--fsdp with --experts is not supported"),
    (["--batch_size", "6"], "batch_size must divide by fsdp"),
], ids=["dp", "pp", "experts", "batch"])
def test_cli_refusals_match_jax(flags, match, tmp_path):
    from linalg_tpu_torch.apps import gpt as tapp

    argv = ["--train", "--steps", "1", "--batch_size", "8", "--ctx_len",
            "16", "--d_model", "32", "--heads", "4", "--layers", "2",
            "--device", "cpu", "--ckpt_dir", str(tmp_path / "ck"),
            "--fsdp", "4", *flags]
    with pytest.raises(AssertionError, match=match):
        tapp.main(argv)
