"""The port's pipeline parallelism (linalg_tpu_torch/parallel/pipeline.py)
against the JAX package's ``parallel/pipeline.py``, on the CPU.

GPipe (``make_pp_loss``, gradients by autograd through the schedule) and
1F1B (``make_pp_1f1b_grads``, explicit forward and backward slots) on
(pp,) and (dp, pp) meshes: the JAX functions on the conftest's virtual
devices, the port's ranks sharing the CPU, both in float64
(``torch_parallel_common.f64``, which also takes the JAX pipeline's
float32 buffers to float64): the loss and every gradient leaf within
1e-9 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_tpu.parallel import pipeline as jpipe
from linalg_tpu.train.optim import adamw_init as jadamw_init
from linalg_tpu_torch.models import gpt as tgpt
from linalg_tpu_torch.parallel import (collectives, make_pp_1f1b_grads,
                                       make_pp_1f1b_train_step,
                                       make_pp_device_train_step,
                                       make_pp_eval, make_pp_train_step,
                                       pp_param_specs, shard_tree,
                                       unshard_tree)
from linalg_tpu_torch.parallel import pipeline as tpipe
from linalg_tpu_torch.parallel import sharding as tsh
from linalg_tpu_torch.train import optim as toptim
from linalg_tpu_torch.train.trainer import make_device_train_step
from torch_parallel_common import (assert_trees_close, both64, f64,  # noqa
                                   flat, ids, jmesh, port_grads, tmesh)

torch.set_num_threads(2)

TINY = dict(vocab_size=19, d_model=32, n_heads=4, d_ff=64, ctx_len=16)
# name: (mesh shape (dp, pp), layers, microbatches, config overrides)
CASES = {
    "pp4_M2": ((1, 4), 4, 2, {}),
    "dp2_pp2_M4_rope": ((2, 2), 4, 4, dict(pos="rope")),
    "pp2_M3_alibi_window": ((1, 2), 2, 3, dict(pos="alibi", window=5)),
}


def _meshes(shape):
    names = ("dp", "pp")
    return jmesh(shape, names), tmesh(shape, names)


def test_specs_match_jax():
    want = jax.tree_util.tree_flatten_with_path(
        jpipe.pp_param_specs("dp"),
        is_leaf=lambda v: isinstance(v, jax.sharding.PartitionSpec))[0]
    got = jax.tree_util.tree_flatten_with_path(
        pp_param_specs("dp"), is_leaf=lambda v: isinstance(v, tuple))[0]
    assert {jax.tree_util.keystr(p): tuple(s) for p, s in want} == {
        jax.tree_util.keystr(p): s for p, s in got}


@pytest.mark.parametrize("name", sorted(CASES))
def test_gpipe_loss_and_every_gradient_match_jax(name, f64):
    shape, L, M, kw = CASES[name]
    jc, jp, tc, tp = both64(**TINY, n_layers=L, **kw)
    B = 6 * shape[0] if M == 3 else 8
    x, y = ids(0, B, 16, 19)
    jm, tm = _meshes(shape)
    jl, jg = jax.value_and_grad(jpipe.make_pp_loss(
        jc, jm, M, dp_axis="dp"))(jp, jnp.asarray(x), jnp.asarray(y))
    specs = pp_param_specs("dp")
    fn = tsh._loss_and_grads(tpipe.make_pp_loss(tc, tm, M, dp_axis="dp"),
                             specs, tm)
    tl, tg = port_grads(fn, shard_tree(tp, specs, tm), x, y, specs, tm)
    np.testing.assert_allclose(tl, float(jl), rtol=1e-9)
    assert_trees_close(tg, jg)


@pytest.mark.parametrize("name", sorted(CASES))
def test_1f1b_loss_and_every_gradient_match_jax(name, f64):
    shape, L, M, kw = CASES[name]
    jc, jp, tc, tp = both64(**TINY, n_layers=L, **kw)
    B = 6 * shape[0] if M == 3 else 8
    x, y = ids(1, B, 16, 19)
    jm, tm = _meshes(shape)
    jl, jg = jpipe.make_pp_1f1b_grads(jc, jm, M, dp_axis="dp")(
        jp, jnp.asarray(x), jnp.asarray(y))
    specs = pp_param_specs("dp")
    tl, tg = port_grads(make_pp_1f1b_grads(tc, tm, M, dp_axis="dp"),
                        shard_tree(tp, specs, tm), x, y, specs, tm)
    np.testing.assert_allclose(tl, float(jl), rtol=1e-9)
    assert_trees_close(tg, jg)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_train_steps_match_jax(schedule, f64):
    """Two constant-lr steps of ``make_pp_train_step`` (GPipe) and
    ``make_pp_1f1b_train_step`` on a (2, 2) mesh: the losses and the
    gathered parameters, as JAX's."""
    jc, jp, tc, tp = both64(**TINY, n_layers=4)
    jm, tm = _meshes((2, 2))
    make_j = (jpipe.make_pp_train_step if schedule == "gpipe"
              else jpipe.make_pp_1f1b_train_step)
    make_t = (make_pp_train_step if schedule == "gpipe"
              else make_pp_1f1b_train_step)
    jstep = make_j(jc, jm, 2, lr=1e-2, weight_decay=0.01, dp_axis="dp")
    tstep = make_t(tc, tm, 2, lr=1e-2, weight_decay=0.01, dp_axis="dp")
    specs = pp_param_specs("dp")
    rp = shard_tree(tp, specs, tm)
    ro = [toptim.adamw_init(p) for p in rp]
    jo = jadamw_init(jp)
    for s in range(2):
        x, y = ids(10 + s, 8, 16, 19)
        jp, jo, jl = jstep(jp, jo, jnp.asarray(x), jnp.asarray(y))
        rp, ro, tl = tstep(rp, ro, torch.as_tensor(x).long(),
                           torch.as_tensor(y).long())
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-9)
    assert_trees_close(unshard_tree(rp, specs, tm), jp)


def test_device_step_matches_single_device_and_counts_ticks(f64):
    """The trainer's 1F1B step equals the single-device step on the same
    windows (clipped, rel 1e-9); its ticks move activations up and
    cotangents down one ppermute each; GPipe's eval matches the
    single-device loss."""
    _, _, tc, tp = both64(**TINY, n_layers=4)
    data = torch.as_tensor(np.random.default_rng(3).integers(0, 19, 1024))
    kw = dict(base_lr=1e-2, min_lr=1e-3, warmup=2, max_steps=16,
              weight_decay=0.01, clip_norm=0.3)
    one = toptim.tree_map(torch.clone, tp)
    step1 = make_device_train_step(tc, 8, **kw)
    opt1 = toptim.adamw_init(one)
    gen = torch.Generator().manual_seed(5)
    l1 = []
    for _ in range(2):
        one, opt1, gen, loss = step1(one, opt1, data, gen)
        l1.append(float(loss))
    tm = tmesh((2, 2), ("dp", "pp"))
    specs = pp_param_specs("dp")
    rp = shard_tree(tp, specs, tm)
    ro = [toptim.adamw_init(p) for p in rp]
    step = make_pp_device_train_step(tc, tm, 8, n_microbatches=2, **kw)
    gen = torch.Generator().manual_seed(5)
    collectives.clear()
    ls = []
    for _ in range(2):
        rp, ro, gen, loss = step(rp, ro, data, gen)
        ls.append(float(loss))
    np.testing.assert_allclose(ls, l1, rtol=1e-9)
    # AdamW divides each entry's gradient by its own size: where that is
    # near eps (embedding rows of tokens absent from the batch), the two
    # summation orders of tok_W's stage-0 and head gradients move the
    # update by up to ~1e-9 absolute
    assert_trees_close(unshard_tree(rp, specs, tm), one, atol=1e-9)
    ticks = 2 + 2 * 2 - 2  # M + 2S - 2
    assert collectives["ppermute"] == 2 * 2 * ticks  # up and down, 2 steps
    gen = torch.Generator().manual_seed(9)
    ev = make_pp_eval(tc, tm, 8, 2, n_microbatches=2)(rp, data, gen)
    with torch.no_grad():
        gen = torch.Generator().manual_seed(9)
        from linalg_tpu_torch.train.trainer import _eval_device

        want = _eval_device(unshard_tree(rp, specs, tm), data, gen, tc, 8, 2)
    np.testing.assert_allclose(float(ev), float(want), rtol=1e-9)


def test_1f1b_recomputes_each_stage_once_per_microbatch(monkeypatch):
    """1F1B runs each stage twice per microbatch (its forward slot, then
    the recompute in its backward slot), except the last stage, whose
    forward slot only stashes: S + S - 1 stage runs a microbatch."""
    cfg = tgpt.GPTConfig(**TINY, n_layers=4)
    params = tgpt.init_gpt_params(cfg, seed=0)
    tm = tmesh((1, 4), ("dp", "pp"))
    specs = pp_param_specs("dp")
    runs = []
    real = tpipe._run_stage
    monkeypatch.setattr(tpipe, "_run_stage", lambda *a: runs.append(1)
                        or real(*a))
    x, y = (torch.as_tensor(a).long() for a in ids(2, 16, 16, 19))
    make_pp_1f1b_grads(cfg, tm, 8, dp_axis="dp")(
        shard_tree(params, specs, tm), x, y)
    assert len(runs) == 8 * (2 * 4 - 1)


@pytest.mark.parametrize("flags,ok", [
    (["--pp", "2"], True),
    (["--pp", "2", "--dp", "2", "--microbatches", "2"], True),
    (["--pp", "2", "--batch_size", "6"], True),
], ids=["pp2", "dp2_pp2_M2", "auto_M_falls_back_to_pp"])
def test_cli_pp_trains(flags, ok, tmp_path, capsys):
    """--pp trains through 1F1B; --microbatches auto is 2*pp when the batch
    divides, else pp (the JAX trainer's rule)."""
    from linalg_tpu_torch.apps import gpt as tapp

    tapp.main(["--train", "--steps", "2", "--eval_every", "2",
               "--batch_size", "8", "--ctx_len", "16", "--d_model", "32",
               "--heads", "4", "--layers", "2", "--device", "cpu",
               "--ckpt_dir", str(tmp_path), *flags])
    out = capsys.readouterr().out
    want = ("2 microbatches" if "--microbatches" in flags or "6" in flags
            else "4 microbatches")
    assert want in out and (tmp_path / "chars_gpt_best.npz").exists()


@pytest.mark.parametrize("flags,match", [
    (["--sp", "2"], "--pp composes with --dp only"),
    (["--tp", "2"], "--pp composes with --dp only"),
    (["--pos", "learned"], "--pos learned is not supported with --pp"),
    (["--experts", "4"], "--pp with --experts is not supported"),
    (["--layers", "3"], "layers must divide by pp"),
    (["--microbatches", "3"], "batch_size must divide by dp"),
], ids=["sp", "tp", "learned", "experts", "layers", "microbatches"])
def test_cli_refusals_match_jax(flags, match, tmp_path):
    from linalg_tpu_torch.apps import gpt as tapp

    with pytest.raises(AssertionError, match=match):
        tapp.main(["--train", "--steps", "1", "--batch_size", "8",
                   "--ctx_len", "16", "--d_model", "32", "--heads", "4",
                   "--layers", "2", "--device", "cpu", "--ckpt_dir",
                   str(tmp_path / "ck"), "--pp", "2", *flags])
