"""The work of tests/test_torch_processes.py, run twice: in each of two
interpreters that share one Gloo group (``python torch_process_child.py
URL RANK OUT_DIR GROUP_TIMEOUT_S``: meshes dealt over the job's two CPU
devices, writes ``res{RANK}.json`` and ``arrays{RANK}.npz`` into OUT_DIR),
and in the pytest process over one-process meshes of CPU ranks, the
reference. Imports neither JAX nor the JAX package.

Every case takes a mesh factory ``make(shape, names)``: the children's
spans the two processes, the reference's keeps every rank in one
process. Float64 throughout (the kernel ring's cases also in float32),
with the port-side casts of
``torch_parallel_common.f64`` (logits and router kept in float64, RoPE
tables in float64, the JAX package's float32 sinusoidal tables, which the
pytest process hands the children in ``sinusoidal.npz``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import pathlib
import sys

import numpy as np
import torch

from linalg_tpu_torch.models import gpt as tgpt
from linalg_tpu_torch.models import moe as tmoe
from linalg_tpu_torch.parallel import (all_gather, all_reduce, all_to_all,
                                       collectives, ppermute, reduce_scatter)
from linalg_tpu_torch.parallel import expert as texpert
from linalg_tpu_torch.parallel import pipeline as tpipe
from linalg_tpu_torch.parallel.mesh import shard_tree, taped, unshard_tree
from linalg_tpu_torch.train.optim import adamw_init, tree_map

TINY = dict(vocab_size=19, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            ctx_len=16)
WIDE = dict(vocab_size=17, d_model=64, n_heads=4, n_layers=2, d_ff=256,
            ctx_len=16)
STEPS = ("fsdp", "ep", "pp", "gpipe", "sp", "sp_pallas")
STEP_KW = dict(base_lr=1e-2, min_lr=1e-3, warmup=2, max_steps=10,
               weight_decay=0.01)


@dataclasses.dataclass(frozen=True)
class Cfg64(tgpt.GPTConfig):
    @property
    def compute_dtype(self):
        return torch.float64


@dataclasses.dataclass(frozen=True)
class MoE64(tmoe.MoEGPTConfig):
    @property
    def compute_dtype(self):
        return torch.float64


def f64_port(tables_by_shape):
    """The port side of ``torch_parallel_common.f64``, for a child:
    ``tables_by_shape`` maps "n_d" to the JAX package's (n, d) float32
    sinusoidal table."""
    def head(p, h, dt):
        return h @ p["tok_W"].to(dt).T + p["head_b"].to(dt)

    def tables(d, pos):
        ang = torch.as_tensor(pos).double()[..., None] / (
            10000.0 ** (torch.arange(0, d, 2, dtype=torch.float64) / d))
        return torch.cos(ang), torch.sin(ang)

    def sinus(n, d, device=None):
        return torch.tensor(tables_by_shape[f"{n}_{d}"])

    for mod in (tgpt, tpipe, texpert, tmoe):
        mod._head = head
    tmoe._ROUTER_DTYPE = torch.float64
    tgpt.rope_tables = tables
    for mod in (tgpt, tmoe):
        mod.sinusoidal_encoding = sinus


def _np(t):
    return t.detach().cpu().numpy()


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = _np(v)
    return out


# -- (a) the collectives and their adjoints -----------------------------------

# name: (mesh shape, axis names, collective, axes, keyword arguments)
COLLECTIVES = {
    "all_reduce_a": ((2, 2), ("a", "b"), "all_reduce", "a", {}),
    "all_reduce_b_mean": ((2, 2), ("a", "b"), "all_reduce", "b",
                          {"op": "mean"}),
    "all_reduce_ab_mean": ((2, 2), ("a", "b"), "all_reduce", ("a", "b"),
                           {"op": "mean"}),
    "all_gather_a": ((2, 2), ("a", "b"), "all_gather", "a", {"dim": 0}),
    "reduce_scatter_a": ((2, 2), ("a", "b"), "reduce_scatter", "a",
                         {"dim": 1}),
    "all_to_all_a": ((2, 2), ("a", "b"), "all_to_all", "a",
                     {"split_dim": 0, "concat_dim": 1}),
    "ppermute_a": ((2, 2), ("a", "b"), "ppermute", "a",
                   {"perm": [(0, 1), (1, 0)]}),
    "all_reduce_4": ((4,), ("a",), "all_reduce", "a", {}),
    "all_gather_4": ((4,), ("a",), "all_gather", "a", {"dim": 1}),
    "reduce_scatter_4_mean": ((4,), ("a",), "reduce_scatter", "a",
                              {"dim": 0, "op": "mean"}),
    "all_to_all_4": ((4,), ("a",), "all_to_all", "a",
                     {"split_dim": 1, "concat_dim": 0}),
    "ppermute_4_ring": ((4,), ("a",), "ppermute", "a",
                        {"perm": [(i, (i + 1) % 4) for i in range(4)]}),
    # rank 1 holds None: rank 2 (the other process) gets None
    "ppermute_4_none": ((4,), ("a",), "ppermute", "a",
                        {"perm": [(0, 1), (1, 2), (2, 3)]}),
    # groups of 3 along "a", two of their ranks in one process and one in
    # the other (the members padded to the larger count)
    "all_reduce_32": ((3, 2), ("a", "b"), "all_reduce", "a", {}),
    "all_gather_32": ((3, 2), ("a", "b"), "all_gather", "a", {"dim": 1}),
    "reduce_scatter_32": ((3, 2), ("a", "b"), "reduce_scatter", "a",
                          {"dim": 0}),
    "all_to_all_32": ((3, 2), ("a", "b"), "all_to_all", "a",
                      {"split_dim": 0, "concat_dim": 1}),
    "ppermute_32": ((3, 2), ("a", "b"), "ppermute", "a",
                    {"perm": [(0, 1), (1, 2), (2, 0)]}),
}
_FNS = {"all_reduce": all_reduce, "all_gather": all_gather,
        "reduce_scatter": reduce_scatter, "all_to_all": all_to_all,
        "ppermute": ppermute}


def collective_case(make, name):
    """One collective forward and backward on (12, 12) float64 values, the
    loss the sum of each output times weights of its shape drawn for its
    rank: {"out/r", "grad/r": arrays of this process's ranks}, the calls
    counted, and the groups that hold a rank of this process."""
    shape, names, kind, axes, kw = COLLECTIVES[name]
    mesh = make(shape, names)
    xs = [torch.tensor(np.random.default_rng(r).normal(size=(12, 12)),
                       requires_grad=True) if mesh.is_local(r) else None
          for r in range(mesh.size)]
    if name.endswith("_none"):
        xs[1] = None
    collectives.clear()
    with taped() as tape:
        outs = _FNS[kind](xs, mesh, axes, **kw)
        loss = sum((o * torch.tensor(np.random.default_rng(100 + r).normal(
            size=tuple(o.shape)))).sum() for r, o in enumerate(outs)
            if o is not None and mesh.is_local(r))
        loss = tape.tie(loss)
    live = [r for r in mesh.local_ranks if xs[r] is not None]
    grads = torch.autograd.grad(loss, [xs[r] for r in live] + [tape.root],
                                allow_unused=True)
    arrays = {}
    for r in mesh.local_ranks:
        if outs[r] is not None:
            arrays[f"out/{r}"] = _np(outs[r])
    for r, g in zip(live, grads):
        arrays[f"grad/{r}"] = (np.zeros((12, 12)) if g is None else
                               _np(g))
    groups = sum(any(mesh.is_local(r) for r in g)
                 for g in mesh.groups(axes))
    return arrays, {"calls": dict(collectives), "groups": groups}


# -- (b), (c) the sharded steps -----------------------------------------------


def _params64(cfg, moe=False):
    p = (tmoe.init_moe_params(cfg, seed=123) if moe else
         tgpt.init_gpt_params(cfg, seed=123))
    return tree_map(lambda t: t.double(), p)


def _batches():
    """The fixed (x, y) batches of ``torch_parallel_common.ids(s, 8, 16,
    19)``, s = 0, 1, 2."""
    out = []
    for s in range(3):
        rng = np.random.default_rng(s)
        out.append((rng.integers(0, 19, (8, 16)).astype(np.int32),
                    rng.integers(0, 19, (8, 16)).astype(np.int32)))
    return out


def dp_tp_steps(make):
    """Three steps of ``make_sharded_train_step`` on a (2, 4) dp x tp mesh
    at lr 1e-2: (losses, the whole parameters after them)."""
    from linalg_tpu_torch.parallel import (gpt_param_specs,
                                           make_sharded_train_step)

    cfg = Cfg64(**TINY)
    mesh = make((2, 4), ("dp", "tp"))
    specs = gpt_param_specs(None, cfg)
    rp = shard_tree(_params64(cfg), specs, mesh)
    ro = [None if p is None else adamw_init(p) for p in rp]
    step = make_sharded_train_step(cfg, mesh, lr=1e-2, weight_decay=0.01)
    losses = []
    for x, y in _batches():
        rp, ro, loss = step(rp, ro, torch.as_tensor(x).long(),
                            torch.as_tensor(y).long())
        losses.append(float(loss))
    return losses, unshard_tree(rp, specs, mesh)


def device_steps(make, which):
    """Two trainer steps (windows drawn from one seeded generator) of FSDP
    4, dp 2 x ep 2 (MoE), dp 2 x pp 2 (1F1B, M 2) or dp 1 x sp 2 (the
    plain ring, or with "sp_pallas" the ring kernels' plain versions; over
    one process the replicated step, over two the per-rank one), or two
    GPipe steps (dp 2 x pp 2, M 2, fixed batches): (losses, the whole
    parameters after them)."""
    from linalg_tpu_torch.parallel import (fsdp_param_specs,
                                           make_ep_device_train_step,
                                           make_fsdp_device_train_step,
                                           make_pp_device_train_step,
                                           moe_param_specs, pp_param_specs)
    from linalg_tpu_torch.parallel import sharding as tsh

    data = torch.as_tensor(np.random.default_rng(5).integers(0, 17, 2048))
    gen = torch.Generator().manual_seed(0)
    if which == "fsdp":
        cfg = Cfg64(**WIDE)
        params = _params64(cfg)
        mesh = make((4,), ("fsdp",))
        specs = fsdp_param_specs(params, 4)
        step = make_fsdp_device_train_step(cfg, mesh, params, 8, **STEP_KW)
    elif which == "ep":
        cfg = MoE64(**TINY, n_experts=4, router_top_k=2)
        params = _params64(cfg, moe=True)
        mesh = make((2, 2), ("dp", "ep"))
        specs = moe_param_specs(cfg)
        step = make_ep_device_train_step(cfg, mesh, 8, **STEP_KW)
    elif which == "gpipe":  # autograd through the stages' ppermutes
        from linalg_tpu_torch.parallel import make_pp_train_step

        cfg = Cfg64(**{**TINY, "n_layers": 4})
        mesh = make((2, 2), ("dp", "pp"))
        specs = pp_param_specs("dp")
        rp = shard_tree(_params64(cfg), specs, mesh)
        ro = [None if p is None else adamw_init(p) for p in rp]
        step = make_pp_train_step(cfg, mesh, 2, lr=1e-2, dp_axis="dp")
        losses = []
        for x, y in _batches()[:2]:
            rp, ro, loss = step(rp, ro, torch.as_tensor(x).long(),
                                torch.as_tensor(y).long())
            losses.append(float(loss))
        return losses, unshard_tree(rp, specs, mesh)
    elif which == "pp":
        cfg = Cfg64(**{**TINY, "n_layers": 4})
        params = _params64(cfg)
        mesh = make((2, 2), ("dp", "pp"))
        specs = pp_param_specs("dp")
        step = make_pp_device_train_step(cfg, mesh, 8, n_microbatches=2,
                                         **STEP_KW)
    else:
        cfg = Cfg64(**{**TINY, "pos": "rope"})
        params = _params64(cfg)
        mesh = make((1, 2), ("dp", "sp"))
        pallas = which == "sp_pallas"
        if not mesh.spans_processes:  # the one-process step, replicated
            step = tsh.make_sp_device_train_step(cfg, mesh, 8, pallas=pallas,
                                                 **STEP_KW)
            opt, losses = adamw_init(params), []
            for _ in range(2):
                params, opt, gen, loss = step(params, opt, data, gen)
                losses.append(float(loss))
            return losses, params
        specs = tsh.sp_param_specs(cfg)
        step = tsh.make_sp_ranks_device_train_step(cfg, mesh, 8,
                                                   pallas=pallas, **STEP_KW)
    rp = shard_tree(params, specs, mesh)
    ro = [None if p is None else adamw_init(p) for p in rp]
    losses = []
    for _ in range(2):
        rp, ro, gen, loss = step(rp, ro, data, gen)
        losses.append(float(loss))
    return losses, unshard_tree(rp, specs, mesh)


# -- (d) the CLI, (e) the refusals, (g) the kernel ring --------------------


def cli_argv(ckpt, log, sp=False):
    """The CLI's dp 2 x tp 2 run, or with ``sp`` the same model under --sp
    2 --ring pallas."""
    axes = (["--sp", "2", "--ring", "pallas"] if sp else
            ["--dp", "2", "--tp", "2"])
    return ["--train", *axes, "--steps", "3", "--eval_every", "3",
            "--d_model", "32", "--layers", "2", "--heads", "4", "--ctx_len",
            "16", "--batch_size", "4", "--device", "cpu", "--ckpt_dir",
            str(ckpt), "--log_file", str(log)]


def cli_run(ckpt, log, sp=False):
    """``apps.gpt.main`` of ``cli_argv``: what it printed."""
    from linalg_tpu_torch.apps import gpt as tapp

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tapp.main(cli_argv(ckpt, log, sp))
    return buf.getvalue()


def qkvw(n, dtype, B=2, h=2, Tl=8, d=8, seed=0):
    """q, k, v and a cotangent w, (B, h, n Tl, d) from a numpy seed (float32
    draws, as tests/test_torch_ring.py makes them), as ``dtype`` tensors."""
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal((B, h, n * Tl, d)).astype(
        np.float32), dtype=dtype) for _ in range(4)]


def _slopes():
    from linalg_tpu_torch.nn.positional import alibi_slopes

    return tuple(float(s) for s in alibi_slopes(2))


# name: ring options (Tl 8 a rank: window 12 reaches one chunk back)
RING_CASES = {"causal": {}, "window12": {"window": 12},
              "alibi": {"slopes": "alibi"}}
RING_NS = (2, 4)
RING_DTYPES = {"f32": torch.float32, "f64": torch.float64}


def ring_case(make, n, name, dtype):
    """``ring_attention_pallas_ranks`` (the kernels' plain versions) over a
    (n,) mesh on ``qkvw(n, seed 40 + n)``, the loss sum(o * w) over this
    process's ranks on the tape: {"o/r", "dq/r", "dk/r", "dv/r"} of this
    process's ranks."""
    from linalg_tpu_torch.parallel.ring_pallas import (
        ring_attention_pallas_ranks)

    kw = dict(RING_CASES[name])
    if "slopes" in kw:
        kw["slopes"] = _slopes()
    mesh = make((n,), ("sp",))
    q, k, v, w = qkvw(n, dtype, seed=40 + n)
    cut = [[x[:, :, r * 8:(r + 1) * 8].clone().requires_grad_(True)
            if mesh.is_local(r) else None for r in range(n)]
           for x in (q, k, v)]
    with taped() as tape:
        outs = ring_attention_pallas_ranks(*cut, mesh, plain=True, **kw)
        loss = tape.tie(sum((outs[r] * w[:, :, r * 8:(r + 1) * 8]).sum()
                            for r in mesh.local_ranks))
    mine = [x[r] for x in cut for r in mesh.local_ranks]
    grads = torch.autograd.grad(loss, mine + [tape.root])
    arrays, m = {}, len(mesh.local_ranks)
    for i, r in enumerate(mesh.local_ranks):
        arrays[f"o/{r}"] = _np(outs[r])
        for j, g in enumerate(("dq", "dk", "dv")):
            arrays[f"{g}/{r}"] = _np(grads[j * m + i])
    return arrays


def ring_global(make):
    """``make_ring_attention_pallas`` over a (1, 2) dp x sp mesh across
    the processes, on global tensors: the output."""
    from linalg_tpu_torch.parallel import make_ring_attention_pallas

    q, k, v, _ = qkvw(2, torch.float64, seed=7)
    return _np(make_ring_attention_pallas(make((1, 2), ("dp", "sp")))(q, k,
                                                                      v))


def _untaped_ring(make):
    """The per-rank kernel ring across processes under autograd, outside
    ``taped()``."""
    from linalg_tpu_torch.parallel.ring_pallas import (
        ring_attention_pallas_ranks)

    mesh = make((2,), ("sp",))
    q = [torch.zeros(1, 1, 8, 8, requires_grad=True) if mesh.is_local(r)
         else None for r in range(2)]
    ring_attention_pallas_ranks(q, q, q, mesh)


def refusals(make):
    """The kernel ring over a mesh across processes (it runs: None), the
    per-rank kernel ring under autograd outside a tape and the serving
    engine over such a mesh (they refuse): {case: None or [exception
    type, message]}."""
    from linalg_tpu_torch.serve.engine import ServeEngine

    got = {}

    def catch(name, fn):
        try:
            fn()
            got[name] = None
        except Exception as e:  # the refusal is the result
            got[name] = [type(e).__name__, str(e)]

    catch("ring", lambda: ring_global(make))
    catch("ring_untaped", lambda: _untaped_ring(make))
    cfg = tgpt.GPTConfig(**TINY)
    catch("serve", lambda: ServeEngine(
        tgpt.init_gpt_params(cfg, seed=0), cfg, n_slots=2,
        mesh=make((1, 2), ("dp", "tp")), device="cpu"))
    return got


def main():
    from linalg_tpu_torch.parallel import init_distributed, make_mesh
    from linalg_tpu_torch.parallel.distributed import process_index

    url, rank, out_dir, group_s = (sys.argv[1], int(sys.argv[2]),
                                   pathlib.Path(sys.argv[3]),
                                   float(sys.argv[4]))
    torch.set_num_threads(2)
    assert init_distributed(url, 2, rank, backend="gloo", timeout_s=group_s)
    f64_port(dict(np.load(out_dir / "sinusoidal.npz")))

    def make(shape, names):
        return make_mesh(shape, names, device_type="cpu")

    res = {"rank": process_index(), "collectives": {}, "mesh": {}}
    arrays = {}
    mesh = make((2, 4), ("dp", "tp"))
    res["mesh"] = {"rank_process": mesh.rank_process,
                   "local_ranks": mesh.local_ranks,
                   "devices": [None if d is None else str(d)
                               for d in mesh.rank_devices]}
    for name in COLLECTIVES:
        a, info = collective_case(make, name)
        res["collectives"][name] = info
        arrays.update({f"coll/{name}/{k}": v for k, v in a.items()})
    losses, params = dp_tp_steps(make)
    res["dp_tp"] = losses
    arrays.update({f"dp_tp/{k}": v for k, v in flat(params).items()})
    res["steps"] = {}
    for which in STEPS:
        losses, params = device_steps(make, which)
        res["steps"][which] = losses
        arrays.update({f"{which}/{k}": v for k, v in flat(params).items()})
    res["refusals"] = refusals(make)
    arrays["ring_global"] = ring_global(make)
    for n in RING_NS:
        for name in RING_CASES:
            for dt, dtype in RING_DTYPES.items():
                a = ring_case(make, n, name, dtype)
                arrays.update({f"ring/{n}/{name}/{dt}/{k}": v
                               for k, v in a.items()})
    res["cli_stdout"] = cli_run(out_dir / "cli_ck", out_dir / "cli.jsonl")
    res["sp_cli_stdout"] = cli_run(out_dir / "sp_ck", out_dir / "sp.jsonl",
                                   sp=True)
    res["jax"] = "jax" in sys.modules or any(
        m.startswith("linalg_tpu.") for m in sys.modules)
    np.savez(out_dir / f"arrays{rank}.npz", **arrays)
    (out_dir / f"res{rank}.json").write_text(json.dumps(res))
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main()
