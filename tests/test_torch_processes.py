"""Meshes that span processes: two interpreters that import no JAX join
one Gloo group through a ``file://`` rendezvous, deal the meshes' ranks
over their two CPU devices (``make_mesh(..., device_type="cpu")``) and run
the work of ``torch_process_child.py`` once for the module; the tests read
what each child wrote and hold it against the same work over one-process
meshes (and against the JAX package where it has the function):

- (a) each collective and its adjoint over (2, 2), (4,) and (3, 2) meshes
  split over the two processes (a (3, 2) group holds two ranks of one
  process and one of the other), equal to the one-process list version,
  and the calls each process counts (one a group that holds a rank of
  it);
- (b) three ``make_sharded_train_step`` steps on a (2, 4) dp x tp mesh, the
  losses and the gathered parameters against JAX's on ``jmesh((2, 4))``
  at rtol 1e-9 (float64);
- (c) two trainer steps each of FSDP 4, dp 2 x ep 2 (MoE), dp 2 x pp 2
  (1F1B) and dp 1 x sp 2 (the plain ring, and the ring kernels' plain
  versions with the chunks crossing by point-to-point messages), and two
  GPipe steps (autograd through the stages' ppermutes), against the
  one-process port, which the other parallel test files hold against
  JAX;
- (d) ``apps.gpt.main(["--train", "--dp", "2", "--tp", "2", ...])`` in both
  processes: process 0 logs the one-process run's losses, and its one
  checkpoint loads in both packages;
- (e) over a mesh across processes the kernel ring on global tensors runs
  (as the plain ring does there); the per-rank kernel ring under autograd
  outside ``taped()`` and ``ServeEngine(mesh=...)`` refuse;
- (f) without a group: ``make_mesh()`` deals the ranks over faked lists of
  cards and shares one card among all ranks;
- (g) ``ring_attention_pallas_ranks`` (K10/K11's plain versions) over (2,)
  and (4,) meshes split over the two processes, causal, window and ALiBi:
  outputs and gradients against JAX's ``make_ring_attention_pallas`` (its
  Pallas ring in interpret mode) at atol 1e-5 in float32, and bit-equal to
  the one-process port in float64;
- (h) ``apps.gpt.main(["--train", "--sp", "2", "--ring", "pallas", ...])``
  in both processes: process 0 logs the one-process run's losses.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_process_child as child
from linalg_tpu.nn import functional as jF
from linalg_tpu.parallel import make_mesh as jmake_mesh
from linalg_tpu.parallel import make_ring_attention_pallas as jring_pallas
from linalg_tpu.parallel import sharding as jsh
from linalg_tpu.train import checkpoint as jckpt
from linalg_tpu.train.optim import adamw_init as jadamw_init
from linalg_tpu_torch.parallel import make_mesh, make_ring_attention_pallas
from linalg_tpu_torch.parallel import mesh as tmesh_mod
from linalg_tpu_torch.parallel.distributed import global_mesh_shape
from linalg_tpu_torch.train import checkpoint as tckpt
from torch_parallel_common import (GROUP_TIMEOUT_S, assert_trees_close,  # noqa
                                   both64, child_env, f64, ids, jmesh,
                                   run_children)

torch.set_num_threads(2)
RANKS = (0, 1)
ADJOINT = {"all_gather": "reduce_scatter", "reduce_scatter": "all_gather"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({rank: result JSON}, {rank: arrays}, the children's directory)."""
    out = tmp_path_factory.mktemp("processes")
    np.savez(out / "sinusoidal.npz", **{
        f"{n}_{d}": np.asarray(jF.sinusoidal_encoding(n, d))
        for n, d in ((16, 32), (16, 64))})
    url = f"file://{out}/rendezvous"
    run_children([[child.__file__, url, str(r), str(out),
                   str(GROUP_TIMEOUT_S)] for r in RANKS],
                 [child_env() for _ in RANKS], out)
    res = {r: json.loads((out / f"res{r}.json").read_text()) for r in RANKS}
    arrays = {r: dict(np.load(out / f"arrays{r}.npz")) for r in RANKS}
    return res, arrays, out


def one_process(shape, names):
    return make_mesh(shape, names, ["cpu"] * int(np.prod(shape)))


def test_two_processes_hold_contiguous_blocks(runs):
    res, _, _ = runs
    for r in RANKS:
        assert res[r]["rank"] == r and res[r]["jax"] is False
        mesh = res[r]["mesh"]
        assert mesh["rank_process"] == [0] * 4 + [1] * 4
        assert mesh["local_ranks"] == list(range(4 * r, 4 * r + 4))
        assert mesh["devices"] == [
            "cpu" if p == r else None for p in mesh["rank_process"]]


@pytest.mark.parametrize("name", sorted(child.COLLECTIVES))
def test_collective_and_adjoint_across_processes(runs, name):
    res, arrays, _ = runs
    want, _ = child.collective_case(one_process, name)
    kind = child.COLLECTIVES[name][2]
    got = {}
    for r in RANKS:
        got.update({k[len(f"coll/{name}/"):]: v for k, v in arrays[r].items()
                    if k.startswith(f"coll/{name}/")})
        info = res[r]["collectives"][name]
        # one call a group holding a rank of this process, forward and
        # backward (the adjoint); CPU tensors stage nothing through the host
        calls = {kind: info["groups"]}
        adj = ADJOINT.get(kind, kind)
        calls[adj] = calls.get(adj, 0) + info["groups"]
        assert info["calls"] == calls
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-12,
                                   err_msg=k)


def _tree(arrays, prefix):
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


def _nest(flat_tree):
    out = {}
    for k, v in flat_tree.items():
        *head, leaf = k.split("/")
        node = out
        for h in head:
            node = node.setdefault(h, {})
        node[leaf] = v
    return out


def test_dp_tp_steps_match_jax(runs, f64):
    """(b): the losses and parameters of three dp x tp steps across two
    processes, as JAX's ``make_sharded_train_step`` on ``jmesh((2, 4))``."""
    res, arrays, _ = runs
    jc, jp, _, _ = both64(**child.TINY)
    jstep = jsh.make_sharded_train_step(jc, jmesh((2, 4), ("dp", "tp")),
                                        lr=1e-2, weight_decay=0.01)
    jo = jadamw_init(jp)
    jl = []
    for s in range(3):
        x, y = ids(s, 8, 16, 19)
        jp, jo, loss = jstep(jp, jo, jnp.asarray(x), jnp.asarray(y))
        jl.append(float(loss))
    for r in RANKS:
        np.testing.assert_allclose(res[r]["dp_tp"], jl, rtol=1e-9)
        assert_trees_close(_nest(_tree(arrays[r], "dp_tp/")), jp)


@pytest.mark.parametrize("which", child.STEPS)
def test_device_steps_match_one_process(runs, f64, which):
    """(c): two trainer steps across two processes, as the same steps with
    every rank in one process."""
    res, arrays, _ = runs
    losses, params = child.device_steps(one_process, which)
    for r in RANKS:
        np.testing.assert_allclose(res[r]["steps"][which], losses,
                                   rtol=1e-9)
        assert_trees_close(_nest(_tree(arrays[r], f"{which}/")), params,
                           atol=1e-12)


def _losses(log):
    rows = [json.loads(ln) for ln in open(log, encoding="utf-8")]
    return ([r["loss"] for r in rows if r["event"] == "train"],
            [r["val_loss"] for r in rows if r["event"] == "eval"])


def test_cli_trains_one_model_across_processes(runs, f64, tmp_path):
    """(d): process 0 logs what one process logs for the same mesh, process
    1 prints no step, and the one checkpoint loads in both packages."""
    res, _, out = runs
    one = child.cli_run(tmp_path / "ck", tmp_path / "log.jsonl")
    assert "mesh dp=2 tp=2: 4 ranks share cpu" in one
    lead, other = res[0]["cli_stdout"], res[1]["cli_stdout"]
    assert ("mesh dp=2 tp=2: 4 ranks over 2 processes (2 here on cpu); "
            "heads/FFN sharded") in lead
    assert "step" not in other and "saved best" not in other
    assert [ln for ln in lead.splitlines() if ln.startswith("step")] == [
        ln for ln in one.splitlines() if ln.startswith("step")]
    got, want = _losses(out / "cli.jsonl"), _losses(tmp_path / "log.jsonl")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5)
    assert [len(g) for g in got] == [len(w) for w in want] == [1, 1]
    tp_, cfg, _, _ = tckpt.load_ckpt(out / "cli_ck", device="cpu")
    t1, _, _, _ = tckpt.load_ckpt(tmp_path / "ck", device="cpu")
    jp, jcfg, _, _ = jckpt.load_ckpt(str(out / "cli_ck"))
    assert jcfg.d_model == cfg.d_model == 32
    assert_trees_close(jax.tree.map(np.asarray, jp), tp_, rtol=0, atol=0)
    assert_trees_close(tp_, t1, rtol=1e-4, atol=1e-6)


def test_refusals_across_processes(runs):
    """(e): over a mesh whose ranks lie in two processes the kernel ring on
    global tensors runs, as the plain ring does there (the whole ring in
    each process, equal to one process's); the per-rank kernel ring under
    autograd outside a tape and the serving engine refuse."""
    res, arrays, _ = runs
    q, k, v, _ = child.qkvw(2, torch.float64, seed=7)
    want = make_ring_attention_pallas(one_process((1, 2), ("dp", "sp")))(
        q, k, v).numpy()
    for r in RANKS:
        got = res[r]["refusals"]
        assert got["ring"] is None
        np.testing.assert_array_equal(arrays[r]["ring_global"], want)
        assert got["ring_untaped"][0] == "RuntimeError"
        assert "taped()" in got["ring_untaped"][1]
        assert got["serve"][0] == "ValueError"
        assert "spans processes [0, 1]" in got["serve"][1]


def _ring_arrays(arrays, n, name, dt):
    """The (o, dq, dk, dv) of a (g) case, each rank's rows from the process
    that holds it, concatenated along T."""
    prefix = f"ring/{n}/{name}/{dt}/"
    parts = {}
    for r in RANKS:
        parts.update({k[len(prefix):]: a for k, a in arrays[r].items()
                      if k.startswith(prefix)})
    assert len(parts) == 4 * n
    return [np.concatenate([parts[f"{what}/{x}"] for x in range(n)], axis=2)
            for what in ("o", "dq", "dk", "dv")]


def _ring_kw(name):
    kw = dict(child.RING_CASES[name])
    if "slopes" in kw:
        kw["slopes"] = child._slopes()
    return kw


@pytest.mark.parametrize("name", sorted(child.RING_CASES))
@pytest.mark.parametrize("n", child.RING_NS)
def test_kernel_ring_across_processes_matches_jax(runs, n, name):
    """(g), float32: the per-rank kernel ring over two processes against
    JAX's Pallas ring (interpret mode) on an (n,) mesh of the virtual
    devices, forward and all three gradients, atol 1e-5."""
    _, arrays, _ = runs
    arrs = [t.numpy() for t in child.qkvw(n, torch.float32, seed=40 + n)]

    def f(q, k, v, w):
        attn = jring_pallas(jmake_mesh((n,), ("sp",), jax.devices()[:n]),
                            **_ring_kw(name))
        out, vjp = jax.vjp(attn, q, k, v)
        return (out,) + vjp(w)

    want = [np.asarray(x) for x in jax.jit(f)(*map(jnp.asarray, arrs))]
    got = _ring_arrays(arrays, n, name, "f32")
    for what, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, err_msg=what)


@pytest.mark.parametrize("name", sorted(child.RING_CASES))
@pytest.mark.parametrize("n", child.RING_NS)
def test_kernel_ring_across_processes_equals_one_process(runs, n, name):
    """(g), float64: the per-rank kernel ring over two processes, bit for
    bit the one-process port's ring on the global tensors."""
    _, arrays, _ = runs
    q, k, v, w = (t.requires_grad_(True) for t in child.qkvw(
        n, torch.float64, seed=40 + n))
    out = make_ring_attention_pallas(one_process((n,), ("sp",)),
                                     **_ring_kw(name))(q, k, v)
    want = [out] + list(torch.autograd.grad(out, (q, k, v), w.detach()))
    got = _ring_arrays(arrays, n, name, "f64")
    for what, g, t in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_array_equal(g, t.detach().numpy(), err_msg=what)


def test_sp_kernel_ring_cli_across_processes(runs, f64, tmp_path):
    """(h): ``--sp 2 --ring pallas`` trains in both processes; process 0
    logs what one process logs for the same run, process 1 prints no
    step."""
    res, _, out = runs
    one = child.cli_run(tmp_path / "ck", tmp_path / "log.jsonl", sp=True)
    assert "mesh dp=1 sp=2: 2 ranks share cpu; ring kernels (K10/K11)" in one
    lead, other = res[0]["sp_cli_stdout"], res[1]["sp_cli_stdout"]
    assert ("mesh dp=1 sp=2: 2 ranks over 2 processes (1 here on cpu); ring "
            "kernels (K10/K11)") in lead
    assert "step" not in other and "saved best" not in other
    assert [ln for ln in lead.splitlines() if ln.startswith("step")] == [
        ln for ln in one.splitlines() if ln.startswith("step")]
    got, want = _losses(out / "sp.jsonl"), _losses(tmp_path / "log.jsonl")
    assert [len(g) for g in got] == [len(w) for w in want] == [1, 1]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5)


def test_make_mesh_deals_over_faked_cards(monkeypatch):
    """(f): without a group, ``make_mesh`` deals its ranks over the job's
    cards, each an equal contiguous block, and a tp group stays on one
    card where the sizes allow it (JAX's global_mesh_shape rule); one card
    takes every rank; a count that does not deal evenly raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cuda = [torch.device("cuda", i) for i in range(4)]
    for cards, shape, want in (
            (4, (2, 4), [cuda[r // 2] for r in range(8)]),
            (2, (2, 4), [cuda[r // 4] for r in range(8)]),
            (4, (2, 2), cuda),
            (4, (1, 2), cuda[:2]),
            (1, (2, 4), [cuda[0]] * 8)):
        monkeypatch.setattr(torch.cuda, "device_count", lambda c=cards: c)
        mesh = make_mesh(shape, ("dp", "tp"))
        assert mesh.rank_devices == want, (cards, shape)
        assert mesh.local_ranks == list(range(mesh.size))
        assert not mesh.spans_processes
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    with pytest.raises(ValueError, match="deal evenly"):
        make_mesh((2, 4), ("dp", "tp"))
    # a launcher's two processes on a host of four cards: two each; one
    # card shared by both where there is one
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert make_mesh(None, ("dp",)).rank_devices == cuda[2:]
    assert global_mesh_shape(4) == (1, 2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert make_mesh((4,), ("tp",), local=True).rank_devices == [cuda[0]] * 4
    # the serving mesh: this process's cards only, the same dealing
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    monkeypatch.delenv("LOCAL_RANK")
    assert tmesh_mod.make_mesh((1, 8), ("dp", "tp"),
                               local=True).rank_devices == [
        cuda[r // 2] for r in range(8)]
