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
  (1F1B) and dp 1 x sp 2 (the plain ring), and two GPipe steps (autograd
  through the stages' ppermutes), against the one-process port, which the
  other parallel test files hold against JAX;
- (d) ``apps.gpt.main(["--train", "--dp", "2", "--tp", "2", ...])`` in both
  processes: process 0 logs the one-process run's losses, and its one
  checkpoint loads in both packages;
- (e) the refusals: the kernel ring, ``ServeEngine(mesh=...)`` and ``--sp
  --ring pallas`` over a mesh across processes;
- (f) without a group: ``make_mesh()`` deals the ranks over faked lists of
  cards and shares one card among all ranks.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_process_child as child
from linalg_tpu.nn import functional as jF
from linalg_tpu.parallel import sharding as jsh
from linalg_tpu.train import checkpoint as jckpt
from linalg_tpu.train.optim import adamw_init as jadamw_init
from linalg_tpu_torch.parallel import make_mesh
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
    """(e): no kernel ring, no serving engine and no ``--ring pallas``
    training over a mesh whose ranks lie in two processes."""
    res, _, _ = runs
    for r in RANKS:
        got = res[r]["refusals"]
        assert got["ring"][0] == "NotImplementedError"
        assert "--ring xla" in got["ring"][1]
        assert "Left for later" in got["ring"][1]
        assert got["sp_pallas"] == got["ring"]
        assert got["serve"][0] == "ValueError"
        assert "spans processes [0, 1]" in got["serve"][1]


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
