"""The port's multi-process initialisation (``parallel/distributed.py``)
and its ``torch.distributed.checkpoint`` backend (``save_ckpt_orbax`` /
``load_ckpt_orbax``) against the JAX package's ``parallel/distributed.py``
and orbax backend, on the CPU.

- The single-process modes of both packages side by side (JAX's
  ``tests/test_parallel.py::TestDistributed``): no process group, the
  whole batch, tp capped to the local device count.
- Two interpreters that import no JAX start one Gloo group through a
  ``file://`` rendezvous in the test's own directory (no TCP port, so
  parallel test workers cannot clash): each sees the pair, its half of the
  batch and the job's mesh shape, and the two save and reload one DCP
  checkpoint collectively. Each child and its group have their own
  timeouts (``torch_parallel_common``'s 600 s and 300 s): a hang fails
  the test. The children's Gloo is pinned to the loopback interface
  (``run_children``), whatever address the host name resolves to.
- DCP beside orbax: one parameter tree saved by each package, sidecars
  equal as JSON, each reloading what it saved (float32, bfloat16 and an
  MoE config's extra meta).
"""

import json
import sys

import jax
import numpy as np
import pytest
import torch

from linalg_tpu.models.gpt import GPTConfig as JCfg
from linalg_tpu.models.moe import MoEGPTConfig as JMoE
from linalg_tpu.train import checkpoint as jckpt
from linalg_tpu_torch import parallel as tpar
from linalg_tpu_torch.models.gpt import GPTConfig, init_gpt_params
from linalg_tpu_torch.models.moe import MoEGPTConfig, init_moe_params
from linalg_tpu_torch.parallel import distributed as tdist
from linalg_tpu_torch.train import checkpoint as tckpt
from torch_parallel_common import GROUP_TIMEOUT_S, child_env, run_children


def test_init_noop_single_process():
    from linalg_tpu.parallel import init_distributed, is_distributed

    assert init_distributed() is False and is_distributed() is False
    assert tpar.init_distributed() is False
    assert tpar.is_distributed() is False


def test_host_local_batch_slice():
    from linalg_tpu.parallel import host_local_batch_slice

    assert host_local_batch_slice(64) == (0, 64)
    assert tpar.host_local_batch_slice(64) == (0, 64)


def test_global_mesh_shape_caps_tp_to_local():
    from linalg_tpu.parallel import global_mesh_shape

    dp, tp = global_mesh_shape(n_heads=4)
    assert dp * tp == len(jax.devices()) and 4 % tp == 0
    assert tp <= len(jax.local_devices())
    # the port without a card: one process of one CPU device
    assert tpar.global_mesh_shape(n_heads=4) == (1, 1)


def test_no_quiet_gloo_without_a_card(monkeypatch, tmp_path):
    """A launcher environment with no card and no request for the CPU
    raises before any group starts; so does asking for the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    url = f"file://{tmp_path}/rdv"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdist.init_distributed(url, 2, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdist.init_distributed(url, 2, 0, device="cuda")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdist.init_distributed()
    monkeypatch.setenv("WORLD_SIZE", "1")  # torchrun with one process
    assert tdist.init_distributed() is False


CHILD = r"""
import json, sys
import torch
import torch.distributed as dist
from linalg_tpu_torch.models.gpt import GPTConfig, init_gpt_params
from linalg_tpu_torch.parallel import (global_mesh_shape,
                                       host_local_batch_slice,
                                       init_distributed, is_distributed)
from linalg_tpu_torch.train.checkpoint import (_flat, load_ckpt_orbax,
                                               save_ckpt_orbax)

url, rank, ckpt, group_s = (sys.argv[1], int(sys.argv[2]), sys.argv[3],
                            float(sys.argv[4]))
if rank == 0:  # explicit arguments
    ok = init_distributed(url, 2, 0, backend="gloo", timeout_s=group_s)
else:  # JAX's launcher environment
    ok = init_distributed(device="cpu", timeout_s=group_s)
cfg = GPTConfig(vocab_size=11, d_model=16, n_heads=2, n_layers=2,
                ctx_len=8)
params = init_gpt_params(cfg, seed=4)
save_ckpt_orbax(ckpt, params, cfg, {"a": 0}, {0: "a"})
back, cfg2, _, _ = load_ckpt_orbax(ckpt, device="cpu")
want, got = _flat(params), _flat(back)
same = cfg2 == cfg and want.keys() == got.keys() and all(
    torch.equal(want[k], got[k]) for k in want)
print(json.dumps({"ok": ok, "dist": is_distributed(),
                  "world": dist.get_world_size(), "rank": dist.get_rank(),
                  "slice": host_local_batch_slice(64),
                  "mesh": global_mesh_shape(4), "dcp": same,
                  "jax": "jax" in sys.modules
                  or any(m.startswith("linalg_tpu.") for m in sys.modules)}))
dist.destroy_process_group()
"""


def test_two_process_gloo_group(tmp_path):
    url = f"file://{tmp_path}/rendezvous"
    envs = [child_env(), child_env(JAX_COORDINATOR_ADDRESS=url,
                                   JAX_NUM_PROCESSES="2", JAX_PROCESS_ID="1")]
    runs = run_children(
        [["-c", CHILD, url, str(rank), str(tmp_path / "ckpt"),
          str(GROUP_TIMEOUT_S)] for rank in range(2)], envs, tmp_path)
    got = [json.loads(r.stdout.strip().splitlines()[-1]) for r in runs]
    for rank, g in enumerate(got):
        assert g == {"ok": True, "dist": True, "world": 2, "rank": rank,
                     "slice": [32 * rank, 32], "mesh": [2, 1], "dcp": True,
                     "jax": False}


def _trees(moe, bf16):
    kw = dict(vocab_size=13, d_model=16, n_heads=2, n_layers=2, ctx_len=8,
              dtype="bfloat16" if bf16 else "float32")
    if moe:
        kw.update(n_experts=2, router_top_k=2, capacity_factor=1.5)
        tc, jc = MoEGPTConfig(**kw), JMoE(**kw)
        params = init_moe_params(tc, seed=1)
    else:
        kw.update(ffn="swiglu", pos="learned", n_kv_heads=1, window=4)
        tc, jc = GPTConfig(**kw), JCfg(**kw)
        params = init_gpt_params(tc, seed=1)
    if bf16:
        params = {k: ({kk: vv.bfloat16() for kk, vv in v.items()}
                      if isinstance(v, dict) else v.bfloat16())
                  for k, v in params.items()}
    return tc, jc, params


@pytest.mark.parametrize("moe,bf16", [(False, False), (False, True),
                                      (True, False)],
                         ids=["dense", "dense_bf16", "moe"])
def test_dcp_beside_orbax(tmp_path, moe, bf16):
    tc, jc, params = _trees(moe, bf16)
    stoi = {c: i for i, c in enumerate("abcdefghijklm")}
    itos = {i: c for c, i in stoi.items()}

    def host(t):
        return np.asarray(t.float().numpy() if bf16 else t.numpy())

    jparams = jax.tree.map(
        lambda t: jax.numpy.asarray(host(t), jax.numpy.bfloat16 if bf16
                                    else jax.numpy.float32), params)
    jckpt.save_ckpt_orbax(tmp_path / "j", jparams, jc, stoi, itos)
    path = tckpt.save_ckpt_orbax(tmp_path / "t", params, tc, stoi, itos)
    assert path == (tmp_path / "t" / tckpt.DCP_NAME).resolve()
    metas = [json.loads((tmp_path / d / tckpt.META_NAME).read_text())
             for d in ("j", "t")]
    assert metas[0] == metas[1]
    back, cfg, s2, i2 = tckpt.load_ckpt_orbax(tmp_path / "t", device="cpu")
    assert cfg == tc and s2 == stoi and i2 == itos
    want, got = tckpt._flat(params), tckpt._flat(back)
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype and torch.equal(want[k], got[k])
    jback, jcfg, _, _ = jckpt.load_ckpt_orbax(tmp_path / "j")
    assert jcfg == jc
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(jback)):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    # the formats do not read each other
    with pytest.raises(Exception):
        tckpt.load_ckpt_orbax(tmp_path / "j", device="cpu")


def test_dcp_loads_onto_the_card_by_default(tmp_path, monkeypatch):
    """Without ``device`` the tensors go to the card; with no card that
    raises rather than loading onto the CPU."""
    tc, _, params = _trees(False, False)
    tckpt.save_ckpt_orbax(tmp_path, params, tc, {}, {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tckpt.load_ckpt_orbax(tmp_path)
