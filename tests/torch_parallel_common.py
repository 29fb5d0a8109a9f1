"""Shared set-up of the sharded-trainer parity tests (tests/test_torch_
sharding.py, test_torch_fsdp.py, test_torch_pipeline.py,
test_torch_expert.py): float64 configs of both packages, meshes of the
conftest's virtual devices and of CPU ranks, and the ``f64`` fixture.

Both packages cast logits (and the MoE router) to float32 and build RoPE
tables in float32, whatever the compute dtype. For the float64 parity the
fixture redirects those casts to float64: the JAX modules' ``jnp.float32``
(a proxy of ``jnp`` with float32 -> float64, in every module on the
sharded path), the port's ``_head`` (and the MoE's ``_ROUTER_DTYPE``), and
RoPE tables formed in float64 in both; the port takes the JAX package's
float32 sinusoidal table (PyTorch's float32 sin/cos differ from XLA's by
an ulp). Weights are the port's float32 ``init_*_params`` (bit-equal to
the JAX package's, pinned by test_torch_train.py and test_torch_moe.py)
widened to float64 for both.
"""

import concurrent.futures
import dataclasses
import os
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_tpu.models import gpt as jgpt
from linalg_tpu.models import moe as jmoe
from linalg_tpu.nn import functional as jF
from linalg_tpu.parallel import expert as jexpert
from linalg_tpu.parallel import fsdp as jfsdp
from linalg_tpu.parallel import make_mesh as jmake_mesh
from linalg_tpu.parallel import pipeline as jpipe
from linalg_tpu.parallel import sharding as jsharding
from linalg_tpu_torch.models import gpt as tgpt
from linalg_tpu_torch.models import moe as tmoe
from linalg_tpu_torch.parallel import expert as texpert
from linalg_tpu_torch.parallel import make_mesh
from linalg_tpu_torch.parallel import pipeline as tpipe


REPO = pathlib.Path(__file__).resolve().parents[1]
# a child's whole run, and the process group's timeout inside it: room for
# the children of several test files started at once next to the other
# test workers
CHILD_TIMEOUT_S = 600
GROUP_TIMEOUT_S = 300


def child_env(**extra):
    """The environment of a child interpreter: the caller's without any
    launcher variable (JAX's or torchrun's), the repo on the path, Gloo
    and its TCP transport pinned to the loopback interface (the host name
    may resolve to an address the machine cannot reach), few threads."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "MASTER_", "WORLD_SIZE", "RANK",
                                "LOCAL_RANK", "LOCAL_WORLD_SIZE"))}
    env.update(PYTHONPATH=str(REPO), GLOO_SOCKET_IFNAME="lo",
               TP_SOCKET_IFNAME="lo", OMP_NUM_THREADS="2")
    env.update(extra)
    return env


def run_children(argvs, envs, cwd, timeout=CHILD_TIMEOUT_S):
    """Run one interpreter per argument list (``[sys.executable, *argv]``)
    at once, each with its environment; return their CompletedProcesses
    once all have ended, or fail with each child's return code and the
    last 3000 characters of its stderr."""
    def child(i):
        try:
            return subprocess.run([sys.executable, *argvs[i]], env=envs[i],
                                  cwd=cwd, capture_output=True, text=True,
                                  timeout=timeout)
        except subprocess.TimeoutExpired as e:
            err = e.stderr.decode() if isinstance(e.stderr, bytes) else (
                e.stderr or "")
            return subprocess.CompletedProcess(e.cmd, f"timeout {timeout} s",
                                               "", err)

    with concurrent.futures.ThreadPoolExecutor(len(argvs)) as pool:
        runs = list(pool.map(child, range(len(argvs))))
    if any(r.returncode != 0 for r in runs):
        raise AssertionError("\n".join(
            f"child {i}: return code {r.returncode}\n{r.stderr[-3000:]}"
            for i, r in enumerate(runs)))
    return runs


@dataclasses.dataclass(frozen=True)
class JaxCfg64(jgpt.GPTConfig):
    @property
    def compute_dtype(self):
        return jnp.float64


@dataclasses.dataclass(frozen=True)
class PortCfg64(tgpt.GPTConfig):
    @property
    def compute_dtype(self):
        return torch.float64


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


def _keep_dtype_head(p, h, dt):
    return h @ p["tok_W"].to(dt).T + p["head_b"].to(dt)


@pytest.fixture
def f64(monkeypatch):
    """Float64 where both packages cast to float32 (see the module
    docstring)."""
    proxy = types.SimpleNamespace(
        **{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")})
    proxy.float32 = jnp.float64
    for mod in (jgpt, jmoe, jsharding, jpipe, jexpert, jfsdp):
        monkeypatch.setattr(mod, "jnp", proxy)
    for mod in (tgpt, tpipe, texpert, tmoe):
        monkeypatch.setattr(mod, "_head", _keep_dtype_head)
    monkeypatch.setattr(tmoe, "_ROUTER_DTYPE", torch.float64)

    def jtables(d, pos):
        ang = jnp.asarray(pos, jnp.float64)[..., None] / (
            10000.0 ** (jnp.arange(0, d, 2, dtype=jnp.float64) / d))
        return jnp.cos(ang), jnp.sin(ang)

    def ttables(d, pos):
        ang = torch.as_tensor(pos).double()[..., None] / (
            10000.0 ** (torch.arange(0, d, 2, dtype=torch.float64) / d))
        return torch.cos(ang), torch.sin(ang)

    for mod in (jgpt, jmoe, jpipe):
        monkeypatch.setattr(mod, "rope_tables", jtables)
    monkeypatch.setattr(tgpt, "rope_tables", ttables)
    def jsinus(n, d, device=None):
        return torch.tensor(np.asarray(jF.sinusoidal_encoding(n, d)))

    for mod in (tgpt, tmoe):
        monkeypatch.setattr(mod, "sinusoidal_encoding", jsinus)


def both64(moe=False, **kw):
    """(jax cfg, jax float64 params, port cfg, port float64 params) of one
    float32 draw."""
    if moe:
        jc, tc = JaxMoE64(**kw), PortMoE64(**kw)
        tp = tmoe.init_moe_params(tc, seed=123)
    else:
        jc, tc = JaxCfg64(**kw), PortCfg64(**kw)
        tp = tgpt.init_gpt_params(tc, seed=123)
    host = to_numpy(tp, np.float64)
    return (jc, jax.tree.map(jnp.asarray, host), tc,
            tgpt.params_from_numpy(host))


def to_numpy(tree, dtype=None):
    if isinstance(tree, dict):
        return {k: to_numpy(v, dtype) for k, v in tree.items()}
    a = np.asarray(tree.detach().cpu().numpy() if isinstance(
        tree, torch.Tensor) else tree)
    return a if dtype is None else a.astype(dtype)


def flat(tree, prefix=""):
    """{'layers/Wq': numpy array, ...} of a JAX or port tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = to_numpy(v)
    return out


def assert_trees_close(got, want, rtol=1e-9, atol=1e-13):
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def jmesh(shape, names):
    n = int(np.prod(shape))
    return jmake_mesh(shape, names, jax.devices()[:n])


def tmesh(shape, names):
    return make_mesh(shape, names, ["cpu"] * int(np.prod(shape)))


def ids(seed, B, T, V):
    """(x, y) int batches from a numpy seed."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, (B, T)).astype(np.int32),
            rng.integers(0, V, (B, T)).astype(np.int32))


def port_grads(loss_and_grads, rank_params, x, y, specs, mesh):
    """(loss, whole gradient tree) of a port sharded loss-and-grads
    function."""
    from linalg_tpu_torch.parallel import unshard_tree

    loss, grads = loss_and_grads(rank_params, torch.as_tensor(x).long(),
                                 torch.as_tensor(y).long())
    return float(loss), unshard_tree(grads, specs, mesh)
