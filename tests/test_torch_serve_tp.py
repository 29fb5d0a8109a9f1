"""Tensor-parallel serving of the port (``ServeEngine(mesh=...)``, ``--serve
--tp``) against the JAX package's mesh engine, on the CPU.

Every case of ``tests/test_serve.py::TestServeTP`` runs through both
engines on (1, tp) meshes: the JAX engine on the conftest's virtual
devices, the port's ranks all on the CPU. Both in float64 (the ``f64``
fixture of ``torch_parallel_common``, plus the JAX engine module's
float32 logits buffer and block-forward logits in float64: ``f64e``),
greedy: the port's tokens must equal the JAX mesh engine's and the port's
unsharded engine's. Beyond JAX's
cases: tp 2, the ``kv_heads % tp != 0`` grouping, more ranks than heads,
uneven head groups, a windowed model (slot cache under a mesh),
registered and automatic prefixes, chunked prefill and top-k sampling, and
every refusal of a mesh composition with the JAX engine's message.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_tpu.models import speculative as jspec
from linalg_tpu.models.moe import MoEGPTConfig as JMoE
from linalg_tpu.models.moe import init_moe_params as jinit_moe
from linalg_tpu.serve import engine as jengine
from linalg_tpu.serve import Request as JRequest
from linalg_tpu.serve import ServeEngine as JEngine
from linalg_tpu.train import checkpoint as jckpt
from linalg_tpu_torch.models.moe import MoEGPTConfig as TMoE
from linalg_tpu_torch.models.moe import init_moe_params as tinit_moe
from linalg_tpu_torch.parallel import collectives, tp_kv_heads
from linalg_tpu_torch.serve import Request, ServeEngine
from torch_parallel_common import both64, f64, jmesh, tmesh  # noqa: F401

torch.set_num_threads(2)

# tests/test_serve.py's CFG (2 heads: a tp 4 mesh leaves two ranks
# without a head) and its GQA/RoPE config
BASE = dict(vocab_size=31, d_model=32, n_heads=2, n_layers=2, ctx_len=64)
GQA = dict(vocab_size=31, d_model=32, n_heads=4, n_layers=2, ctx_len=64,
           n_kv_heads=2, pos="rope")


@pytest.fixture
def f64e(f64, monkeypatch):
    """``f64`` and the float32 casts of the JAX engine (its logits buffer)
    and of its block forward (admission extensions) redirected to
    float64, as ``f64`` redirects the models'."""
    proxy = types.SimpleNamespace(
        **{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")})
    proxy.float32 = jnp.float64
    for mod in (jengine, jspec):
        monkeypatch.setattr(mod, "jnp", proxy)


def prompts(seed, n, V=31, lo=3, hi=12):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V, size=rng.integers(lo, hi)).tolist()
            for _ in range(n)]


def run_jax(jp, jc, ps, n, tp=None, **kw):
    mesh = None if tp is None else jmesh((1, tp), ("dp", "tp"))
    eng = JEngine(jp, jc, n_slots=2, chunk=4, top_k=1, mesh=mesh, **kw)
    ids = [eng.submit(JRequest(p, n)) for p in ps]
    done = {c.request_id: c.tokens for c in eng.run()}
    return [done[i] for i in ids]


def run_port(tp_, tc, ps, n, tp=None, prefix=None, **kw):
    mesh = None if tp is None else tmesh((1, tp), ("dp", "tp"))
    kw = {"top_k": 1, **kw}
    eng = ServeEngine(tp_, tc, n_slots=2, chunk=4, mesh=mesh, device="cpu",
                      **kw)
    pid = None if prefix is None else eng.register_prefix(prefix)
    ids = [eng.submit(Request(p, n, prefix_id=pid)) for p in ps]
    done = {c.request_id: c.tokens for c in eng.run()}
    return [done[i] for i in ids]


@pytest.mark.parametrize("name,kw,n_prompts,n,seed", [
    ("matches_unsharded", BASE, 4, 8, 0),
    ("gqa_rope", GQA, 3, 6, 1),
], ids=["matches_unsharded", "gqa_rope"])
@pytest.mark.parametrize("tp", [2, 4])
def test_tokens_equal_jax_mesh_and_unsharded(f64e, name, kw, n_prompts, n,
                                             seed, tp):
    """TestServeTP.test_matches_unsharded and test_gqa_rope_tp: tp 4 over
    2 heads (two ranks hold none) and over 2 KV heads (each KV head
    replicated on the two ranks whose query heads read it), and tp 2."""
    jc, jp, tc, tparams = both64(**kw)
    ps = prompts(seed, n_prompts)
    want = run_jax(jp, jc, ps, n, tp=tp)
    assert run_jax(jp, jc, ps, n) == want
    collectives.clear()
    assert run_port(tparams, tc, ps, n, tp=tp) == want
    assert collectives["all_reduce"] > 0
    assert run_port(tparams, tc, ps, n) == want


def test_prefix_cache_under_tp(f64e):
    """TestServeTP.test_prefix_cache_under_tp: a registered prefix plus a
    suffix equals the whole prompt, in both packages' mesh engines."""
    jc, jp, tc, tparams = both64(**BASE)
    rng = np.random.default_rng(2)
    prefix = rng.integers(0, 31, size=rng.integers(10, 14)).tolist()
    suffix = rng.integers(0, 31, size=rng.integers(3, 6)).tolist()
    want = run_jax(jp, jc, [prefix + suffix], 6)
    mesh = jmesh((1, 4), ("dp", "tp"))
    eng = JEngine(jp, jc, n_slots=2, chunk=4, top_k=1, mesh=mesh)
    pid = eng.register_prefix(prefix)
    eng.submit(JRequest(suffix, 6, prefix_id=pid))
    assert eng.run()[0].tokens == want[0]
    assert run_port(tparams, tc, [suffix], 6, tp=4, prefix=prefix) == want


@pytest.mark.parametrize("case", [
    dict(cfg=dict(GQA, window=8), tp=2),
    dict(cfg=dict(BASE, n_heads=4, pos="alibi", ffn="swiglu"), tp=4),
    dict(cfg=dict(BASE, d_model=48, n_heads=6, n_kv_heads=3, pos="learned",
                  ffn="geglu"), tp=4),
], ids=["window_rope_tp2", "alibi_swiglu_tp4", "uneven_groups_tp4"])
def test_configs_and_compositions(f64e, case):
    """A windowed RoPE model stays on the slot cache under a mesh (the
    unsharded port engine serves it in ring mode, with the same tokens);
    ALiBi's per-head bias cut to each rank's heads; 6 heads over 4 ranks
    with 3 KV heads, where ranks keep one KV head per query head. Each
    with a registered prefix, ``auto_prefix`` and chunked prefill
    (prefill window 5)."""
    jc, jp, tc, tparams = both64(**case["cfg"])
    tp = case["tp"]
    ps = prompts(3, 3, hi=20)
    want = run_jax(jp, jc, ps, 6, tp=tp)
    assert run_port(tparams, tc, ps, 6) == want
    assert run_port(tparams, tc, ps, 6, tp=tp) == want
    assert run_port(tparams, tc, ps, 6, tp=tp, prefill_window=5) == want
    prefix = prompts(4, 1, lo=8, hi=9)[0]
    full = [prefix + p for p in ps]
    want_full = run_jax(jp, jc, full, 6, tp=tp)
    assert run_port(tparams, tc, ps, 6, tp=tp, prefix=prefix) == want_full
    mesh = tmesh((1, tp), ("dp", "tp"))
    eng = ServeEngine(tparams, tc, n_slots=2, chunk=4, top_k=1, mesh=mesh,
                      auto_prefix=True, device="cpu")
    eng.register_prefix(prefix)
    ids = [eng.submit(Request(p, 6)) for p in full]
    done = {c.request_id: c.tokens for c in eng.run()}
    assert [done[i] for i in ids] == want_full


def test_top_k_sampling_equals_unsharded(f64e):
    """Sampling runs once, on tp rank 0's device, from the engine's
    generator: top-k 3 sampling draws the unsharded engine's tokens."""
    _, _, tc, tparams = both64(**GQA)
    ps = prompts(5, 4)
    kw = dict(top_k=3, seed=11)
    assert (run_port(tparams, tc, ps, 8, tp=4, **kw)
            == run_port(tparams, tc, ps, 8, **kw))


def test_kv_heads_per_rank():
    from linalg_tpu_torch.models.gpt import GPTConfig

    cfg = GPTConfig(**GQA)
    assert [tp_kv_heads(cfg, 2, r) for r in range(2)] == [[0], [1]]
    assert [tp_kv_heads(cfg, 4, r) for r in range(4)] == [[0], [0], [1],
                                                          [1]]
    six = GPTConfig(**dict(BASE, d_model=48, n_heads=6, n_kv_heads=3))
    # heads {0}, {1, 2}, {3}, {4, 5}: rank 1 reads KV 0 and 1 unevenly
    assert [tp_kv_heads(six, 4, r) for r in range(4)] == [[0], [0, 1], [1],
                                                          [2]]
    assert tp_kv_heads(GPTConfig(**BASE), 4, 0) == []


def _messages(make):
    """The ValueError message of each refused mesh composition."""
    out = []
    for kw in (dict(quant="int8"), dict(paged=True), dict(max_loras=2),
               dict(speculative=2)):
        with pytest.raises(ValueError) as e:
            make(**kw)
        out.append(str(e.value))
    return out


def test_refusals_carry_jax_messages():
    from linalg_tpu.models.gpt import GPTConfig as JCfg
    from linalg_tpu.models.gpt import init_gpt_params as jinit
    from linalg_tpu_torch.models.gpt import GPTConfig, init_gpt_params

    jc, tc = JCfg(**BASE), GPTConfig(**BASE)
    jp, tparams = jinit(jc, seed=0), init_gpt_params(tc, seed=0)
    jm, tm = jmesh((1, 4), ("dp", "tp")), tmesh((1, 4), ("dp", "tp"))
    want = _messages(lambda **kw: JEngine(jp, jc, mesh=jm, **kw))
    got = _messages(lambda **kw: ServeEngine(tparams, tc, mesh=tm,
                                             device="cpu", **kw))
    assert got == want
    assert "full-precision dense GPT" in got[0]
    # an MoE model and a mesh without a 'tp' axis
    moe = dict(vocab_size=31, d_model=32, n_heads=2, n_layers=2, ctx_len=64,
               n_experts=2)
    for make, bad in (
            (lambda m: JEngine(jinit_moe(JMoE(**moe), seed=0), JMoE(**moe),
                               mesh=m), jmesh((4,), ("x",))),
            (lambda m: ServeEngine(tinit_moe(TMoE(**moe), seed=0),
                                   TMoE(**moe), mesh=m, device="cpu"),
             tmesh((4,), ("x",)))):
        with pytest.raises(ValueError, match="dense GPT"):
            make(bad)
    for make, bad in ((lambda m: JEngine(jp, jc, mesh=m),
                       jmesh((4,), ("x",))),
                      (lambda m: ServeEngine(tparams, tc, mesh=m,
                                             device="cpu"),
                       tmesh((4,), ("x",)))):
        with pytest.raises(ValueError, match="serving mesh needs a 'tp' "
                                             "axis"):
            make(bad)


def test_serve_cli_tp_matches_jax_cli(tmp_path, capsys):
    """``--serve --tp 4`` on one JAX-saved checkpoint: the port's CLI (4
    ranks on the CPU) writes the JAX CLI's rows (4 virtual devices), and
    under ``--tp`` both print the same fallbacks for ``--paged`` and
    ``--speculative``."""
    from linalg_tpu.apps import gpt as japp
    from linalg_tpu.models.gpt import GPTConfig as JCfg
    from linalg_tpu.models.gpt import init_gpt_params as jinit
    from linalg_tpu_torch.apps import gpt as tapp

    chars = "abcdefghijklmnopqrstuvwxyz .,!?"
    stoi = {c: i for i, c in enumerate(chars)}
    jckpt.save_ckpt(tmp_path, jinit(JCfg(**BASE), seed=7), JCfg(**BASE),
                    stoi, {i: c for c, i in stoi.items()})
    (tmp_path / "p.txt").write_text("hello there\nabc\n", encoding="utf-8")
    common = ["--serve", "--ckpt_dir", str(tmp_path), "--prompts",
              str(tmp_path / "p.txt"), "--gen_tokens", "6", "--n_slots", "2",
              "--chunk", "4", "--top_k", "1", "--tp", "4", "--paged",
              "--speculative", "2"]
    rows, notes = {}, {}
    for name, run, extra in (
            ("jax", lambda a: japp.serve_cli(japp.build_parser().parse_args(
                a)), []),
            ("port", tapp.main, ["--device", "cpu"])):
        out = tmp_path / f"{name}.jsonl"
        run(common + ["--out", str(out)] + extra)
        notes[name] = [ln for ln in capsys.readouterr().out.splitlines()
                       if ln.startswith("(--")]
        rows[name] = [json.loads(ln)["text"]
                      for ln in out.read_text().splitlines()]
    assert rows["port"] == rows["jax"] and len(rows["port"]) == 2
    assert notes["port"] == notes["jax"] and len(notes["port"]) == 2
    assert jax.device_count() >= 4
