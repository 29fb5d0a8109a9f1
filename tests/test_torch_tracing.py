"""The port's spans (``linalg_tpu_torch.utils.profiling.span``) in the
serving engine and the training step, on the CPU.

With no profiler recording a span is the shared no-op: nothing is entered
and nothing recorded. Under ``torch.profiler`` the engine's spans nest as
``serve.step`` > ``serve.admit`` (carrying its request id and prompt
length) > ``serve.prefill`` / ``serve.extend``, with ``serve.decode``,
``serve.fetch`` and ``serve.account`` after the admissions; the training
step's ``train.forward``, ``train.backward`` and ``train.optimizer``
follow in order inside ``train.step``. Tracing changes no served token
and no loss. The ``cuda`` test reads the device-timed spans on a card.
"""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from linalg_tpu_torch.models.gpt import GPTConfig, init_gpt_params
from linalg_tpu_torch.serve import Request, ServeEngine
from linalg_tpu_torch.train.optim import adamw_init
from linalg_tpu_torch.train.trainer import make_device_train_step
from linalg_tpu_torch.utils import profiling

torch.set_num_threads(2)

CFG = GPTConfig(vocab_size=31, d_model=64, n_heads=2, n_layers=2,
                ctx_len=64)
WINDOW = 16
# prompts of one window, of two and of three (the last partly filled)
PROMPT_LENS = (5, 16, 20, 37, 9)


def _engine():
    eng = ServeEngine(init_gpt_params(CFG, seed=7), CFG, device="cpu",
                      n_slots=2, chunk=4, top_k=1, prefill_window=WINDOW,
                      paged=True, page=8)
    rng = np.random.default_rng(3)
    ids = [eng.submit(Request(rng.integers(0, CFG.vocab_size, n).tolist(),
                              6)) for n in PROMPT_LENS]
    return eng, ids


def _serve(profiled):
    eng, ids = _engine()
    if not profiled:
        done = eng.run()
        return {c.request_id: c.tokens for c in done}, eng, None
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        done = eng.run()
    return {c.request_id: c.tokens for c in done}, eng, prof.events()


def _train(profiled, grad_accum=1, steps=2):
    cfg = dict(base_lr=3e-4, min_lr=3e-5, warmup=2, max_steps=10,
               weight_decay=0.01)
    params = init_gpt_params(CFG, seed=1)
    opt = adamw_init(params)
    step = make_device_train_step(CFG, 4, grad_accum=grad_accum, **cfg)
    data = torch.randint(0, CFG.vocab_size, (2000,),
                         generator=torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(3)
    losses, prof = [], None

    def run():
        nonlocal params, opt, gen
        for _ in range(steps):
            params, opt, gen, loss = step(params, opt, data, gen)
            losses.append(loss)

    if profiled:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            run()
    else:
        run()
    return losses, params, prof.events() if prof is not None else None


def _named(events, name):
    return sorted((e for e in events if e.name == name),
                  key=lambda e: e.time_range.start)


def _children(events, parent, name):
    return [e for e in _named(events, name) if e.cpu_parent is parent]


def test_off_a_span_is_the_shared_no_op(monkeypatch):
    """No profiler: every span is one object, and a run of the engine and
    of the training step enters no RecordFunction and records nothing."""
    assert not torch.autograd.profiler._is_profiler_enabled
    assert (profiling.span("serve.step")
            is profiling.span("train.forward", torch.device("cpu"))
            is profiling.span("serve.admit", args={"request": 1}))

    def refuse(*a, **k):
        raise AssertionError("a span was entered with no profiler on")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    _serve(profiled=False)
    _train(profiled=False, grad_accum=2)
    assert profiling._records == []


def test_serve_spans_nest_inside_the_step():
    tokens, eng, events = _serve(profiled=True)
    steps = _named(events, "serve.step")
    admits = _named(events, "serve.admit")
    assert len(admits) == len(PROMPT_LENS) == eng.stats["prefills"]
    assert all(a.cpu_parent in steps for a in admits)
    by_id = {a.kwinputs["request"]: a for a in admits}
    assert sorted(by_id) == sorted(tokens)
    for rid, n in zip(sorted(by_id), PROMPT_LENS):
        a = by_id[rid]
        assert a.kwinputs["prompt"] == n
        assert len(_children(events, a, "serve.prefill")) == 1
        assert len(_children(events, a, "serve.extend")) == math.ceil(
            n / WINDOW) - 1
    assert len(_named(events, "serve.prefill")) == len(PROMPT_LENS)
    # one decode, fetch and account a chunk, in that order, in its step
    for name in ("serve.decode", "serve.fetch", "serve.account"):
        spans = _named(events, name)
        assert len(spans) == eng.stats["chunks"]
        assert all(s.cpu_parent in steps for s in spans)
    for step in steps:
        kids = sorted((e for e in events if e.cpu_parent is step
                       and e.name.startswith("serve.")),
                      key=lambda e: e.time_range.start)
        names = [k.name for k in kids]
        if "serve.decode" in names:
            n_admit = names.count("serve.admit")
            assert names == ["serve.admit"] * n_admit + [
                "serve.decode", "serve.fetch", "serve.account"]
    assert profiling._records == []  # CPU spans are never device-timed


def test_serving_is_the_same_with_the_profiler_on():
    off, _, _ = _serve(profiled=False)
    on, _, _ = _serve(profiled=True)
    assert on == off


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_spans_follow_in_order_inside_the_step(grad_accum):
    _, _, events = _train(profiled=True, grad_accum=grad_accum)
    steps = _named(events, "train.step")
    assert len(steps) == 2
    for step in steps:
        kids = sorted((e for e in events if e.cpu_parent is step
                       and e.name.startswith("train.")),
                      key=lambda e: e.time_range.start)
        assert [k.name for k in kids] == ["train.forward",
                                          "train.backward"] * grad_accum + [
                                              "train.optimizer"]


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_training_is_the_same_with_the_profiler_on(grad_accum):
    l_off, p_off, _ = _train(profiled=False, grad_accum=grad_accum)
    l_on, p_on, _ = _train(profiled=True, grad_accum=grad_accum)
    assert [float(x) for x in l_on] == [float(x) for x in l_off]
    for k, v in p_off["layers"].items():
        assert torch.equal(p_on["layers"][k], v), k
    assert torch.equal(p_on["tok_W"], p_off["tok_W"])


def test_a_new_session_drops_the_last_ones_device_records():
    profiling._records.append(("train.forward", None, None))
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling._records == []
    assert profiling.device_ms("train.forward") == []


@pytest.mark.cuda
def test_device_spans_time_the_step_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    params = init_gpt_params(CFG, seed=1, device=dev)
    step = make_device_train_step(CFG, 4, base_lr=3e-4, min_lr=3e-5,
                                  warmup=2, max_steps=10, weight_decay=0.01)
    data = torch.randint(0, CFG.vocab_size, (2000,), device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    opt = adamw_init(params)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(3):
            params, opt, gen, _ = step(params, opt, data, gen)
        torch.cuda.synchronize()
    for name in ("train.forward", "train.backward", "train.optimizer"):
        ms = profiling.device_ms(name)
        assert len(ms) == 3 and all(t > 0 for t in ms), (name, ms)
    assert profiling.device_ms("train.step") == []  # host only
