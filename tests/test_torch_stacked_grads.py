"""How the training backward writes the gradients of the stacked (L, ...)
weight leaves (linalg_tpu_torch/models/gpt.py ``_layer_params`` and its
callers), counted on the CPU.

Each layer takes its weights from the cast stack through one ``unbind``
per leaf, whose backward writes the L layers' gradients into the stack
once (one ``stack``). Indexing the stack per layer (``w[i]``) gives one
``select_backward`` a layer, each a zero-filled stack holding one layer's
gradient, and L - 1 adds of whole stacks: O(L^2) bytes. A
``TorchDispatchMode`` records every op whose output has a stacked leaf's
shape through the backward of a tiny config (T 5 and batch 3 keep the
activations' shapes apart from the leaves').
"""

import collections

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from linalg_tpu_torch.models import gpt as tgpt
from linalg_tpu_torch.models import moe as tmoe
from linalg_tpu_torch.models import seq2seq as tseq

torch.set_num_threads(2)

B, T, V = 3, 5, 19


class _StackShapedOps(TorchDispatchMode):
    """Counts (op name, output shape) of the ops whose output has one of
    ``shapes``."""

    def __init__(self, shapes):
        super().__init__()
        self.shapes = set(shapes)
        self.count = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and tuple(t.shape) in self.shapes:
                self.count[(func.overloadpacket.__name__,
                            tuple(t.shape))] += 1
        return out


def _ids(seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, V, (B, T), generator=g),
            torch.randint(0, V, (B, T), generator=g))


def _gpt(L):
    cfg = tgpt.GPTConfig(vocab_size=V, d_model=32, n_heads=2, n_layers=L,
                         ctx_len=16, dtype="bfloat16")
    params = tgpt.init_gpt_params(cfg, seed=0)
    x, y = _ids(L)
    return params, lambda p: tgpt.gpt_loss(p, x, y, cfg), [params["layers"]]


def _moe():
    cfg = tmoe.MoEGPTConfig(vocab_size=V, d_model=32, n_heads=2, n_layers=4,
                            ctx_len=16, n_experts=4, dtype="bfloat16")
    params = tmoe.init_moe_params(cfg, seed=0)
    x, y = _ids(1)
    return (params, lambda p: tmoe.moe_gpt_loss(p, x, y, cfg),
            [params["layers"]])


def _seq2seq():
    cfg = tseq.Seq2SeqConfig(vocab_size=V, d_model=32, n_heads=2,
                             n_enc_layers=4, n_dec_layers=3, d_ff=64,
                             max_len=16)
    params = tseq.init_seq2seq_params(cfg, seed=0)
    src, tgt = _ids(2)
    return (params, lambda p: tseq.seq2seq_loss(p, src, tgt, tgt, cfg),
            [params["encoder"], params["decoder"]])


CASES = {"gpt_L4": lambda: _gpt(4), "gpt_L8": lambda: _gpt(8),
         "moe_L4": _moe, "seq2seq_L4_L3": _seq2seq}


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_stack_write_per_leaf(case):
    params, loss_fn, stacks = CASES[case]()
    leaves = [w for s in stacks for w in s.values()]
    for w in leaves:
        w.requires_grad_(True)
    loss = loss_fn(params)
    shapes = {tuple(w.shape) for w in leaves}
    mode = _StackShapedOps(shapes)
    with mode:
        torch.autograd.grad(loss, leaves)
    names = collections.Counter(op for op, _ in mode.count.elements())
    assert names["select_backward"] == 0, mode.count
    assert names["add"] == 0, mode.count
    # one stack per leaf; leaves of one shape share a key
    per_shape = collections.Counter(tuple(w.shape) for w in leaves)
    for shape, n in per_shape.items():
        assert mode.count[("stack", shape)] <= n, mode.count
