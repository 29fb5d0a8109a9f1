"""The gradients of the stacked (L, ...) weight leaves through
``_layer_params``'s one ``unbind`` a leaf (linalg_tpu_torch/models/gpt.py)
equal, element for element, those of the per-layer indexing ``w[i]`` it
replaced, written here as the reference.

Each slot of a stack receives its one layer's gradient either way: the
indexed path adds the other layers' zeros to it, which is exact but for
the sign of a zero, so both sides add 0.0 (folding -0.0 into +0.0)
before ``torch.equal``. Tiny GPT and MoE configs (L 4) on the CPU, in
bfloat16 and float32 compute.
"""

import pytest
import torch

from linalg_tpu_torch.models import gpt as tgpt
from linalg_tpu_torch.models import moe as tmoe

torch.set_num_threads(2)

B, T, V = 2, 7, 19


def _indexed_layer_params(params, dt):
    """The reference: each layer's weights indexed out of the cast stack."""
    stacked = {k: w.to(dt) for k, w in params["layers"].items()}
    L = next(iter(stacked.values())).shape[0]
    return [{k: w[i] for k, w in stacked.items()} for i in range(L)]


def _grads(loss_fn, init, cfg):
    params = init(cfg, seed=3)
    g = torch.Generator().manual_seed(5)
    x = torch.randint(0, V, (B, T), generator=g)
    y = torch.randint(0, V, (B, T), generator=g)
    leaves = [params["tok_W"], params["head_b"],
              *params["layers"].values()]
    for w in leaves:
        w.requires_grad_(True)
    grads = torch.autograd.grad(loss_fn(params, x, y, cfg), leaves)
    return [gr + 0.0 for gr in grads]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("model", ["gpt", "moe"])
def test_unbind_grads_equal_indexed(model, dtype, monkeypatch):
    kw = dict(vocab_size=V, d_model=32, n_heads=2, n_layers=4, ctx_len=16,
              dtype=dtype)
    if model == "gpt":
        mod, cfg = tgpt, tgpt.GPTConfig(**kw)
        init, loss_fn = tgpt.init_gpt_params, tgpt.gpt_loss
    else:
        mod, cfg = tmoe, tmoe.MoEGPTConfig(n_experts=4, **kw)
        init, loss_fn = tmoe.init_moe_params, tmoe.moe_gpt_loss
    new = _grads(loss_fn, init, cfg)
    monkeypatch.setattr(mod, "_layer_params", _indexed_layer_params)
    old = _grads(loss_fn, init, cfg)
    assert len(new) == len(old)
    for a, b in zip(new, old):
        assert a.dtype == b.dtype == torch.float32
        assert torch.equal(a, b)
