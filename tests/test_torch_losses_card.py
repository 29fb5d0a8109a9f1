"""The chunked cross-entropy's tensor-core path on a card
(``linalg_tpu_torch/nn/losses.py``): a bfloat16 h on a CUDA device takes
bf16 x bf16 chunk products with float32 accumulation and float32 logits.

Every test here carries the ``cuda`` marker and skips without a card. The
loss and the gradients are held to the float64 loss through the full
(N, V) logits of the same inputs (h's bf16 values, W and b as given) at a
padded vocabulary (V 50,257 in chunks of 4,096), also with a common offset
on the bias that only float32 logits carry; padding rows take exactly
zero gradient and change nothing; the spans name the path taken. No JAX
here, so these run on the card with ``--noconftest``:

    python -m pytest tests/test_torch_losses_card.py -q -m cuda --noconftest
"""

from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from linalg_tpu_torch.nn.losses import chunked_softmax_ce
from linalg_tpu_torch.utils import profiling

# relative error of the bf16 path against the float64 loss, by quantity:
# at least 3x what an H100 reads at this size (loss 5.2e-6, 5.3e-6 at
# offset 64, dh 2.3e-3 of which the return in bf16 is most, dW 2.2e-4,
# db 2.3e-4, each the same at both offsets), and no looser
# than the benchmark's limits (gpt2xl-train: loss_gap 1.5e-4, grad_gap 0.03)
BOUNDS = {"loss": 2e-5, "dh": 1e-2, "dW": 1e-3, "db": 1e-3}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(N, D, V, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    h = torch.randn(N, D, generator=g, device=device).bfloat16()
    W = 0.1 * torch.randn(V, D, generator=g, device=device)
    b = 0.1 * torch.randn(V, generator=g, device=device)
    y = torch.randint(0, V, (N,), generator=g, device=device)
    return h, W, b, y


def _port(h, W, b, y, chunk=4096):
    ts = [t.detach().clone().requires_grad_(True) for t in (h, W, b)]
    loss = chunked_softmax_ce(*ts, y, chunk)
    return [loss.detach()] + list(torch.autograd.grad(loss, ts))


def _full_f64(h, W, b, y):
    ts = [t.detach().double().requires_grad_(True) for t in (h, W, b)]
    logits = ts[0] @ ts[1].T + ts[2]
    loss = torch.mean(torch.logsumexp(logits, -1)
                      - logits.gather(1, y[:, None])[:, 0])
    return [loss.detach()] + list(torch.autograd.grad(loss, ts))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0.0, 64.0])
def test_bf16_path_matches_f64_full_logits(cuda, offset):
    """N 2048, D 512, V 50,257 (13 chunks, the last 1,007 rows real):
    loss, dh, dW and db against float64 full logits, each by its norm;
    the forward and backward make no host synchronisation.

    A bias raised by 64 everywhere changes neither the loss nor a
    gradient. Float32 logits round it away (~4e-6 each); bf16 logits
    would round each by up to 0.25: on an H100 that reads loss 5.2e-4,
    dW and db 7e-3, past their bounds, where at offset 0 it reads loss
    1.6e-5 and dW 8.3e-4, inside them, hidden by W's own bf16 rounding."""
    h, W, b, y = _inputs(2048, 512, 50257, cuda)
    b = b + offset
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # the path never waits
    try:
        got = _port(h, W, b, y)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = _full_f64(h, W, b, y)
    assert [t.dtype for t in got] == [torch.float32, torch.bfloat16,
                                      torch.float32, torch.float32]
    errs = {}
    for name, g, w in zip(("loss", "dh", "dW", "db"), got, want):
        errs[name] = float(torch.linalg.vector_norm(g.double() - w)
                           / torch.linalg.vector_norm(w))
    print(f"bf16 path, offset {offset}, relative error against float64:",
          errs)
    for name, e in errs.items():
        assert e <= BOUNDS[name], (name, e, BOUNDS[name])


@pytest.mark.cuda
def test_padded_rows_take_zero_gradient(cuda):
    """Rows the caller pads on (zero W, bias -1e30), as the vocabulary's
    own padding is: V 50,257 + 50 still pads to 53,248, so every chunk
    product is the same call; the loss and the real rows' gradients come
    out bit for bit the same, the padding rows' dW and db exactly 0."""
    V, pad = 50257, 50
    h, W, b, y = _inputs(2048, 512, V, cuda, seed=1)
    Wx = torch.cat([W, W.new_zeros(pad, W.shape[1])])
    bx = torch.cat([b, b.new_full((pad,), -1e30)])
    loss, dh, dW, db = _port(h, W, b, y)
    loss_x, dh_x, dW_x, db_x = _port(h, Wx, bx, y)
    assert torch.equal(loss, loss_x) and torch.equal(dh, dh_x)
    assert torch.equal(dW, dW_x[:V]) and torch.equal(db, db_x[:V])
    assert torch.count_nonzero(dW_x[V:]) == 0
    assert torch.count_nonzero(db_x[V:]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,path", [(torch.bfloat16, "bf16"),
                                        (torch.float32, "f32")])
def test_card_spans_name_the_path(cuda, dtype, path):
    """On the card a bfloat16 h takes the bf16 path, a float32 h the
    float32 one; each pass's span is timed on the device. V 9,000 in
    chunks of 4,096 is 3 chunks."""
    h, W, b, y = _inputs(256, 64, 9000, cuda, seed=2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        _port(h.to(dtype), W, b, y)
        torch.cuda.synchronize()
    for name in ("ce.forward", "ce.backward"):
        (ev,) = [e for e in prof.events() if e.name == name]
        assert ev.kwinputs == {"path": path, "chunks": 3}, name
        (ms,) = profiling.device_ms(name)
        assert ms > 0.0
