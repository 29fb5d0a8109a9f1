"""The port's hand-written CUDA kernels against their plain PyTorch
versions (linalg_tpu_torch/kernels).

Imports neither JAX nor ``linalg_tpu``, so it also runs on a machine with
a card and no JAX: ``python -m pytest tests/test_torch_kernels.py -q -m
cuda --noconftest`` (tests/conftest.py imports JAX). Tests that need the
card carry the ``cuda`` marker and skip where there is none; the rest
check, on the CPU, what the wrappers do without a card.
"""

import numpy as np
import pytest
import torch

from linalg_tpu_torch.kernels import build as kbuild
from linalg_tpu_torch.kernels.paged_attention import paged_attention_cuda
from linalg_tpu_torch.kernels.qr_panel import factor_strip_cuda
from linalg_tpu_torch.ops.qr import householder_qr
from linalg_tpu_torch.ops.qr_panel import (
    factor_panel_ref,
    factor_strip,
    factor_strip_ref,
)
from linalg_tpu_torch.serve.paged import paged_attention, paged_attention_ref

torch.set_num_threads(2)

# the tolerance tests/test_paged.py holds the Pallas kernels to (float32
# sums in another order)
RTOL, ATOL = 2e-5, 2e-6
# bfloat16 keeps 8 bits of mantissa: outputs of magnitude ~1 round at ~4e-3
BF16_ATOL = 2e-2
# the panel sweep against its plain version: float32 sums over m lanes in
# another order; a float64 sweep at m 4096 differs from the float32 one by
# 2e-5 on St (magnitude 65), 1.4e-7 on Vt and 1e-7 on Tt
QR_RTOL_OF_MAX = 1e-5

SHAPES = [(4, 2, 128), (8, 1, 64), (4, 4, 64), (2, 2, 128)]


@pytest.fixture
def cuda():
    """The CUDA device, or a skip where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def paged_inputs(H, hk, d, seed, B=3, page=16, Pmax=4):
    """numpy inputs in the engine's layout: distinct pages per slot,
    ragged positions, an additive per-head bias on the live rows, and the
    last slot idle (all-trash table row, position past ctx)."""
    rng = np.random.default_rng(seed)
    ctx = page * Pmax
    n_pages = 1 + B * Pmax
    f32 = np.float32
    q = rng.normal(size=(B, H, 1, d)).astype(f32)
    pk = rng.normal(size=(n_pages, hk, page, d)).astype(f32)
    pv = rng.normal(size=(n_pages, hk, page, d)).astype(f32)
    table = rng.permutation(np.arange(1, n_pages)).reshape(B, Pmax)
    table[-1] = 0
    pos = rng.integers(1, ctx, size=B)
    pos[-1] = ctx + 5
    live = np.arange(ctx)[None, :] <= pos[:, None]
    mask = np.where(live, 0.0, -1e9)[:, None, None, :] + rng.normal(
        scale=0.1, size=(B, H, 1, ctx)) * live[:, None, None, :]
    return (q, pk, pv, mask.astype(f32), table.astype(np.int32),
            pos.astype(np.int32))


def on(device, args, dtype=torch.float32):
    return [torch.tensor(a, device=device,
                         dtype=dtype if a.dtype == np.float32 else None)
            for a in args]


def test_dispatcher_takes_plain_version_on_cpu():
    args = on("cpu", paged_inputs(4, 2, 64, seed=3))
    before = paged_attention_cuda.launches
    torch.testing.assert_close(paged_attention(*args),
                               paged_attention_ref(*args), rtol=0, atol=0)
    assert paged_attention_cuda.launches == before


def test_kernel_wrapper_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_cuda(*on("cpu", paged_inputs(4, 2, 64, seed=4)))


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    if kbuild.DEFAULT_NVCC.exists():
        pytest.skip("the toolkit's default nvcc is installed here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kbuild.build("paged_attention")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol,atol",
                         [(torch.float32, RTOL, ATOL),
                          (torch.bfloat16, 0.0, BF16_ATOL)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("H,hk,d", SHAPES + [(8, 2, 32)])
def test_kernel_matches_ref_on_card(cuda, H, hk, d, dtype, rtol, atol):
    args = on(cuda, paged_inputs(H, hk, d, seed=H + hk + d), dtype)
    before = paged_attention_cuda.launches
    got = paged_attention(*args)
    torch.cuda.synchronize()
    assert paged_attention_cuda.launches == before + 1
    torch.testing.assert_close(got.float(),
                               paged_attention_ref(*args).float(),
                               rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    args = on(cuda, paged_inputs(4, 2, 64, seed=5))
    with pytest.raises(ValueError, match="d_head"):
        paged_attention_cuda(*on(cuda, paged_inputs(4, 2, 16, seed=5)))
    with pytest.raises(ValueError, match="dtype"):
        paged_attention_cuda(*(a.double() if a.is_floating_point() else a
                               for a in args))
    strided_q = args[0].repeat_interleave(2, dim=-1)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        paged_attention_cuda(strided_q, *args[1:])


def test_qr_panel_wrapper_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        factor_strip_cuda(torch.zeros(8, 32), 0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,k,zero", [(32, 1024, 0, None),
                                        (32, 1030, 7, 3),
                                        (128, 2048, 0, None)],
                         ids=["strip", "ragged_zero_col", "panel_b128"])
def test_qr_panel_matches_ref_on_card(cuda, b, m, k, zero):
    St = np.random.default_rng(b + m + k).standard_normal((b, m))
    if zero is not None:
        St[zero] = 0.0
    St = torch.tensor(St, dtype=torch.float32, device=cuda)
    ref = factor_strip_ref if b <= 64 else factor_panel_ref
    before = factor_strip_cuda.launches
    got = factor_strip(St, k) if b <= 64 else factor_strip_cuda(St, k)
    torch.cuda.synchronize()
    assert factor_strip_cuda.launches == before + 1
    for g, w in zip(got, ref(St, k)):
        tol = QR_RTOL_OF_MAX * max(1.0, float(w.abs().max()))
        torch.testing.assert_close(g, w, rtol=0, atol=tol)
    if zero is not None:  # exact skip: no reflector, tau = 0
        assert float(got[1][zero].abs().max()) == 0.0
        assert float(got[2][zero, zero]) == 0.0


@pytest.mark.cuda
def test_qr_panel_rejects_what_it_does_not_take(cuda):
    St = torch.randn(16, 64, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        factor_strip_cuda(St.double(), 0)
    with pytest.raises(ValueError, match="contiguous"):
        factor_strip_cuda(St.T.contiguous().T, 0)
    with pytest.raises(ValueError, match="outside"):
        factor_strip_cuda(torch.randn(300, 64, device=cuda), 0)


@pytest.mark.cuda
def test_householder_qr_through_kernel_under_callers_tf32(cuda):
    n = 512
    A = torch.tensor(np.random.default_rng(0).standard_normal((n, n)),
                     dtype=torch.float32, device=cuda)
    before = factor_strip_cuda.launches
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        Q, R = householder_qr(A)
        still_on = torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    assert factor_strip_cuda.launches == before + n // 32
    assert still_on  # the caller's setting is restored
    A64 = A.double()
    rel = torch.linalg.norm(Q.double() @ R.double() - A64) / torch.linalg.norm(
        A64)
    assert float(rel) <= 1e-6
