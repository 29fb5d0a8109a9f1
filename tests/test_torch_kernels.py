"""The port's hand-written CUDA kernels against their plain PyTorch
versions (linalg_tpu_torch/kernels).

Imports neither JAX nor ``linalg_tpu``, so it also runs on a machine with
a card and no JAX: ``python -m pytest tests/test_torch_kernels.py -q -m
cuda --noconftest`` (tests/conftest.py imports JAX). Tests that need the
card carry the ``cuda`` marker and skip where there is none; the rest
check, on the CPU, what the wrappers do without a card.
"""

import pathlib

import numpy as np
import pytest
import torch

from linalg_tpu_torch.kernels import build as kbuild
from linalg_tpu_torch.kernels.flash_attention import (
    flash_delta_cuda,
    flash_dkdv_cuda,
    flash_dq_cuda,
    flash_fwd_cuda,
)
from linalg_tpu_torch.kernels.paged_attention import (paged_attention_cuda,
                                                      paged_splits)
from linalg_tpu_torch.models.gpt import _padded_attn
from linalg_tpu_torch.nn.flash import (
    flash_attention,
    flash_attention_ref,
    flash_bwd_ref,
    flash_fwd_ref,
)
from linalg_tpu_torch.nn.flash_long import flash_attention_long
from linalg_tpu_torch.nn.flash_stream import flash_attention_stream
from linalg_tpu_torch.kernels import qr_panel as kqp
from linalg_tpu_torch.kernels.qr_panel import (
    cluster_shape,
    factor_strip_cuda,
)
from linalg_tpu_torch.ops.qr import householder_qr
from linalg_tpu_torch.ops.qr_panel import (
    factor_panel,
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
# the widest head the kernel takes, one between its padded widths (with a
# query group of 3), the narrowest
EXTRA_SHAPES = [(2, 1, 256), (6, 2, 96), (4, 4, 8)]


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


def test_build_rebuilds_when_a_shared_header_changes(monkeypatch, tmp_path):
    """The library's digest covers the csrc/*.cuh headers a source
    includes: an edited header builds a new library, never loads the stale
    one (nvcc mocked: it writes the file it is asked for)."""
    import subprocess

    csrc, out = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "h.cuh"\n')
    (csrc / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(kbuild, "CSRC_DIR", csrc)
    monkeypatch.setattr(kbuild, "BUILD_DIR", out)
    monkeypatch.setattr(kbuild, "_nvcc", lambda: "nvcc")
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        pathlib.Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(kbuild.subprocess, "run", fake_run)
    first = kbuild.build("k")
    assert kbuild.build("k") == first and len(calls) == 1  # cached
    (csrc / "h.cuh").write_text("// two\n")
    second = kbuild.build("k")
    assert second != first and second.exists() and len(calls) == 2


PAGED_DTYPES = pytest.mark.parametrize(
    "dtype,rtol,atol", [(torch.float32, RTOL, ATOL),
                        (torch.bfloat16, 0.0, BF16_ATOL)],
    ids=["f32", "bf16"])


def check_paged_on_card(args, rtol, atol):
    before = paged_attention_cuda.launches
    got = paged_attention(*args)
    torch.cuda.synchronize()
    assert paged_attention_cuda.launches == before + 1
    torch.testing.assert_close(got.float(),
                               paged_attention_ref(*args).float(),
                               rtol=rtol, atol=atol)


@pytest.mark.cuda
@PAGED_DTYPES
@pytest.mark.parametrize("H,hk,d",
                         SHAPES + [(8, 2, 32)] + EXTRA_SHAPES
                         + [(16, 1, 32), (8, 2, 256), (8, 1, 256)])
def test_kernel_matches_ref_on_card(cuda, H, hk, d, dtype, rtol, atol):
    args = on(cuda, paged_inputs(H, hk, d, seed=H + hk + d), dtype)
    check_paged_on_card(args, rtol, atol)


@pytest.mark.cuda
@PAGED_DTYPES
@pytest.mark.parametrize("case", ["b1_full_ctx", "pos0"])
def test_kernel_at_edge_positions_on_card(cuda, case, dtype, rtol, atol):
    """One slot at the last position of a 32-page context (every tile
    live, the most splits), and every slot at position 0 (one live page:
    most splits empty)."""
    if case == "b1_full_ctx":
        args = paged_inputs(4, 2, 128, seed=21, B=1, page=64, Pmax=32)
        args[4][0] = np.arange(32, 0, -1)  # pages 32..1, not the trash page
        args[5][:] = 64 * 32 - 1
        args[3][:] = 0.0  # every row live
    else:
        args = paged_inputs(4, 2, 128, seed=22, B=4, page=64, Pmax=8)
        args[-1][:] = 0
        live = np.arange(64 * 8) == 0
        args[3][:] = np.where(live, 0.0, -1e9).astype(np.float32)
    check_paged_on_card(on(cuda, args, dtype), rtol, atol)


@pytest.mark.cuda
@PAGED_DTYPES
@pytest.mark.parametrize("case", ["one", "several", "more_than_live"])
def test_kernel_split_counts_on_card(cuda, case, dtype, rtol, atol):
    """The split counts the wrapper picks from the shapes give the same
    attention: S 1 (blocks enough without splitting), several, and more
    than every busy slot's live tiles (empty splits), at a page of three
    tiles."""
    B, hk, Pmax = {"one": (40, 8, 2), "several": (8, 2, 8),
                   "more_than_live": (8, 2, 8)}[case]
    args = paged_inputs(8, hk, 64, seed=B + hk, B=B, page=80, Pmax=Pmax)
    if case == "more_than_live":  # every busy slot on its first page
        args[5][:-1] = np.arange(B - 1) * 11
        live = np.arange(80 * Pmax)[None, :] <= args[5][:, None]
        args[3][:] = np.where(live, 0.0, -1e9)[:, None, None, :]
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    S = paged_splits(B, 8, hk, 80, Pmax, n_sm)
    assert {"one": S == 1, "several": 1 < S < 3 * Pmax,
            "more_than_live": S > 3}[case], S
    check_paged_on_card(on(cuda, args, dtype), rtol, atol)


def shared_inputs(H, hk, d, seed, B=4, page=16, Pmax=6, n_shared=2):
    """``paged_inputs`` with pages that slots share, as a registered
    prefix or a page-cache hit leaves them: every slot's table starts with
    the same ``n_shared`` page ids, then private pages; ragged positions
    past the shared run, one slot still inside it, the last idle."""
    q, pk, pv, mask, table, pos = paged_inputs(H, hk, d, seed, B, page,
                                               Pmax)
    rng = np.random.default_rng(seed + 100)
    ctx = page * Pmax
    shared = table[0, :n_shared].copy()
    table[:-1, :n_shared] = shared
    pos[:-1] = rng.integers(n_shared * page, ctx, size=B - 1)
    pos[0] = page - 3  # inside the first shared page
    live = np.arange(ctx)[None, :] <= pos[:, None]
    mask = (np.where(live, 0.0, -1e9)[:, None, None, :]
            + rng.normal(scale=0.1, size=(B, H, 1, ctx))
            * live[:, None, None, :]).astype(np.float32)
    return q, pk, pv, mask, table, pos


@pytest.mark.parametrize("H,hk,d", [(4, 2, 128), (8, 1, 64), (4, 4, 32)])
def test_shared_pages_equal_private_copies(H, hk, d):
    """On the CPU: attention through tables that share pages equals
    attention through private copies of those pages (the plain version,
    which the card's kernel is held to)."""
    q, pk, pv, mask, table, pos = shared_inputs(H, hk, d, seed=H + d)
    n_pages = pk.shape[0]
    pk2 = np.concatenate([pk, pk[table[1:-1, :2].ravel()]])
    pv2 = np.concatenate([pv, pv[table[1:-1, :2].ravel()]])
    table2 = table.copy()
    table2[1:-1, :2] = n_pages + np.arange(2 * (len(table) - 2)).reshape(
        -1, 2)
    got = paged_attention(*on("cpu", (q, pk, pv, mask, table, pos)))
    want = paged_attention(*on("cpu", (q, pk2, pv2, mask, table2, pos)))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
@PAGED_DTYPES
@pytest.mark.parametrize("H,hk,d", [(4, 2, 128), (8, 1, 64), (4, 4, 32)])
def test_kernel_with_shared_pages_on_card(cuda, H, hk, d, dtype, rtol,
                                          atol):
    """The kernels walk pages that several slots' tables share (a
    registered prefix, a page-cache hit) in place: the plain version's
    attention."""
    args = on(cuda, shared_inputs(H, hk, d, seed=H + d), dtype)
    check_paged_on_card(args, rtol, atol)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    args = on(cuda, paged_inputs(4, 2, 64, seed=5))
    for d in (12, 264):  # not a multiple of 8; past 256
        with pytest.raises(ValueError, match="d_head"):
            paged_attention_cuda(*on(cuda, paged_inputs(4, 2, d, seed=5)))
    with pytest.raises(ValueError, match="dtype"):
        paged_attention_cuda(*(a.double() if a.is_floating_point() else a
                               for a in args))
    strided_q = args[0].repeat_interleave(2, dim=-1)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        paged_attention_cuda(strided_q, *args[1:])


def test_qr_panel_wrapper_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        factor_strip_cuda(torch.zeros(8, 32), 0)


# (b, m, k, zero row, (C, lanes a thread) of the cluster kernel, or (0, 0)
# for the grid kernel): C 1, several and 16 CTAs, k near m (fewer live
# lanes than a CTA; pivots past m), two lanes a thread past 4096 live
# lanes, b 64; and the shapes the rule sends to the grid kernel: K12's b
# 128 and 256, the tall strips of a 16384 x 4096 QR (first and last), b
# 64 past a cluster, a ragged b 100 with a zero column, pivots past m at
# b 128, S and Vt in device memory (b 256 at m 16384), and more lanes than
# MAX_GRID CTAs of 64 hold
QR_CARD_CASES = {
    "strip": (32, 1024, 0, None, (4, 1)),
    "ragged_zero_col": (32, 1030, 7, 3, (5, 1)),
    "largest_cluster": (32, 4096, 0, None, (16, 1)),
    "one_cta": (32, 4096, 3900, 1, (1, 1)),
    "k_near_m": (32, 1030, 1020, None, (1, 1)),
    "two_lanes": (32, 6000, 5, 20, (12, 2)),
    "two_lanes_largest": (32, 8192, 0, None, (16, 2)),
    "b64": (64, 4096, 0, None, (16, 1)),
    "b64_ragged": (64, 2050, 33, 60, (8, 1)),
    "wide_m": (32, 20000, 0, None, (0, 0)),
    "panel_b128": (128, 2048, 0, None, (0, 0)),
    "panel_b128_m4096": (128, 4096, 0, None, (0, 0)),
    "panel_b256": (256, 4096, 0, None, (0, 0)),
    "tall": (32, 16384, 0, None, (0, 0)),
    "tall_k4064": (32, 16384, 4064, None, (0, 0)),
    "b64_m8192": (64, 8192, 0, None, (0, 0)),
    "b100_ragged_zero_col": (100, 1030, 7, 3, (0, 0)),
    "b128_k_past_m": (128, 4096, 4000, 10, (0, 0)),
    "off_chip_b256": (256, 16384, 0, None, (0, 0)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(QR_CARD_CASES))
def test_qr_panel_matches_ref_on_card(cuda, case):
    b, m, k, zero, shape = QR_CARD_CASES[case]
    assert cluster_shape(b, m, k) == shape
    cluster = shape[0] > 0
    St = np.random.default_rng(b + m + k).standard_normal((b, m))
    if zero is not None:
        St[zero] = 0.0
    St = torch.tensor(St, dtype=torch.float32, device=cuda)
    ref = factor_strip_ref if b <= 64 else factor_panel_ref
    counts = (factor_strip_cuda.launches, factor_strip_cuda.cluster_launches,
              factor_strip_cuda.grid_launches,
              factor_strip_cuda.panel_launches)
    got = factor_strip(St, k) if b <= 64 else factor_panel(St, k)
    torch.cuda.synchronize()
    moved = (factor_strip_cuda.cluster_launches - counts[1],
             factor_strip_cuda.grid_launches - counts[2])
    assert factor_strip_cuda.launches == counts[0] + 1
    assert moved == ((1, 0) if cluster else (0, 1))
    # K12's widths count as panel launches as well
    assert factor_strip_cuda.panel_launches == counts[3] + (b > 64)
    for g, w in zip(got, ref(St, k)):
        tol = QR_RTOL_OF_MAX * max(1.0, float(w.abs().max()))
        torch.testing.assert_close(g, w, rtol=0, atol=tol)
    if zero is not None and k + zero < m:  # exact skip: no reflector, tau 0
        assert float(got[1][zero].abs().max()) == 0.0
        assert float(got[2][zero, zero]) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["b64", "b64_ragged", "largest_cluster",
                                  "two_lanes_largest", "tall", "panel_b256",
                                  "b100_ragged_zero_col", "off_chip_b256"])
def test_qr_cluster_repeats_bitwise_on_card(cuda, case):
    # both kernels sum in a fixed order, so 200 launches back to back into
    # outputs of their own must agree bit for bit: a race between their
    # threads or CTAs (a Tt row formed from a stale z, an exchange word
    # read before its step) would show as one launch that differs
    b, m, k, zero, _ = QR_CARD_CASES[case]
    St = np.random.default_rng(b + m + k).standard_normal((b, m))
    if zero is not None:
        St[zero] = 0.0
    St = torch.tensor(St, dtype=torch.float32, device=cuda)
    outs = [factor_strip_cuda(St, k) for _ in range(200)]
    torch.cuda.synchronize()
    ref = factor_strip_ref if b <= 64 else factor_panel_ref
    for g, w in zip(outs[0], ref(St, k)):
        tol = QR_RTOL_OF_MAX * max(1.0, float(w.abs().max()))
        torch.testing.assert_close(g, w, rtol=0, atol=tol)
    differ = [i for i, out in enumerate(outs)
              if not all(torch.equal(g, f) for g, f in zip(out, outs[0]))]
    assert differ == []


def _grid_strip(case, cuda):
    b, m, k, zero, _ = QR_CARD_CASES[case]
    St = np.random.default_rng(b + m + k).standard_normal((b, m))
    if zero is not None:
        St[zero] = 0.0
    return torch.tensor(St, dtype=torch.float32, device=cuda), k


@pytest.mark.cuda
def test_qr_grid_buffer_shared_across_shapes_on_card(cuda):
    # one exchange buffer serves every grid launch of a stream, whatever
    # its (b, G): launches of four shapes in turn, 50 rounds, each bitwise
    # equal to its shape's first, which agrees with the plain version
    cases = ["tall", "panel_b256", "b100_ragged_zero_col", "off_chip_b256"]
    strips = [_grid_strip(c, cuda) for c in cases]
    first = [factor_strip_cuda(St, k) for St, k in strips]
    later = [[factor_strip_cuda(St, k) for St, k in strips]
             for _ in range(50)]
    torch.cuda.synchronize()
    for (St, k), out in zip(strips, first):
        ref = factor_strip_ref if St.shape[0] <= 64 else factor_panel_ref
        for g, w in zip(out, ref(St, k)):
            tol = QR_RTOL_OF_MAX * max(1.0, float(w.abs().max()))
            torch.testing.assert_close(g, w, rtol=0, atol=tol)
    differ = [(r, c) for r, outs in enumerate(later)
              for c, out in enumerate(outs)
              if not all(torch.equal(g, f) for g, f in zip(out, first[c]))]
    assert differ == []


@pytest.mark.cuda
def test_qr_grid_epoch_wraps_on_card(cuda):
    # each grid launch advances the epoch in the buffer's first word; where
    # it wraps, the last CTA clears the buffer, so words left with an epoch
    # 0 tag (planted here, NaN in value) cannot pass for the next launch's
    St, k = _grid_strip("tall", cuda)
    want = factor_strip_cuda(St, k)
    work = kqp._work[(St.device.index,
                      torch.cuda.current_stream(cuda).cuda_stream)]
    torch.cuda.synchronize()
    epoch = int(work[0]) & 0xFFFFFFFF
    assert int(work[0]) >> 32 == 0  # the finish count is back to 0
    factor_strip_cuda(St, k)
    torch.cuda.synchronize()
    assert int(work[0]) == (epoch + 1) % kqp.EPOCHS
    nan_step0 = (1 << 32) | 0x7FC00000  # tag of step 0 at epoch 0, NaN
    work[0] = kqp.EPOCHS - 1
    work[kqp.WORK_HEAD:] = nan_step0
    outs = [factor_strip_cuda(St, k) for _ in range(2)]
    torch.cuda.synchronize()
    assert int(work[0]) == 1
    for out in outs:
        assert all(torch.equal(g, f) for g, f in zip(out, want))


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
    cluster_before = factor_strip_cuda.cluster_launches
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        Q, R = householder_qr(A)
        still_on = torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    assert factor_strip_cuda.launches == before + n // 32
    # every strip of the QR goes through the cluster kernel
    assert factor_strip_cuda.cluster_launches == cluster_before + n // 32
    assert still_on  # the caller's setting is restored
    A64 = A.double()
    rel = torch.linalg.norm(Q.double() @ R.double() - A64) / torch.linalg.norm(
        A64)
    assert float(rel) <= 1e-6


@pytest.mark.cuda
def test_householder_qr_tall_through_grid_kernel(cuda):
    # 16384 live lanes and more: every strip goes through the grid kernel
    m, n = 16384, 512
    A = torch.tensor(np.random.default_rng(1).standard_normal((m, n)),
                     dtype=torch.float32, device=cuda)
    before = factor_strip_cuda.grid_launches
    launches = factor_strip_cuda.launches
    Q, R = householder_qr(A)
    torch.cuda.synchronize()
    assert factor_strip_cuda.launches == launches + n // 32
    assert factor_strip_cuda.grid_launches == before + n // 32
    A64 = A.double()
    rel = torch.linalg.norm(Q.double() @ R.double() - A64) / torch.linalg.norm(
        A64)
    assert float(rel) <= 1e-6
    orth = torch.linalg.norm(Q.double().T @ Q.double() - torch.eye(
        n, dtype=torch.float64, device=cuda))
    assert float(orth) <= 1e-4


# flash kernels vs their plain versions: float32 sums over T and d in
# another order (1e-4 of the largest value); bfloat16 outputs and the
# rounded P and dS keep 8 bits of mantissa, and the kernel's online softmax
# rounds exp(s - m_running) where the plain version rounds the normalized p
# (2e-2 of the largest value)
FLASH_RTOL_OF_MAX = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

# the shapes chip_smoke.py drives: the training slice (B 24, H 8, T 1024,
# d 128), T 2048 through flash_attention_long, d 64, and a ragged T
FLASH_SHAPES = [(24, 8, 1024, 128), (2, 8, 2048, 128), (4, 8, 1024, 64),
                (3, 2, 256, 32)]


def flash_inputs(shape, dtype, device, seed):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(shape), dtype=dtype,
                         device=device) for _ in range(4)]


def assert_close_of_max(got, want, dtype, what):
    tol = FLASH_RTOL_OF_MAX[dtype] * max(1.0, float(want.abs().max()))
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol, f"{what}: max_abs_err {err:.3e} > {tol:.3e}"


def test_flash_wrappers_reject_cpu_tensors():
    q = torch.zeros(1, 1, 64, 32)
    L = torch.zeros(1, 1, 64)
    with pytest.raises(ValueError, match="CUDA"):
        flash_fwd_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        flash_dq_cuda(q, q, q, q, L, L)
    with pytest.raises(ValueError, match="CUDA"):
        flash_dkdv_cuda(q, q, q, q, L, L)
    with pytest.raises(ValueError, match="CUDA"):
        flash_delta_cuda(q, q)


def test_flash_dispatcher_takes_plain_version_on_cpu():
    q, k, v, do = flash_inputs((1, 2, 64, 16), torch.float32, "cpu", 0)
    before = (flash_fwd_cuda.launches, flash_dq_cuda.launches,
              flash_dkdv_cuda.launches)
    for t in (q, k, v):
        t.requires_grad_(True)
    o = flash_attention(q, k, v)
    o.backward(do)
    o_ref, L_ref = flash_fwd_ref(q.detach(), k.detach(), v.detach())
    torch.testing.assert_close(o.detach(), o_ref, rtol=0, atol=0)
    want = flash_bwd_ref(q.detach(), k.detach(), v.detach(), o_ref, L_ref, do)
    for got, w in zip((q.grad, k.grad, v.grad), want):
        torch.testing.assert_close(got, w, rtol=0, atol=0)
    assert (flash_fwd_cuda.launches, flash_dq_cuda.launches,
            flash_dkdv_cuda.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", FLASH_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_flash_kernels_match_ref_on_card(cuda, shape, dtype, causal):
    q, k, v, do = flash_inputs(shape, dtype, cuda, seed=sum(shape))
    before = (flash_fwd_cuda.launches, flash_dq_cuda.launches,
              flash_dkdv_cuda.launches)
    o, L = flash_fwd_cuda(q, k, v, causal)
    o_ref, L_ref = flash_fwd_ref(q, k, v, causal)
    torch.cuda.synchronize()
    assert_close_of_max(o, o_ref, dtype, "o")
    assert_close_of_max(L, L_ref, dtype, "L")
    # the backward kernels from the plain forward's o and L, so each kernel
    # is held alone
    delta = torch.sum(do.float() * o_ref.float(), dim=-1)
    dq = flash_dq_cuda(q, k, v, do, L_ref, delta, causal)
    dk, dv = flash_dkdv_cuda(q, k, v, do, L_ref, delta, causal)
    torch.cuda.synchronize()
    want = flash_bwd_ref(q, k, v, o_ref, L_ref, do, causal)
    for got, w, what in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        assert_close_of_max(got, w, dtype, what)
    assert (flash_fwd_cuda.launches, flash_dq_cuda.launches,
            flash_dkdv_cuda.launches) == tuple(n + 1 for n in before)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal,window,group", [(True, None, 1),
                                                 (False, None, 1),
                                                 (True, 300, 2)],
                         ids=["causal", "full", "window_gqa"])
def test_flash_d256_kernels_match_ref_on_card(cuda, dtype, causal, window,
                                              group):
    """The widest heads, d 256: the bf16 forward reloads Q's fragments per
    key tile, dk/dv runs two 128-column slices, f32 takes 32-row tiles."""
    B, H, T, d = 2, 4, 1024, 256
    q, k, v, do = flash_inputs((B, H, T, d), dtype, cuda, seed=256 + group)
    k, v = k[:, :H // group].contiguous(), v[:, :H // group].contiguous()
    o, L = flash_fwd_cuda(q, k, v, causal, window, group)
    o_ref, L_ref = flash_fwd_ref(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert_close_of_max(o, o_ref, dtype, "o")
    assert_close_of_max(L, L_ref, dtype, "L")
    delta = torch.sum(do.float() * o_ref.float(), dim=-1)
    dq = flash_dq_cuda(q, k, v, do, L_ref, delta, causal, window, group)
    dk, dv = flash_dkdv_cuda(q, k, v, do, L_ref, delta, causal, window,
                             group)
    torch.cuda.synchronize()
    want = flash_bwd_ref(q, k, v, o_ref, L_ref, do, causal, window)
    for got, w, what in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        assert_close_of_max(got, w, dtype, what)


# The bf16 kernels (wgmma, TMA ring) at every width, (B, H, hk, T, d,
# window, causal): T 320 leaves the last 128-row block half empty (T % 128
# == 64), T 1024 fills it; windows 200 and 300 put the band's edge inside a
# tile, 512 on a tile boundary; groups 1, 2 and 4 (MQA).
BF16_CASES = [(2, 4, 4, 320, 32, None, True),
              (2, 4, 2, 320, 64, 200, True),
              (1, 4, 1, 320, 128, 300, False),
              (1, 4, 4, 320, 256, None, False),
              (2, 4, 2, 1024, 32, 512, True),
              (1, 8, 2, 1024, 64, None, False),
              (2, 4, 1, 1024, 128, 200, True),
              (1, 4, 2, 1024, 256, 300, True),
              (2, 4, 4, 1024, 128, 512, False)]


def check_bf16_kernels(q, k, v, do, causal, window, group):
    """o, L, dq, dk, dv of the kernels against the plain versions (the
    backward kernels from the plain forward's o and L); each kernel
    launches once. Returns the kernels' five outputs."""
    before = (flash_fwd_cuda.launches, flash_dq_cuda.launches,
              flash_dkdv_cuda.launches)
    o, L = flash_fwd_cuda(q, k, v, causal, window, group)
    o_ref, L_ref = flash_fwd_ref(q, k, v, causal, window)
    delta = torch.sum(do.float() * o_ref.float(), dim=-1)
    dq = flash_dq_cuda(q, k, v, do, L_ref, delta, causal, window, group)
    dk, dv = flash_dkdv_cuda(q, k, v, do, L_ref, delta, causal, window,
                             group)
    torch.cuda.synchronize()
    assert (flash_fwd_cuda.launches, flash_dq_cuda.launches,
            flash_dkdv_cuda.launches) == tuple(n + 1 for n in before)
    want = (o_ref, L_ref) + flash_bwd_ref(q, k, v, o_ref, L_ref, do, causal,
                                          window)
    got = (o, L, dq, dk, dv)
    for g, w, what in zip(got, want, ("o", "L", "dq", "dk", "dv")):
        assert g.shape == w.shape, what
        assert_close_of_max(g, w, torch.bfloat16, what)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("case", BF16_CASES,
                         ids=lambda c: "B{}H{}hk{}T{}d{}w{}{}".format(
                             *c[:6], "c" if c[6] else "n"))
def test_flash_bf16_kernels_match_ref_on_card(cuda, case):
    B, H, hk, T, d, window, causal = case
    q, k, v, do = stream_inputs(B, H, hk, T, d, torch.bfloat16, cuda,
                                seed=T + d + hk)
    check_bf16_kernels(q, k, v, do, causal, window, H // hk)


@pytest.mark.cuda
@pytest.mark.parametrize("T,window", [(320, 300), (1024, None)],
                         ids=["T320_w300", "T1024"])
def test_flash_bf16_kernels_on_head_views_on_card(cuda, T, window):
    """K7's layout: each head a strided column slice of (B, T, H*d), read
    and written in place; outputs keep that layout."""
    B, H, d = 2, 4, 128
    x = flash_inputs((B, T, H * d), torch.bfloat16, cuda, seed=T)
    heads = [t.view(B, T, H, d).transpose(1, 2) for t in x]
    o, _, dq, _, _ = check_bf16_kernels(*heads, True, window, 1)
    assert o.stride() == heads[0].stride() and dq.stride() == o.stride()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [32, 128, 256])
def test_flash_delta_kernel_matches_ref_on_card(cuda, d, dtype):
    """rowsum(dO * O) in float32 through the kernel, on head views of
    (B, T, H*d) as the model hands them over, against the plain version
    (the same products, summed in another order)."""
    from linalg_tpu_torch.nn.flash import flash_delta_ref

    o, do = (t.view(2, 320, 4, d).transpose(1, 2) for t in flash_inputs(
        (2, 320, 4 * d), dtype, cuda, seed=d)[:2])
    before = flash_delta_cuda.launches
    got = flash_delta_cuda(o, do)
    torch.cuda.synchronize()
    assert flash_delta_cuda.launches == before + 1
    want = flash_delta_ref(o, do)
    assert got.shape == want.shape == (2, 4, 320)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_flash_bf16_kernels_give_equal_bits_twice(cuda):
    """No atomics: each output tile has one owner and every sum runs in a
    fixed order, so two runs agree bit for bit."""
    q, k, v, do = stream_inputs(2, 4, 2, 1024, 128, torch.bfloat16, cuda, 7)
    runs = [check_bf16_kernels(q, k, v, do, True, 300, 2) for _ in range(2)]
    for a, b, what in zip(*runs, ("o", "L", "dq", "dk", "dv")):
        assert torch.equal(a, b), what


@pytest.mark.cuda
def test_flash_d160_through_the_picker_on_card(cuda):
    """A d_head of 160 takes the flash kernels at 256 wide (JAX's rule:
    every d_head >= 8), zero-padded, against the same through the plain
    versions."""
    from linalg_tpu_torch.models.gpt import _REMAT_SDPA, _pick_attn

    attn = _pick_attn(1024, 160, "cuda")
    assert attn is not _REMAT_SDPA
    x = flash_inputs((2, 1024, 2, 160), torch.float32, cuda, seed=160)
    before = flash_fwd_cuda.launches
    grads = []
    for f in (attn, lambda q, k, v, mask: flash_attention_ref(q, k, v)):
        q, k, v = (t.clone().requires_grad_(True) for t in x[:3])
        o = f(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), None)
        o.backward(x[3].transpose(1, 2))
        grads.append([o.detach(), q.grad, k.grad, v.grad])
    assert flash_fwd_cuda.launches == before + 1
    for got, w, what in zip(*grads, ("o", "dq", "dk", "dv")):
        assert_close_of_max(got, w, torch.float32, what)


@pytest.mark.cuda
@pytest.mark.parametrize("T,fn", [(1024, flash_attention),
                                  (2048, flash_attention_long),
                                  (1000, flash_attention)],
                         ids=["flash", "flash_long", "ragged"])
def test_flash_attention_autograd_on_card(cuda, T, fn):
    """The autograd Function through the kernels against the same Function
    through the plain versions, on transposed (non-contiguous) views as the
    model hands them over; T 1000 through the picker's padding."""
    x = flash_inputs((2, T, 4, 64), torch.float32, cuda, seed=T)
    attn = _padded_attn(fn, T, 1024) if T % 256 else (
        lambda q, k, v, mask: fn(q, k, v, True))
    ref = _padded_attn(flash_attention_ref, T, 1024) if T % 256 else (
        lambda q, k, v, mask: flash_attention_ref(q, k, v, True))
    grads = []
    for f in (attn, ref):
        q, k, v = (t.clone().requires_grad_(True) for t in x[:3])
        o = f(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), None)
        o.backward(x[3].transpose(1, 2))
        grads.append([o.detach(), q.grad, k.grad, v.grad])
    for got, w, what in zip(*grads, ("o", "dq", "dk", "dv")):
        assert_close_of_max(got, w, torch.float32, what)


@pytest.mark.cuda
def test_flash_kernels_reject_what_they_do_not_take(cuda):
    q, k, v, do = flash_inputs((2, 2, 128, 64), torch.float32, cuda, 9)
    L = torch.zeros(2, 2, 128, device=cuda)
    with pytest.raises(ValueError, match="d_head"):
        flash_fwd_cuda(*(t[..., :48].contiguous() for t in (q, k, v)))
    with pytest.raises(ValueError, match="dtype"):
        flash_fwd_cuda(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="multiple"):
        flash_fwd_cuda(*(t[:, :, :100].contiguous() for t in (q, k, v)))
    with pytest.raises(ValueError, match="contiguous"):  # d axis strided
        flash_fwd_cuda(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="grouped"):
        flash_fwd_cuda(q, k[:, :1].contiguous(), v[:, :1].contiguous())
    with pytest.raises(ValueError, match="float32"):
        flash_dq_cuda(q, k, v, do, L.half(), L)
    with pytest.raises(ValueError, match="share one dtype"):
        flash_dkdv_cuda(q, k, v, do.bfloat16(), L, L)


# K4 through the same kernels: (B, H, hk, T, d, window, causal). The slice's
# shape at a smaller batch; MQA with a window of 300 (not a multiple of 64:
# the first key tile of a query tile is wholly banned for its later rows)
# and no causal ban; window 1 (each row sees only itself); a band with no
# group; T 8192 with no window through the stream's group path.
STREAM_CASES = [(2, 4, 2, 4096, 128, 512, True),
                (1, 4, 1, 1024, 64, 300, False),
                (1, 4, 1, 768, 128, 300, True),
                (2, 2, 1, 256, 32, 1, True),
                (1, 4, 4, 512, 64, 100, True),
                (1, 4, 2, 8192, 128, None, True)]


def stream_inputs(B, H, hk, T, d, dtype, device, seed):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(shape), dtype=dtype,
                         device=device)
            for shape in ((B, H, T, d), (B, hk, T, d), (B, hk, T, d),
                          (B, H, T, d))]


def test_flash_wrappers_refuse_a_group_that_does_not_divide():
    q = torch.zeros(1, 4, 64, 32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_fwd_cuda(q, q[:, :2], q[:, :2], group=2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", STREAM_CASES,
                         ids=lambda c: "B{}H{}hk{}T{}d{}w{}{}".format(
                             *c[:6], "c" if c[6] else "n"))
def test_stream_kernels_match_ref_on_card(cuda, case, dtype):
    """The kernels with a band and a group against the plain versions:
    o and L (the wholly-banned-tile rows show in L first), then dq and the
    grouped dk/dv from the plain forward's o and L."""
    B, H, hk, T, d, window, causal = case
    q, k, v, do = stream_inputs(B, H, hk, T, d, dtype, cuda, seed=T + d)
    g = H // hk
    o, L = flash_fwd_cuda(q, k, v, causal, window, g)
    o_ref, L_ref = flash_fwd_ref(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert_close_of_max(o, o_ref, dtype, "o")
    assert_close_of_max(L, L_ref, dtype, "L")
    delta = torch.sum(do.float() * o_ref.float(), dim=-1)
    dq = flash_dq_cuda(q, k, v, do, L_ref, delta, causal, window, g)
    dk, dv = flash_dkdv_cuda(q, k, v, do, L_ref, delta, causal, window, g)
    torch.cuda.synchronize()
    assert dk.shape == k.shape and dv.shape == v.shape
    want = flash_bwd_ref(q, k, v, o_ref, L_ref, do, causal, window)
    for got, w, what in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        assert_close_of_max(got, w, dtype, what)


@pytest.mark.cuda
@pytest.mark.parametrize("T,hk,window", [(1024, 2, 300), (1280, 1, 64)],
                         ids=["gqa_w300", "mqa_w64"])
def test_stream_autograd_on_card(cuda, T, hk, window):
    """flash_attention_stream through the kernels against the same
    Function through the plain versions, on transposed views of (B, T, h,
    d) as the model hands them over; the kernels launch once each."""
    rng = np.random.default_rng(T)
    x = [torch.tensor(rng.standard_normal((2, T, h, 64)),
                      dtype=torch.float32, device=cuda) for h in (4, hk, hk)]
    dO = torch.tensor(rng.standard_normal((2, T, 4, 64)),
                      dtype=torch.float32, device=cuda).transpose(1, 2)
    before = (flash_fwd_cuda.launches, flash_dq_cuda.launches,
              flash_dkdv_cuda.launches)
    outs = []
    for f in (flash_attention_stream, flash_attention_ref):
        q, k, v = (t.clone().requires_grad_(True) for t in x)
        o = f(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), True,
              window)
        o.backward(dO)
        outs.append([o.detach(), q.grad, k.grad, v.grad])
    torch.cuda.synchronize()
    assert (flash_fwd_cuda.launches, flash_dq_cuda.launches,
            flash_dkdv_cuda.launches) == tuple(n + 1 for n in before)
    for got, w, what in zip(*outs, ("o", "dq", "dk", "dv")):
        assert_close_of_max(got, w, torch.float32, what)


# K7: the flash kernels on head views of (B, T, H*d) tensors
# (nn/flash_btd.py), the published shape and the JAX tests' small ones
BTD_SHAPES = [(128, 256, 4, 128), (2, 64, 2, 128), (3, 128, 4, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", BTD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_btd_through_kernels_matches_ref_on_card(cuda, shape, dtype):
    """attention_btd through the kernels (strided head views, outputs
    written in (B, T, H*d)) against the same Function through the plain
    versions; each kernel launches once."""
    from linalg_tpu_torch.nn.flash_btd import attention_btd, attention_btd_ref

    B, T, H, d = shape
    x = flash_inputs((B, T, H * d), dtype, cuda, seed=B + T)
    before = (flash_fwd_cuda.launches, flash_dq_cuda.launches,
              flash_dkdv_cuda.launches)
    outs = []
    for fn in (attention_btd, attention_btd_ref):
        q, k, v = (t.clone().requires_grad_(True) for t in x[:3])
        o = fn(q, k, v, H)
        o.backward(x[3])
        outs.append([o.detach(), q.grad, k.grad, v.grad])
    torch.cuda.synchronize()
    assert (flash_fwd_cuda.launches, flash_dq_cuda.launches,
            flash_dkdv_cuda.launches) == tuple(n + 1 for n in before)
    assert outs[0][0].is_contiguous() and outs[0][0].shape == (B, T, H * d)
    for got, w, what in zip(*outs, ("o", "dq", "dk", "dv")):
        assert_close_of_max(got, w, dtype, what)


# K8/K9 (kernels/csrc/fused_layer.cu) vs their plain versions, as a share
# of max|want|: float32 sums in another order (1e-4); bf16 outputs keep 8
# bits of mantissa, and x^, relu(z) and dz round where the plain versions
# round, but an element on a rounding boundary may round the other way
# (2e-2)
FUSED_RTOL_OF_MAX = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# The outputs of K9's backward behind the ReLU mask (dx, dg, db, dW1, db1):
# a z within the sums' rounding of 0 may fall on the other side of the
# ReLU in the two versions, which moves that dz entry by all of da, so
# they are held by ||got - want|| / ||want|| instead (a few such entries
# at N 16384 move it by ~3e-4)
FUSED_MASKED = ("ffn dx", "ffn dg", "ffn db", "dW1", "db1")
FUSED_RTOL_OF_NORM = {torch.float32: 1e-3, torch.bfloat16: 2e-2}


def fused_error(got, want, dtype, what):
    """(error, tolerance) of one output: max abs against a share of
    max|want|, or, behind K9's ReLU mask, the relative norm."""
    g, w = got.float(), want.float()
    if what in FUSED_MASKED:
        return (float(torch.linalg.norm(g - w) / torch.linalg.norm(w)),
                FUSED_RTOL_OF_NORM[dtype])
    return (float((g - w).abs().max()),
            FUSED_RTOL_OF_MAX[dtype] * max(1.0, float(w.abs().max())))
# (N, D, F): the published width at B 64 x T 256; train_big's width (D
# 1024: K9's forward runs two 512-column groups); a D past 1024 whose
# normalized rows no longer fit in shared memory (K9's bf16 forward streams
# x; five column groups, the last 128 wide); a ragged N (5 row tiles: the
# 8 row groups of the cross-row sums are uneven, some empty, and the
# 128-row tiles of the bf16 kernels end half past N); one tile
FUSED_SHAPES = [(16384, 512, 2048), (4096, 1024, 4096), (192, 2176, 384),
                (320, 128, 256), (64, 256, 384)]


def fused_inputs(N, D, F, dtype, device, seed):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, shift=0.0):
        return torch.tensor(rng.standard_normal(shape) * scale + shift,
                            dtype=dtype, device=device)

    x = t(N, D)
    qkv = (x, t(D, scale=0.1, shift=1.0), t(D, scale=0.1),
           *(t(D, D, scale=D ** -0.5) for _ in range(3)))
    ffn = (x, qkv[1], qkv[2], t(D, F, scale=D ** -0.5), t(F, scale=0.1),
           t(F, D, scale=F ** -0.5), t(D, scale=0.1))
    return qkv, ffn, [t(N, D) for _ in range(3)]


def fused_counts():
    from linalg_tpu_torch.kernels import fused_layer as kf

    return (kf.ln_qkv_fwd_cuda.launches, kf.ln_qkv_bwd_cuda.launches,
            kf.ln_ffn_fwd_cuda.launches, kf.ln_ffn_bwd_cuda.launches)


def test_fused_wrappers_reject_cpu_tensors():
    from linalg_tpu_torch.kernels import fused_layer as kf

    qkv, ffn, dys = fused_inputs(64, 128, 128, torch.float32, "cpu", 0)
    with pytest.raises(ValueError, match="CUDA"):
        kf.ln_qkv_fwd_cuda(*qkv)
    with pytest.raises(ValueError, match="CUDA"):
        kf.ln_qkv_bwd_cuda(*qkv, *dys)
    with pytest.raises(ValueError, match="CUDA"):
        kf.ln_ffn_fwd_cuda(*ffn)
    with pytest.raises(ValueError, match="CUDA"):
        kf.ln_ffn_bwd_cuda(*ffn[:6], dys[0])


def test_fused_dispatchers_take_plain_version_on_cpu():
    from linalg_tpu_torch.nn.fused_layer import ln_ffn, ln_qkv

    qkv, ffn, dys = fused_inputs(64, 128, 128, torch.float32, "cpu", 1)
    before = fused_counts()
    xs = [t.clone().requires_grad_(True) for t in qkv]
    torch.autograd.grad(ln_qkv(*xs), xs, dys)
    xs = [t.clone().requires_grad_(True) for t in ffn]
    torch.autograd.grad(ln_ffn(*xs), xs, dys[0])
    assert fused_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", FUSED_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_fused_kernels_match_ref_on_card(cuda, shape, dtype):
    """Every output and gradient of K8 and K9 against the plain versions;
    each wrapper launches once."""
    from linalg_tpu_torch.kernels import fused_layer as kf
    from linalg_tpu_torch.nn import fused_layer as fl

    qkv, ffn, dys = fused_inputs(*shape, dtype, cuda, seed=sum(shape))
    before = fused_counts()
    got = [*kf.ln_qkv_fwd_cuda(*qkv), *kf.ln_qkv_bwd_cuda(*qkv, *dys),
           kf.ln_ffn_fwd_cuda(*ffn), *kf.ln_ffn_bwd_cuda(*ffn[:6], dys[0])]
    torch.cuda.synchronize()
    assert fused_counts() == tuple(n + 1 for n in before)
    want = [*fl.ln_qkv_ref(*qkv), *fl.ln_qkv_bwd_ref(*qkv, *dys),
            fl.ln_ffn_ref(*ffn), *fl.ln_ffn_bwd_ref(*ffn[:6], dys[0])]
    names = ["q", "k", "v", "dx", "dg", "db", "dWq", "dWk", "dWv", "f",
             "ffn dx", "ffn dg", "ffn db", "dW1", "db1", "dW2", "db2"]
    for g, w, what in zip(got, want, names):
        assert g.shape == w.shape and g.dtype == w.dtype, what
        err, tol = fused_error(g, w, dtype, what)
        assert err <= tol, f"{what}: error {err:.3e} > {tol:.3e}"


@pytest.mark.cuda
def test_fused_backward_is_deterministic_on_card(cuda):
    """No float atomics: two backward runs give the same bits."""
    from linalg_tpu_torch.kernels import fused_layer as kf

    qkv, ffn, dys = fused_inputs(1024, 256, 512, torch.float32, cuda, 5)
    for fn, args in ((kf.ln_qkv_bwd_cuda, (*qkv, *dys)),
                     (kf.ln_ffn_bwd_cuda, (*ffn[:6], dys[0]))):
        a, b = fn(*args), fn(*args)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_fused_kernels_reject_what_they_do_not_take(cuda):
    from linalg_tpu_torch.kernels import fused_layer as kf

    qkv, ffn, _ = fused_inputs(128, 128, 256, torch.float32, cuda, 6)
    x = qkv[0]
    with pytest.raises(ValueError, match="multiple of 64"):
        kf.ln_qkv_fwd_cuda(x[:100].contiguous(), *qkv[1:])
    with pytest.raises(ValueError, match="dtype"):
        kf.ln_qkv_fwd_cuda(x.double(), *(t.double() for t in qkv[1:]))
    with pytest.raises(ValueError, match="share"):
        kf.ln_qkv_fwd_cuda(x.bfloat16(), *qkv[1:])
    with pytest.raises(ValueError, match="contiguous"):
        kf.ln_qkv_fwd_cuda(x, *qkv[1:3], qkv[3].T, *qkv[4:])
    with pytest.raises(ValueError, match="shape"):
        kf.ln_ffn_fwd_cuda(*ffn[:5], ffn[5][:128].contiguous(), ffn[6])


# ----- ring attention (K10/K11, csrc/ring_attention.cu) ----------------

def ring_inputs(B, h, T, d, dtype, device, seed):
    """q, k, v and dO (B, h, T, d) from a numpy seed."""
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal((B, h, T, d)), dtype=dtype,
                         device=device) for _ in range(4)]


def ring_both(x, n, plain, devices=None, **kw):
    """(o, L, dq, dk, dv) of the ring over n ranks on x's device (or on
    ``devices``), through the kernels or (``plain``) their plain versions;
    the backward from the forward's own o and L."""
    from linalg_tpu_torch.parallel import make_mesh
    from linalg_tpu_torch.parallel.ring_pallas import (
        ring_attention_pallas_bwd_local, ring_attention_pallas_local)

    q, k, v, do = x
    mesh = make_mesh((n,), ("sp",), devices or [q.device] * n)
    o, L = ring_attention_pallas_local(q, k, v, mesh=mesh, with_lse=True,
                                       plain=plain, **kw)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    grads = ring_attention_pallas_bwd_local(q, k, v, do, L, delta,
                                            mesh=mesh, plain=plain, **kw)
    return (o, L) + grads


def test_ring_wrappers_reject_cpu_tensors():
    from linalg_tpu_torch.kernels.ring_attention import (ring_bwd_cuda,
                                                         ring_fwd_cuda)

    BH, n, Tl, D = 2, 2, 64, 32
    q = [torch.zeros(BH, Tl, D) for _ in range(n)]
    f = [torch.zeros(BH, Tl) for _ in range(n)]
    kw = dict(H=1, causal=True, window=None, slopes=None, scale=0.125)
    with pytest.raises(ValueError, match="CUDA"):
        ring_fwd_cuda(q, q, q, q, f, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        ring_bwd_cuda(q, q, q, q, f, f, q, q, q, **kw)


# (B, h, T, d, n, causal, window, alibi): ragged Tl (100, 125, 45, 250),
# padded widths (48 -> 64), d 256, dead chunks behind the band
RING_CASES = [
    (2, 2, 400, 64, 4, True, None, False),
    (1, 2, 1000, 128, 8, True, 300, False),
    (2, 4, 512, 128, 2, True, None, True),
    (2, 2, 360, 64, 8, False, None, False),
    (1, 2, 1000, 128, 4, True, 200, True),
    (1, 2, 256, 48, 4, True, 100, True),
    (1, 1, 128, 256, 2, True, None, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", RING_CASES,
                         ids=lambda c: "B{}h{}T{}d{}n{}{}{}{}".format(
                             *c[:5], "c" if c[5] else "f",
                             f"w{c[6]}" if c[6] else "",
                             "alibi" if c[7] else ""))
def test_ring_kernels_match_plain_on_card(cuda, case, dtype):
    """K10 and K11 against their plain versions on the same inputs: the
    kernels' one call per direction against the plain steps through the
    slots, rotations and bundle lap; launches one per ring call, at any n.
    Tolerance as chip_smoke.py's: f32 1e-4, bf16 2e-2 x max|want| (sums in
    another order; bf16 rounds the outputs)."""
    from linalg_tpu_torch.kernels import ring_attention as kr
    from linalg_tpu_torch.nn.positional import alibi_slopes

    B, h, T, d, n, causal, window, alibi = case
    x = ring_inputs(B, h, T, d, dtype, cuda, seed=T + n)
    kw = dict(causal=causal, window=window,
              slopes=tuple(alibi_slopes(h).tolist()) if alibi else None)
    before = (kr.ring_fwd_cuda.launches, kr.ring_bwd_cuda.launches)
    got = ring_both(x, n, False, **kw)
    torch.cuda.synchronize()
    assert (kr.ring_fwd_cuda.launches - before[0],
            kr.ring_bwd_cuda.launches - before[1]) == (1, 1)
    want = ring_both(x, n, True, **kw)
    rtol = 1e-4 if dtype == torch.float32 else 2e-2
    for what, g, w in zip(("o", "L", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, what
        err = float((g.float() - w.float()).abs().max())
        tol = rtol * max(1.0, float(w.float().abs().max()))
        assert err <= tol, f"{what}: error {err:.3e} > {tol:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(2, 4, 1024, 128, 4, True, 300, False),
                                  (2, 2, 1000, 64, 4, True, None, True),
                                  (1, 2, 512, 256, 2, False, None, False)],
                         ids=["window", "ragged_alibi", "d256_full"])
def test_ring_bf16_kernels_track_f32_as_the_plain_ring(cuda, case):
    """The bf16 kernels keep P and dS in ~16 bits (hi + lo products), as
    the TPU kernel keeps them in f32: on the same bf16 inputs, their o, dq,
    dk and dv are no farther from the f32 plain ring than the bf16 plain
    ring (f32 math, outputs rounded to bf16) is, x 1.1. Rounding P or dS
    once to bf16 would put them ~2^-9 of max|o| farther."""
    from linalg_tpu_torch.nn.positional import alibi_slopes

    B, h, T, d, n, causal, window, alibi = case
    x = ring_inputs(B, h, T, d, torch.bfloat16, cuda, seed=T + d)
    kw = dict(causal=causal, window=window,
              slopes=tuple(alibi_slopes(h).tolist()) if alibi else None)
    ref = ring_both([t.float() for t in x], n, True, **kw)
    plain = ring_both(x, n, True, **kw)
    kern = ring_both(x, n, False, **kw)
    torch.cuda.synchronize()
    for i, what in ((0, "o"), (2, "dq"), (3, "dk"), (4, "dv")):
        off_plain = float((plain[i].float() - ref[i]).abs().max())
        off_kern = float((kern[i].float() - ref[i]).abs().max())
        assert off_kern <= 1.1 * off_plain, (
            f"{what}: kernels {off_kern:.3e} off f32, plain {off_plain:.3e}")


def test_ring_rank_lists_reject_cpu_tensors_and_mixed_shapes():
    from linalg_tpu_torch.kernels.ring_attention import ring_fwd_cuda

    kw = dict(H=1, causal=True, window=None, slopes=None, scale=0.125)
    q = [torch.zeros(2, 64, 32) for _ in range(2)]
    f = [torch.zeros(2, 64) for _ in range(2)]
    with pytest.raises(ValueError, match="CUDA"):
        ring_fwd_cuda(q, q, q, q, f, **kw)
    with pytest.raises(ValueError, match="2 entries"):
        ring_fwd_cuda(q, q[:1], q, q, f, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", RING_CASES,
                         ids=lambda c: "B{}h{}T{}d{}n{}{}{}{}".format(
                             *c[:5], "c" if c[5] else "f",
                             f"w{c[6]}" if c[6] else "",
                             "alibi" if c[7] else ""))
def test_ring_rank_tables_equal_stacked_on_card(cuda, case, dtype,
                                                monkeypatch):
    """K10/K11 through per-rank chunk tables, each rank's chunks a tensor
    of its own on the card (head stride Tl), against the ranks' views of
    the rank-stacked inputs (head stride T): the same bits, one launch per
    direction either way."""
    from linalg_tpu_torch.kernels import ring_attention as kr
    from linalg_tpu_torch.nn.positional import alibi_slopes
    from linalg_tpu_torch.parallel import ring_pallas

    B, h, T, d, n, causal, window, alibi = case
    x = ring_inputs(B, h, T, d, dtype, cuda, seed=T + n + 1)
    kw = dict(causal=causal, window=window,
              slopes=tuple(alibi_slopes(h).tolist()) if alibi else None)
    stacked = ring_both(x, n, False, **kw)
    monkeypatch.setattr(ring_pallas, "_ring_size", lambda mesh, axis, dev: (
        n, [[dev] * n]))
    before = (kr.ring_fwd_cuda.launches, kr.ring_bwd_cuda.launches)
    tables = ring_both(x, n, False, **kw)
    torch.cuda.synchronize()
    assert (kr.ring_fwd_cuda.launches - before[0],
            kr.ring_bwd_cuda.launches - before[1]) == (1, 1)
    for what, a, b in zip(("o", "L", "dq", "dk", "dv"), tables, stacked):
        assert torch.equal(a, b), what


@pytest.mark.cuda
def test_ring_across_two_cards_equals_one_card(cuda):
    """The ring's ranks on two cards (each card's launch reading the
    other's chunks in place) give the one-card bits; a launch a card and
    direction."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from linalg_tpu_torch.kernels import ring_attention as kr

    x = ring_inputs(2, 4, 1024, 128, torch.bfloat16, cuda, seed=21)
    one = ring_both(x, 4, False, window=300)
    before = (kr.ring_fwd_cuda.launches, kr.ring_bwd_cuda.launches)
    two = ring_both(x, 4, False, window=300,
                    devices=["cuda:0", "cuda:0", "cuda:1", "cuda:1"])
    torch.cuda.synchronize()
    assert (kr.ring_fwd_cuda.launches - before[0],
            kr.ring_bwd_cuda.launches - before[1]) == (2, 2)
    assert all(torch.equal(a, b) for a, b in zip(one, two))


@pytest.mark.cuda
def test_ring_backward_is_deterministic_on_card(cuda):
    """No atomics: two backward runs give the same bits."""
    x = ring_inputs(2, 2, 512, 128, torch.float32, cuda, seed=9)
    a = ring_both(x, 4, False, window=200)
    b = ring_both(x, 4, False, window=200)
    assert all(torch.equal(s, t) for s, t in zip(a, b))


@pytest.mark.cuda
def test_ring_autograd_on_card(cuda):
    """make_ring_attention_pallas through autograd on the card equals the
    plain ring (parallel.ring) in f32."""
    from linalg_tpu_torch.parallel import (make_mesh, make_ring_attention,
                                           make_ring_attention_pallas)

    mesh = make_mesh((4,), ("sp",), [cuda] * 4)
    x = ring_inputs(2, 4, 1024, 64, torch.float32, cuda, seed=3)
    outs = []
    for make in (make_ring_attention_pallas, make_ring_attention):
        q, k, v = (t.clone().requires_grad_(True) for t in x[:3])
        o = make(mesh, window=300)(q, k, v)
        o.backward(x[3])
        outs.append((o.detach(), q.grad, k.grad, v.grad))
    for g, w in zip(*outs):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def _engine_tokens(params, cfg, device, reqs, adapters=(), **kw):
    from linalg_tpu_torch.serve import Request, ServeEngine

    eng = ServeEngine(params, cfg, n_slots=3, chunk=4, top_k=1,
                      prefill_window=16, paged=True, page=16, device=device,
                      **kw)
    for ad in adapters:
        eng.register_lora(*ad)
    ids = [eng.submit(Request(p, n, lora_id=lid)) for p, n, lid in reqs]
    done = {c.request_id: c for c in eng.run()}
    return [done[i].tokens for i in ids], eng


@pytest.mark.cuda
@pytest.mark.parametrize("ops", ["int8", "lora"])
def test_paged_kernel_under_int8_and_lora_ops(cuda, ops):
    """K5/K6 with int8 decode ops or the per-slot LoRA side-path around
    them: one paged kernel call a layer and decode step, and float32
    greedy tokens equal to the gather engine's (the plain read)."""
    from linalg_tpu_torch.models.gpt import GPTConfig, init_gpt_params
    from linalg_tpu_torch.models.lora import LoRAConfig, init_lora_params

    cfg = GPTConfig(vocab_size=31, d_model=128, n_heads=4, n_kv_heads=2,
                    n_layers=2, ctx_len=128)
    params = init_gpt_params(cfg, seed=7, device=cuda)
    rng = np.random.default_rng(9)
    reqs = [(rng.integers(0, 31, int(n)).tolist(), int(b), i % 2)
            for i, (n, b) in enumerate(((3, 20), (30, 9), (12, 16),
                                        (5, 6), (20, 14)))]
    kw, adapters = {}, ()
    if ops == "int8":
        kw = dict(quant="int8")
        reqs = [(p, n, 0) for p, n, _ in reqs]
    else:
        ad = init_lora_params(params, LoRAConfig(rank=4), seed=1)
        for k, v in ad["layers"].items():
            if k.endswith("_B"):
                ad["layers"][k] = torch.tensor(
                    rng.normal(0, 0.05, tuple(v.shape)), dtype=torch.float32,
                    device=cuda)
        adapters = ((ad, LoRAConfig(rank=4)),)
        kw = dict(max_loras=1, lora_rank=4)
    outs = {}
    for read in ("kernel", "gather"):
        before = paged_attention_cuda.launches
        outs[read], eng = _engine_tokens(params, cfg, cuda, reqs, adapters,
                                         paged_attn=read, **kw)
        n = paged_attention_cuda.launches - before
        assert n == (eng.stats["chunks"] * eng.chunk * cfg.n_layers
                     if read == "kernel" else 0)
    assert outs["kernel"] == outs["gather"]
