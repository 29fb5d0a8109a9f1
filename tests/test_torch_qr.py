"""The port's QR (linalg_tpu_torch/ops/qr.py, ops/qr_panel.py) against the
JAX package's.

The same numpy-seeded matrices go through both packages on the CPU. The
JAX Pallas kernels run in interpret mode, as tests/test_qr_pallas.py runs
them. Tolerances: the panel sweeps within 1e-5 (float32, sums in another
order; the tolerance test_qr_pallas.py holds factor_strip to against
factor_panel), the blocked float32 drivers within 2e-4 (test_qr_pallas.py's
bound between two float32 drivers), float64 QR and least squares within
1e-10, and test_qr.py's orthogonality bounds.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from linalg_tpu.ops.pallas import qr_panel as jqp
from linalg_tpu.ops.qr import (
    householder_qr as j_householder_qr,
    least_squares_householder_qr as j_lsq_hh,
    least_squares_qr as j_lsq_mgs,
    qr as j_qr,
)
from linalg_tpu_torch.kernels import qr_panel as kqp
from linalg_tpu_torch.kernels.qr_panel import factor_strip_cuda
from linalg_tpu_torch.ops import qr_panel as tqp
from linalg_tpu_torch.ops.qr import (
    householder_qr,
    least_squares_householder_qr,
    least_squares_qr,
    qr,
)

torch.set_num_threads(2)

SWEEP_ATOL = 1e-5
DRIVER_ATOL = 2e-4
F64_ATOL = 1e-10


def _rand(shape, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, atol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# the panel sweeps (K1 / K12) and their dispatchers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["strip", "panel"])
@pytest.mark.parametrize("k", [0, 8])
def test_sweep_ref_matches_jax_kernel(kind, k):
    A = _rand((24, 8), 11)
    jfn = jqp.factor_strip if kind == "strip" else jqp.factor_panel
    tfn = tqp.factor_strip_ref if kind == "strip" else tqp.factor_panel_ref
    with pltpu.force_tpu_interpret_mode():
        want = jfn(jnp.asarray(A.T), k, 8)
    got = tfn(torch.from_numpy(A.T.copy()), k)
    for g, w in zip(got, want):
        _close(g, w, SWEEP_ATOL)


@pytest.mark.parametrize("kind", ["strip", "panel"])
def test_sweep_ref_zero_column_skipped(kind):
    A = _rand((16, 4), 4)
    A[:, 2] = 0.0
    jfn = jqp.factor_strip if kind == "strip" else jqp.factor_panel
    tfn = tqp.factor_strip_ref if kind == "strip" else tqp.factor_panel_ref
    with pltpu.force_tpu_interpret_mode():
        want = jfn(jnp.asarray(A.T), 0, 4)
    St, Vt, Tt = tfn(torch.from_numpy(A.T.copy()), 0)
    # no reflector and tau = 0, exactly: padded columns rely on it
    assert float(Vt[2].abs().max()) == 0.0
    assert float(Tt[2, 2]) == 0.0
    for g, w in zip((St, Vt, Tt), want):
        _close(g, w, SWEEP_ATOL)


def test_sweep_ref_compact_wy_identity():
    m, b = 24, 8
    A = _rand((m, b), 1)
    St, Vt, Tt = tqp.factor_panel_ref(torch.from_numpy(A.T.copy()), 0)
    V, T = Vt.double().numpy().T, Tt.double().numpy().T
    Qp = np.eye(m) - V @ T @ V.T
    assert np.linalg.norm(Qp.T @ Qp - np.eye(m)) < 1e-5
    assert np.linalg.norm(Qp @ St.double().numpy().T - A) < 1e-4


# the cluster kernel's split algebra (ops/qr_panel.py::_cluster_sweep_ref):
# C lane ranges, strips (b, m, k), and a zero column (row 3 of St)
CLUSTER_CASES = [(32, 1024, 0, None), (32, 1030, 7, None),
                 (64, 512, 100, None), (32, 1030, 7, 3)]
# float32 sums over up to m lanes in another order: 1e-5 of max|want|
# (the kernel-vs-plain tolerance of tests/test_torch_kernels.py); float64
# 1e-12 of max|want|
SPLIT_RTOL_OF_MAX = {np.float32: 1e-5, np.float64: 1e-12}


def _strip(b, m, k, zero, dtype):
    St = _rand((b, m), b + m + k, dtype)
    if zero is not None:
        St[zero] = 0.0
    return St


@pytest.fixture(scope="module")
def jax_strips():
    """JAX factor_strip (interpret mode) of each CLUSTER_CASES strip in
    float32 and float64, computed once per module on first use."""
    cache = {}

    def get(case, dtype):
        if (case, dtype) not in cache:
            b, m, k, zero = case
            with pltpu.force_tpu_interpret_mode():
                out = jqp.factor_strip(jnp.asarray(_strip(*case, dtype)), k,
                                       b)
            cache[case, dtype] = [np.asarray(o) for o in out]
        return cache[case, dtype]

    return get


def _close_of_max(got, want, rtol):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=rtol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("case", CLUSTER_CASES,
                         ids=["b32_m1024", "b32_m1030_k7", "b64_m512_k100",
                              "zero_column"])
@pytest.mark.parametrize("C", [1, 2, 5, 16])
def test_cluster_split_algebra(jax_strips, case, C):
    """The cluster kernel's arithmetic (C lane ranges, folded dots summed
    in rank order, Tt as CTA 0 builds it) against the plain sweep and
    against JAX's factor_strip in interpret mode, float32 and float64."""
    b, m, k, zero = case
    for dtype in (np.float32, np.float64):
        St = torch.from_numpy(_strip(*case, dtype))
        got = tqp._cluster_sweep_ref(St, k, C)
        rtol = SPLIT_RTOL_OF_MAX[dtype]
        if dtype == np.float32:
            for g, w in zip(got, tqp.factor_strip_ref(St, k)):
                _close_of_max(g, w, rtol)
        for g, w in zip(got, jax_strips(case, dtype)):
            _close_of_max(g, w, rtol)
        if zero is not None:  # exact skip: no reflector, tau = 0
            assert float(got[1][zero].abs().max()) == 0.0
            assert float(got[2][zero, zero]) == 0.0
            assert torch.equal(got[0][zero], St[zero])


def test_cluster_shape_rule():
    """The shape rule between the two kernels: the cluster kernel up to 64
    rows and 16 CTAs of 256 live lanes (b <= 32: then 16 of 512, two lanes
    a thread), C shrinking with the live lanes down to 1; everything else
    the grid kernel, at most 128 CTAs of at least 64 live lanes (a multiple
    of 32), S and Vt on chip while 2 b (L + 1) floats fit."""
    shape, grid = kqp.cluster_shape, kqp.grid_shape
    assert shape(32, 4096, 0) == (16, 1)
    assert shape(32, 4096, 2048) == (8, 1)
    assert shape(32, 4096, 4064) == (1, 1)
    assert shape(32, 4096, 4095) == (1, 1)
    assert shape(32, 1030, 7) == (5, 1)  # lanes from 4: 1026 of them
    assert shape(32, 4097, 0) == (9, 2)
    assert shape(32, 8192, 0) == (16, 2)
    assert shape(32, 8193, 0) == (0, 0)
    assert grid(32, 8193, 0) == (86, 96, True)
    assert shape(32, 8193, 4) == (16, 2)
    assert shape(64, 4096, 1) == (16, 1)
    assert shape(64, 4097, 0) == (0, 0)
    assert grid(64, 4097, 0) == (65, 64, True)
    assert shape(128, 2048, 0) == (0, 0)
    assert grid(128, 2048, 0) == (32, 64, True)
    assert shape(8, 40, 100) == (1, 1)  # no live lane: every step skips
    # every strip of the 4096^2 QR takes the cluster kernel
    assert all(shape(32, 4096, k)[0] for k in range(0, 4096, 32))
    # every strip of the 16384 x 4096 QR takes the grid kernel
    assert all(shape(32, 16384, k) == (0, 0) for k in range(0, 4096, 32))
    assert grid(32, 16384, 0) == (128, 128, True)
    assert grid(32, 16384, 4064) == (97, 128, True)  # 12,320 live lanes
    assert grid(64, 8192, 0) == (128, 64, True)
    assert grid(256, 4096, 0) == (64, 64, True)
    assert grid(100, 1030, 7) == (17, 64, True)
    assert grid(100, 300, 7) == (5, 64, True)
    assert grid(8, 40, 100) == (1, 64, True)  # no live lane
    # past ~216 KB of S and Vt a CTA, they stay in device memory
    assert grid(256, 16384, 0) == (128, 128, False)
    assert grid(128, 32768, 0) == (128, 256, False)
    assert grid(64, 32768, 0) == (128, 256, True)


@pytest.mark.parametrize("cap", [1, 7, 64, 128])
@pytest.mark.parametrize("bmk", [(32, 4096, 0), (32, 16384, 4064),
                                 (256, 4096, 0), (8, 40, 100)])
def test_grid_shape_under_a_cap(bmk, cap):
    """grid_shape with at most ``cap`` CTAs (tools/bench_qr.py times fewer
    than the wrapper's): CTAs of at least 64 lanes, a multiple of 32, that
    cover the live lanes, each non-empty; the cap of MAX_GRID is the
    wrapper's rule."""
    b, m, k = bmk
    live = max(m - (k & ~3), 0)
    G, L, on_chip = kqp.grid_shape(b, m, k, cap)
    assert 1 <= G <= cap and L >= kqp.GRID_MIN_LANES and L % 32 == 0
    assert G * L >= live and (G == 1 or (G - 1) * L < live)
    assert on_chip == kqp.grid_on_chip(b, L)
    if cap == kqp.MAX_GRID:
        assert (G, L, on_chip) == kqp.grid_shape(b, m, k)


@pytest.mark.parametrize("name", ["MAX_B", "MAX_M", "MAX_CLUSTER",
                                  "MAX_GRID", "GRID_SMEM", "WORK_HEAD",
                                  "WORK_WORDS", "EPOCHS"])
def test_wrapper_constants_match_the_kernel_source(name):
    """The wrapper's copies of csrc/qr_panel.cu's limits: the exchange
    buffer it allocates must hold every word the kernel may clear."""
    src = (pathlib.Path(kqp.__file__).parent / "csrc"
           / "qr_panel.cu").read_text()
    consts = {}  # the file-scope constants, in order
    for n, expr in re.findall(r"^constexpr \w+ (\w+) = ([^;]+);", src,
                              re.MULTILINE):
        consts[n] = eval(re.sub(r"\b(\w+)u\b", r"\1", expr), {},
                         dict(consts))
    assert consts[name] == getattr(kqp, name)


@pytest.mark.parametrize("live", [1, 64, 1026, 8193, 12320, 16384, 32768])
@pytest.mark.parametrize("G", [1, 3, 33, 128])
def test_grid_lanes_cover_the_live_lanes(live, G):
    """Ranges of grid_lanes(live, G) lanes, a multiple of 32: at most G of
    them cover the live lanes, each non-empty."""
    L = kqp.grid_lanes(live, G)
    n = -(-live // L)
    assert L % 32 == 0 and 1 <= n <= G and n * L >= live > (n - 1) * L


# the grid kernel's split algebra (ops/qr_panel.py::_grid_sweep_ref) at G
# CTAs: uneven lane ranges (1026 live lanes from lane 4), a strip and a
# K12 panel, and a zero column (row 3 of St)
GRID_CASES = [(32, 1030, 7, None), (100, 1030, 7, None), (100, 1030, 7, 3)]


@pytest.fixture(scope="module")
def jax_panels():
    """JAX factor_strip (b <= 64) or factor_panel of each GRID_CASES strip
    in interpret mode, float32 and float64, computed once per module."""
    cache = {}

    def get(case, dtype):
        if (case, dtype) not in cache:
            b, m, k, zero = case
            fn = jqp.factor_strip if b <= 64 else jqp.factor_panel
            with pltpu.force_tpu_interpret_mode():
                out = fn(jnp.asarray(_strip(*case, dtype)), k, b)
            cache[case, dtype] = [np.asarray(o) for o in out]
        return cache[case, dtype]

    return get


@pytest.mark.parametrize("case", GRID_CASES,
                         ids=["b32_m1030_k7", "b100_m1030_k7", "zero_column"])
@pytest.mark.parametrize("G", [1, 3, 7, 33])
def test_grid_split_algebra(jax_panels, case, G):
    """The grid kernel's arithmetic (G lane ranges of a multiple of 32
    lanes, partials summed in rank order, Tt from z) against the plain
    sweep and against JAX's factor_strip / factor_panel in interpret mode,
    float32 and float64."""
    b, m, k, zero = case
    for dtype in (np.float32, np.float64):
        St = torch.from_numpy(_strip(*case, dtype))
        got = tqp._grid_sweep_ref(St, k, G)
        rtol = SPLIT_RTOL_OF_MAX[dtype]
        if dtype == np.float32:
            for g, w in zip(got, tqp.factor_panel_ref(St, k)):
                _close_of_max(g, w, rtol)
        for g, w in zip(got, jax_panels(case, dtype)):
            _close_of_max(g, w, rtol)
        if zero is not None:  # exact skip: no reflector, tau = 0
            assert float(got[1][zero].abs().max()) == 0.0
            assert float(got[2][zero, zero]) == 0.0
            assert torch.equal(got[0][zero], St[zero])


def test_cluster_ctas():
    """CTAs for the live lanes m - (k & ~3), the count the shape rule and
    tools/bench_qr.py both take."""
    assert kqp.cluster_ctas(4096, 0, 1) == 16
    assert kqp.cluster_ctas(4096, 0, 2) == 8
    assert kqp.cluster_ctas(4096, 3, 1) == 16  # lanes from 0
    assert kqp.cluster_ctas(4096, 3841, 1) == 1  # lanes from 3840: 256
    assert kqp.cluster_ctas(4096, 3836, 1) == 2  # lanes from 3836: 260
    assert kqp.cluster_ctas(40, 100, 1) == 1  # no live lane
    for b, m, k in [(32, 4096, 2048), (64, 2050, 33), (32, 6000, 5)]:
        C, lpt = kqp.cluster_shape(b, m, k)
        assert C == kqp.cluster_ctas(m, k, lpt)


@pytest.mark.parametrize("k", [0, 4])
def test_dispatcher_takes_plain_version_on_cpu(k):
    St = torch.from_numpy(_rand((8, 40), 3))
    before = factor_strip_cuda.launches
    for g, w in zip(tqp.factor_strip(St, k), tqp.factor_strip_ref(St, k)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert factor_strip_cuda.launches == before


def test_strip_takes_at_most_64_rows():
    with pytest.raises(ValueError, match="at most 64"):
        tqp.factor_strip(torch.zeros(65, 80), 0)


@pytest.mark.parametrize("b, m", [(8, 40), (64, 200), (128, 300)])
def test_factor_panel_matches_jax(b, m):
    """The port's factor_panel (K12's dispatcher) against JAX's
    factor_panel in interpret mode, pivots from lane 5, a zero column: on
    the CPU it is the plain sweep, launching nothing."""
    St = _rand((b, m), b + m)
    St[2] = 0.0
    with pltpu.force_tpu_interpret_mode():
        want = jqp.factor_panel(jnp.asarray(St), 5, b)
    before = factor_strip_cuda.launches
    got = tqp.factor_panel(torch.from_numpy(St), 5)
    assert factor_strip_cuda.launches == before
    for g, w in zip(got, want):
        _close_of_max(g, w, SWEEP_ATOL)
    assert float(got[1][2].abs().max()) == 0.0
    assert float(got[2][2, 2]) == 0.0


# ---------------------------------------------------------------------------
# the blocked driver householder_qr_panel
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_driver_64():
    """JAX householder_qr_pallas at n 64, block 16, inner 8, pair on/off
    (interpret mode), computed once for the module."""
    A = _rand((64, 64), 11)
    out = {}
    with pltpu.force_tpu_interpret_mode():
        for pair in (True, False):
            Q, R = jqp.householder_qr_pallas(jnp.asarray(A), block=16,
                                             inner=8, pair=pair)
            out[pair] = (np.asarray(Q), np.asarray(R))
    return A, out


@pytest.mark.parametrize("pair", [True, False])
def test_driver_matches_jax(jax_driver_64, pair):
    A, out = jax_driver_64
    Q, R = tqp.householder_qr_panel(torch.from_numpy(A), block=16, inner=8,
                                    pair=pair)
    _close(Q, out[pair][0], DRIVER_ATOL)
    _close(R, out[pair][1], DRIVER_ATOL)
    assert np.abs(np.tril(R.numpy(), -1)).max() == 0.0


def test_driver_through_grid_split_matches_jax():
    """householder_qr_panel with the grid kernel's split algebra as its
    strip sweep (7 CTAs) against JAX's householder_qr_pallas in interpret
    mode, on a tall 1030 x 256 matrix."""
    A = _rand((1030, 256), 5)
    with pltpu.force_tpu_interpret_mode():
        Qj, Rj = jqp.householder_qr_pallas(jnp.asarray(A))
    Q, R = tqp.householder_qr_panel(
        torch.from_numpy(A), strip=lambda St, k: tqp._grid_sweep_ref(St, k, 7))
    _close(Q, Qj, DRIVER_ATOL)
    _close(R, Rj, DRIVER_ATOL)


@pytest.mark.parametrize("kw", [dict(pair=True), dict(pair=False),
                                dict(agg=3), dict(inner=16)])
def test_driver_reconstructs_tall(kw):
    A = _rand((96, 48), 12)
    Q, R = tqp.householder_qr_panel(torch.from_numpy(A), block=16,
                                    **{"inner": 8, **kw})
    Q, R = Q.double().numpy(), R.double().numpy()
    assert Q.shape == (96, 48) and R.shape == (48, 48)
    assert np.linalg.norm(Q @ R - A) / np.linalg.norm(A) < 1e-5
    assert np.linalg.norm(Q.T @ Q - np.eye(48)) < 1e-4


def test_driver_two_level_equals_single_strip():
    # a width-16 panel as two 8-strips + WY merge = one 16-wide sweep
    A = torch.from_numpy(_rand((32, 16), 12))
    Q1, R1 = tqp.householder_qr_panel(A, block=16, inner=8,
                                      strip=tqp.factor_panel_ref)
    Q2, R2 = tqp.householder_qr_panel(A, block=16, inner=16,
                                      strip=tqp.factor_panel_ref)
    _close(R1, R2, DRIVER_ATOL)
    _close(Q1, Q2, DRIVER_ATOL)


def test_driver_runs_in_full_precision_and_restores_setting():
    seen = []

    def spy(St, k):
        seen.append(torch.get_float32_matmul_precision())
        return tqp.factor_strip_ref(St, k)

    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")  # what allow_tf32 = True sets
    try:
        tqp.householder_qr_panel(torch.from_numpy(_rand((32, 32), 2)),
                                 block=16, inner=8, strip=spy)
        after = torch.get_float32_matmul_precision()
    finally:
        torch.set_float32_matmul_precision(prev)
    assert seen and set(seen) == {"highest"}
    assert after == "high"


def _precisions():
    return tuple(b.fp32_precision for b in (
        torch.backends, torch.backends.cuda.matmul,
        torch.backends.mkldnn.matmul))


def test_qr_after_the_callers_legacy_tf32_switch():
    """A caller who switches TF32 on and off through the legacy
    ``allow_tf32`` flag around a QR (as chip_smoke.py's phase 6 does) finds
    every precision setting as it left it, and can run the next QR.
    Restoring the global setting would also set oneDNN's to TF32; with
    CUDA's back at IEEE the two disagree, and PyTorch's global getter,
    which the next QR reads, raises."""
    A = torch.from_numpy(_rand((32, 32), 2))
    prev, prev_flag = _precisions(), torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        before = _precisions()
        tqp.householder_qr_panel(A, block=16, inner=8)
        assert _precisions() == before
        torch.backends.cuda.matmul.allow_tf32 = False
        Q, R = tqp.householder_qr_panel(A, block=16, inner=8)
        assert torch.get_float32_matmul_precision() == "highest"
        assert np.linalg.norm(Q.double().numpy() @ R.double().numpy() - _np(
            A)) / np.linalg.norm(_np(A)) < 1e-5
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = prev_flag
        for b, p in zip((torch.backends, torch.backends.cuda.matmul,
                         torch.backends.mkldnn.matmul), prev):
            b.fp32_precision = p


@pytest.mark.parametrize("K", [100, 384, 1000, 5000])
def test_chunked_lane_product_equals_matmul(K):
    X = torch.from_numpy(_rand((7, K), 1, np.float64))
    V = torch.from_numpy(_rand((5, K), 2, np.float64))
    torch.testing.assert_close(tqp._xvt(X, V), X @ V.T, rtol=1e-12,
                               atol=1e-12)


# ---------------------------------------------------------------------------
# ops/qr.py against the JAX package, float64
# ---------------------------------------------------------------------------


SHAPES = [(5, 3), (64, 64), (100, 10), (37, 37), (130, 70)]


@pytest.mark.parametrize("reorth", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_mgs_matches_jax(shape, reorth):
    A = _rand(shape, shape[0], np.float64)
    Q, R = qr(A, reorth=reorth)
    Qj, Rj = j_qr(A, reorth=reorth)
    _close(Q, Qj, F64_ATOL)
    _close(R, Rj, F64_ATOL)
    assert np.linalg.norm(Q.numpy() @ R.numpy() - A) < 1e-10


@pytest.mark.parametrize("block", [2, 7, 16, 64, 128])
@pytest.mark.parametrize("shape", SHAPES)
def test_householder_matches_jax(shape, block):
    A = _rand(shape, shape[1], np.float64)
    Q, R = householder_qr(A, block=block)
    Qj, Rj = j_householder_qr(A, block=block)
    assert Q.shape == shape and R.shape == (shape[1], shape[1])
    _close(Q, Qj, F64_ATOL)
    _close(R, Rj, F64_ATOL)


def test_orthogonality_bounds():
    A = _rand((100, 10), 0, np.float64)
    Q, _ = qr(A, reorth=True)
    assert np.linalg.norm(Q.numpy().T @ Q.numpy() - np.eye(10)) < 1e-10
    Q, _ = householder_qr(_rand((100, 10), 1, np.float64))
    assert np.linalg.norm(Q.numpy().T @ Q.numpy() - np.eye(10)) < 1e-10


def test_householder_zero_column_skipped():
    A = _rand((8, 5), 11, np.float64)
    A[:, 2] = 0.0
    Q, R = householder_qr(A, block=2)
    Qj, Rj = j_householder_qr(A, block=2)
    assert abs(float(R[2, 2])) < 1e-12
    assert np.linalg.norm(Q.numpy() @ R.numpy() - A) < 1e-12
    _close(Q, Qj, F64_ATOL)
    _close(R, Rj, F64_ATOL)


def test_householder_float32_on_cpu_takes_core_not_kernel():
    # CPU tensors never reach the panel kernel: the JAX rule's core path
    A = _rand((256, 128), 2)
    before = factor_strip_cuda.launches
    Q, R = householder_qr(A)
    assert factor_strip_cuda.launches == before
    assert Q.dtype == torch.float32
    Qj, Rj = j_householder_qr(A)
    _close(Q, Qj, DRIVER_ATOL)
    _close(R, Rj, DRIVER_ATOL)
    Qn, Rn = Q.double().numpy(), R.double().numpy()
    assert np.linalg.norm(Qn @ Rn - A) / np.linalg.norm(A) < 1e-5
    assert np.linalg.norm(Qn.T @ Qn - np.eye(128)) < 1e-4


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("kind", ["mgs", "householder"])
def test_least_squares_match_jax(kind, seed):
    rng = np.random.default_rng(seed + (500 if kind == "householder" else 0))
    A = rng.standard_normal((40, 7))
    b = rng.standard_normal(40)
    fn, jfn = ((least_squares_qr, j_lsq_mgs) if kind == "mgs"
               else (least_squares_householder_qr, j_lsq_hh))
    x = fn(A, b)
    _close(x, jfn(A, b), F64_ATOL)
    r_np = np.linalg.norm(A @ np.linalg.lstsq(A, b, rcond=None)[0] - b)
    assert np.linalg.norm(A @ x.numpy() - b) <= r_np * (1 + 1e-8)


def test_mgs_linear_dependence_raises():
    with pytest.raises(ValueError, match="linearly dependent"):
        qr(np.ones((4, 3)))


def test_householder_wide_raises():
    with pytest.raises(ValueError, match="m >= n"):
        householder_qr(np.ones((3, 5)))
