"""The port's linear-algebra toolkit (linalg_tpu_torch/ops: elimination,
matrix functions, projections, SVD, PCA, eigen methods, batched variants,
the benchmark CLI) against the JAX package's.

Float64 on the CPU, the same numpy-seeded inputs to both packages; cases
mirror tests/test_{elimination,matrix_functions,projections,svd,eigen,
batched}.py. Values agree within 1e-10 unless a test says otherwise (sums
in another order); lists, ranks and raises exactly. Where the two packages
draw different random numbers (the SVD completion: jax.random against a
torch.Generator) or may pick other signs (eigenvectors, singular vectors),
the port is held to the properties instead: orthonormal columns and
A = U diag(s) V^T, or sign-aligned vectors.
"""

import numpy as np
import pytest
import torch

import linalg_tpu as la
import linalg_tpu.ops.batched as jbatched
import linalg_tpu_torch as lt
import linalg_tpu_torch.ops.batched as tbatched
from linalg_tpu_torch.ops.benchmark_qr import main as bench_main
from linalg_tpu_torch.utils import numerics as tnum

torch.set_num_threads(2)

ATOL = 1e-10


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _lowrank(m, n, r, seed, noise=0.0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((m, r)) @ rng.standard_normal((r, n))
    if noise:
        X = X + noise * rng.standard_normal((m, n))
    return X


def _align_signs(X, Y):
    """Flip columns of Y so each has a positive dot with X's column."""
    Y = np.array(Y, copy=True)
    for j in range(X.shape[1]):
        if X[:, j] @ Y[:, j] < 0:
            Y[:, j] = -Y[:, j]
    return Y


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------


def test_numerics_match_jax():
    assert tnum.EPS == la.EPS
    from linalg_tpu.utils.numerics import eps_for as jeps
    for tdt, jdt in [(torch.float64, "float64"), (torch.float32, "float32"),
                     (torch.bfloat16, "bfloat16"), (torch.float16, "float16")]:
        assert tnum.eps_for(tdt) == jeps(jdt)
    A = np.random.default_rng(0).standard_normal((5, 7))
    assert abs(float(tnum.scale_tol(torch.from_numpy(A)))
               - float(la.scale_tol(A))) < 1e-20
    v = np.random.default_rng(1).standard_normal(6)
    assert abs(float(tnum.scale_tol(torch.from_numpy(v)))
               - float(la.scale_tol(v))) < 1e-20
    for perm in ([0, 1, 2], [1, 0, 2], [2, 0, 1], [3, 2, 1, 0]):
        assert tnum.permutation_sign(perm) == la.permutation_sign(perm)
    np.testing.assert_array_equal(tnum.random_nonsingular_upper(6, seed=3),
                                  la.random_nonsingular_upper(6, seed=3))
    np.testing.assert_array_equal(tnum.random_nonsingular_qr(6, seed=3),
                                  la.random_nonsingular_qr(6, seed=3))


# ---------------------------------------------------------------------------
# elimination
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(10))
@pytest.mark.parametrize("fixture", ["qr", "upper"])
def test_gaussian_solve_matches_jax(fixture, seed):
    rng = np.random.default_rng(seed + (1000 if fixture == "upper" else 0))
    A = (la.random_nonsingular_qr(10, seed=seed) if fixture == "qr"
         else la.random_nonsingular_upper(10, seed=seed))
    b = rng.standard_normal(10)
    x = lt.gaussian_solve(A, b)
    _close(x, la.gaussian_solve(A, b), atol=1e-9, rtol=1e-10)
    r_np = np.linalg.norm(A @ np.linalg.solve(A, b) - b)
    assert np.linalg.norm(A @ x.numpy() - b) <= r_np * (1 + 1e-6) + 1e-9


def test_gaussian_solve_matrix_rhs():
    A = la.random_nonsingular_qr(6, seed=7)
    B = np.random.default_rng(7).standard_normal((6, 3))
    _close(lt.gaussian_solve(A, B), la.gaussian_solve(A, B))


def test_gaussian_solve_rank_deficient_falls_back_to_lstsq():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((4, 2)) @ rng.standard_normal((2, 4))
    b = A @ rng.standard_normal(4)
    x = lt.gaussian_solve(A, b)
    assert np.linalg.norm(A @ x.numpy() - b) < 1e-8
    _close(x, la.gaussian_solve(A, b), atol=1e-8)  # both minimum-norm


@pytest.mark.parametrize("api", ["gaussian_solve", "back_substitute"])
def test_inconsistent_system_raises(api):
    if api == "gaussian_solve":
        args = (np.array([[1.0, 2.0], [2.0, 4.0]]), np.array([1.0, 3.0]))
    else:
        args = (np.array([[1.0, 2.0], [0.0, 0.0]]), np.array([1.0, 5.0]))
    for fn in (getattr(lt, api), getattr(la, api)):
        with pytest.raises(ValueError, match="inconsistent"):
            fn(*args)


def test_back_substitute_singular_raises_rank_deficient():
    U = np.array([[1.0, 2.0], [0.0, 0.0]])
    c = np.array([1.0, 0.0])
    for fn in (lt.back_substitute, la.back_substitute):
        with pytest.raises(ValueError, match="rank deficient"):
            fn(U, c)


def test_back_substitute_simple():
    U = np.array([[2.0, 1.0], [0.0, 3.0]])
    _close(lt.back_substitute(U, np.array([5.0, 6.0])), [1.5, 2.0])


@pytest.mark.parametrize("shape,seed,pivot", [
    ((8, 8), 2, True), ((5, 5), 5, True), ((3, 5), 9, True),
    ((6, 4), 4, True), ((5, 5), 6, False)])
def test_forward_eliminate_matches_jax(shape, seed, pivot):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal(shape)
    b = rng.standard_normal(shape[0])
    U, c, piv, free, perm = lt.forward_eliminate(A, b, pivot=pivot)
    Uj, cj, pivj, freej, permj = la.forward_eliminate(A, b, pivot=pivot)
    assert (piv, free, perm) == (pivj, freej, permj)
    _close(U, Uj)
    _close(c, cj)
    assert lt.forward_eliminate(A)[1] is None


def test_forward_then_back_recovers_solution():
    rng = np.random.default_rng(11)
    A = la.random_nonsingular_qr(6, seed=11)
    x0 = rng.standard_normal(6)
    U, c, *_ = lt.forward_eliminate(A, A @ x0)
    _close(lt.back_substitute(U, c), x0, atol=1e-8)


@pytest.mark.parametrize("seed", range(6))
def test_nullspace_and_rank_match_jax(seed):
    rng = np.random.default_rng(seed)
    r = int(rng.integers(1, 4))
    A = rng.standard_normal((6, r)) @ rng.standard_normal((r, 8))
    N = lt.nullspace_basis_elimination(A)
    assert lt.rank_elimination(A) == la.rank_elimination(A) == r
    assert N.shape == (8, 8 - r)
    _close(N, la.nullspace_basis_elimination(A), atol=1e-8)
    assert np.linalg.norm(A @ N.numpy()) < 1e-8


def test_nullspace_full_rank_empty():
    A = la.random_nonsingular_qr(5, seed=4)
    assert tuple(lt.nullspace_basis_elimination(A).shape) == (5, 0)


@pytest.mark.parametrize("trial", range(12))
def test_rank_matches_numpy(trial):
    rng = np.random.default_rng(trial)
    r = int(rng.integers(0, 7))
    A = (np.zeros((8, 6)) if r == 0
         else rng.standard_normal((8, r)) @ rng.standard_normal((r, 6)))
    assert lt.rank_elimination(A) == np.linalg.matrix_rank(A)


@pytest.mark.parametrize("shape,r,seed", [((4, 6), None, 13),
                                          ((5, 7), 3, 17), ((6, 6), 4, 19)])
def test_rref_matches_jax(shape, r, seed):
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal(shape) if r is None
         else rng.standard_normal((shape[0], r))
         @ rng.standard_normal((r, shape[1])))
    R, piv = lt.rref(A)
    Rj, pivj = la.rref(A)
    assert piv == pivj
    _close(R, Rj, atol=1e-8)
    R2, piv2 = lt.rref(R.numpy())
    assert piv2 == piv
    _close(R2, R)


# ---------------------------------------------------------------------------
# det, adj, rank_numpy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(5))
def test_det_matches_jax(seed):
    A = np.random.default_rng(seed).standard_normal((7, 7))
    d = lt.det(A)
    assert isinstance(d, float)
    assert np.isclose(d, la.det(A), rtol=1e-10, atol=1e-12)


def test_det_large_and_special():
    A = np.random.default_rng(0).standard_normal((100, 100))
    assert np.isclose(lt.det(A), np.linalg.det(A), rtol=1e-8, atol=1e-8)
    assert abs(lt.det(np.ones((4, 4)))) < 1e-12
    assert np.isclose(lt.det(np.eye(5)), 1.0)
    B = np.asarray(la.random_nonsingular_qr(5, seed=1))
    assert np.isclose(lt.det(B[[1, 0, 2, 3, 4]]), -lt.det(B), rtol=1e-9)
    with pytest.raises(ValueError, match="non-square"):
        lt.det(np.ones((3, 4)))


def test_adj_nonsingular_matches_jax():
    A = np.asarray(la.random_nonsingular_qr(8, seed=2))
    _close(lt.adj(A), la.adj(A), atol=1e-9, rtol=1e-9)


def test_adj_singular_cofactor_path():
    A = np.array([[1.0, 2.0, 3.0], [2.0, 4.0, 6.0], [1.0, 0.0, 1.0]])
    got = lt.adj(A)
    _close(got, la.adj(A))
    _close(A @ got.numpy(), np.zeros((3, 3)))


def test_rank_numpy_matches():
    A = (np.random.default_rng(1).standard_normal((6, 3))
         @ np.random.default_rng(2).standard_normal((3, 5)))
    assert lt.rank_numpy(A) == la.rank_numpy(A) == 3


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,k,seed", [((10, 4), None, 0),
                                          ((20, 5), None, 1),
                                          ((9, 3), 2, 4)])
def test_projection_matches_jax(shape, k, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal(shape)
    b = rng.standard_normal(shape[0] if k is None else (shape[0], k))
    p = lt.project_onto_colspace(A, b)
    assert p.shape == (shape[0], 1 if k is None else k)
    _close(p, la.project_onto_colspace(A, b), atol=1e-9)


def test_projection_rank_deficient_falls_back_to_pinv(capsys):
    rng = np.random.default_rng(3)
    base = rng.standard_normal((10, 2))
    A = np.hstack([base, base[:, :1]])
    b = rng.standard_normal(10)
    p = lt.project_onto_colspace(A, b)
    assert "pseudo-inverse" in capsys.readouterr().out
    _close(p.ravel(), A @ np.linalg.lstsq(A, b, rcond=None)[0], atol=1e-9)


# ---------------------------------------------------------------------------
# SVD and PCA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["eigh", "jacobi"])
@pytest.mark.parametrize("shape", [(8, 5), (20, 20), (5, 8), (40, 7)])
def test_svd_matches_jax(shape, method):
    A = np.random.default_rng(shape[0]).standard_normal(shape)
    U, s, Vt = lt.svd(A, method=method)
    Uj, sj, Vtj = la.svd(A, method=method)
    _close(s, sj, atol=1e-9)
    U, Vt = U.numpy(), Vt.numpy()
    assert np.linalg.norm(U @ np.diag(s.numpy()) @ Vt - A, 2) < 1e-10
    _close(_align_signs(np.asarray(Uj), U), Uj, atol=1e-7)
    _close(_align_signs(np.asarray(Vtj).T, Vt.T), np.asarray(Vtj).T,
           atol=1e-7)


@pytest.mark.parametrize("method", ["eigh", "jacobi"])
def test_svd_rank_deficient_completion_properties(method):
    A = _lowrank(10, 6, 3, seed=3)
    U, s, Vt = lt.svd(A, method=method, seed=5)
    U, s = U.numpy(), s.numpy()
    _close(s[:3], np.asarray(la.svd(A, method=method)[1])[:3], atol=1e-9)
    assert np.all(s[3:] == 0.0)
    assert np.linalg.norm(U.T @ U - np.eye(6)) < 1e-8
    assert np.linalg.norm(U @ np.diag(s) @ Vt.numpy() - A) < 1e-8
    # the completion is seeded: the same seed gives the same U
    _close(lt.svd(A, method=method, seed=5)[0], U, atol=0)


def test_svd_jacobi_f32_rank_deficient():
    X = _lowrank(40, 12, 4, seed=11).astype(np.float32)
    U, s, Vt = lt.svd(X, method="jacobi")
    U, s, Vt = U.numpy(), s.numpy(), Vt.numpy()
    assert np.linalg.norm(U.T @ U - np.eye(12)) < 5e-6
    assert np.linalg.norm(Vt @ Vt.T - np.eye(12)) < 5e-6
    assert np.linalg.norm(U @ np.diag(s) @ Vt - X) < 5e-5 * s[0]
    assert np.all(s[4:] < s[0] * 1e-5)


def test_svd_reorthogonalize_and_invalid_method():
    A = np.random.default_rng(1).standard_normal((12, 6))
    U0, s0, _ = lt.svd(A)
    U1, s1, _ = lt.svd(A, reorthogonalize=True)
    _close(s0, s1, atol=0)
    _close(U0, U1)
    with pytest.raises(ValueError, match="Unknown SVD method"):
        lt.svd(np.eye(3), method="qr")


@pytest.mark.parametrize("k", [2, 5, 8])
def test_pca_matches_jax(k):
    data = _lowrank(50, 8, 4, seed=5, noise=0.05)
    got = lt.pca(data, k)
    want = la.pca(data, k)
    pcs, scores = got[0].numpy(), got[1].numpy()
    assert pcs.shape == (8, k) and scores.shape == (50, k)
    pcs_a = _align_signs(np.asarray(want[0]), pcs)
    _close(pcs_a, want[0], atol=1e-8)
    _close(_align_signs(np.asarray(want[1]), scores), want[1], atol=1e-8)
    for g, w in zip(got[2:], want[2:]):
        _close(g, w)
    assert isinstance(got[4], float)


# ---------------------------------------------------------------------------
# eigen methods
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [0, 1, 2, 5, -1, -3])
def test_matrix_power_eig_matches_jax(k):
    A = np.random.default_rng(0).standard_normal((6, 6)) + 6 * np.eye(6)
    got = lt.matrix_power_eig(A, k)
    _close(got, la.matrix_power_eig(A, k), atol=1e-8, rtol=1e-8)
    _close(got, np.linalg.matrix_power(A, k), atol=1e-8, rtol=1e-7)


def test_matrix_power_eig_defective_falls_back():
    J = np.array([[2.0, 1.0], [0.0, 2.0]])
    _close(lt.matrix_power_eig(J, 5), np.linalg.matrix_power(J, 5),
           atol=1e-8)


def test_matrix_power_eig_drops_imaginary_parts():
    th = 0.7
    Rm = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    got = lt.matrix_power_eig(Rm, 4)
    assert not got.is_complex()
    _close(got, np.linalg.matrix_power(Rm, 4), atol=1e-9)


def test_matrix_power_binary_matches_jax():
    A = np.random.default_rng(1).standard_normal((5, 5))
    _close(lt.matrix_power_binary(A, 7), la.matrix_power_binary(A, 7),
           atol=1e-9, rtol=1e-9)


@pytest.mark.parametrize("case", ["psd", "diag", "zero", "tight"])
def test_power_iteration_matches_jax(case):
    rng = np.random.default_rng(4)
    B = rng.standard_normal((10, 10))
    A, kw = {
        "psd": (B @ B.T, {}),
        "diag": (np.diag([1.0, 3.0, -2.0]), {}),
        "zero": (np.zeros((4, 4)), {}),
        "tight": (B @ B.T, dict(tol=1e-12)),
    }[case]
    v0 = np.ones(A.shape[0])
    lam, v = lt.power_iteration(A, v0=v0, **kw)
    lamj, vj = la.power_iteration(A, v0=v0, **kw)
    assert isinstance(lam, float)
    assert np.isclose(lam, lamj, rtol=1e-10, atol=1e-12)
    _close(v, vj, atol=1e-8)


def test_power_iteration_history_matches_jax():
    rng = np.random.default_rng(5)
    B = rng.standard_normal((7, 7))
    A = B @ B.T
    lam, v, iters, hist = lt.power_iteration(A, v0=np.ones(7),
                                             return_history=True)
    lamj, vj, itersj, histj = la.power_iteration(A, v0=np.ones(7),
                                                 return_history=True)
    assert iters == itersj and len(hist) == len(histj)
    _close(hist, histj, atol=1e-9, rtol=1e-6)
    assert hist[-1] < 1e-10
    assert np.isclose(lam, lamj, rtol=1e-10)


def test_power_iteration_default_v0_and_raises():
    A = np.random.default_rng(11).normal(size=(6, 6))
    A = A @ A.T
    lam, v = lt.power_iteration(A)
    lamj, _ = la.power_iteration(A)
    assert np.isclose(lam, lamj, rtol=1e-10)
    with pytest.raises(ValueError, match="square"):
        lt.power_iteration(np.ones((3, 4)))
    with pytest.raises(ValueError, match="v0"):
        lt.power_iteration(np.eye(3), v0=np.ones(4))


# ---------------------------------------------------------------------------
# batched variants
# ---------------------------------------------------------------------------


def test_batched_qr_matches_jax_and_flags():
    A = np.random.default_rng(0).standard_normal((5, 20, 8))
    Q, R, ok = tbatched.batched_qr(A)
    Qj, Rj, okj = jbatched.batched_qr(A)
    _close(Q, Qj)
    _close(R, Rj)
    assert ok.tolist() == np.asarray(okj).tolist() == [True] * 5
    _, _, ok = tbatched.batched_qr(np.stack([np.eye(4, 3), np.ones((4, 3))]))
    assert ok.tolist() == [True, False]


def test_batched_householder_matches_jax():
    A = np.random.default_rng(1).standard_normal((4, 30, 11))
    Q, R = tbatched.batched_householder_qr(A, block=8)
    Qj, Rj = jbatched.batched_householder_qr(A, block=8)
    _close(Q, Qj)
    _close(R, Rj)


def test_batched_svd_matches_jax():
    A = np.random.default_rng(2).standard_normal((3, 12, 6))
    U, s, Vt = tbatched.batched_svd(A)
    _, sj, _ = jbatched.batched_svd(A)
    _close(s, sj, atol=1e-9)
    rec = U.numpy() @ (s.numpy()[:, :, None] * Vt.numpy())
    assert np.linalg.norm(rec - A) < 1e-9


def test_batched_solve_and_det_match_jax():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((6, 9, 9)) + 9 * np.eye(9)
    x0 = rng.standard_normal((6, 9))
    b = np.einsum("bij,bj->bi", A, x0)
    x, ok = tbatched.batched_solve(A, b)
    xj, okj = jbatched.batched_solve(A, b)
    _close(x, xj)
    assert ok.all() and np.asarray(okj).all()
    _, ok = tbatched.batched_solve(np.stack([np.eye(3), np.zeros((3, 3))]),
                                   np.ones((2, 3)))
    assert ok.tolist() == [True, False]
    D = rng.standard_normal((7, 6, 6))
    _close(tbatched.batched_det(D), jbatched.batched_det(D), atol=1e-10,
           rtol=1e-10)


# ---------------------------------------------------------------------------
# the benchmark CLI
# ---------------------------------------------------------------------------


def test_benchmark_qr_cli_on_cpu(tmp_path, capsys):
    out = tmp_path / "bench.csv"
    records = bench_main(["--sizes", "40x40", "60x30", "--repeats", "2",
                          "--device", "cpu", "--out", str(out)])
    lines = out.read_text().splitlines()
    assert lines[0] == "kernel,size,sec,sec/ref,residual/ref,orth_err"
    assert [ln.split(",")[:2] for ln in lines[1:]] == [
        ["GE", "40x40"], ["MGS-QR", "40x40"], ["HH-QR", "40x40"],
        ["MGS-QR", "60x30"], ["HH-QR", "60x30"]]
    for kernel, _size, sec, _rel, res, orth in records:
        assert sec > 0 and np.isfinite(res) and res < 10
        if kernel != "GE":
            assert orth < 1e-4
    assert "device: cpu" in capsys.readouterr().out


def test_benchmark_qr_cli_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bench_main(["--sizes", "8x8", "--device", "cuda",
                    "--out", str(tmp_path / "x.csv")])
