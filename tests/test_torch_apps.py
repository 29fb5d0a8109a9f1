"""The port's small apps (linalg_tpu_torch/apps/{logic_gates,vectors,
glovecompare}.py) against the JAX package's, on the CPU.

- logic_gates: the same numpy draws for one seed, 400 SGD epochs in each
  package (float32; torch autograd against ``jax.value_and_grad``): the
  same truth-table predictions, probabilities within 1e-4, the asserts of
  ``main`` passing.
- vectors: the port's own copy; its ``VectorTests`` run here as they are
  (collected from this module), and each operation equals the JAX
  package's ``Vector``'s.
- glovecompare: a GloVe text file the test writes itself; ``load_glove``
  equal, ``top_k_neighbors`` the JAX package's and numpy's float64
  top-k.
"""

import math

import numpy as np
import pytest

from linalg_tpu.apps import glovecompare as jglove
from linalg_tpu.apps import logic_gates as jgates
from linalg_tpu.apps import vectors as jvectors
from linalg_tpu_torch.apps import glovecompare as tglove
from linalg_tpu_torch.apps import logic_gates as tgates
from linalg_tpu_torch.apps.vectors import Vector, VectorTests  # noqa: F401


@pytest.fixture(scope="module")
def gates():
    return {name: (jgates.train_gate(labels, verbose=False),
                   tgates.train_gate(labels, verbose=False, device="cpu"))
            for labels, name, _ in (jgates.XOR_TABLE, jgates.OR_TABLE)}


@pytest.mark.parametrize("name", ["XOR", "OR"])
def test_gate_predictions_equal_jax(gates, name):
    jm, tm = gates[name]
    X = tgates._INPUTS
    np.testing.assert_array_equal(tm.predict(X), jm.predict(X))
    np.testing.assert_allclose(tm.predict_proba(X).numpy(),
                               np.asarray(jm.predict_proba(X)), atol=1e-4)
    for k in ("W1", "b1", "W2", "b2"):
        np.testing.assert_allclose(tm.params[k].numpy(),
                                   np.asarray(jm.params[k]), atol=1e-4)


@pytest.mark.parametrize("name", ["XOR", "OR"])
def test_gate_reduce_matches_jax(gates, name):
    jm, tm = gates[name]
    for seq in ([1, 0, 1, 1, 0], [0, 0, 1], [1, 1, 1, 1]):
        assert tgates.gate_reduce(tm, seq) == jgates.gate_reduce(jm, seq)


def test_initial_weights_are_the_jax_draws():
    jm, tm = jgates.GateMLP(H=8, seed=3), tgates.GateMLP(H=8, seed=3,
                                                         device="cpu")
    for k in jm.params:
        np.testing.assert_array_equal(tm.params[k].numpy(),
                                      np.asarray(jm.params[k]))


def test_logic_gates_main_asserts_pass(capsys):
    models = tgates.main(["--gate", "both", "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(models) == 2
    assert "XOR: all truth-table and fold asserts passed" in out
    assert "OR: all truth-table and fold asserts passed" in out


def test_vector_operations_equal_jax():
    rng = np.random.default_rng(0)
    for _ in range(5):
        a, b = (rng.standard_normal(3) for _ in range(2))
        tv, tw = Vector(*a), Vector(*b)
        jv, jw = jvectors.Vector(*a), jvectors.Vector(*b)
        for got, want in ((tv + tw, jv + jw), (tv - tw, jv - jw),
                          (tv.cross(tw), jv.cross(jw)), (2.5 * tv, 2.5 * jv)):
            assert (got.x, got.y, got.z) == (want.x, want.y, want.z)
        assert tv.dot(tw) == jv.dot(jw)
        assert tv.angle(tw) == jv.angle(jw)
        assert tv.cosine_similarity(tw) == jv.cosine_similarity(jw)
    assert math.isclose(Vector(1, 1e-8, 0).angle(Vector(1, 1e-8, 0)), 0.0,
                        abs_tol=1e-7)
    with pytest.raises(AttributeError):
        Vector(1, 2, 3).x = 0


def _write_glove(path, V=400, D=50, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((V, D)).astype(np.float32)
    words = [f"w{i}" for i in range(V)]
    with open(path, "w", encoding="utf-8") as f:
        f.write("bad\n")  # a line of no values: skipped
        for w, row in zip(words, M):
            f.write(w + " " + " ".join(f"{v:.6f}" for v in row) + "\n")
    return words


def test_load_glove_equals_jax(tmp_path):
    path = tmp_path / "glove.txt"
    _write_glove(path)
    ts, ti, tM = tglove.load_glove(path)
    js, ji, jM = jglove.load_glove(path)
    assert ts == js and ti == ji
    np.testing.assert_array_equal(tM, jM)
    with pytest.raises(ValueError, match="no embeddings"):
        (tmp_path / "empty.txt").write_text("x\n")
        tglove.load_glove(tmp_path / "empty.txt")


@pytest.mark.parametrize("word", ["w0", "w123", "w399"])
def test_top_k_neighbors_equal_jax_and_numpy(tmp_path, word):
    path = tmp_path / "glove.txt"
    _write_glove(path)
    stoi, itos, M = tglove.load_glove(path)
    got = tglove.top_k_neighbors(M, stoi, itos, word, 10, device="cpu")
    want = jglove.top_k_neighbors(M, stoi, itos, word, 10)
    assert [w for w, _ in got] == [w for w, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=1e-5)
    M64 = M.astype(np.float64)
    unit = M64 / np.linalg.norm(M64, axis=1, keepdims=True)
    sims = unit @ unit[stoi[word]]
    sims[stoi[word]] = -np.inf
    assert [w for w, _ in got] == [itos[i] for i in np.argsort(-sims)[:10]]
    assert math.isclose(tglove.cosine_similarity(M[0], M[1]),
                        jglove.cosine_similarity(M[0], M[1]))


def test_glovecompare_main(tmp_path, capsys):
    path = tmp_path / "glove.txt"
    _write_glove(path)
    tglove.main(["w1", "w2", "--glove", str(path), "--top_k", "3",
                 "--device", "cpu"])
    out = capsys.readouterr().out
    assert "cosine(w1, w2) = " in out and out.count("top-3 neighbors") == 2
    with pytest.raises(SystemExit, match="not in vocabulary"):
        tglove.main(["w1", "nope", "--glove", str(path), "--device", "cpu"])
    with pytest.raises(SystemExit, match="not found"):
        tglove.main(["w1", "w2", "--glove", str(tmp_path / "none.txt")])


def test_apps_default_to_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tgates.GateMLP()
