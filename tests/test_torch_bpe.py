"""The port's byte-level BPE (linalg_tpu_torch/nn/tokenizers.py), its host
C loops (linalg_tpu_torch/native) and the BPE checkpoint sidecar against
the JAX package's.

Merges, ranks, token ids and texts are compared exactly; checkpoint
arrays bit for bit.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from linalg_tpu.models import gpt as jgpt
from linalg_tpu.nn import tokenizers as jtok
from linalg_tpu.train import checkpoint as jckpt
from linalg_tpu_torch import native as tnative
from linalg_tpu_torch.models import gpt as tgpt
from linalg_tpu_torch.nn import tokenizers as ttok
from linalg_tpu_torch.train import checkpoint as tckpt
from linalg_tpu_torch.train.data import synthetic_corpus

REPO = pathlib.Path(__file__).resolve().parents[1]
TEXT = synthetic_corpus()[:6000] + " naïve café — ünïcödé ✓ 日本語"
SAMPLES = ["", "a", "To be, or not to be", TEXT[:700],
           "héllo wörld — ✓ 日本語 😀 mixed ascii",
           "\n\n  trailing spaces  \t"]


def test_native_library_builds():
    assert tnative.native_available(), tnative.native_error()
    assert (REPO / "linalg_tpu_torch" / "native" / "_build").is_dir()


@pytest.mark.parametrize("vocab", [300, 512])
@pytest.mark.parametrize("path", ["c", "python"])
def test_merges_equal_jax(vocab, path):
    """The port's merges (the C loop, or the Python oracle) equal the JAX
    package's ``BPETokenizer.train`` merge for merge, in order."""
    want = jtok.BPETokenizer.train(TEXT, vocab).merges
    if path == "c":
        assert tnative.native_available()
        got = ttok.BPETokenizer.train(TEXT, vocab).merges
    else:
        got = ttok.BPETokenizer._train_py(TEXT.encode("utf-8"), vocab)
    assert len(got) == vocab - 256
    assert got == want
    assert ttok.BPETokenizer(got).ranks == jtok.BPETokenizer(want).ranks


@pytest.fixture(scope="module")
def tokenizers():
    merges = jtok.BPETokenizer.train(TEXT, 400).merges
    return ttok.BPETokenizer(merges), jtok.BPETokenizer(merges)


@pytest.mark.parametrize("text", SAMPLES)
def test_encode_decode_equal_jax(text, tokenizers):
    """ASCII, multi-byte UTF-8 and empty strings: ids equal the JAX
    package's through the C loop and the Python oracle; decode gives the
    text back, and each token's bytes match."""
    tt, jt = tokenizers
    want = np.asarray(jt.encode(text))
    got = tt.encode(text)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tt._encode_py(text.encode("utf-8")), want)
    assert tt.decode(got) == jt.decode(want) == text
    assert [tt.token_bytes(i) for i in got] == [jt.token_bytes(i)
                                               for i in want]


def test_state_and_bare_constructor(tokenizers):
    tt, jt = tokenizers
    assert tt.save() == jt.save()
    assert tt.vocab_size == jt.vocab_size == 400
    assert ttok.BPETokenizer.load(jt.save()).merges == tt.merges
    with pytest.raises(NotImplementedError, match="untrained"):
        ttok.BPETokenizer()


def test_char_encode_through_c_equals_jax():
    text = synthetic_corpus()[:3000]
    tt, jt = ttok.CharTokenizer(text), jtok.CharTokenizer(text)
    probe = text[:500] + "Zq€"  # unknown characters are dropped
    np.testing.assert_array_equal(tt.encode(probe), jt.encode(probe))
    with pytest.raises(KeyError):
        tt.encode("€", drop_unknown=False)


def test_concurrent_first_builds(tmp_path):
    """Four processes racing on the first build into an empty directory
    all load the library; one library is left and no temporary file."""
    code = ("import pathlib, sys\n"
            "import linalg_tpu_torch.native.loader as L\n"
            "L.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
            "print(L.native_available(), L.bpe_train_native(b'abab' * 9, 260))"
            "\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    want = ttok.BPETokenizer._train_py(b"abab" * 9, 260)
    assert outs == [f"True {want}"] * 4
    assert [f.suffix for f in tmp_path.iterdir()] == [".so"]


def test_gather_windows_matches_python():
    ids = np.arange(100, dtype=np.int32) * 3
    starts = np.array([0, 17, 80], np.int64)
    x, y = tnative.gather_windows(ids, starts, 12)
    np.testing.assert_array_equal(x, np.stack([ids[s:s + 12]
                                               for s in starts]))
    np.testing.assert_array_equal(y, np.stack([ids[s + 1:s + 13]
                                               for s in starts]))
    with pytest.raises(ValueError, match="outside"):
        tnative.gather_windows(ids, np.array([88], np.int64), 12)


CFG = dict(vocab_size=400, d_model=32, n_heads=2, n_layers=2, ctx_len=16)


def test_bpe_checkpoint_jax_to_port(tmp_path, tokenizers):
    _, jt = tokenizers
    jc = jgpt.GPTConfig(**CFG)
    jp = jgpt.init_gpt_params(jc, seed=1)
    jckpt.save_ckpt(tmp_path, jp, jc, {}, {}, tokenizer=jt)
    params, cfg, stoi, itos = tckpt.load_ckpt(tmp_path, device="cpu")
    tok = tckpt.load_tokenizer(tmp_path)
    assert isinstance(tok, ttok.BPETokenizer) and tok.merges == jt.merges
    assert cfg == tgpt.GPTConfig(**CFG) and stoi == {} and itos == {}
    np.testing.assert_array_equal(params["tok_W"].numpy(),
                                  np.asarray(jp["tok_W"]))


def test_bpe_checkpoint_port_to_jax(tmp_path, tokenizers):
    tt, _ = tokenizers
    tc = tgpt.GPTConfig(**CFG)
    tp = tgpt.init_gpt_params(tc, seed=1)
    tckpt.save_ckpt(tmp_path, tp, tc, {}, {}, tokenizer=tt)
    meta = json.loads((tmp_path / tckpt.META_NAME).read_text())
    assert meta["tokenizer"] == "bpe"
    params, cfg, stoi, itos = jckpt.load_ckpt(tmp_path)
    tok = jckpt.load_tokenizer(tmp_path)
    assert isinstance(tok, jtok.BPETokenizer) and tok.merges == tt.merges
    assert cfg == jgpt.GPTConfig(**CFG)
    for key in ("Wq", "W2"):
        np.testing.assert_array_equal(np.asarray(params["layers"][key]),
                                      tp["layers"][key].numpy())


def test_serve_cli_bpe_checkpoint_matches_jax(tmp_path, tokenizers):
    """``--serve`` on a JAX-saved BPE checkpoint (multi-byte prompts
    included) writes the JAX CLI's completions, greedily."""
    from linalg_tpu.apps.gpt import build_parser as jparser
    from linalg_tpu.apps.gpt import serve_cli as jserve
    from linalg_tpu_torch.apps.gpt import build_parser, serve_cli

    _, jt = tokenizers
    jc = jgpt.GPTConfig(**dict(CFG, ctx_len=48))
    jckpt.save_ckpt(tmp_path, jgpt.init_gpt_params(jc, seed=2), jc, {}, {},
                    tokenizer=jt)
    (tmp_path / "prompts.txt").write_text(
        "First Citizen:\nhé ünïcödé ✓ 日本語\n\nALL: speak\n",
        encoding="utf-8")
    common = ["--serve", "--ckpt_dir", str(tmp_path), "--prompts",
              str(tmp_path / "prompts.txt"), "--gen_tokens", "12",
              "--n_slots", "2", "--chunk", "4", "--top_k", "1"]

    def read(name):
        return [json.loads(ln) for ln in
                (tmp_path / name).read_text(encoding="utf-8").splitlines()]

    jserve(jparser().parse_args(common + ["--out", str(tmp_path / "j")]))
    serve_cli(build_parser().parse_args(
        common + ["--out", str(tmp_path / "t"), "--device", "cpu"]))
    want = read("j")
    assert [r["new_tokens"] for r in want] == [12, 12, 12]
    assert read("t") == want


def test_cli_train_bpe_writes_jax_merges(tmp_path):
    """``--train --tokenizer bpe --steps 2 --device cpu`` through the
    port's CLI and the JAX package's CLI (a subprocess on the CPU) on the
    same corpus: the sidecars carry the same merges and vocabulary."""
    data = tmp_path / "corpus.txt"
    data.write_text(synthetic_corpus()[:30000], encoding="utf-8")
    common = ["--train", "--tokenizer", "bpe", "--vocab_size", "320",
              "--steps", "2", "--eval_every", "2", "--d_model", "16",
              "--layers", "1", "--heads", "2", "--ctx_len", "16",
              "--batch_size", "2", "--data", str(data)]
    from linalg_tpu_torch.apps import gpt as tapp

    tapp.main(common + ["--ckpt_dir", str(tmp_path / "port"),
                        "--device", "cpu"])
    subprocess.run([sys.executable, "-m", "linalg_tpu.apps.gpt", *common,
                    "--ckpt_dir", str(tmp_path / "jax")], cwd=REPO,
                   env=_cpu_env(), check=True, capture_output=True,
                   timeout=300)
    port = json.loads((tmp_path / "port" / tckpt.META_NAME).read_text())
    jax_ = json.loads((tmp_path / "jax" / jckpt.META_NAME).read_text())
    assert port["tokenizer"] == jax_["tokenizer"] == "bpe"
    assert port["merges"] == jax_["merges"] and len(port["merges"]) == 64
    assert port["vocab_size"] == jax_["vocab_size"] == 320
    assert port["stoi"] == jax_["stoi"] == {}


def _cpu_env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env
