"""Word-embedding similarity over GloVe text vectors — the counterpart of
``linalg_tpu/apps/glovecompare.py``: load GloVe ``word v1 v2 ...`` text
embeddings, report the cosine similarity of two words and each word's
top-k nearest neighbors.

    python -m linalg_tpu_torch.apps.glovecompare WORD1 WORD2
        [--glove data/glove.6B.300d.txt] [--top_k 10] [--device cpu]

The similarities against the whole vocabulary are one float32
matrix-vector product of the row-normalized embeddings on the device (the
card unless ``--device cpu``), in full float32 (no TF32), as the JAX
module's is one jitted product.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.numerics import full_f32_matmul

__all__ = ["load_glove", "cosine_similarity", "top_k_neighbors", "main"]


def load_glove(path) -> Tuple[Dict[str, int], List[str], np.ndarray]:
    """Parse a GloVe text file -> (word->row, row->word, (V, D) float32
    matrix); lines of fewer than two values are skipped."""
    words: List[str] = []
    vecs: List[np.ndarray] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            if len(parts) < 3:
                continue
            words.append(parts[0])
            vecs.append(np.asarray(parts[1:], dtype=np.float32))
    if not vecs:
        raise ValueError(f"no embeddings parsed from {path}")
    return {w: i for i, w in enumerate(words)}, words, np.stack(vecs, axis=0)


def cosine_similarity(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


@full_f32_matmul()
def _cosine_all(M_unit, v_unit):
    return M_unit @ v_unit


def top_k_neighbors(M: np.ndarray, stoi: Dict[str, int], itos: List[str],
                    word: str, k: int = 10, device=None
                    ) -> List[Tuple[str, float]]:
    """The k nearest words to ``word`` by cosine similarity (the word
    itself excluded), best first. ``M`` may be a (V, D) numpy array or a
    tensor already holding the row-normalized matrix on the device (how a
    caller asking many queries uploads it once)."""
    if isinstance(M, torch.Tensor):
        M_unit = M
        v_unit = M_unit[stoi[word]]
    else:
        dev = resolve_device(device)
        M_unit = torch.as_tensor(
            M / (np.linalg.norm(M, axis=1, keepdims=True) + 1e-12),
            device=dev)
        v = np.asarray(M[stoi[word]], dtype=np.float32)
        v_unit = torch.as_tensor(v / (np.linalg.norm(v) + 1e-12), device=dev)
    sims = _cosine_all(M_unit, v_unit).cpu().numpy().copy()
    sims[stoi[word]] = -np.inf
    idx = np.argpartition(sims, -k)[-k:]
    idx = idx[np.argsort(sims[idx])[::-1]]
    return [(itos[i], float(sims[i])) for i in idx]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("word1")
    ap.add_argument("word2")
    ap.add_argument("--glove", default="data/glove.6B.300d.txt")
    ap.add_argument("--top_k", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    path = pathlib.Path(args.glove)
    if not path.is_file():
        sys.exit(f"GloVe file not found: {path}")
    stoi, itos, M = load_glove(path)
    for w in (args.word1, args.word2):
        if w not in stoi:
            sys.exit(f"word not in vocabulary: {w}")

    sim = cosine_similarity(M[stoi[args.word1]], M[stoi[args.word2]])
    print(f"cosine({args.word1}, {args.word2}) = {sim:.4f}")
    for w in (args.word1, args.word2):
        print(f"\ntop-{args.top_k} neighbors of {w!r}:")
        for nb, s in top_k_neighbors(M, stoi, itos, w, args.top_k,
                                     device=args.device):
            print(f"  {nb:20s} {s:.4f}")


if __name__ == "__main__":
    main()
