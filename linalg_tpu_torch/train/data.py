"""Training corpus, char vocabulary and random-window batches — the
counterpart of ``linalg_tpu/train/data.py``.

``load_text`` resolves, in order: an explicit path, ``$LINALG_TPU_DATA``,
a repo-local data file, and finally the deterministic synthetic
pseudo-Shakespeare corpus (the same text as the JAX package's for the same
seed). Unlike the JAX package it never reaches for the network.
"""

from __future__ import annotations

import os
import pathlib
from typing import Dict, Iterator, List, Tuple

import numpy as np

from ..nn.tokenizers import CharTokenizer

__all__ = ["load_text", "build_char_vocab", "encode", "decode",
           "batch_stream", "synthetic_corpus"]

_LOCAL_CANDIDATES = ("data/tinyshakespeare.txt", "data/input.txt")


def synthetic_corpus(n_chars: int = 400_000, seed: int = 7) -> str:
    """Deterministic pseudo-Shakespeare: an order-4 char-level Markov
    babbler over a seed passage (the JAX package's, draw for draw)."""
    seed_text = (
        "FIRST CITIZEN:\n"
        "Before we proceed any further, hear me speak.\n\n"
        "ALL:\nSpeak, speak.\n\n"
        "FIRST CITIZEN:\n"
        "You are all resolved rather to die than to famish?\n\n"
        "ALL:\nResolved. resolved.\n\n"
        "FIRST CITIZEN:\n"
        "First, you know Caius Marcius is chief enemy to the people.\n\n"
        "ALL:\nWe know't, we know't.\n\n"
        "MENENIUS:\n"
        "What work's, my countrymen, in hand? where go you\n"
        "With bats and clubs? The matter? speak, I pray you.\n\n"
        "MARCIUS:\n"
        "Thanks. What's the matter, you dissentious rogues,\n"
        "That, rubbing the poor itch of your opinion,\n"
        "Make yourselves scabs?\n\n"
        "SICINIUS:\n"
        "Nature teaches beasts to know their friends.\n\n"
        "CORIOLANUS:\n"
        "What would you have, you curs,\n"
        "That like nor peace nor war? the one affrights you,\n"
        "The other makes you proud. He that trusts to you,\n"
        "Where he should find you lions, finds you hares;\n"
        "Where foxes, geese: you are no surer, no,\n"
        "Than is the coal of fire upon the ice,\n"
        "Or hailstone in the sun.\n\n"
    )
    order = 4
    rng = np.random.default_rng(seed)
    table: Dict[str, List[str]] = {}
    for i in range(len(seed_text) - order):
        table.setdefault(seed_text[i:i + order], []).append(
            seed_text[i + order])
    out = list(seed_text[:order])
    ctx = seed_text[:order]
    for _ in range(n_chars - order):
        choices = table.get(ctx)
        if not choices:
            ctx = seed_text[:order]
            choices = table[ctx]
        ch = choices[int(rng.integers(len(choices)))]
        out.append(ch)
        ctx = ctx[1:] + ch
    return "".join(out)


def load_text(path: str | None = None, allow_synthetic: bool = True) -> str:
    """Resolve the training corpus (see the module docstring for the
    order). A candidate counts when it is a file of more than 1000 bytes.
    With ``allow_synthetic=False`` a missing corpus raises
    ``FileNotFoundError`` instead of falling to the synthetic one."""
    candidates = [c for c in (path, os.environ.get("LINALG_TPU_DATA")) if c]
    here = pathlib.Path(__file__).resolve().parents[2]
    candidates += [str(here / c) for c in _LOCAL_CANDIDATES]
    for c in candidates:
        p = pathlib.Path(c)
        if p.is_file() and p.stat().st_size > 1000:
            return p.read_text(encoding="utf-8")
    if not allow_synthetic:
        raise FileNotFoundError("No training corpus available")
    print("[data] no local corpus; using the deterministic synthetic corpus")
    return synthetic_corpus()


def build_char_vocab(text: str) -> Tuple[Dict[str, int], Dict[int, str]]:
    tok = CharTokenizer(text)
    return tok.stoi, tok.itos


def encode(text: str, stoi: Dict[str, int]) -> np.ndarray:
    """Text -> int32 ids; characters outside ``stoi`` are dropped."""
    return CharTokenizer.from_pretrained(
        stoi, {i: c for c, i in stoi.items()}).encode(text)


def decode(ids, itos: Dict[int, str]) -> str:
    return "".join(itos[int(i)] for i in np.asarray(ids).ravel())


def batch_stream(data_ids: np.ndarray, B: int, T: int,
                 rng: np.random.Generator
                 ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Random windows (x, y = x shifted by one) forever, as int32 (B, T)
    numpy arrays; starts drawn from ``rng`` as the JAX package draws them."""
    data_ids = np.ascontiguousarray(data_ids, dtype=np.int32)
    L = len(data_ids)
    cols = np.arange(T)
    while True:
        offs = rng.integers(0, L - T - 1, size=B)[:, None] + cols[None, :]
        yield data_ids[offs], data_ids[offs + 1]
