"""Tokenizers — the counterpart of ``linalg_tpu/nn/tokenizers.py``: the
character tokenizer and byte-level BPE, with the same merge order, ranks,
encodings and serialized state. Host-side; the byte loops run in the
port's own C library (``linalg_tpu_torch/native``) with the Python loops
as their exact-semantics oracle.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, List, Optional

import numpy as np

__all__ = ["BaseTokenizer", "CharTokenizer", "BPETokenizer"]


class BaseTokenizer(ABC):
    """Minimal tokenizer interface."""

    @abstractmethod
    def encode(self, text: str) -> np.ndarray:
        """Text -> int32 token-id array."""

    @abstractmethod
    def decode(self, ids) -> str:
        """Token ids -> text."""

    @property
    @abstractmethod
    def vocab_size(self) -> int:
        """Number of distinct tokens."""


class CharTokenizer(BaseTokenizer):
    """Character vocabulary, ordered by sorted unique characters, with the
    reference's ``stoi``/``itos`` dict views."""

    def __init__(self, text: Optional[str] = None,
                 vocab: Optional[List[str]] = None):
        if vocab is None and text is None:
            raise ValueError("Must provide either text or vocab")
        self._set_vocab(list(vocab) if vocab is not None
                        else sorted(set(text)))

    def _set_vocab(self, chars: List[str]) -> None:
        self._vocab = chars
        self.stoi = {ch: i for i, ch in enumerate(chars)}
        self.itos = dict(enumerate(chars))

    @classmethod
    def from_pretrained(cls, stoi: Dict[str, int],
                        itos: Dict) -> "CharTokenizer":
        tok = cls.__new__(cls)
        ordered = [None] * len(itos)
        for k, v in itos.items():
            ordered[int(k)] = v
        tok._set_vocab(ordered)
        tok.stoi = dict(stoi)  # honor a non-contiguous custom stoi
        return tok

    def encode(self, text: str, drop_unknown: bool = True) -> np.ndarray:
        """Text -> int32 ids; unknown characters are dropped, or raise
        ``KeyError`` with ``drop_unknown=False``."""
        from ..native import encode_chars

        return encode_chars(text, self.stoi, drop_unknown=drop_unknown)

    def decode(self, ids) -> str:
        return "".join(self.itos[int(i)] for i in np.asarray(ids).ravel())

    @property
    def vocab_size(self) -> int:
        return len(self.stoi)


class BPETokenizer(BaseTokenizer):
    """Byte-level byte-pair encoding: tokens 0..255 are raw bytes, learned
    merges extend the vocabulary (merge i is token 256 + i, its rank).
    Build it with ``BPETokenizer.train(text, vocab_size)`` or ``load``;
    the bare constructor raises (there is no untrained BPE)."""

    def __init__(self, merges: Optional[List[tuple]] = None):
        if merges is None:
            raise NotImplementedError(
                "BPETokenizer has no untrained form: use "
                "BPETokenizer.train(text, vocab_size) or "
                "BPETokenizer.load().")
        self.merges: List[tuple] = [tuple(m) for m in merges]
        # pair -> merged token id, in training order (rank = priority); a
        # pair learned twice keeps its later rank, as in the C loop
        self.ranks: Dict[tuple, int] = {
            pair: 256 + i for i, pair in enumerate(self.merges)}
        self._expand: Dict[int, bytes] = {}

    @classmethod
    def train(cls, text: str, vocab_size: int = 512) -> "BPETokenizer":
        """Learn merges by repeatedly fusing the most frequent adjacent
        pair (ties: the smaller first id, then first appearance). The loop
        runs in C when the library builds, else in ``_train_py``."""
        assert vocab_size >= 256, "byte-level BPE needs vocab_size >= 256"
        from ..native import bpe_train_native

        data = text.encode("utf-8")
        native = bpe_train_native(data, vocab_size)
        if native is not None:
            return cls(native)
        return cls(cls._train_py(data, vocab_size))

    @classmethod
    def _train_py(cls, data: bytes, vocab_size: int) -> List[tuple]:
        """Pure-Python merge learning: the oracle of the C loop."""
        ids = list(data)
        merges: List[tuple] = []
        next_id = 256
        while next_id < vocab_size and len(ids) > 1:
            counts: Dict[tuple, int] = {}
            for a, b in zip(ids, ids[1:]):
                counts[(a, b)] = counts.get((a, b), 0) + 1
            pair, freq = max(counts.items(),
                             key=lambda kv: (kv[1], -kv[0][0]))
            if freq < 2:
                break
            ids = cls._merge(ids, pair, next_id)
            merges.append(pair)
            next_id += 1
        return merges

    @staticmethod
    def _merge(ids: List[int], pair: tuple, new_id: int) -> List[int]:
        out, i, n = [], 0, len(ids)
        while i < n:
            if i + 1 < n and ids[i] == pair[0] and ids[i + 1] == pair[1]:
                out.append(new_id)
                i += 2
            else:
                out.append(ids[i])
                i += 1
        return out

    def encode(self, text: str) -> np.ndarray:
        from ..native import bpe_encode_native

        data = text.encode("utf-8")
        native = bpe_encode_native(data, self.merges)
        if native is not None:
            return native
        return self._encode_py(data)

    def _encode_py(self, data: bytes) -> np.ndarray:
        """Pure-Python encode: the oracle of the C loop. The lowest-rank
        (earliest-learned) applicable pair merges first, everywhere."""
        ids = list(data)
        while len(ids) > 1:
            best, best_rank = None, None
            for a, b in zip(ids, ids[1:]):
                r = self.ranks.get((a, b))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = (a, b), r
            if best is None:
                break
            ids = self._merge(ids, best, best_rank)
        return np.asarray(ids, dtype=np.int32)

    def token_bytes(self, i: int) -> bytes:
        """Raw bytes of one token id (streamed decode feeds these through
        an incremental UTF-8 decoder, so a character split across tokens
        reassembles)."""
        i = int(i)
        if i < 256:
            return bytes([i])
        if i not in self._expand:
            a, b = self.merges[i - 256]
            self._expand[i] = self.token_bytes(a) + self.token_bytes(b)
        return self._expand[i]

    def decode(self, ids) -> str:
        data = b"".join(self.token_bytes(int(i))
                        for i in np.asarray(ids).ravel())
        return data.decode("utf-8", errors="replace")

    @property
    def vocab_size(self) -> int:
        return 256 + len(self.merges)

    def save(self) -> Dict:
        return {"merges": [list(m) for m in self.merges]}

    @classmethod
    def load(cls, data: Dict) -> "BPETokenizer":
        return cls(merges=[tuple(m) for m in data["merges"]])
