"""Character tokenizer — the counterpart of ``linalg_tpu/nn/tokenizers.py``'s
``CharTokenizer`` (byte-level BPE comes later, ROADMAP.md queue 1, item 2).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

__all__ = ["CharTokenizer"]


class CharTokenizer:
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
        if drop_unknown:
            ids = [self.stoi[c] for c in text if c in self.stoi]
        else:
            ids = [self.stoi[c] for c in text]
        return np.asarray(ids, dtype=np.int32)

    def decode(self, ids) -> str:
        return "".join(self.itos[int(i)] for i in np.asarray(ids).ravel())

    @property
    def vocab_size(self) -> int:
        return len(self.stoi)
