"""Host C loops of the data path: the char encoder, the window gather and
the byte-level BPE train/encode loops (``fastloader.c``, built at first
use), each with its pure-Python oracle."""

from .loader import (bpe_encode_native, bpe_train_native, encode_chars,
                     gather_windows, native_available, native_error)

__all__ = ["encode_chars", "gather_windows", "native_available",
           "native_error", "bpe_train_native", "bpe_encode_native"]
