"""ctypes loader for the host C loops (``fastloader.c``) — the counterpart
of ``linalg_tpu/native/loader.py``.

The shared library is compiled at first use (``cc -O3 -shared -fPIC``)
into ``linalg_tpu_torch/native/_build/fastloader-<digest>.so``; the digest
covers the source, the compiler and the flags, so an edited source is
rebuilt and a stale library is never loaded. The build writes a temporary
file and renames it into place, so concurrent processes racing on the
first build never load a partial library. Every entry point keeps the
pure-Python loop as its exact-semantics oracle and uses it when no
compiler is available (``native_available()`` says which ran). These are
host loops: nothing here touches a device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["native_available", "native_error", "encode_chars",
           "gather_windows", "bpe_train_native", "bpe_encode_native",
           "BUILD_DIR"]

_SRC = pathlib.Path(__file__).resolve().with_name("fastloader.c")
BUILD_DIR = _SRC.parent / "_build"
CC_FLAGS = ("-O3", "-shared", "-fPIC")
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_ERROR: Optional[str] = None

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)


def _build() -> ctypes.CDLL:
    cc = os.environ.get("CC", "cc")
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join((cc,) + CC_FLAGS).encode())
    so = BUILD_DIR / f"fastloader-{h.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        res = subprocess.run([cc, *CC_FLAGS, str(_SRC), "-o", str(tmp)],
                             capture_output=True, text=True, check=False)
        if res.returncode:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building {_SRC.name} failed:\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, so)  # atomic: a racing loader never sees a partial
    lib = ctypes.CDLL(str(so))
    lib.encode_ascii.restype = ctypes.c_int64
    lib.encode_ascii.argtypes = [ctypes.c_char_p, ctypes.c_int64, _I32P,
                                 ctypes.c_int, _I32P]
    lib.gather_windows.restype = None
    lib.gather_windows.argtypes = [_I32P, ctypes.c_int64, _I64P,
                                   ctypes.c_int64, ctypes.c_int64, _I32P,
                                   _I32P]
    lib.bpe_train.restype = ctypes.c_int32
    lib.bpe_train.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                              ctypes.c_int32, _I32P]
    lib.bpe_encode.restype = ctypes.c_int64
    lib.bpe_encode.argtypes = [ctypes.c_char_p, ctypes.c_int64, _I32P,
                               ctypes.c_int32, _I32P]
    return lib


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED, _ERROR
    if not _TRIED:
        _TRIED = True
        try:
            _LIB = _build()
        except (OSError, RuntimeError) as e:  # no compiler or no library:
            # the Python loops run
            _LIB, _ERROR = None, f"{type(e).__name__}: {e}"
    return _LIB


def native_available() -> bool:
    """Whether the C library built and loaded (else the Python loops)."""
    return _lib() is not None


def native_error() -> Optional[str]:
    """Why the C library is unavailable, or None."""
    _lib()
    return _ERROR


def _ptr(a: np.ndarray, ctype=_I32P):
    return a.ctypes.data_as(ctype)


def encode_chars(text: str, stoi: Dict[str, int],
                 drop_unknown: bool = True) -> np.ndarray:
    """``CharTokenizer.encode`` semantics; the C loop for byte text."""
    lib = _lib()
    if lib is not None and all(len(c) == 1 and ord(c) < 256 for c in stoi):
        try:
            raw = text.encode("latin-1")
        except UnicodeEncodeError:
            raw = None
        if raw is not None:
            lut = np.full(256, -1, dtype=np.int32)
            for ch, i in stoi.items():
                lut[ord(ch)] = i
            out = np.empty(len(raw), dtype=np.int32)
            n = lib.encode_ascii(raw, len(raw), _ptr(lut),
                                 1 if drop_unknown else 0, _ptr(out))
            out = out[:n]
            if not drop_unknown and (out < 0).any():
                raise KeyError("unknown character in text")
            return out
    if drop_unknown:
        ids = [stoi[c] for c in text if c in stoi]
    else:
        ids = [stoi[c] for c in text]
    return np.asarray(ids, dtype=np.int32)


def gather_windows(ids: np.ndarray, starts: np.ndarray,
                   T: int) -> Tuple[np.ndarray, np.ndarray]:
    """Random-window batch gather: x[b] = ids[s:s+T], y shifted by one."""
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    B = starts.shape[0]
    if B and (starts.min() < 0 or starts.max() + T + 1 > len(ids)):
        raise ValueError(f"a window of {T + 1} ids from the starts runs "
                         f"outside the {len(ids)} ids")
    lib = _lib()
    if lib is not None:
        x = np.empty((B, T), dtype=np.int32)
        y = np.empty((B, T), dtype=np.int32)
        lib.gather_windows(_ptr(ids), len(ids), _ptr(starts, _I64P), B, T,
                           _ptr(x), _ptr(y))
        return x, y
    x = np.stack([ids[s:s + T] for s in starts])
    y = np.stack([ids[s + 1:s + T + 1] for s in starts])
    return x, y


def bpe_train_native(data: bytes, vocab_size: int
                     ) -> Optional[List[Tuple[int, int]]]:
    """BPE merges learned by the C loop, or None without the library (the
    caller runs the Python loop)."""
    lib = _lib()
    if lib is None:
        return None
    out = np.empty(2 * max(vocab_size - 256, 1), dtype=np.int32)
    n = lib.bpe_train(data, len(data), vocab_size, _ptr(out))
    if n < 0:
        return None
    return [(int(out[2 * i]), int(out[2 * i + 1])) for i in range(n)]


def bpe_encode_native(data: bytes, merges) -> Optional[np.ndarray]:
    """int32 ids of ``data`` under the learned merges by the C loop, or
    None without the library (the caller runs the Python loop)."""
    lib = _lib()
    if lib is None:
        return None
    if len(data) == 0:
        return np.empty(0, dtype=np.int32)
    flat = np.ascontiguousarray(np.asarray(merges, dtype=np.int32)
                                .reshape(-1))
    out = np.empty(len(data), dtype=np.int32)
    m = lib.bpe_encode(data, len(data), _ptr(flat), len(merges), _ptr(out))
    if m < 0:
        return None
    return out[:m].copy()
