"""Build the port's CUDA kernels from the sources in ``kernels/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` straight into ``kernels/_build/lib<name>-<digest>.so`` for Hopper
(``sm_90a``), then loaded with ``ctypes`` by its wrapper. No PyTorch header
is included, so a build takes seconds rather than the minutes a
``torch.utils.cpp_extension`` build of the same file takes, and it needs no
``ninja``. The digest covers the source, the shared headers
``csrc/*.cuh`` it may include and the flags, so an edited source or header
is rebuilt and a stale library is never loaded.

Building happens at first use, never at import: importing the package works
on a machine with no CUDA toolkit. A build failure raises with the
compiler's output; nothing falls back to another implementation.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess
import time

__all__ = ["build", "BUILD_DIR", "NVCC_FLAGS"]

CSRC_DIR = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
DEFAULT_NVCC = pathlib.Path("/usr/local/cuda/bin/nvcc")


def _nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, else ``PATH``, else the
    toolkit's default install location."""
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if DEFAULT_NVCC.exists():
        return str(DEFAULT_NVCC)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def _digest(src: pathlib.Path) -> str:
    """Digest of a source, every shared header beside it and the flags."""
    h = hashlib.sha1(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def build(name: str) -> pathlib.Path:
    """Return the shared library built from ``csrc/<name>.cu``, compiling
    it first if this source and these flags have not been built yet.

    The compiler's output (``-Xptxas -v`` prints registers, shared memory
    and spills per kernel) is kept beside the library as ``<stem>.log``."""
    src = CSRC_DIR / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}-{_digest(src)}.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    log = (f"$ {' '.join(cmd)}\n# {seconds:.1f} s, exit {res.returncode}\n"
           f"{res.stdout}{res.stderr}")
    out.with_suffix(".log").write_text(log)
    if res.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {src.name} failed:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial
    return out
