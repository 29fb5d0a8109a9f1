"""Where a step of the QR panel kernels spends its time, on the card.

    python3 tools/qr_step_clocks.py

Builds two variants of ``linalg_tpu_torch/kernels/csrc/qr_panel.cu`` into
the gitignored ``kernels/_build/``, from the unchanged source with the
instrumentation it keeps behind compile-time switches:

- ``-DQR_STEP_CLOCKS``: thread 0 of CTA 0 and of the last CTA read
  ``clock64()`` at the boundaries of each step's phases (the kernels'
  ``QR_TICK``) and sum the cycles per phase; ``qr_step_clocks`` copies the
  sums out after the launch. The cluster kernel's phases: selecting row j
  and posting the pivot lane's columns, the partial dots with the warp's
  first fold, the other folds, the block barrier, the block sum with the
  pushes into every CTA, CTA 0's Tt row with the wait for the pushes, the
  sums in rank order, the second block barrier, the reflector's scalars,
  the register update. The grid kernel's: the partial dots with their
  sum over the slot's threads and the CTA's exchange words, the previous
  step's Tt columns, the reduce (polling and summing the G partials of
  this CTA's slots), the gather of every slot's total with the block
  barrier, the scalars and the update.
- ``-DQR_STEP_BARRIER``: one extra cluster barrier a step in the cluster
  kernel, so its time against the unchanged kernel's is the cost of a
  cluster barrier.

Prints cycles a step per phase at (b, m, k) = (32, 4096, 0) (C 16),
(32, 4096, 3968) (C 1) and (64, 4096, 0) (C 16) on the cluster kernel and
(32, 16384, 0) (G 128) and (128, 4096, 0) (G 64) on the grid kernel, the
SM clock, the device time (a CUDA graph over copies of St larger than the
L2) of each as built by the package and, for the cluster kernel, of the
``barrier`` variant, and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from linalg_tpu_torch.kernels import build as kbuild  # noqa: E402
from linalg_tpu_torch.kernels import qr_panel as kqp  # noqa: E402

CASES = [(32, 4096, 0), (32, 4096, 3968), (64, 4096, 0), (32, 16384, 0),
         (128, 4096, 0)]
PHASES = {"cluster": ["row j, pivot post", "partials + first fold",
                      "other folds", "block barrier", "block sum + push",
                      "Tt row + wait", "sums in rank order", "block barrier",
                      "scalars", "update"],
          "grid": ["partial dots + words", "Tt columns", "reduce",
                   "gather + barrier", "scalars + update"]}


def build_variant(define):
    """qr_panel.cu built with ``-D<define>``; returns the library's path."""
    kbuild.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = kbuild.BUILD_DIR / f"{define.lower()}.so"
    res = subprocess.run([kbuild._nvcc(), *kbuild.NVCC_FLAGS, f"-D{define}",
                          "-o", str(so),
                          str(kbuild.CSRC_DIR / "qr_panel.cu")],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"building {so.name} failed:\n{res.stderr}")
    return str(so)


def launcher(lib, b, m, k):
    """The kernel of library ``lib`` that the wrapper's shape rule picks:
    (function, kernel name, CTAs)."""
    C, lpt = kqp.cluster_shape(b, m, k)
    if C:
        return (lambda St, k: kqp._launch(St, k, C, lpt, lib)), "cluster", C
    G, L, on_chip = kqp.grid_shape(b, m, k)
    return ((lambda St, k: kqp._launch_grid(St, k, G, L, on_chip, lib)),
            "grid", G)


def main() -> int:
    if not torch.cuda.is_available():
        print("qr_step_clocks: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    clocks = build_variant("QR_STEP_CLOCKS")
    barrier = build_variant("QR_STEP_BARRIER")
    read_clocks = ctypes.CDLL(clocks).qr_step_clocks
    for b, m, k in CASES:
        St = torch.tensor(np.random.default_rng(1).standard_normal((b, m)),
                          dtype=torch.float32, device="cuda")
        run, kernel, n = launcher(clocks, b, m, k)
        for _ in range(3):
            run(St, k)
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * 32)()
        if read_clocks(buf):
            raise RuntimeError("reading the clocks failed")
        last = 16 if n > 1 else 0  # the last CTA's row (CTA 0's alone)
        names = PHASES[kernel]
        print(f"(b, m, k) = ({b}, {m}, {k}), {kernel} kernel, {n} CTAs: "
              f"cycles a step, CTA 0 / CTA {n - 1}")
        for i, name in enumerate(names, start=1):
            print(f"  {name:24s} {buf[i] / b:8.1f} "
                  f"{buf[last + i] / b:8.1f}")
        end = len(names) + 1
        print(f"  {'all':24s} {sum(buf[1:end]) / b:8.1f} "
              f"{sum(buf[last + 1:last + end]) / b:8.1f}")
        sets = [(c, k) for (c,) in smoke.cold_copies((St,), 64 << 20)]
        kqp.factor_strip_cuda(St, k)
        base = smoke.graph_ms(kqp.factor_strip_cuda, sets)
        if kernel == "grid":
            print(f"  device ms: kernel {base:.4f} ({base / b * 1e3:.3f} us "
                  "a step)")
            continue
        extra = smoke.graph_ms(launcher(barrier, b, m, k)[0], sets)
        print(f"  device ms: kernel {base:.4f}, with one more cluster "
              f"barrier a step {extra:.4f} ({(extra - base) / b * 1e3:.3f} "
              f"us a barrier)")
    sm = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                         "--format=csv,noheader"], capture_output=True,
                        text=True).stdout.strip()
    print(f"SM clock {sm}; {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
