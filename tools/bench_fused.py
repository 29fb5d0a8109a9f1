"""Time the fused LayerNorm kernels K8 (``ln_qkv``) and K9 (``ln_ffn``) of
one checkout's ``linalg_tpu_torch`` on the card, forward and
forward+backward, so two checkouts (a parent commit unpacked beside the
tree, and the tree) can be compared in one run on one card:

    python3 tools/bench_fused.py --root PARENT_DIR --root . \\
        --root . --root PARENT_DIR

Each ``--root`` runs in a process of its own (the kernels build there from
that checkout's sources at first use). Every case prints one JSON line:
the root, the shape (N, D, F), the dtype, CUDA-event medians in ms, and the
card's name and power limit as ``nvidia-smi`` gives them. Inputs are made
from a numpy seed as in ``chip_smoke.py``'s phase 12.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

CASES = (  # (N, D, F, dtype)
    (24576, 1024, 4096, "float32"),   # train_big's width
    (16384, 512, 2048, "float32"),    # the published width
    (4096, 2048, 8192, "bfloat16"),   # a width past 1024
)


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""


def median_ms(fn, args, trials, reps, warm):
    import numpy as np
    import torch

    for _ in range(warm):
        fn(*args)
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn(*args)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def run_root(root: str) -> None:
    """Time every case with the package under ``root``; one JSON line
    each."""
    sys.path.insert(0, str(pathlib.Path(root).resolve()))
    import numpy as np
    import torch

    from linalg_tpu_torch.kernels import fused_layer as kf

    name = card()
    for N, D, F, dt in CASES:
        dtype = getattr(torch, dt)
        rng = np.random.default_rng(500)

        def t(*shape, scale=1.0, shift=0.0):
            return torch.tensor(rng.standard_normal(shape) * scale + shift,
                                dtype=dtype, device="cuda")

        x = t(N, D)
        g, b = t(D, scale=0.1, shift=1.0), t(D, scale=0.1)
        qkv = (x, g, b, *(t(D, D, scale=D ** -0.5) for _ in range(3)))
        ffn = (x, g, b, t(D, F, scale=D ** -0.5), t(F, scale=0.1),
               t(F, D, scale=F ** -0.5), t(D, scale=0.1))

        def k_qkv(*a):  # the forward's outputs stand in for dq, dk, dv
            return kf.ln_qkv_bwd_cuda(*a, *kf.ln_qkv_fwd_cuda(*a))

        def k_ffn(*a):
            return kf.ln_ffn_bwd_cuda(*a[:6], kf.ln_ffn_fwd_cuda(*a))

        times = {
            what: median_ms(fn, args, trials=5, reps=3, warm=2)
            for what, fn, args in (("ln_qkv fwd", kf.ln_qkv_fwd_cuda, qkv),
                                   ("ln_qkv fwd+bwd", k_qkv, qkv),
                                   ("ln_ffn fwd", kf.ln_ffn_fwd_cuda, ffn),
                                   ("ln_ffn fwd+bwd", k_ffn, ffn))}
        print(json.dumps({"root": root, "shape": [N, D, F], "dtype": dt,
                          "ms": times, "card": name}), flush=True)
        del x, qkv, ffn
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append", required=True,
                    help="a checkout whose linalg_tpu_torch is timed; "
                         "repeat to compare")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one:
        run_root(a.root[0])
        return 0
    rc = 0
    for root in a.root:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", "--root", root]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
