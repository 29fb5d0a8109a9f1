#!/usr/bin/env python
"""QR / Gaussian-elimination benchmark harness.

Port of ``linalg_tpu/ops/benchmark_qr.py``: the same table and CSV schema
(kernel, size, sec, sec/ref, residual/ref, orth_err), with the baseline
``torch.linalg.lstsq`` on the SAME device. Each kernel runs once untimed
(first-use costs, such as building the CUDA kernel), then ``--repeats``
timed calls; ``sec`` is their median. On a CUDA device each call is timed
with CUDA events around the call; on the CPU with ``time.perf_counter``.
Results are pulled to the host before the residuals are computed.

Run: ``python -m linalg_tpu_torch.ops.benchmark_qr [--device cuda]
[--sizes 300x300 1000x1000] [--out bench_results.csv]``
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .elimination import back_substitute, forward_eliminate
from .qr import (
    householder_qr,
    least_squares_householder_qr,
    least_squares_qr,
    qr,
)
from ..utils.device import resolve_device


def _timer(device: torch.device):
    """Seconds taken by one call of ``f``, on ``device``'s own clock."""
    if device.type == "cuda":
        def timed(f):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            f()
            b.record()
            torch.cuda.synchronize(device)
            return a.elapsed_time(b) / 1e3
    else:
        def timed(f):
            t0 = time.perf_counter()
            f()
            return time.perf_counter() - t0
    return timed


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", nargs="*",
                    default=["300x300", "1000x1000", "5000x1000"])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--out", default="bench_results.csv")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    sizes = [tuple(int(v) for v in s.replace("×", "x").split("x"))
             for s in args.sizes]
    device = resolve_device(args.device)  # raises without a card
    timed = _timer(device)

    np.random.seed(0)
    records = []
    for m, n in sizes:
        A = np.random.randn(m, n).astype(np.float32)
        b = np.random.randn(m).astype(np.float32)
        At = torch.as_tensor(A, device=device)
        bt = torch.as_tensor(b, device=device)

        def run(f, *fargs):
            f(*fargs)  # first use
            return float(np.median([timed(lambda: f(*fargs))
                                    for _ in range(args.repeats)]))

        def lstsq(A, b):
            return torch.linalg.lstsq(A, b[:, None]).solution[:, 0]

        t_ref = run(lstsq, At, bt)
        r_ref = np.linalg.norm(A @ _host(lstsq(At, bt)) - b, np.inf)

        if m == n:
            def gauss():
                U, c, *_ = forward_eliminate(At, bt)
                return back_substitute(U, c)

            t_g = run(gauss)
            r_g = np.linalg.norm(A @ _host(gauss()) - b, np.inf)
            records.append(("GE", f"{m}x{n}", t_g, t_g / t_ref, r_g / r_ref,
                            ""))

        t_mgs = run(qr, At)
        Q = _host(qr(At)[0])
        ortho = float(np.linalg.norm(Q.T @ Q - np.eye(n), np.inf))
        r_mgs = np.linalg.norm(A @ _host(least_squares_qr(At, bt)) - b,
                               np.inf)
        records.append(("MGS-QR", f"{m}x{n}", t_mgs, t_mgs / t_ref,
                        r_mgs / r_ref, ortho))

        t_hh = run(householder_qr, At)
        Qh = _host(householder_qr(At)[0])
        ortho2 = float(np.linalg.norm(Qh.T @ Qh - np.eye(n), np.inf))
        r_hh = np.linalg.norm(
            A @ _host(least_squares_householder_qr(At, bt)) - b, np.inf)
        records.append(("HH-QR", f"{m}x{n}", t_hh, t_hh / t_ref,
                        r_hh / r_ref, ortho2))

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {name}")
    header = ["kernel", "size", "sec", "sec/ref", "residual/ref", "orth_err"]
    widths = [8, 10, 10, 10, 14, 12]
    print(" | ".join(h.ljust(w) for h, w in zip(header, widths)))
    print("-|-".join("-" * w for w in widths))
    lines = [",".join(header)]
    for rec in records:
        cells = [
            str(rec[0]), str(rec[1]), f"{rec[2]:.4f}", f"{rec[3]:.3f}",
            f"{rec[4]:.3f}", (f"{rec[5]:.2e}" if rec[5] != "" else ""),
        ]
        print(" | ".join(c.ljust(w) for c, w in zip(cells, widths)))
        lines.append(",".join(cells))
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"\nwrote {args.out}")
    return records


if __name__ == "__main__":
    main()
