"""Time the Householder panel kernels (K1/K12, ``csrc/qr_panel.cu``) on the
card: the cluster kernel at one and at two lanes a thread (C 16 and C 8
CTAs at m 4096; the wrapper's shape rule takes two only past 16 CTAs of
one), and the single-block kernel (the design before the cluster kernel,
which the wrapper keeps for the shapes a cluster does not hold), at the
same strips in one process, beside the plain PyTorch sweep and the bound;
then the 4096^2 ``householder_qr`` interleaved with ``torch.linalg.qr``:

    python3 tools/bench_qr.py [--qr_reps 3] [--profile]

The strips are phase 6's (``chip_smoke.QR_CASES``, the same seeds). Every
case prints one JSON line: the kernel, its cluster size C (0 for the
single-block kernel), the strip (b, m, k), CUDA-event medians in ms called
from Python (``ms``) and replayed from a CUDA graph over copies of St
larger than the L2 (``device_ms``; the single-block kernel is device-bound,
so its eager time stands), the plain version's ``plain_ms``, the bound, the
max error of St, Vt and Tt against the plain version as a share of
max|want|, and the card's name and power limit as ``nvidia-smi`` gives
them. ``--profile`` adds a ``torch.profiler`` breakdown of one QR, last.
Inputs, bound and timing helpers are ``chip_smoke.py``'s (``strip_bound``,
``median_ms``, ``graph_ms``, ``cold_copies``, ``report_profile``).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from linalg_tpu_torch.kernels import qr_panel as kqp  # noqa: E402
from linalg_tpu_torch.ops.qr import householder_qr  # noqa: E402
from linalg_tpu_torch.ops.qr_panel import (  # noqa: E402
    factor_panel_ref,
    factor_strip_ref,
)


def block_kernel(St, k):
    """The single-block kernel on St, whatever the shape rule picks."""
    return kqp._launch(St, k, 0, 0)


def cluster_kernel(lpt):
    """The cluster kernel at ``lpt`` lanes a thread, whatever the shape
    rule picks."""
    def run(St, k):
        return kqp._launch(St, k, kqp.cluster_ctas(St.shape[1], k, lpt), lpt)
    return run


def rel_err(got, want):
    return max(float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
               for g, w in zip(got, want))


def strip_cases(card):
    for i, (name, (b, m, k), zero) in enumerate(smoke.QR_CASES):
        St = np.random.default_rng(100 + i).standard_normal((b, m))
        if zero is not None:
            St[zero] = 0.0
        St = torch.tensor(St, dtype=torch.float32, device="cuda")
        ref = factor_strip_ref if b <= 64 else factor_panel_ref
        want = ref(St, k)
        plain_ms = smoke.median_ms(ref, (St, k), trials=5, reps=2, warm=1)
        bms, by = smoke.strip_bound(b, m - k)
        runs = [("single-block", 0, block_kernel)]
        if b <= kqp.CLUSTER_MAX_B:
            runs += [(f"cluster, {lpt} lane(s) a thread", lpt,
                      cluster_kernel(lpt))
                     for lpt in ((1, 2) if b <= 32 else (1,))]
        for kernel, lpt, fn in runs:
            C = kqp.cluster_ctas(m, k, lpt) if lpt else 0
            if C > kqp.MAX_CLUSTER:
                continue
            err = rel_err(fn(St, k), want)
            slow = not C
            ms = smoke.median_ms(fn, (St, k), trials=7 if slow else 15,
                                 reps=3 if slow else 10)
            dev_ms = ms if slow else smoke.graph_ms(fn, [
                (c, k) for (c,) in smoke.cold_copies((St,), 64 << 20)])
            print(json.dumps(dict(
                case=name, kernel=kernel, C=C, b=b, m=m, k=k, ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                rel_err_of_max=err, card=card)), flush=True)
        del St
        torch.cuda.empty_cache()


def qr_runs(card, reps):
    N = smoke.QR_N
    A = torch.tensor(np.random.default_rng(0).standard_normal((N, N)),
                     dtype=torch.float32, device="cuda")
    A64 = A.double()

    runs = {"householder_qr": householder_qr,
            "torch.linalg.qr": torch.linalg.qr}
    for fn in runs.values():
        fn(A)
    torch.cuda.synchronize()
    times = {name: [] for name in runs}
    for _ in range(reps):  # interleaved, so drift hits every candidate
        for name, fn in runs.items():
            a = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            a.record()
            fn(A)
            e.record()
            torch.cuda.synchronize()
            times[name].append(a.elapsed_time(e))
    for name, fn in runs.items():
        Q, R = fn(A)
        rel = float(torch.linalg.norm(Q.double() @ R.double() - A64)
                    / torch.linalg.norm(A64))
        print(json.dumps(dict(run=name, n=N, ms=times[name],
                              median_ms=float(np.median(times[name])),
                              rel_resid=rel, card=card)), flush=True)
    return A


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--qr_reps", type=int, default=3)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_qr: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    strip_cases(card)
    A = qr_runs(card, args.qr_reps)
    if args.profile:  # last: the profiler stays attached to the card
        householder_qr(A)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=smoke.PROFILED) as prof:
            t0 = time.perf_counter()
            householder_qr(A)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        smoke.report_profile("qr", "householder_qr", prof, wall)
    return 0


if __name__ == "__main__":
    sys.exit(main())
