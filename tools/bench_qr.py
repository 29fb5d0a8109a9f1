"""Time the Householder panel kernels (K1/K12, ``csrc/qr_panel.cu``) on the
card: the cluster kernel at one and at two lanes a thread (where a cluster
holds the strip), the grid kernel at the wrapper's (G, L) at every strip
(the cluster kernel's too) and, where the shape rule picks it, with the
lanes spread over half as many CTAs, and, with ``--parent``, the
single-block kernel of an earlier source, at the same strips in one
process, beside the plain PyTorch sweep and the bound; then
``householder_qr`` at 4096^2 and at 16384 x 4096 interleaved with
``torch.linalg.qr``:

    python3 tools/bench_qr.py [--parent qr_panel.cu] [--qr_reps 3]
                              [--profile]

``--parent`` names a ``qr_panel.cu`` that exports the single-block
kernel's ``qr_panel_launch`` (the design before the grid kernel, e.g.
``git show <commit>:linalg_tpu_torch/kernels/csrc/qr_panel.cu``). It is
built into the gitignored ``kernels/_build/`` and timed at every strip
before any kernel of this tree runs.

The strips are phase 6's (``chip_smoke.QR_CASES``, the same seeds). Every
case and kernel prints one JSON line: the kernel, its CTAs (C or G; 1 for
the single block), the strip (b, m, k), the CUDA-event median in ms called
from Python (``ms``), the same replayed from a CUDA graph over copies of St
larger than the L2 (``device_ms``; null for the single-block kernel, which
is device-bound), the plain version's ``plain_ms``, the bound,
the max error of St, Vt and Tt against the plain version as a share of
max|want|, and the card's name and power limit as ``nvidia-smi`` gives
them. ``--profile`` adds a ``torch.profiler`` breakdown of each QR, last.
Inputs, bound and timing helpers are ``chip_smoke.py``'s (``strip_bound``,
``median_ms``, ``graph_ms``, ``cold_copies``, ``report_profile``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from linalg_tpu_torch.kernels import build as kbuild  # noqa: E402
from linalg_tpu_torch.kernels import qr_panel as kqp  # noqa: E402
from linalg_tpu_torch.ops.qr import householder_qr  # noqa: E402
from linalg_tpu_torch.ops.qr_panel import (  # noqa: E402
    factor_panel_ref,
    factor_strip_ref,
)
from linalg_tpu_torch.utils.numerics import eps_for  # noqa: E402


def parent_kernel(src):
    """The single-block kernel of the source at ``src``, built with the
    package's flags: a function (St, k) -> (St_out, Vt, Tt)."""
    kbuild.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = kbuild.BUILD_DIR / "parent_qr_panel.so"
    res = subprocess.run([kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", str(so),
                          str(src)], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"building {src} failed:\n{res.stderr}")
    fn = ctypes.CDLL(str(so)).qr_panel_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(St, k):
        b, m = St.shape
        S_out, Vt, Tt = kqp._outputs(St)
        rc = fn(St.data_ptr(), S_out.data_ptr(), Vt.data_ptr(),
                Tt.data_ptr(), b, m, k, eps_for(torch.float32),
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"single-block launch failed (code {rc})")
        return S_out, Vt, Tt
    return run


def cluster_kernel(lpt):
    """The cluster kernel at ``lpt`` lanes a thread, whatever the shape
    rule picks."""
    def run(St, k):
        return kqp._launch(St, k, kqp.cluster_ctas(St.shape[1], k, lpt), lpt)
    return run


def grid_kernel(b, m, k, G):
    """The grid kernel with the live lanes spread over at most G CTAs, by
    the wrapper's rule (``grid_shape``); (function, CTAs, lanes a CTA)."""
    G, L, on_chip = kqp.grid_shape(b, m, k, G)
    return (lambda St, k: kqp._launch_grid(St, k, G, L, on_chip)), G, L


def rel_err(got, want):
    return max(float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
               for g, w in zip(got, want))


def strip(i):
    name, (b, m, k), zero, _ = smoke.QR_CASES[i]
    St = np.random.default_rng(100 + i).standard_normal((b, m))
    if zero is not None:
        St[zero] = 0.0
    return torch.tensor(St, dtype=torch.float32, device="cuda")


def kernels_of(b, m, k):
    """(label, CTAs, function) of every kernel of this tree to time: the
    cluster kernel where a cluster holds the strip, and the grid kernel
    at every shape (at the cluster kernel's shapes too, so that each
    kernel is measured where the rule picks the other), at the wrapper's
    G and, where the rule picks it, at half as many CTAs."""
    runs = []
    if b <= kqp.CLUSTER_MAX_B:
        for lpt in ((1, 2) if b <= 32 else (1,)):
            C = kqp.cluster_ctas(m, k, lpt)
            if C <= kqp.MAX_CLUSTER:
                runs.append((f"cluster, {lpt} lane(s) a thread", C,
                             cluster_kernel(lpt)))
    G = kqp.grid_shape(b, m, k)[0]
    for g in (G,) if kqp.cluster_shape(b, m, k)[0] else (G, -(-G // 2)):
        fn, G_, L = grid_kernel(b, m, k, g)
        runs.append((f"grid, {L} lanes a CTA", G_, fn))
    return runs


def time_case(i, kernel, ctas, fn, card, graph):
    name, (b, m, k), _, _ = smoke.QR_CASES[i]
    St = strip(i)
    ref = factor_strip_ref if b <= 64 else factor_panel_ref
    want = ref(St, k)
    err = rel_err(fn(St, k), want)
    slow = kernel == "single-block"
    ms = smoke.median_ms(fn, (St, k), trials=7 if slow else 15,
                         reps=3 if slow else 10)
    sets = [(c, k) for (c,) in smoke.cold_copies((St,), 64 << 20)]
    dev_ms = smoke.graph_ms(fn, sets) if graph else None
    plain_ms = smoke.median_ms(ref, (St, k), trials=5, reps=2, warm=1)
    bms, by = smoke.strip_bound(b, m - k)
    print(json.dumps(dict(
        case=name, kernel=kernel, ctas=ctas, b=b, m=m, k=k, ms=ms,
        device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, rel_err_of_max=err, card=card)), flush=True)
    del St
    torch.cuda.empty_cache()


def qr_runs(card, reps, shapes):
    out = []
    for M, N in shapes:
        A = torch.tensor(np.random.default_rng(0).standard_normal((M, N)),
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
            print(json.dumps(dict(run=name, m=M, n=N, ms=times[name],
                                  median_ms=float(np.median(times[name])),
                                  rel_resid=rel, card=card)), flush=True)
        del A64
        out.append(A)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=pathlib.Path)
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
    cases = range(len(smoke.QR_CASES))
    if args.parent:  # first, before any kernel of this tree has run
        run = parent_kernel(args.parent)
        for i in cases:
            time_case(i, "single-block", 1, run, card, graph=False)
    for i in cases:
        b, m, k = smoke.QR_CASES[i][1]
        for kernel, ctas, fn in kernels_of(b, m, k):
            time_case(i, kernel, ctas, fn, card, graph=True)
    As = qr_runs(card, args.qr_reps, [(smoke.QR_N, smoke.QR_N),
                                      smoke.QR_TALL])
    if args.profile:  # last: the profiler stays attached to the card
        for A in As:
            householder_qr(A)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=smoke.PROFILED) as prof:
                t0 = time.perf_counter()
                householder_qr(A)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            smoke.report_profile("qr", f"householder_qr {tuple(A.shape)}",
                                 prof, wall)
    return 0


if __name__ == "__main__":
    sys.exit(main())
