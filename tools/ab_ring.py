"""Interleaved A/B of the ring kernels K10/K11 between checkouts on the
card, at ``chip_smoke.py`` phase 14's sp shapes, each ``--root`` in a
process of its own, in the order given:

    python3 tools/ab_ring.py --root PARENT_DIR --root . \\
        --root . --root PARENT_DIR

Each process builds that checkout's kernels, then times its
``ring_attention_pallas_local`` (K10) and ``ring_attention_pallas_bwd_local``
(K11) over 4 ranks on the card three ways: as phase 14 does (the median
over 7 trials of the CUDA-event time of 3 calls, host included), over 20
calls a trial (the host's share amortised when the card is the slower),
and the host time to issue one call (no synchronisation). A digest of the
outputs shows whether two checkouts compute the same bits. Prints the
card's name and power limit, one JSON line a root, then the median of
each number over the processes of each root.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r'''
import hashlib, json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from linalg_tpu_torch.parallel import make_mesh
from linalg_tpu_torch.parallel.ring_pallas import (
    ring_attention_pallas_bwd_local, ring_attention_pallas_local)

CASES = (  # phase 14's sp shapes: name, B, h, T, d, dtype, window
    ("long_window", 8, 4, 4096, 128, torch.bfloat16, 512),
    ("long_window f32", 8, 4, 4096, 128, torch.float32, 512),
    ("train_big", 24, 8, 1024, 128, torch.bfloat16, None))


def median_ms(fn, args, trials, reps, warm=3):
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


def host_us(fn, args, calls=20):
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / calls * 1e6


mesh = make_mesh((4,), ("sp",), ["cuda"] * 4)
out = {}
for i, (name, B, h, T, d, dtype, window) in enumerate(CASES):
    rng = np.random.default_rng(1400 + i)
    x = [torch.tensor(rng.standard_normal((B, h, T, d)), dtype=dtype,
                      device="cuda") for _ in range(4)]
    kw = dict(causal=True, window=window)

    def fwd(q, k, v):
        return ring_attention_pallas_local(q, k, v, mesh=mesh,
                                           with_lse=True, **kw)

    o, L = fwd(*x[:3])
    delta = torch.sum(x[3].float() * o.float(), dim=-1)

    def bwd(q, k, v, do):
        return ring_attention_pallas_bwd_local(q, k, v, do, L, delta,
                                               mesh=mesh, **kw)

    digest = hashlib.sha256()
    for t in (o, L) + tuple(bwd(*x)):
        digest.update(t.float().cpu().numpy().tobytes())
    out[name] = {
        "fwd_ms": median_ms(fwd, x[:3], 7, 3),
        "bwd_ms": median_ms(bwd, x, 7, 3),
        "fwd_ms_20": median_ms(fwd, x[:3], 7, 20),
        "bwd_ms_20": median_ms(bwd, x, 7, 20),
        "fwd_host_us": host_us(fwd, x[:3]),
        "bwd_host_us": host_us(bwd, x),
        "digest": digest.hexdigest()[:16]}
    del x, o, L, delta
    torch.cuda.empty_cache()
print(json.dumps(out))
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", action="append", required=True,
                    help="a checkout whose linalg_tpu_torch to time")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    rc = 0
    runs = {}
    for root in args.root:
        res = subprocess.run([sys.executable, "-c", CHILD,
                              os.path.abspath(root)], capture_output=True,
                             text=True)
        rc = rc or res.returncode
        line = (res.stdout.strip().splitlines()[-1] if res.returncode == 0
                else res.stderr[-1500:])
        print(root, line, flush=True)
        if res.returncode == 0:
            runs.setdefault(root, []).append(json.loads(line))
    for root, got in runs.items():
        med = {}
        for case in got[0]:
            med[case] = {
                k: sorted(g[case][k] for g in got)[len(got) // 2]
                for k in got[0][case] if k != "digest"}
            med[case]["digests"] = sorted({g[case]["digest"] for g in got})
        print("median", root, json.dumps(med), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
