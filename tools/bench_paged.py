"""Time the paged decode-attention kernels (K5/K6) of one checkout's
``linalg_tpu_torch`` on the card, beside their plain PyTorch version and
the bound, so two checkouts (a parent commit unpacked beside the tree, and
the tree) can be compared in one run on one card:

    python3 tools/bench_paged.py --root PARENT_DIR --root . \\
        --root . --root PARENT_DIR

Each ``--root`` runs in a process of its own (the kernels build there from
that checkout's sources at first use). Every case prints one JSON line:
the root, the case and its shape (B, H, hk, d, page, Pmax), the dtype, the
split count S where the checkout splits, CUDA-event medians in ms of the
kernel and of the plain version called from Python (``ms``, host launch
overhead included) and replayed from a CUDA graph over copies of the
inputs larger than the L2 (``device_ms``), the bound in ms and what bounds
it, the max abs error against the plain version, and the card's name and
power limit as ``nvidia-smi`` gives them. ``--sweep`` also takes the
split count and device time with the wrapper's ``WAVES`` at 0 (S 1), 1,
2, 4 and 8; ``--profile`` adds a line per case, after all timing, with each
CUDA kernel's device time per call from ``torch.profiler``. Inputs, bound
and timing are ``chip_smoke.py``'s (``kernel_case``, ``paged_bound``,
``median_ms``, ``graph_ms``) and the cases its ``PAGED_CASES``, so they
are phase 3's.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""


def smoke_helpers():
    """This checkout's ``chip_smoke.py``, loaded by path (a root's own copy
    may predate its ``PAGED_CASES``)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_root(root: str, sweep: bool, profile: bool) -> None:
    """Time every case with the package under ``root``; one JSON line
    each, and with ``profile`` one more per case, last, with each kernel's
    device time."""
    smoke = smoke_helpers()
    sys.path.insert(0, str(pathlib.Path(root).resolve()))
    import torch

    from linalg_tpu_torch.kernels import paged_attention as kp
    from linalg_tpu_torch.serve.paged import paged_attention_ref

    if not torch.cuda.is_available():
        raise SystemExit("bench_paged: no CUDA card")
    name = card()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    splits_of = getattr(kp, "paged_splits", None)  # older checkouts: none
    profiled = []
    for i, (case, shp, dt, per_head, layout) in enumerate(
            smoke.PAGED_CASES):
        args = smoke.kernel_case(*shp, dt, seed=i, per_head_mask=per_head,
                                 layout=layout)
        try:
            got = kp.paged_attention_cuda(*args)
        except ValueError as e:  # a shape an older kernel does not take
            print(json.dumps({"root": root, "case": case, "refused": str(e),
                              "card": name}), flush=True)
            continue
        want = paged_attention_ref(*args)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        bms, by = smoke.paged_bound(*args)
        sets = smoke.cold_copies(args)
        row = {"root": root, "case": case, "shape": list(shp),
               "dtype": str(dt).removeprefix("torch."),
               "ms": smoke.median_ms(kp.paged_attention_cuda, args),
               "plain_ms": smoke.median_ms(paged_attention_ref, args),
               "device_ms": smoke.graph_ms(kp.paged_attention_cuda, sets),
               "plain_device_ms": smoke.graph_ms(paged_attention_ref, sets),
               "bound_ms": bms, "bound_by": by, "max_abs_err": err,
               "card": name}
        if splits_of is not None:
            S = splits_of(*shp[:3], *shp[4:], n_sm)
            row["S"] = S
            if sweep:
                row["S_and_device_ms_by_waves"] = {
                    w: sweep_waves(kp, smoke, shp, n_sm, w, sets)
                    for w in (0, 1, 2, 4, 8)}
        print(json.dumps(row), flush=True)
        if profile:
            profiled.append((case, sets))
        else:
            del sets
        del args, got, want
        torch.cuda.empty_cache()
    # last: the profiler stays attached to the card once it has run
    for case, sets in profiled:
        print(json.dumps({"root": root, "case": case,
                          "device_ms_by_kernel": kernel_ms(
                              kp.paged_attention_cuda, sets),
                          "card": name}), flush=True)


def sweep_waves(kp, smoke, shp, n_sm, waves, sets):
    """[S, device ms] with the wrapper's ``WAVES`` set to ``waves`` (0
    gives S 1) while the CUDA graph is captured."""
    old = kp.WAVES
    kp.WAVES = waves
    try:
        return [kp.paged_splits(*shp[:3], *shp[4:], n_sm),
                smoke.graph_ms(kp.paged_attention_cuda, sets)]
    finally:
        kp.WAVES = old


def kernel_ms(fn, arg_sets, rounds=3):
    """Mean device time (ms) per call of each CUDA kernel ``fn`` runs,
    from ``torch.profiler`` over ``rounds`` passes of the argument sets."""
    import torch

    for a in arg_sets:
        fn(*a)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            for a in arg_sets:
                fn(*a)
        torch.cuda.synchronize()
    calls = rounds * len(arg_sets)
    return {e.key[:60]: e.self_device_time_total / 1e3 / calls
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append", required=True,
                    help="a checkout whose linalg_tpu_torch is timed; "
                         "repeat to compare")
    ap.add_argument("--sweep", action="store_true",
                    help="also time other split counts (checkouts that "
                         "split)")
    ap.add_argument("--profile", action="store_true",
                    help="also print each kernel's device time from "
                         "torch.profiler (after every timing)")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one:
        run_root(a.root[0], a.sweep, a.profile)
        return 0
    flags = [f for f, on in (("--sweep", a.sweep), ("--profile", a.profile))
             if on]
    rc = 0
    for root in a.root:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", "--root", root] + flags).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
