"""Run one cell of the benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, weights, building or loading the kernels, warm-up) is
timed as ``setup_s``. With ``--trace 1`` a few steps are then profiled
(``portbench.trace``). The window measures for ``--seconds``; then the
program's state is freed, the plain reference checks what the timed path
produced, and the last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``compared``: each number the check
compared, beside its limit (also the last lines of standard error).

It needs the CUDA cards the cell asks for and fails without them; it
never falls back to the CPU.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
from typing import Dict, Optional  # noqa: E402

from portbench import manifest  # noqa: E402
from portbench.trace import Segment, breakdown, busy_us  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "linalg_tpu")


def banned_modules() -> list:
    """Loaded modules whose top-level name is one the port must not load
    (compared as whole names: ``linalg_tpu_torch`` is not ``linalg_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(root: pathlib.Path, name: str, seed: int, seconds: float,
             trace: bool, device, t0: float = _T0) -> Dict:
    """One run of cell ``name`` on ``device``: the result object."""
    import torch

    bench = manifest.load(root)
    cell = manifest.cell(root, bench, name)
    run = manifest.kind_module(root, cell["mix"]["kind"]).Run(
        cell, seed, device)
    run.setup()
    _sync(device)
    # what set-up left behind stays out of the window's collections
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0
    seg, seg_info = None, {}
    if trace:
        seg = Segment()
        with seg.record(lambda: _sync(device)):
            seg_info = run.segment()
    window = run.measure(seconds)
    gc.unfreeze()
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
        kind = torch.cuda.get_device_name(device)
    else:
        peak, kind = 0, "cpu"
    run.release()
    compared = run.check()
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in compared.values())
    metrics: Dict[str, Dict] = {}
    if trace:
        ctx = {"cell": cell, "window": window, "segment": seg_info,
               "events": seg.events, "span": seg.span}
        for m in manifest.metrics_of(bench, name, "per_layer"):
            v = manifest.reader(root, m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(window["metrics"], setup_s=setup_s)
        for m in manifest.metrics_of(bench, name, "end_to_end"):
            if m["name"] in values:  # a tail of no samples has no value
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": kind, "count": cell["chips"],
           "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(window["attempted"]),
           "failed": int(window["failed"]), "metrics": metrics,
           "device": dev}
    if trace and seg.span is not None:
        dev["busy_s"] = busy_us(seg.events, seg.span) / 1e6
        dev["window_s"] = (seg.span[1] - seg.span[0]) / 1e6
        out["breakdown"] = breakdown(seg.events, seg.span)
    out["compared"] = compared
    return out


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = manifest.ROOT
    cell = manifest.cell(root, manifest.load(root), args.workload)

    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = run_cell(root, args.workload, args.seed, args.seconds,
                   bool(args.trace), device)
    found = banned_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; the port and "
              "the harness must not", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for k, c in out["compared"].items():
        print(f"compared {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
