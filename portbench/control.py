"""Readings that the check's limits are set from, at a cell's own size.

    python3 -m portbench.control --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 [--seconds 12] [--out FILE]

For every seed it prints one JSON line (and appends it to ``--out``):

- ``program``: what the check reads from the program's timed path against
  the plain reference, as a benchmark run reads it;
- on the control seeds, ``control``: the same numbers with the plain
  reference in the program's place computed a precision below the
  configuration's (float8 e4m3 operands for bfloat16), and, in a
  training cell, ``half``: the reference in the program's place with half
  of each batch left out (half the rows; with one row, half its
  positions), the mean taken over the rest. A state left unchanged reads
  1 by the measure of ``change_gap`` and needs no run.

Serving cells run a window of ``--seconds`` at the cell's own load, then
score the program's served tokens and, on the same prompts and tokens,
the tokens that the float8 reference puts first, each by the check's
``flip_gap`` against the cell's limit (``compared``), beside the widest
and the mean gap. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import manifest
from portbench.reference import gpt as ref


def train_readings(kind, run, control: bool):
    run.setup()
    run.release()
    base = run.reference()
    out = {"program": run.readings(base)}
    if control:
        c = run.reference(mm=ref.fp8_mm)
        out["control"] = kind.compare(c["losses"], c["grad_norms"],
                                     c["change"], base)
        rows = run.B // 2 if run.B > 1 else -(run.T // 2)
        h = run.reference(rows=rows)
        out["half"] = kind.compare(h["losses"], h["grad_norms"],
                                  h["change"], base)
    return out


def _gap_readings(g) -> dict:
    """What a stream's gaps read: the widest, the mean and the share of
    tokens that are not the reference's best, beside ``flip_gap``."""
    if g is None or g.numel() == 0:
        return {}
    return {"gap": float(g.max()), "mean_gap": float(g.mean()),
            "flips": float((g > 0).float().mean())}


def serve_readings(run, control: bool, seconds: float):
    run.setup()
    run.measure(seconds)
    run.release()
    got = run.reference_gaps(run.sample(), control=control)
    out = {"tokens": got["tokens"]}
    for side in ("program", "control") if control else ("program",):
        g = got[side]
        out[side] = {**_gap_readings(g), "compared": run.compared(g)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    root = manifest.ROOT
    cell = manifest.cell(root, manifest.load(root), args.workload)
    kind = manifest.kind_module(root, cell["mix"]["kind"])
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        run = kind.Run(cell, seed, device)
        if cell["mix"]["kind"] == "train":
            out = train_readings(kind, run, seed in ctrl)
        else:
            out = serve_readings(run, seed in ctrl, args.seconds)
        out = {"workload": args.workload, "seed": seed, **out}
        line = json.dumps(out)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
