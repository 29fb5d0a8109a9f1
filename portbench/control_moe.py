"""``portbench.control``'s readings for a cell of a training kind other
than ``train`` (``train_moe``), which ``control`` sends to its serving
branch:

    python3 -m portbench.control_moe --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 [--out FILE]

One JSON line a seed, as ``control`` prints them: ``program`` and, on the
control seeds, ``control`` (the reference at float8 e4m3 operands) and
``half`` (half of each batch left out).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import control, manifest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control_moe needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    root = manifest.ROOT
    cell = manifest.cell(root, manifest.load(root), args.workload)
    kind = manifest.kind_module(root, cell["mix"]["kind"])
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        run = kind.Run(cell, seed, device)
        out = {"workload": args.workload, "seed": seed,
               **control.train_readings(kind, run, seed in ctrl)}
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
