"""Interleaved A/B of ``train.trainer.sample`` between checkouts on the
card: each ``--root`` runs in a process of its own, in the order given:

    python3 tools/ab_sample.py --root PARENT_DIR --root . \\
        --root PARENT_DIR --root . --root PARENT_DIR --root .

At phase 16's config (d 512, 4 heads, 4 layers, ctx 256, float32) each
process warms up on 512 tokens, times ``sample`` of 2048 tokens three
times (tok/s, host clock around a synchronised run), then counts the CUDA
events of one 128-token chunk with ``torch.profiler``: equal counts mean
the two checkouts launch the same kernels. Prints the card's name and
power limit, one JSON line a root, then each root's median tok/s over all
of its timed runs. ``--cpu`` runs the same loop on the host alone, one
thread, at d 32 (1024 tokens), where a step's time is Python and op
dispatch: a check of the decode step's host cost without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r'''
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from linalg_tpu_torch.models.gpt import GPTConfig, init_gpt_params
from linalg_tpu_torch.train.trainer import sample

cpu = sys.argv[2] == "cpu"
if cpu:
    torch.set_num_threads(1)
sync = (lambda: None) if cpu else torch.cuda.synchronize
cfg = GPTConfig(vocab_size=65, d_model=32 if cpu else 512, n_heads=4,
                n_layers=4, ctx_len=256)
p = init_gpt_params(cfg, seed=0, device=sys.argv[2])
ident = {i: i for i in range(65)}
steps = 1024 if cpu else 2048
list(sample(p, cfg, [1, 2, 3], ident, steps=steps // 4, seed=0, chunk=128))
sync()
tps = []
for _ in range(3):
    t = time.perf_counter()
    list(sample(p, cfg, [1, 2, 3], ident, steps=steps, seed=0, chunk=128))
    sync()
    tps.append(round(steps / (time.perf_counter() - t), 1))
if cpu:
    print(json.dumps({"sample_tok_s": tps}))
    sys.exit(0)
with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    list(sample(p, cfg, [1, 2, 3], ident, steps=128, seed=0, chunk=128))
    torch.cuda.synchronize()
n = sum(e.count for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA)
print(json.dumps({"sample_tok_s": tps, "cuda_events_128_tokens": n}))
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", action="append", required=True,
                    help="a checkout whose linalg_tpu_torch to time")
    ap.add_argument("--cpu", action="store_true",
                    help="time on the host alone, at d 32")
    args = ap.parse_args()
    if not args.cpu:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True)
        print(smi.stdout.strip(), flush=True)
    rc = 0
    tps = {}
    for root in args.root:
        res = subprocess.run([sys.executable, "-c", CHILD,
                              os.path.abspath(root),
                              "cpu" if args.cpu else "cuda"],
                             capture_output=True, text=True)
        rc = rc or res.returncode
        line = (res.stdout.strip().splitlines()[-1] if res.returncode == 0
                else res.stderr[-1500:])
        print(root, line, flush=True)
        if res.returncode == 0:
            tps.setdefault(root, []).extend(json.loads(line)["sample_tok_s"])
    for root, xs in tps.items():
        xs = sorted(xs)
        print(f"median {root}: {xs[len(xs) // 2]} tok/s over {len(xs)} runs "
              f"({xs[0]}-{xs[-1]})", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
