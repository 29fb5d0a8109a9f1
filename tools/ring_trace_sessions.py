"""How often a ``torch.profiler`` session on the card loses the ring's
kernel records: one ring forward+backward (``chip_smoke.ring_run`` at
long_window's shape, bf16) profiled four ways, 15 sessions each in turns:
CUDA activity only with a kernel of its own first (``chip_smoke.
ring_copies``' session), CPU and CUDA activity, and each of those after a
warm-up step traced and thrown away (``torch.profiler.schedule``):

    python3 tools/ring_trace_sessions.py

Prints, for each way, the ring kernels each session's trace held (3 when
it is complete) and how many of the sessions were complete.
"""

import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.chdir(ROOT)
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from linalg_tpu_torch.kernels import build as kbuild  # noqa: E402

P = torch.profiler


def ring_kernels(events):
    return sum(1 for e in events if "dur" in e and e.get("cat") == "kernel"
               and any(f in e["name"] for f in ("fwd_bf16", "dq_bf16",
                                                "dkdv_bf16")))


def export(prof):
    with tempfile.TemporaryDirectory() as tmp:
        prof.export_chrome_trace(f"{tmp}/t.json")
        return json.load(open(f"{tmp}/t.json"))["traceEvents"]


def main():
    kbuild.build("ring_attention")
    x = [torch.randn(8, 4, 4096, 128, device="cuda", dtype=torch.bfloat16)
         for _ in range(4)]
    for _ in range(2):
        cs.ring_run(x, cs.SP, window=512)
    torch.cuda.synchronize()

    def cuda_only():
        with P.profile(activities=[P.ProfilerActivity.CUDA]) as prof:
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            cs.ring_run(x, cs.SP, window=512)
            torch.cuda.synchronize()
        return ring_kernels(export(prof))

    def cpu_cuda():
        with P.profile(activities=[P.ProfilerActivity.CPU,
                                   P.ProfilerActivity.CUDA]) as prof:
            cs.ring_run(x, cs.SP, window=512)
            torch.cuda.synchronize()
        return ring_kernels(export(prof))

    def warm(acts):
        got = []
        with P.profile(activities=acts,
                       schedule=P.schedule(wait=0, warmup=1, active=1,
                                           repeat=1),
                       on_trace_ready=lambda p: got.append(
                           ring_kernels(export(p)))) as prof:
            for _ in range(2):
                cs.ring_run(x, cs.SP, window=512)
                torch.cuda.synchronize()
                prof.step()
        return got[0]

    ways = {"cuda_only": cuda_only, "cpu_cuda": cpu_cuda,
            "warm_cuda": lambda: warm([P.ProfilerActivity.CUDA]),
            "warm_cpu_cuda": lambda: warm([P.ProfilerActivity.CPU,
                                           P.ProfilerActivity.CUDA])}
    res = {k: [] for k in ways}
    for _ in range(15):
        for k, fn in ways.items():
            res[k].append(fn())
    for k, v in res.items():
        print(k, v, "complete", sum(n == 3 for n in v), "of", len(v),
              flush=True)


if __name__ == "__main__":
    main()
