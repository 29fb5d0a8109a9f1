"""Time the sampling path at the published config (``bench.py:329``,
``chip_smoke.SAMPLE_CFG``) on the card, in one process:

    python3 tools/bench_sample.py [--rounds 4] [--profile]

Each round times, interleaved, ``train.trainer.sample`` of 2048 tokens
from [1, 2, 3] (context rollover every 128) and ``gpt_generate`` of phase
16's 8 ragged prompts x 128 new tokens, in f32 and bf16, each two ways:
the decode step's Python position filled in on the device (``fill``, the
package's ``models.gpt._positions``) and copied from the host by
``torch.as_tensor`` (``copy``: a blocking copy that waits for the device
every token, what the step did before). Prints one JSON line per case
with the host wall times of every round (``s``), their median and tok/s,
and the card's name and power limit as ``nvidia-smi`` gives them.
``--profile`` adds ``torch.profiler`` breakdowns of one f32 ``sample`` of
512 tokens each way (device time, idle share, top kernels and ops), last:
the profiler stays attached to the card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from linalg_tpu_torch.models import gpt as tgpt  # noqa: E402
from linalg_tpu_torch.train.trainer import sample  # noqa: E402


def copied_positions(x, dev):
    """The position as the decode step made it before: a copy from the
    host, which blocks until the device's queue drains."""
    return torch.as_tensor(x, dtype=torch.int32, device=dev).reshape(-1)


@contextlib.contextmanager
def positions(way):
    with smoke.patched((tgpt, {"_positions": copied_positions}
                        if way == "copy" else {})):
        yield


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_sample: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    ident = {i: i for i in range(smoke.SAMPLE_CFG["vocab_size"])}
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 65, size=(int(L),))
               for L in rng.integers(3, 120, size=(8,))]
    models = {}
    for dtype in ("float32", "bfloat16"):
        cfg = tgpt.GPTConfig(dtype=dtype, **smoke.SAMPLE_CFG)
        models[dtype] = (cfg, tgpt.init_gpt_params(cfg, seed=0,
                                                   device="cuda"))
    runs = {
        "sample": (lambda p, c: list(sample(p, c, [1, 2, 3], ident,
                                            steps=smoke.SAMPLE_TOKENS,
                                            seed=1)), smoke.SAMPLE_TOKENS),
        "gpt_generate": (lambda p, c: tgpt.gpt_generate(
            p, c, prompts, smoke.GEN_NEW, seed=0).cpu(),
            len(prompts) * smoke.GEN_NEW),
    }
    times = {}
    for (dtype, (cfg, params)) in models.items():  # first use out of it
        for way in ("fill", "copy"):
            with positions(way):
                for fn, _ in runs.values():
                    fn(params, cfg)
    for r in range(args.rounds):
        ways = ("fill", "copy") if r % 2 == 0 else ("copy", "fill")
        for dtype, (cfg, params) in models.items():
            for name, (fn, _) in runs.items():
                for way in ways:
                    with positions(way):
                        _, s = smoke.timed(lambda: fn(params, cfg))
                    times.setdefault((name, dtype, way), []).append(s)
    for (name, dtype, way), s in times.items():
        med = float(np.median(s))
        print(json.dumps({"run": name, "dtype": dtype, "positions": way,
                          "s": s, "median_s": med,
                          "tok_s": runs[name][1] / med, "card": smi}),
              flush=True)
    if args.profile:
        cfg, params = models["float32"]
        for way in ("fill", "copy"):
            with positions(way), torch.profiler.profile(
                    activities=smoke.PROFILED) as prof:
                t0 = time.perf_counter()
                list(sample(params, cfg, [1, 2, 3], ident, steps=512,
                            seed=1))
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            smoke.report_profile(f"sample {way}", "f32 sample of 512 "
                                 "tokens", prof, wall)
    return 0


if __name__ == "__main__":
    sys.exit(main())
