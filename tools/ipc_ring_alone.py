"""``chip_smoke.py`` phase 28 alone on the card: the ring kernels K10/K11
across two processes through CUDA IPC, with what it is held against in
the same call:

    python3 tools/ipc_ring_alone.py

Builds ``ring_attention``, runs phase 26 (``ring_tables_phase``: the
one-process call on per-rank tensors, whose times phase 28 prints beside
its own), trains phase 28's ``--sp 4`` run in this one process (its
step-1 loss and ms/step, the yardstick phase 15 gives in a whole run),
then ``ipc_ring_phase``. Prints the card's name and power limit first.
About 1.5 minutes of chip time with the build.
"""

import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.chdir(ROOT)
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from linalg_tpu_torch.kernels import build as kbuild  # noqa: E402
from linalg_tpu_torch.kernels import ring_attention as kr  # noqa: E402


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    t = time.time()
    kbuild.build("ring_attention")
    print(f"build {time.time() - t:.1f} s", flush=True)
    tables = cs.ring_tables_phase()
    with tempfile.TemporaryDirectory() as tmp:
        one = cs.timed_train(cs.ipc_argv(), (kr.ring_fwd_cuda,
                                             kr.ring_bwd_cuda),
                             f"{tmp}/ck", f"{tmp}/one.jsonl")
    sp_one = dict(loss1=one["losses"][0], ms=cs.step_ms(one["stamps"]))
    print("one process", sp_one, one["launches"], flush=True)
    del one
    torch.cuda.empty_cache()
    print(cs.ipc_ring_phase(smi, tables, sp_one), flush=True)


if __name__ == "__main__":
    main()
