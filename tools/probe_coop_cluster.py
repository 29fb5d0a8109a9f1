"""Whether a cooperative launch takes a thread-block cluster dimension on
this card, and what the largest co-resident grid of such clusters is.

    python3 tools/probe_coop_cluster.py

The grid kernel of ``linalg_tpu_torch/kernels/csrc/qr_panel.cu`` is
launched cooperatively, so that its CTAs, which wait on each other's
exchange words, are all resident at once. A first level of its exchange
inside thread-block clusters (distributed shared memory, as the cluster
kernel's) would need both launch attributes on one launch. This builds a
small probe kernel into the gitignored ``kernels/_build/`` with the
package's ``nvcc`` flags and launches it with
``cudaLaunchAttributeCooperative`` and ``cudaLaunchAttributeClusterDimension``
together, at cluster sizes 2, 4, 8 and 16 and grids of 64 and 128 CTAs: each
CTA writes its rank into its cluster's rank-0 CTA through distributed
shared memory, then every CTA waits on a grid-wide arrival counter (which
deadlocks unless all CTAs are resident), and the host checks the sums.
Prints one line a launch: the attributes' return code, the occupancy
(``cudaOccupancyMaxActiveClusters``) and whether the sums came out right,
then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from linalg_tpu_torch.kernels import build as kbuild  # noqa: E402

SOURCE = r"""
#include <cuda_runtime.h>

__global__ void probe(int* sums, unsigned* arrivals, int n) {
  __shared__ int acc;
  unsigned rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  if (threadIdx.x == 0) acc = 0;
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
  if (threadIdx.x == 0) {
    unsigned local = (unsigned)__cvta_generic_to_shared(&acc), remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, 0;"
                 : "=r"(remote) : "r"(local));
    asm volatile("red.shared::cluster.add.u32 [%0], %1;"
                 :: "r"(remote), "r"(rank + 1) : "memory");
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
  if (threadIdx.x == 0) {
    if (rank == 0) sums[blockIdx.x] = acc;
    __threadfence();
    atomicAdd(arrivals, 1u);
    const long long t0 = clock64();
    while (atomicAdd(arrivals, 0u) < (unsigned)n)
      if (clock64() - t0 > (1ll << 32)) __trap();
  }
}

extern "C" int probe_launch(int* sums, unsigned* arrivals, int n, int cs,
                            int* clusters) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n, 1, 1);
  cfg.blockDim = dim3(128, 1, 1);
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaFuncSetAttribute(
      probe, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(clusters, probe, &cfg);
  if (err != cudaSuccess) return (int)err;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, probe, sums, arrivals, n);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceSynchronize();
  return (int)err;
}
"""


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_coop_cluster: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    kbuild.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = kbuild.BUILD_DIR / "probe_coop_cluster.cu"
    so = kbuild.BUILD_DIR / "probe_coop_cluster.so"
    src.write_text(SOURCE)
    res = subprocess.run([kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", str(so),
                          str(src)], capture_output=True, text=True)
    if res.returncode:
        print(res.stderr, file=sys.stderr)
        return 1
    fn = ctypes.CDLL(str(so)).probe_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for n in (64, 128):
        for cs in (2, 4, 8, 16):
            sums = torch.zeros(n, dtype=torch.int32, device="cuda")
            arrivals = torch.zeros(1, dtype=torch.int32, device="cuda")
            clusters = ctypes.c_int(0)
            rc = fn(sums.data_ptr(), arrivals.data_ptr(), n, cs,
                    ctypes.byref(clusters))
            right = None
            if rc == 0:
                want = cs * (cs + 1) // 2
                got = sums.view(-1, cs)[:, 0].cpu()
                right = bool((got == want).all())
            print(f"grid {n} CTAs, clusters of {cs}: launch code {rc}, "
                  f"{clusters.value} clusters co-resident, sums right "
                  f"{right}", flush=True)
            if rc not in (0, 1, 2, 98, 720, 801, 912):
                break  # a sticky error: later launches cannot run
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
