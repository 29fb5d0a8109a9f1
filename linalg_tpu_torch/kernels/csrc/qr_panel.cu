// Householder reflector sweep over a transposed QR panel strip, for Hopper
// (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU kernels of linalg_tpu/ops/pallas/qr_panel.py:
// factor_strip (qr_panel.py:143, _strip_kernel, the unrolled sweep that
// householder_qr_pallas runs on every 32-wide strip) and factor_panel
// (qr_panel.py:173, _panel_kernel, the same contract for any width through
// a fori_loop and masked selects). The unrolling and the masked selects are
// TPU indexing workarounds; one kernel here takes any b up to MAX_B.
//
// Contract (the Pallas kernels' contract, unchanged), all float32:
//   s_in (b, m)   the transposed strip St: row j is column j of the panel
//   k             the global pivot of row 0 (row j pivots at lane k + j)
//   s_out (b, m)  St after the b reflections (rows hold this strip's R rows)
//   vt (b, m)     unit-norm reflectors w_j, zero left of lane k + j
//   tt (b, b)     the transposed compact-WY factor: H_0 ... H_{b-1} =
//                 I - V T V^T with T = Tt^T, tau = 2
// For each step j: x = row j of S on lanes >= k + j; nrm = ||x||; the step
// is skipped when nrm < eps (w = 0, Tt[j, j] = 0, S unchanged — padded and
// zero columns rely on that being exact); else alpha = copysign(nrm, x0),
// w = (x + alpha e) / sqrt(wn2) with wn2 = nrm^2 + 2 alpha x0 + alpha^2;
// y = S w over all b rows; S -= 2 y w^T; Vt[j] = w; z = Vt[:j] w;
// Tt[j, :j] = -2 z^T Tt[:j]; Tt[j, j] = 2. Everything is element-wise f32
// FMA, never the tensor cores: the TPU kernel stays off the MXU to avoid
// bf16 operands, and TF32 would do the same harm here.
//
// What bounds it on this card: one strip is a chain of b dependent steps,
// and each step streams the live part of S twice (y, then the update) and
// the finished reflectors once (z): about 4 b (m - k) floats of traffic per
// step, at m = 4096, b = 32 some 0.5-2 MB. The strip does not fit in one
// SM: St and Vt are 512 KB each at m = 4096, b = 32, against 227 KB of
// shared memory and 256 KB of registers. The TPU kept it in VMEM.
//
// Design: one thread block per strip (NT threads). S, Vt and Tt stay in
// device memory and are swept from there; their ~1 MB working set stays in
// the 50 MB L2, so each step is bound by one SM's L2 bandwidth and by its
// five block barriers. The reflector w lives in shared memory (m floats).
// Per step: one block-wide reduction (the norm); then all b + j dot
// products of y and z in one phase, one warp per row writing its result to
// shared memory (no per-dot block reduction); then the rank-1 update of S
// over the flattened (b, live lanes) range, with the Tt row computed beside
// it. Only lanes >= k + j are read or written (rounded down to a multiple
// of 4 for 16-byte loads; w is zero there). Later, faster designs: a
// thread-block cluster holding the strip in distributed shared memory, and
// fusing the update with the next step's norm.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 1024;           // threads per block
constexpr int NWARPS = NT / 32;    // 32: one reduction slot per warp
constexpr int MAX_B = 256;         // rows of St (panel width)
constexpr int MAX_M = 32768;       // lanes of St (matrix rows); w is m floats
static_assert(NWARPS == 32, "block_sum reads one slot per lane");

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: every lane ends with the same, bitwise equal, sum
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of one value per thread over the block; every thread gets it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = warp_sum(red[threadIdx.x & 31]);
  __syncthreads();  // red is free again
  return t;
}

// Dot product of a row of length m with w over lanes [lo, m), by one warp.
// With V4, lo and m are multiples of 4 and the row is 16-byte aligned.
template <bool V4>
__device__ __forceinline__ float warp_row_dot(const float* row,
                                              const float* w, int lo, int m,
                                              int lane) {
  float s = 0.f;
  if (V4) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const float4* w4 = reinterpret_cast<const float4*>(w);
    for (int q = (lo >> 2) + lane; q < (m >> 2); q += 32) {
      const float4 a = r4[q];
      const float4 c = w4[q];
      s = fmaf(a.x, c.x, s);
      s = fmaf(a.y, c.y, s);
      s = fmaf(a.z, c.z, s);
      s = fmaf(a.w, c.w, s);
    }
  } else {
    for (int l = lo + lane; l < m; l += 32) s = fmaf(row[l], w[l], s);
  }
  return warp_sum(s);
}

// s, vt and tt are written during the sweep and read back by other
// threads, so they are plain pointers: no __restrict__, no read-only path.
template <bool V4>
__global__ void __launch_bounds__(NT)
qr_panel_kernel(const float* __restrict__ s_in, float* s, float* vt,
                float* tt, int b, int m, int k, float eps) {
  extern __shared__ __align__(16) float smem[];
  const int m_pad = (m + 3) & ~3;
  float* w = smem;             // (m_pad) the current reflector
  float* yz = w + m_pad;       // (2 b): y = S w, then z = Vt[:j] w
  float* red = yz + 2 * b;     // (NWARPS) reduction scratch
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long bm = (long)b * m;

  if (V4) {
    const float4* src = reinterpret_cast<const float4*>(s_in);
    float4* dst = reinterpret_cast<float4*>(s);
    float4* v4 = reinterpret_cast<float4*>(vt);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (long i = tid; i < bm / 4; i += NT) {
      dst[i] = src[i];
      v4[i] = zero;
    }
  } else {
    for (long i = tid; i < bm; i += NT) {
      s[i] = s_in[i];
      vt[i] = 0.f;
    }
  }
  for (int i = tid; i < b * b; i += NT) tt[i] = 0.f;
  __syncthreads();

  for (int j = 0; j < b; ++j) {
    const int jg = k + j;
    const float* xrow = s + (long)j * m;

    // 1. norm of the live part of row j (empty when jg >= m)
    float p = 0.f;
    for (int l = jg + tid; l < m; l += NT) p = fmaf(xrow[l], xrow[l], p);
    const float nrm2 = block_sum(p, red);
    const float nrm = sqrtf(nrm2);
    // skipped step (also NaN): w = 0 would leave S, Vt and Tt as they are,
    // and Vt[j], Tt[j, :] are already zero
    if (!(nrm >= eps)) continue;

    // 2. the reflector, into shared memory and Vt[j]
    const float x0 = xrow[jg];
    const float alpha = x0 >= 0.f ? nrm : -nrm;
    const float wn2 = nrm2 + 2.f * alpha * x0 + alpha * alpha;
    const float inv = rsqrtf(wn2 == 0.f ? 1.f : wn2);
    const int lo = V4 ? (jg & ~3) : jg;
    float* vrow = vt + (long)j * m;
    for (int l = lo + tid; l < m; l += NT) {
      float wl = 0.f;
      if (l >= jg) {
        wl = (xrow[l] + (l == jg ? alpha : 0.f)) * inv;
        vrow[l] = wl;
      }
      w[l] = wl;
    }
    __syncthreads();  // also: every thread has read x0 before row j changes

    // 3. y = S w (rows 0..b-1) and z = Vt[:j] w (rows b..b+j-1), one warp
    // per row
    for (int r = warp; r < b + j; r += NWARPS) {
      const float* row = r < b ? s + (long)r * m : vt + (long)(r - b) * m;
      const float d = warp_row_dot<V4>(row, w, lo, m, lane);
      if (lane == 0) yz[r] = d;
    }
    __syncthreads();

    // 4. Tt row j from z and the rows of Tt before it (Tt is lower
    // triangular, so only c <= i contributes), then S -= 2 y w^T on the
    // live lanes
    if (tid <= j) {
      float t = 2.f;
      if (tid < j) {
        float acc = 0.f;
        for (int i = tid; i < j; ++i)
          acc = fmaf(yz[b + i], tt[(long)i * b + tid], acc);
        t = -2.f * acc;
      }
      tt[(long)j * b + tid] = t;
    }
    if (V4) {
      const int q0 = lo >> 2;
      const int nq = (m >> 2) - q0;
      float4* s4 = reinterpret_cast<float4*>(s);
      const float4* w4 = reinterpret_cast<const float4*>(w);
      for (int i = tid; i < b * nq; i += NT) {  // b * m < 2^31
        const int r = i / nq;
        const int q = q0 + (i - r * nq);
        const float c = -2.f * yz[r];
        const float4 wq = w4[q];
        float4 v = s4[(long)r * (m >> 2) + q];
        v.x = fmaf(c, wq.x, v.x);
        v.y = fmaf(c, wq.y, v.y);
        v.z = fmaf(c, wq.z, v.z);
        v.w = fmaf(c, wq.w, v.w);
        s4[(long)r * (m >> 2) + q] = v;
      }
    } else {
      const int nl = m - lo;
      for (int i = tid; i < b * nl; i += NT) {
        const int r = i / nl;
        const int l = lo + (i - r * nl);
        s[(long)r * m + l] = fmaf(-2.f * yz[r], w[l], s[(long)r * m + l]);
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Returns 0 on success, -1 for arguments the kernel does not take, else the
// cudaError_t of the launch.
extern "C" int qr_panel_launch(const void* s_in, void* s_out, void* vt,
                               void* tt, int b, int m, int k, float eps,
                               void* stream) {
  if (b < 1 || b > MAX_B || m < 1 || m > MAX_M || k < 0) return -1;
  const int m_pad = (m + 3) & ~3;
  const size_t smem = (size_t)(m_pad + 2 * b + NWARPS) * sizeof(float);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(s_in) | reinterpret_cast<uintptr_t>(s_out) |
        reinterpret_cast<uintptr_t>(vt)) & 15) == 0;
  void (*kern)(const float*, float*, float*, float*, int, int, int, float) =
      (m % 4 == 0 && aligned) ? &qr_panel_kernel<true>
                               : &qr_panel_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<1, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s_in), static_cast<float*>(s_out),
      static_cast<float*>(vt), static_cast<float*>(tt), b, m, k, eps);
  return (int)cudaGetLastError();
}
