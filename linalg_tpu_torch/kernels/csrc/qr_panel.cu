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
// each a reduction over the live lanes of every row followed by a rank-1
// update that the next step's reduction needs. The strip does not fit in
// one SM -- St and Vt are 512 KB each at m = 4096, b = 32, against 227 KB
// of shared memory and 256 KB of registers -- but it fits a thread-block
// cluster of 8-16 SMs. The TPU kept it in VMEM.
//
// Two kernels; the wrapper (kernels/qr_panel.py) picks one by shape alone.
//
// qr_cluster_kernel (b <= 64 and at most 16 CTAs of live lanes): one
// thread-block cluster per strip, the strip held in registers. CTA r of
// the C in the cluster owns the contiguous live lanes [lo + r CL, lo + (r
// + 1) CL), lo = k & ~3, CL = 256 LPT; thread t owns LPT of them and keeps
// each lane's column of S and of Vt (b values each) in registers, so a
// step's rank-1 update is register-local and a strip's device-memory
// traffic is its bytes read once and written once. The dot products fold
// into one reduction a step: with x = row j on lanes >= jg = k + j,
//   S_r . w = inv (S_r . x + alpha S_r[jg]),  Vt_i . w = inv (Vt_i . x +
//   alpha Vt_i[jg]),
// and S_j . x = nrm^2, S_j[jg] = x0. So each thread forms the 2B partial
// dots S_r . x and Vt_i . x of its lanes (B = 32 or 64 rows, zero past b),
// the warp sums them transposed (2B - 1 shuffles, each lane ending with
// 2B / 32 sums), the block's warps through shared memory, and each CTA
// pushes its block partials into every CTA of the cluster (itself too) with
// st.async, counted in bytes on the receiver's mbarrier; the CTA owning
// lane jg pushes its S and Vt columns beside them. Each CTA then sums the
// C partials of each dot in rank order, so nrm, alpha, inv, y and z are
// bitwise equal in every CTA and the exact-skip test agrees cluster-wide.
// Receive buffers and mbarriers ping-pong by step parity: a CTA can run at
// most one step ahead of another, since it needs every CTA's partials of a
// step to finish it. So no cluster barrier runs inside the sweep: on the
// H100 one more a step costs 0.4-0.6 us (tools/qr_step_clocks.py), about
// a quarter of a step. z rides in the step's reduction (the Vt_i . x
// dots), so Tt's recurrence runs as the steps go, in CTA 0, thread c
// keeping column c in shared memory, in the shadow of the next step's
// pushes; a Gram V V^T at the end would add a cluster reduction of b^2
// values and the whole recurrence after the last step. Lanes left of lo
// are only copied (St) and zeroed (Vt), by clusters of their own beside
// the sweeping one (grid y > 0), so a late strip's dead lanes do not run
// through the sweeping CTAs. A step is latency-bound (~4,000 cycles at b
// 32 on the H100: about half the warp folds and the register update,
// half the push's round trip and the sums), not bound by bytes.
//
// qr_panel_kernel (everything else: K12's b 128-256, or more live lanes
// than 16 CTAs hold): one 1024-thread block per strip. S, Vt and Tt stay in
// device memory and are swept from there; their working set stays in the
// 50 MB L2, so each step is bound by one SM's L2 bandwidth and by its five
// block barriers. The reflector w lives in shared memory (m floats). Per
// step: one block-wide reduction (the norm); then all b + j dot products
// of y and z in one phase, one warp per row writing its result to shared
// memory; then the rank-1 update of S over the flattened (b, live lanes)
// range, with the Tt row computed beside it. Only lanes >= k + j are read
// or written (rounded down to a multiple of 4 for 16-byte loads; w is zero
// there).

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


// ---- the cluster kernel ----

constexpr int CNT = 256;            // threads per CTA
constexpr int CWARPS = CNT / 32;    // 8
constexpr int MAX_CLUSTER = 16;     // CTAs per cluster (non-portable past 8)
constexpr int COPY_PER_CTA = 8192;  // dead-lane floats per copying CTA
constexpr unsigned FULL = 0xffffffffu;

// Step instrumentation of the cluster kernel, compiled in only with
// -DQR_STEP_CLOCKS (tools/qr_step_clocks.py): thread 0 of CTA 0 and of the
// last CTA sum the cycles of each phase of a step, QR_TICK(n) closing phase
// n (0 only starts the clock), and store the sums in qr_step_clock_sums,
// row 0 for CTA 0 and row 1 for the last. -DQR_STEP_BARRIER adds one
// cluster barrier a step, so its cost can be timed.
#ifdef QR_STEP_CLOCKS
__device__ long long qr_step_clock_sums[2][16];
#define QR_CLOCKS_INIT \
  long long acc_[16] = {}; \
  long long last_ = 0;
#define QR_CLOCKED (tid == 0 && (rank == 0 || (int)rank == C - 1))
#define QR_TICK(n)                         \
  if (QR_CLOCKED) {                        \
    const long long now_ = clock64();      \
    if (n) acc_[n] += now_ - last_;        \
    last_ = now_;                          \
  }
#define QR_CLOCKS_STORE                                   \
  if (QR_CLOCKED)                                         \
    for (int n_ = 0; n_ < 16; ++n_)                       \
      qr_step_clock_sums[rank == 0 ? 0 : 1][n_] = acc_[n_];
#else
#define QR_CLOCKS_INIT
#define QR_TICK(n)
#define QR_CLOCKS_STORE
#endif

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of the cluster arrives; its earlier shared-memory writes are
// visible to every thread of the cluster after the wait.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address in the CTA of cluster rank `rank` of shared-memory address
// `addr` of this CTA.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(addr), "r"(rank));
  return remote;
}

// 16 bytes into another CTA's shared memory, counted in bytes on that
// CTA's mbarrier `bar` (both cluster addresses)
__device__ __forceinline__ void st_async(uint32_t dst, float4 v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of st.async traffic this phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Wait, with acquire at cluster scope (the bytes come from other CTAs),
// for the completion of the barrier's phase of parity `parity`. A wait
// that has not completed after ~2^32 cycles (seconds) is a protocol fault:
// it traps, so the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
}

// One level of the warp's transposed sum: a[0, 2h) held by every lane
// becomes a[0, h), lanes with bit `o` set keeping the upper half. After
// the levels o = 16 ... 1, lane L holds the warp's sums of entries
// [L n / 32, (L + 1) n / 32) of the original n.
template <int H, int LEN>
__device__ __forceinline__ void fold(float (&a)[LEN], int o, int lane) {
  static_assert(2 * H <= LEN, "fold reads a[0, 2H)");
  const bool up = lane & o;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? a[i] : a[i + H];
    const float keep = up ? a[i + H] : a[i];
    a[i] = keep + __shfl_xor_sync(FULL, send, o);
  }
}

// Tt[j, c] for thread c <= j of CTA 0: -2 sum_{c <= i < j} z_i Tt[i, c]
// (Tt is lower triangular), Tt[j, j] = 2. Thread c alone reads and writes
// column c of ttc.
template <int B>
__device__ __forceinline__ void tt_row(float* ttc, const float* z, int j,
                                       int c) {
  float acc = 0.f;
  for (int i = c; i < j; ++i) acc = fmaf(z[i], ttc[i * B + c], acc);
  ttc[j * B + c] = c < j ? -2.f * acc : 2.f;
}

// B: rows held a lane (b padded with zero rows); LPT: lanes a thread.
// grid (C, 1 + D), cluster (C, 1, 1): cluster y = 0 sweeps the strip,
// clusters y > 0 copy the dead lanes [0, lo).
template <int B, int LPT>
__global__ void __launch_bounds__(CNT, 1)
qr_cluster_kernel(const float* __restrict__ s_in, float* __restrict__ s_out,
                  float* __restrict__ vt, float* __restrict__ tt, int b,
                  int m, int k, int lo, float eps) {
  constexpr int N = 2 * B;      // dots a step: S_r . x, then Vt_i . x
  constexpr int NPL = N / 32;   // sums a lane holds after the warp's fold
  constexpr int CL = CNT * LPT; // lanes a CTA
  __shared__ __align__(16) float red[CWARPS][N];
  __shared__ __align__(16) float pivl[N];  // the pivot lane's S, Vt columns
  // what every CTA of the cluster pushes here, ping-pong by step parity:
  // its block partials of the N dots, and the pivot lane's columns
  __shared__ __align__(16) float recv[2][MAX_CLUSTER][N];
  __shared__ __align__(16) float rpiv[2][N];
  __shared__ __align__(8) uint64_t mbar[2];   // the bytes of each parity
  __shared__ __align__(16) float tot[2 * N];  // cluster sums, pivot column
  __shared__ float ttc[B * B];                // Tt (CTA 0), column c: thread c
  __shared__ float zbuf[2][B];                // z of a step (CTA 0), ping-pong
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (blockIdx.y > 0) {  // a copying cluster: St -> St_out, Vt = 0
    const long n = (long)b * lo;
    const long step = (long)(gridDim.y - 1) * gridDim.x * CNT;
    for (long e = ((long)(blockIdx.y - 1) * gridDim.x + blockIdx.x) * CNT +
                  tid;
         e < n; e += step) {
      const long r = e / lo;
      const long i = r * m + (e - r * lo);
      s_out[i] = s_in[i];
      vt[i] = 0.f;
    }
    return;
  }

  const uint32_t rank = cluster_ctarank();
  const int C = gridDim.x;
  float s[LPT][B];
  float v[LPT][B];
  int ln[LPT];
  bool ok[LPT];
#pragma unroll
  for (int q = 0; q < LPT; ++q) {
    ln[q] = lo + (int)rank * CL + q * CNT + tid;
    ok[q] = ln[q] < m;
#pragma unroll
    for (int r = 0; r < B; ++r) {
      s[q][r] = (r < b && ok[q]) ? s_in[(long)r * m + ln[q]] : 0.f;
      v[q][r] = 0.f;
    }
  }
  if (rank == 0)
    for (int i = tid; i < B * B; i += CNT) ttc[i] = 0.f;
  if (tid == 0) {
    mbar_init(smem_addr(&mbar[0]), 1);
    mbar_init(smem_addr(&mbar[1]), 1);
  }
  cluster_sync();  // every CTA runs, its barriers set, before any push

  QR_CLOCKS_INIT
  int pending = -1;  // the step whose Tt row CTA 0 has yet to form
  for (int j = 0; j < b; ++j) {
    const int jg = k + j;
    const int par = j & 1;
    const int owner = jg < m ? (jg - lo) / CL : -1;  // CTA of lane jg
    QR_TICK(0)

    // 1. x = row j on lanes >= jg; the pivot lane's owner posts its columns
    float x[LPT];
#pragma unroll
    for (int q = 0; q < LPT; ++q) {
      float xj = 0.f;
#pragma unroll
      for (int r = 0; r < B; ++r) xj = r == j ? s[q][r] : xj;
      x[q] = (ok[q] && ln[q] >= jg) ? xj : 0.f;
      if (ok[q] && ln[q] == jg) {
        float4* piv = reinterpret_cast<float4*>(pivl);
#pragma unroll
        for (int r = 0; r < B; r += 4) {
          piv[r / 4] = make_float4(s[q][r], s[q][r + 1], s[q][r + 2],
                                   s[q][r + 3]);
          piv[(B + r) / 4] = make_float4(v[q][r], v[q][r + 1], v[q][r + 2],
                                         v[q][r + 3]);
        }
      }
    }

    QR_TICK(1)
    // 2. partial dots, summed over the warp (the first fold computes them)
    float a[B];
    {
      const bool up = lane & 16;
#pragma unroll
      for (int i = 0; i < B; ++i) {
        float ps = 0.f, pv = 0.f;
#pragma unroll
        for (int q = 0; q < LPT; ++q) {
          ps = fmaf(s[q][i], x[q], ps);
          pv = fmaf(v[q][i], x[q], pv);
        }
        const float send = up ? ps : pv;
        const float keep = up ? pv : ps;
        a[i] = keep + __shfl_xor_sync(FULL, send, 16);
      }
    }
    QR_TICK(2)
    fold<B / 2>(a, 8, lane);
    fold<B / 4>(a, 4, lane);
    fold<B / 8>(a, 2, lane);
    fold<B / 16>(a, 1, lane);
#pragma unroll
    for (int i = 0; i < NPL; ++i) red[warp][lane * NPL + i] = a[i];
    QR_TICK(3)
    __syncthreads();
    QR_TICK(4)

    // 3. the block's partial of each dot, pushed into every CTA of the
    // cluster (itself too) with the pivot lane's columns; each CTA then sums
    // the C partials in rank order, so the sums are bitwise equal in all
    const uint32_t bar = smem_addr(&mbar[par]);
    if (tid == 0)
      mbar_expect_tx(bar, 4u * N * (C + (owner >= 0 ? 1 : 0)));
    if (tid < N / 4) {
      const float4* r4 = reinterpret_cast<const float4*>(red[0]);
      float4 t = r4[tid];
#pragma unroll
      for (int w = 1; w < CWARPS; ++w) {
        const float4 u = r4[w * (N / 4) + tid];
        t.x += u.x;
        t.y += u.y;
        t.z += u.z;
        t.w += u.w;
      }
      const uint32_t dst = smem_addr(&recv[par][rank][4 * tid]);
      for (int c = 0; c < C; ++c) st_async(map_rank(dst, c), t,
                                           map_rank(bar, c));
    } else if (tid < N / 2 && owner == (int)rank) {
      const int i = tid - N / 4;
      const float4 t = reinterpret_cast<const float4*>(pivl)[i];
      const uint32_t dst = smem_addr(&rpiv[par][4 * i]);
      for (int c = 0; c < C; ++c) st_async(map_rank(dst, c), t,
                                           map_rank(bar, c));
    }
    QR_TICK(5)
    if (rank == 0 && tid <= pending)  // in the shadow of the pushes
      tt_row<B>(ttc, zbuf[pending & 1], pending, tid);
    pending = -1;
    mbar_wait(bar, (j >> 1) & 1);
#ifdef QR_STEP_BARRIER
    cluster_sync();
#endif
    QR_TICK(6)
    if (tid < N) {
      float t = 0.f;
#pragma unroll
      for (int c = 0; c < MAX_CLUSTER; ++c)
        if (c < C) t += recv[par][c][tid];
      tot[tid] = t;
    } else if (tid < 2 * N) {
      tot[tid] = owner >= 0 ? rpiv[par][tid - N] : 0.f;
    }
    QR_TICK(7)
    __syncthreads();
    QR_TICK(8)

    // 4. the reflector's scalars; a skipped step (also NaN) leaves S, Vt
    // and Tt exactly as they are
    const float nrm2 = tot[j];
    const float nrm = sqrtf(nrm2);
    if (!(nrm >= eps)) continue;
    const float x0 = tot[N + j];
    const float alpha = x0 >= 0.f ? nrm : -nrm;
    const float wn2 = nrm2 + 2.f * alpha * x0 + alpha * alpha;
    const float inv = rsqrtf(wn2 == 0.f ? 1.f : wn2);

    QR_TICK(9)
    // 5. S -= 2 y w^T and Vt[j] = w on this thread's lanes
    float w[LPT];
#pragma unroll
    for (int q = 0; q < LPT; ++q)
      w[q] = (x[q] + (ln[q] == jg ? alpha : 0.f)) * inv;
    const float4* t4 = reinterpret_cast<const float4*>(tot);
#pragma unroll
    for (int r4 = 0; r4 < B / 4; ++r4) {
      const float4 dot = t4[r4];
      const float4 piv = t4[N / 4 + r4];
      const float c[4] = {-2.f * inv * fmaf(alpha, piv.x, dot.x),
                          -2.f * inv * fmaf(alpha, piv.y, dot.y),
                          -2.f * inv * fmaf(alpha, piv.z, dot.z),
                          -2.f * inv * fmaf(alpha, piv.w, dot.w)};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * r4 + i;
#pragma unroll
        for (int q = 0; q < LPT; ++q) {
          s[q][r] = fmaf(c[i], w[q], s[q][r]);
          v[q][r] = r == j ? w[q] : v[q][r];
        }
      }
    }

    QR_TICK(10)
    // 6. z_i = Vt_i . w for Tt's row j, which CTA 0 forms while it waits
    // at the next step's cluster barrier (or after the sweep)
    if (rank == 0 && tid < j)
      zbuf[j & 1][tid] = inv * fmaf(alpha, tot[N + B + tid], tot[B + tid]);
    pending = j;
  }

  // the last step's z, written by threads i < j, is read by every thread
  // c <= j: inside the sweep the next step's block barrier orders them
  __syncthreads();
  if (rank == 0 && tid <= pending) tt_row<B>(ttc, zbuf[pending & 1], pending,
                                          tid);
  QR_CLOCKS_STORE
  cluster_sync();  // no CTA leaves while pushes to it may be in flight
#pragma unroll
  for (int q = 0; q < LPT; ++q) {
    if (!ok[q]) continue;
#pragma unroll
    for (int r = 0; r < B; ++r) {
      if (r < b) {
        s_out[(long)r * m + ln[q]] = s[q][r];
        vt[(long)r * m + ln[q]] = v[q][r];
      }
    }
  }
  if (rank == 0)
    for (int i = tid; i < b * b; i += CNT) tt[i] = ttc[(i / b) * B + i % b];
}

typedef void (*ClusterKernel)(const float*, float*, float*, float*, int, int,
                              int, int, float);

// Lanes a CTA of the cluster kernel sweeps for b rows and `lpt` lanes a
// thread; 0 for a combination it was not built for.
int cluster_cta_lanes(int b, int lpt) {
  if (b < 1 || b > 64) return 0;
  if (lpt == 1 || (lpt == 2 && b <= 32)) return CNT * lpt;
  return 0;
}

}  // namespace

#ifdef QR_STEP_CLOCKS
// The last cluster launch's phase sums (2 x 16) into `out` (host memory).
extern "C" int qr_step_clocks(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, qr_step_clock_sums,
                                   sizeof(qr_step_clock_sums));
}
#endif

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

// The cluster kernel over C CTAs of `lpt` lanes a thread. Returns 0 on
// success, -1 for arguments it does not take (C CTAs must cover the live
// lanes m - (k & ~3)), -2 when no cluster of C CTAs can be scheduled (the
// first launch of each kernel and C asks cudaOccupancyMaxActiveClusters),
// else the cudaError_t of the launch.
extern "C" int qr_cluster_launch(const void* s_in, void* s_out, void* vt,
                                 void* tt, int b, int m, int k, float eps,
                                 int C, int lpt, void* stream) {
  const int cl = cluster_cta_lanes(b, lpt);
  if (!cl || m < 1 || m > MAX_M || k < 0 || C < 1 || C > MAX_CLUSTER)
    return -1;
  const int lo = (k & ~3) < m ? (k & ~3) : m;
  const int live = m - lo;
  // the C CTAs cover the live lanes, and each holds some (C 1 holds none
  // when there are none)
  if ((long)C * cl < live || (long)(C - 1) * cl >= (live > 0 ? live : 1))
    return -1;
  static const ClusterKernel kernels[3] = {&qr_cluster_kernel<32, 1>,
                                           &qr_cluster_kernel<32, 2>,
                                           &qr_cluster_kernel<64, 1>};
  static bool schedulable[3][MAX_CLUSTER + 1];
  const int which = b > 32 ? 2 : lpt - 1;
  const ClusterKernel kern = kernels[which];
  const long dead = (long)b * lo;
  const long per_cluster = (long)C * COPY_PER_CTA;
  const int copies = (int)((dead + per_cluster - 1) / per_cluster);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1 + copies, 1);
  cfg.blockDim = dim3(CNT, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (!schedulable[which][C]) {
    // clusters past 8 CTAs are non-portable; the attribute stays set for
    // every later launch of this kernel, whatever its C
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return -2;
    schedulable[which][C] = true;
  }
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const float*>(s_in), static_cast<float*>(s_out),
      static_cast<float*>(vt), static_cast<float*>(tt), b, m, k, lo, eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
