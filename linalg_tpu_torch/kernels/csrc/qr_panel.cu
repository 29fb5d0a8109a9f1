// Householder reflector sweep over a transposed QR panel strip, for Hopper
// (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU kernels of linalg_tpu/ops/pallas/qr_panel.py:
// factor_strip (qr_panel.py:143, _strip_kernel, the unrolled sweep that
// householder_qr_pallas runs on every 32-wide strip) and factor_panel
// (qr_panel.py:173, _panel_kernel, the same contract for any width through
// a fori_loop and masked selects). The unrolling and the masked selects are
// TPU indexing workarounds; the kernels here take any b up to MAX_B.
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
// of shared memory and 256 KB of registers -- so both kernels spread the
// live lanes [lo, m), lo = k & ~3, over many SMs, each CTA owning a
// contiguous range of them, and exchange one reduction a step. The TPU
// kept the strip in VMEM.
//
// The dot products fold into one reduction a step: with x = row j on
// lanes >= jg = k + j,
//   S_r . w = inv (S_r . x + alpha S_r[jg]),  Vt_i . w = inv (Vt_i . x +
//   alpha Vt_i[jg]),
// and S_j . x = nrm^2, S_j[jg] = x0. So each CTA forms the partial dots
// S_r . x and Vt_i . x of its lanes, the CTA owning lane jg publishes its S
// and Vt columns beside them, and each sum of the partials is formed in one
// fixed order, so nrm, alpha, inv, y and z are bitwise equal in every CTA
// and the exact-skip test is unanimous. z rides in the step's reduction,
// so Tt's recurrence runs as the steps go, in the shadow of the next
// step's exchange; a Gram V V^T at the end would add a reduction of b^2
// values and the whole recurrence after the last step. Lanes left of lo
// are only copied (St) and zeroed (Vt). A step is latency-bound: a few
// thousand cycles of exchange round trip and local work, against bytes
// and operations worth a few hundred.
//
// Two kernels; the wrapper (kernels/qr_panel.py) picks one by shape alone.
//
// qr_cluster_kernel (b <= 64 and at most 16 CTAs of live lanes): one
// thread-block cluster per strip, the strip held in registers. CTA r of
// the C in the cluster owns the contiguous live lanes [lo + r CL, lo + (r
// + 1) CL), CL = 256 LPT; thread t owns LPT of them and keeps each lane's
// column of S and of Vt (b values each) in registers, so a step's rank-1
// update is register-local and a strip's device-memory traffic is its
// bytes read once and written once. Each thread forms the 2B partial dots
// of its lanes (B = 32 or 64 rows, zero past b), the warp sums them
// transposed (2B - 1 shuffles, each lane ending with 2B / 32 sums), the
// block's warps through shared memory, and each CTA pushes its block
// partials into every CTA of the cluster (itself too) with st.async,
// counted in bytes on the receiver's mbarrier; the CTA owning lane jg
// pushes its S and Vt columns beside them. Each CTA then sums the C
// partials of each dot in rank order. Receive buffers and mbarriers
// ping-pong by step parity: a CTA can run at most one step ahead of
// another, since it needs every CTA's partials of a step to finish it. So
// no cluster barrier runs inside the sweep: on the H100 one more a step
// costs 0.4-0.6 us (tools/qr_step_clocks.py), about a quarter of a step.
// Tt's recurrence runs in CTA 0, thread c keeping column c in shared
// memory. Lanes left of lo are copied by clusters of their own beside the
// sweeping one (grid y > 0), so a late strip's dead lanes do not run
// through the sweeping CTAs. A step takes ~4,000 cycles at b 32 on the
// H100: about half the warp folds and the register update, half the
// push's round trip and the sums.
//
// qr_grid_kernel (everything else: K12's b 65-256, and strips of b <= 64
// with more live lanes than a cluster holds): G co-resident CTAs of 512
// threads, at most MAX_GRID = 128, one an SM, launched cooperatively so
// that none waits on a CTA that was never scheduled. CTA g owns the live
// lanes [lo + g L, lo + (g + 1) L) and keeps their columns of S and Vt in
// shared memory (row stride L + 1) where 2 b (L + 1) floats fit, else
// works on them in s_out and vt in device memory (only b >= 128 past m
// ~8192). A step: each of the 2b slots (S rows, then Vt rows < j) gets P
// neighbouring threads (P = 512 / 2b rounded down to a power of 2), each
// forming the partial dot over every P-th group of 4 lanes (a warp's 32
// loads then hit 32 banks at P 8), summed over the group by shuffles, no
// block barrier. The exchange is a reduce, then a gather, through L2 in
// 64-bit words that carry the float beside a tag of the launch's epoch
// and the step ((epoch << 9) | (j + 1)),
// written with st.relaxed.gpu and polled with ld.relaxed.gpu (never a
// stale L1 line), a value and its arrival in one load: no counter, fence
// or grid barrier. Each CTA writes its partial of each slot to the slot's
// reducer, CTA s mod G; the reducer's threads poll the G partials of a
// slot, one each, sum them by a shuffle tree in each warp and the warp
// sums in order, and write the slot's total; every CTA polls the totals
// and the pivot column, which the owner of lane jg writes beside its
// partials. One CTA forms each sum, so every CTA reads the same nrm,
// alpha, inv, y and z, and the exact-skip test is unanimous. Each CTA
// reads ~G + 2b words a step: a one-level exchange, every CTA reading all
// G partials of every slot, moved G times more through L2 and took 5.8 us
// a step at (32, 16384) against ~1.2 us of local work (PERF.md §6). A
// first level inside clusters of 8 CTAs (distributed shared memory, then
// a word a cluster through L2) did worse too: the H100 takes a cooperative
// launch in clusters (tools/probe_coop_cluster.py), but does not hold 16
// clusters of 8 of these CTAs at once, and at (128, 4096) G 64 it took
// 0.81 ms against this exchange's 0.64, every CTA reading 8 words a slot.
// Fusing the next step's dots into the update pass (S read once a step)
// did not pay either: 0.130 ms against 0.120 at (32, 16384), its scalar
// loop slower than the float4 dots and the warp-per-row update apart.
// The buffers ping-pong by step parity for the reason the cluster kernel's
// do: no CTA writes step j + 2's words before every CTA has read step
// j's. The buffer is the caller's and is kept from launch to launch: its
// first word holds the epoch (low half), which every CTA reads as it
// starts, and the count of CTAs done with the exchange (high half); the
// last of them advances the epoch, so no word of an earlier launch
// carries this launch's tags and no launch needs the buffer cleared (when
// the epoch's 23 bits wrap, that CTA zeroes the buffer). Tt's recurrence
// is spread over the CTAs by column (Tt[j, c] needs only column c of Tt
// and z, which every CTA has): CTA g forms its ceil(b / G) columns in its
// last warps, up to 32 threads a column, in shared memory where they fit
// (else in tt), in the shadow of the next step's exchange. A poll
// that has not seen its tag after ~2^32 cycles traps, so a protocol fault
// fails the launch instead of holding the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_B = 256;         // rows of St (panel width)
constexpr int MAX_M = 32768;       // lanes of St (matrix rows)

// ---- the cluster kernel ----

constexpr int CNT = 256;            // threads per CTA
constexpr int CWARPS = CNT / 32;    // 8
constexpr int MAX_CLUSTER = 16;     // CTAs per cluster (non-portable past 8)
constexpr int COPY_PER_CTA = 8192;  // dead-lane floats per copying CTA
constexpr unsigned FULL = 0xffffffffu;

// Step instrumentation of both kernels, compiled in only with
// -DQR_STEP_CLOCKS (tools/qr_step_clocks.py): thread 0 of CTA 0 and of the
// last CTA sum the cycles of each phase of a step, QR_TICK(n) closing phase
// n (0 only starts the clock), and store the sums in qr_step_clock_sums,
// row 0 for CTA 0 and row 1 for the last. -DQR_STEP_BARRIER adds one
// cluster barrier a step to the cluster kernel, so its cost can be timed.
#ifdef QR_STEP_CLOCKS
__device__ long long qr_step_clock_sums[2][16];
#define QR_CLOCKS_INIT \
  long long acc_[16] = {}; \
  long long last_ = 0;
#define QR_CLOCKED \
  (tid == 0 && (rank == 0 || (int)rank == (int)gridDim.x - 1))
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



// ---- the grid kernel ----

constexpr int GNT = 512;            // threads per CTA
constexpr int GWARPS = GNT / 32;    // 16
constexpr int MAX_GRID = 128;       // CTAs, one an SM
// dynamic shared memory a grid CTA may take: the H100's 232,448 bytes a
// block, less the 6,208 static bytes and a margin (kernels/qr_panel.py's
// GRID_SMEM)
constexpr size_t GRID_SMEM = 221184;
static_assert(2 * MAX_B <= GNT, "a thread for every slot");
// the exchange buffer in 64-bit words: the epoch and the finish count in
// the first of a 128-byte line of its own (the words after it keep their
// line alignment), then 2 parities x 2 MAX_B slots x (MAX_GRID partials,
// the total, the pivot entry) (kernels/qr_panel.py's WORK_WORDS)
constexpr long WORK_HEAD = 16;
constexpr long WORK_WORDS = WORK_HEAD + 2 * 2 * MAX_B * (MAX_GRID + 2);
constexpr unsigned EPOCHS = 1u << 23;  // the tag's high bits: j + 1 <= 256

// One exchange word: the float in the low half, the step's tag in the high
// half, stored and loaded whole (an aligned 64-bit access is single-copy
// atomic), at GPU scope so that it goes through L2.
__device__ __forceinline__ void put_word(unsigned long long* p, float v,
                                         unsigned tag) {
  const unsigned long long w =
      ((unsigned long long)tag << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(w)
               : "memory");
}

__device__ __forceinline__ unsigned long long get_word(
    const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
               : "=l"(w)
               : "l"(p)
               : "memory");
  return w;
}

__device__ __forceinline__ bool has_tag(unsigned long long w, unsigned tag) {
  return (unsigned)(w >> 32) == tag;
}

// The float of word p once it carries `tag`; w is a load of it already
// made. A word that has not arrived after ~2^32 cycles is a protocol
// fault: trap, so the launch fails instead of holding the card.
__device__ __forceinline__ float word_value(const unsigned long long* p,
                                            unsigned long long w,
                                            unsigned tag) {
  if (!has_tag(w, tag)) {
    const long long t0 = clock64();
    do {
      w = get_word(p);
      if (clock64() - t0 > (1ll << 32)) __trap();
    } while (!has_tag(w, tag));
  }
  return __uint_as_float((unsigned)w);
}

// Sum over the P (a power of 2) neighbouring lanes of a group: every lane
// of the group ends with the same, bitwise equal, sum.
__device__ __forceinline__ float group_sum(float v, int P) {
  for (int o = 1; o < P; o <<= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Tt[j, c] for the ncols columns from c0 that this CTA owns, tpc threads a
// column (a power of 2 dividing 32), the last ncols tpc threads of the CTA
// (u = their index among them): -2 sum_{c <= i < j} z_i Tt[i, c] (Tt is
// lower triangular), Tt[j, j] = 2. T holds the columns: T[i * ts + c -
// c0]. Every thread of the CTA calls it.
__device__ __forceinline__ void grid_tt_row(float* T, long ts, const float* z,
                                            int j, int c0, int ncols,
                                            int tpc, int u) {
  const int q = u / tpc;
  const int c = c0 + q;
  const bool mine = u >= 0 && q < ncols && c <= j;
  float acc = 0.f;
  if (mine)
    for (int i = c + u % tpc; i < j; i += tpc)
      acc = fmaf(z[i], T[i * ts + q], acc);
  acc = group_sum(acc, tpc);
  if (mine && u % tpc == 0) T[j * ts + q] = c < j ? -2.f * acc : 2.f;
}

// ONCHIP: S and Vt of the CTA's lanes in shared memory (row stride L + 1),
// else in s_out and vt (row stride m). t_smem: the CTA's Tt columns in
// shared memory, else in tt. work: the exchange buffer, the epoch and the
// finish count in its first line, then 2 parities x 2b slots x (G partials, the total, the
// pivot column's entry) words (WORK_WORDS at most).
template <bool ONCHIP>
__global__ void __launch_bounds__(GNT, 1)
qr_grid_kernel(const float* __restrict__ s_in, float* s_out, float* vt,
               float* tt, unsigned long long* work, int b, int m, int k,
               int lo, int L, int t_smem, float eps) {
  // dynamic: x of two steps (2 L), S and Vt (b (L + 1) each) when ONCHIP,
  // the Tt columns (b ncols) when t_smem
  extern __shared__ __align__(16) float gsm[];
  __shared__ float tot[2 * MAX_B];   // the step's sums, S rows then Vt rows
  __shared__ float pivc[2 * MAX_B];  // the pivot lane's S, Vt columns
  __shared__ float zbuf[2][MAX_B];   // z of a step, ping-pong
  __shared__ float wsum[GWARPS];     // warp sums of the slots reduced here
  __shared__ unsigned epoch;         // this launch's, from work[0]
  const int tid = threadIdx.x;
  unsigned* ctrl = reinterpret_cast<unsigned*>(work);  // epoch, done
  if (tid == 0) epoch = *reinterpret_cast<volatile unsigned*>(ctrl);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = gridDim.x;
  const unsigned rank = blockIdx.x;
  const int S2 = 2 * b;
  const int lane0 = lo + (int)rank * L;
  const int Lg = max(0, min(L, m - lane0));  // this CTA's lanes
  const long stride = ONCHIP ? L + 1 : m;
  float* S = ONCHIP ? gsm + 2 * L : s_out + lane0;
  float* V = ONCHIP ? gsm + 2 * L + (long)b * (L + 1) : vt + lane0;
  // Tt's columns [c0, c0 + ncols) are this CTA's
  const int per_cta = (b + G - 1) / G;
  const int c0 = min(b, (int)rank * per_cta);
  const int ncols = min(b, c0 + per_cta) - c0;
  float* T = t_smem ? gsm + 2 * L + (ONCHIP ? 2 * (long)b * (L + 1) : 0)
                    : tt + c0;
  const long ts = t_smem ? ncols : b;
  int tpc = 1;
  while (tpc < 32 && 2 * tpc * max(ncols, 1) <= GNT) tpc *= 2;
  // the last warps form Tt: the first ones reduce and gather the exchange
  const int tu = tid - (GNT - tpc * ncols);

  // dead lanes [0, lo): copied and zeroed by all CTAs
  const long dead = (long)b * lo;
  for (long e = (long)rank * GNT + tid; e < dead; e += (long)G * GNT) {
    const long r = e / lo;
    const long i = r * m + (e - r * lo);
    s_out[i] = s_in[i];
    vt[i] = 0.f;
  }
  for (int r = warp; r < b; r += GWARPS)
    for (int l = lane; l < Lg; l += 32) {
      S[r * stride + l] = s_in[(long)r * m + lane0 + l];
      V[r * stride + l] = 0.f;
    }
  for (int l = tid; l < Lg; l += GNT)
    gsm[l] = lane0 + l >= k ? s_in[lane0 + l] : 0.f;
  for (int e = tid; e < b * ncols; e += GNT)
    T[e / ncols * ts + e % ncols] = 0.f;

  // slot s < 2b: S row s, then Vt row s - b; P neighbouring threads a
  // slot (tid = slot P + part), each over every P-th group of 4 lanes
  int P = 1;
  while (2 * P * S2 <= GNT) P *= 2;
  const int slot = tid / P;
  const int part = tid % P;
  // this CTA reduces slots rank, rank + G, ...: Gw threads (G rounded up
  // to warps) a slot, np slots a pass
  const int Gw = (G + 31) & ~31;
  const int np = GNT / Gw;
  unsigned long long* partw = work + WORK_HEAD;           // [2][2b][G]
  unsigned long long* totw = partw + 2 * (long)S2 * G;    // [2][2b]
  unsigned long long* pivw = totw + 2 * S2;               // [2][2b]
  __syncthreads();

  QR_CLOCKS_INIT
  int pending = -1;  // the step whose Tt row has yet to be formed
  for (int j = 0; j < b; ++j) {
    const int jg = k + j;
    const int par = j & 1;
    const unsigned tag = (epoch << 9) | (j + 1);
    const int owner = jg < m ? (jg - lo) / L : -1;  // CTA of lane jg
    const int ns = b + j;  // slots in use: S rows, Vt rows < j
    const bool live = slot < ns;  // (slot < 2b: tid < P 2b)
    const float* x = gsm + par * L;
    QR_TICK(0)

    // 1. the partial dots of this CTA's lanes, summed over the slot's
    // threads; its word, and the owner of lane jg its columns
    float acc = 0.f;
    if (live) {
      const float* row =
          slot < b ? S + slot * stride : V + (slot - b) * stride;
      const int n4 = Lg >> 2;  // whole groups of 4 lanes
#pragma unroll 4
      for (int g = part; g < n4; g += P) {
        const float4 xv = reinterpret_cast<const float4*>(x)[g];
        acc = fmaf(row[4 * g], xv.x, acc);
        acc = fmaf(row[4 * g + 1], xv.y, acc);
        acc = fmaf(row[4 * g + 2], xv.z, acc);
        acc = fmaf(row[4 * g + 3], xv.w, acc);
      }
      if (part == 0)
        for (int l = 4 * n4; l < Lg; ++l) acc = fmaf(row[l], x[l], acc);
    }
    acc = group_sum(acc, P);
    if (live && part == 0)
      put_word(partw + ((long)par * S2 + slot) * G + rank, acc, tag);
    if (live && part == P - 1 && owner == (int)rank) {
      const int pl = jg - lane0;
      put_word(pivw + par * S2 + slot,
               slot < b ? S[slot * stride + pl] : V[(slot - b) * stride + pl],
               tag);
    }
    QR_TICK(1)

    // 2. the previous step's Tt row, in the shadow of the exchange
    if (pending >= 0)
      grid_tt_row(T, ts, zbuf[pending & 1], pending, c0, ncols, tpc, tu);
    pending = -1;
    QR_TICK(2)

    // 3. this CTA's slots: the G partials of each, one a thread, summed by
    // a shuffle tree in each warp and the warp sums in order; the total
    // goes out as the slot's word
    const int nmine = (int)rank < ns ? (ns - 1 - (int)rank) / G + 1 : 0;
    for (int q0 = 0; q0 < nmine; q0 += np) {
      const int q = q0 + tid / Gw;
      const int gi = tid % Gw;
      const unsigned long long* pw =
          partw + ((long)par * S2 + rank + (long)q * G) * G + gi;
      float v = 0.f;
      if (q < nmine && gi < G) v = word_value(pw, get_word(pw), tag);
      v = group_sum(v, 32);
      if (lane == 0) wsum[warp] = v;
      __syncthreads();
      if (tid < np && q0 + tid < nmine) {
        const int wps = Gw / 32;  // warps a slot
        float t = wsum[tid * wps];
        for (int w = 1; w < wps; ++w) t += wsum[tid * wps + w];
        put_word(totw + par * S2 + rank + (long)(q0 + tid) * G, t, tag);
      }
      if (q0 + np < nmine) __syncthreads();  // wsum is read
    }
    QR_TICK(3)

    // 4. every slot's total, and the pivot column
    if (tid < ns) {
      const unsigned long long* tw = totw + par * S2 + tid;
      const unsigned long long* vw = pivw + par * S2 + tid;
      const unsigned long long t0 = get_word(tw);
      const unsigned long long v0 = owner >= 0 ? get_word(vw) : 0ull;
      tot[tid] = word_value(tw, t0, tag);
      pivc[tid] = owner >= 0 ? word_value(vw, v0, tag) : 0.f;
    }
    __syncthreads();
    QR_TICK(4)

    // 5. the reflector's scalars; a skipped step (also NaN) leaves S, Vt
    // and Tt exactly as they are
    const float nrm2 = tot[j];
    const float nrm = sqrtf(nrm2);
    float* xn = gsm + (par ^ 1) * L;  // x of the next step
    if (!(nrm >= eps)) {
      if (j + 1 < b)
        for (int l = tid; l < Lg; l += GNT)
          xn[l] = lane0 + l > jg ? S[(j + 1) * stride + l] : 0.f;
      __syncthreads();
      continue;
    }
    const float x0 = pivc[j];
    const float alpha = x0 >= 0.f ? nrm : -nrm;
    const float wn2 = nrm2 + 2.f * alpha * x0 + alpha * alpha;
    const float inv = rsqrtf(wn2 == 0.f ? 1.f : wn2);
    if (tid >= b && tid < ns)
      zbuf[par][tid - b] = inv * fmaf(alpha, pivc[tid], tot[tid]);
    pending = j;

    // 6. S -= 2 y w^T and Vt[j] = w on this CTA's lanes; x of the next
    // step from the updated row j + 1
    const int pl = jg - lane0;
    for (int r = warp; r < b; r += GWARPS) {
      const float c = -2.f * inv * fmaf(alpha, pivc[r], tot[r]);
      float* Sr = S + r * stride;
      for (int l = lane; l < Lg; l += 32) {
        const float wl = (x[l] + (l == pl ? alpha : 0.f)) * inv;
        const float v = fmaf(c, wl, Sr[l]);
        Sr[l] = v;
        if (r == j) V[j * stride + l] = wl;
        if (r == j + 1) xn[l] = l > pl ? v : 0.f;
      }
    }
    __syncthreads();
    QR_TICK(5)
  }

  // this CTA is done with the exchange (its last polls came before the
  // last step's barrier), and every CTA read the epoch before any CTA
  // passed step 0 (it needs all G partials): count it done; the count's
  // value is read at the end, so the atomic's round trip overlaps the rest
  unsigned done = 0;
  if (tid == 0) done = atomicAdd(ctrl + 1, 1u);

  // the last step's z is ordered before this by the step's final barrier
  if (pending >= 0)
    grid_tt_row(T, ts, zbuf[pending & 1], pending, c0, ncols, tpc, tu);
  QR_CLOCKS_STORE
  if (ONCHIP)
    for (int r = warp; r < b; r += GWARPS)
      for (int l = lane; l < Lg; l += 32) {
        s_out[(long)r * m + lane0 + l] = S[r * stride + l];
        vt[(long)r * m + lane0 + l] = V[r * stride + l];
      }
  if (t_smem) {
    __syncthreads();  // the last Tt row
    for (int e = tid; e < b * ncols; e += GNT)
      tt[(long)(e / ncols) * b + c0 + e % ncols] = T[e];
  }

  // the last CTA done with the exchange advances the epoch and resets the
  // count; where the epoch wraps, no word may keep a tag of epoch 0 (the
  // zeroing, by one thread, comes once in 2^23 launches)
  if (tid == 0 && done == (unsigned)G - 1) {
    const unsigned next = epoch + 1 < EPOCHS ? epoch + 1 : 0;
    if (next == 0)
      for (long e = WORK_HEAD; e < WORK_WORDS; ++e) work[e] = 0ull;
    work[0] = next;  // the count (high half) back to 0
  }
}

// Dynamic shared memory of the grid kernel: x of two steps, the S and Vt
// columns of L lanes when they are on chip, and, when t_smem, the CTA's
// ncols columns of Tt.
size_t grid_smem(int b, int L, bool on_chip, int ncols) {
  return sizeof(float) * (2 * (size_t)L +
                          (on_chip ? 2 * (size_t)b * (L + 1) : 0) +
                          (size_t)b * ncols);
}

}  // namespace

#ifdef QR_STEP_CLOCKS
// The last launch's phase sums (2 x 16) into `out` (host memory).
extern "C" int qr_step_clocks(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, qr_step_clock_sums,
                                   sizeof(qr_step_clock_sums));
}
#endif

// The grid kernel over G co-resident CTAs of L lanes each (a multiple of
// 4), S and Vt on chip or in s_out and vt. `work`: WORK_WORDS 64-bit
// words, zeroed before the first launch that uses them and then left to
// the kernel; launches that share it must not overlap. Returns 0 on success, -1 for arguments it does not take
// (the G CTAs must cover the live lanes m - (k & ~3), each holding some;
// S and Vt on chip must fit in GRID_SMEM),
// -2 when G CTAs cannot all be resident at once on this device, else the
// cudaError_t of the launch (a refused cooperative launch included).
extern "C" int qr_grid_launch(const void* s_in, void* s_out, void* vt,
                              void* tt, void* work, int b, int m, int k,
                              float eps, int G, int L, int on_chip,
                              void* stream) {
  if (b < 1 || b > MAX_B || m < 1 || m > MAX_M || k < 0 || G < 1 ||
      G > MAX_GRID || L < 4 || L % 4 || L > MAX_M)
    return -1;
  const int lo = (k & ~3) < m ? (k & ~3) : m;
  const int live = m - lo;
  if ((long)G * L < live || (long)(G - 1) * L >= (live > 0 ? live : 1))
    return -1;
  typedef void (*GridKernel)(const float*, float*, float*, float*,
                             unsigned long long*, int, int, int, int, int,
                             int, float);
  const GridKernel kern =
      on_chip ? &qr_grid_kernel<true> : &qr_grid_kernel<false>;
  // the CTA's Tt columns in shared memory where they fit beside the rest
  const int ncols = (b + G - 1) / G;
  const bool t_smem = grid_smem(b, L, on_chip, ncols) <= GRID_SMEM;
  const size_t smem = grid_smem(b, L, on_chip, t_smem ? ncols : 0);
  if (smem > GRID_SMEM) return -1;
  static size_t smem_set[2] = {48 * 1024, 48 * 1024};
  if (smem > smem_set[on_chip ? 1 : 0]) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[on_chip ? 1 : 0] = smem;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, GNT,
                                                        smem);
  if (err != cudaSuccess) return (int)err;
  if ((long)per_sm * sms < G) return -2;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G, 1, 1);
  cfg.blockDim = dim3(GNT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const float*>(s_in), static_cast<float*>(s_out),
      static_cast<float*>(vt), static_cast<float*>(tt),
      static_cast<unsigned long long*>(work), b, m, k, lo, L, (int)t_smem,
      eps);
  if (err != cudaSuccess) return (int)err;
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
