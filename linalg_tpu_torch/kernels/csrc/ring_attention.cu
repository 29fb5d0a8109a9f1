// Ring attention for Hopper (sm_90a), plain C interface: every step of the
// ring in one launch, the running state in registers, the K/V chunks read
// where they lie.
//
// Replaces the Pallas TPU kernels of
//   linalg_tpu/parallel/ring_pallas.py:209  ring_attention_pallas_local (K10,
//                                           body _ring_kernel :92)
//   linalg_tpu/parallel/ring_pallas.py:439  ring_attention_pallas_bwd_local
//                                           (K11, body _ring_bwd_kernel :313)
//
// Sequence parallelism over a ring of n ranks: rank r holds the query rows
// [r Tl, (r + 1) Tl) of a sequence of T = n Tl, and over n steps each K/V
// chunk passes every rank once. On the TPU one kernel per device loops over
// the n steps, keeps its running state in VMEM and moves the chunks with
// remote DMAs. Here a block reads chunk src where it lies, through a
// table of per-rank base pointers (Tab): views of rank-stacked (BH, T, D)
// tensors on one card, one (BH, Tl, D) tensor per rank, a peer card's
// memory, or another process's arena opened through CUDA IPC (the entry
// points at the end of this file), which stand in for the remote DMA. No
// chunk is copied between ranks.
// Each block loops over the ring's steps itself, in the ring's order, so
// the sums are taken in the order the TPU takes them:
//
//   forward (K10)  fwd: one block per (row tile, bh, rank r) folds chunk
//                  src = (r - s) mod n at step s = 0..n-1 into its online
//                  softmax (f32 m, l and O accumulator in registers for the
//                  whole ring) and writes O = acc / l in the io dtype and
//                  L = m + log l (f32) once.
//   backward (K11) dq: one block per (row tile, bh, rank r), the same walk:
//                  P = exp(S - L), dP = dO V^T, dS = (dP - delta) P,
//                  dq += dS K in f32 registers, written once, scaled.
//                  dkdv: one block per (key tile, bh, chunk c): at step s
//                  the chunk's keys gain rank (c + s) mod n's share,
//                  dv += P^T dO and dk += scale dS^T Q, the TPU bundle's lap
//                  (ring_pallas.py:375) without the bundle; written once.
//
// Every output row is owned by one block: no atomics, and two runs give the
// same bits. delta = rowsum(dO * O) is one f32 pass the caller makes, as the
// TPU wrapper does (ring_pallas.py:561). `r0` and the grid's z extent pick a
// range of ranks (chunks for dk/dv): one launch a card covers the ranks
// whose outputs lie there, and the caller orders it after every source
// card's writes (events).
//
// Masks use global positions, row = r Tl + i and col = src Tl + j: causal
// (col <= row), the sliding-window band (col > row - window) and the ALiBi
// bias slope_h (col - row) added to the scaled scores, as _ring_kernel does.
// _chunk_live (ring_pallas.py:74) decides per (rank, chunk) whether the
// chunk can hold a visible key; a dead one is skipped. Inside a live chunk
// a block walks only the tiles that hold a visible entry (key tiles for
// query rows, query tiles for keys). Tl needs no relation to the tile size:
// keys and queries at j >= Tl are banned, and tile rows past Tl are
// zero-filled by the copy, never read. Banned scores are -inf and give
// exactly 0; a row that has seen nothing yet keeps m = -inf (alpha 1, p 0);
// the l == 0 guard of the TPU kernel stays. Tiles wholly inside the band
// skip the element-wise test.
//
// Two paths, one contract:
//   bf16  tensor cores, mma.sync m16n8k16 (bf16 operands, f32 accumulate),
//         4 warps x 16 rows of a 64-row tile; the helpers are
//         mma_bf16.cuh's, shared with flash_attention.cu. Q K^T and dO V^T
//         are exact products of bf16 values. P and dS are f32, as in the
//         TPU kernel (`jnp.dot(p, v)` with f32 p, ring_pallas.py:184-185,
//         :397-408): each is split into hi = bf16(x) and lo = bf16(x - hi)
//         and multiplied twice (hi B + lo B), which keeps ~16 bits of it.
//         Every operand tile is row-major in shared memory as it lies in
//         device memory (rows padded by 8 elements); the products that
//         contract over its rows read it transposed with ldmatrix.trans.
//   f32   f32 FMA on the CUDA cores, never TF32: 256 threads as a 16 x 16
//         grid, thread (ty, tx) owns score entries (ty + 16 i, tx + 16 j)
//         and output entries (ty + 16 i, tx + 16 c); rows padded by one
//         float. 64-row tiles, 32 at d 256 to fit shared memory.
// Both stage their tiles with cp.async (16-byte copies for bf16, 4-byte for
// the padded f32 rows; zero fill past Tl) into a two-stage ring of
// shared-memory tiles: the next tile's copy runs while this one computes,
// across step boundaries too.
//
// What bounds it on this card: at long_window's shape (B 8, h 4, T 4096,
// d 128, n 4, window 512) the band leaves 62.9M visible pairs, 4 d flops
// each forward and 8 d backward: tens of microseconds of bf16 tensor-core
// time against ~40-70 us of q/k/v/o traffic. Neither decides: the hi/lo
// split issues 3 products per score tile forward and 8 backward where one
// rounding would issue 2 and 5, mma.sync reaches about two thirds of
// wgmma's rate, and each warp runs its products, softmax and products in
// series, with 128-thread blocks of 52-203 KB of shared memory and
// 118-242 registers leaving few warps an SM to hide that.
//
// Layouts (all contiguous, elements): q, k, v, dO, o, dq, dk, dv: (BH, T,
// D) rank-stacked or (BH, Tl, D) a rank, in the io dtype; L, delta: (BH, T)
// or (BH, Tl) f32. D is the padded head width
// (32, 64, 128, 256): zero columns add nothing to q.k and give zero output
// columns, and `scale` is 1 / sqrt(true d).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BM = 64;   // bf16: rows a block owns (queries; keys in dk/dv)
constexpr int BN = 64;   // bf16: keys per tile of the forward and dq walks
constexpr int MT = 128;  // bf16 threads: 4 warps x 16 rows
constexpr int NT = 256;  // f32 threads: a 16 x 16 grid

struct Ring {
  int BH, H, n, Tl, r0, causal, window;
  float scale;
  const float* slopes;  // (H,) ALiBi slopes, or null
};

// The per-rank chunk tables: rank x's rows of each tensor start at
// in[kind][x] (out[kind][x]), and head bh's rows at hs * bh rows further.
// Rank-stacked tensors give base + x Tl rows and hs = T; one tensor per
// rank gives its own base and hs = Tl. A pointer may be a peer card's, or
// a slot of another process's arena (hs = Tl).
// The table is a __grid_constant__ kernel parameter: indexed at run time
// in place, never copied to local memory.
constexpr int MAX_RANKS = 32;
enum { IQ, IK, IV, IDO, IL, IDL, N_IN };
enum { O0, O1, O2, N_OUT };  // o, L (forward); dq, dk, dv (backward)
struct Tab {
  const void* in[N_IN][MAX_RANKS];
  void* out[N_OUT][MAX_RANKS];
  long long hs;
};

// Head bh of rank x's chunk of table entry `kind` (rows of W elements of
// type T); in_row: its row `row`. A block takes its own rank's heads once,
// restrict-qualified (read or written through no other pointer), and
// looks up the chunks of the others as its walk reaches them.
template <typename T, int W>
__device__ __forceinline__ const T* in_head(const Tab& tb, int kind, int x,
                                            int bh) {
  return static_cast<const T*>(tb.in[kind][x]) + (size_t)bh * tb.hs * W;
}
template <typename T, int W>
__device__ __forceinline__ T* out_head(const Tab& tb, int kind, int x,
                                       int bh) {
  return static_cast<T*>(tb.out[kind][x]) + (size_t)bh * tb.hs * W;
}
template <typename T, int W>
__device__ __forceinline__ const T* in_row(const Tab& tb, int kind, int x,
                                           int bh, int row) {
  return in_head<T, W>(tb, kind, x, bh) + (size_t)row * W;
}

__device__ __forceinline__ float slope_of(const Ring& a, int bh) {
  return a.slopes ? a.slopes[bh % a.H] : 0.f;
}

// _chunk_live: whether the chunk of rank src can hold a key visible to
// rank r. Causal: not in the future. Window: its newest key is less than
// window - 1 behind r's oldest row, (r - src - 1) Tl < window - 1.
__device__ __forceinline__ bool chunk_live(const Ring& a, int src, int r) {
  if (!a.causal) return true;
  if (src > r) return false;
  return a.window <= 0 || (long long)(r - src - 1) * a.Tl < a.window - 1;
}

// The scaled, biased score of query `row` and key `col` (global
// positions). In a `masked` tile it is -inf where the pair is banned or
// `in` is false (a row or key past Tl); other tiles hold no banned pair.
__device__ __forceinline__ float score(float dot, const Ring& a, float slope,
                                       int row, int col, bool masked,
                                       bool in) {
  if (masked && (!in || (a.causal && col > row) ||
                 (a.window > 0 && row - col >= a.window)))
    return -INFINITY;
  return dot * a.scale + slope * (float)(col - row);
}

// Whether a tile of rows [row0, row0 + R) and keys [col0, col0 + C) can hold
// a banned pair: it crosses the diagonal or the band's lower edge, or runs
// past Tl (`full` false).
__device__ __forceinline__ bool edge(const Ring& a, int row0, int R,
                                     int col0, int C, bool full) {
  return !full || (a.causal && col0 + C - 1 > row0) ||
         (a.window > 0 && row0 + R - 1 - col0 >= a.window);
}

// The tiles a block visits, in the ring's order. KeyWalk: query rows
// [row0, row1] of rank r; at step s the chunk src = (r - s) mod n, if
// live, key tiles [t, t1) of width B that hold a key visible to a row.
struct KeyWalk {
  Ring a;
  int r, row0, row1, B;
  int s, src, t, t1;

  __device__ bool seek() {
    for (; s < a.n; ++s) {
      src = (r - s + a.n) % a.n;
      if (!chunk_live(a, src, r)) continue;
      const int c0 = src * a.Tl;
      int jlo = 0, jhi = a.Tl - 1;
      if (a.window > 0) jlo = max(jlo, row0 - a.window + 1 - c0);
      if (a.causal) jhi = min(jhi, row1 - c0);
      if (jhi < jlo) continue;
      t = jlo / B;
      t1 = jhi / B + 1;
      return true;
    }
    return false;
  }
  __device__ bool start() {
    s = 0;
    return seek();
  }
  __device__ bool next() {
    if (++t < t1) return true;
    ++s;
    return seek();
  }
};

// QueryWalk: keys [col0, col1] of chunk c; at step s the rank r = (c + s)
// mod n, if c is live for it, query tiles [t, t1) of width B that see one.
struct QueryWalk {
  Ring a;
  int c, col0, col1, B;
  int s, r, t, t1;

  __device__ bool seek() {
    for (; s < a.n; ++s) {
      r = (c + s) % a.n;
      if (!chunk_live(a, c, r)) continue;
      const int r0 = r * a.Tl;
      int ilo = 0, ihi = a.Tl - 1;
      if (a.causal) ilo = max(ilo, col0 - r0);
      if (a.window > 0) ihi = min(ihi, col1 + a.window - 1 - r0);
      if (ihi < ilo) continue;
      t = ilo / B;
      t1 = ihi / B + 1;
      return true;
    }
    return false;
  }
  __device__ bool start() {
    s = 0;
    return seek();
  }
  __device__ bool next() {
    if (++t < t1) return true;
    ++s;
    return seek();
  }
};

// Rows [0, R) of a (rows, D) bf16 array into shared memory of row stride
// D + 8, one 16-byte cp.async per thread and step; rows at or past `valid`
// are zero-filled and not read.
template <int D, int R>
__device__ __forceinline__ void stage_bf16(bf16* dst,
                                           const bf16* __restrict__ src,
                                           int valid) {
  constexpr int V = D / 8;
  for (int i = threadIdx.x; i < R * V; i += MT) {
    const int r = i / V, c = (i % V) * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * (D + 8) + c, src + (ok ? (size_t)r * D + c : 0), ok);
  }
}

// The same for f32 rows into row stride D + 1, 4 bytes a copy.
template <int D, int R>
__device__ __forceinline__ void stage_f32(float* dst,
                                          const float* __restrict__ src,
                                          int valid) {
  for (int i = threadIdx.x; i < R * D; i += NT) {
    const int r = i / D, c = i % D;
    const bool ok = r < valid;
    cp_async4(dst + r * (D + 1) + c, src + (ok ? (size_t)r * D + c : 0), ok);
  }
}

// R floats (L or delta of a tile's rows), zero at or past `valid`.
template <int R>
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ src,
                                           int valid) {
  for (int i = threadIdx.x; i < R; i += MT)
    cp_async4(dst + i, src + (i < valid ? i : 0), i < valid);
}

// ===================== bf16: tensor-core tiles ==========================

// K10. Grid (row tiles of Tl, BH, ranks x D / DC column slices). A block
// accumulates the DC columns [c0, c0 + DC) of O; at d 256 two slices each
// recompute the scores, so the accumulator stays at 64 registers.
template <int D, int DC>
__global__ void __launch_bounds__(MT, 1)
    fwd_bf16(const __grid_constant__ Tab tb, const Ring a) {
  constexpr int RS = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BM * RS;      // two stages of BN rows
  bf16* Vs = Ks + 2 * BN * RS;  // two stages
  const int r = a.r0 + blockIdx.z / (D / DC), bh = blockIdx.y;
  const int c0 = (blockIdx.z % (D / DC)) * DC;
  const int i0 = blockIdx.x * BM;
  const int rows = min(BM, a.Tl - i0);
  const int row0 = r * a.Tl + i0;  // global row of the tile
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = (threadIdx.x >> 5) * 16;  // the warp's rows in the tile
  const float slope = slope_of(a, bh);
  const bf16* __restrict__ qh = in_head<bf16, D>(tb, IQ, r, bh);
  bf16* __restrict__ oh = out_head<bf16, D>(tb, O0, r, bh);
  float* __restrict__ Lo = out_head<float, 1>(tb, O1, r, bh);

  stage_bf16<D, BM>(Qs, qh + (size_t)i0 * D, rows);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DC / 8][4] = {};
  KeyWalk w{a, r, row0, row0 + rows - 1, BN};
  bool have = w.start();
  if (have) {
    stage_bf16<D, BN>(Ks, in_row<bf16, D>(tb, IK, w.src, bh, w.t * BN),
                      a.Tl - w.t * BN);
    stage_bf16<D, BN>(Vs, in_row<bf16, D>(tb, IV, w.src, bh, w.t * BN),
                      a.Tl - w.t * BN);
  }
  cp_async_commit();
  for (int buf = 0; have; buf ^= 1) {
    KeyWalk nx = w;
    const bool more = nx.next();
    if (more) {  // the next tile's copy flies while this one computes
      stage_bf16<D, BN>(Ks + (buf ^ 1) * BN * RS,
                        in_row<bf16, D>(tb, IK, nx.src, bh, nx.t * BN),
                        a.Tl - nx.t * BN);
      stage_bf16<D, BN>(Vs + (buf ^ 1) * BN * RS,
                        in_row<bf16, D>(tb, IV, nx.src, bh, nx.t * BN),
                        a.Tl - nx.t * BN);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Kt = Ks + buf * BN * RS;
    const bf16* Vt = Vs + buf * BN * RS;
    const int j0 = w.t * BN, col0 = w.src * a.Tl + j0;
    float s[BN / 8][4] = {};
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t qa[4];
      load_a(qa, Qs, RS, wr, kc * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        uint32_t b[2];
        load_b(b, Kt, RS, nt * 8, kc * 16, g, t);
        mma(s[nt], qa, b);
      }
    }
    const bool masked =
        edge(a, row0, BM, col0, BN, rows == BM && j0 + BN <= a.Tl);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int li = wr + g + 8 * (i >> 1), lj = 8 * nt + 2 * t + (i & 1);
        s[nt][i] = score(s[nt][i], a, slope, row0 + li, col0 + lj,
                         masked, li < rows && j0 + lj < a.Tl);
        mx[i >> 1] = fmaxf(mx[i >> 1], s[nt][i]);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
    bool none[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mn = fmaxf(m[h], quad_max(mx[h]));
      none[h] = mn == -INFINITY;  // nothing visible yet
      alpha[h] = none[h] ? 1.f : expf(m[h] - mn);
      m[h] = mn;
    }
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = none[i >> 1] ? 0.f : expf(s[nt][i] - m[i >> 1]);
        s[nt][i] = p;
        rs[i >> 1] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + quad_sum(rs[h]);
#pragma unroll
    for (int dn = 0; dn < DC / 8; ++dn)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[dn][i] *= alpha[i >> 1];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t hi[4], lo[4];
      acc_to_a_split(hi, lo, s, kk);
#pragma unroll
      for (int dn = 0; dn < DC / 16; ++dn) {
        uint32_t b0[2], b1[2];
        load_bt(b0, b1, Vt, RS, kk * 16, c0 + dn * 16, lane);
        mma(acc[2 * dn], hi, b0);
        mma(acc[2 * dn], lo, b0);
        mma(acc[2 * dn + 1], hi, b1);
        mma(acc[2 * dn + 1], lo, b1);
      }
    }
    __syncthreads();  // this stage's K and V are consumed
    w = nx;
    have = more;
  }
  cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int li = wr + g + 8 * h;
    if (li >= rows) continue;
    bf16* orow = oh + (size_t)(i0 + li) * D;
    const float denom = l[h] == 0.f ? 1.f : l[h];
    const float inv = 1.f / denom;
#pragma unroll
    for (int dn = 0; dn < DC / 8; ++dn)
      *reinterpret_cast<uint32_t*>(orow + c0 + dn * 8 + 2 * t) =
          pack(acc[dn][2 * h] * inv, acc[dn][2 * h + 1] * inv);
    if (t == 0 && c0 == 0)
      Lo[i0 + li] = m[h] + logf(denom);
  }
}

// K11's dq pass. Grid (row tiles of Tl, BH, ranks x D / DC column
// slices); dq's columns [c0, c0 + DC).
template <int D, int DC>
__global__ void __launch_bounds__(MT, 1)
    dq_bf16(const __grid_constant__ Tab tb, const Ring a) {
  constexpr int RS = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + BM * RS;
  bf16* Ks = dOs + BM * RS;     // two stages of BN rows
  bf16* Vs = Ks + 2 * BN * RS;  // two stages
  const int r = a.r0 + blockIdx.z / (D / DC), bh = blockIdx.y;
  const int c0 = (blockIdx.z % (D / DC)) * DC;
  const int i0 = blockIdx.x * BM;
  const int rows = min(BM, a.Tl - i0);
  const int row0 = r * a.Tl + i0;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = (threadIdx.x >> 5) * 16;
  const float slope = slope_of(a, bh);
  const bf16* __restrict__ qh = in_head<bf16, D>(tb, IQ, r, bh);
  const bf16* __restrict__ dOh = in_head<bf16, D>(tb, IDO, r, bh);
  const float* __restrict__ Lh = in_head<float, 1>(tb, IL, r, bh);
  const float* __restrict__ dlh = in_head<float, 1>(tb, IDL, r, bh);
  bf16* __restrict__ dqh = out_head<bf16, D>(tb, O0, r, bh);

  stage_bf16<D, BM>(Qs, qh + (size_t)i0 * D, rows);
  stage_bf16<D, BM>(dOs, dOh + (size_t)i0 * D, rows);
  float Lr[2], dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int li = wr + g + 8 * h;
    Lr[h] = li < rows ? Lh[i0 + li] : 0.f;
    dr[h] = li < rows ? dlh[i0 + li] : 0.f;
  }
  float acc[DC / 8][4] = {};
  KeyWalk w{a, r, row0, row0 + rows - 1, BN};
  bool have = w.start();
  if (have) {
    stage_bf16<D, BN>(Ks, in_row<bf16, D>(tb, IK, w.src, bh, w.t * BN),
                      a.Tl - w.t * BN);
    stage_bf16<D, BN>(Vs, in_row<bf16, D>(tb, IV, w.src, bh, w.t * BN),
                      a.Tl - w.t * BN);
  }
  cp_async_commit();
  for (int buf = 0; have; buf ^= 1) {
    KeyWalk nx = w;
    const bool more = nx.next();
    if (more) {
      stage_bf16<D, BN>(Ks + (buf ^ 1) * BN * RS,
                        in_row<bf16, D>(tb, IK, nx.src, bh, nx.t * BN),
                        a.Tl - nx.t * BN);
      stage_bf16<D, BN>(Vs + (buf ^ 1) * BN * RS,
                        in_row<bf16, D>(tb, IV, nx.src, bh, nx.t * BN),
                        a.Tl - nx.t * BN);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Kt = Ks + buf * BN * RS;
    const bf16* Vt = Vs + buf * BN * RS;
    const int j0 = w.t * BN, col0 = w.src * a.Tl + j0;
    float s[BN / 8][4] = {}, dp[BN / 8][4] = {};
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t qa[4], da[4];
      load_a(qa, Qs, RS, wr, kc * 16, g, t);
      load_a(da, dOs, RS, wr, kc * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        uint32_t b[2];
        load_b(b, Kt, RS, nt * 8, kc * 16, g, t);
        mma(s[nt], qa, b);
        load_b(b, Vt, RS, nt * 8, kc * 16, g, t);
        mma(dp[nt], da, b);
      }
    }
    const bool masked =
        edge(a, row0, BM, col0, BN, rows == BM && j0 + BN <= a.Tl);
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int li = wr + g + 8 * (i >> 1), lj = 8 * nt + 2 * t + (i & 1);
        const float x = score(s[nt][i], a, slope, row0 + li, col0 + lj,
                              masked, li < rows && j0 + lj < a.Tl);
        const float p = x == -INFINITY ? 0.f : expf(x - Lr[i >> 1]);
        s[nt][i] = (dp[nt][i] - dr[i >> 1]) * p;  // dS
      }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t hi[4], lo[4];
      acc_to_a_split(hi, lo, s, kk);
#pragma unroll
      for (int dn = 0; dn < DC / 16; ++dn) {
        uint32_t b0[2], b1[2];
        load_bt(b0, b1, Kt, RS, kk * 16, c0 + dn * 16, lane);
        mma(acc[2 * dn], hi, b0);
        mma(acc[2 * dn], lo, b0);
        mma(acc[2 * dn + 1], hi, b1);
        mma(acc[2 * dn + 1], lo, b1);
      }
    }
    __syncthreads();
    w = nx;
    have = more;
  }
  cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int li = wr + g + 8 * h;
    if (li >= rows) continue;
    bf16* dqrow = dqh + (size_t)(i0 + li) * D;
#pragma unroll
    for (int dn = 0; dn < DC / 8; ++dn)
      *reinterpret_cast<uint32_t*>(dqrow + c0 + dn * 8 + 2 * t) =
          pack(a.scale * acc[dn][2 * h], a.scale * acc[dn][2 * h + 1]);
  }
}

// K11's dk/dv pass. Grid (key tiles of Tl, BH, chunks x D / DC column
// slices); BQ queries per tile. Warp rows are keys, accumulator columns
// queries (the transposed scores S^T = K Q^T); a block accumulates the DC
// columns [c0, c0 + DC) of dk and dv, recomputing the scores per slice.
template <int D, int BQ, int DC>
__global__ void __launch_bounds__(MT, 1)
    dkdv_bf16(const __grid_constant__ Tab tb, const Ring a) {
  constexpr int RS = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BM * RS;
  bf16* Qs = Vs + BM * RS;       // two stages of BQ rows
  bf16* dOs = Qs + 2 * BQ * RS;  // two stages
  float* Ls = reinterpret_cast<float*>(dOs + 2 * BQ * RS);  // two stages
  float* Ds = Ls + 2 * BQ;                                  // two stages
  const int c = a.r0 + blockIdx.z / (D / DC);
  const int c0 = (blockIdx.z % (D / DC)) * DC;
  const int bh = blockIdx.y;
  const int j0 = blockIdx.x * BM;  // first local key of the tile
  const int cols = min(BM, a.Tl - j0);
  const int col0 = c * a.Tl + j0;  // its global position
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = (threadIdx.x >> 5) * 16;  // the warp's keys in the tile
  const float slope = slope_of(a, bh);
  const bf16* __restrict__ kh = in_head<bf16, D>(tb, IK, c, bh);
  const bf16* __restrict__ vh = in_head<bf16, D>(tb, IV, c, bh);
  bf16* __restrict__ dkh = out_head<bf16, D>(tb, O1, c, bh);
  bf16* __restrict__ dvh = out_head<bf16, D>(tb, O2, c, bh);

  stage_bf16<D, BM>(Ks, kh + (size_t)j0 * D, cols);
  stage_bf16<D, BM>(Vs, vh + (size_t)j0 * D, cols);
  float accv[DC / 8][4] = {}, acck[DC / 8][4] = {};
  QueryWalk w{a, c, col0, col0 + cols - 1, BQ};
  bool have = w.start();
  if (have) {
    const int at = w.t * BQ, valid = a.Tl - at;
    stage_bf16<D, BQ>(Qs, in_row<bf16, D>(tb, IQ, w.r, bh, at), valid);
    stage_bf16<D, BQ>(dOs, in_row<bf16, D>(tb, IDO, w.r, bh, at), valid);
    stage_rows<BQ>(Ls, in_row<float, 1>(tb, IL, w.r, bh, at), valid);
    stage_rows<BQ>(Ds, in_row<float, 1>(tb, IDL, w.r, bh, at), valid);
  }
  cp_async_commit();
  for (int buf = 0; have; buf ^= 1) {
    QueryWalk nx = w;
    const bool more = nx.next();
    if (more) {
      const int nb = buf ^ 1;
      const int at = nx.t * BQ, valid = a.Tl - at;
      stage_bf16<D, BQ>(Qs + nb * BQ * RS,
                        in_row<bf16, D>(tb, IQ, nx.r, bh, at), valid);
      stage_bf16<D, BQ>(dOs + nb * BQ * RS,
                        in_row<bf16, D>(tb, IDO, nx.r, bh, at), valid);
      stage_rows<BQ>(Ls + nb * BQ, in_row<float, 1>(tb, IL, nx.r, bh, at),
                     valid);
      stage_rows<BQ>(Ds + nb * BQ, in_row<float, 1>(tb, IDL, nx.r, bh, at),
                     valid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Qt = Qs + buf * BQ * RS;
    const bf16* dOt = dOs + buf * BQ * RS;
    const float* Lt = Ls + buf * BQ;
    const float* Dt = Ds + buf * BQ;
    const int i0 = w.t * BQ, row0 = w.r * a.Tl + i0;
    const int rows = min(BQ, a.Tl - i0);
    float st[BQ / 8][4] = {}, dpt[BQ / 8][4] = {};
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t ka[4], va[4];
      load_a(ka, Ks, RS, wr, kc * 16, g, t);
      load_a(va, Vs, RS, wr, kc * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
        uint32_t b[2];
        load_b(b, Qt, RS, nt * 8, kc * 16, g, t);
        mma(st[nt], ka, b);
        load_b(b, dOt, RS, nt * 8, kc * 16, g, t);
        mma(dpt[nt], va, b);
      }
    }
    const bool masked =
        edge(a, row0, BQ, col0, BM, cols == BM && rows == BQ);
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = 8 * nt + 2 * t + (i & 1);  // query in the tile
        const int kj = wr + g + 8 * (i >> 1);     // key in the tile
        const float x = score(st[nt][i], a, slope, row0 + qi, col0 + kj,
                              masked, qi < rows && kj < cols);
        const float p = x == -INFINITY ? 0.f : expf(x - Lt[qi]);
        st[nt][i] = p;
        dpt[nt][i] = (dpt[nt][i] - Dt[qi]) * p;  // dS^T
      }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t ph[4], pl[4], dh[4], dl[4];
      acc_to_a_split(ph, pl, st, kk);
      acc_to_a_split(dh, dl, dpt, kk);
#pragma unroll
      for (int dn = 0; dn < DC / 16; ++dn) {
        uint32_t b0[2], b1[2];
        load_bt(b0, b1, dOt, RS, kk * 16, c0 + dn * 16, lane);
        mma(accv[2 * dn], ph, b0);
        mma(accv[2 * dn], pl, b0);
        mma(accv[2 * dn + 1], ph, b1);
        mma(accv[2 * dn + 1], pl, b1);
        load_bt(b0, b1, Qt, RS, kk * 16, c0 + dn * 16, lane);
        mma(acck[2 * dn], dh, b0);
        mma(acck[2 * dn], dl, b0);
        mma(acck[2 * dn + 1], dh, b1);
        mma(acck[2 * dn + 1], dl, b1);
      }
    }
    __syncthreads();
    w = nx;
    have = more;
  }
  cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // written whether or not a rank saw it
    const int kj = wr + g + 8 * h;
    if (kj >= cols) continue;
    bf16* dkrow = dkh + (size_t)(j0 + kj) * D + c0;
    bf16* dvrow = dvh + (size_t)(j0 + kj) * D + c0;
#pragma unroll
    for (int dn = 0; dn < DC / 8; ++dn) {
      const int col = dn * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dvrow + col) =
          pack(accv[dn][2 * h], accv[dn][2 * h + 1]);
      *reinterpret_cast<uint32_t*>(dkrow + col) =
          pack(a.scale * acck[dn][2 * h], a.scale * acck[dn][2 * h + 1]);
    }
  }
}

// ===================== f32: element-wise FMA ============================

// reductions over the 16 threads that own one row (one half of a warp)
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[i][j] += sum_e A[(ty + 16 i)][e] * B[(tx + 16 j)][e] over two tiles of
// stride D + 1: Q K^T, dO V^T and their transposes.
template <int D, int R>
__device__ __forceinline__ void tile_dot(float (&acc)[R][R],
                                         const float* __restrict__ A,
                                         const float* __restrict__ B, int ty,
                                         int tx) {
  constexpr int S = D + 1;
#pragma unroll 4
  for (int e = 0; e < D; ++e) {
    float x[R], y[R];
#pragma unroll
    for (int i = 0; i < R; ++i) x[i] = A[(ty + 16 * i) * S + e];
#pragma unroll
    for (int j = 0; j < R; ++j) y[j] = B[(tx + 16 * j) * S + e];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// acc[i][c] += sum_k P[(ty + 16 i)][k] * V[k][(tx + 16 c)]: a score tile
// (stride BR + 1) times a row tile (stride D + 1).
template <int D, int BR>
__device__ __forceinline__ void tile_mul(float (&acc)[BR / 16][D / 16],
                                         const float* __restrict__ P,
                                         const float* __restrict__ V, int ty,
                                         int tx) {
  constexpr int R = BR / 16, S = D + 1, PS = BR + 1;
#pragma unroll 4
  for (int kk = 0; kk < BR; ++kk) {
    float p[R];
#pragma unroll
    for (int i = 0; i < R; ++i) p[i] = P[(ty + 16 * i) * PS + kk];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const float x = V[kk * S + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i][c] = fmaf(p[i], x, acc[i][c]);
    }
  }
}

// K10. Grid (row tiles of Tl, BH, ranks); BR rows and keys per tile.
template <int D, int BR>
__global__ void __launch_bounds__(NT, 1)
    fwd_f32(const __grid_constant__ Tab tb, const Ring a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int R = BR / 16, C = D / 16, S = D + 1, PS = BR + 1;
  float* Qs = smem;
  float* Ks = Qs + BR * S;      // two stages
  float* Vs = Ks + 2 * BR * S;  // two stages
  float* Ps = Vs + 2 * BR * S;
  const int r = a.r0 + blockIdx.z, bh = blockIdx.y;
  const int i0 = blockIdx.x * BR;
  const int rows = min(BR, a.Tl - i0);
  const int row0 = r * a.Tl + i0;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float slope = slope_of(a, bh);
  const float* __restrict__ qh = in_head<float, D>(tb, IQ, r, bh);
  float* __restrict__ oh = out_head<float, D>(tb, O0, r, bh);
  float* __restrict__ Lo = out_head<float, 1>(tb, O1, r, bh);

  stage_f32<D, BR>(Qs, qh + (size_t)i0 * D, rows);
  float m[R], l[R], acc[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }
  KeyWalk w{a, r, row0, row0 + rows - 1, BR};
  bool have = w.start();
  if (have) {
    stage_f32<D, BR>(Ks, in_row<float, D>(tb, IK, w.src, bh, w.t * BR),
                     a.Tl - w.t * BR);
    stage_f32<D, BR>(Vs, in_row<float, D>(tb, IV, w.src, bh, w.t * BR),
                     a.Tl - w.t * BR);
  }
  cp_async_commit();
  for (int buf = 0; have; buf ^= 1) {
    KeyWalk nx = w;
    const bool more = nx.next();
    if (more) {
      stage_f32<D, BR>(Ks + (buf ^ 1) * BR * S,
                       in_row<float, D>(tb, IK, nx.src, bh, nx.t * BR),
                       a.Tl - nx.t * BR);
      stage_f32<D, BR>(Vs + (buf ^ 1) * BR * S,
                       in_row<float, D>(tb, IV, nx.src, bh, nx.t * BR),
                       a.Tl - nx.t * BR);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Kt = Ks + buf * BR * S;
    const float* Vt = Vs + buf * BR * S;
    const int j0 = w.t * BR, col0 = w.src * a.Tl + j0;
    const bool masked =
        edge(a, row0, BR, col0, BR, rows == BR && j0 + BR <= a.Tl);
    float s[R][R] = {};
    tile_dot<D, R>(s, Qs, Kt, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int li = ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int lj = tx + 16 * j;
        s[i][j] = score(s[i][j], a, slope, row0 + li, col0 + lj,
                        masked, li < rows && j0 + lj < a.Tl);
        mx = fmaxf(mx, s[i][j]);
      }
      const float mn = fmaxf(m[i], row_max(mx));
      const bool none = mn == -INFINITY;  // nothing visible yet
      const float alpha = none ? 1.f : expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float p = none ? 0.f : expf(s[i][j] - mn);
        rs += p;
        Ps[li * PS + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // P complete
    tile_mul<D, BR>(acc, Ps, Vt, ty, tx);
    __syncthreads();  // K, V and P consumed
    w = nx;
    have = more;
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int li = ty + 16 * i;
    if (li >= rows) continue;
    float* orow = oh + (size_t)(i0 + li) * D;
    const float denom = l[i] == 0.f ? 1.f : l[i];
    const float inv = 1.f / denom;
#pragma unroll
    for (int c = 0; c < C; ++c) orow[tx + 16 * c] = acc[i][c] * inv;
    if (tx == 0)
      Lo[i0 + li] = m[i] + logf(denom);
  }
}

// K11's dq pass, f32.
template <int D, int BR>
__global__ void __launch_bounds__(NT, 1)
    dq_f32(const __grid_constant__ Tab tb, const Ring a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int R = BR / 16, C = D / 16, S = D + 1, PS = BR + 1;
  float* Qs = smem;
  float* dOs = Qs + BR * S;
  float* Ks = dOs + BR * S;     // two stages
  float* Vs = Ks + 2 * BR * S;  // two stages
  float* dSs = Vs + 2 * BR * S;
  const int r = a.r0 + blockIdx.z, bh = blockIdx.y;
  const int i0 = blockIdx.x * BR;
  const int rows = min(BR, a.Tl - i0);
  const int row0 = r * a.Tl + i0;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float slope = slope_of(a, bh);
  const float* __restrict__ qh = in_head<float, D>(tb, IQ, r, bh);
  const float* __restrict__ dOh = in_head<float, D>(tb, IDO, r, bh);
  const float* __restrict__ Lh = in_head<float, 1>(tb, IL, r, bh);
  const float* __restrict__ dlh = in_head<float, 1>(tb, IDL, r, bh);
  float* __restrict__ dqh = out_head<float, D>(tb, O0, r, bh);

  stage_f32<D, BR>(Qs, qh + (size_t)i0 * D, rows);
  stage_f32<D, BR>(dOs, dOh + (size_t)i0 * D, rows);
  float Lr[R], dr[R], acc[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int li = ty + 16 * i;
    Lr[i] = li < rows ? Lh[i0 + li] : 0.f;
    dr[i] = li < rows ? dlh[i0 + li] : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }
  KeyWalk w{a, r, row0, row0 + rows - 1, BR};
  bool have = w.start();
  if (have) {
    stage_f32<D, BR>(Ks, in_row<float, D>(tb, IK, w.src, bh, w.t * BR),
                     a.Tl - w.t * BR);
    stage_f32<D, BR>(Vs, in_row<float, D>(tb, IV, w.src, bh, w.t * BR),
                     a.Tl - w.t * BR);
  }
  cp_async_commit();
  for (int buf = 0; have; buf ^= 1) {
    KeyWalk nx = w;
    const bool more = nx.next();
    if (more) {
      stage_f32<D, BR>(Ks + (buf ^ 1) * BR * S,
                       in_row<float, D>(tb, IK, nx.src, bh, nx.t * BR),
                       a.Tl - nx.t * BR);
      stage_f32<D, BR>(Vs + (buf ^ 1) * BR * S,
                       in_row<float, D>(tb, IV, nx.src, bh, nx.t * BR),
                       a.Tl - nx.t * BR);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Kt = Ks + buf * BR * S;
    const float* Vt = Vs + buf * BR * S;
    const int j0 = w.t * BR, col0 = w.src * a.Tl + j0;
    const bool masked =
        edge(a, row0, BR, col0, BR, rows == BR && j0 + BR <= a.Tl);
    float s[R][R] = {}, dp[R][R] = {};
    tile_dot<D, R>(s, Qs, Kt, ty, tx);
    tile_dot<D, R>(dp, dOs, Vt, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int li = ty + 16 * i, lj = tx + 16 * j;
        const float x = score(s[i][j], a, slope, row0 + li, col0 + lj,
                              masked, li < rows && j0 + lj < a.Tl);
        const float p = x == -INFINITY ? 0.f : expf(x - Lr[i]);
        dSs[li * PS + lj] = (dp[i][j] - dr[i]) * p;
      }
    __syncthreads();  // dS complete
    tile_mul<D, BR>(acc, dSs, Kt, ty, tx);
    __syncthreads();
    w = nx;
    have = more;
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int li = ty + 16 * i;
    if (li >= rows) continue;
    float* dqrow = dqh + (size_t)(i0 + li) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) dqrow[tx + 16 * c] = a.scale * acc[i][c];
  }
}

// K11's dk/dv pass, f32. Thread (ty, tx) owns the transposed score
// entries (key ty + 16 i, query tx + 16 j) and the dk/dv entries (key
// ty + 16 i, column tx + 16 c).
template <int D, int BR>
__global__ void __launch_bounds__(NT, 1)
    dkdv_f32(const __grid_constant__ Tab tb, const Ring a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int R = BR / 16, C = D / 16, S = D + 1, PS = BR + 1;
  float* Ks = smem;
  float* Vs = Ks + BR * S;
  float* Qs = Vs + BR * S;       // two stages
  float* dOs = Qs + 2 * BR * S;  // two stages
  float* Pt = dOs + 2 * BR * S;
  float* dSt = Pt + BR * PS;
  const int c = a.r0 + blockIdx.z, bh = blockIdx.y;
  const int j0 = blockIdx.x * BR;
  const int cols = min(BR, a.Tl - j0);
  const int col0 = c * a.Tl + j0;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float slope = slope_of(a, bh);
  const float* __restrict__ kh = in_head<float, D>(tb, IK, c, bh);
  const float* __restrict__ vh = in_head<float, D>(tb, IV, c, bh);
  float* __restrict__ dkh = out_head<float, D>(tb, O1, c, bh);
  float* __restrict__ dvh = out_head<float, D>(tb, O2, c, bh);

  stage_f32<D, BR>(Ks, kh + (size_t)j0 * D, cols);
  stage_f32<D, BR>(Vs, vh + (size_t)j0 * D, cols);
  float accv[R][C], acck[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int cc = 0; cc < C; ++cc) accv[i][cc] = acck[i][cc] = 0.f;
  QueryWalk w{a, c, col0, col0 + cols - 1, BR};
  bool have = w.start();
  if (have) {
    stage_f32<D, BR>(Qs, in_row<float, D>(tb, IQ, w.r, bh, w.t * BR),
                     a.Tl - w.t * BR);
    stage_f32<D, BR>(dOs, in_row<float, D>(tb, IDO, w.r, bh, w.t * BR),
                     a.Tl - w.t * BR);
  }
  cp_async_commit();
  for (int buf = 0; have; buf ^= 1) {
    QueryWalk nx = w;
    const bool more = nx.next();
    if (more) {
      stage_f32<D, BR>(Qs + (buf ^ 1) * BR * S,
                       in_row<float, D>(tb, IQ, nx.r, bh, nx.t * BR),
                       a.Tl - nx.t * BR);
      stage_f32<D, BR>(dOs + (buf ^ 1) * BR * S,
                       in_row<float, D>(tb, IDO, nx.r, bh, nx.t * BR),
                       a.Tl - nx.t * BR);
    }
    cp_async_commit();
    const int i0 = w.t * BR, row0 = w.r * a.Tl + i0;
    const int rows = min(BR, a.Tl - i0);
    // rank w.r's L and delta: read-only for the whole launch (__ldg)
    const float* Lw = in_row<float, 1>(tb, IL, w.r, bh, i0);
    const float* dw = in_row<float, 1>(tb, IDL, w.r, bh, i0);
    float Lq[R], dq_[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int lj = tx + 16 * j;
      Lq[j] = lj < rows ? __ldg(Lw + lj) : 0.f;
      dq_[j] = lj < rows ? __ldg(dw + lj) : 0.f;
    }
    cp_async_wait<1>();
    __syncthreads();
    const float* Qt = Qs + buf * BR * S;
    const float* dOt = dOs + buf * BR * S;
    const bool masked =
        edge(a, row0, BR, col0, BR, cols == BR && rows == BR);
    float st[R][R] = {}, dpt[R][R] = {};
    tile_dot<D, R>(st, Ks, Qt, ty, tx);
    tile_dot<D, R>(dpt, Vs, dOt, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int ki = ty + 16 * i, lj = tx + 16 * j;
        const float x = score(st[i][j], a, slope, row0 + lj, col0 + ki,
                              masked, lj < rows && ki < cols);
        const float p = x == -INFINITY ? 0.f : expf(x - Lq[j]);
        Pt[ki * PS + lj] = p;
        dSt[ki * PS + lj] = (dpt[i][j] - dq_[j]) * p;
      }
    __syncthreads();  // P^T and dS^T complete
    tile_mul<D, BR>(accv, Pt, dOt, ty, tx);
    tile_mul<D, BR>(acck, dSt, Qt, ty, tx);
    __syncthreads();
    w = nx;
    have = more;
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < R; ++i) {  // written whether or not a rank saw it
    const int ki = ty + 16 * i;
    if (ki >= cols) continue;
    float* dkrow = dkh + (size_t)(j0 + ki) * D;
    float* dvrow = dvh + (size_t)(j0 + ki) * D;
#pragma unroll
    for (int cc = 0; cc < C; ++cc) {
      dvrow[tx + 16 * cc] = accv[i][cc];
      dkrow[tx + 16 * cc] = a.scale * acck[i][cc];
    }
  }
}

// ===================== launch =========================================

// Raise the kernel's dynamic shared-memory cap where it is over the 48 KB
// default (a launch over the cap is refused and never runs), launch it and
// return the launch's error.
template <typename... P, typename... A>
int launch(void (*kern)(P...), dim3 grid, int threads, size_t smem,
           cudaStream_t stream, A... args) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// Tile sizes per width, chosen so that no kernel spills: bf16 queries per
// tile of dk/dv BQ (16 from d 128,
// where its two f32 accumulators take 128 registers); the column slice DC
// of every accumulator (128: two slices at d 256); f32 rows per tile BR
// (32 at d 256, for shared memory).
template <int D>
struct Tiles {
  static constexpr int BQ = D >= 128 ? 16 : 32;
  static constexpr int DC = D == 256 ? 128 : D;
  static constexpr int BR = D == 256 ? 32 : 64;
};

constexpr size_t bf16_smem(int D, int own, int staged, int BN) {
  return ((size_t)own * BM + (size_t)staged * 2 * BN) * (D + 8) * 2;
}
constexpr size_t f32_smem(int D, int tiles, int scores, int BR) {
  return ((size_t)tiles * BR * (D + 1) + (size_t)scores * BR * (BR + 1)) * 4;
}

template <int D>
int run_bf16(int which, const Ring& a, int nr, const Tab& tb,
             cudaStream_t st) {
  using C = Tiles<D>;
  const dim3 grid((a.Tl + BM - 1) / BM, a.BH, nr * (D / C::DC));
  if (which == 0)
    return launch(fwd_bf16<D, C::DC>, grid, MT, bf16_smem(D, 1, 2, BN), st,
                  tb, a);
  int err = launch(dq_bf16<D, C::DC>, grid, MT, bf16_smem(D, 2, 2, BN), st,
                   tb, a);
  if (err) return err;
  return launch(dkdv_bf16<D, C::BQ, C::DC>, grid, MT,
                bf16_smem(D, 2, 2, C::BQ) + 4 * C::BQ * 4, st, tb, a);
}

template <int D>
int run_f32(int which, const Ring& a, int nr, const Tab& tb,
            cudaStream_t st) {
  constexpr int BR = Tiles<D>::BR;
  const dim3 grid((a.Tl + BR - 1) / BR, a.BH, nr);
  if (which == 0)
    return launch(fwd_f32<D, BR>, grid, NT, f32_smem(D, 5, 1, BR), st, tb,
                  a);
  int err = launch(dq_f32<D, BR>, grid, NT, f32_smem(D, 6, 1, BR), st, tb,
                   a);
  if (err) return err;
  return launch(dkdv_f32<D, BR>, grid, NT, f32_smem(D, 6, 2, BR), st, tb,
                a);
}

template <int D>
int run(int dtype, int which, const Ring& a, int nr, const Tab& tb,
        cudaStream_t st) {
  if (dtype == 0) return run_f32<D>(which, a, nr, tb, st);
  if (dtype == 1) return run_bf16<D>(which, a, nr, tb, st);
  return -1;
}

// Fill a kernel's table from the caller's flat one: N_IN rows of MAX_RANKS
// input pointers, then N_OUT rows of output pointers, rank-major in each.
int dispatch(int dtype, int d, int which, const Ring& a, int nr,
             const void* const* flat, long long hs, void* stream) {
  if (a.n < 1 || a.n > MAX_RANKS || a.Tl < 1 ||
      (long long)a.n * a.Tl > 0x7fffffff || a.BH < 1 || a.BH > 65535 ||
      a.H < 1 || a.BH % a.H || a.r0 < 0 || nr < 1 || a.r0 + nr > a.n ||
      a.window < 0 || hs < a.Tl || (long long)a.BH * hs > 0x7fffffff)
    return -1;
  Tab tb;
  for (int x = 0; x < MAX_RANKS; ++x) {
    for (int i = 0; i < N_IN; ++i) tb.in[i][x] = flat[i * MAX_RANKS + x];
    for (int i = 0; i < N_OUT; ++i)
      tb.out[i][x] = const_cast<void*>(flat[(N_IN + i) * MAX_RANKS + x]);
  }
  tb.hs = hs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return run<32>(dtype, which, a, nr, tb, s);
    case 64: return run<64>(dtype, which, a, nr, tb, s);
    case 128: return run<128>(dtype, which, a, nr, tb, s);
    case 256: return run<256>(dtype, which, a, nr, tb, s);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO, o, dq, dk, dv). d is the
// padded head width (32, 64, 128 or 256), BH = batch * heads, H the heads
// (ALiBi slope of head bh % H; `slopes` null for none), n the ring's ranks
// (at most ring_max_ranks()), Tl the rows per rank, ranks [r0, r0 + nr)
// the launch's, window 0 for no band. `tab` is the flat per-rank table
// (see dispatch): the forward's inputs q, k, v and outputs o, L; the
// backward's inputs q, k, v, dO, L, delta and outputs dq, dk, dv. `hs`
// is the rows between two heads of a rank's chunk (T when rank-stacked,
// Tl for one tensor per rank). Each returns 0 on success, -1 for an
// unsupported dtype, d or shape, else the cudaError_t of a launch.

extern "C" int ring_max_ranks() { return MAX_RANKS; }

// The forward over ranks [r0, r0 + nr) of the ring (K10): o (BH, rows, d)
// and L (BH, rows) f32 of each rank.
extern "C" int ring_fwd_launch(int dtype, int d, const void* const* tab,
                               long long hs, const void* slopes, int BH,
                               int H, int n, int Tl, int r0, int nr,
                               int causal, int window, float scale,
                               void* stream) {
  Ring a{BH, H, n, Tl, r0, causal, window, scale,
         static_cast<const float*>(slopes)};
  return dispatch(dtype, d, 0, a, nr, tab, hs, stream);
}

// The backward over ranks (chunks) [r0, r0 + nr) (K11): the dq pass, then
// the dk/dv pass, from the forward's L and delta = rowsum(dO * O), both
// f32.
extern "C" int ring_bwd_launch(int dtype, int d, const void* const* tab,
                               long long hs, const void* slopes, int BH,
                               int H, int n, int Tl, int r0, int nr,
                               int causal, int window, float scale,
                               void* stream) {
  Ring a{BH, H, n, Tl, r0, causal, window, scale,
         static_cast<const float*>(slopes)};
  return dispatch(dtype, d, 1, a, nr, tab, hs, stream);
}

// Let card `dev` read card `peer`'s memory: 0 when it can (already
// enabled counts), else the cudaError_t (cudaErrorPeerAccessUnsupported
// when the pair cannot reach each other).
extern "C" int ring_enable_peer(int dev, int peer) {
  if (dev == peer) return 0;
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, dev, peer);
  if (err != cudaSuccess) return (int)err;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  int prev = 0;
  err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(dev);
  if (err == cudaSuccess) err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear it: already enabled is success
    err = cudaSuccess;
  }
  cudaSetDevice(prev);
  return (int)err;
}

// -- chunks in other processes (CUDA IPC) ------------------------------------
//
// A rank held by another process has no pointer here. Its process places
// its chunks in an arena of its own, allocated with cudaMalloc (never
// from a caching allocator, whose blocks share one handle with their
// neighbours), exports the arena's handle, and every peer opens it once:
// the opened pointer goes into the table like any other chunk's. Each
// returns 0 or the cudaError_t; the device is set for the call and put
// back.

extern "C" int ring_ipc_handle_bytes() {
  return (int)sizeof(cudaIpcMemHandle_t);
}

// An arena of `bytes` on card `dev`: its pointer and its exported handle
// (ring_ipc_handle_bytes() bytes).
extern "C" int ring_ipc_alloc(int dev, long long bytes, void** ptr,
                              void* handle) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(dev);
  if (err == cudaSuccess) err = cudaMalloc(ptr, (size_t)bytes);
  if (err == cudaSuccess) {
    err = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle),
                              *ptr);
    if (err != cudaSuccess) cudaFree(*ptr);
  }
  cudaSetDevice(prev);
  return (int)err;
}

// A peer's arena from its handle, opened on card `dev` (another card's
// arena is read over peer access, enabled here; a pair that cannot reach
// each other fails). Fails on a handle of this process's own.
extern "C" int ring_ipc_open(int dev, const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof h);
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(dev);
  if (err == cudaSuccess)
    err = cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
  cudaSetDevice(prev);
  return (int)err;
}

// Close a peer's arena opened by ring_ipc_open (before its owner frees it).
extern "C" int ring_ipc_close(int dev, void* ptr) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(dev);
  if (err == cudaSuccess) err = cudaIpcCloseMemHandle(ptr);
  cudaSetDevice(prev);
  return (int)err;
}

// Free this process's arena (once every peer has closed it).
extern "C" int ring_ipc_free(int dev, void* ptr) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(dev);
  if (err == cudaSuccess) err = cudaFree(ptr);
  cudaSetDevice(prev);
  return (int)err;
}

// Copy `bytes` from a contiguous chunk into an arena slot, in `stream`'s
// order.
extern "C" int ring_ipc_copy(void* dst, const void* src, long long bytes,
                             void* stream) {
  return (int)cudaMemcpyAsync(dst, src, (size_t)bytes,
                              cudaMemcpyDeviceToDevice,
                              static_cast<cudaStream_t>(stream));
}
