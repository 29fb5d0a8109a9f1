// Ring attention, one ring step at a time, for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernels of
//   linalg_tpu/parallel/ring_pallas.py:209  ring_attention_pallas_local (K10,
//                                           body _ring_kernel :92)
//   linalg_tpu/parallel/ring_pallas.py:439  ring_attention_pallas_bwd_local
//                                           (K11, body _ring_bwd_kernel :313)
//
// Sequence parallelism over a ring of n ranks: rank r holds the query rows
// [r Tl, (r + 1) Tl) of a sequence of T = n Tl, and over n steps each K/V
// chunk passes every rank once. At step s rank r holds the chunk of rank
// src = (r - s) mod n. On the TPU one kernel per device loops over the n
// steps and moves the chunks itself with remote DMAs. Here the ranks are
// rank-stacked buffers, the caller moves the chunks between steps (device
// copies on a side stream, CUDA events as the credits), and each kernel
// below is ONE step for a range of ranks [r0, r0 + nr): blockIdx.z picks
// the rank, so a placement of ranks on several cards launches one range per
// card. Blocks carry nothing between launches except what they store:
//
//   forward (K10)  ring_fwd: the online softmax of the chunk folded into
//                  f32 running max m, normalizer l and accumulator acc,
//                  stored per row between steps; the last step writes
//                  O = acc / l in the io dtype and L = m + log l (f32).
//   backward (K11) ring_dq: P = exp(S - L), dP = dO V^T, dS = (dP - delta)
//                  P, dq += dS K, accumulated in f32 between steps, scaled
//                  and written in the io dtype at the last step;
//                  ring_dkdv: the traveling bundle's dk += scale dS^T Q and
//                  dv += P^T dO for the chunk it holds now (the bundle is
//                  f32 (k, v, dk, dv), as on the TPU).
//
// Each (rank, row tile) owns its rows of m/l/acc and dq, and each (rank, key
// tile) its rows of the bundle, so there are no atomics and two runs give
// the same bits. delta = rowsum(dO * O) is one f32 pass the caller makes,
// as the TPU wrapper does (ring_pallas.py:561).
//
// Masks use global positions, row = r Tl + i and col = src Tl + j: causal
// (col <= row), the sliding-window band (col > row - window) and the ALiBi
// bias slope_h (col - row) added to the scaled scores, as _ring_kernel does.
// _chunk_live (ring_pallas.py:74) decides per (rank, step) whether the chunk
// can hold a visible key; a dead chunk's blocks return at once (the forward
// and dq still finalize at the last step). Inside a live chunk a block walks
// only the key (or query) tiles that hold a visible entry, as K4 does, and
// applies the element-wise mask to every tile, so Tl needs no relation to
// the tile size: rows and columns past Tl are banned and never stored.
// Banned scores are -inf and give exactly 0; a row that has seen nothing
// yet keeps m = -inf (alpha 1, p 0). The own chunk (step 0) is always live
// and holds the diagonal, so every row has a finite max after step 0, and
// l > 0 at the end; the l == 0 guard of the TPU kernel stays.
//
// Precision: as the TPU kernels (ring_pallas.py:136, :167-168, :346-347),
// all math is f32 on the FMA units for f32 and bf16 inputs alike; bf16 is
// widened when staged into shared memory. Scores, P and dS never round.
//
// What bounds it on this card: arithmetic. At long_window's shape (B 8, h 4,
// T 4096, d 128, n 4, window 512) the live pairs cost 4 d flops each
// forward and 8 d (with recomputation) backward on FMA units of 67 TFLOP/s,
// against a few MB of q/k/v/o traffic. Design: each tile product stays in
// registers and shared memory; dead chunks and tiles outside the band are
// skipped, not masked. Simple and right first: 256 threads as a 16 x 16
// grid, thread (ty, tx) owns score entries (ty + 16 i, tx + 16 j) and output
// entries (ty + 16 i, tx + 16 c); tiles of BR rows (64, or 32 at d 256 to
// fit shared memory) padded by one float. Tensor cores, cp.async/TMA and the
// f32 state kept in registers across steps are perf_opt work.
//
// Layouts (all contiguous, elements): q, dO, o, dq: (BH, T, D); m, l, L,
// delta: (BH, T) f32; acc, dq_acc: (BH, T, D) f32; the forward's K/V slot:
// (n, 2, BH, Tl, D) in the io dtype; the backward's bundle slot: (n, 4, BH,
// Tl, D) f32. D is the padded head width (32, 64, 128, 256): zero columns
// add nothing to q.k and give zero output columns, and `scale` is
// 1 / sqrt(true d).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;  // threads per block: a 16 x 16 grid

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

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

// _chunk_live: whether the chunk of rank src can hold a key visible to
// rank r. Causal: not in the future. Window: its newest key is less than
// window - 1 behind r's oldest row, (r - src - 1) Tl < window - 1.
__device__ __forceinline__ bool chunk_live(int src, int r, int Tl, int causal,
                                           int window) {
  if (!causal) return true;
  if (src > r) return false;
  return window <= 0 || (long long)(r - src - 1) * Tl < window - 1;
}

// query `row` may not see key `col` (global positions)
__device__ __forceinline__ bool banned(long long row, long long col,
                                       int causal, int window) {
  return (causal && col > row) || (window > 0 && row - col >= window);
}

// Rows [0, BR) of a (rows, D) array of row stride D, widened to f32, into
// shared memory of row stride D + 1; rows at or past `valid` are zero.
template <int D, int BR, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int valid) {
  for (int i = threadIdx.x; i < BR * D; i += NT) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = r < valid ? to_f(src[(size_t)r * D + c]) : 0.f;
  }
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
    float a[R], b[R];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = A[(ty + 16 * i) * S + e];
#pragma unroll
    for (int j = 0; j < R; ++j) b[j] = B[(tx + 16 * j) * S + e];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
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
  for (int k = 0; k < BR; ++k) {
    float p[R];
#pragma unroll
    for (int i = 0; i < R; ++i) p[i] = P[(ty + 16 * i) * PS + k];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const float x = V[k * S + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i][c] = fmaf(p[i], x, acc[i][c]);
    }
  }
}

// The scaled, biased and masked score of (row, col) from the raw product.
__device__ __forceinline__ float score(float dot, float scale, float slope,
                                       long long row, long long col,
                                       bool in_chunk, int causal, int window) {
  if (!in_chunk || banned(row, col, causal, window)) return -INFINITY;
  return dot * scale + slope * (float)(col - row);
}

struct Step {
  int BH, H, n, Tl, step, r0, causal, window, last;
  float scale;
  const float* slopes;  // (H,) ALiBi slopes, or null
};

// The key tiles [kb0, kb1) of chunk `src` that hold a key visible to the
// query rows [row0, row1] (global).
__device__ __forceinline__ void key_tiles(const Step& a, int src,
                                          long long row0, long long row1,
                                          int BR, int& kb0, int& kb1) {
  const long long c0 = (long long)src * a.Tl;
  long long jlo = 0, jhi = a.Tl - 1;
  if (a.window > 0) jlo = max(jlo, row0 - a.window + 1 - c0);
  if (a.causal) jhi = min(jhi, row1 - c0);
  kb0 = (int)(jlo / BR);
  kb1 = jhi < jlo ? kb0 : (int)(jhi / BR) + 1;
}

// ===================== K10: one forward step ============================

template <int D, int BR, typename IO>
__global__ void __launch_bounds__(NT)
    ring_fwd(const IO* __restrict__ q, const IO* __restrict__ kv,
             float* __restrict__ m_s, float* __restrict__ l_s,
             float* __restrict__ acc_s, IO* __restrict__ o,
             float* __restrict__ L, const Step a) {
  extern __shared__ float smem[];
  constexpr int R = BR / 16, C = D / 16, S = D + 1, PS = BR + 1;
  float* Qs = smem;
  float* Ks = Qs + BR * S;
  float* Vs = Ks + BR * S;
  float* Ps = Vs + BR * S;
  const int r = a.r0 + blockIdx.z;
  const int bh = blockIdx.y;
  const int src = (r - a.step % a.n + a.n) % a.n;
  const bool live = chunk_live(src, r, a.Tl, a.causal, a.window);
  if (!live && !a.last) return;
  const int i0 = blockIdx.x * BR;  // first local row of the tile
  const int rows = min(BR, a.Tl - i0);
  const long long Tg = (long long)a.n * a.Tl;
  const long long grow0 = (long long)r * a.Tl + i0;  // its global row
  const size_t rbase = (size_t)bh * Tg + grow0;       // its (bh, row) index
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float slope = a.slopes ? a.slopes[bh % a.H] : 0.f;

  float m[R], l[R], acc[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int li = ty + 16 * i;
    const bool ok = a.step > 0 && li < rows;
    m[i] = ok ? m_s[rbase + li] : -INFINITY;
    l[i] = ok ? l_s[rbase + li] : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c)
      acc[i][c] = ok ? acc_s[(rbase + li) * D + tx + 16 * c] : 0.f;
  }

  if (live) {
    load_tile<D, BR>(Qs, q + rbase * D, rows);
    const IO* kc = kv + (((size_t)r * 2 + 0) * a.BH + bh) * a.Tl * D;
    const IO* vc = kv + (((size_t)r * 2 + 1) * a.BH + bh) * a.Tl * D;
    int kb0, kb1;
    key_tiles(a, src, grow0, grow0 + rows - 1, BR, kb0, kb1);
    for (int kb = kb0; kb < kb1; ++kb) {
      const int j0 = kb * BR;
      const int cols = min(BR, a.Tl - j0);
      __syncthreads();  // the previous tile's K, V and P are consumed
      load_tile<D, BR>(Ks, kc + (size_t)j0 * D, cols);
      load_tile<D, BR>(Vs, vc + (size_t)j0 * D, cols);
      __syncthreads();
      float s[R][R] = {};
      tile_dot<D, R>(s, Qs, Ks, ty, tx);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const long long row = grow0 + ty + 16 * i;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int lj = tx + 16 * j;
          s[i][j] = score(s[i][j], a.scale, slope, row,
                          (long long)src * a.Tl + j0 + lj,
                          lj < cols && ty + 16 * i < rows, a.causal,
                          a.window);
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
          Ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
        }
        l[i] = l[i] * alpha + row_sum(rs);
        m[i] = mn;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
      }
      __syncthreads();  // P complete
      tile_mul<D, BR>(acc, Ps, Vs, ty, tx);
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int li = ty + 16 * i;
    if (li >= rows) continue;
    const size_t g = rbase + li;
    if (a.last) {
      const float denom = l[i] == 0.f ? 1.f : l[i];
      const float inv = 1.f / denom;
#pragma unroll
      for (int c = 0; c < C; ++c)
        o[g * D + tx + 16 * c] = from_f<IO>(acc[i][c] * inv);
      if (tx == 0) L[g] = m[i] + logf(denom);
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) acc_s[g * D + tx + 16 * c] = acc[i][c];
      if (tx == 0) {
        m_s[g] = m[i];
        l_s[g] = l[i];
      }
    }
  }
}

// ===================== K11: one backward step ===========================

// dq of rank r's query rows against the chunk the bundle slot holds.
template <int D, int BR, typename IO>
__global__ void __launch_bounds__(NT)
    ring_dq(const IO* __restrict__ q, const IO* __restrict__ dO,
            const float* __restrict__ L, const float* __restrict__ delta,
            const float* __restrict__ bundle, float* __restrict__ dq_acc,
            IO* __restrict__ dq, const Step a) {
  extern __shared__ float smem[];
  constexpr int R = BR / 16, C = D / 16, S = D + 1, PS = BR + 1;
  float* Qs = smem;
  float* dOs = Qs + BR * S;
  float* Ks = dOs + BR * S;
  float* Vs = Ks + BR * S;
  float* dSs = Vs + BR * S;
  const int r = a.r0 + blockIdx.z;
  const int bh = blockIdx.y;
  const int src = (r - a.step % a.n + a.n) % a.n;
  const bool live = chunk_live(src, r, a.Tl, a.causal, a.window);
  if (!live && !a.last) return;
  const int i0 = blockIdx.x * BR;
  const int rows = min(BR, a.Tl - i0);
  const long long Tg = (long long)a.n * a.Tl;
  const long long grow0 = (long long)r * a.Tl + i0;
  const size_t rbase = (size_t)bh * Tg + grow0;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float slope = a.slopes ? a.slopes[bh % a.H] : 0.f;

  float acc[R][C], Lr[R], dr[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int li = ty + 16 * i;
    const bool ok = li < rows;
    Lr[i] = ok ? L[rbase + li] : 0.f;
    dr[i] = ok ? delta[rbase + li] : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c)
      acc[i][c] = ok && a.step > 0 ? dq_acc[(rbase + li) * D + tx + 16 * c]
                                   : 0.f;
  }

  if (live) {
    load_tile<D, BR>(Qs, q + rbase * D, rows);
    load_tile<D, BR>(dOs, dO + rbase * D, rows);
    const float* kc = bundle + (((size_t)r * 4 + 0) * a.BH + bh) * a.Tl * D;
    const float* vc = bundle + (((size_t)r * 4 + 1) * a.BH + bh) * a.Tl * D;
    int kb0, kb1;
    key_tiles(a, src, grow0, grow0 + rows - 1, BR, kb0, kb1);
    for (int kb = kb0; kb < kb1; ++kb) {
      const int j0 = kb * BR;
      const int cols = min(BR, a.Tl - j0);
      __syncthreads();
      load_tile<D, BR>(Ks, kc + (size_t)j0 * D, cols);
      load_tile<D, BR>(Vs, vc + (size_t)j0 * D, cols);
      __syncthreads();
      float s[R][R] = {}, dp[R][R] = {};
      tile_dot<D, R>(s, Qs, Ks, ty, tx);
      tile_dot<D, R>(dp, dOs, Vs, ty, tx);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int lj = tx + 16 * j;
          const float sv = score(s[i][j], a.scale, slope, grow0 + ty + 16 * i,
                                 (long long)src * a.Tl + j0 + lj,
                                 lj < cols && ty + 16 * i < rows, a.causal,
                                 a.window);
          const float p = sv == -INFINITY ? 0.f : expf(sv - Lr[i]);
          dSs[(ty + 16 * i) * PS + lj] = (dp[i][j] - dr[i]) * p;
        }
      __syncthreads();
      tile_mul<D, BR>(acc, dSs, Ks, ty, tx);
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int li = ty + 16 * i;
    if (li >= rows) continue;
    const size_t g = rbase + li;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (a.last)
        dq[g * D + tx + 16 * c] = from_f<IO>(a.scale * acc[i][c]);
      else
        dq_acc[g * D + tx + 16 * c] = acc[i][c];
    }
  }
}

// The bundle's dk/dv rows of key tile blockIdx.x of the chunk rank r holds,
// from r's query rows. Thread (ty, tx) owns the transposed score entries
// (key ty + 16 i, query tx + 16 j) and the dk/dv entries (key ty + 16 i,
// column tx + 16 c).
template <int D, int BR, typename IO>
__global__ void __launch_bounds__(NT)
    ring_dkdv(const IO* __restrict__ q, const IO* __restrict__ dO,
              const float* __restrict__ L, const float* __restrict__ delta,
              float* __restrict__ bundle, const Step a) {
  extern __shared__ float smem[];
  constexpr int R = BR / 16, C = D / 16, S = D + 1, PS = BR + 1;
  float* Ks = smem;
  float* Vs = Ks + BR * S;
  float* Qs = Vs + BR * S;
  float* dOs = Qs + BR * S;
  float* Pt = dOs + BR * S;
  float* dSt = Pt + BR * PS;
  const int r = a.r0 + blockIdx.z;
  const int bh = blockIdx.y;
  const int src = (r - a.step % a.n + a.n) % a.n;
  if (!chunk_live(src, r, a.Tl, a.causal, a.window)) return;
  const int j0 = blockIdx.x * BR;  // first local key of the tile
  const int cols = min(BR, a.Tl - j0);
  const long long Tg = (long long)a.n * a.Tl;
  const long long gcol0 = (long long)src * a.Tl + j0;
  const long long qrow0 = (long long)r * a.Tl;  // r's first global row
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float slope = a.slopes ? a.slopes[bh % a.H] : 0.f;
  float* kc = bundle + (((size_t)r * 4 + 0) * a.BH + bh) * a.Tl * D;
  float* vc = bundle + (((size_t)r * 4 + 1) * a.BH + bh) * a.Tl * D;
  float* dkc = bundle + (((size_t)r * 4 + 2) * a.BH + bh) * a.Tl * D;
  float* dvc = bundle + (((size_t)r * 4 + 3) * a.BH + bh) * a.Tl * D;

  load_tile<D, BR>(Ks, kc + (size_t)j0 * D, cols);
  load_tile<D, BR>(Vs, vc + (size_t)j0 * D, cols);
  float accv[R][C], acck[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) accv[i][c] = acck[i][c] = 0.f;

  // r's query rows that see a key of the tile: causal, rows >= the first
  // key; window, rows < the last key + window
  long long ilo = 0, ihi = a.Tl - 1;
  if (a.causal) ilo = max(ilo, gcol0 - qrow0);
  if (a.window > 0) ihi = min(ihi, gcol0 + cols - 1 + a.window - 1 - qrow0);
  const int qb0 = (int)(ilo / BR);
  const int qb1 = ihi < ilo ? qb0 : (int)(ihi / BR) + 1;
  for (int qb = qb0; qb < qb1; ++qb) {
    const int i0 = qb * BR;
    const int rows = min(BR, a.Tl - i0);
    const size_t rbase = (size_t)bh * Tg + qrow0 + i0;
    __syncthreads();
    load_tile<D, BR>(Qs, q + rbase * D, rows);
    load_tile<D, BR>(dOs, dO + rbase * D, rows);
    float Lq[R], dq_[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int lj = tx + 16 * j;
      Lq[j] = lj < rows ? L[rbase + lj] : 0.f;
      dq_[j] = lj < rows ? delta[rbase + lj] : 0.f;
    }
    __syncthreads();
    float st[R][R] = {}, dpt[R][R] = {};
    tile_dot<D, R>(st, Ks, Qs, ty, tx);
    tile_dot<D, R>(dpt, Vs, dOs, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int lj = tx + 16 * j;
        const float sv = score(st[i][j], a.scale, slope, qrow0 + i0 + lj,
                               gcol0 + ty + 16 * i,
                               lj < rows && ty + 16 * i < cols, a.causal,
                               a.window);
        const float p = sv == -INFINITY ? 0.f : expf(sv - Lq[j]);
        Pt[(ty + 16 * i) * PS + lj] = p;
        dSt[(ty + 16 * i) * PS + lj] = (dpt[i][j] - dq_[j]) * p;
      }
    __syncthreads();
    tile_mul<D, BR>(accv, Pt, dOs, ty, tx);
    tile_mul<D, BR>(acck, dSt, Qs, ty, tx);
  }
  if (qb1 <= qb0) return;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int li = ty + 16 * i;
    if (li >= cols) continue;
    const size_t g = (size_t)(j0 + li) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dvc[g + tx + 16 * c] += accv[i][c];
      dkc[g + tx + 16 * c] += a.scale * acck[i][c];
    }
  }
}

// ===================== launch =========================================

constexpr size_t smem_bytes(int D, int BR, int tiles, int scores) {
  return ((size_t)tiles * BR * (D + 1) + (size_t)scores * BR * (BR + 1)) * 4;
}

// Raise the kernel's dynamic shared-memory cap where it is over the 48 KB
// default (a launch over the cap is refused and never runs), launch it on
// the (tiles of Tl, BH, ranks) grid, and return the launch's error.
template <typename... P, typename... A>
int launch(void (*kern)(P...), size_t smem, int BR, int nr, const Step& a,
           cudaStream_t stream, A... args) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<dim3((a.Tl + BR - 1) / BR, a.BH, nr), NT, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// The pointers of one launch: the io-dtype inputs q and kv slot (forward)
// or q and dO (backward), the f32 inputs, the f32 state it updates, and the
// io-dtype output.
struct Ptrs {
  const void *in0, *in1;
  const float *L, *delta;         // backward: the forward's L and delta
  float *s0, *s1, *s2;            // forward m, l, acc; backward bundle, dq_acc
  void* out;                      // forward o, backward dq
  float* L_out;                   // forward L
};

template <int D, int BR, typename T>
int run(int which, const Step& a, int nr, const Ptrs& p,
        cudaStream_t stream) {
  const T* in0 = static_cast<const T*>(p.in0);
  const T* in1 = static_cast<const T*>(p.in1);
  T* out = static_cast<T*>(p.out);
  if (which == 0)
    return launch(ring_fwd<D, BR, T>, smem_bytes(D, BR, 3, 1), BR, nr, a,
                  stream, in0, in1, p.s0, p.s1, p.s2, out, p.L_out, a);
  int err = launch(ring_dq<D, BR, T>, smem_bytes(D, BR, 4, 1), BR, nr, a,
                   stream, in0, in1, p.L, p.delta, p.s0, p.s1, out, a);
  if (err) return err;
  return launch(ring_dkdv<D, BR, T>, smem_bytes(D, BR, 4, 2), BR, nr, a,
                stream, in0, in1, p.L, p.delta, p.s0, a);
}

template <int D, int BR>
int run_dtype(int dtype, int which, const Step& a, int nr, const Ptrs& p,
              cudaStream_t stream) {
  if (dtype == 0) return run<D, BR, float>(which, a, nr, p, stream);
  if (dtype == 1) return run<D, BR, bf16>(which, a, nr, p, stream);
  return -1;
}

int dispatch(int dtype, int d, int which, const Step& a, int nr,
             const Ptrs& p, void* stream) {
  if (a.n < 1 || a.Tl < 1 || a.BH < 1 || a.BH > 65535 || a.H < 1 ||
      a.BH % a.H || a.step < 0 || a.step >= a.n || a.r0 < 0 || nr < 1 ||
      nr > 65535 || a.r0 + nr > a.n || a.window < 0)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return run_dtype<32, 64>(dtype, which, a, nr, p, s);
    case 64: return run_dtype<64, 64>(dtype, which, a, nr, p, s);
    case 128: return run_dtype<128, 64>(dtype, which, a, nr, p, s);
    case 256: return run_dtype<256, 32>(dtype, which, a, nr, p, s);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, dO, the forward's K/V slot, o, dq).
// d is the padded head width (32, 64, 128 or 256), BH = batch * heads, H
// the heads (ALiBi slope of head bh % H; `slopes` null for none), n the
// ring's ranks, Tl the rows per rank, step in [0, n), ranks [r0, r0 + nr),
// window 0 for no band, last 1 on step n - 1. Each returns 0 on success,
// -1 for an unsupported dtype, d or shape, else the cudaError_t of a launch.

// One forward step (K10): fold the chunk in kv_slot (n, 2, BH, Tl, d) into
// m, l (BH, T) and acc (BH, T, d), all f32; at the last step write o (BH,
// T, d) and L (BH, T) instead.
extern "C" int ring_fwd_step_launch(int dtype, int d, const void* q,
                                    const void* kv_slot, void* m, void* l,
                                    void* acc, void* o, void* L,
                                    const void* slopes, int BH, int H, int n,
                                    int Tl, int step, int r0, int nr,
                                    int causal, int window, float scale,
                                    int last, void* stream) {
  Step a{BH, H, n, Tl, step, r0, causal, window, last, scale,
         static_cast<const float*>(slopes)};
  Ptrs p{q, kv_slot, nullptr, nullptr, static_cast<float*>(m),
         static_cast<float*>(l), static_cast<float*>(acc), o,
         static_cast<float*>(L)};
  return dispatch(dtype, d, 0, a, nr, p, stream);
}

// One backward step (K11): dq of every rank's rows against the chunk in
// bundle_slot (n, 4, BH, Tl, d) f32 = (k, v, dk, dv), accumulated in dq_acc
// (BH, T, d) f32 and written to dq at the last step; then the chunk's dk
// and dv in the bundle gain this rank's share.
extern "C" int ring_bwd_step_launch(int dtype, int d, const void* q,
                                    const void* dO, const void* L,
                                    const void* delta, void* bundle_slot,
                                    void* dq_acc, void* dq,
                                    const void* slopes, int BH, int H, int n,
                                    int Tl, int step, int r0, int nr,
                                    int causal, int window, float scale,
                                    int last, void* stream) {
  Step a{BH, H, n, Tl, step, r0, causal, window, last, scale,
         static_cast<const float*>(slopes)};
  Ptrs p{q, dO, static_cast<const float*>(L),
         static_cast<const float*>(delta), static_cast<float*>(bundle_slot),
         static_cast<float*>(dq_acc), nullptr, dq, nullptr};
  return dispatch(dtype, d, 1, a, nr, p, stream);
}
