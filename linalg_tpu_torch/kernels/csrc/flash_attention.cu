// Flash attention, forward and backward, for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernels of
//   linalg_tpu/nn/flash.py:36-106       flash_attention (K2): _fwd_kernel,
//                                       _bwd_kernel, T <= 1024
//   linalg_tpu/nn/flash_long.py:33-119  flash_attention_long (K3):
//                                       _fwd_kernel, _dq_kernel, _dkv_kernel,
//                                       T in (1024, 8192]
//   linalg_tpu/nn/flash_stream.py:114-265  flash_attention_stream (K4):
//                                       _fwd_kernel, _bwd_dkdv_kernel,
//                                       _bwd_dq_kernel, any T, a sliding-
//                                       window band, grouped K/V heads
// All three compute the same math; the TPU splits it three ways only
// because the (T, T) score tile, or the whole K/V, has to fit VMEM. Here
// one family of three kernels serves every entry point:
//
//   forward  O = softmax(scale * Q K^T + causal) V, and the row logsumexp
//            L = m + log(l), f32, shape (B*H, T)
//   dq       P = exp(S - L), dP = dO V^T, dS = (dP - delta) * P,
//            dq = scale * dS K
//   dk/dv    dv = P^T dO, dk = scale * dS^T Q
//
// delta = rowsum(dO * O) is one small f32 pass the caller makes, as K3 does
// outside its kernels. dq and dk/dv are separate kernels, as in K3: each
// output row is owned by one block, so there are no atomics and the
// gradients are deterministic.
//
// The band (K4): query row i sees key j when (not causal or j <= i) and
// (window == 0 or i - j < window); window 0 means no band, and causal 0
// with a window bans only the keys behind it. A query tile walks only the
// key tiles [kstart, kend) that hold a visible key, a key tile only the
// query tiles [qstart, qend) that see it, so windowed attention costs
// O(T * window); the element-wise fill applies to the tiles that cross the
// diagonal or the band's lower edge. A tile can be wholly banned for some
// of a block's rows (the first tile of a band that is not a multiple of
// 64): those rows then take the fill as their running max, and the first
// live tile rescales them by alpha = exp(-1e9 - m) = 0, so nothing of the
// banned tile survives. Every row sees at least its own key, so a live
// tile always comes.
//
// Grouped K/V (K4's GQA): q, o, dO, dq have B*H heads, k, v, dk, dv B*hk,
// with group = H / hk query heads per KV head; blockIdx.y = b*H + h reads
// K/V head blockIdx.y / group = b*hk + h / group, so the expanded K/V never
// exists in memory. dk/dv run one block per (b, KV head, key tile): it
// walks the group's query heads and their live query tiles, sums their
// contributions in the f32 registers it already holds and writes the
// grouped result once, rounded once -- no expanded dk/dv, no group sum
// afterwards, no atomics. (K4 returns per-query-head dk/dv rounded to the
// io dtype and sums them afterwards; the two differ by bf16 rounding.)
//
// Layouts (K7): every head tensor is addressed through its own element
// strides -- per batch, per head, per row -- with the D columns of a row
// contiguous. Contiguous (B, H, T, D) has strides (H T D, T D, D); the
// model's (B, T, H*D) projections (linalg_tpu/nn/flash_btd.py:178
// attention_btd, K7) have (T H D, D, H D): head h is the column slice
// [h D, (h + 1) D) of each row, read and written in place, so K7 needs no
// head transpose on either side. K7 computes K2's function; only the
// layout differs, so it runs these kernels. (The TPU's (8 H, T) broadcast
// rows of L do not carry over: L is (B*H, T) here for every layout.)
//
// Contract: q, o, do, dq hold B*H heads and k, v, dk, dv B*H / group, in
// one dtype (float or bf16), 16-byte aligned, with batch, head and row
// strides that are multiples of 16 bytes; L and delta contiguous (B*H, T)
// float. T % 64 == 0, D in {32, 64, 128, 256}. Scores, the
// running max and normalizer, and every accumulator are f32. The rules of
// the Pallas kernels carry over: masked scores take -1e9 (K4 fills -1e30;
// both give exactly 0 after exp); P is rounded to the io dtype before P V
// and before P^T dO; dS is rounded to the io dtype before dS K and dS^T Q.
// The forward keeps an
// online softmax, so it rounds p~ = exp(s - m_running) where K2 rounds
// p = e / denom; in bf16 the two differ within bf16's rounding, and in f32
// not at all beyond the order of the sums.
//
// What bounds it on this card: arithmetic. At the training shape (B 24,
// H 8, T 1024, d 128) the forward does 2 * B*H * T^2 * d / 2 * 2 = 52 GFLOP
// (causal half) per call against 0.2 GB of q/k/v/o traffic, ~250 flops per
// byte, so the products decide the time and the (T, T) probabilities must
// never go to device memory (the plain version writes 0.8 GB of them per
// call). Every design choice follows from that: each 64 x 64 score, P and
// dS tile lives in registers and shared memory only; a block walks only
// the key (or query) tiles that hold a visible entry -- causal future
// tiles and tiles behind the band are skipped, not computed and masked;
// each 64-row Q/K/V/dO tile is staged in shared memory once per block and
// reused for all its products. At K4's training shape (B 8, H 4, T 4096,
// d 128, window 512) the band leaves ~1/7 of the causal tile pairs.
//
// Two paths, one contract:
//   bf16  tensor cores: mma.sync m16n8k16 (bf16 operands, f32 accumulate),
//         4 warps per 64-row tile, 16 rows per warp. The S/dP accumulators
//         are rearranged in registers into the A operand of the next
//         product (P V, dS K, P^T dO, dS^T Q), rounded to bf16 on the way --
//         exactly the Pallas kernels' .astype(io dtype). Operands that a
//         product needs with the other axis contiguous (V, K, Q, dO as the
//         B operand of a P- or dS-product) get a transposed copy in shared
//         memory. Rows are padded by 8 elements so the 32-bit fragment
//         loads of a warp hit 32 distinct banks.
//   f32   element-wise f32 FMA on the CUDA cores, never TF32 (the TPU's
//         MXU truncation is not carried over): 256 threads as a 16 x 16
//         grid, thread (ty, tx) owns score entries (ty + 16 i, tx + 16 j)
//         and output entries (ty + 16 i, tx + 16 c); rows are padded by one
//         float. A row's 16 owners are half a warp, so row reductions are
//         four xor-shuffles.
// Simple and right first: no cp.async/TMA pipelining, no wgmma, no warp
// specialisation -- that is later perf_opt work. Shared memory per block
// at D 128: bf16 forward 53 KB, dq 88 KB, dk/dv 107 KB; f32 forward
// 116 KB, dq 149 KB, dk/dv 165 KB -- above the 48 KB static limit, so each
// launch raises the kernel's dynamic shared-memory cap first. At D 256 the
// bf16 forward reloads Q's fragments from shared memory per key tile (its
// accumulator alone takes 128 registers), dk/dv runs two 128-column
// slices over a grid dimension, each recomputing its scores, and the f32
// kernels take 32-row tiles to fit shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BM = 64;        // rows per tile (query and key tiles alike)
constexpr float NEG = -1e9f;  // the Pallas kernels' mask fill

// Element strides of one head tensor: per batch, per head, per row.
struct Lay {
  long long b, h, r;
};
// The layouts of every head tensor of a launch; H query heads and hk K/V
// heads per batch.
struct Lays {
  Lay q, k, v, o, dO, dq, dk, dv;
  int H, hk;
};

// Offset of head `bh` (= batch * heads + head) of a tensor of layout `l`.
__device__ __forceinline__ size_t head_at(const Lay& l, int bh, int heads) {
  return (size_t)(bh / heads) * l.b + (size_t)(bh % heads) * l.h;
}

// ===================== bf16: tensor-core tiles =========================

constexpr int MT = 128;      // threads per block: 4 warps x 16 rows
constexpr int TS = BM + 8;   // row stride (elements) of a transposed tile

template <int D> constexpr int RS = D + 8;  // row stride of a row tile

// The fragment helpers (mma, load_a, load_b, pack, acc_to_a, quad_max,
// quad_sum) are mma_bf16.cuh's.

// Rows [0, BM) of a (rows, D) bf16 array of row stride `rs` into shared
// memory (stride RS<D>), 16 bytes a thread, coalesced.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst,
                                          const bf16* __restrict__ src,
                                          long long rs) {
  constexpr int V = D / 8;
  for (int i = threadIdx.x; i < BM * V; i += MT) {
    const int r = i / V, c = (i % V) * 8;
    *reinterpret_cast<uint4*>(dst + r * RS<D> + c) =
        *reinterpret_cast<const uint4*>(src + r * rs + c);
  }
}

// The same rows transposed: dst[c][r] (stride TS). Consecutive threads
// take consecutive rows, so a warp's stores of one column are contiguous.
template <int D>
__device__ __forceinline__ void load_cols(bf16* dst,
                                          const bf16* __restrict__ src,
                                          long long rs) {
  for (int i = threadIdx.x; i < BM * (D / 8); i += MT) {
    const int r = i % BM, c = (i / BM) * 8;
    const uint4 x = *reinterpret_cast<const uint4*>(src + r * rs + c);
    const bf16* e = reinterpret_cast<const bf16*>(&x);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c + j) * TS + r] = e[j];
  }
}

// ===================== the band (causal, window) =======================

// Tiles of B rows (64; the f32 kernels take 32 at d 256).
// query i may not see key j
__device__ __forceinline__ bool banned(int i, int j, int causal,
                                       int window) {
  return (causal && j > i) || (window > 0 && i - j >= window);
}
// the key tiles [key_start, key_end) of query tile qb hold a visible key
template <int B>
__device__ __forceinline__ int key_start(int qb, int window) {
  return window > 0 ? max(0, qb * B - (window - 1)) / B : 0;
}
__device__ __forceinline__ int key_end(int qb, int nt, int causal) {
  return causal ? qb + 1 : nt;
}
// the query tiles [query_start, query_end) of key tile kb see one of its
// keys: the last one's first row still sees the tile's last key
__device__ __forceinline__ int query_start(int kb, int causal) {
  return causal ? kb : 0;
}
template <int B>
__device__ __forceinline__ int query_end(int kb, int nt, int window) {
  return window > 0 ? min(nt, (kb * B + B + window - 2) / B + 1) : nt;
}
// the tile pair holds a banned entry: it crosses the diagonal or the
// band's lower edge, so it takes the element-wise fill
template <int B>
__device__ __forceinline__ bool edge(int qb, int kb, int causal,
                                     int window) {
  return (causal && kb >= qb) ||
         (window > 0 && kb * B <= qb * B + B - 1 - window);
}

template <int D>
__global__ void __launch_bounds__(MT)
    fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o,
             float* __restrict__ L, int Tlen, int causal, int window,
             int group, float scale, const Lays ly) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BM * RS<D>;
  bf16* Vt = Ks + BM * RS<D>;
  const int nt = Tlen / BM;
  const int qb = nt - 1 - blockIdx.x;  // the longest causal rows first
  const int kvh = blockIdx.y / group;
  q += head_at(ly.q, blockIdx.y, ly.H);
  o += head_at(ly.o, blockIdx.y, ly.H);
  k += head_at(ly.k, kvh, ly.hk);
  v += head_at(ly.v, kvh, ly.hk);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;  // the warp's rows in the tile

  load_rows<D>(Qs, q + qb * BM * ly.q.r, ly.q.r);
  __syncthreads();
  // Q's fragments stay in registers up to d 128; at d 256 they would take
  // 64 registers beside the 128 of the accumulator, so they are reloaded
  // from shared memory per key tile
  constexpr bool kQreg = D <= 128;
  uint32_t qa[kQreg ? D / 16 : 1][4];
  if constexpr (kQreg) {
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
      load_a(qa[kc], Qs, RS<D>, r0, kc * 16, g, t);
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 8][4] = {};
  const int kend = key_end(qb, nt, causal);
  for (int kb = key_start<BM>(qb, window); kb < kend; ++kb) {
    __syncthreads();  // the previous tile's K and V are consumed
    load_rows<D>(Ks, k + kb * BM * ly.k.r, ly.k.r);
    load_cols<D>(Vt, v + kb * BM * ly.v.r, ly.v.r);
    __syncthreads();
    float s[BM / 8][4] = {};
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t a[4];
      if constexpr (kQreg) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qa[kc][i];
      } else {
        load_a(a, Qs, RS<D>, r0, kc * 16, g, t);
      }
#pragma unroll
      for (int n = 0; n < BM / 8; ++n) {
        uint32_t b[2];
        load_b(b, Ks, RS<D>, n * 8, kc * 16, g, t);
        mma(s[n], a, b);
      }
    }
    const bool masked = edge<BM>(qb, kb, causal, window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BM / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[n][i] * scale;
        if (masked && banned(qb * BM + r0 + g + 8 * (i >> 1),
                             kb * BM + 8 * n + 2 * t + (i & 1), causal,
                             window))
          x = NEG;
        s[n][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mn = fmaxf(m[h], quad_max(mx[h]));
      // 0 on the first tile, and on the first live tile after a tile
      // wholly banned for this row
      alpha[h] = expf(m[h] - mn);
      m[h] = mn;
    }
#pragma unroll
    for (int n = 0; n < BM / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[n][i] = expf(s[n][i] - m[i >> 1]);
        rs[i >> 1] += s[n][i];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + quad_sum(rs[h]);
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[dn][i] *= alpha[i >> 1];
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s, kk);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        uint32_t b[2];
        load_b(b, Vt, TS, dn * 8, kk * 16, g, t);
        mma(acc[dn], a, b);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = qb * BM + r0 + g + 8 * h;
    const float inv = 1.f / l[h];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(o + r * ly.o.r + dn * 8 + 2 * t) =
          pack(acc[dn][2 * h] * inv, acc[dn][2 * h + 1] * inv);
    if (t == 0) L[(size_t)blockIdx.y * Tlen + r] = m[h] + logf(l[h]);
  }
}

template <int D>
__global__ void __launch_bounds__(MT)
    dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dO,
            const float* __restrict__ L, const float* __restrict__ delta,
            bf16* __restrict__ dq, int Tlen, int causal, int window,
            int group, float scale, const Lays ly) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + BM * RS<D>;
  bf16* Ks = dOs + BM * RS<D>;
  bf16* Vs = Ks + BM * RS<D>;
  bf16* Kt = Vs + BM * RS<D>;
  const int nt = Tlen / BM;
  const int qb = nt - 1 - blockIdx.x;
  const int kvh = blockIdx.y / group;
  q += head_at(ly.q, blockIdx.y, ly.H);
  dO += head_at(ly.dO, blockIdx.y, ly.H);
  dq += head_at(ly.dq, blockIdx.y, ly.H);
  k += head_at(ly.k, kvh, ly.hk);
  v += head_at(ly.v, kvh, ly.hk);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;

  load_rows<D>(Qs, q + qb * BM * ly.q.r, ly.q.r);
  load_rows<D>(dOs, dO + qb * BM * ly.dO.r, ly.dO.r);
  float Lr[2], dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t r = (size_t)blockIdx.y * Tlen + qb * BM + r0 + g + 8 * h;
    Lr[h] = L[r];
    dr[h] = delta[r];
  }
  float acc[D / 8][4] = {};
  const int kend = key_end(qb, nt, causal);
  for (int kb = key_start<BM>(qb, window); kb < kend; ++kb) {
    __syncthreads();
    load_rows<D>(Ks, k + kb * BM * ly.k.r, ly.k.r);
    load_rows<D>(Vs, v + kb * BM * ly.v.r, ly.v.r);
    load_cols<D>(Kt, k + kb * BM * ly.k.r, ly.k.r);
    __syncthreads();
    float s[BM / 8][4] = {}, dp[BM / 8][4] = {};
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t a[4], c[4];
      load_a(a, Qs, RS<D>, r0, kc * 16, g, t);
      load_a(c, dOs, RS<D>, r0, kc * 16, g, t);
#pragma unroll
      for (int n = 0; n < BM / 8; ++n) {
        uint32_t b[2];
        load_b(b, Ks, RS<D>, n * 8, kc * 16, g, t);
        mma(s[n], a, b);
        load_b(b, Vs, RS<D>, n * 8, kc * 16, g, t);
        mma(dp[n], c, b);
      }
    }
    const bool masked = edge<BM>(qb, kb, causal, window);
#pragma unroll
    for (int n = 0; n < BM / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[n][i] * scale;
        if (masked && banned(qb * BM + r0 + g + 8 * (i >> 1),
                             kb * BM + 8 * n + 2 * t + (i & 1), causal,
                             window))
          x = NEG;
        const float p = expf(x - Lr[i >> 1]);
        s[n][i] = (dp[n][i] - dr[i >> 1]) * p;  // dS
      }
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s, kk);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        uint32_t b[2];
        load_b(b, Kt, TS, dn * 8, kk * 16, g, t);
        mma(acc[dn], a, b);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = qb * BM + r0 + g + 8 * h;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(dq + r * ly.dq.r + dn * 8 + 2 * t) =
          pack(scale * acc[dn][2 * h], scale * acc[dn][2 * h + 1]);
  }
}

// One block per (KV head, key tile kb, column slice), blockIdx.y = b*hk +
// kv head; it walks the group's query heads and their live query tiles.
// Warp rows are keys, accumulator columns queries (the transposed scores
// S^T = K Q^T). The block accumulates the DC columns [c0, c0 + DC) of dk
// and dv, blockIdx.z = c0 / DC: at d 256 the two accumulators of all 256
// columns would take 256 registers, so two slices each recompute the
// scores.
template <int D, int DC>
__global__ void __launch_bounds__(MT)
    dkdv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dO,
              const float* __restrict__ L, const float* __restrict__ delta,
              bf16* __restrict__ dk, bf16* __restrict__ dv, int Tlen,
              int causal, int window, int group, float scale,
              const Lays ly) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BM * RS<D>;
  bf16* Qs = Vs + BM * RS<D>;
  bf16* dOs = Qs + BM * RS<D>;
  bf16* Qt = dOs + BM * RS<D>;
  bf16* dOt = Qt + DC * TS;
  float* Ls = reinterpret_cast<float*>(dOt + DC * TS);
  float* Ds = Ls + BM;
  const int nt = Tlen / BM;
  const int kb = blockIdx.x;  // low key tiles see the most query tiles
  const int c0 = blockIdx.z * DC;
  k += head_at(ly.k, blockIdx.y, ly.hk);
  v += head_at(ly.v, blockIdx.y, ly.hk);
  dk += head_at(ly.dk, blockIdx.y, ly.hk);
  dv += head_at(ly.dv, blockIdx.y, ly.hk);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;

  load_rows<D>(Ks, k + kb * BM * ly.k.r, ly.k.r);
  load_rows<D>(Vs, v + kb * BM * ly.v.r, ly.v.r);
  float accv[DC / 8][4] = {}, acck[DC / 8][4] = {};
  const int qstart = query_start(kb, causal);
  const int nq = query_end<BM>(kb, nt, window) - qstart;
  for (int it = 0; it < group * nq; ++it) {
    const int qh = blockIdx.y * group + it / nq;  // query head b*H + h
    const int qb = qstart + it % nq;
    __syncthreads();
    const bf16* qt = q + head_at(ly.q, qh, ly.H) + qb * BM * ly.q.r;
    const bf16* dot = dO + head_at(ly.dO, qh, ly.H) + qb * BM * ly.dO.r;
    load_rows<D>(Qs, qt, ly.q.r);
    load_rows<D>(dOs, dot, ly.dO.r);
    load_cols<DC>(Qt, qt + c0, ly.q.r);
    load_cols<DC>(dOt, dot + c0, ly.dO.r);
    if (threadIdx.x < BM) {
      const size_t r = (size_t)qh * Tlen + qb * BM + threadIdx.x;
      Ls[threadIdx.x] = L[r];
      Ds[threadIdx.x] = delta[r];
    }
    __syncthreads();
    float st[BM / 8][4] = {}, dpt[BM / 8][4] = {};
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t a[4], c[4];
      load_a(a, Ks, RS<D>, r0, kc * 16, g, t);
      load_a(c, Vs, RS<D>, r0, kc * 16, g, t);
#pragma unroll
      for (int n = 0; n < BM / 8; ++n) {
        uint32_t b[2];
        load_b(b, Qs, RS<D>, n * 8, kc * 16, g, t);
        mma(st[n], a, b);
        load_b(b, dOs, RS<D>, n * 8, kc * 16, g, t);
        mma(dpt[n], c, b);
      }
    }
    const bool masked = edge<BM>(qb, kb, causal, window);
#pragma unroll
    for (int n = 0; n < BM / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = 8 * n + 2 * t + (i & 1);  // query in the tile
        float x = st[n][i] * scale;
        // the query row is the column here, the key the row
        if (masked && banned(qb * BM + col, kb * BM + r0 + g + 8 * (i >> 1),
                             causal, window))
          x = NEG;
        const float p = expf(x - Ls[col]);
        st[n][i] = p;
        dpt[n][i] = (dpt[n][i] - Ds[col]) * p;  // dS^T
      }
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      uint32_t pa[4], da[4];
      acc_to_a(pa, st, kk);
      acc_to_a(da, dpt, kk);
#pragma unroll
      for (int dn = 0; dn < DC / 8; ++dn) {
        uint32_t b[2];
        load_b(b, dOt, TS, dn * 8, kk * 16, g, t);
        mma(accv[dn], pa, b);
        load_b(b, Qt, TS, dn * 8, kk * 16, g, t);
        mma(acck[dn], da, b);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long r = (long long)kb * BM + r0 + g + 8 * h;
#pragma unroll
    for (int dn = 0; dn < DC / 8; ++dn) {
      const int c = c0 + dn * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dv + r * ly.dv.r + c) =
          pack(accv[dn][2 * h], accv[dn][2 * h + 1]);
      *reinterpret_cast<uint32_t*>(dk + r * ly.dk.r + c) =
          pack(scale * acck[dn][2 * h], scale * acck[dn][2 * h + 1]);
    }
  }
}

// ===================== f32: element-wise FMA ===========================

// Tiles of BR rows: 64, or 32 at d 256, where six 64-row f32 tiles would
// not fit the 227 KB of shared memory a block can have. Thread (ty, tx)
// owns rows ty + 16 i, i < BR / 16.
constexpr int NT = 256;  // threads per block: a 16 x 16 grid

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

// Rows [0, BR) of a (rows, D) array of row stride `rs` into shared
// memory, row stride D + 1.
template <int D, int BR>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          long long rs) {
  for (int i = threadIdx.x; i < BR * D; i += NT)
    dst[(i / D) * (D + 1) + i % D] = src[(i / D) * rs + i % D];
}

// acc[i][j] += sum_e A[(ty + 16 i)][e] * B[(tx + 16 j)][e] over two tiles
// of stride D + 1: the score products Q K^T, dO V^T and their transposes.
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

template <int D, int BR>
__global__ void __launch_bounds__(NT)
    fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ o,
            float* __restrict__ L, int Tlen, int causal, int window,
            int group, float scale, const Lays ly) {
  extern __shared__ float smem[];
  constexpr int R = BR / 16, S = D + 1, PS = BR + 1;
  float* Qs = smem;
  float* Ks = Qs + BR * S;
  float* Vs = Ks + BR * S;
  float* Ps = Vs + BR * S;
  const int nt = Tlen / BR;
  const int qb = nt - 1 - blockIdx.x;
  const int kvh = blockIdx.y / group;
  q += head_at(ly.q, blockIdx.y, ly.H);
  o += head_at(ly.o, blockIdx.y, ly.H);
  k += head_at(ly.k, kvh, ly.hk);
  v += head_at(ly.v, kvh, ly.hk);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<D, BR>(Qs, q + qb * BR * ly.q.r, ly.q.r);
  float m[R], l[R], acc[R][D / 16];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  }
  const int kend = key_end(qb, nt, causal);
  for (int kb = key_start<BR>(qb, window); kb < kend; ++kb) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tile<D, BR>(Ks, k + kb * BR * ly.k.r, ly.k.r);
    load_tile<D, BR>(Vs, v + kb * BR * ly.v.r, ly.v.r);
    __syncthreads();
    float s[R][R] = {};
    tile_dot<D, R>(s, Qs, Ks, ty, tx);
    const bool masked = edge<BR>(qb, kb, causal, window);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s[i][j] *= scale;
        if (masked && banned(qb * BR + ty + 16 * i, kb * BR + tx + 16 * j,
                             causal, window))
          s[i][j] = NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      const float mn = fmaxf(m[i], row_max(mx));
      // 0 on the first tile, and on the first live tile after a tile
      // wholly banned for this row
      const float alpha = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float p = expf(s[i][j] - mn);
        rs += p;
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // P complete
    tile_mul<D, BR>(acc, Ps, Vs, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = qb * BR + ty + 16 * i;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      o[r * ly.o.r + tx + 16 * c] = acc[i][c] * inv;
    if (tx == 0) L[(size_t)blockIdx.y * Tlen + r] = m[i] + logf(l[i]);
  }
}

template <int D, int BR>
__global__ void __launch_bounds__(NT)
    dq_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dO,
           const float* __restrict__ L, const float* __restrict__ delta,
           float* __restrict__ dq, int Tlen, int causal, int window,
           int group, float scale, const Lays ly) {
  extern __shared__ float smem[];
  constexpr int R = BR / 16, S = D + 1, PS = BR + 1;
  float* Qs = smem;
  float* dOs = Qs + BR * S;
  float* Ks = dOs + BR * S;
  float* Vs = Ks + BR * S;
  float* dSs = Vs + BR * S;
  const int nt = Tlen / BR;
  const int qb = nt - 1 - blockIdx.x;
  const int kvh = blockIdx.y / group;
  q += head_at(ly.q, blockIdx.y, ly.H);
  dO += head_at(ly.dO, blockIdx.y, ly.H);
  dq += head_at(ly.dq, blockIdx.y, ly.H);
  k += head_at(ly.k, kvh, ly.hk);
  v += head_at(ly.v, kvh, ly.hk);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<D, BR>(Qs, q + qb * BR * ly.q.r, ly.q.r);
  load_tile<D, BR>(dOs, dO + qb * BR * ly.dO.r, ly.dO.r);
  float Lr[R], dr[R], acc[R][D / 16];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const size_t r = (size_t)blockIdx.y * Tlen + qb * BR + ty + 16 * i;
    Lr[i] = L[r];
    dr[i] = delta[r];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  }
  const int kend = key_end(qb, nt, causal);
  for (int kb = key_start<BR>(qb, window); kb < kend; ++kb) {
    __syncthreads();
    load_tile<D, BR>(Ks, k + kb * BR * ly.k.r, ly.k.r);
    load_tile<D, BR>(Vs, v + kb * BR * ly.v.r, ly.v.r);
    __syncthreads();
    float s[R][R] = {}, dp[R][R] = {};
    tile_dot<D, R>(s, Qs, Ks, ty, tx);
    tile_dot<D, R>(dp, dOs, Vs, ty, tx);
    const bool masked = edge<BR>(qb, kb, causal, window);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        float sv = s[i][j] * scale;
        if (masked && banned(qb * BR + ty + 16 * i, kb * BR + tx + 16 * j,
                             causal, window))
          sv = NEG;
        const float p = expf(sv - Lr[i]);
        dSs[(ty + 16 * i) * PS + tx + 16 * j] = (dp[i][j] - dr[i]) * p;
      }
    __syncthreads();
    tile_mul<D, BR>(acc, dSs, Ks, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = qb * BR + ty + 16 * i;
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      dq[r * ly.dq.r + tx + 16 * c] = scale * acc[i][c];
  }
}

// One block per (KV head, key tile kb), walking the group's query heads
// and their live query tiles. Thread (ty, tx) owns the transposed score
// entries (key ty + 16 i, query tx + 16 j) and the dk/dv entries
// (key ty + 16 i, column tx + 16 c).
template <int D, int BR>
__global__ void __launch_bounds__(NT)
    dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dO,
             const float* __restrict__ L, const float* __restrict__ delta,
             float* __restrict__ dk, float* __restrict__ dv, int Tlen,
             int causal, int window, int group, float scale,
             const Lays ly) {
  extern __shared__ float smem[];
  constexpr int R = BR / 16, S = D + 1, PS = BR + 1;
  float* Ks = smem;
  float* Vs = Ks + BR * S;
  float* Qs = Vs + BR * S;
  float* dOs = Qs + BR * S;
  float* Pt = dOs + BR * S;
  float* dSt = Pt + BR * PS;
  const int nt = Tlen / BR;
  const int kb = blockIdx.x;
  k += head_at(ly.k, blockIdx.y, ly.hk);
  v += head_at(ly.v, blockIdx.y, ly.hk);
  dk += head_at(ly.dk, blockIdx.y, ly.hk);
  dv += head_at(ly.dv, blockIdx.y, ly.hk);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<D, BR>(Ks, k + kb * BR * ly.k.r, ly.k.r);
  load_tile<D, BR>(Vs, v + kb * BR * ly.v.r, ly.v.r);
  float accv[R][D / 16], acck[R][D / 16];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) accv[i][c] = acck[i][c] = 0.f;
  const int qstart = query_start(kb, causal);
  const int nq = query_end<BR>(kb, nt, window) - qstart;
  for (int it = 0; it < group * nq; ++it) {
    const int qh = blockIdx.y * group + it / nq;  // query head b*H + h
    const int qb = qstart + it % nq;
    __syncthreads();
    load_tile<D, BR>(Qs, q + head_at(ly.q, qh, ly.H) + qb * BR * ly.q.r,
                     ly.q.r);
    load_tile<D, BR>(dOs, dO + head_at(ly.dO, qh, ly.H) + qb * BR * ly.dO.r,
                     ly.dO.r);
    float Lq[R], dq_[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const size_t r = (size_t)qh * Tlen + qb * BR + tx + 16 * j;
      Lq[j] = L[r];
      dq_[j] = delta[r];
    }
    __syncthreads();
    float st[R][R] = {}, dpt[R][R] = {};
    tile_dot<D, R>(st, Ks, Qs, ty, tx);
    tile_dot<D, R>(dpt, Vs, dOs, ty, tx);
    const bool masked = edge<BR>(qb, kb, causal, window);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        float sv = st[i][j] * scale;
        if (masked && banned(qb * BR + tx + 16 * j, kb * BR + ty + 16 * i,
                             causal, window))
          sv = NEG;
        const float p = expf(sv - Lq[j]);
        Pt[(ty + 16 * i) * PS + tx + 16 * j] = p;
        dSt[(ty + 16 * i) * PS + tx + 16 * j] = (dpt[i][j] - dq_[j]) * p;
      }
    __syncthreads();
    tile_mul<D, BR>(accv, Pt, dOs, ty, tx);
    tile_mul<D, BR>(acck, dSt, Qs, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const long long r = (long long)kb * BR + ty + 16 * i;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      dv[r * ly.dv.r + tx + 16 * c] = accv[i][c];
      dk[r * ly.dk.r + tx + 16 * c] = scale * acck[i][c];
    }
  }
}

// ===================== launch =========================================

struct Args {
  const void *q, *k, *v, *dO;
  const float *L, *delta;
  void *out0, *out1;
  float* L_out;
  int BH, T, causal, window, group;  // BH counts query heads
  float scale;
  cudaStream_t stream;
  Lays ly;
};

// Raise the kernel's dynamic shared-memory cap to `smem` where it is over
// the 48 KB default (a launch over the cap is refused and never runs),
// launch it on the (T / tile, rows, slices) grid, and return the launch's
// error.
template <typename... P, typename... A>
int launch(void (*kern)(P...), int threads, size_t smem, int tile,
           dim3 rows, const Args& a, A... args) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<dim3(a.T / tile, rows.x, rows.y), threads, smem, a.stream>>>(
      args...);
  return (int)cudaGetLastError();
}

// shared-memory bytes: bf16 row tiles, bf16 transposed tiles of `width`
// columns, f32 floats
constexpr size_t bf16_smem(int D, int rows, int cols, int width,
                           int floats) {
  return ((size_t)rows * BM * (D + 8) + (size_t)cols * width * TS) * 2 +
         (size_t)floats * 4;
}
constexpr size_t f32_smem(int D, int BR, int tiles, int scores) {
  return ((size_t)tiles * BR * (D + 1) + (size_t)scores * BR * (BR + 1)) *
         4;
}

// which: 0 forward, 1 dq (grid rows: query heads), 2 dk/dv (KV heads; at
// d 256 two column slices)
template <int D>
int run_bf16(int which, const Args& a) {
  constexpr int DC = D == 256 ? 128 : D;
  auto in = [](const void* p) { return static_cast<const bf16*>(p); };
  auto out = [](void* p) { return static_cast<bf16*>(p); };
  switch (which) {
    case 0:
      return launch(fwd_bf16<D>, MT, bf16_smem(D, 2, 1, D, 0), BM,
                    dim3(a.BH, 1), a, in(a.q), in(a.k), in(a.v),
                    out(a.out0), a.L_out, a.T, a.causal, a.window, a.group,
                    a.scale, a.ly);
    case 1:
      return launch(dq_bf16<D>, MT, bf16_smem(D, 4, 1, D, 0), BM,
                    dim3(a.BH, 1), a, in(a.q), in(a.k), in(a.v), in(a.dO),
                    a.L, a.delta, out(a.out0), a.T, a.causal, a.window,
                    a.group, a.scale, a.ly);
    case 2:
      return launch(dkdv_bf16<D, DC>, MT, bf16_smem(D, 4, 2, DC, 2 * BM),
                    BM, dim3(a.BH / a.group, D / DC), a, in(a.q), in(a.k),
                    in(a.v), in(a.dO), a.L, a.delta, out(a.out0),
                    out(a.out1), a.T, a.causal, a.window, a.group, a.scale,
                    a.ly);
    default:
      return -1;
  }
}

template <int D>
int run_f32(int which, const Args& a) {
  constexpr int BR = D == 256 ? 32 : BM;
  auto in = [](const void* p) { return static_cast<const float*>(p); };
  auto out = [](void* p) { return static_cast<float*>(p); };
  switch (which) {
    case 0:
      return launch(fwd_f32<D, BR>, NT, f32_smem(D, BR, 3, 1), BR,
                    dim3(a.BH, 1), a, in(a.q), in(a.k), in(a.v),
                    out(a.out0), a.L_out, a.T, a.causal, a.window, a.group,
                    a.scale, a.ly);
    case 1:
      return launch(dq_f32<D, BR>, NT, f32_smem(D, BR, 4, 1), BR,
                    dim3(a.BH, 1), a, in(a.q), in(a.k), in(a.v), in(a.dO),
                    a.L, a.delta, out(a.out0), a.T, a.causal, a.window,
                    a.group, a.scale, a.ly);
    case 2:
      return launch(dkdv_f32<D, BR>, NT, f32_smem(D, BR, 4, 2), BR,
                    dim3(a.BH / a.group, 1), a, in(a.q), in(a.k), in(a.v),
                    in(a.dO), a.L, a.delta, out(a.out0), out(a.out1), a.T,
                    a.causal, a.window, a.group, a.scale, a.ly);
    default:
      return -1;
  }
}

template <int D>
int run(int dtype, int which, const Args& a) {
  if (dtype == 0) return run_f32<D>(which, a);
  if (dtype == 1) return run_bf16<D>(which, a);
  return -1;
}

int dispatch(int dtype, int d, int which, Args& a, int B, int H,
             const long long* strides) {
  if (a.T <= 0 || a.T % BM || B <= 0 || H <= 0 || B * H > 65535 ||
      a.window < 0 || a.group < 1 || H % a.group)
    return -1;
  a.BH = B * H;
  Lay* lay[] = {&a.ly.q, &a.ly.k, &a.ly.v, &a.ly.o,
                &a.ly.dO, &a.ly.dq, &a.ly.dk, &a.ly.dv};
  for (int i = 0; i < 8; ++i)
    *lay[i] = Lay{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.ly.H = H;
  a.ly.hk = H / a.group;
  switch (d) {
    case 32: return run<32>(dtype, which, a);
    case 64: return run<64>(dtype, which, a);
    case 128: return run<128>(dtype, which, a);
    case 256: return run<256>(dtype, which, a);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. B batches of H query heads; k and v
// hold H / group heads per batch. window 0 means no band. `strides` holds
// the (batch, head, row) element strides of q, k, v, o, dO, dq, dk, dv in
// that order (24 values; those of tensors a launch does not take are not
// read). Each returns 0 on success, -1 for an unsupported dtype, d or
// shape, else the cudaError_t of the launch.

// o = attention(q, k, v); L = its row logsumexp (f32, (B*H, T)).
extern "C" int flash_fwd_launch(int dtype, int d, const void* q,
                                const void* k, const void* v, void* o,
                                void* L, int B, int H, int T, int causal,
                                int window, int group, float scale,
                                const long long* strides, void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, o, nullptr,
         static_cast<float*>(L), 0, T, causal, window, group, scale,
         static_cast<cudaStream_t>(stream), {}};
  return dispatch(dtype, d, 0, a, B, H, strides);
}

// dq from q, k, v, dO, L and delta = rowsum(dO * O) (f32, (B*H, T)).
extern "C" int flash_dq_launch(int dtype, int d, const void* q, const void* k,
                               const void* v, const void* dO, const void* L,
                               const void* delta, void* dq, int B, int H,
                               int T, int causal, int window, int group,
                               float scale, const long long* strides,
                               void* stream) {
  Args a{q, k, v, dO, static_cast<const float*>(L),
         static_cast<const float*>(delta), dq, nullptr, nullptr, 0, T,
         causal, window, group, scale, static_cast<cudaStream_t>(stream),
         {}};
  return dispatch(dtype, d, 1, a, B, H, strides);
}

// dk and dv (H / group heads per batch, each summed over its group) from
// the same inputs.
extern "C" int flash_dkdv_launch(int dtype, int d, const void* q,
                                 const void* k, const void* v, const void* dO,
                                 const void* L, const void* delta, void* dk,
                                 void* dv, int B, int H, int T, int causal,
                                 int window, int group, float scale,
                                 const long long* strides, void* stream) {
  Args a{q, k, v, dO, static_cast<const float*>(L),
         static_cast<const float*>(delta), dk, dv, nullptr, 0, T, causal,
         window, group, scale, static_cast<cudaStream_t>(stream), {}};
  return dispatch(dtype, d, 2, a, B, H, strides);
}
