// Fused LayerNorm + projections, forward and backward, for Hopper
// (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of
//   linalg_tpu/nn/fused_layer.py:166  ln_qkv (K8): _ln_qkv_fwd_kernel,
//                                     _ln_qkv_bwd_kernel
//   linalg_tpu/nn/fused_layer.py:312  ln_ffn (K9): _ln_ffn_fwd_kernel,
//                                     _ln_ffn_chunk_bwd_kernel
//
//   ln_qkv   x^ = LN(x) (f32 statistics, eps 1e-5) rounded to the io dtype;
//            q, k, v = x^ Wq, x^ Wk, x^ Wv (f32 accumulation)
//   ln_ffn   z = x^ W1 + b1, a = relu(z) rounded, f = a W2 + b2
//   backward the LN is recomputed from x (nothing beyond the inputs is
//            saved from the forward); dW = x^T dy, dxn = sum dy W^T,
//            dz = (z > 0) * df W2^T rounded, dW1 = x^T dz, dW2 = a^T df,
//            db1 = colsum(dz in f32), dxn = dz W1^T, and the closed-form
//            LN backward dx = (g dxn - mean(g dxn) - x^ mean(g dxn x^)) rstd,
//            dg = colsum(dxn x^), db = colsum(dxn), all from f32 dxn.
//
// Rounding follows the Pallas kernels: x^ to the io dtype before each
// product, relu(z) and dz to the io dtype, every product accumulated in
// f32, weight gradients summed in f32 and rounded once by the caller.
//
// What bounds it on this card: at the published width (N 16384 = B 64 x T
// 256, D 512, F 2048) the forward products are 25.8 GFLOP (K8) and 68.7
// GFLOP (K9), the backward twice that, against 67 MB and 42 MB of bf16
// inputs and outputs: in bf16 the tensor cores decide (0.078 and 0.21 ms
// fwd+bwd at 989 TFLOP/s), in f32 the FMA units (1.15 and 3.08 ms at 67
// TFLOP/s). So every product has to run on wgmma in bf16, and nothing may
// be recomputed: K9's forward keeps its (N, F) hidden on the chip and
// computes it once per row, not once per output-column block.
//
// bf16 (Hopper's warpgroup products, fed by the TMA). Every block is two
// consumer warpgroups, each owning 64 rows, and one thread that keeps
// tiles in flight through a ring of shared-memory slots guarded by full
// and empty mbarriers (the traps of wgmma_bf16.cuh's mbar_wait turn a
// protocol fault into a failed launch): in K8's forward and the backward
// GEMM the one active thread of a producer warpgroup, which hands its
// registers to the consumers (setmaxnreg 40 / 232); in K9's forward,
// whose accumulators need more registers than a 384-thread block is
// compiled to, thread 0 of the consumers.
//   K8 forward   block = 128 rows x 64 columns of each of q, k, v. A slot
//                holds the x tile (128 x 64, as it lies) and the Wq, Wk,
//                Wv tiles (64 x 64). Each consumer thread reads its A
//                fragments of x from the swizzled tile, applies the
//                LayerNorm in f32 (row mean and rstd in registers, g and b
//                per column from global memory, L1-resident), rounds to
//                bf16 and issues
//                wgmma_rs three times -- q, k and v are three B operands
//                on one register A tile, so x^ is formed once per k-step.
//   K9 forward   block = 64 rows x up to 512 output columns (D <= 512: the
//                whole row, so z = x^ W1 is computed once per row; D 1024:
//                twice; D: ceil(D / 512) times). Up to D 1024 the x tile
//                (64 x D) arrives once and is normalised in place in
//                shared memory (x^ is reused by all F / 128 hidden chunks,
//                so it is formed once rather than per chunk); wider rows
//                do not fit, so x is streamed instead, each 128-column x
//                tile in the slot of the W1 tile it meets and normalised
//                there (x^ formed F / 128 times, x read from L2 as often:
//                at D 2048, F 8192 that adds half to the W1 traffic).
//                Per hidden chunk of 128: each warpgroup
//                computes its 64 columns of z = x^ W1[:, chunk] (wgmma,
//                W1 streamed MN-major), rounds a = relu(z + b1) into a
//                swizzled A tile in shared memory (two buffers), and after
//                a named barrier both warpgroups multiply the whole 64 x
//                128 a tile into their own 64 x 256 output accumulator
//                (W2 streamed MN-major in 32-row tiles). Neither x^ nor
//                the hidden reaches device memory. Each 64-row block
//                streams all of W1 and W2 from L2 (4 MB at the published
//                width), so L2 bandwidth bounds it before the tensor
//                cores do.
//   backward     the statistics pass writes x^ once (N x D, io dtype: 16
//                MB at the published width) beside (mean, rstd); every
//                backward product is then one TMA-fed wgmma GEMM template
//                (gemm_bf16): 128 x 128 tiles, a 4-slot ring, A and B each
//                K-major or MN-major (the transpose bits, never a copied
//                transpose), with three epilogues: f32 dxn (K8's sums
//                three products into one accumulator), f32 split partials
//                of the weight gradients, and K9's dz step, whose two
//                products z = x^ W1 and da = df W2^T end in the relu and
//                mask, a and dz stored rounded (N x F, scratch) and the
//                db1 column partials of f32 dz. Rows past N arrive as
//                zeros and are never stored.
// f32 (element-wise FMA on the CUDA cores, never TF32, as the plain
// versions and the flash kernels' f32 path): one SIMT GEMM template, 128
// x 128 tiles (64 x 128 for the dz step), 256 threads each owning an 8 x 8
// (4 x 8) register tile, 16-deep k-slices double-buffered through
// registers, staged with 16-byte coalesced loads (operands whose
// contraction runs along a row are transposed on the way into shared
// memory, so the inner loop reads four 16-byte vectors per 64 FMAs); the
// K8 forward applies the LayerNorm while staging x. K9's f32 forward
// keeps the once-per-row structure on the CUDA cores: 32 rows x 512
// output columns a block, 128-wide hidden chunks.
//
// The LN backward passes stay separate kernels with 16-byte loads, each
// reading the f32 dxn once: dx one warp a row, the dg/db partials one
// block per 32 columns and row split.
//
// Cross-row sums (dW, dg, db, db1): the TPU accumulates them across its
// sequential grid. Blocks here run in parallel and in no order, so the
// rows are cut into fixed groups (S splits for dW, dg and db; 64-row tiles
// for db1, as the dz step's epilogue owns them), each group writes an f32
// partial, and the caller sums the partials in a fixed order. No float
// atomics: two runs give the same bits.
//
// Contract: x (N, D), W (D, D), W1 (D, F), W2 (F, D), all contiguous, one
// dtype; N % 64 == 0, D % 128 == 0, F % 128 == 0.
//
// Shared memory and registers per instantiation (-Xptxas -v on the H100;
// no stack frame, no spill anywhere): bf16 K8 forward 4 slots x 40 KB, 161
// KB at any D, 168 registers (384 threads); K9 forward (256 threads)
// resident x^ 128 D bytes + 2 x 16 KB a buffers + 4 (D 512) or 2 (D 1024)
// slots x 32 KB, 231 KB either way, 212 registers; streamed 4 slots x 48
// KB + the a buffers, 231 KB, 219 registers; gemm_bf16 4 slots x 32 KB +
// 4 KB of db1 sums, 136 KB, 168 registers; f32 GEMM 34 KB static (26 KB
// for dz's 64-row tiles), 125-153 registers; f32 K9 forward 62 KB, 127
// registers; the LN passes 32-40 registers.

#include <cuda.h>  // CUtensorMap and its enums only: nothing links libcuda
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float EPS = 1e-5f;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- 16-byte vectors: 8 bf16 or 4 floats ----

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int n = 4; };
template <> struct Vec<bf16> { static constexpr int n = 8; };

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[Vec<T>::n]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  if constexpr (sizeof(T) == 4) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  } else {
    const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(h[i]);
  }
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[Vec<T>::n]) {
  uint4 u;
  if constexpr (sizeof(T) == 4) {
    u = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                   __float_as_uint(v[2]), __float_as_uint(v[3]));
  } else {
    u = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                   pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
  }
  *reinterpret_cast<uint4*>(p) = u;
}

// four consecutive elements as floats (8 bytes of bf16, 16 of f32)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// the LayerNorm of one element, before rounding
__device__ __forceinline__ float ln1(float x, float mu, float rs, float g,
                                     float b) {
  return fmaf((x - mu) * rs, g, b);
}

// ===================== the LayerNorm passes ============================

// Per-row (mean, rstd) of x (N, D): one warp a row, two passes in f32 over
// 16-byte vectors. With `xhat`, also writes x^ = LN(x) rounded to the io
// dtype (the backward's operand).
template <typename T>
__global__ void __launch_bounds__(256)
    ln_stats(const T* __restrict__ x, const T* __restrict__ g,
             const T* __restrict__ b, float2* __restrict__ stats,
             T* __restrict__ xhat, int N, int D) {
  constexpr int V = Vec<T>::n;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= N) return;
  const T* xr = x + (size_t)row * D;
  float s = 0.f;
  for (int c = lane * V; c < D; c += 32 * V) {
    float v[V];
    load_vec(xr + c, v);
#pragma unroll
    for (int i = 0; i < V; ++i) s += v[i];
  }
  const float mu = warp_sum(s) / D;
  float q = 0.f;
  for (int c = lane * V; c < D; c += 32 * V) {
    float v[V];
    load_vec(xr + c, v);
#pragma unroll
    for (int i = 0; i < V; ++i) q += (v[i] - mu) * (v[i] - mu);
  }
  const float rs = 1.f / sqrtf(warp_sum(q) / D + EPS);
  if (lane == 0) stats[row] = make_float2(mu, rs);
  if (xhat == nullptr) return;
  for (int c = lane * V; c < D; c += 32 * V) {
    float v[V], gv[V], bv[V];
    load_vec(xr + c, v);
    load_vec(g + c, gv);
    load_vec(b + c, bv);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = ln1(v[i], mu, rs, gv[i], bv[i]);
    store_vec(xhat + (size_t)row * D + c, v);
  }
}

// dx of the LayerNorm from f32 dxn: one warp a row, 16-byte vectors of x
// and g (4 floats of dxn per 4 elements).
template <typename T>
__global__ void __launch_bounds__(256)
    ln_bwd_dx(const T* __restrict__ x, const float2* __restrict__ stats,
              const T* __restrict__ g, const float* __restrict__ dxn,
              T* __restrict__ dx, int N, int D) {
  constexpr int V = Vec<T>::n;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= N) return;
  const float2 st = stats[row];
  const T* xr = x + (size_t)row * D;
  const float* dr = dxn + (size_t)row * D;
  float m1 = 0.f, m2 = 0.f;
  for (int c = lane * V; c < D; c += 32 * V) {
    float xv[V], gv[V];
    load_vec(xr + c, xv);
    load_vec(g + c, gv);
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 d = load4(dr + c + i);
      const float dd[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float gh = dd[e] * gv[i + e];
        m1 += gh;
        m2 += gh * ((xv[i + e] - st.x) * st.y);
      }
    }
  }
  m1 = warp_sum(m1) / D;
  m2 = warp_sum(m2) / D;
  for (int c = lane * V; c < D; c += 32 * V) {
    float xv[V], gv[V], out[V];
    load_vec(xr + c, xv);
    load_vec(g + c, gv);
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 d = load4(dr + c + i);
      const float dd[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float xh = (xv[i + e] - st.x) * st.y;
        out[i + e] = (dd[e] * gv[i + e] - m1 - xh * m2) * st.y;
      }
    }
    store_vec(dx + (size_t)row * D + c, out);
  }
}

// The f32 partials of dg = colsum(dxn x^) and db = colsum(dxn) over the
// rows [s rows, (s + 1) rows) of split s = blockIdx.y, for 32 columns: part
// (S, 2, D). 8 threads x 4 columns by 128 row lanes (the grid is only D /
// 32 x S blocks: 128 at D 512, so each block brings many loads in flight),
// each lane's sums reduced in a fixed order.
template <typename T>
__global__ void __launch_bounds__(1024)
    ln_bwd_dgb(const T* __restrict__ x, const float2* __restrict__ stats,
               const float* __restrict__ dxn, float* __restrict__ part,
               int N, int D, int rows) {
  __shared__ float red[2][128][33];
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const int c = blockIdx.x * 32 + 4 * tx;
  const int rend = min(N, ((int)blockIdx.y + 1) * rows);
  float sg[4] = {0.f, 0.f, 0.f, 0.f}, sb[4] = {0.f, 0.f, 0.f, 0.f};
  for (int r = blockIdx.y * rows + ty; r < rend; r += 128) {
    const float2 st = stats[r];
    const float4 d = load4(dxn + (size_t)r * D + c);
    const float4 xv = load4(x + (size_t)r * D + c);
    const float dd[4] = {d.x, d.y, d.z, d.w}, xx[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sg[e] += dd[e] * ((xx[e] - st.x) * st.y);
      sb[e] += dd[e];
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    red[0][ty][4 * tx + e] = sg[e];
    red[1][ty][4 * tx + e] = sb[e];
  }
  __syncthreads();
  if (threadIdx.x >= 64) return;
  const int w = threadIdx.x >> 5, col = threadIdx.x & 31;
  float s = 0.f;
  for (int i = 0; i < 128; ++i) s += red[w][i][col];
  part[((size_t)blockIdx.y * 2 + w) * D + blockIdx.x * 32 + col] = s;
}

// ===================== bf16: wgmma fed by the TMA ======================

// Descriptor of a K-major operand tile (rows of 128 bytes, boxes of 64
// columns `box` bytes apart): k-step ks (16 columns) of the tile at t.
__device__ __forceinline__ uint64_t desc_k(uint32_t t, int ks, int box) {
  return make_desc(fresh(t) + (ks >> 2) * box + (ks & 3) * 32, 16, 1024, 1);
}
// Descriptor of an MN-major operand tile: k-step ks (16 rows) of boxes of
// 64 columns `box` bytes apart along N.
__device__ __forceinline__ uint64_t desc_mn(uint32_t t, int ks, int box) {
  return make_desc(fresh(t) + ks * 2048, box, 1024, 1);
}

// One thread initialises `n` full barriers (one arrival plus the TMA's
// bytes) from `full` and as many empty barriers (one arrival per consumer
// warp) after them, and `extra` single-arrival barriers after those.
__device__ __forceinline__ void init_ring(uint32_t full, int n, int extra) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < n; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(full + 8 * (n + s), 8);
    }
    for (int e = 0; e < extra; ++e) mbar_init(full + 8 * (2 * n + e), 1);
    mbar_init_fence();
  }
  __syncthreads();
}

// A consumer warp is done with slot s: its lane 0 arrives on empty[s].
__device__ __forceinline__ void release(uint32_t empty, int s) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8 * s);
}

// ---- K8 forward ----

constexpr int QKV_STAGES = 4;
constexpr int QKV_XB = 128 * 128;            // x tile: 128 rows x 64 cols
constexpr int QKV_WB = 64 * 128;             // a W tile: 64 rows x 64 cols
constexpr int QKV_SLOT = QKV_XB + 3 * QKV_WB;

constexpr size_t QKV_SMEM = QKV_STAGES * QKV_SLOT + 16 * QKV_STAGES + 1024;

// Block (column block x, row block y): rows [128 y, 128 y + 128) (64 per
// consumer warpgroup) x columns [64 x, 64 x + 64) of q, k and v.
__global__ void __launch_bounds__(384, 1)
    qkv_fwd_bf16(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tw0,
                 const __grid_constant__ CUtensorMap tw1,
                 const __grid_constant__ CUtensorMap tw2,
                 const float2* __restrict__ stats, const bf16* __restrict__ g,
                 const bf16* __restrict__ b, bf16* __restrict__ q,
                 bf16* __restrict__ k, bf16* __restrict__ v, int N, int D) {
  unsigned char* sm = smem_aligned();
  const uint32_t ring = smem_u32(sm);
  const uint32_t full = ring + QKV_STAGES * QKV_SLOT;
  const uint32_t empty = full + 8 * QKV_STAGES;
  const int n0 = blockIdx.x * 64, m0 = blockIdx.y * 128, nk = D / 64;
  init_ring(full, QKV_STAGES, 0);

  if (threadIdx.x >= 256) {  // the producer warpgroup
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % QKV_STAGES;
        if (i >= QKV_STAGES) mbar_wait(empty + 8 * s, (i / QKV_STAGES - 1) & 1);
        const uint32_t st = ring + s * QKV_SLOT, bar = full + 8 * s;
        mbar_expect_tx(bar, QKV_SLOT);
        tma_load_2d(st, &tx, bar, 64 * i, m0);
        tma_load_2d(st + QKV_XB, &tw0, bar, n0, 64 * i);
        tma_load_2d(st + QKV_XB + QKV_WB, &tw1, bar, n0, 64 * i);
        tma_load_2d(st + QKV_XB + 2 * QKV_WB, &tw2, bar, n0, 64 * i);
      }
    }
    return;
  }
  reg_alloc<CONSUMER_REGS>();

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  const int rl = wg * 64 + 16 * warp + gq;  // the thread's rows rl, rl + 8
  float mu[2], rs[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + rl + 8 * h;
    const float2 s2 = row < N ? stats[row] : make_float2(0.f, 0.f);
    mu[h] = s2.x;
    rs[h] = s2.y;
  }
  float acc[3][32];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[j][e] = 0.f;
  for (int i = 0; i < nk; ++i) {
    const int s = i % QKV_STAGES;
    const uint32_t st = ring + s * QKV_SLOT;
    const unsigned char* xs = sm + s * QKV_SLOT;
    mbar_wait(full + 8 * s, (i / QKV_STAGES) & 1);
    // A fragments of x^ (the m16n8k16 A layout: rows rl, rl + 8; columns
    // 2t, 2t + 1 and 2t + 8, 2t + 9 of each 16-column step)
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 64 * i + 16 * kk + 8 * c + 2 * t;
        const float2 gg = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(g + col));
        const float2 bb = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(b + col));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rl + 8 * h;
          const uint32_t u = *reinterpret_cast<const uint32_t*>(
              xs + swz128(r, 2 * kk + c) + 4 * t);
          const float2 xv =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
          a[kk][h + 2 * c] = pack_bf16x2(ln1(xv.x, mu[h], rs[h], gg.x, bb.x),
                                         ln1(xv.y, mu[h], rs[h], gg.y, bb.y));
        }
      }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        wgmma_rs<64>(acc[j], a[kk],
                     desc_mn(st + QKV_XB + j * QKV_WB, kk, QKV_WB), 1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < 3; ++j) fence_regs(acc[j]);
    release(empty, s);
  }
  bf16* outs[3] = {q, k, v};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + rl + 8 * h;
    if (row >= N) continue;
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<uint32_t*>(outs[j] + (size_t)row * D + n0 + 8 * n +
                                     2 * t) =
            pack_bf16x2(acc[j][4 * n + 2 * h], acc[j][4 * n + 2 * h + 1]);
  }
}

// ---- K9 forward ----

constexpr int FFN_G = 512;      // output columns of a block (2 x 256)
constexpr int FFN_W = 32768;    // a W1 tile (128 x 128) or W2 tile (32 x 512)
constexpr int FFN_XT = 16384;   // a streamed x tile: 64 rows x 128 columns
constexpr int FFN_AB = 16384;   // one a buffer: 64 rows x 128 hidden

// The shared memory of width D: x^ (64 x D) resident and formed once where
// it fits beside two ring slots (D <= 1024); else x streamed, the slot of
// each W1 tile also holding the x tile of the same 128 columns, normalised
// there. Then up to 4 slots (2 at D 1024, 4 at D <= 512 or streamed), the
// two a buffers, the row statistics, the barriers and the alignment.
struct FfnPlan {
  int stream, xres, slot, stages;
};
FfnPlan ffn_plan(int D) {
  const int free = 232448 - 1024 - 512 - 8 - 2 * FFN_AB;
  FfnPlan p{0, 128 * D, FFN_W, 0};
  if ((free - p.xres) / (p.slot + 16) < 2) p = {1, 0, FFN_W + FFN_XT, 0};
  const int s = (free - p.xres) / (p.slot + 16);
  p.stages = s > 4 ? 4 : s;
  return p;
}
size_t ffn_smem(const FfnPlan& p) {
  return (size_t)p.xres + 2 * FFN_AB + (size_t)p.stages * (p.slot + 16) +
         512 + 8 + 1024;
}

// Block (row block x, column group y): rows [64 x, 64 x + 64) x output
// columns [512 y, 512 y + 512), warpgroup w owning 256 of them. Per hidden
// chunk of 128 the ring brings D / 128 W1 tiles (128 x 128, two boxes:
// warpgroup w's 64 hidden columns in box w; with STREAM, then the x tile
// of the same 128 columns, two boxes), then 4 W2 tiles (32 hidden rows x
// 512 columns, eight 64-column boxes: warpgroup w's in boxes 4w .. 4w +
// 3). Columns past D arrive as zeros and are not stored.
// No producer warp: ptxas compiles a block of more than 256 threads to 168
// registers a thread (65536 / 384: warps are allocated four at a time),
// setmaxnreg or not, and a consumer's 64 x 256 output and 64 x 64 z
// accumulators alone take 160. So the block is the two consumer
// warpgroups (255 registers allowed), and thread 0 refills the ring: at
// the start of step i it waits until every warp has released slot i - 1
// and loads tile i - 1 + stages into it.
template <int STREAM>
__global__ void __launch_bounds__(256, 1)
    ffn_fwd_bf16(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tw1,
                 const __grid_constant__ CUtensorMap tw2,
                 const float2* __restrict__ stats, const bf16* __restrict__ g,
                 const bf16* __restrict__ b, const bf16* __restrict__ b1,
                 const bf16* __restrict__ b2, bf16* __restrict__ f, int D,
                 int F, int slot, int stages) {
  unsigned char* sm = smem_aligned();
  const int xres = STREAM ? 0 : 128 * D;
  const uint32_t xs = smem_u32(sm);    // resident x^: D / 64 boxes of 8 KB
  const uint32_t abuf = xs + xres;     // two a buffers
  const uint32_t ring = abuf + 2 * FFN_AB;
  float2* rstat =
      reinterpret_cast<float2*>(sm + xres + 2 * FFN_AB + stages * slot);
  const uint32_t full = ring + stages * slot + 512;
  const uint32_t empty = full + 8 * stages, xbar = empty + 8 * stages;
  const int m0 = blockIdx.x * 64, g0 = blockIdx.y * FFN_G;
  const int nw1 = D / 128, nchunk = F / 128;
  const int per = nw1 + 4, total = nchunk * per;  // tiles a chunk, in all
  init_ring(full, stages, 1);

  // tile n of the stream into its slot: W1 tile kt or W2 tile j of chunk c
  auto load = [&](int n) {
    const int s = n % stages, c = n / per, r = n % per;
    const uint32_t st = ring + s * slot, bar = full + 8 * s;
    if (r < nw1) {
      mbar_expect_tx(bar, STREAM ? FFN_W + FFN_XT : FFN_W);
      tma_load_2d(st, &tw1, bar, 128 * c, 128 * r);
      tma_load_2d(st + 16384, &tw1, bar, 128 * c + 64, 128 * r);
      if (STREAM) {
        tma_load_2d(st + FFN_W, &tx, bar, 128 * r, m0);
        tma_load_2d(st + FFN_W + 8192, &tx, bar, 128 * r + 64, m0);
      }
    } else {
      mbar_expect_tx(bar, FFN_W);
      for (int bx = 0; bx < 8; ++bx)
        tma_load_2d(st + bx * 4096, &tw2, bar, g0 + 64 * bx,
                    128 * c + 32 * (r - nw1));
    }
  };
  auto refill = [&](int i) {
    const int n = i - 1 + stages;
    if (threadIdx.x == 0 && i > 0 && n < total) {
      mbar_wait(empty + 8 * ((i - 1) % stages), ((i - 1) / stages) & 1);
      load(n);
    }
  };
  if (threadIdx.x == 0) {
    if (!STREAM) {
      mbar_expect_tx(xbar, 128 * D);
      for (int bx = 0; bx < D / 64; ++bx)
        tma_load_2d(xs + bx * 8192, &tx, xbar, 64 * bx, m0);
    }
    for (int n = 0; n < stages && n < total; ++n) load(n);
  }

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, gq = lane >> 2, t = lane & 3;
  // x^ in place: each thread normalises 16-byte chunks of the `nbox`
  // swizzled 64-column boxes at `tile`, whose first column is col0 (chunk
  // p of row r of box bx holds columns col0 + 64 bx + 8 (p ^ r % 8) ..)
  auto normalise = [&](unsigned char* tile, int nbox, int col0) {
    for (int idx = tid; idx < 512 * nbox; idx += 256) {
      const int bx = idx >> 9, r = (idx >> 3) & 63, p = idx & 7;
      const int col = col0 + 64 * bx + 8 * (p ^ (r & 7));
      bf16* cp = reinterpret_cast<bf16*>(tile + bx * 8192 + r * 128 + p * 16);
      float xv[8], gv[8], bv[8];
      load_vec(cp, xv);
      load_vec(g + col, gv);
      load_vec(b + col, bv);
      const float2 s2 = rstat[r];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        xv[e] = ln1(xv[e], s2.x, s2.y, gv[e], bv[e]);
      store_vec(cp, xv);
    }
    fence_proxy_async();
    named_bar_sync(1, 256);
  };
  if (tid < 64) rstat[tid] = stats[m0 + tid];
  named_bar_sync(1, 256);
  if (!STREAM) {  // x^ once, for every hidden chunk
    mbar_wait(xbar, 0);
    normalise(sm, D / 64, 0);
  }

  float out[128];
#pragma unroll
  for (int e = 0; e < 128; ++e) out[e] = 0.f;
  int i = 0;
  for (int c = 0; c < nchunk; ++c) {
    float z[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) z[e] = 0.f;
    for (int kt = 0; kt < nw1; ++kt, ++i) {
      const int s = i % stages;
      const uint32_t st = ring + s * slot;
      refill(i);
      mbar_wait(full + 8 * s, (i / stages) & 1);
      // streamed: this k-tile's x^, formed in its slot
      if (STREAM) normalise(sm + (st - xs) + FFN_W, 2, 128 * kt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_ss_t<0, 1>(z,
                         STREAM ? desc_k(st + FFN_W, kk, 8192)
                                : desc_k(xs, 8 * kt + kk, 8192),
                         desc_mn(st + wg * 16384, kk, 16384), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(z);
      release(empty, s);
    }
    // a = relu(z + b1) rounded, into box wg of a buffer c % 2
    unsigned char* ab = sm + xres + (c & 1) * FFN_AB + wg * 8192;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 bb = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(b1 + 128 * c + 64 * wg +
                                                   8 * n + 2 * t));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + gq + 8 * h;
        *reinterpret_cast<uint32_t*>(ab + swz128(r, n) + 4 * t) =
            pack_bf16x2(fmaxf(z[4 * n + 2 * h] + bb.x, 0.f),
                        fmaxf(z[4 * n + 2 * h + 1] + bb.y, 0.f));
      }
    }
    fence_proxy_async();
    named_bar_sync(1, 256);  // both halves of the a tile are written
    const uint32_t at = abuf + (c & 1) * FFN_AB;
    for (int j = 0; j < 4; ++j, ++i) {
      const int s = i % stages;
      const uint32_t st = ring + s * slot;
      refill(i);
      mbar_wait(full + 8 * s, (i / stages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        wgmma_ss_t<0, 1>(out, desc_k(at, 2 * j + kk, 8192),
                         desc_mn(st + wg * 16384, kk, 4096), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(out);
      release(empty, s);
    }
  }
#pragma unroll
  for (int n = 0; n < 32; ++n) {
    const int col = g0 + 256 * wg + 8 * n + 2 * t;
    if (col >= D) continue;
    const float2 bb = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(b2 + col));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 16 * warp + gq + 8 * h;
      *reinterpret_cast<uint32_t*>(f + (size_t)row * D + col) =
          pack_bf16x2(out[4 * n + 2 * h] + bb.x, out[4 * n + 2 * h + 1] + bb.y);
    }
  }
}

// ---- the backward's GEMM template ----

// C (M x Ncols) from A (M x K) and B (K x Ncols). An operand is K-major
// when its contraction runs along its rows in memory (A (M, K) or B
// (Ncols, K) row-major: one TMA box of 128 rows x 64 columns a tile) and
// MN-major when it runs down them (A (K, M) or B (K, Ncols) row-major: two
// boxes of 64 rows x 64 columns); wgmma reads the latter through its
// transpose bit. Kinds:
//   DXN    C = sum over q < nsum of A_q B_q (K8's dxn: dq Wq^T + dk Wk^T +
//          dv Wv^T; K9's dz W1^T), A and B K-major, f32 out.
//   SPLIT  C_j + s csplit = A_j^T B_j over the rows of split s (blockIdx.z
//          = j S + s): the weight gradients x^T dy, a^T df, x^T dz, both
//          MN-major, f32 partials.
//   DZ     K9's first backward step: z = x^ W1 (B MN-major) and da = df
//          W2^T (B K-major) in two accumulators; a = relu(z + b1) and dz =
//          (z > 0) da stored rounded, db1 partials of f32 dz per 64-row
//          tile.
enum Kind { DXN = 0, SPLIT = 1, DZ = 2, OUT_LN = 3 };

constexpr int GB_STAGES = 4;
constexpr int GB_TILE = 16384;  // an A or B tile: 128 x 64 bf16
constexpr int GB_SLOT = 2 * GB_TILE;
constexpr size_t GB_SMEM = GB_STAGES * GB_SLOT + 4096 + 16 * GB_STAGES + 1024;

struct Maps {
  CUtensorMap a[3];
  CUtensorMap b[3];
};

struct GArgs {
  float* c[3];
  long long ldc, csplit;
  int M, K, nsum, S, kc;
  const bf16* b1;
  bf16* a_out;
  bf16* dz_out;
  float* db1_part;
};

template <int TA, int TB>
__device__ __forceinline__ void load_slot(uint32_t st, const CUtensorMap* ma,
                                          const CUtensorMap* mb, uint32_t bar,
                                          int m0, int n0, int k0) {
  mbar_expect_tx(bar, GB_SLOT);
  if (TA == 0) {
    tma_load_2d(st, ma, bar, k0, m0);
  } else {
    tma_load_2d(st, ma, bar, m0, k0);
    tma_load_2d(st + 8192, ma, bar, m0 + 64, k0);
  }
  if (TB == 0) {
    tma_load_2d(st + GB_TILE, mb, bar, k0, n0);
  } else {
    tma_load_2d(st + GB_TILE, mb, bar, n0, k0);
    tma_load_2d(st + GB_TILE + 8192, mb, bar, n0 + 64, k0);
  }
}

// The producer's side of one term: nk k-tiles from k0 through the ring.
template <int TA, int TB>
__device__ __forceinline__ void produce(int& i, int nk, int k0, uint32_t ring,
                                        uint32_t full, uint32_t empty,
                                        const CUtensorMap* ma,
                                        const CUtensorMap* mb, int m0,
                                        int n0) {
  for (int it = 0; it < nk; ++it, ++i) {
    const int s = i % GB_STAGES;
    if (i >= GB_STAGES) mbar_wait(empty + 8 * s, (i / GB_STAGES - 1) & 1);
    load_slot<TA, TB>(ring + s * GB_SLOT, ma, mb, full + 8 * s, m0, n0,
                      k0 + 64 * it);
  }
}

// The consumers' side: acc += this warpgroup's 64 rows of A times B over
// nk k-tiles (four k-steps each). Each tile's products complete before
// its slot is released: keeping one tile in flight (wait_group 1, the
// release one tile late) measured slower, ptxas serialising the wgmmas
// behind the release's divergent branch.
template <int TA, int TB>
__device__ __forceinline__ void consume(float (&acc)[64], int& i, int nk,
                                        uint32_t ring, uint32_t full,
                                        uint32_t empty, int wg) {
  for (int it = 0; it < nk; ++it, ++i) {
    const int s = i % GB_STAGES;
    const uint32_t st = ring + s * GB_SLOT;
    mbar_wait(full + 8 * s, (i / GB_STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_t<TA, TB>(acc,
                         TA ? desc_mn(st + wg * 8192, kk, 8192)
                            : desc_k(st + wg * 8192, kk, 8192),
                         TB ? desc_mn(st + GB_TILE, kk, 8192)
                            : desc_k(st + GB_TILE, kk, 8192),
                         1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    release(empty, s);
  }
}

// Block (column tile x, row tile y, z): rows [128 y, 128 y + 128) (64 per
// consumer warpgroup) x columns [128 x, 128 x + 128).
template <int KIND>
__global__ void __launch_bounds__(384, 1)
    gemm_bf16(const __grid_constant__ Maps mp, const GArgs p) {
  unsigned char* sm = smem_aligned();
  const uint32_t ring = smem_u32(sm);
  float* red = reinterpret_cast<float*>(sm + GB_STAGES * GB_SLOT);
  const uint32_t full = ring + GB_STAGES * GB_SLOT + 4096;
  const uint32_t empty = full + 8 * GB_STAGES;
  const int n0 = blockIdx.x * 128, m0 = blockIdx.y * 128;
  const int j = KIND == SPLIT ? blockIdx.z / p.S : 0;
  const int sp = KIND == SPLIT ? blockIdx.z % p.S : 0;
  const int kb = sp * p.kc;
  const int nk = KIND == SPLIT ? (max(0, min(p.K, kb + p.kc) - kb) + 63) / 64
                               : p.K / 64;
  init_ring(full, GB_STAGES, 0);

  if (threadIdx.x >= 256) {  // the producer warpgroup
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      int i = 0;
      if constexpr (KIND == DXN) {
        for (int q = 0; q < p.nsum; ++q)
          produce<0, 0>(i, nk, 0, ring, full, empty, &mp.a[q], &mp.b[q], m0,
                        n0);
      } else if constexpr (KIND == SPLIT) {
        produce<1, 1>(i, nk, kb, ring, full, empty, &mp.a[j], &mp.b[j], m0,
                      n0);
      } else {
        produce<0, 1>(i, nk, 0, ring, full, empty, &mp.a[0], &mp.b[0], m0, n0);
        produce<0, 0>(i, nk, 0, ring, full, empty, &mp.a[1], &mp.b[1], m0, n0);
      }
    }
    return;
  }
  reg_alloc<CONSUMER_REGS>();

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  const int rbase = m0 + wg * 64 + 16 * warp + gq;  // rows rbase, rbase + 8
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  int i = 0;
  if constexpr (KIND != DZ) {
    if constexpr (KIND == DXN) {
      for (int q = 0; q < p.nsum; ++q)
        consume<0, 0>(acc, i, nk, ring, full, empty, wg);
    } else {
      consume<1, 1>(acc, i, nk, ring, full, empty, wg);
    }
    // (no dynamic index into the parameter's array: it would copy the
    // array to the stack)
    float* C = (j == 0 ? p.c[0] : j == 1 ? p.c[1] : p.c[2]) +
               (size_t)sp * p.csplit;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rbase + 8 * h;
      if (row >= p.M) continue;
#pragma unroll
      for (int n = 0; n < 16; ++n)
        *reinterpret_cast<float2*>(C + (size_t)row * p.ldc + n0 + 8 * n +
                                   2 * t) =
            make_float2(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);
    }
  } else {
    float da[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) da[e] = 0.f;
    consume<0, 1>(acc, i, nk, ring, full, empty, wg);
    consume<0, 0>(da, i, nk, ring, full, empty, wg);
    // entry 4 n + 2 h + e: row rbase + 8 h, column n0 + 8 n + 2 t + e
    float cs[32];
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int col = n0 + 8 * n + 2 * t;
      const float2 bb = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(p.b1 + col));
      cs[2 * n] = cs[2 * n + 1] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rbase + 8 * h;
        const float z0 = acc[4 * n + 2 * h] + bb.x;
        const float z1 = acc[4 * n + 2 * h + 1] + bb.y;
        const float d0 = z0 > 0.f ? da[4 * n + 2 * h] : 0.f;
        const float d1 = z1 > 0.f ? da[4 * n + 2 * h + 1] : 0.f;
        cs[2 * n] += d0;
        cs[2 * n + 1] += d1;
        if (row < p.M) {
          const size_t at = (size_t)row * p.ldc + col;
          *reinterpret_cast<uint32_t*>(p.a_out + at) =
              pack_bf16x2(fmaxf(z0, 0.f), fmaxf(z1, 0.f));
          *reinterpret_cast<uint32_t*>(p.dz_out + at) = pack_bf16x2(d0, d1);
        }
      }
    }
    // column sums over the warpgroup's 64 rows: the 8 row groups of a
    // warp by shuffles, then the 4 warps through shared memory
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      float v = cs[e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      cs[e] = v;
    }
    float* rw = red + wg * 512 + warp * 128;
    if (gq == 0)
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        rw[8 * n + 2 * t] = cs[2 * n];
        rw[8 * n + 2 * t + 1] = cs[2 * n + 1];
      }
    named_bar_sync(2 + wg, 128);
    const int col = threadIdx.x & 127, tile = m0 / 64 + wg;
    if (tile < p.M / 64) {
      const float* rr = red + wg * 512 + col;
      p.db1_part[(size_t)tile * p.ldc + n0 + col] =
          ((rr[0] + rr[128]) + rr[256]) + rr[384];
    }
  }
}

// ===================== f32: element-wise FMA ===========================

// The f32 GEMM: the same kinds over BM x 128 tiles (BM 128, or 64 for DZ's
// two accumulators), plus OUT_LN (K8's forward: C_j = LN(x) W_j into the
// io dtype, j = blockIdx.z). Element (m, k) of a K-major A is A[m lda + k],
// of an MN-major A A[k lda + m]; element (k, n) of a K-major B is B[n ldb
// + k], of an MN-major B B[k ldb + n]. 256 threads as a 16 x 16 grid:
// thread (ty, tx) owns rows 64 (i / 4) + 4 ty + i % 4 and columns 64 (j /
// 4) + 4 tx + j % 4 of the tile. k-slices of 16 are staged in shared
// memory k-major (As[k][m], Bs[k][n]), double-buffered: the next slice's
// 16-byte global loads are in registers while this slice is multiplied.
constexpr int FK = 16;

struct FArgs {
  const float* A[3];
  const float* B[3];
  float* C[3];
  long long lda[3], ldb[3];
  long long ldc, csplit;
  int M, K, nsum, S, kc;
  const float2* stats;  // OUT_LN: the rows' (mean, rstd), g and b
  const float* g;
  const float* b;
  const float* b1;      // DZ
  float* a_out;
  float* dz_out;
  float* db1_part;
};

template <int BM>
struct FSmem {
  float a[2][FK][BM + 4];
  float b[2][FK][128 + 4];
};

// One term's product into acc over contraction rows [kb, ke) (a multiple
// of 16 long). A K-major rows past M read as zeros; LN applies the
// LayerNorm to A's elements as they are staged.
template <int BM, bool AMN, bool BMN, bool LN>
__device__ __forceinline__ void f32_term(float (&acc)[BM / 16][8],
                                         FSmem<BM>& sm, const FArgs& p,
                                         const float* __restrict__ A,
                                         long long lda,
                                         const float* __restrict__ B,
                                         long long ldb, int kb, int ke,
                                         int m0, int n0) {
  constexpr int R = BM / 16, NA = BM / 64;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nk = (ke - kb) / FK;
  float4 ra[NA], rb[2];
  auto load = [&](int k0) {
#pragma unroll
    for (int e = 0; e < NA; ++e) {
      const int idx = tid + 256 * e;
      if (AMN) {
        const int k = idx / (BM / 4), m4 = 4 * (idx % (BM / 4));
        ra[e] = load4(A + (size_t)(k0 + k) * lda + m0 + m4);
      } else {
        const int m = idx >> 2, k4 = 4 * (idx & 3);
        const int row = m0 + m;
        ra[e] = row < p.M ? load4(A + (size_t)row * lda + k0 + k4)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
        if (LN && row < p.M) {
          const float2 st = p.stats[row];
          const float4 gv = load4(p.g + k0 + k4), bv = load4(p.b + k0 + k4);
          ra[e] = make_float4(ln1(ra[e].x, st.x, st.y, gv.x, bv.x),
                              ln1(ra[e].y, st.x, st.y, gv.y, bv.y),
                              ln1(ra[e].z, st.x, st.y, gv.z, bv.z),
                              ln1(ra[e].w, st.x, st.y, gv.w, bv.w));
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int idx = tid + 256 * e;
      if (BMN) {
        const int k = idx >> 5, n4 = 4 * (idx & 31);
        rb[e] = load4(B + (size_t)(k0 + k) * ldb + n0 + n4);
      } else {
        const int n = idx >> 2, k4 = 4 * (idx & 3);
        rb[e] = load4(B + (size_t)(n0 + n) * ldb + k0 + k4);
      }
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int e = 0; e < NA; ++e) {
      const int idx = tid + 256 * e;
      if (AMN) {
        const int k = idx / (BM / 4), m4 = 4 * (idx % (BM / 4));
        *reinterpret_cast<float4*>(&sm.a[buf][k][m4]) = ra[e];
      } else {
        const int m = idx >> 2, k4 = 4 * (idx & 3);
        sm.a[buf][k4][m] = ra[e].x;
        sm.a[buf][k4 + 1][m] = ra[e].y;
        sm.a[buf][k4 + 2][m] = ra[e].z;
        sm.a[buf][k4 + 3][m] = ra[e].w;
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int idx = tid + 256 * e;
      if (BMN) {
        const int k = idx >> 5, n4 = 4 * (idx & 31);
        *reinterpret_cast<float4*>(&sm.b[buf][k][n4]) = rb[e];
      } else {
        const int n = idx >> 2, k4 = 4 * (idx & 3);
        sm.b[buf][k4][n] = rb[e].x;
        sm.b[buf][k4 + 1][n] = rb[e].y;
        sm.b[buf][k4 + 2][n] = rb[e].z;
        sm.b[buf][k4 + 3][n] = rb[e].w;
      }
    }
  };
  if (nk <= 0) return;
  load(kb);
  store(0);
  __syncthreads();
  for (int it = 0; it < nk; ++it) {
    const int buf = it & 1;
    if (it + 1 < nk) load(kb + FK * (it + 1));
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      float a[R], b[8];
#pragma unroll
      for (int e = 0; e < R / 4; ++e) {
        const float4 v =
            *reinterpret_cast<const float4*>(&sm.a[buf][k][64 * e + 4 * ty]);
        a[4 * e] = v.x;
        a[4 * e + 1] = v.y;
        a[4 * e + 2] = v.z;
        a[4 * e + 3] = v.w;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 v =
            *reinterpret_cast<const float4*>(&sm.b[buf][k][64 * e + 4 * tx]);
        b[4 * e] = v.x;
        b[4 * e + 1] = v.y;
        b[4 * e + 2] = v.z;
        b[4 * e + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) acc[i][jj] = fmaf(a[i], b[jj], acc[i][jj]);
    }
    if (it + 1 < nk) store(buf ^ 1);
    __syncthreads();
  }
}

template <int KIND, int BM>
__global__ void __launch_bounds__(256)
    gemm_f32(const FArgs p) {
  constexpr int R = BM / 16;
  __shared__ __align__(16) FSmem<BM> sm;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * 128, m0 = blockIdx.y * BM;
  float acc[R][8];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) acc[i][jj] = 0.f;
  auto row_of = [&](int i) { return m0 + 64 * (i >> 2) + 4 * ty + (i & 3); };
  auto col_of = [&](int e) { return n0 + 64 * e + 4 * tx; };
  if constexpr (KIND != DZ) {
    int j = 0, sp = 0, kb = 0, ke = p.K;
    if constexpr (KIND == DXN) {
      for (int q = 0; q < p.nsum; ++q)
        f32_term<BM, false, false, false>(acc, sm, p, p.A[q], p.lda[q],
                                          p.B[q], p.ldb[q], 0, p.K, m0, n0);
    } else if constexpr (KIND == SPLIT) {
      j = blockIdx.z / p.S;
      sp = blockIdx.z % p.S;
      kb = sp * p.kc;
      ke = min(p.K, kb + p.kc);
      f32_term<BM, true, true, false>(acc, sm, p, p.A[j], p.lda[j], p.B[j],
                                      p.ldb[j], kb, ke, m0, n0);
    } else {  // OUT_LN
      j = blockIdx.z;
      f32_term<BM, false, true, true>(acc, sm, p, p.A[0], p.lda[0], p.B[j],
                                      p.ldb[j], 0, p.K, m0, n0);
    }
    float* C = p.C[j] + (size_t)sp * p.csplit;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = row_of(i);
      if (row >= p.M) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float4*>(C + (size_t)row * p.ldc + col_of(e)) =
            make_float4(acc[i][4 * e], acc[i][4 * e + 1], acc[i][4 * e + 2],
                        acc[i][4 * e + 3]);
    }
  } else {
    float da[R][8];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) da[i][jj] = 0.f;
    f32_term<BM, false, true, false>(acc, sm, p, p.A[0], p.lda[0], p.B[0],
                                     p.ldb[0], 0, p.K, m0, n0);
    f32_term<BM, false, false, false>(da, sm, p, p.A[1], p.lda[1], p.B[1],
                                      p.ldb[1], 0, p.K, m0, n0);
    float cs[8];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float4 bb = load4(p.b1 + col_of(e));
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) cs[4 * e + c] = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float av[4], dv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float z = acc[i][4 * e + c] + bv[c];
          av[c] = fmaxf(z, 0.f);
          dv[c] = z > 0.f ? da[i][4 * e + c] : 0.f;
          cs[4 * e + c] += dv[c];
        }
        const size_t at = (size_t)row_of(i) * p.ldc + col_of(e);
        *reinterpret_cast<float4*>(p.a_out + at) =
            make_float4(av[0], av[1], av[2], av[3]);
        *reinterpret_cast<float4*>(p.dz_out + at) =
            make_float4(dv[0], dv[1], dv[2], dv[3]);
      }
    }
    // db1 partial of the tile's 64 rows: the 16 row owners of a column
    // through shared memory, summed in a fixed order
    static_assert(BM == 64, "one 64-row tile per DZ block");
    float* red = &sm.a[0][0][0];  // 16 x 128 floats, after the last sync
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int c = 0; c < 4; ++c) red[ty * 128 + 64 * e + 4 * tx + c] = cs[4 * e + c];
    __syncthreads();
    if (tid < 128) {
      float s = 0.f;
      for (int r = 0; r < 16; ++r) s += red[r * 128 + tid];
      p.db1_part[(size_t)blockIdx.y * p.ldc + n0 + tid] = s;
    }
  }
}

// K9's f32 forward: block = 32 rows x 512 output columns (the whole row at
// D <= 512), hidden chunks of 128. Per chunk z (32 x 128) is accumulated
// over D in 16-deep slices of x^ (the LayerNorm applied while staging)
// and W1, thread (zy, zx) owning rows 4 zy .. and hidden columns 4 zx ..;
// a = relu(z + b1) goes to shared memory and is multiplied into the
// output, thread (oy, ox) owning rows 8 oy .. and columns 4 ox .., 256 + 4
// ox ... Columns past D read zeros and are not stored.
constexpr int FF_BM = 32, FF_HC = 128, FF_G = 512;
struct FFSmem {
  float x[FK][FF_BM + 4];
  float w1[FK][FF_HC + 4];
  float a[FF_HC][FF_BM + 4];
  float w2[FK][FF_G + 4];
};

__global__ void __launch_bounds__(256)
    ffn_fwd_f32(const float* __restrict__ x, const float2* __restrict__ stats,
                const float* __restrict__ g, const float* __restrict__ b,
                const float* __restrict__ w1, const float* __restrict__ b1,
                const float* __restrict__ w2, const float* __restrict__ b2,
                float* __restrict__ f, int D, int F) {
  extern __shared__ __align__(16) unsigned char ff_raw[];
  FFSmem& sm = *reinterpret_cast<FFSmem*>(ff_raw);
  const int tid = threadIdx.x;
  const int zy = tid >> 5, zx = tid & 31, oy = tid >> 6, ox = tid & 63;
  const int m0 = blockIdx.x * FF_BM, g0 = blockIdx.y * FF_G;
  float o[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) o[i][jj] = 0.f;
  for (int c0 = 0; c0 < F; c0 += FF_HC) {
    float z[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) z[i][jj] = 0.f;
    for (int k0 = 0; k0 < D; k0 += FK) {
      if (tid < 128) {
        const int r = tid >> 2, k4 = 4 * (tid & 3);
        const float4 xv = load4(x + (size_t)(m0 + r) * D + k0 + k4);
        const float4 gv = load4(g + k0 + k4), bv = load4(b + k0 + k4);
        const float2 st = stats[m0 + r];
        sm.x[k4][r] = ln1(xv.x, st.x, st.y, gv.x, bv.x);
        sm.x[k4 + 1][r] = ln1(xv.y, st.x, st.y, gv.y, bv.y);
        sm.x[k4 + 2][r] = ln1(xv.z, st.x, st.y, gv.z, bv.z);
        sm.x[k4 + 3][r] = ln1(xv.w, st.x, st.y, gv.w, bv.w);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int idx = tid + 256 * e, k = idx >> 5, h4 = 4 * (idx & 31);
        *reinterpret_cast<float4*>(&sm.w1[k][h4]) =
            load4(w1 + (size_t)(k0 + k) * F + c0 + h4);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < FK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&sm.x[k][4 * zy]);
        const float4 w = *reinterpret_cast<const float4*>(&sm.w1[k][4 * zx]);
        const float av[4] = {a.x, a.y, a.z, a.w}, wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) z[i][jj] = fmaf(av[i], wv[jj], z[i][jj]);
      }
      __syncthreads();
    }
    const float4 bb = load4(b1 + c0 + 4 * zx);
    const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        sm.a[4 * zx + jj][4 * zy + i] = fmaxf(z[i][jj] + bv[jj], 0.f);
    for (int k0 = 0; k0 < FF_HC; k0 += FK) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int idx = tid + 256 * e, k = idx >> 7, n4 = 4 * (idx & 127);
        const int col = g0 + n4;
        *reinterpret_cast<float4*>(&sm.w2[k][n4]) =
            col < D ? load4(w2 + (size_t)(c0 + k0 + k) * D + col)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      __syncthreads();  // also publishes the a chunk
#pragma unroll
      for (int k = 0; k < FK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(&sm.a[k0 + k][8 * oy]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&sm.a[k0 + k][8 * oy + 4]);
        const float4 w0 = *reinterpret_cast<const float4*>(&sm.w2[k][4 * ox]);
        const float4 w1v =
            *reinterpret_cast<const float4*>(&sm.w2[k][256 + 4 * ox]);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1v.x, w1v.y, w1v.z, w1v.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) o[i][jj] = fmaf(av[i], wv[jj], o[i][jj]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int col = g0 + 256 * e + 4 * ox;
    if (col >= D) continue;
    const float4 bb2 = load4(b2 + col);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<float4*>(f + (size_t)(m0 + 8 * oy + i) * D + col) =
          make_float4(o[i][4 * e] + bb2.x, o[i][4 * e + 1] + bb2.y,
                      o[i][4 * e + 2] + bb2.z, o[i][4 * e + 3] + bb2.w);
  }
}

// ===================== launch =========================================

// The 2-D tensor map of a row-major bf16 (rows, cols) array read in boxes
// of box_rows x 64 columns under the 128-byte swizzle; boxes past the
// array's edge read as zeros.
int make_map(CUtensorMap* m, const void* p, int rows, int cols,
             int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return MAP_FAILED;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : MAP_FAILED;
}
// an operand's map: K-major tiles are one 128-row box, MN-major two 64-row
int map_k(CUtensorMap* m, const void* p, int rows, int cols) {
  return make_map(m, p, rows, cols, 128);
}
int map_mn(CUtensorMap* m, const void* p, int rows, int cols) {
  return make_map(m, p, rows, cols, 64);
}

template <typename T>
int stats_launch(const void* x, const void* g, const void* b, float2* stats,
                 void* xhat, int N, int D, cudaStream_t st) {
  return launch(ln_stats<T>, 256, 0, dim3((N + 7) / 8), st,
                static_cast<const T*>(x), static_cast<const T*>(g),
                static_cast<const T*>(b), stats, static_cast<T*>(xhat), N, D);
}

// rows of a split of the cross-row sums: a multiple of 64 (whole k-tiles)
int split_rows(int N, int S) { return (N / S + 63) / 64 * 64; }

template <typename T>
int ln_bwd_launch(const void* x, const float2* stats, const void* g,
                  const float* dxn, void* dx, float* dgb_part, int N, int D,
                  int S, cudaStream_t st) {
  if (int rc = launch(ln_bwd_dx<T>, 256, 0, dim3((N + 7) / 8), st,
                      static_cast<const T*>(x), stats,
                      static_cast<const T*>(g), dxn, static_cast<T*>(dx), N,
                      D))
    return rc;
  return launch(ln_bwd_dgb<T>, 1024, 0, dim3(D / 32, S), st,
                static_cast<const T*>(x), stats, dxn, dgb_part, N, D,
                split_rows(N, S));
}

int gemm_bf16_launch(int kind, const Maps& mp, const GArgs& p, int Ncols,
                     int Z, cudaStream_t st) {
  const dim3 grid(Ncols / 128, (p.M + 127) / 128, Z);
  switch (kind) {
    case DXN: return launch(gemm_bf16<DXN>, 384, GB_SMEM, grid, st, mp, p);
    case SPLIT: return launch(gemm_bf16<SPLIT>, 384, GB_SMEM, grid, st, mp, p);
    case DZ: return launch(gemm_bf16<DZ>, 384, GB_SMEM, grid, st, mp, p);
    default: return -1;
  }
}

int gemm_f32_launch(int kind, const FArgs& p, int Ncols, int Z,
                    cudaStream_t st) {
  switch (kind) {
    case DXN:
      return launch(gemm_f32<DXN, 128>, 256, 0,
                    dim3(Ncols / 128, (p.M + 127) / 128, Z), st, p);
    case SPLIT:
      return launch(gemm_f32<SPLIT, 128>, 256, 0,
                    dim3(Ncols / 128, (p.M + 127) / 128, Z), st, p);
    case OUT_LN:
      return launch(gemm_f32<OUT_LN, 128>, 256, 0,
                    dim3(Ncols / 128, (p.M + 127) / 128, Z), st, p);
    case DZ:
      return launch(gemm_f32<DZ, 64>, 256, 0, dim3(Ncols / 128, p.M / 64, Z),
                    st, p);
    default: return -1;
  }
}

// ---- K8 ----

int qkv_fwd_bf16_run(const void* x, const void* g, const void* b,
                     const void* wq, const void* wk, const void* wv, void* q,
                     void* k, void* v, float2* stats, int N, int D,
                     cudaStream_t st) {
  if (int rc = stats_launch<bf16>(x, g, b, stats, nullptr, N, D, st))
    return rc;
  CUtensorMap tx, t0, t1, t2;
  int e = make_map(&tx, x, N, D, 128);
  if (!e) e = make_map(&t0, wq, D, D, 64);
  if (!e) e = make_map(&t1, wk, D, D, 64);
  if (!e) e = make_map(&t2, wv, D, D, 64);
  if (e) return e;
  auto h = [](void* p) { return static_cast<bf16*>(p); };
  return launch(qkv_fwd_bf16, 384, QKV_SMEM, dim3(D / 64, (N + 127) / 128),
                st, tx, t0, t1, t2, (const float2*)stats,
                static_cast<const bf16*>(g), static_cast<const bf16*>(b),
                h(q), h(k), h(v), N, D);
}

int qkv_fwd_f32_run(const void* x, const void* g, const void* b,
                    const void* wq, const void* wk, const void* wv, void* q,
                    void* k, void* v, float2* stats, int N, int D,
                    cudaStream_t st) {
  if (int rc = stats_launch<float>(x, g, b, stats, nullptr, N, D, st))
    return rc;
  auto c = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  FArgs p{};
  p.A[0] = c(x);
  p.lda[0] = D;
  const float* ws[3] = {c(wq), c(wk), c(wv)};
  float* outs[3] = {o(q), o(k), o(v)};
  for (int j = 0; j < 3; ++j) {
    p.B[j] = ws[j];
    p.ldb[j] = D;
    p.C[j] = outs[j];
  }
  p.ldc = D;
  p.M = N;
  p.K = D;
  p.stats = stats;
  p.g = c(g);
  p.b = c(b);
  return gemm_f32_launch(OUT_LN, p, D, 3, st);
}

template <typename T>
int qkv_bwd(const void* x, const void* g, const void* b, const void* wq,
            const void* wk, const void* wv, const void* dq, const void* dk,
            const void* dv, void* dx, float2* stats, void* xhat, float* dxn,
            float* dw_part, float* dgb_part, int N, int D, int S,
            cudaStream_t st) {
  if (int rc = stats_launch<T>(x, g, b, stats, xhat, N, D, st)) return rc;
  const void* dys[3] = {dq, dk, dv};
  const void* ws[3] = {wq, wk, wv};
  const size_t DD = (size_t)D * D;
  if constexpr (sizeof(T) == 2) {
    // dxn = dq Wq^T + dk Wk^T + dv Wv^T, f32
    Maps md, mw;
    GArgs pd{}, pw{};
    for (int j = 0; j < 3; ++j) {
      int e = map_k(&md.a[j], dys[j], N, D);
      if (!e) e = map_k(&md.b[j], ws[j], D, D);
      if (!e) e = map_mn(&mw.a[j], xhat, N, D);
      if (!e) e = map_mn(&mw.b[j], dys[j], N, D);
      if (e) return e;
      pw.c[j] = dw_part + j * S * DD;
    }
    pd.c[0] = dxn;
    pd.ldc = D;
    pd.M = N;
    pd.K = D;
    pd.nsum = 3;
    if (int rc = gemm_bf16_launch(DXN, md, pd, D, 1, st)) return rc;
    // dW_j partials: x^T dy_j over each split's rows, (3, S, D, D) f32
    pw.ldc = D;
    pw.csplit = (long long)DD;
    pw.M = D;
    pw.K = N;
    pw.S = S;
    pw.kc = split_rows(N, S);
    if (int rc = gemm_bf16_launch(SPLIT, mw, pw, D, 3 * S, st)) return rc;
  } else {
    auto c = [](const void* p) { return static_cast<const float*>(p); };
    FArgs pd{}, pw{};
    for (int j = 0; j < 3; ++j) {
      pd.A[j] = c(dys[j]);
      pd.lda[j] = D;
      pd.B[j] = c(ws[j]);
      pd.ldb[j] = D;
      pw.A[j] = c(xhat);
      pw.lda[j] = D;
      pw.B[j] = c(dys[j]);
      pw.ldb[j] = D;
      pw.C[j] = dw_part + j * S * DD;
    }
    pd.C[0] = dxn;
    pd.ldc = D;
    pd.M = N;
    pd.K = D;
    pd.nsum = 3;
    if (int rc = gemm_f32_launch(DXN, pd, D, 1, st)) return rc;
    pw.ldc = D;
    pw.csplit = (long long)DD;
    pw.M = D;
    pw.K = N;
    pw.S = S;
    pw.kc = split_rows(N, S);
    if (int rc = gemm_f32_launch(SPLIT, pw, D, 3 * S, st)) return rc;
  }
  return ln_bwd_launch<T>(x, stats, g, dxn, dx, dgb_part, N, D, S, st);
}

// ---- K9 ----

int ffn_fwd_bf16_run(const void* x, const void* g, const void* b,
                     const void* w1, const void* b1, const void* w2,
                     const void* b2, void* f, float2* stats, int N, int D,
                     int F, cudaStream_t st) {
  if (int rc = stats_launch<bf16>(x, g, b, stats, nullptr, N, D, st))
    return rc;
  CUtensorMap tx, t1, t2;
  int e = make_map(&tx, x, N, D, 64);
  if (!e) e = make_map(&t1, w1, D, F, 128);
  if (!e) e = make_map(&t2, w2, F, D, 32);
  if (e) return e;
  const FfnPlan pl = ffn_plan(D);
  auto c = [](const void* p) { return static_cast<const bf16*>(p); };
  auto kern = &ffn_fwd_bf16<0>;
  if (pl.stream) kern = &ffn_fwd_bf16<1>;
  return launch(kern, 256, ffn_smem(pl),
                dim3(N / 64, (D + FFN_G - 1) / FFN_G), st, tx, t1, t2,
                (const float2*)stats, c(g), c(b), c(b1), c(b2),
                static_cast<bf16*>(f), D, F, pl.slot, pl.stages);
}

int ffn_fwd_f32_run(const void* x, const void* g, const void* b,
                    const void* w1, const void* b1, const void* w2,
                    const void* b2, void* f, float2* stats, int N, int D,
                    int F, cudaStream_t st) {
  if (int rc = stats_launch<float>(x, g, b, stats, nullptr, N, D, st))
    return rc;
  auto c = [](const void* p) { return static_cast<const float*>(p); };
  return launch(ffn_fwd_f32, 256, sizeof(FFSmem),
                dim3(N / FF_BM, (D + FF_G - 1) / FF_G), st, c(x),
                (const float2*)stats, c(g), c(b), c(w1), c(b1), c(w2), c(b2),
                static_cast<float*>(f), D, F);
}

template <typename T>
int ffn_bwd(const void* x, const void* g, const void* b, const void* w1,
            const void* b1, const void* w2, const void* df, void* dx,
            float2* stats, void* xhat, void* a, void* dz, float* db1_part,
            float* dw1_part, float* dw2_part, float* dxn, float* dgb_part,
            int N, int D, int F, int S, cudaStream_t st) {
  if (int rc = stats_launch<T>(x, g, b, stats, xhat, N, D, st)) return rc;
  const int kc = split_rows(N, S);
  if constexpr (sizeof(T) == 2) {
    // a, dz (N, F) and the db1 partials: z = x^ W1, da = df W2^T
    Maps mz, m2, m1, mx;
    int e = map_k(&mz.a[0], xhat, N, D);
    if (!e) e = map_mn(&mz.b[0], w1, D, F);
    if (!e) e = map_k(&mz.a[1], df, N, D);
    if (!e) e = map_k(&mz.b[1], w2, F, D);
    if (!e) e = map_mn(&m2.a[0], a, N, F);   // dW2 = a^T df
    if (!e) e = map_mn(&m2.b[0], df, N, D);
    if (!e) e = map_mn(&m1.a[0], xhat, N, D);  // dW1 = x^T dz
    if (!e) e = map_mn(&m1.b[0], dz, N, F);
    if (!e) e = map_k(&mx.a[0], dz, N, F);   // dxn = dz W1^T
    if (!e) e = map_k(&mx.b[0], w1, D, F);
    if (e) return e;
    GArgs pz{};
    pz.ldc = F;
    pz.M = N;
    pz.K = D;
    pz.b1 = static_cast<const bf16*>(b1);
    pz.a_out = static_cast<bf16*>(a);
    pz.dz_out = static_cast<bf16*>(dz);
    pz.db1_part = db1_part;
    if (int rc = gemm_bf16_launch(DZ, mz, pz, F, 1, st)) return rc;
    GArgs p2{};
    p2.c[0] = dw2_part;
    p2.ldc = D;
    p2.csplit = (long long)F * D;
    p2.M = F;
    p2.K = N;
    p2.S = S;
    p2.kc = kc;
    if (int rc = gemm_bf16_launch(SPLIT, m2, p2, D, S, st)) return rc;
    GArgs p1 = p2;
    p1.c[0] = dw1_part;
    p1.ldc = F;
    p1.csplit = (long long)D * F;
    p1.M = D;
    if (int rc = gemm_bf16_launch(SPLIT, m1, p1, F, S, st)) return rc;
    GArgs px{};
    px.c[0] = dxn;
    px.ldc = D;
    px.M = N;
    px.K = F;
    px.nsum = 1;
    if (int rc = gemm_bf16_launch(DXN, mx, px, D, 1, st)) return rc;
  } else {
    auto c = [](const void* p) { return static_cast<const float*>(p); };
    auto o = [](void* p) { return static_cast<float*>(p); };
    FArgs pz{};
    pz.A[0] = c(xhat);
    pz.lda[0] = D;
    pz.B[0] = c(w1);
    pz.ldb[0] = F;
    pz.A[1] = c(df);
    pz.lda[1] = D;
    pz.B[1] = c(w2);
    pz.ldb[1] = D;
    pz.ldc = F;
    pz.M = N;
    pz.K = D;
    pz.b1 = c(b1);
    pz.a_out = o(a);
    pz.dz_out = o(dz);
    pz.db1_part = db1_part;
    if (int rc = gemm_f32_launch(DZ, pz, F, 1, st)) return rc;
    FArgs p2{};
    p2.A[0] = c(a);
    p2.lda[0] = F;
    p2.B[0] = c(df);
    p2.ldb[0] = D;
    p2.C[0] = dw2_part;
    p2.ldc = D;
    p2.csplit = (long long)F * D;
    p2.M = F;
    p2.K = N;
    p2.S = S;
    p2.kc = kc;
    if (int rc = gemm_f32_launch(SPLIT, p2, D, S, st)) return rc;
    FArgs p1 = p2;
    p1.A[0] = c(xhat);
    p1.lda[0] = D;
    p1.B[0] = c(dz);
    p1.ldb[0] = F;
    p1.C[0] = dw1_part;
    p1.ldc = F;
    p1.csplit = (long long)D * F;
    p1.M = D;
    if (int rc = gemm_f32_launch(SPLIT, p1, F, S, st)) return rc;
    FArgs px{};
    px.A[0] = c(dz);
    px.lda[0] = F;
    px.B[0] = c(w1);
    px.ldb[0] = F;
    px.C[0] = dxn;
    px.ldc = D;
    px.M = N;
    px.K = F;
    px.nsum = 1;
    if (int rc = gemm_f32_launch(DXN, px, D, 1, st)) return rc;
  }
  return ln_bwd_launch<T>(x, stats, g, dxn, dx, dgb_part, N, D, S, st);
}

bool shapes_ok(int N, int D, int F, int S) {
  return N > 0 && N % 64 == 0 && N / 64 <= 65535 && D > 0 && D % 128 == 0 &&
         F > 0 && F % 128 == 0 && S > 0 && S <= 65535 / 3;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Every array is contiguous and
// row-major: x (N, D), g and b (D), W (D, D), W1 (D, F), b1 (F), W2 (F, D),
// b2 (D); stats is an (N) float2 scratch of (mean, rstd). Each returns 0
// on success, -1 for an unsupported dtype or shape, -2 when a bf16
// launch's tensor maps cannot be encoded, else the cudaError_t of the
// first failed launch.

// q, k, v = LN(x) Wq, LN(x) Wk, LN(x) Wv.
extern "C" int ln_qkv_fwd_launch(int dtype, const void* x, const void* g,
                                 const void* b, const void* wq,
                                 const void* wk, const void* wv, void* q,
                                 void* k, void* v, void* stats, int N, int D,
                                 void* stream) {
  if (!shapes_ok(N, D, 128, 1)) return -1;
  auto st = static_cast<cudaStream_t>(stream);
  auto s2 = static_cast<float2*>(stats);
  if (dtype == 0)
    return qkv_fwd_f32_run(x, g, b, wq, wk, wv, q, k, v, s2, N, D, st);
  if (dtype == 1)
    return qkv_fwd_bf16_run(x, g, b, wq, wk, wv, q, k, v, s2, N, D, st);
  return -1;
}

// dx (N, D) in the io dtype; f32 partials over S row splits: dw_part (3,
// S, D, D) of dWq, dWk, dWv and dgb_part (S, 2, D) of dg and db; xhat (N,
// D) in the io dtype and dxn (N, D) f32 are scratch.
extern "C" int ln_qkv_bwd_launch(int dtype, const void* x, const void* g,
                                 const void* b, const void* wq,
                                 const void* wk, const void* wv,
                                 const void* dq, const void* dk,
                                 const void* dv, void* dx, void* stats,
                                 void* xhat, void* dxn, void* dw_part,
                                 void* dgb_part, int N, int D, int S,
                                 void* stream) {
  if (!shapes_ok(N, D, 128, S)) return -1;
  auto st = static_cast<cudaStream_t>(stream);
  auto s2 = static_cast<float2*>(stats);
  auto f = [](void* p) { return static_cast<float*>(p); };
  if (dtype == 0)
    return qkv_bwd<float>(x, g, b, wq, wk, wv, dq, dk, dv, dx, s2, xhat,
                          f(dxn), f(dw_part), f(dgb_part), N, D, S, st);
  if (dtype == 1)
    return qkv_bwd<bf16>(x, g, b, wq, wk, wv, dq, dk, dv, dx, s2, xhat,
                         f(dxn), f(dw_part), f(dgb_part), N, D, S, st);
  return -1;
}

// f = relu(LN(x) W1 + b1) W2 + b2.
extern "C" int ln_ffn_fwd_launch(int dtype, const void* x, const void* g,
                                 const void* b, const void* w1,
                                 const void* b1, const void* w2,
                                 const void* b2, void* f, void* stats, int N,
                                 int D, int F, void* stream) {
  if (!shapes_ok(N, D, F, 1)) return -1;
  auto st = static_cast<cudaStream_t>(stream);
  auto s2 = static_cast<float2*>(stats);
  if (dtype == 0)
    return ffn_fwd_f32_run(x, g, b, w1, b1, w2, b2, f, s2, N, D, F, st);
  if (dtype == 1)
    return ffn_fwd_bf16_run(x, g, b, w1, b1, w2, b2, f, s2, N, D, F, st);
  return -1;
}

// dx (N, D) in the io dtype; f32 partials: db1_part (N / 64, F), dw1_part
// (S, D, F), dw2_part (S, F, D), dgb_part (S, 2, D); xhat (N, D), a
// and dz (N, F) in the io dtype and dxn (N, D) f32 are scratch.
extern "C" int ln_ffn_bwd_launch(int dtype, const void* x, const void* g,
                                 const void* b, const void* w1,
                                 const void* b1, const void* w2,
                                 const void* df, void* dx, void* stats,
                                 void* xhat, void* a, void* dz,
                                 void* db1_part, void* dw1_part,
                                 void* dw2_part, void* dxn, void* dgb_part,
                                 int N, int D, int F, int S, void* stream) {
  if (!shapes_ok(N, D, F, S)) return -1;
  auto st = static_cast<cudaStream_t>(stream);
  auto s2 = static_cast<float2*>(stats);
  auto f = [](void* p) { return static_cast<float*>(p); };
  if (dtype == 0)
    return ffn_bwd<float>(x, g, b, w1, b1, w2, df, dx, s2, xhat, a, dz,
                          f(db1_part), f(dw1_part), f(dw2_part), f(dxn),
                          f(dgb_part), N, D, F, S, st);
  if (dtype == 1)
    return ffn_bwd<bf16>(x, g, b, w1, b1, w2, df, dx, s2, xhat, a, dz,
                         f(db1_part), f(dw1_part), f(dw2_part), f(dxn),
                         f(dgb_part), N, D, F, S, st);
  return -1;
}

// Dynamic shared memory (bytes) a launch asks for at width D: which 0 the
// bf16 ln_qkv forward, 1 the bf16 ln_ffn forward, 2 the bf16 backward
// GEMM, 3 the f32 ln_ffn forward; -1 for one that does not exist.
extern "C" long long fused_smem_bytes(int which, int D) {
  if (D <= 0 || D % 128) return -1;
  switch (which) {
    case 0: return (long long)QKV_SMEM;
    case 1: return (long long)ffn_smem(ffn_plan(D));
    case 2: return (long long)GB_SMEM;
    case 3: return (long long)sizeof(FFSmem);
    default: return -1;
  }
}
