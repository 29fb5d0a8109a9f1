// bf16 tensor-core fragments and asynchronous copies for Hopper (sm_90a),
// shared by flash_attention.cu and ring_attention.cu.
//
// One warp computes c += a * b on one mma.sync m16n8k16 tile: a 16 x 16 bf16
// (row), b 16 x 8 bf16 (col), c 16 x 8 f32. Lane (g = lane / 4, t = lane % 4)
// holds a: (g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..); b: (k
// 2t..2t+1, n g), (k 2t+8.., n g); c: (g, 2t..2t+1), (g+8, 2t..). An
// accumulator of 16 rows x 8 N columns, held as N mma tiles, has the a
// layout: it becomes the A operand of the next product in registers.
//
// Shared-memory tiles are row-major with rows padded by 8 elements, so the
// 32-bit fragment loads of a warp and the eight 16-byte rows of an ldmatrix
// hit distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// c += a * b for one m16n8k16 tile, f32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two floats rounded to bf16 (nearest even), `lo` in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A operand: the 16 x 16 block at (row0, k0) of a row-major tile
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int stride, int row0, int k0, int g,
                                       int t) {
  const bf16* p = tile + (row0 + g) * stride + k0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * stride);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * stride + 8);
}

// B operand B[k][n] = tile[n0 + n][k0 + k]: a tile stored n-major with the
// contraction axis contiguous
__device__ __forceinline__ void load_b(uint32_t (&b)[2], const bf16* tile,
                                       int stride, int n0, int k0, int g,
                                       int t) {
  const bf16* p = tile + (n0 + g) * stride + k0 + 2 * t;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// B operands of the two n8 tiles [n0, n0 + 16) of B[k][n] = tile[k0 + k][n]:
// a row-major tile whose rows run along the contraction (V in P V, K in
// dS K, dO in P^T dO, Q in dS^T Q), read transposed by one ldmatrix.
// Lanes 0-15 address rows k0..k0+15 at column n0, lanes 16-31 the same rows
// at n0 + 8; matrix i (lanes 8i..8i+7) lands in register i.
__device__ __forceinline__ void load_bt(uint32_t (&b0)[2], uint32_t (&b1)[2],
                                        const bf16* tile, int stride, int k0,
                                        int n0, int lane) {
  const bf16* p = tile + (k0 + (lane & 15)) * stride + n0 + (lane >> 4) * 8;
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(b0[0]), "=r"(b0[1]), "=r"(b1[0]), "=r"(b1[1])
      : "r"(addr));
}

// The A operand of a product over the 16 columns [16 kk, 16 kk + 16) of a
// 16 x 8N accumulator held as N mma tiles: its c layout is the a layout,
// rounded to bf16.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&s)[N][4], int kk) {
  a[0] = pack(s[2 * kk][0], s[2 * kk][1]);
  a[1] = pack(s[2 * kk][2], s[2 * kk][3]);
  a[2] = pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  a[3] = pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

// The same block split in two bf16 operands, hi = bf16(x) and lo = bf16(x -
// hi): hi B + lo B keeps ~16 bits of x where one rounding keeps 8.
template <int N>
__device__ __forceinline__ void acc_to_a_split(uint32_t (&hi)[4],
                                               uint32_t (&lo)[4],
                                               const float (&s)[N][4],
                                               int kk) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x0 = s[2 * kk + (i >> 1)][2 * (i & 1)];
    const float x1 = s[2 * kk + (i >> 1)][2 * (i & 1) + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = pack(x0 - hf.x, x1 - hf.y);
  }
}

// An accumulator entry i of tile n sits at row (g + 8 (i / 2)) of the
// warp's 16 and column (8 n + 2 t + i % 2): a row's entries live in the
// four lanes of one quad.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---- cp.async: global -> shared copies that run beside the compute ----

// 16 bytes; `valid` false writes 16 zero bytes and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes, the same zero fill
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace
