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
// Every product named above is computed here, in one tile engine: a block
// owns a 64 x 128 output tile (64 x 32 or 64 x 64 for the FFN's hidden
// chunks) and walks the contraction in chunks of 32, staging both operands
// in shared memory in the layout the inner loop wants (row or transposed,
// whatever the operand's layout in device memory). The LayerNorm is
// applied while the x operand is staged, from per-row (mean, rstd) that a
// small first kernel writes: x^ never goes to device memory. K9's forward
// keeps each 64 x 32 hidden chunk a = relu(x^ W1 + b1) in shared memory
// and multiplies it into the 64 x 128 output tile at once, so the (N, F)
// hidden never leaves the chip either; the price is that each of the
// D / 128 output-column blocks recomputes its rows' z.
//
// Cross-row sums (dW, dg, db, db1): the TPU accumulates them across its
// sequential grid. Blocks here run in parallel and in no order, so the rows
// are cut into S fixed groups, each block writes the f32 partial of its
// group, and the caller sums the S partials in a fixed order. No float
// atomics: two runs give the same bits. db1's partials are per 64-row
// tile, summed the same way.
//
// The backward's structure differs from the TPU's where shared memory
// forces it: the row reductions of the LN backward need whole rows of dxn,
// which a 128-column tile does not hold, so dxn goes to device memory in
// f32 (N x D) and two small kernels finish dx and the dg/db partials;
// K9's backward writes a and dz (N x F, io dtype) once and runs dW2, dW1
// and dxn as three products over them (the TPU recomputes them per hidden
// chunk inside VMEM). K9's LN backward uses the f32 dxn, where the JAX
// package rounds dxn to the io dtype and runs the LN backward in it.
//
// Rounding follows the Pallas kernels: x^ to the io dtype before each
// product, relu(z) and dz to the io dtype, weight gradients accumulated in
// f32 and rounded once by the caller.
//
// What bounds it on this card: at the published width (N 16384 = B 64 x T
// 256, D 512, F 2048) the forward products are 25.8 GFLOP (K8) and 68.7
// GFLOP (K9) against 67 MB and 42 MB of bf16 traffic, so in bf16 the
// tensor cores decide (about 0.03 and 0.07 ms at 989 TFLOP/s) and in f32
// the FMA units (0.39 and 1.0 ms at 67 TFLOP/s). The design keeps every
// operand tile in shared memory and every accumulator in registers.
//
// Two paths, one contract (x (N, D), W (D, D), W1 (D, F), W2 (F, D), all
// contiguous, one dtype; N % 64 == 0, D % 128 == 0, F % 128 == 0):
//   bf16  tensor cores, mma.sync m16n8k16 (bf16 operands, f32 accumulate),
//         4 warps, each 16 rows of the 64-row tile; staged rows padded by
//         8 elements so a warp's 32-bit fragment loads hit 32 banks.
//   f32   element-wise f32 FMA, never TF32: 256 threads as a 16 x 16
//         grid, thread (ty, tx) owns entries (ty + 16 i, tx + 16 j);
//         staged rows padded by one float.
// Simple and right first: no cp.async/TMA pipelining, no wgmma, scalar
// staging loads -- later perf_opt work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;    // rows of an output tile
constexpr int BN = 128;   // columns of an output tile
constexpr int BK = 32;    // contraction chunk staged in shared memory
constexpr int HC = 32;    // hidden chunk of the FFN forward (= BK)
constexpr int ZC = 64;    // hidden columns of an FFN backward tile
constexpr float EPS = 1e-5f;

template <typename T> struct Cfg;
template <> struct Cfg<float> {
  static constexpr int threads = 256, pad = 1;
};
template <> struct Cfg<bf16> {
  static constexpr int threads = 128, pad = 8;
};
template <typename T> constexpr int KS = BK + Cfg<T>::pad;  // staged stride

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The LayerNorm of one element of x, rounded to the io dtype:
// ((x - mean) * rstd) * g[col] + b[col] from the row's (mean, rstd).
template <typename T>
struct LN {
  const float2* stats;
  const T* g;
  const T* b;
  __device__ __forceinline__ T operator()(T x, int row, int col) const {
    const float2 st = stats[row];
    return from_f<T>((to_f(x) - st.x) * st.y * to_f(g[col]) + to_f(b[col]));
  }
};

// dst[r][k] (stride KS<T>) = element (r0 + r, k0 + k) of the row-major
// array src (row stride ld), for r < R, k < BK; LayerNormed when LNA.
template <typename T, int R, bool LNA>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src,
                                           long long ld, int r0, int k0,
                                           const LN<T>& ln) {
  for (int i = threadIdx.x; i < R * BK; i += Cfg<T>::threads) {
    const int r = i / BK, k = i % BK;
    T x = src[(r0 + r) * ld + k0 + k];
    if constexpr (LNA) x = ln(x, r0 + r, k0 + k);
    dst[r * KS<T> + k] = x;
  }
}

// dst[r][k] = element (k0 + k, r0 + r) of src: a tile of its transpose.
// Consecutive threads read consecutive columns of one row (coalesced).
template <typename T, int R, bool LNA>
__device__ __forceinline__ void stage_cols(T* dst, const T* __restrict__ src,
                                           long long ld, int r0, int k0,
                                           const LN<T>& ln) {
  for (int i = threadIdx.x; i < R * BK; i += Cfg<T>::threads) {
    const int r = i % R, k = i / R;
    T x = src[(k0 + k) * ld + r0 + r];
    if constexpr (LNA) x = ln(x, k0 + k, r0 + r);
    dst[r * KS<T> + k] = x;
  }
}

// ===================== bf16: tensor-core tiles =========================

// c += a * b for one m16n8k16 tile: a 16 x 16 bf16 (row), b 16 x 8 bf16
// (col), c 16 x 8 f32. Lane (g = lane / 4, t = lane % 4) holds
// a: (g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..);
// b: (k 2t..2t+1, n g), (k 2t+8.., n g); c: (g, 2t..2t+1), (g+8, 2t..).
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

template <typename T, int NC> struct Tile;

// A 64 x NC f32 accumulator over 4 warps: warp w holds rows 16 w .. 16 w +
// 15 as NC / 8 mma tiles; entry i of tile n is row g + 8 (i / 2), column
// 8 n + 2 t + i % 2.
template <int NC> struct Tile<bf16, NC> {
  float acc[NC / 8][4];
  int r0, g, t;
  __device__ __forceinline__ void init() {
    const int lane = threadIdx.x & 31;
    g = lane >> 2;
    t = lane & 3;
    r0 = (threadIdx.x >> 5) * 16;
#pragma unroll
    for (int n = 0; n < NC / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  }
  // acc += As (64 x BK) * Bs^T, Bs staged NC x BK (contraction contiguous)
  __device__ __forceinline__ void chunk(const bf16* As, const bf16* Bs) {
    constexpr int S = KS<bf16>;
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      const bf16* p = As + (r0 + g) * S + kc * 16 + 2 * t;
      const uint32_t a[4] = {ld32(p), ld32(p + 8 * S), ld32(p + 8),
                             ld32(p + 8 * S + 8)};
#pragma unroll
      for (int n = 0; n < NC / 8; ++n) {
        const bf16* q = Bs + (n * 8 + g) * S + kc * 16 + 2 * t;
        const uint32_t b[2] = {ld32(q), ld32(q + 8)};
        mma(acc[n], a, b);
      }
    }
  }
  // f(row, column, entry, the same entry of `o`) for every owned entry
  template <typename F>
  __device__ __forceinline__ void each2(Tile& o, F f) {
#pragma unroll
    for (int n = 0; n < NC / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        f(r0 + g + 8 * (i >> 1), 8 * n + 2 * t + (i & 1), acc[n][i],
          o.acc[n][i]);
  }
  template <typename F>
  __device__ __forceinline__ void each(F f) {
    each2(*this, [&](int r, int c, float& v, float&) { f(r, c, v); });
  }
};

// ===================== f32: element-wise FMA ===========================

// A 64 x NC f32 accumulator over a 16 x 16 thread grid: thread (ty, tx)
// holds rows ty + 16 i, columns tx + 16 j.
template <int NC> struct Tile<float, NC> {
  float acc[4][NC / 16];
  int ty, tx;
  __device__ __forceinline__ void init() {
    tx = threadIdx.x & 15;
    ty = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC / 16; ++j) acc[i][j] = 0.f;
  }
  __device__ __forceinline__ void chunk(const float* As, const float* Bs) {
    constexpr int S = KS<float>;
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float a[4], b[NC / 16];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[(ty + 16 * i) * S + k];
#pragma unroll
      for (int j = 0; j < NC / 16; ++j) b[j] = Bs[(tx + 16 * j) * S + k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC / 16; ++j)
          acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  template <typename F>
  __device__ __forceinline__ void each2(Tile& o, F f) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC / 16; ++j)
        f(ty + 16 * i, tx + 16 * j, acc[i][j], o.acc[i][j]);
  }
  template <typename F>
  __device__ __forceinline__ void each(F f) {
    each2(*this, [&](int r, int c, float& v, float&) { f(r, c, v); });
  }
};

// ===================== kernels =========================================

// Per-row (mean, rstd) of x (N, D): one warp a row, two passes in f32.
template <typename T>
__global__ void __launch_bounds__(256)
    ln_stats(const T* __restrict__ x, float2* __restrict__ stats, int N,
             int D) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= N) return;
  const T* xr = x + (size_t)row * D;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s += to_f(xr[c]);
  const float mu = warp_sum(s) / D;
  float v = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float d = to_f(xr[c]) - mu;
    v += d * d;
  }
  v = warp_sum(v) / D;
  if (lane == 0) stats[row] = make_float2(mu, 1.f / sqrtf(v + EPS));
}

// C[j] (M x Ncols) = sum over q < nsum of A[j + q] * B[j + q] over the
// contraction rows of split s, for blockIdx.z = j * S + s. A is (M, K)
// row-major, or (K, M) row-major when A_KM (then read transposed); B is
// (K, Ncols) row-major when B_KN, else (Ncols, K) row-major (read as its
// transpose). LNA LayerNorms A's elements as x's while staging them.
// Split s covers contraction rows [s kc, min(K, (s + 1) kc)) and writes
// its partial at C[j] + s csplit.
struct GemmArgs {
  const void* A[3];
  const void* B[3];
  void* C[3];
  long long lda, ldb, ldc, csplit;
  int K, kc, S, nsum, out_f32;
  const float2* stats;
  const void* g;
  const void* b;
};

template <typename T, bool A_KM, bool LNA, bool B_KN>
__global__ void __launch_bounds__(Cfg<T>::threads) gemm(const GemmArgs p) {
  __shared__ __align__(16) T As[BM * KS<T>];
  __shared__ __align__(16) T Bs[BN * KS<T>];
  const int j = blockIdx.z / p.S, s = blockIdx.z % p.S;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kbeg = s * p.kc, kend = min(p.K, kbeg + p.kc);
  const LN<T> ln{p.stats, static_cast<const T*>(p.g),
                 static_cast<const T*>(p.b)};
  Tile<T, BN> acc;
  acc.init();
  for (int q = 0; q < p.nsum; ++q) {
    const T* A = static_cast<const T*>(p.A[j + q]);
    const T* B = static_cast<const T*>(p.B[j + q]);
    for (int k0 = kbeg; k0 < kend; k0 += BK) {
      __syncthreads();  // the previous chunk is consumed
      if constexpr (A_KM)
        stage_cols<T, BM, LNA>(As, A, p.lda, m0, k0, ln);
      else
        stage_rows<T, BM, LNA>(As, A, p.lda, m0, k0, ln);
      if constexpr (B_KN)
        stage_cols<T, BN, false>(Bs, B, p.ldb, n0, k0, ln);
      else
        stage_rows<T, BN, false>(Bs, B, p.ldb, n0, k0, ln);
      __syncthreads();
      acc.chunk(As, Bs);
    }
  }
  const size_t base = (size_t)s * p.csplit + (size_t)m0 * p.ldc + n0;
  if (p.out_f32) {
    float* C = static_cast<float*>(p.C[j]) + base;
    acc.each([&](int r, int c, float& v) { C[r * p.ldc + c] = v; });
  } else {
    T* C = static_cast<T*>(p.C[j]) + base;
    acc.each([&](int r, int c, float& v) { C[r * p.ldc + c] = from_f<T>(v); });
  }
}

// K9 forward: f (64 rows x 128 columns) = sum over hidden chunks c of
// relu(x^ W1[:, c] + b1[c]) W2[c, :], plus b2. Each chunk's z (64 x 32) is
// accumulated over D, turned into a (rounded) in shared memory and
// multiplied into the output tile at once.
template <typename T>
__global__ void __launch_bounds__(Cfg<T>::threads)
    ffn_fwd(const T* __restrict__ x, LN<T> ln, const T* __restrict__ w1,
            const T* __restrict__ b1, const T* __restrict__ w2,
            const T* __restrict__ b2, T* __restrict__ f, int D, int F) {
  __shared__ __align__(16) T As[BM * KS<T>];   // x^ chunk
  __shared__ __align__(16) T B1[HC * KS<T>];   // W1 chunk, transposed
  __shared__ __align__(16) T Hs[BM * KS<T>];   // a chunk (HC == BK)
  __shared__ __align__(16) T B2[BN * KS<T>];   // W2 chunk, transposed
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  Tile<T, BN> out;
  out.init();
  for (int c0 = 0; c0 < F; c0 += HC) {
    Tile<T, HC> z;
    z.init();
    for (int k0 = 0; k0 < D; k0 += BK) {
      __syncthreads();
      stage_rows<T, BM, true>(As, x, D, m0, k0, ln);
      stage_cols<T, HC, false>(B1, w1, F, c0, k0, ln);
      __syncthreads();
      z.chunk(As, B1);
    }
    // Hs and B2 were last read before the syncs of the loop above
    z.each([&](int r, int c, float& v) {
      Hs[r * KS<T> + c] = from_f<T>(fmaxf(v + to_f(b1[c0 + c]), 0.f));
    });
    stage_cols<T, BN, false>(B2, w2, D, n0, c0, ln);
    __syncthreads();
    out.chunk(Hs, B2);
  }
  out.each([&](int r, int c, float& v) {
    f[(size_t)(m0 + r) * D + n0 + c] = from_f<T>(v + to_f(b2[n0 + c]));
  });
}

// K9 backward, first step, for a 64-row x 64-hidden tile: z = x^ W1 + b1
// and da = df W2^T over D; a = relu(z) and dz = (z > 0) da, both rounded,
// to device memory; the tile's column sums of dz (f32, unrounded) to
// db1_part[row tile].
template <typename T>
__global__ void __launch_bounds__(Cfg<T>::threads)
    ffn_dz(const T* __restrict__ x, LN<T> ln, const T* __restrict__ w1,
           const T* __restrict__ b1, const T* __restrict__ w2,
           const T* __restrict__ df, T* __restrict__ a_out,
           T* __restrict__ dz_out, float* __restrict__ db1_part, int D,
           int F) {
  constexpr int TB = BM * KS<T> * sizeof(T);  // bytes of one staged tile
  static_assert(4 * TB >= BM * (ZC + 1) * 4, "the sums reuse the tiles");
  __shared__ __align__(16) unsigned char smem[4 * TB];
  T* As = reinterpret_cast<T*>(smem);            // x^ chunk
  T* Ad = reinterpret_cast<T*>(smem + TB);       // df chunk
  T* B1 = reinterpret_cast<T*>(smem + 2 * TB);   // W1 chunk, transposed
  T* B2 = reinterpret_cast<T*>(smem + 3 * TB);   // W2 rows of the chunk
  const int m0 = blockIdx.y * BM, c0 = blockIdx.x * ZC;
  Tile<T, ZC> z, da;
  z.init();
  da.init();
  for (int k0 = 0; k0 < D; k0 += BK) {
    __syncthreads();
    stage_rows<T, BM, true>(As, x, D, m0, k0, ln);
    stage_rows<T, BM, false>(Ad, df, D, m0, k0, ln);
    stage_cols<T, ZC, false>(B1, w1, F, c0, k0, ln);
    stage_rows<T, ZC, false>(B2, w2, D, c0, k0, ln);
    __syncthreads();
    z.chunk(As, B1);
    da.chunk(Ad, B2);
  }
  __syncthreads();  // the staged tiles become the column-sum buffer
  float* red = reinterpret_cast<float*>(smem);
  z.each2(da, [&](int r, int c, float& zv, float& dv) {
    const float zz = zv + to_f(b1[c0 + c]);
    const float dz = zz > 0.f ? dv : 0.f;
    const size_t at = (size_t)(m0 + r) * F + c0 + c;
    a_out[at] = from_f<T>(fmaxf(zz, 0.f));
    dz_out[at] = from_f<T>(dz);
    red[r * (ZC + 1) + c] = dz;
  });
  __syncthreads();
  if (threadIdx.x < ZC) {
    float s = 0.f;
    for (int r = 0; r < BM; ++r) s += red[r * (ZC + 1) + threadIdx.x];
    db1_part[(size_t)blockIdx.y * F + c0 + threadIdx.x] = s;
  }
}

// dx of the LayerNorm from f32 dxn: one warp a row.
template <typename T>
__global__ void __launch_bounds__(256)
    ln_bwd_dx(const T* __restrict__ x, const float2* __restrict__ stats,
              const T* __restrict__ g, const float* __restrict__ dxn,
              T* __restrict__ dx, int N, int D) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= N) return;
  const float2 st = stats[row];
  const T* xr = x + (size_t)row * D;
  const float* dr = dxn + (size_t)row * D;
  float m1 = 0.f, m2 = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float gh = dr[c] * to_f(g[c]);
    m1 += gh;
    m2 += gh * ((to_f(xr[c]) - st.x) * st.y);
  }
  m1 = warp_sum(m1) / D;
  m2 = warp_sum(m2) / D;
  for (int c = lane; c < D; c += 32) {
    const float xh = (to_f(xr[c]) - st.x) * st.y;
    const float gh = dr[c] * to_f(g[c]);
    dx[(size_t)row * D + c] = from_f<T>((gh - m1 - xh * m2) * st.y);
  }
}

// The f32 partials of dg = colsum(dxn x^) and db = colsum(dxn) over the
// rows [s rows, (s + 1) rows) of split s = blockIdx.y: part (S, 2, D).
template <typename T>
__global__ void __launch_bounds__(128)
    ln_bwd_dgb(const T* __restrict__ x, const float2* __restrict__ stats,
               const float* __restrict__ dxn, float* __restrict__ part,
               int N, int D, int rows) {
  const int col = blockIdx.x * 128 + threadIdx.x;
  const int rbeg = (int)blockIdx.y * rows;
  const int rend = min(N, rbeg + rows);
  float sg = 0.f, sb = 0.f;
  for (int r = rbeg; r < rend; ++r) {
    const float2 st = stats[r];
    const float d = dxn[(size_t)r * D + col];
    sg += d * ((to_f(x[(size_t)r * D + col]) - st.x) * st.y);
    sb += d;
  }
  part[((size_t)blockIdx.y * 2) * D + col] = sg;
  part[((size_t)blockIdx.y * 2 + 1) * D + col] = sb;
}

// ===================== launch =========================================

#define CHECK_LAUNCH()                              \
  do {                                              \
    const cudaError_t e = cudaGetLastError();       \
    if (e != cudaSuccess) return (int)e;            \
  } while (0)

template <typename T>
int stats_launch(const void* x, float2* stats, int N, int D,
                 cudaStream_t st) {
  ln_stats<T><<<(N + 7) / 8, 256, 0, st>>>(static_cast<const T*>(x), stats,
                                          N, D);
  CHECK_LAUNCH();
  return 0;
}

template <typename T, bool A_KM, bool LNA, bool B_KN>
int gemm_launch(const GemmArgs& p, int M, int Ncols, int Z,
                cudaStream_t st) {
  gemm<T, A_KM, LNA, B_KN>
      <<<dim3(Ncols / BN, M / BM, Z), Cfg<T>::threads, 0, st>>>(p);
  CHECK_LAUNCH();
  return 0;
}

template <typename T>
int ln_bwd_launch(const void* x, const float2* stats, const void* g,
                  const float* dxn, void* dx, float* dgb_part, int N, int D,
                  int S, int rows, cudaStream_t st) {
  ln_bwd_dx<T><<<(N + 7) / 8, 256, 0, st>>>(
      static_cast<const T*>(x), stats, static_cast<const T*>(g), dxn,
      static_cast<T*>(dx), N, D);
  CHECK_LAUNCH();
  ln_bwd_dgb<T><<<dim3(D / 128, S), 128, 0, st>>>(
      static_cast<const T*>(x), stats, dxn, dgb_part, N, D, rows);
  CHECK_LAUNCH();
  return 0;
}

template <typename T>
int qkv_fwd(const void* x, const void* g, const void* b, const void* wq,
            const void* wk, const void* wv, void* q, void* k, void* v,
            float2* stats, int N, int D, cudaStream_t st) {
  if (int rc = stats_launch<T>(x, stats, N, D, st)) return rc;
  GemmArgs p{{x, x, x}, {wq, wk, wv}, {q, k, v}, D, D, D, 0,
             D, D, 1, 1, 0, stats, g, b};
  return gemm_launch<T, false, true, true>(p, N, D, 3, st);
}

template <typename T>
int qkv_bwd(const void* x, const void* g, const void* b, const void* wq,
            const void* wk, const void* wv, const void* dq, const void* dk,
            const void* dv, void* dx, float2* stats, float* dxn,
            float* dw_part, float* dgb_part, int N, int D, int S,
            cudaStream_t st) {
  const int rows = (N / S + BK - 1) / BK * BK;  // contraction rows a split
  if (int rc = stats_launch<T>(x, stats, N, D, st)) return rc;
  // dxn = dq Wq^T + dk Wk^T + dv Wv^T, f32
  GemmArgs pd{{dq, dk, dv}, {wq, wk, wv}, {dxn}, D, D, D, 0,
              D, D, 1, 3, 1, stats, g, b};
  if (int rc = gemm_launch<T, false, false, false>(pd, N, D, 1, st))
    return rc;
  // dW_j partials: x^T dy_j over each split's rows, (3, S, D, D) f32
  const size_t DD = (size_t)D * D;
  GemmArgs pw{{x, x, x}, {dq, dk, dv},
              {dw_part, dw_part + S * DD, dw_part + 2 * S * DD},
              D, D, D, (long long)DD, N, rows, S, 1, 1, stats, g, b};
  if (int rc = gemm_launch<T, true, true, true>(pw, D, D, 3 * S, st))
    return rc;
  return ln_bwd_launch<T>(x, stats, g, dxn, dx, dgb_part, N, D, S, rows,
                          st);
}

template <typename T>
int ffn_fwd_launch(const void* x, const void* g, const void* b,
                   const void* w1, const void* b1, const void* w2,
                   const void* b2, void* f, float2* stats, int N, int D,
                   int F, cudaStream_t st) {
  if (int rc = stats_launch<T>(x, stats, N, D, st)) return rc;
  auto c = [](const void* p) { return static_cast<const T*>(p); };
  ffn_fwd<T><<<dim3(D / BN, N / BM), Cfg<T>::threads, 0, st>>>(
      c(x), LN<T>{stats, c(g), c(b)}, c(w1), c(b1), c(w2), c(b2),
      static_cast<T*>(f), D, F);
  CHECK_LAUNCH();
  return 0;
}

template <typename T>
int ffn_bwd_launch(const void* x, const void* g, const void* b,
                   const void* w1, const void* b1, const void* w2,
                   const void* df, void* dx, float2* stats, void* a,
                   void* dz, float* db1_part, float* dw1_part,
                   float* dw2_part, float* dxn, float* dgb_part, int N,
                   int D, int F, int S, cudaStream_t st) {
  const int rows = (N / S + BK - 1) / BK * BK;
  if (int rc = stats_launch<T>(x, stats, N, D, st)) return rc;
  auto c = [](const void* p) { return static_cast<const T*>(p); };
  ffn_dz<T><<<dim3(F / ZC, N / BM), Cfg<T>::threads, 0, st>>>(
      c(x), LN<T>{stats, c(g), c(b)}, c(w1), c(b1), c(w2), c(df),
      static_cast<T*>(a), static_cast<T*>(dz), db1_part, D, F);
  CHECK_LAUNCH();
  // dW2 partials (S, F, D): a^T df
  GemmArgs p2{{a}, {df}, {dw2_part}, F, D, D, (long long)F * D,
              N, rows, S, 1, 1, stats, g, b};
  if (int rc = gemm_launch<T, true, false, true>(p2, F, D, S, st))
    return rc;
  // dW1 partials (S, D, F): x^T dz
  GemmArgs p1{{x}, {dz}, {dw1_part}, D, F, F, (long long)D * F,
              N, rows, S, 1, 1, stats, g, b};
  if (int rc = gemm_launch<T, true, true, true>(p1, D, F, S, st))
    return rc;
  // dxn (N, D) f32: dz W1^T
  GemmArgs px{{dz}, {w1}, {dxn}, F, F, D, 0, F, F, 1, 1, 1, stats, g, b};
  if (int rc = gemm_launch<T, false, false, false>(px, N, D, 1, st))
    return rc;
  return ln_bwd_launch<T>(x, stats, g, dxn, dx, dgb_part, N, D, S, rows,
                          st);
}

bool shapes_ok(int N, int D, int F, int S) {
  return N > 0 && N % BM == 0 && N / BM <= 65535 && D > 0 && D % BN == 0 &&
         F > 0 && F % BN == 0 && S > 0 && S <= 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Every array is contiguous and
// row-major: x (N, D), g and b (D), W (D, D), W1 (D, F), b1 (F), W2 (F, D),
// b2 (D); stats is an (N) float2 scratch of (mean, rstd). Each returns 0
// on success, -1 for an unsupported dtype or shape, else the cudaError_t
// of the first failed launch.

// q, k, v = LN(x) Wq, LN(x) Wk, LN(x) Wv.
extern "C" int ln_qkv_fwd_launch(int dtype, const void* x, const void* g,
                                 const void* b, const void* wq,
                                 const void* wk, const void* wv, void* q,
                                 void* k, void* v, void* stats, int N, int D,
                                 void* stream) {
  if (!shapes_ok(N, D, BN, 1)) return -1;
  auto st = static_cast<cudaStream_t>(stream);
  auto s2 = static_cast<float2*>(stats);
  if (dtype == 0) return qkv_fwd<float>(x, g, b, wq, wk, wv, q, k, v, s2, N,
                                        D, st);
  if (dtype == 1) return qkv_fwd<bf16>(x, g, b, wq, wk, wv, q, k, v, s2, N,
                                       D, st);
  return -1;
}

// dx (N, D) in the io dtype; f32 partials over S row splits: dw_part
// (3, S, D, D) of dWq, dWk, dWv, dgb_part (S, 2, D) of dg and db; dxn an
// (N, D) f32 scratch.
extern "C" int ln_qkv_bwd_launch(int dtype, const void* x, const void* g,
                                 const void* b, const void* wq,
                                 const void* wk, const void* wv,
                                 const void* dq, const void* dk,
                                 const void* dv, void* dx, void* stats,
                                 void* dxn, void* dw_part, void* dgb_part,
                                 int N, int D, int S, void* stream) {
  if (!shapes_ok(N, D, BN, S)) return -1;
  auto st = static_cast<cudaStream_t>(stream);
  auto s2 = static_cast<float2*>(stats);
  auto f = [](void* p) { return static_cast<float*>(p); };
  if (dtype == 0)
    return qkv_bwd<float>(x, g, b, wq, wk, wv, dq, dk, dv, dx, s2, f(dxn),
                          f(dw_part), f(dgb_part), N, D, S, st);
  if (dtype == 1)
    return qkv_bwd<bf16>(x, g, b, wq, wk, wv, dq, dk, dv, dx, s2, f(dxn),
                         f(dw_part), f(dgb_part), N, D, S, st);
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
    return ffn_fwd_launch<float>(x, g, b, w1, b1, w2, b2, f, s2, N, D, F,
                                 st);
  if (dtype == 1)
    return ffn_fwd_launch<bf16>(x, g, b, w1, b1, w2, b2, f, s2, N, D, F, st);
  return -1;
}

// dx (N, D) in the io dtype; f32 partials: db1_part (N / 64, F), dw1_part
// (S, D, F), dw2_part (S, F, D), dgb_part (S, 2, D); a and dz (N, F) in
// the io dtype and dxn (N, D) f32 are scratch.
extern "C" int ln_ffn_bwd_launch(int dtype, const void* x, const void* g,
                                 const void* b, const void* w1,
                                 const void* b1, const void* w2,
                                 const void* df, void* dx, void* stats,
                                 void* a, void* dz, void* db1_part,
                                 void* dw1_part, void* dw2_part, void* dxn,
                                 void* dgb_part, int N, int D, int F, int S,
                                 void* stream) {
  if (!shapes_ok(N, D, F, S)) return -1;
  auto st = static_cast<cudaStream_t>(stream);
  auto s2 = static_cast<float2*>(stats);
  auto f = [](void* p) { return static_cast<float*>(p); };
  if (dtype == 0)
    return ffn_bwd_launch<float>(x, g, b, w1, b1, w2, df, dx, s2, a, dz,
                                 f(db1_part), f(dw1_part), f(dw2_part),
                                 f(dxn), f(dgb_part), N, D, F, S, st);
  if (dtype == 1)
    return ffn_bwd_launch<bf16>(x, g, b, w1, b1, w2, df, dx, s2, a, dz,
                                f(db1_part), f(dw1_part), f(dw2_part),
                                f(dxn), f(dgb_part), N, D, F, S, st);
  return -1;
}
