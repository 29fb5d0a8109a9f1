// K13: grouped GEMM over variable-size expert groups, bf16 operands and
// float32 accumulation, for the dropless routed FFN (models/moe.py,
// dispatch "grouped").
//
// It replaces no Pallas kernel: the JAX package computes its experts by
// dense einsums over (E, C) capacity slots, which drop tokens past C and,
// without drops, compute E / k times the assigned rows. Here the routed
// rows are sorted by expert, and group e owns the rows [offs[e], offs[e+1])
// of the sorted order; offs lives on the device, so nothing is read back
// to the host to size a launch.
//
// Two kernels:
//
//   rows:  C[r, :] = A[ia(r), :] @ B_e          for r in group e
//          ia(r) = a_idx[r] (a row gather, the token of a routed row) or r;
//          B_e = W[e] (K x N, row-major) or, with BT, W[e]^T for W (El, N, K).
//          Rows [offs[El], M) of C (the tail past the routed rows) are
//          written with zeros, so every row of C is defined.
//   dw:    C_e = A[ia(rows of e)]^T @ D[rows of e]  (K x N), zero for an
//          empty group.
//
// The forward product is `rows`, dX is `rows` with BT, dW is `dw`.
//
// What bounds it on the H100: at the routed FFN's shapes (K, N of 896 to
// 2304, ~1,024 rows a group) every product does ~100-900 operations a byte,
// so it is bound by the tensor cores. Design: 128 x 128 output tiles, eight
// warps of 64 x 32, mma.sync m16n8k16 fed by ldmatrix from a three-stage
// cp.async ring of 32-deep slices, two CTAs (16 warps) an SM. Four warps of
// 64 x 64 on 64-deep slices (230 registers a thread, 8 warps an SM) ran no
// faster on the H100, and the weight gradient 20% slower. Rows are gathered
// by the cp.async addresses themselves (16 bytes a thread, a row's chunks
// contiguous), so the gathered operand is never written to device memory.
// A row tile never straddles two groups; the grid covers the most tiles any
// routing can need (M / 128 + El + 1), and the tiles past the last group
// zero the tail.
//
// Shared tiles are padded by 8 elements a row so that the eight 16-byte rows
// of an ldmatrix fall in distinct banks.

#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, THREADS = 256;
constexpr int AP = BK + 8;    // rows kernel: A tile [BM][AP]
constexpr int BP = BN + 8;    // B / D tile [BK][BP], the contraction in rows
constexpr int BTP = BK + 8;   // rows kernel, BT: B tile [BN][BTP]
constexpr int DAP = BM + 8;   // dw kernel: A tile [BK][DAP]
constexpr int ROWS_STAGE = BM * AP + (BN * BTP > BK * BP ? BN * BTP : BK * BP);
constexpr int DW_STAGE = BK * DAP + BK * BP;
constexpr int ROWS_SMEM = STAGES * ROWS_STAGE * 2;
constexpr int DW_SMEM = STAGES * DW_STAGE * 2;

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// The row tile `t` of the grid: group e (or -1 past the groups: a tail tile
// to zero), its first row and its row count (0: nothing to do).
struct RowTile {
  int e, row0, rows;
};

__device__ __forceinline__ RowTile row_tile(const int* offs, int El, int M,
                                            int t) {
  for (int e = 0; e < El; ++e) {
    const int lo = offs[e], cnt = offs[e + 1] - lo;
    const int nt = (cnt + BM - 1) / BM;
    if (t < nt) return {e, lo + t * BM, min(BM, cnt - t * BM)};
    t -= nt;
  }
  const int row0 = offs[El] + t * BM;
  return {-1, row0, max(0, min(BM, M - row0))};
}

// B fragments of the two n8 tiles [n0, n0 + 16) x k [k0, k0 + 16) from a
// tile stored n-major with the contraction contiguous: matrix i of the x4
// (lanes 8i..8i+7) is n (i / 2) * 8 + lane % 8, k (i % 2) * 8.
__device__ __forceinline__ void load_b_nk(uint32_t (&b0)[2],
                                          uint32_t (&b1)[2], const bf16* tile,
                                          int stride, int n0, int k0,
                                          int lane) {
  uint32_t r[4];
  ldsm_x4(r, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * stride + k0 +
                 (((lane >> 3) & 1) << 3));
  b0[0] = r[0];
  b0[1] = r[1];
  b1[0] = r[2];
  b1[1] = r[3];
}

__device__ __forceinline__ void zero(float (&acc)[4][4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
}

// Store a warp's 64 x 32 accumulator at (r0, c0) of a row-major bf16 C of
// `rows` x `cols` valid entries, `ld` elements a row.
__device__ __forceinline__ void store(const float (&acc)[4][4][4], bf16* C,
                                      int ld, int r0, int c0, int rows,
                                      int cols, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + i * 16 + g + h * 8;
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + j * 8 + 2 * t4;
        if (c < cols)
          *reinterpret_cast<uint32_t*>(C + (size_t)r * ld + c) =
              pack(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

template <bool BT>
__global__ void __launch_bounds__(THREADS)
    grouped_gemm_rows(const bf16* __restrict__ A,
                      const int* __restrict__ a_idx,
                      const bf16* __restrict__ W, bf16* __restrict__ C,
                      const int* __restrict__ offs, int El, int M, int K,
                      int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const RowTile tile = row_tile(offs, El, M, blockIdx.y);
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  if (tile.rows <= 0) return;
  if (tile.e < 0) {  // a tail tile: zeros
    const int chunks = BN / 8;
    for (int c = tid; c < tile.rows * chunks; c += THREADS) {
      const int r = c / chunks, n = n0 + (c % chunks) * 8;
      if (n < N)
        *reinterpret_cast<uint4*>(C + (size_t)(tile.row0 + r) * N + n) =
            make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const bf16* We = W + (size_t)tile.e * K * N;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;

  // this thread's two A chunks: rows tid / 4 and tid / 4 + 64, column
  // chunk tid % 4 of each 32-deep slice; their source rows are fixed
  const int a_cc = (tid & 3) * 8;
  const bf16* a_src[2];
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = (tid >> 2) + i * 64;
    a_ok[i] = r < tile.rows;
    const int row = tile.row0 + (a_ok[i] ? r : 0);
    a_src[i] = A + (size_t)(a_idx ? a_idx[row] : row) * K;
  }

  auto load = [&](int stage, int kt) {
    bf16* As = smem + stage * ROWS_STAGE;
    bf16* Bs = As + BM * AP;
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = (tid >> 2) + i * 64, k = k0 + a_cc;
      const bool ok = a_ok[i] && k < K;
      cp_async16(As + r * AP + a_cc, ok ? a_src[i] + k : A, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      if (BT) {  // [BN][BTP]: row n, chunk of k
        const int r = c >> 2, cc = (c & 3) * 8;
        const int n = n0 + r, k = k0 + cc;
        const bool ok = n < N && k < K;
        cp_async16(Bs + r * BTP + cc, ok ? We + (size_t)n * K + k : W, ok);
      } else {  // [BK][BP]: row k, chunk of n
        const int r = c >> 4, cc = (c & 15) * 8;
        const int k = k0 + r, n = n0 + cc;
        const bool ok = k < K && n < N;
        cp_async16(Bs + r * BP + cc, ok ? We + (size_t)k * N + n : W, ok);
      }
    }
  };

  float acc[4][4][4];
  zero(acc);
  const int KT = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = kt + STAGES - 1;
    if (nxt < KT) load(nxt % STAGES, nxt);
    cp_async_commit();
    const bf16* As = smem + (kt % STAGES) * ROWS_STAGE;
    const bf16* Bs = As + BM * AP;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldsm_x4(a[i], As + (wm * 64 + i * 16 + (lane & 7) +
                            (((lane >> 3) & 1) << 3)) * AP +
                          kk * 16 + ((lane >> 4) << 3));
#pragma unroll
      for (int j2 = 0; j2 < 2; ++j2) {
        if (BT)
          load_b_nk(b[2 * j2], b[2 * j2 + 1], Bs, BTP, wn * 32 + j2 * 16,
                    kk * 16, lane);
        else
          load_bt(b[2 * j2], b[2 * j2 + 1], Bs, BP, kk * 16,
                  wn * 32 + j2 * 16, lane);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma(acc[i][j], a[i], b[j]);
    }
  }
  cp_async_wait<0>();
  store(acc, C + (size_t)tile.row0 * N, N, wm * 64, n0 + wn * 32, tile.rows,
        N, lane);
}

__global__ void __launch_bounds__(THREADS)
    grouped_gemm_dw(const bf16* __restrict__ A, const int* __restrict__ a_idx,
                    const bf16* __restrict__ D, bf16* __restrict__ C,
                    const int* __restrict__ offs, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int e = blockIdx.z;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;  // m: columns of A
  const int lo = offs[e], cnt = offs[e + 1] - lo;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;

  // A tile [BK rows][BM columns of A] and D tile [BK rows][BN]: chunk c =
  // tid + i * 256 is row c / 16, 16-byte chunk c % 16
  auto load = [&](int stage, int rt) {
    bf16* As = smem + stage * DW_STAGE;
    bf16* Ds = As + BK * DAP;
    const int r0 = rt * BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      const int r = c >> 4, cc = (c & 15) * 8;
      const bool row_ok = r0 + r < cnt;
      const int row = lo + (row_ok ? r0 + r : 0);
      const int m = m0 + cc, n = n0 + cc;
      const bool a_ok = row_ok && m < K, d_ok = row_ok && n < N;
      cp_async16(As + r * DAP + cc,
                 a_ok ? A + (size_t)(a_idx ? a_idx[row] : row) * K + m : A,
                 a_ok);
      cp_async16(Ds + r * BP + cc, d_ok ? D + (size_t)row * N + n : D, d_ok);
    }
  };

  float acc[4][4][4];
  zero(acc);
  const int RT = (cnt + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < RT) load(s, s);
    cp_async_commit();
  }
  for (int rt = 0; rt < RT; ++rt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = rt + STAGES - 1;
    if (nxt < RT) load(nxt % STAGES, nxt);
    cp_async_commit();
    const bf16* As = smem + (rt % STAGES) * DW_STAGE;
    const bf16* Ds = As + BK * DAP;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4][4], b[4][2];
      // A^T fragments: the tile holds A's rows along the contraction, so
      // matrix i of the x4 is k rows kk * 16 + (i / 2) * 8 + lane % 8 at
      // column m + (i % 2) * 8, read transposed
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldsm_x4_t(a[i], As + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                 DAP +
                            wm * 64 + i * 16 + (((lane >> 3) & 1) << 3));
#pragma unroll
      for (int j2 = 0; j2 < 2; ++j2)
        load_bt(b[2 * j2], b[2 * j2 + 1], Ds, BP, kk * 16, wn * 32 + j2 * 16,
                lane);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma(acc[i][j], a[i], b[j]);
    }
  }
  cp_async_wait<0>();
  store(acc, C + (size_t)e * K * N, N, m0 + wm * 64, n0 + wn * 32, K, N,
        lane);
}

template <typename Kernel>
int allow_smem(Kernel k, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace

extern "C" {

// C (M, N) = the grouped rows product; see the header. The most row tiles
// any routing needs: M / BM + El + 1 (one partial tile a group, the tail).
int grouped_rows_launch(const void* A, const int* a_idx, const void* W,
                        void* C, const int* offs, int El, int M, int K, int N,
                        int b_trans, void* stream) {
  static bool ready[2] = {false, false};
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM + El + 1);
  auto s = static_cast<cudaStream_t>(stream);
  if (b_trans) {
    if (!ready[1]) {
      if (int rc = allow_smem(grouped_gemm_rows<true>, ROWS_SMEM)) return rc;
      ready[1] = true;
    }
    grouped_gemm_rows<true><<<grid, THREADS, ROWS_SMEM, s>>>(
        static_cast<const bf16*>(A), a_idx, static_cast<const bf16*>(W),
        static_cast<bf16*>(C), offs, El, M, K, N);
  } else {
    if (!ready[0]) {
      if (int rc = allow_smem(grouped_gemm_rows<false>, ROWS_SMEM)) return rc;
      ready[0] = true;
    }
    grouped_gemm_rows<false><<<grid, THREADS, ROWS_SMEM, s>>>(
        static_cast<const bf16*>(A), a_idx, static_cast<const bf16*>(W),
        static_cast<bf16*>(C), offs, El, M, K, N);
  }
  return static_cast<int>(cudaGetLastError());
}

// C (El, K, N): C_e = A[ia(rows of e)]^T D[rows of e].
int grouped_dw_launch(const void* A, const int* a_idx, const void* D, void* C,
                      const int* offs, int El, int K, int N, void* stream) {
  static bool ready = false;
  if (!ready) {
    if (int rc = allow_smem(grouped_gemm_dw, DW_SMEM)) return rc;
    ready = true;
  }
  const dim3 grid((N + BN - 1) / BN, (K + BM - 1) / BM, El);
  grouped_gemm_dw<<<grid, THREADS, DW_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(A), a_idx, static_cast<const bf16*>(D),
      static_cast<bf16*>(C), offs, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
