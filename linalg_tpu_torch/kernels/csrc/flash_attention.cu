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
//   bf16  Hopper's warpgroup products (wgmma: bf16 operands, f32
//         accumulate) fed by the Tensor Memory Accelerator. A block is two
//         consumer warpgroups, each owning one 64-row tile, and a producer
//         warpgroup that streams the other side's tiles through a two-slot
//         ring of shared memory guarded by mbarriers, so the next tile's
//         copy runs under this tile's products; the producer's registers go
//         to the consumers (setmaxnreg). The score products (S = Q K^T, dP =
//         dO V^T and their transposes) read both operands from shared
//         memory. The P- and dS-products (P V, dS K, P^T dO, dS^T Q) take
//         P or dS from registers, rounded to bf16 on the way -- exactly the
//         Pallas kernels' .astype(io dtype) -- and read V, K, dO or Q
//         MN-major through wgmma's transpose bit: no operand is copied
//         transposed. The TMA reads each head through a 4-D tensor map
//         built from its strides (the layouts: wgmma_bf16.cuh); rows past T
//         arrive as zeros and are never stored, so T % 128 == 64 leaves the
//         last block's second warpgroup idle.
//   f32   element-wise f32 FMA on the CUDA cores, never TF32 (the TPU's
//         MXU truncation is not carried over): 256 threads as a 16 x 16
//         grid, thread (ty, tx) owns score entries (ty + 16 i, tx + 16 j)
//         and output entries (ty + 16 i, tx + 16 c); rows are padded by one
//         float. A row's 16 owners are half a warp, so row reductions are
//         four xor-shuffles.
// Shared memory per block at D 128: bf16 forward 97 KB, dq 129 KB, dk/dv
// 99 KB; f32 forward 116 KB, dq 149 KB, dk/dv 165 KB -- above the 48 KB
// static limit, so each launch raises the kernel's dynamic shared-memory
// cap first. At D 256 the bf16 forward and dq blocks are one consumer
// warpgroup (64 rows), to fit shared memory and the registers, dk/dv runs
// two 128-column slices over a grid dimension, each recomputing its
// scores, and the f32 kernels take 32-row tiles.
// Scheduling is the plain grid: one block per (head, row block), the
// blocks that walk the most tiles first, every head's before any head's
// lighter ones, so the last wave holds the short blocks; no atomics.

#include <cuda.h>  // CUtensorMap and its enums only: nothing links libcuda
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"  // bf16, pack, quad_max, quad_sum
#include "wgmma_bf16.cuh"

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

// ===================== bf16: wgmma fed by TMA ==========================

// One block: NWG consumer warpgroups, each owning one 64-row tile (query
// rows in the forward and dq, key rows in dk/dv), then one producer
// warpgroup, one thread of which keeps the streamed tiles of the other
// side in flight through a ring of STAGES shared-memory slots. Slot s is
// guarded by two mbarriers: full[s] (one arrival from the producer plus
// the TMA's bytes) and
// empty[s] (one arrival from each consumer warp once its products have
// read the slot). Every consumer warp passes through every streamed tile
// of the block -- waits full, arrives empty -- and computes only on the
// tiles its own rows see, so the phases of the two barriers never run
// ahead of each other. With two consumer warpgroups the block's register
// pool is 384 threads x 168 (what ptxas gives a 384-thread block); the
// producer drops to 40 (its loop state) and the consumers take 232:
// 128 x 40 + 256 x 232 = 384 x 168 (setmaxnreg.inc waits until the pool
// has them).
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int STAGES = 2;
// dk/dv's P^T hand-over: 64 x 64 f32 per buffer, two buffers (one at d
// 256, where a second would not fit shared memory)
constexpr int P_BYTES = 64 * 64 * 4;
template <int D>
constexpr int P_BUFS = D == 256 ? 1 : 2;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int NWG>
constexpr int threads_of() {
  return 128 * (NWG + 1);
}

// Shared-memory geometry of one 64-row bf16 tile of D columns, as the TMA
// writes it: D / SW boxes of 64 rows x SW columns, each swizzled.
template <int D>
struct Tile {
  static constexpr int SW = D < 64 ? D : 64;      // columns per box row
  static constexpr int ROWB = 2 * SW;             // bytes per box row
  static constexpr int BOXES = D / SW;
  static constexpr int BOXB = BM * ROWB;          // bytes per box
  static constexpr int BYTES = BM * D * 2;        // bytes per tile
  static constexpr int SWZ = ROWB == 128 ? 1 : 2; // 128- or 64-byte swizzle
};

// Descriptor of a K-major operand: the tile at `t`, its columns
// [16 kk, 16 kk + 16) as the contraction.
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t t, int kk) {
  using G = Tile<D>;
  return make_desc(
      fresh(t) + (16 * kk / G::SW) * G::BOXB + (16 * kk % G::SW) * 2, 16,
      8 * G::ROWB, G::SWZ);
}

// Descriptor of an MN-major operand: the tile at `t`, its rows
// [16 kk, 16 kk + 16) as the contraction, its columns from c0 (a multiple
// of SW) as N.
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t t, int kk, int c0) {
  using G = Tile<D>;
  return make_desc(fresh(t) + (c0 / G::SW) * G::BOXB + 16 * kk * G::ROWB,
                   G::BOXB, 8 * G::ROWB, G::SWZ);
}

// Rows [row, row + 64) of head (head, batch) of a tensor map into the tile
// at `dst`, one TMA box per SW columns; rows past T arrive as zeros.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* m,
                                          uint32_t bar, int row, int head,
                                          int batch) {
#pragma unroll
  for (int x = 0; x < Tile<D>::BOXES; ++x)
    tma_load_4d(dst + x * Tile<D>::BOXB, m, bar, x * Tile<D>::SW, row, head,
                batch);
}

// The A operand of the 16-column block kk of a 64 x 64 accumulator,
// rounded to bf16 (entry 4 n + i of the flat accumulator is entry i of
// mma.sync tile n).
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&s)[32],
                                     int kk) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = pack(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// Accumulator entry j of a thread: its row in the warpgroup's 64 (r0 is
// the warp's first) and its column.
__device__ __forceinline__ int acc_row(int r0, int g, int j) {
  return r0 + g + 8 * ((j >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int t, int j) {
  return 8 * (j >> 2) + 2 * t + (j & 1);
}

// The query tiles [qb0, qlast] of a forward or dq block (blocks - 1 - y:
// the longest causal rows first, every head's before any head's shorter
// ones) and the key tiles [ks, ke) any of them sees. Each role computes it
// after the split, so nothing of it lives across setmaxnreg.
struct QueryBlock {
  int nt, qb0, qlast, ks, ke;
  __device__ __forceinline__ QueryBlock(int nwg, int Tlen, int causal,
                                        int window) {
    nt = Tlen / BM;
    qb0 = nwg * ((nt + nwg - 1) / nwg - 1 - (int)blockIdx.y);
    qlast = min(qb0 + nwg, nt) - 1;
    ks = key_start<BM>(qb0, window);
    ke = key_end(qlast, nt, causal);
  }
};

// One thread initialises the block's barriers: `resident` (the tiles
// loaded once) and full[s], empty[s] per slot, 8 bytes apart from `bars`.
template <int NWG>
__device__ __forceinline__ void init_barriers(uint32_t bars) {
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 + 8 * s, 1);
      mbar_init(bars + 8 + 8 * (STAGES + s), 4 * NWG);
    }
    mbar_init_fence();
  }
  __syncthreads();
}

// Forward. Block (bh, y) owns query tiles [NWG b0, NWG b0 + NWG), b0 =
// blocks - 1 - y: the longest causal rows first, every head's before any
// head's shorter ones. Q is loaded once; K and V tiles stream through the
// ring. Per key tile a warpgroup issues S = Q K^T (K-major Q and K), the
// online softmax in registers, P rounded to bf16 as the register A operand
// of O += P V (V MN-major).
template <int D, int NWG>
__global__ void __launch_bounds__(threads_of<NWG>(), 1)
    fwd_bf16(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
             float* __restrict__ L, int Tlen, int causal, int window,
             int group, float scale, const Lays ly) {
  using G = Tile<D>;
  // NWG Q tiles, then per slot K and V, then the barriers
  const uint32_t Qs = smem_u32(smem_aligned());
  const uint32_t KV = Qs + NWG * G::BYTES;
  const uint32_t qbar = KV + STAGES * 2 * G::BYTES;
  const uint32_t full = qbar + 8, empty = full + 8 * STAGES;
  const int bh = blockIdx.x;
  init_barriers<NWG>(qbar);

  if (threadIdx.x >= 128 * NWG) {  // the producer warpgroup
    if constexpr (NWG > 1) reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 128 * NWG) {
      const QueryBlock blk(NWG, Tlen, causal, window);
      const int qb0 = blk.qb0, qlast = blk.qlast, ks = blk.ks, ke = blk.ke;
      const int kvh = bh / group;
      mbar_expect_tx(qbar, (qlast - qb0 + 1) * G::BYTES);
      for (int w = 0; qb0 + w <= qlast; ++w)
        load_tile<D>(Qs + w * G::BYTES, &tq, qbar, (qb0 + w) * BM,
                     bh % ly.H, bh / ly.H);
      for (int i = 0, kb = ks; kb < ke; ++i, ++kb) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + 8 * s, (i / STAGES - 1) & 1);
        const uint32_t kt = KV + s * 2 * G::BYTES;
        mbar_expect_tx(full + 8 * s, 2 * G::BYTES);
        load_tile<D>(kt, &tk, full + 8 * s, kb * BM, kvh % ly.hk,
                     kvh / ly.hk);
        load_tile<D>(kt + G::BYTES, &tv, full + 8 * s, kb * BM, kvh % ly.hk,
                     kvh / ly.hk);
      }
    }
    return;
  }
  if constexpr (NWG > 1) reg_alloc<CONSUMER_REGS>();

  const QueryBlock blk(NWG, Tlen, causal, window);
  const int nt = blk.nt, ks = blk.ks, ke = blk.ke;
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, r0 = 16 * (threadIdx.x / 32 % 4);
  const int qb = blk.qb0 + wg;
  const bool live = qb < nt;  // T % 128 == 64 leaves the last block's
                              // second warpgroup without rows
  const int ks_w = live ? key_start<BM>(qb, window) : ks;
  const int ke_w = live ? key_end(qb, nt, causal) : ks;
  const uint32_t Qw = Qs + wg * G::BYTES;
  const float sl2 = scale * LOG2E;  // exp(x) = exp2(x log2 e)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
  if (live) mbar_wait(qbar, 0);
  for (int i = 0, kb = ks; kb < ke; ++i, ++kb) {
    const int s = i % STAGES;
    const uint32_t kt = KV + s * 2 * G::BYTES;
    mbar_wait(full + 8 * s, (i / STAGES) & 1);
    if (kb >= ks_w && kb < ke_w) {
      float sc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(sc, desc_k<D>(Qw, kk), desc_k<D>(kt, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      const bool masked = edge<BM>(qb, kb, causal, window);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        float x = sc[j] * sl2;
        if (masked && banned(qb * BM + acc_row(r0, g, j),
                             kb * BM + acc_col(t, j), causal, window))
          x = NEG;
        sc[j] = x;
        mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], x);
      }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mn = fmaxf(m[h], quad_max(mx[h]));
        // 0 on the first tile, and on the first live tile after a tile
        // wholly banned for this row
        alpha[h] = exp2f(m[h] - mn);
        m[h] = mn;
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        sc[j] = exp2f(sc[j] - m[(j >> 1) & 1]);
        rs[(j >> 1) & 1] += sc[j];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + quad_sum(rs[h]);
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[j] *= alpha[(j >> 1) & 1];
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) to_a(pa[kk], sc, kk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D>(acc, pa[kk], desc_mn<D>(kt + G::BYTES, kk, 0), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }
  if (!live) return;
  o += head_at(ly.o, bh, ly.H);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = qb * BM + r0 + g + 8 * h;
    const float inv = 1.f / l[h];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(o + r * ly.o.r + 8 * n + 2 * t) =
          pack(acc[4 * n + 2 * h] * inv, acc[4 * n + 2 * h + 1] * inv);
    if (t == 0) L[(size_t)bh * Tlen + r] = (m[h] + log2f(l[h])) * LN2;
  }
}

// dq. Blocks as the forward's; Q and dO are loaded once, K and V tiles
// stream. Per key tile: S = Q K^T and dP = dO V^T (K-major), dS = P (dP -
// delta) rounded to bf16 as the register A operand of dq += dS K (K
// MN-major).
template <int D, int NWG>
__global__ void __launch_bounds__(threads_of<NWG>(), 1)
    dq_bf16(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const __grid_constant__ CUtensorMap tdo,
            const float* __restrict__ L, const float* __restrict__ delta,
            bf16* __restrict__ dq, int Tlen, int causal, int window,
            int group, float scale, const Lays ly) {
  using G = Tile<D>;
  // NWG Q tiles, NWG dO tiles, then per slot K and V, then the barriers
  const uint32_t Qs = smem_u32(smem_aligned());
  const uint32_t dOs = Qs + NWG * G::BYTES;
  const uint32_t KV = dOs + NWG * G::BYTES;
  const uint32_t qbar = KV + STAGES * 2 * G::BYTES;
  const uint32_t full = qbar + 8, empty = full + 8 * STAGES;
  const int bh = blockIdx.x;
  init_barriers<NWG>(qbar);

  if (threadIdx.x >= 128 * NWG) {  // the producer warpgroup
    if constexpr (NWG > 1) reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 128 * NWG) {
      const QueryBlock blk(NWG, Tlen, causal, window);
      const int qb0 = blk.qb0, qlast = blk.qlast, ks = blk.ks, ke = blk.ke;
      const int kvh = bh / group;
      mbar_expect_tx(qbar, 2 * (qlast - qb0 + 1) * G::BYTES);
      for (int w = 0; qb0 + w <= qlast; ++w) {
        load_tile<D>(Qs + w * G::BYTES, &tq, qbar, (qb0 + w) * BM,
                     bh % ly.H, bh / ly.H);
        load_tile<D>(dOs + w * G::BYTES, &tdo, qbar, (qb0 + w) * BM,
                     bh % ly.H, bh / ly.H);
      }
      for (int i = 0, kb = ks; kb < ke; ++i, ++kb) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + 8 * s, (i / STAGES - 1) & 1);
        const uint32_t kt = KV + s * 2 * G::BYTES;
        mbar_expect_tx(full + 8 * s, 2 * G::BYTES);
        load_tile<D>(kt, &tk, full + 8 * s, kb * BM, kvh % ly.hk,
                     kvh / ly.hk);
        load_tile<D>(kt + G::BYTES, &tv, full + 8 * s, kb * BM, kvh % ly.hk,
                     kvh / ly.hk);
      }
    }
    return;
  }
  if constexpr (NWG > 1) reg_alloc<CONSUMER_REGS>();

  const QueryBlock blk(NWG, Tlen, causal, window);
  const int nt = blk.nt, ks = blk.ks, ke = blk.ke;
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, r0 = 16 * (threadIdx.x / 32 % 4);
  const int qb = blk.qb0 + wg;
  const bool live = qb < nt;
  const int ks_w = live ? key_start<BM>(qb, window) : ks;
  const int ke_w = live ? key_end(qb, nt, causal) : ks;
  const uint32_t Qw = Qs + wg * G::BYTES, dOw = dOs + wg * G::BYTES;
  const float sl2 = scale * LOG2E;
  float Lr[2] = {0.f, 0.f}, dr[2] = {0.f, 0.f};
  if (live) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t r = (size_t)bh * Tlen + qb * BM + r0 + g + 8 * h;
      Lr[h] = L[r] * LOG2E;
      dr[h] = delta[r];
    }
  }
  float acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
  if (live) mbar_wait(qbar, 0);
  for (int i = 0, kb = ks; kb < ke; ++i, ++kb) {
    const int s = i % STAGES;
    const uint32_t kt = KV + s * 2 * G::BYTES;
    mbar_wait(full + 8 * s, (i / STAGES) & 1);
    if (kb >= ks_w && kb < ke_w) {
      float sc[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss(sc, desc_k<D>(Qw, kk), desc_k<D>(kt, kk), kk > 0);
        wgmma_ss(dp, desc_k<D>(dOw, kk), desc_k<D>(kt + G::BYTES, kk),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      const bool masked = edge<BM>(qb, kb, causal, window);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        float x = sc[j] * sl2;
        if (masked && banned(qb * BM + acc_row(r0, g, j),
                             kb * BM + acc_col(t, j), causal, window))
          x = NEG;
        const int h = (j >> 1) & 1;
        sc[j] = (dp[j] - dr[h]) * exp2f(x - Lr[h]);  // dS
      }
      uint32_t da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) to_a(da[kk], sc, kk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D>(acc, da[kk], desc_mn<D>(kt, kk, 0), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }
  if (!live) return;
  dq += head_at(ly.dq, bh, ly.H);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = qb * BM + r0 + g + 8 * h;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(dq + r * ly.dq.r + 8 * n + 2 * t) =
          pack(scale * acc[4 * n + 2 * h], scale * acc[4 * n + 2 * h + 1]);
  }
}

// dk/dv. Block (kvh, y, z) owns key tile y of KV head kvh = b*hk + kv head
// (low key tiles, which the most query tiles see, first) and the DC
// columns [z DC, z DC + DC) of dk and dv. K and V are loaded once; the
// group's query heads and their live query tiles stream (Q, dO, and their
// rows of L and delta). The two consumer warpgroups share the 64 keys and
// split the work of each query tile: the first computes S^T = K Q^T and
// P^T, hands P^T (f32) to the second through shared memory and
// accumulates dv += P^T dO; the second computes dP^T = V dO^T, takes P^T,
// forms dS^T and accumulates dk += dS^T Q. K, V, Q and dO are K-major in
// the score products, dO and Q MN-major in the others, P^T and dS^T are
// rounded to bf16 as the register A operands. Each warpgroup holds one
// 64 x DC accumulator (both in one would not fit its registers beside the
// scores) and issues 2 of the tile's 4 products. At d 256 the
// accumulators of all 256 columns would not fit either, so two 128-column
// slices each recompute the scores.
template <int D, int DC>
__global__ void __launch_bounds__(threads_of<2>(), 1)
    dkdv_bf16(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const __grid_constant__ CUtensorMap tdo,
              const float* __restrict__ L, const float* __restrict__ delta,
              bf16* __restrict__ dk, bf16* __restrict__ dv, int Tlen,
              int causal, int window, int group, float scale,
              const Lays ly) {
  using G = Tile<D>;
  // a slot: the Q tile, the dO tile, 64 floats of L and 64 of delta,
  // padded to the next 1024 bytes
  constexpr int SLOT = 2 * G::BYTES + 1024;
  // the K tile, the V tile, the slots, the P^T buffers, then the barriers:
  // resident, full and empty per slot, pfull and pempty per P^T buffer
  unsigned char* sm = smem_aligned();
  const uint32_t Ks = smem_u32(sm), Vs = Ks + G::BYTES;
  const uint32_t QS = Vs + G::BYTES;
  const uint32_t PS = QS + STAGES * SLOT;
  const uint32_t kvbar = PS + P_BUFS<D> * P_BYTES;
  const uint32_t full = kvbar + 8, empty = full + 8 * STAGES;
  const uint32_t pfull = empty + 8 * STAGES, pempty = pfull + 8 * P_BUFS<D>;
  const int kvh = blockIdx.x, kb = blockIdx.y;
  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    for (int b = 0; b < P_BUFS<D>; ++b) {  // every thread of a warpgroup
      mbar_init(pfull + 8 * b, 128);
      mbar_init(pempty + 8 * b, 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // the producer warpgroup
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      // the query tiles that see the key tile
      const int qs = query_start(kb, causal);
      const int nq = query_end<BM>(kb, Tlen / BM, window) - qs;
      mbar_expect_tx(kvbar, 2 * G::BYTES);
      load_tile<D>(Ks, &tk, kvbar, kb * BM, kvh % ly.hk, kvh / ly.hk);
      load_tile<D>(Vs, &tv, kvbar, kb * BM, kvh % ly.hk, kvh / ly.hk);
      for (int i = 0; i < group * nq; ++i) {
        const int qh = kvh * group + i / nq;  // query head b*H + h
        const int qb = qs + i % nq;
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + 8 * s, (i / STAGES - 1) & 1);
        const uint32_t st = QS + s * SLOT, bar = full + 8 * s;
        const size_t rows = (size_t)qh * Tlen + qb * BM;
        mbar_expect_tx(bar, 2 * G::BYTES + 2 * BM * 4);
        load_tile<D>(st, &tq, bar, qb * BM, qh % ly.H, qh / ly.H);
        load_tile<D>(st + G::BYTES, &tdo, bar, qb * BM, qh % ly.H,
                     qh / ly.H);
        bulk_load(st + 2 * G::BYTES, L + rows, BM * 4, bar);
        bulk_load(st + 2 * G::BYTES + BM * 4, delta + rows, BM * 4, bar);
      }
    }
    return;
  }
  reg_alloc<CONSUMER_REGS>();

  const int qs = query_start(kb, causal);
  const int nq = query_end<BM>(kb, Tlen / BM, window) - qs;
  const int c0 = blockIdx.z * DC;
  const bool dk_wg = threadIdx.x >= 128;  // else the dv warpgroup
  const int tid = threadIdx.x % 128, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, r0 = 16 * (tid / 32);
  const float sl2 = scale * LOG2E;
  float acc[DC / 2];
#pragma unroll
  for (int j = 0; j < DC / 2; ++j) acc[j] = 0.f;
  mbar_wait(kvbar, 0);
  for (int i = 0; i < group * nq; ++i) {
    const int qb = qs + i % nq;
    const int s = i % STAGES, b = i % P_BUFS<D>, use = i / P_BUFS<D>;
    const uint32_t st = QS + s * SLOT;
    const float* Ls =
        reinterpret_cast<const float*>(sm + (st - Ks) + 2 * G::BYTES);
    // P^T in the accumulator's layout: entry j of thread tid at j 128 + tid
    float* pt = reinterpret_cast<float*>(sm + (PS - Ks) + b * P_BYTES) + tid;
    mbar_wait(full + 8 * s, (i / STAGES) & 1);
    // dP^T = V dO^T, or S^T = K Q^T: one product, its operands picked by
    // the role, so no wgmma sits on a divergent path
    const uint32_t sa = dk_wg ? Vs : Ks, sb = dk_wg ? st + G::BYTES : st;
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(sc, desc_k<D>(sa, kk), desc_k<D>(sb, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    if (dk_wg) {
      const float* Ds = Ls + BM;
      mbar_wait(pfull + 8 * b, use & 1);
#pragma unroll
      for (int j = 0; j < 32; ++j)
        sc[j] = (sc[j] - Ds[acc_col(t, j)]) * pt[128 * j];  // dS^T
      mbar_arrive(pempty + 8 * b);
    } else {
      const bool masked = edge<BM>(qb, kb, causal, window);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = acc_col(t, j);  // the query in the tile
        float x = sc[j] * sl2;
        // the query is the column here, the key the row
        if (masked && banned(qb * BM + col, kb * BM + acc_row(r0, g, j),
                             causal, window))
          x = NEG;
        sc[j] = exp2f(x - Ls[col] * LOG2E);  // P^T
      }
      if (use > 0) mbar_wait(pempty + 8 * b, (use - 1) & 1);
#pragma unroll
      for (int j = 0; j < 32; ++j) pt[128 * j] = sc[j];
      mbar_arrive(pfull + 8 * b);
    }
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) to_a(a[kk], sc, kk);
    // dk += dS^T Q, or dv += P^T dO
    const uint32_t bt = dk_wg ? st : st + G::BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<DC>(acc, a[kk], desc_mn<D>(bt, kk, c0), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }
  bf16* out = dk_wg ? dk + head_at(ly.dk, kvh, ly.hk)
                    : dv + head_at(ly.dv, kvh, ly.hk);
  const long long rs = dk_wg ? ly.dk.r : ly.dv.r;
  const float f = dk_wg ? scale : 1.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long r = (long long)kb * BM + r0 + g + 8 * h;
#pragma unroll
    for (int n = 0; n < DC / 8; ++n)
      *reinterpret_cast<uint32_t*>(out + r * rs + c0 + 8 * n + 2 * t) =
          pack(f * acc[4 * n + 2 * h], f * acc[4 * n + 2 * h + 1]);
  }
}

// ===================== f32: element-wise FMA ===========================

// Tiles of BR rows: 64, or 32 at d 256, where six 64-row f32 tiles would
// not fit the 227 KB of shared memory a block can have. Thread (ty, tx)
// owns rows ty + 16 i, i < BR / 16.
// threads per block: a 16 x 16 grid. The kernels are declared with a
// minimum of one block per SM: without it ptxas trades a few spilled bytes
// for a 64-register budget at d 32 and 64.
constexpr int NT = 256;

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
__global__ void __launch_bounds__(NT, 1)
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
__global__ void __launch_bounds__(NT, 1)
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
__global__ void __launch_bounds__(NT, 1)
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

// ===================== delta = rowsum(dO * O) =========================

// delta[bh T + r] = sum over the D columns of dO[r] * O[r] in f32: the
// backward's one pass outside the dq and dk/dv kernels (K3 and K4 take it
// outside theirs, flash_long.py:213-217, flash_stream.py:367-368). It
// reads O and dO once and writes 4 bytes a row, so memory bounds it: each
// thread loads 16 bytes of one row of each, a row's threads are
// neighbouring lanes, and their sums meet by xor-shuffles.
template <typename T, int D>
__global__ void __launch_bounds__(256)
    delta_rows(const T* __restrict__ o, const T* __restrict__ dO,
               float* __restrict__ delta, int Tlen, int rows,
               const Lays ly) {
  constexpr int V = 16 / sizeof(T);             // elements in 16 bytes
  constexpr int TPR = D / V < 32 ? D / V : 32;  // threads per row
  const int row = blockIdx.x * (256 / TPR) + threadIdx.x / TPR;
  const int lane = threadIdx.x % TPR;
  const int bh = row / Tlen, r = row % Tlen;
  float sum = 0.f;
  if (row < rows) {
    const T* a = o + head_at(ly.o, bh, ly.H) + r * ly.o.r;
    const T* b = dO + head_at(ly.dO, bh, ly.H) + r * ly.dO.r;
#pragma unroll
    for (int c = lane * V; c < D; c += TPR * V) {
      const uint4 x = *reinterpret_cast<const uint4*>(a + c);
      const uint4 y = *reinterpret_cast<const uint4*>(b + c);
      if constexpr (sizeof(T) == 2) {
        const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 u = __bfloat1622float2(xs[i]);
          const float2 w = __bfloat1622float2(ys[i]);
          sum = fmaf(u.x, w.x, fmaf(u.y, w.y, sum));
        }
      } else {
        const float* xs = reinterpret_cast<const float*>(&x);
        const float* ys = reinterpret_cast<const float*>(&y);
#pragma unroll
        for (int i = 0; i < 4; ++i) sum = fmaf(xs[i], ys[i], sum);
      }
    }
  }
#pragma unroll
  for (int m = TPR / 2; m > 0; m >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, m);
  if (row < rows && lane == 0) delta[row] = sum;
}

// ===================== launch =========================================

struct Args {
  const void *q, *k, *v, *dO;
  const float *L, *delta;
  void *out0, *out1;
  float* L_out;
  int B, BH, T, causal, window, group;  // BH counts query heads
  float scale;
  cudaStream_t stream;
  Lays ly;
};

// The 4-D tensor map (d, T, heads, batch) of a bf16 head tensor of layout
// `l`, with its element strides as bytes: any layout the wrappers accept
// (contiguous heads, K7's head views of (B, T, H*d)) is read in place, in
// boxes of 64 rows x SW columns under the swizzle the descriptors name.
// Rows past T read as zeros.
template <int D>
int make_map(CUtensorMap* m, const void* p, const Lay& l, int heads, int B,
             int T) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return MAP_FAILED;
  const cuuint64_t dims[4] = {D, (cuuint64_t)T, (cuuint64_t)heads,
                              (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)(2 * l.r), (cuuint64_t)(2 * l.h),
                           (cuuint64_t)(2 * l.b)};
  // a dimension of extent 1 is never stepped: its stride need only be one
  // the encoder takes
  for (int i = 1; i < 3; ++i)
    if (dims[i + 1] == 1) strides[i] = strides[i - 1] * dims[i];
  const cuuint32_t box[4] = {Tile<D>::SW, BM, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      Tile<D>::SWZ == 1 ? CU_TENSOR_MAP_SWIZZLE_128B
                        : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : MAP_FAILED;
}

// bytes of the mbarriers after the tiles: one for the resident tiles,
// full and empty per slot
constexpr size_t BARS = 8 * (1 + 2 * STAGES);

// Forward and dq blocks: two consumer warpgroups (128 query rows); one at
// d 256, where dq's two resident 128-row tiles and a ring would not fit
// the 227 KB of shared memory a block can have and the forward's
// 128-column accumulator would not fit the 232 registers setmaxnreg
// gives. dk/dv blocks: two warpgroups on one 64-row key tile, in two
// 128-column slices at d 256.
template <int D>
constexpr int warpgroups() {
  return D == 256 ? 1 : 2;
}
template <int D>
constexpr int dkdv_cols() {
  return D == 256 ? 128 : D;
}

// Dynamic shared memory of a bf16 launch (which: 0 forward, 1 dq, 2
// dk/dv): the resident tiles, the ring's slots (dk/dv's with L and delta),
// the barriers, and 1024 bytes to align the tiles to the swizzle atom.
template <int D>
constexpr size_t bf16_smem(int which) {
  using G = Tile<D>;
  constexpr int W = warpgroups<D>();
  return which == 0   ? W * G::BYTES + STAGES * 2 * G::BYTES + BARS + 1024
         : which == 1 ? 2 * W * G::BYTES + STAGES * 2 * G::BYTES + BARS + 1024
                      : 2 * G::BYTES + STAGES * (2 * G::BYTES + 1024) +
                            P_BUFS<D> * (P_BYTES + 16) + BARS + 1024;
}

template <int D>
int run_bf16(int which, const Args& a) {
  constexpr int W = warpgroups<D>(), DC = dkdv_cols<D>();
  const Lays& ly = a.ly;
  CUtensorMap tq, tk, tv, tdo;
  int e = make_map<D>(&tq, a.q, ly.q, ly.H, a.B, a.T);
  if (!e) e = make_map<D>(&tk, a.k, ly.k, ly.hk, a.B, a.T);
  if (!e) e = make_map<D>(&tv, a.v, ly.v, ly.hk, a.B, a.T);
  if (!e && which) e = make_map<D>(&tdo, a.dO, ly.dO, ly.H, a.B, a.T);
  if (e) return e;
  const int nt = a.T / BM;
  auto out = [](void* p) { return static_cast<bf16*>(p); };
  switch (which) {
    case 0:
      return launch(fwd_bf16<D, W>, threads_of<W>(), bf16_smem<D>(0),
                    dim3(a.BH, (nt + W - 1) / W), a.stream, tq, tk, tv,
                    out(a.out0), a.L_out, a.T, a.causal, a.window, a.group,
                    a.scale, ly);
    case 1:
      return launch(dq_bf16<D, W>, threads_of<W>(), bf16_smem<D>(1),
                    dim3(a.BH, (nt + W - 1) / W), a.stream, tq, tk, tv, tdo,
                    a.L, a.delta, out(a.out0), a.T, a.causal, a.window,
                    a.group, a.scale, ly);
    case 2:
      return launch(dkdv_bf16<D, DC>, threads_of<2>(), bf16_smem<D>(2),
                    dim3(a.BH / a.group, nt, D / DC), a.stream,
                    tq, tk, tv, tdo, a.L, a.delta, out(a.out0), out(a.out1),
                    a.T, a.causal, a.window, a.group, a.scale, ly);
    default:
      return -1;
  }
}

constexpr size_t f32_smem(int D, int BR, int tiles, int scores) {
  return ((size_t)tiles * BR * (D + 1) + (size_t)scores * BR * (BR + 1)) *
         4;
}
template <int D>
constexpr int f32_rows() {
  return D == 256 ? 32 : BM;
}
// the f32 launches' dynamic shared memory: Q, K, V, P (forward); Q, dO,
// K, V, dS (dq); K, V, Q, dO, P^T, dS^T (dk/dv)
template <int D>
constexpr size_t f32_smem_of(int which) {
  return f32_smem(D, f32_rows<D>(), which == 0 ? 3 : 4, which == 2 ? 2 : 1);
}

template <int D>
int run_f32(int which, const Args& a) {
  constexpr int BR = f32_rows<D>();
  auto in = [](const void* p) { return static_cast<const float*>(p); };
  auto out = [](void* p) { return static_cast<float*>(p); };
  switch (which) {
    case 0:
      return launch(fwd_f32<D, BR>, NT, f32_smem_of<D>(0),
                    dim3(a.T / BR, a.BH), a.stream, in(a.q), in(a.k),
                    in(a.v), out(a.out0), a.L_out, a.T, a.causal, a.window,
                    a.group, a.scale, a.ly);
    case 1:
      return launch(dq_f32<D, BR>, NT, f32_smem_of<D>(1),
                    dim3(a.T / BR, a.BH), a.stream, in(a.q), in(a.k),
                    in(a.v), in(a.dO), a.L, a.delta, out(a.out0), a.T,
                    a.causal, a.window, a.group, a.scale, a.ly);
    case 2:
      return launch(dkdv_f32<D, BR>, NT, f32_smem_of<D>(2),
                    dim3(a.T / BR, a.BH / a.group), a.stream, in(a.q),
                    in(a.k), in(a.v), in(a.dO), a.L, a.delta, out(a.out0),
                    out(a.out1), a.T, a.causal, a.window, a.group, a.scale,
                    a.ly);
    default:
      return -1;
  }
}

// rowsum(dO * O) into a.L_out, 256 threads over 256 / (threads per row)
// rows each
template <typename T, int D>
int run_delta(const Args& a) {
  constexpr int TPR = D / (16 / sizeof(T)) < 32 ? D / (16 / sizeof(T)) : 32;
  const int rows = a.BH * a.T, per = 256 / TPR;
  return launch(delta_rows<T, D>, 256, 0, dim3((rows + per - 1) / per),
                a.stream, static_cast<const T*>(a.out0),
                static_cast<const T*>(a.dO), a.L_out, a.T, rows, a.ly);
}

// which: 0 forward, 1 dq, 2 dk/dv, 3 delta
template <int D>
int run(int dtype, int which, const Args& a) {
  if (which == 3)
    return dtype == 0 ? run_delta<float, D>(a)
           : dtype == 1 ? run_delta<bf16, D>(a)
                        : -1;
  if (dtype == 0) return run_f32<D>(which, a);
  if (dtype == 1) return run_bf16<D>(which, a);
  return -1;
}

int dispatch(int dtype, int d, int which, Args& a, int B, int H,
             const long long* strides) {
  if (a.T <= 0 || a.T % BM || B <= 0 || H <= 0 || B * H > 65535 ||
      a.window < 0 || a.group < 1 || H % a.group)
    return -1;
  a.B = B;
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

template <int D>
long long smem_of(int dtype, int which) {
  if (which < 0 || which > 2) return -1;
  return dtype == 0 ? (long long)f32_smem_of<D>(which)
                    : (long long)bf16_smem<D>(which);
}

}  // namespace

// Dynamic shared memory (bytes) a launch of dtype (0 float32, 1 bfloat16),
// head width d and kernel `which` (0 forward, 1 dq, 2 dk/dv) asks for, or
// -1 for one that does not exist.
extern "C" long long flash_smem_bytes(int dtype, int d, int which) {
  if (dtype != 0 && dtype != 1) return -1;
  switch (d) {
    case 32: return smem_of<32>(dtype, which);
    case 64: return smem_of<64>(dtype, which);
    case 128: return smem_of<128>(dtype, which);
    case 256: return smem_of<256>(dtype, which);
    default: return -1;
  }
}

// dtype: 0 = float32, 1 = bfloat16. B batches of H query heads; k and v
// hold H / group heads per batch. window 0 means no band. `strides` holds
// the (batch, head, row) element strides of q, k, v, o, dO, dq, dk, dv in
// that order (24 values; those of tensors a launch does not take are not
// read). Each returns 0 on success, -1 for an unsupported dtype, d or
// shape, -2 when a bf16 launch's tensor maps cannot be encoded, else the
// cudaError_t of the launch.

// o = attention(q, k, v); L = its row logsumexp (f32, (B*H, T)).
extern "C" int flash_fwd_launch(int dtype, int d, const void* q,
                                const void* k, const void* v, void* o,
                                void* L, int B, int H, int T, int causal,
                                int window, int group, float scale,
                                const long long* strides, void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, o, nullptr,
         static_cast<float*>(L), 0, 0, T, causal, window, group, scale,
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
         static_cast<const float*>(delta), dq, nullptr, nullptr, 0, 0, T,
         causal, window, group, scale, static_cast<cudaStream_t>(stream),
         {}};
  return dispatch(dtype, d, 1, a, B, H, strides);
}

// delta = rowsum(dO * O) (f32, (B*H, T)) from o and dO of q's layout
// (strides: o's and dO's places).
extern "C" int flash_delta_launch(int dtype, int d, const void* o,
                                  const void* dO, void* delta, int B, int H,
                                  int T, int causal, int window, int group,
                                  float scale, const long long* strides,
                                  void* stream) {
  Args a{nullptr, nullptr, nullptr, dO, nullptr, nullptr,
         const_cast<void*>(o), nullptr, static_cast<float*>(delta), 0, 0, T,
         causal, window, group, scale, static_cast<cudaStream_t>(stream),
         {}};
  return dispatch(dtype, d, 3, a, B, H, strides);
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
         static_cast<const float*>(delta), dk, dv, nullptr, 0, 0, T, causal,
         window, group, scale, static_cast<cudaStream_t>(stream), {}};
  return dispatch(dtype, d, 2, a, B, H, strides);
}
