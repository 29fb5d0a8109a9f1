// Paged decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU kernels of linalg_tpu/serve/paged.py:
// paged_attn_pallas_dma (_paged_attn_dma_kernel) and paged_attn_pallas
// (_paged_attn_kernel). Both compute, for every slot b and query head h,
// single-token attention over the slot's KV rows, which live in a pool of
// fixed-size pages addressed through a per-slot page table. The kernels
// here cover both: the DMA kernel's 128-lane row folding and the grid
// kernel's 8-row query padding are TPU layout workarounds with no
// counterpart on this card.
//
// Contract (the Pallas kernels' contract, unchanged):
//   q      (B, H, 1, d)               compute dtype T (float or bf16)
//   pool_k (n_pages, hk, page, d)     T, hk divides H (GQA)
//   pool_v (n_pages, hk, page, d)     T
//   mask   (B, 1|H, 1, Pmax*page)     T, additive (validity and any bias)
//   table  (B, Pmax) int32            logical page i of slot b -> pool page
//   pos    (B,) int32                 slot positions
//   out    (B, H, 1, d)               T
// d is a multiple of 8 from 8 to 256; page is a multiple of 8. Query head
// h reads KV head h / (H/hk). The walk over logical pages stops at
// min(pos[b] / page + 1, Pmax): idle slots' positions grow past ctx and
// their table rows point at trash page 0, so the clamp keeps them in range.
// Scores, the running max, the normaliser and the accumulator are f32; the
// mask is added in f32; probabilities are rounded to T before p*v, as the
// Pallas kernels do; a zero normaliser divides by 1.
//
// What bounds it on this card: bytes. Each step reads every live KV row once
// (2 * rows * d * sizeof(T) per KV head) and does 4*g operations per
// element read (g = H/hk query heads share each KV head): 4 operations a
// byte at g 2 in bf16, ~13 TFLOP/s at the full 3.35 TB/s, which the FMA
// units (67 TFLOP/s) cover without the tensor cores. The design therefore
// reads each live page once per (slot, KV head), serves all g query heads
// of the group from that one read, and keeps enough copies in flight to
// stream at the card's rate:
//
// 1. paged_partials, grid (S, hk * ng, B), NT threads: split-K over the
//    slot's live tiles. A tile is TILE key rows of one page (a page of
//    fewer rows, or its last tile, is shorter). The host picks S from the
//    shapes and the SM count, never from pos (that would sync the host);
//    each block reads pos[b], counts the slot's live tiles and takes tiles
//    [s * n / S, (s + 1) * n / S). K, V and mask tiles stream through a
//    ring of 2 to 4 stages of shared memory by 16-byte cp.async: tiles
//    i+1 .. i+STAGES-1 are in flight while tile i is scored. A block
//    serves up to GB query heads of one KV head (ng = ceil(g / GB) blocks
//    share a KV head when g > 8). Thread (c, rg) owns features [8c, 8c +
//    8) and row group rg: it scores rows rg, rg + R, ... of each tile for
//    all its heads against q held in registers, sums each score over the
//    DP/8 lanes of its row (log2(DP/8) shuffles a head, where DP is d
//    rounded up to a power of two from 32), and runs its own online
//    softmax and f32 accumulators in registers; no score goes through
//    shared memory. At the end the R row groups are merged in shared
//    memory and the block writes its f32 partials (m, l, acc[d]) per
//    head. A split with no live tile writes m = NEG_INIT, l = 0, acc = 0.
// 2. paged_combine, grid (B * H), NTC threads: merges the S partials of a
//    (slot, head): M = max m_s, L = sum l_s e^(m_s - M), out = sum acc_s
//    e^(m_s - M) / (L, or 1 if L = 0), rounded to T.
//
// The split rule is mirrored by serve/paged.py::paged_attention_partials_ref
// (TILE = kernels/paged_attention.py TILE_ROWS, which the wrapper passes
// and the launcher checks).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"  // cp_async16, cp_async_commit, cp_async_wait

namespace {

constexpr int NT = 128;    // threads of a partials block
constexpr int NTC = 256;   // threads of a combine block
constexpr int TILE = 32;   // key rows of a tile: the unit of the split
constexpr int EPL = 8;     // features a lane owns
constexpr float NEG_INIT = -1.7014117e38f;  // float32 min / 2, as in Pallas

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// eight consecutive elements of shared memory (16-byte aligned) as floats
__device__ __forceinline__ void load8(const float* p, float (&x)[EPL]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&x)[EPL]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The thread layout of a partials block of padded width DP (32 to 256):
// LPR lanes share a key row, R row groups fill the block. The pipeline
// holds as many stages of K and V tiles as ~96 KB takes at width DP (2 to
// 4), so two blocks fit on an SM.
template <typename T, int DP>
struct Layout {
  static constexpr int LPR = DP / EPL;  // lanes per key row
  static constexpr int R = NT / LPR;    // row groups
  static constexpr int RPT = TILE / R;  // rows of a tile per row group
  static constexpr int RB = RPT < 4 ? RPT : 4;  // rows scored together
  static constexpr int KV_BYTES = 2 * TILE * DP * (int)sizeof(T);
  static constexpr int STAGES =
      96 * 1024 / KV_BYTES < 2 ? 2
      : (96 * 1024 / KV_BYTES > 4 ? 4 : 96 * 1024 / KV_BYTES);
  static_assert(LPR >= 4 && LPR <= 32 && R <= TILE && TILE % R == 0 &&
                    RPT % RB == 0,
                "layout");
};

// Elements of one pipeline stage: the K and V tiles and the staged mask
// rows (one, or one per served head).
__host__ __device__ inline size_t stage_elems(int d, int mask_heads,
                                              int gb) {
  return 2 * (size_t)TILE * d + (size_t)(mask_heads == 1 ? 1 : gb) * TILE;
}

// Shared memory of a partials block: the pipeline stages, reused after the
// walk for the merge of the row groups ((R, GB) maxima and sums, (R, GB,
// DP) accumulators).
template <typename T, int DP, int GB>
size_t partials_smem(int d, int mask_heads) {
  using L = Layout<T, DP>;
  const size_t pipe =
      L::STAGES * stage_elems(d, mask_heads, GB) * sizeof(T);
  const size_t merge = (2 + (size_t)DP) * L::R * GB * sizeof(float);
  return pipe > merge ? pipe : merge;
}

template <typename T, int DP, int GB>
__global__ void __launch_bounds__(NT)
paged_partials(const T* __restrict__ q, const T* __restrict__ pool_k,
               const T* __restrict__ pool_v, const T* __restrict__ mask,
               const int* __restrict__ table, const int* __restrict__ pos,
               float* __restrict__ part_m, float* __restrict__ part_l,
               float* __restrict__ part_acc, int H, int hk, int d, int page,
               int Pmax, int mask_heads, int S, float scale) {
  using L = Layout<T, DP>;
  constexpr int LPR = L::LPR, R = L::R, RPT = L::RPT;
  // rows scored together: two at width 256 with 4 or more heads, where
  // ptxas holds the block to 128 registers and four rows spill in f32
  constexpr int RB = GB >= 4 && DP == 256 ? 2 : L::RB;
  constexpr int STAGES = L::STAGES;
  constexpr int V16 = 16 / sizeof(T);  // elements of a 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];

  const int s = blockIdx.x;
  const int g = H / hk;
  const int ng = (g + GB - 1) / GB;
  const int kh = blockIdx.y / ng;
  const int h0 = kh * g + (blockIdx.y % ng) * GB;  // first head served
  const int gc = min(GB, kh * g + g - h0);         // heads served
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int c = tid % LPR;   // feature chunk [8c, 8c + 8)
  const int rg = tid / LPR;  // row group
  const bool cvalid = c * EPL < d;
  const long ctx = (long)Pmax * page;
  const long obase = ((long)b * H + h0) * S + s;  // partial (b, h0, s)

  // the slot's live tiles and this split's share of them
  const int p = pos[b];
  const int n_live = min((p < 0 ? 0 : p / page) + 1, Pmax);
  const int tpp = (page + TILE - 1) / TILE;  // tiles per page
  const int n_tiles = n_live * tpp;
  const int lo = (int)((long)s * n_tiles / S);
  const int hi = (int)((long)(s + 1) * n_tiles / S);
  if (lo == hi) {
    for (int i = tid; i < gc * d; i += NT)
      part_acc[(obase + (long)(i / d) * S) * d + i % d] = 0.f;
    if (tid < gc) {
      part_m[obase + (long)tid * S] = NEG_INIT;
      part_l[obase + (long)tid * S] = 0.f;
    }
    return;
  }

  const size_t stage = stage_elems(d, mask_heads, GB);
  T* const buf = reinterpret_cast<T*>(smem);
  const int mrows = mask_heads == 1 ? 1 : gc;  // mask rows staged
  // K, V and mask tile `tau` of the slot into stage `st`
  auto load_tile = [&](int tau, int st) {
    const int i = tau / tpp, t0 = (tau % tpp) * TILE;
    const int rows = min(TILE, page - t0);
    const long pg = table[(long)b * Pmax + i];
    const long src = ((pg * hk + kh) * page + t0) * (long)d;
    T* ks = buf + st * stage;
    T* vs = ks + TILE * d;
    T* ms = vs + TILE * d;
    const int nkv = rows * d / V16;
    for (int v = tid; v < nkv; v += NT) {
      cp_async16(ks + v * V16, pool_k + src + v * V16, true);
      cp_async16(vs + v * V16, pool_v + src + v * V16, true);
    }
    const int nm = rows / V16;  // rows is a multiple of 8
    for (int v = tid; v < mrows * nm; v += NT) {
      const int j = v / nm, u = v % nm;
      const long hm = mask_heads == 1 ? 0 : h0 + j;
      cp_async16(ms + j * TILE + u * V16,
                 mask + ((long)b * mask_heads + hm) * ctx + (long)i * page +
                     t0 + u * V16,
                 true);
    }
  };

  // q of the served heads, this lane's features, in registers
  float qr[GB][EPL];
  float m[GB], l[GB], acc[GB][EPL];
#pragma unroll
  for (int j = 0; j < GB; ++j) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      qr[j][e] = (j < gc && cvalid)
                     ? to_f(q[((long)b * H + h0 + j) * d + c * EPL + e])
                     : 0.f;
      acc[j][e] = 0.f;
    }
    m[j] = NEG_INIT;
    l[j] = 0.f;
  }

  // STAGES - 1 tiles in flight ahead of the one being scored; a group is
  // committed for every tile slot, empty past the split's end, so the
  // count that wait_group sees stays STAGES - 2 behind
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (lo + i < hi) load_tile(lo + i, i);
    cp_async_commit();
  }
  for (int tau = lo; tau < hi; ++tau) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile tau
    // every thread's copies have landed, and every thread is done with
    // tile tau - 1, whose stage the next copy overwrites
    __syncthreads();
    const int nxt = tau + STAGES - 1;
    if (nxt < hi) load_tile(nxt, (nxt - lo) % STAGES);
    cp_async_commit();
    const int st = (tau - lo) % STAGES;
    const int rows = min(TILE, page - (tau % tpp) * TILE);
    const T* ks = buf + st * stage;
    const T* vs = ks + TILE * d;
    const T* ms = vs + TILE * d;
#pragma unroll
    for (int k0 = 0; k0 < RPT; k0 += RB) {
      float sc[RB][GB];
#pragma unroll
      for (int k = 0; k < RB; ++k) {
        const int r = rg + R * (k0 + k);
        float kf[EPL];
        if (cvalid) {
          load8(ks + r * d + c * EPL, kf);
        } else {
#pragma unroll
          for (int e = 0; e < EPL; ++e) kf[e] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < GB; ++j) {
          float a = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) a = fmaf(qr[j][e], kf[e], a);
          sc[k][j] = a;
        }
      }
      // each score summed over its row's LPR lanes (all lanes get it)
#pragma unroll
      for (int k = 0; k < RB; ++k)
#pragma unroll
        for (int j = 0; j < GB; ++j)
#pragma unroll
          for (int o = LPR / 2; o > 0; o >>= 1)
            sc[k][j] += __shfl_xor_sync(0xffffffffu, sc[k][j], o);
      // scale and mask in f32; rows past the tile's end never count
#pragma unroll
      for (int k = 0; k < RB; ++k) {
        const int r = rg + R * (k0 + k);
#pragma unroll
        for (int j = 0; j < GB; ++j) {
          const int jm = mask_heads == 1 ? 0 : j;
          sc[k][j] = r < rows ? sc[k][j] * scale + to_f(ms[jm * TILE + r])
                              : -INFINITY;
        }
      }
      // this row group's online softmax over the RB rows
#pragma unroll
      for (int j = 0; j < GB; ++j) {
        float mx = m[j];
#pragma unroll
        for (int k = 0; k < RB; ++k) mx = fmaxf(mx, sc[k][j]);
        const float alpha = expf(m[j] - mx);
        float sum = 0.f;
#pragma unroll
        for (int k = 0; k < RB; ++k) {
          const float pe = expf(sc[k][j] - mx);
          sum += pe;
          sc[k][j] = to_f(from_f<T>(pe));  // p in the value dtype
        }
        m[j] = mx;
        l[j] = l[j] * alpha + sum;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[j][e] *= alpha;
      }
#pragma unroll
      for (int k = 0; k < RB; ++k) {
        const int r = rg + R * (k0 + k);
        if (r < rows && cvalid) {
          float vf[EPL];
          load8(vs + r * d + c * EPL, vf);
#pragma unroll
          for (int j = 0; j < GB; ++j)
#pragma unroll
            for (int e = 0; e < EPL; ++e)
              acc[j][e] = fmaf(sc[k][j], vf[e], acc[j][e]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the stages are free: reuse them for the merge

  // merge the R row groups: (R, GB) maxima and sums, (R, GB, DP) acc
  float* rm = reinterpret_cast<float*>(smem);
  float* rl = rm + R * GB;
  float* ra = rl + R * GB;
  if (c == 0) {
#pragma unroll
    for (int j = 0; j < GB; ++j) rm[rg * GB + j] = m[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < GB; ++j) {
    float M = NEG_INIT;
    for (int x = 0; x < R; ++x) M = fmaxf(M, rm[x * GB + j]);
    const float w = expf(m[j] - M);
    if (c == 0) rl[rg * GB + j] = l[j] * w;
    float* dst = ra + (rg * GB + j) * DP + c * EPL;
#pragma unroll
    for (int e = 0; e < EPL; ++e) dst[e] = acc[j][e] * w;
  }
  __syncthreads();
  for (int i = tid; i < gc * d; i += NT) {
    const int j = i / d, e = i % d;
    float a = 0.f;
    for (int x = 0; x < R; ++x) a += ra[(x * GB + j) * DP + e];
    part_acc[(obase + (long)j * S) * d + e] = a;
  }
  if (tid < gc) {
    float M = NEG_INIT, sum = 0.f;
    for (int x = 0; x < R; ++x) M = fmaxf(M, rm[x * GB + tid]);
    for (int x = 0; x < R; ++x) sum += rl[x * GB + tid];
    part_m[obase + (long)tid * S] = M;
    part_l[obase + (long)tid * S] = sum;
  }
}

template <typename T>
__global__ void __launch_bounds__(NTC)
paged_combine(const float* __restrict__ part_m,
              const float* __restrict__ part_l,
              const float* __restrict__ part_acc, T* __restrict__ out, int S,
              int d) {
  extern __shared__ float w[];  // (S,) weights e^(m_s - M)
  __shared__ float red[NTC / 32];
  __shared__ float tot;
  __shared__ float4 part[NTC];
  const long bh = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* pm = part_m + bh * S;
  const float* pl = part_l + bh * S;
  const float* pa = part_acc + bh * S * d;

  float mx = NEG_INIT;
  for (int s = tid; s < S; s += NTC) mx = fmaxf(mx, pm[s]);
  mx = warp_max(mx);
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  if (tid == 0) {
    float M = red[0];
    for (int x = 1; x < NTC / 32; ++x) M = fmaxf(M, red[x]);
    tot = M;
  }
  __syncthreads();
  const float M = tot;
  float sum = 0.f;
  for (int s = tid; s < S; s += NTC) {
    const float ws = expf(pm[s] - M);
    w[s] = ws;
    sum += pl[s] * ws;
  }
  sum = warp_sum(sum);
  __syncthreads();  // every thread has read tot
  if (lane == 0) red[warp] = sum;
  __syncthreads();
  if (tid == 0) {
    float Ls = 0.f;
    for (int x = 0; x < NTC / 32; ++x) Ls += red[x];
    tot = Ls;
  }
  __syncthreads();
  const float Ls = tot;
  const float denom = Ls == 0.f ? 1.f : Ls;
  // thread (f, sg) sums features [4f, 4f + 4) over splits sg, sg + nsg,
  // ..., with loads of several splits in flight; the nsg group sums meet
  // in shared memory
  const int fq = d / 4;      // float4 columns: 2 to 64
  const int nsg = NTC / fq;  // split groups: 4 to 128
  const int f = tid % fq, sg = tid / fq;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  if (sg < nsg) {
#pragma unroll 4
    for (int s = sg; s < S; s += nsg) {
      const float4 v = reinterpret_cast<const float4*>(pa + (long)s * d)[f];
      const float ws = w[s];
      a.x = fmaf(v.x, ws, a.x);
      a.y = fmaf(v.y, ws, a.y);
      a.z = fmaf(v.z, ws, a.z);
      a.w = fmaf(v.w, ws, a.w);
    }
  }
  part[tid] = a;
  __syncthreads();
  const float* sums = reinterpret_cast<const float*>(part);  // (nsg, d)
  for (int e = tid; e < d; e += NTC) {
    float t = 0.f;
    for (int x = 0; x < nsg; ++x) t += sums[x * d + e];
    out[bh * d + e] = from_f<T>(t / denom);
  }
}

struct Args {
  const void *q, *pool_k, *pool_v, *mask;
  const int *table, *pos;
  float* scratch;
  void* out;
  int B, H, hk, d, page, Pmax, mask_heads, S;
  float scale;
  cudaStream_t stream;
};

template <typename T, int DP, int GB>
int launch(const Args& a) {
  const size_t smem = partials_smem<T, DP, GB>(a.d, a.mask_heads);
  auto kern = paged_partials<T, DP, GB>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int g = a.H / a.hk;
  const int ng = (g + GB - 1) / GB;
  const long bhs = (long)a.B * a.H * a.S;
  float* pm = a.scratch;
  float* pl = pm + bhs;
  float* pa = pm + ((2 * bhs + 3) & ~3L);  // 16-byte aligned
  kern<<<dim3(a.S, a.hk * ng, a.B), NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.pool_k),
      static_cast<const T*>(a.pool_v), static_cast<const T*>(a.mask),
      a.table, a.pos, pm, pl, pa, a.H, a.hk, a.d, a.page, a.Pmax,
      a.mask_heads, a.S, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t csmem = (size_t)a.S * sizeof(float);
  if (csmem > 48 * 1024) {
    err = cudaFuncSetAttribute(paged_combine<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)csmem);
    if (err != cudaSuccess) return (int)err;
  }
  paged_combine<T><<<a.B * a.H, NTC, csmem, a.stream>>>(
      pm, pl, pa, static_cast<T*>(a.out), a.S, a.d);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int dispatch_gb(int gb, const Args& a) {
  switch (gb) {
    case 1: return launch<T, DP, 1>(a);
    case 2: return launch<T, DP, 2>(a);
    case 4: return launch<T, DP, 4>(a);
    case 8: return launch<T, DP, 8>(a);
    default: return -1;
  }
}

template <typename T>
int dispatch_d(int gb, const Args& a) {
  if (a.d % 8 || a.d < 8 || a.d > 256) return -1;
  if (a.d <= 32) return dispatch_gb<T, 32>(gb, a);
  if (a.d <= 64) return dispatch_gb<T, 64>(gb, a);
  if (a.d <= 128) return dispatch_gb<T, 128>(gb, a);
  return dispatch_gb<T, 256>(gb, a);
}

template <typename T, int DP>
size_t smem_gb(int gb, int d, int mask_heads) {
  return gb == 1   ? partials_smem<T, DP, 1>(d, mask_heads)
         : gb == 2 ? partials_smem<T, DP, 2>(d, mask_heads)
         : gb == 4 ? partials_smem<T, DP, 4>(d, mask_heads)
                   : partials_smem<T, DP, 8>(d, mask_heads);
}

template <typename T>
size_t smem_d(int gb, int d, int mask_heads) {
  return d <= 32    ? smem_gb<T, 32>(gb, d, mask_heads)
         : d <= 64  ? smem_gb<T, 64>(gb, d, mask_heads)
         : d <= 128 ? smem_gb<T, 128>(gb, d, mask_heads)
                    : smem_gb<T, 256>(gb, d, mask_heads);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. gb: query heads a partials block
// serves (1, 2, 4 or 8); splits: S; tile: the caller's TILE_ROWS, which
// must equal TILE. scratch (16-byte aligned) holds B*H*S*(d + 2) + 4
// floats: m, l, then acc from the next 16-byte boundary. Launches the
// partials and the combine kernel on `stream`. Returns 0 on success, -1
// for an unsupported d, dtype, gb or tile, else the cudaError_t of a
// launch.
extern "C" int paged_attention_launch(
    int dtype, const void* q, const void* pool_k, const void* pool_v,
    const void* mask, const void* table, const void* pos, void* scratch,
    void* out, int B, int H, int hk, int d, int page, int Pmax,
    int mask_heads, int gb, int splits, int tile, float scale,
    void* stream) {
  if (tile != TILE || splits < 1 || page % 8) return -1;
  const Args a{q, pool_k, pool_v, mask,
               static_cast<const int*>(table), static_cast<const int*>(pos),
               static_cast<float*>(scratch), out, B, H, hk, d, page, Pmax,
               mask_heads, splits, scale, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_d<float>(gb, a);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(gb, a);
  return -1;
}

// Dynamic shared memory (bytes) of the partials block that serves width d
// with gb query heads and mask_heads mask rows a slot, or -1 for what the
// launcher refuses.
extern "C" long long paged_partials_smem(int dtype, int d, int mask_heads,
                                         int gb) {
  if (d % 8 || d < 8 || d > 256 || !(gb == 1 || gb == 2 || gb == 4 ||
                                     gb == 8))
    return -1;
  if (dtype == 0) return (long long)smem_d<float>(gb, d, mask_heads);
  if (dtype == 1) return (long long)smem_d<__nv_bfloat16>(gb, d, mask_heads);
  return -1;
}
