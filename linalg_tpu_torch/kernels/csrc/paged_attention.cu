// Paged decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU kernels of linalg_tpu/serve/paged.py:
// paged_attn_pallas_dma (_paged_attn_dma_kernel) and paged_attn_pallas
// (_paged_attn_kernel). Both compute, for every slot b and query head h,
// single-token attention over the slot's KV rows, which live in a pool of
// fixed-size pages addressed through a per-slot page table. One kernel here
// covers both: the DMA kernel's 128-lane row folding and the grid kernel's
// 8-row query padding are TPU layout workarounds with no counterpart on
// this card.
//
// Contract (the Pallas kernels' contract, unchanged):
//   q      (B, H, 1, d)               compute dtype T (float or bf16)
//   pool_k (n_pages, hk, page, d)     T, hk divides H (GQA)
//   pool_v (n_pages, hk, page, d)     T
//   mask   (B, 1|H, 1, Pmax*page)     T, additive (validity and any bias)
//   table  (B, Pmax) int32            logical page i of slot b -> pool page
//   pos    (B,) int32                 slot positions
//   out    (B, H, 1, d)               T
// Query head h reads KV head h / (H/hk). The walk over logical pages stops
// at min(pos[b] / page + 1, Pmax): idle slots' positions grow past ctx and
// their table rows point at trash page 0, so the clamp keeps them in range.
// Scores, the running max, the normalizer and the accumulator are f32; the
// mask is added in f32; probabilities are rounded to T before p*v, as the
// Pallas kernels do; a zero normalizer divides by 1.
//
// What bounds it on this card: bytes. Each step reads every live KV row once
// (2 * rows * d * sizeof(T) per KV head) and does 4*g flops per element read
// (g = H/hk query heads share each KV head), far below the ~295 flops/byte
// at which the tensor cores would become the limit. The design therefore
// reads each live page exactly once per (slot, KV head) and serves all g
// query heads of the group from that one read, keeps scores and
// accumulators in shared memory and registers, and never materializes the
// gathered (B, hk, ctx, d) view that the plain PyTorch version builds.
//
// Layout: one thread block per (slot b, KV head kh), NT threads. Each
// logical page is consumed in tiles of TILE rows: the K and V tiles are
// copied to shared memory with 16-byte loads, one warp per key row computes
// the g scores (a warp-shuffle reduction over d), one warp per query head
// updates the online softmax, and all threads update the g x d
// accumulators. Simple and correct first; split-K over pages (more blocks
// in flight than B * hk), cp.async/TMA double buffering and wgmma are later
// work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;            // threads per block
constexpr int NWARPS = NT / 32;
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

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Shared-memory floats ahead of the K/V tiles, rounded up to 16 bytes.
__host__ __device__ inline int head_floats(int g, int D, int TILE) {
  int n = 2 * g * D + g * TILE + 3 * g;
  return (n + 3) & ~3;
}

template <typename T, int D, int TILE>
__global__ void __launch_bounds__(NT)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                       const T* __restrict__ pool_v,
                       const T* __restrict__ mask,
                       const int* __restrict__ table,
                       const int* __restrict__ pos, T* __restrict__ out,
                       int H, int hk, int page, int Pmax, int mask_heads,
                       float scale) {
  extern __shared__ __align__(16) float smem[];
  const int g = H / hk;
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long ctx = (long)Pmax * page;

  float* qs = smem;                  // (g, D) query group, f32
  float* acc = qs + g * D;           // (g, D) accumulators
  float* sc = acc + g * D;           // (g, TILE) scores, then probabilities
  float* m_s = sc + g * TILE;        // (g,) running max
  float* l_s = m_s + g;              // (g,) running normalizer
  float* a_s = l_s + g;              // (g,) rescale factor of this tile
  T* ks = reinterpret_cast<T*>(smem + head_floats(g, D, TILE));  // (TILE, D)
  T* vs = ks + TILE * D;                                          // (TILE, D)

  for (int i = tid; i < g * D; i += NT) {
    const int j = i / D, e = i % D;
    qs[i] = to_f(q[((long)b * H + kh * g + j) * D + e]);
    acc[i] = 0.f;
  }
  for (int j = tid; j < g; j += NT) {
    m_s[j] = NEG_INIT;
    l_s[j] = 0.f;
  }
  __syncthreads();

  const int p = pos[b];
  int n_live = (p < 0 ? 0 : p / page) + 1;
  if (n_live > Pmax) n_live = Pmax;
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int C = D / 32;            // elements of a key row per lane

  for (int i = 0; i < n_live; ++i) {
    const long page_id = table[(long)b * Pmax + i];
    const long head_base = ((page_id * hk + kh) * (long)page) * D;
    for (int t0 = 0; t0 < page; t0 += TILE) {
      const int rows = min(TILE, page - t0);
      const uint4* ksrc =
          reinterpret_cast<const uint4*>(pool_k + head_base + (long)t0 * D);
      const uint4* vsrc =
          reinterpret_cast<const uint4*>(pool_v + head_base + (long)t0 * D);
      const int n_vec = rows * D / VEC;
      for (int v = tid; v < n_vec; v += NT) {
        reinterpret_cast<uint4*>(ks)[v] = ksrc[v];
        reinterpret_cast<uint4*>(vs)[v] = vsrc[v];
      }
      __syncthreads();

      // scores: one warp per key row, all g query heads of the group
      for (int r = warp; r < rows; r += NWARPS) {
        float kr[C];
#pragma unroll
        for (int c = 0; c < C; ++c) kr[c] = to_f(ks[r * D + lane + 32 * c]);
        const long t = (long)i * page + t0 + r;
        for (int j = 0; j < g; ++j) {
          float s = 0.f;
#pragma unroll
          for (int c = 0; c < C; ++c) s += qs[j * D + lane + 32 * c] * kr[c];
          s = warp_sum(s);
          if (lane == 0) {
            const int mh = mask_heads == 1 ? 0 : kh * g + j;
            sc[j * TILE + r] =
                s * scale + to_f(mask[((long)b * mask_heads + mh) * ctx + t]);
          }
        }
      }
      __syncthreads();

      // online softmax: one warp per query head
      for (int j = warp; j < g; j += NWARPS) {
        float mx = NEG_INIT;
        for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, sc[j * TILE + r]);
        mx = warp_max(mx);
        const float m_prev = m_s[j];
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int r = lane; r < rows; r += 32) {
          const float pe = expf(sc[j * TILE + r] - m_new);
          sum += pe;
          sc[j * TILE + r] = to_f(from_f<T>(pe));  // p in the value dtype
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          l_s[j] = l_s[j] * alpha + sum;
          m_s[j] = m_new;
          a_s[j] = alpha;
        }
      }
      __syncthreads();

      // accumulators: thread per (head, feature), f32
      for (int idx = tid; idx < g * D; idx += NT) {
        const int j = idx / D, e = idx % D;
        float a = acc[idx] * a_s[j];
        const float* pj = sc + j * TILE;
        for (int r = 0; r < rows; ++r) a += pj[r] * to_f(vs[r * D + e]);
        acc[idx] = a;
      }
      __syncthreads();
    }
  }

  for (int idx = tid; idx < g * D; idx += NT) {
    const int j = idx / D, e = idx % D;
    const float l = l_s[j];
    out[((long)b * H + kh * g + j) * D + e] =
        from_f<T>(acc[idx] / (l == 0.f ? 1.f : l));
  }
}

template <typename T, int D>
int launch(const void* q, const void* pool_k, const void* pool_v,
           const void* mask, const int* table, const int* pos, void* out,
           int B, int H, int hk, int page, int Pmax, int mask_heads,
           float scale, cudaStream_t stream) {
  // K and V tiles take 32 KB together in either dtype
  constexpr int TILE = sizeof(T) == 4 ? 32 : 64;
  const int g = H / hk;
  const size_t smem = head_floats(g, D, TILE) * sizeof(float) +
                      2 * (size_t)TILE * D * sizeof(T);
  auto kern = paged_attention_kernel<T, D, TILE>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(B, hk);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool_k),
      static_cast<const T*>(pool_v), static_cast<const T*>(mask), table, pos,
      static_cast<T*>(out), H, hk, page, Pmax, mask_heads, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int d, const void* q, const void* pool_k, const void* pool_v,
               const void* mask, const int* table, const int* pos, void* out,
               int B, int H, int hk, int page, int Pmax, int mask_heads,
               float scale, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, pool_k, pool_v, mask, table, pos, out, B, H, hk,
                           page, Pmax, mask_heads, scale, stream);
    case 64:
      return launch<T, 64>(q, pool_k, pool_v, mask, table, pos, out, B, H, hk,
                           page, Pmax, mask_heads, scale, stream);
    case 128:
      return launch<T, 128>(q, pool_k, pool_v, mask, table, pos, out, B, H,
                            hk, page, Pmax, mask_heads, scale, stream);
    default:
      return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns 0 on success, -1 for an
// unsupported d or dtype, else the cudaError_t of the launch.
extern "C" int paged_attention_launch(int dtype, const void* q,
                                      const void* pool_k, const void* pool_v,
                                      const void* mask, const void* table,
                                      const void* pos, void* out, int B, int H,
                                      int hk, int d, int page, int Pmax,
                                      int mask_heads, float scale,
                                      void* stream) {
  const int* tbl = static_cast<const int*>(table);
  const int* ps = static_cast<const int*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(d, q, pool_k, pool_v, mask, tbl, ps, out, B, H,
                             hk, page, Pmax, mask_heads, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, pool_k, pool_v, mask, tbl, ps, out,
                                     B, H, hk, page, Pmax, mask_heads, scale,
                                     s);
  return -1;
}
