// paged_decode — decode attention (q_len == 1) over the paged KV arenas.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_decode.py::
// paged_decode_attention (registry name "paged_decode").
//
// Computes, for every slot s and head n,
//   out[s, n*H:(n+1)*H] = softmax_j(q·k_j / sqrt(H)) · v_j,  j = 0..ctx[s]
// where key j of slot s lives in physical block block_tables[s, j / bs],
// row j % bs, columns n*H..n*H+H of the [num_blocks, bs, N*H] arenas.
//
// What bounds it: memory. Each slot reads ctx+1 rows of K and of V for
// every head, Σ_s (ctx_s + 1) · N·H · 2 · itemsize bytes, against ~4·H
// flops per row per head: far below the card's ops-per-byte balance.
//
// Design: one CTA per (slot, head) — 16 x 12 = 192 CTAs for GPT-3 125M
// at 16 slots. The CTA reads its slot's block table itself and walks the
// logical keys 0..ctx only (the TPU design walks all max_blocks grid
// steps and skips with pl.when; its head-selection matrices and 128-lane
// padding are TPU tiling devices and are gone). Each key costs two
// dependent loads (table entry, then the row), so latency, not bandwidth,
// limits a CTA: each of the 8 warps takes every 8th GROUP of 4 keys and
// issues all 4 keys' K and V loads before computing on any, with one
// online-softmax update (running max m, denominator l, weighted value sum,
// in f32) per group. A lane holds H/32 contiguous elements, loaded as
// 2-element vectors, so a warp reads a key row of the head as one
// contiguous segment. The warps merge once at the end through shared
// memory. Keys past ctx are never used (their group slots are masked and
// their loads re-read key ctx), so no -1e30 mask is needed; an inactive
// slot (ctx 0, all-null table) reads key 0 of the null block and returns
// that finite row like the plain version does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kGroup = 4;     // keys a warp has in flight at once

// N (even) contiguous elements -> f32, two at a time
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float* out) {
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    const float2 f = *reinterpret_cast<const float2*>(p + i);
    out[i] = f.x;
    out[i + 1] = f.y;
  }
}
template <int N>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float* out) {
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + i));
    out[i] = f.x;
    out[i + 1] = f.y;
  }
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int H>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ ctx_lens, T* __restrict__ out,
                    int n_heads, int bs, int mb, float scale) {
  constexpr int kPerLane = H / 32;
  static_assert(kPerLane % 2 == 0, "head_dim must be a multiple of 64");
  const int s = blockIdx.x;
  const int n = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long nh = (long long)n_heads * H;
  const long long col = (long long)n * H + lane * kPerLane;
  // keys beyond the table's reach do not exist; the plain version's
  // mask over mb*bs gathered keys treats a larger ctx the same way
  const int last = min(ctx_lens[s], mb * bs - 1);
  const int* table = block_tables + (long long)s * mb;

  float qv[kPerLane];
  load_f32<kPerLane>(q + s * nh + col, qv);
  float m = -INFINITY, l = 0.f, acc[kPerLane];
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) acc[e] = 0.f;

  for (int j0 = warp * kGroup; j0 <= last; j0 += kWarps * kGroup) {
    float kf[kGroup][kPerLane], vf[kGroup][kPerLane];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int j = min(j0 + u, last);
      const long long row =
          ((long long)table[j / bs] * bs + (j % bs)) * nh + col;
      load_f32<kPerLane>(k_pages + row, kf[u]);
      load_f32<kPerLane>(v_pages + row, vf[u]);
    }
    float sc[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) dot += qv[e] * kf[u][e];
      sc[u] = dot;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int u = 0; u < kGroup; ++u)
        sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], o);
    }
    float gmax = -INFINITY;
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      sc[u] = j0 + u <= last ? sc[u] * scale : -INFINITY;
      gmax = fmaxf(gmax, sc[u]);
    }
    // key j0 <= last is live, so gmax and m_new are finite
    const float m_new = fmaxf(m, gmax);
    const float alpha = __expf(m - m_new);   // 0 on the first group
    l *= alpha;
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) acc[e] *= alpha;
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const float p = __expf(sc[u] - m_new);  // 0 for masked keys
      l += p;
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) acc[e] += p * vf[u][e];
    }
    m = m_new;
  }

  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_acc[kWarps][H];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) sm_acc[warp][lane * kPerLane + e] = acc[e];
  __syncthreads();

  // warp 0 always holds key 0, so the merged max is finite and den > 0;
  // warps that saw no key (m = -inf) weigh 0
  float mx = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
  for (int d = threadIdx.x; d < H; d += blockDim.x) {
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = sm_m[w] == -INFINITY ? 0.f : __expf(sm_m[w] - mx);
      den += sm_l[w] * c;
      num += sm_acc[w][d] * c;
    }
    out[s * nh + (long long)n * H + d] = from_f32<T>(num / den);
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* block_tables, const int* ctx_lens, void* out, int S,
           int n_heads, int head_dim, int bs, int mb, float scale,
           cudaStream_t stream) {
  const dim3 grid(S, n_heads);
  const dim3 block(kWarps * 32);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k_pages);
  const T* vp = static_cast<const T*>(v_pages);
  T* op = static_cast<T*>(out);
  switch (head_dim) {
    case 64:
      paged_decode_kernel<T, 64><<<grid, block, 0, stream>>>(
          qp, kp, vp, block_tables, ctx_lens, op, n_heads, bs, mb, scale);
      break;
    case 128:
      paged_decode_kernel<T, 128><<<grid, block, 0, stream>>>(
          qp, kp, vp, block_tables, ctx_lens, op, n_heads, bs, mb, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim 64 or 128. Returns a
// cudaError_t code.
extern "C" int paged_decode_launch(const void* q, const void* k_pages,
                                   const void* v_pages,
                                   const void* block_tables,
                                   const void* ctx_lens, void* out, int S,
                                   int n_heads, int head_dim, int bs, int mb,
                                   int dtype, float scale, void* stream) {
  const int* tab = static_cast<const int*>(block_tables);
  const int* ctx = static_cast<const int*>(ctx_lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, tab, ctx, out, S, n_heads,
                         head_dim, bs, mb, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, tab, ctx, out, S,
                                 n_heads, head_dim, bs, mb, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
