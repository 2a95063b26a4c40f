// decode_attention — decode attention (q_len == 1) over the dense, flat
// KV cache of `generate`.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_decode.py::
// decode_attention (registry name "decode_fused").
//
// Computes, for every batch row b and head n,
//   out[b, n*H:(n+1)*H] = softmax_j(q·k_j / sqrt(H)) · v_j,  j = 0..off
// where key j of row b is k_buf[b, j, n*H:(n+1)*H] of the flat
// [B, L, N*H] cache and `off` is one position shared by all rows. The
// output is f32; q and the cache may each be f32 or bf16, and every
// value is widened to f32 on load. The cache is only read (the caller
// writes position off first).
//
// What bounds it: memory. Each (row, head) reads off+1 rows of K and of
// V, 2·B·(off+1)·N·H·itemsize bytes in all, against ~4·H flops per key
// per head: far below the card's ops-per-byte balance.
//
// Design: one CTA per (row, head), 96 CTAs for GPT-3 125M at batch 8 —
// fewer than the card's 132 SMs; splitting the keys across CTAs is left
// for later. The CTA walks keys 0..off only, not all of L (the TPU grid
// visits every L-tile and masks; its head-selection 0/1 matmuls, the
// (8, 128) tiling and the VMEM-sized L-tiles are TPU devices and are
// gone). As in paged_decode.cu each of the 8 warps takes every 8th group
// of 4 keys and issues all 4 keys' K and V loads before computing on any;
// a lane holds H/32 contiguous elements, so a warp reads a key row of the
// head as one contiguous segment. The online softmax runs in f32 with
// the running max started at -1e30 and keys past off excluded explicitly
// (p = 0), so no exp(-inf + inf) can form; the warps merge once at the
// end through shared memory and the CTA makes one f32 store per element.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kGroup = 4;       // keys a warp has in flight at once
constexpr float kNeg = -1e30f;

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

template <typename TQ, typename TC, int H>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const TQ* __restrict__ q, const TC* __restrict__ k_buf,
                        const TC* __restrict__ v_buf, float* __restrict__ out,
                        int L, int n_heads, int last, float scale) {
  constexpr int kPerLane = H / 32;
  static_assert(kPerLane % 2 == 0, "head_dim must be a multiple of 64");
  const int b = blockIdx.x;
  const int n = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long nh = (long long)n_heads * H;
  const long long col = (long long)n * H + lane * kPerLane;
  const TC* kb = k_buf + (long long)b * L * nh + col;
  const TC* vb = v_buf + (long long)b * L * nh + col;

  float qv[kPerLane];
  load_f32<kPerLane>(q + b * nh + col, qv);
  float m = kNeg, l = 0.f, acc[kPerLane];
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) acc[e] = 0.f;

  for (int j0 = warp * kGroup; j0 <= last; j0 += kWarps * kGroup) {
    float kf[kGroup][kPerLane], vf[kGroup][kPerLane];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      // keys past `last` re-read key `last` and are excluded below
      const long long row = (long long)min(j0 + u, last) * nh;
      load_f32<kPerLane>(kb + row, kf[u]);
      load_f32<kPerLane>(vb + row, vf[u]);
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
    // key j0 <= last is live, so the group max is a real score
    float gmax = kNeg;
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      sc[u] *= scale;
      if (j0 + u <= last) gmax = fmaxf(gmax, sc[u]);
    }
    const float m_new = fmaxf(m, gmax);
    const float alpha = __expf(m - m_new);   // 0 on the first group
    l *= alpha;
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) acc[e] *= alpha;
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const float p = j0 + u <= last ? __expf(sc[u] - m_new) : 0.f;
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

  // warp 0 always holds key 0, so the merged max is a real score and
  // den > 0; a warp that saw no key (l = 0) weighs 0
  float mx = kNeg;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
  for (int d = threadIdx.x; d < H; d += blockDim.x) {
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = sm_l[w] == 0.f ? 0.f : __expf(sm_m[w] - mx);
      den += sm_l[w] * c;
      num += sm_acc[w][d] * c;
    }
    out[b * nh + (long long)n * H + d] = num / den;
  }
}

template <typename TQ, typename TC>
int launch(const void* q, const void* k_buf, const void* v_buf, float* out,
           int B, int L, int n_heads, int head_dim, int last, float scale,
           cudaStream_t stream) {
  const dim3 grid(B, n_heads);
  const dim3 block(kWarps * 32);
  const TQ* qp = static_cast<const TQ*>(q);
  const TC* kp = static_cast<const TC*>(k_buf);
  const TC* vp = static_cast<const TC*>(v_buf);
  switch (head_dim) {
    case 64:
      decode_attention_kernel<TQ, TC, 64><<<grid, block, 0, stream>>>(
          qp, kp, vp, out, L, n_heads, last, scale);
      break;
    case 128:
      decode_attention_kernel<TQ, TC, 128><<<grid, block, 0, stream>>>(
          qp, kp, vp, out, L, n_heads, last, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename TQ>
int launch_q(const void* q, const void* k_buf, const void* v_buf, float* out,
             int B, int L, int n_heads, int head_dim, int last, float scale,
             int cache_dtype, cudaStream_t stream) {
  if (cache_dtype == 0)
    return launch<TQ, float>(q, k_buf, v_buf, out, B, L, n_heads, head_dim,
                             last, scale, stream);
  if (cache_dtype == 1)
    return launch<TQ, __nv_bfloat16>(q, k_buf, v_buf, out, B, L, n_heads,
                                     head_dim, last, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [B, 1, N*H], k_buf/v_buf [B, L, N*H], out f32 [B, 1, N*H]; keys
// 0..last are read (last = min(off, L - 1)). Dtype codes: 0 = float32,
// 1 = bfloat16, for q and for the cache; head_dim 64 or 128. Returns a
// cudaError_t code.
extern "C" int decode_attention_launch(const void* q, const void* k_buf,
                                       const void* v_buf, void* out, int B,
                                       int L, int n_heads, int head_dim,
                                       int last, int q_dtype, int cache_dtype,
                                       float scale, void* stream) {
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return launch_q<float>(q, k_buf, v_buf, o, B, L, n_heads, head_dim, last,
                           scale, cache_dtype, st);
  if (q_dtype == 1)
    return launch_q<__nv_bfloat16>(q, k_buf, v_buf, o, B, L, n_heads,
                                   head_dim, last, scale, cache_dtype, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
