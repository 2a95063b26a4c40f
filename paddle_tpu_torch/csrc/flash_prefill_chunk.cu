// flash_prefill_chunk — one request's chunked-prefill attention over the
// paged KV arenas.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_decode.py::
// flash_prefill_chunk (registry name "flash_prefill_chunk").
//
// The chunk's C queries sit at positions p0..p0+C-1 (p0 is a runtime
// value and need not be a multiple of bs: a prefix-cache hit resumes
// anywhere). Query row i of head n attends causally to keys
// 0..min(p0+i, mb*bs-1), key j living in physical block table_row[j/bs],
// row j % bs, columns n*H..n*H+H of the [num_blocks, bs, N*H] arenas:
//   out[i, n*H:(n+1)*H] = softmax_j(q_i·k_j / sqrt(H)) · v_j
//
// What bounds it: at the serving shapes (C = 128, H = 64, context up to
// 512) the kernel moves (p0+C)·N·H·2·itemsize bytes of K/V and does
// ~4·H flops per (query, key) pair per head, so a full chunk over a long
// context is near the card's balance point, while the short contexts
// are bound by memory. This first version is bound by neither: it uses
// FMA and shared memory, not the tensor cores, and its 24 CTAs (12 heads
// x 2 row tiles at C = 128) fill 24 of the 132 SMs. That is the design's
// known limit, recorded for the PR that makes it fast.
//
// Design: one CTA per (head, tile of 64 query rows), one thread per
// query row holding q and its f32 accumulator in registers. The CTA
// walks the logical blocks 0..(last key of its tile)/bs IN ORDER,
// staging each block's K and V rows for its head in shared memory (f32),
// and every thread updates its row's online softmax once per 8-key
// sub-tile. Keys past a row's position are excluded explicitly (p = 0),
// and block 0 — key 0, which every query may see — comes first, so the
// running max is finite before any fully masked sub-tile could appear;
// masked sub-tiles are skipped. Padded query rows past the request's
// real tokens read whatever the null block holds, which the engine keeps
// finite, and their outputs are discarded by the caller.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 64;     // query rows per CTA, one thread each
constexpr int kSub = 8;       // keys per online-softmax update

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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
__global__ void __launch_bounds__(kRows)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                     const T* __restrict__ v_pages,
                     const int* __restrict__ table_row, T* __restrict__ out,
                     int C, int n_heads, int bs, int mb, int p0,
                     float scale) {
  extern __shared__ float smem[];
  float* ks = smem;             // [bs][H]
  float* vs = smem + bs * H;    // [bs][H]
  const int n = blockIdx.x;
  const int r0 = blockIdx.y * kRows;
  const int r = r0 + threadIdx.x;
  const bool live = r < C;
  const long long nh = (long long)n_heads * H;
  const int n_keys = mb * bs;
  const int last = min(p0 + r, n_keys - 1);       // this row's last key
  const int tile_last = min(p0 + min(r0 + kRows, C) - 1, n_keys - 1);
  const int n_blocks = tile_last / bs + 1;

  float qv[H], acc[H];
#pragma unroll
  for (int d = 0; d < H; ++d) {
    qv[d] = live ? to_f32(q[r * nh + (long long)n * H + d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int b = 0; b < n_blocks; ++b) {
    const long long base =
        (long long)table_row[b] * bs * nh + (long long)n * H;
    __syncthreads();            // the previous block's rows are consumed
    for (int i = threadIdx.x; i < bs * H; i += kRows) {
      const long long off = base + (long long)(i / H) * nh + (i % H);
      ks[i] = to_f32(k_pages[off]);
      vs[i] = to_f32(v_pages[off]);
    }
    __syncthreads();
    if (!live) continue;
    for (int t = 0; t < bs; t += kSub) {
      const int kpos = b * bs + t;
      if (kpos > last) break;   // this and later sub-tiles fully masked
      float sc[kSub];
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const float* kr = ks + (t + j) * H;
        float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
#pragma unroll
        for (int d = 0; d < H; d += 4) {
          d0 += qv[d] * kr[d];
          d1 += qv[d + 1] * kr[d + 1];
          d2 += qv[d + 2] * kr[d + 2];
          d3 += qv[d + 3] * kr[d + 3];
        }
        sc[j] = kpos + j <= last ? ((d0 + d1) + (d2 + d3)) * scale
                                 : -INFINITY;
        tmax = fmaxf(tmax, sc[j]);
      }
      // key kpos <= last is live, so tmax and m_new are finite
      const float m_new = fmaxf(m, tmax);
      const float alpha = __expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < H; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const float p = __expf(sc[j] - m_new);    // 0 for masked keys
        const float* vr = vs + (t + j) * H;
        l += p;
#pragma unroll
        for (int d = 0; d < H; ++d) acc[d] += p * vr[d];
      }
      m = m_new;
    }
  }
  if (live) {
    const float inv = 1.f / l;
    T* o = out + r * nh + (long long)n * H;
#pragma unroll
    for (int d = 0; d < H; ++d) o[d] = from_f32<T>(acc[d] * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* table_row, void* out, int C, int n_heads, int head_dim,
           int bs, int mb, int p0, float scale, cudaStream_t stream) {
  const dim3 grid(n_heads, (C + kRows - 1) / kRows);
  const dim3 block(kRows);
  const size_t smem = 2 * (size_t)bs * head_dim * sizeof(float);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k_pages);
  const T* vp = static_cast<const T*>(v_pages);
  T* op = static_cast<T*>(out);
  switch (head_dim) {
    case 64:
      flash_prefill_kernel<T, 64><<<grid, block, smem, stream>>>(
          qp, kp, vp, table_row, op, C, n_heads, bs, mb, p0, scale);
      break;
    case 128:
      flash_prefill_kernel<T, 128><<<grid, block, smem, stream>>>(
          qp, kp, vp, table_row, op, C, n_heads, bs, mb, p0, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim 64 or 128. bs must be a
// multiple of 8 and 2*bs*head_dim*4 bytes of shared memory must fit the
// 48 KB static limit (the wrapper checks both). Returns a cudaError_t.
extern "C" int flash_prefill_chunk_launch(const void* q, const void* k_pages,
                                          const void* v_pages,
                                          const void* table_row, void* out,
                                          int C, int n_heads, int head_dim,
                                          int bs, int mb, int p0, int dtype,
                                          float scale, void* stream) {
  const int* tab = static_cast<const int*>(table_row);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, tab, out, C, n_heads,
                         head_dim, bs, mb, p0, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, tab, out, C, n_heads,
                                 head_dim, bs, mb, p0, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_prefill_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
