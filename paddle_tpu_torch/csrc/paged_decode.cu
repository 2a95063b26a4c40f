// paged_decode — decode attention (q_len == 1) over the paged KV arenas.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_decode.py::
// paged_decode_attention (registry name "paged_decode").
//
// Computes, for every slot s and head n,
//   out[s, n*H:(n+1)*H] = softmax_j(q·k_j / sqrt(H)) · v_j,  j = 0..ctx[s]
// where key j of slot s lives in physical block block_tables[s, j / bs],
// row j % bs, columns n*H..n*H+H of the [num_blocks, bs, N*H] arenas. A
// ctx beyond the table's reach is clamped to mb*bs - 1.
//
// What bounds it: memory. Each slot reads ctx+1 rows of K and of V for
// every head, Σ_s (ctx_s + 1) · N·H · 2 · itemsize bytes, against ~4·H
// flops per row per head: far below the card's ops-per-byte balance. At
// a serving step (16 slots, ctx up to 511, GPT-3 125M) that is 9-15 MB,
// 3-5 us at 3.35 TB/s, so what costs is how many SMs pull at once and
// how many round trips each makes.
//
// Design (flash-decoding, two kernels on one stream):
// - paged_decode_split: one CTA per (slot, chunk of `chunk` keys; the
//   wrapper's 32, two blocks of 16), covering all heads; chunks past
//   the slot's last key exit at once.
//   A CTA reads whole key rows (N·H contiguous elements, 1536 bytes at
//   GPT-3 125M in bf16), and each page it touches is read by it alone.
//   Its warps form a grid of column slices x key lanes: a slice is 32
//   lanes x 16 bytes of the row (so a head is H / (16 / itemsize)
//   neighbouring lanes, whose dot products meet by shuffles), and key
//   lane w takes keys c0 + w, c0 + w + KW, ... The CTA loads its slice
//   of the block table into shared memory together with ctx, so the
//   table is no dependent load per key; then each warp issues the K and
//   V loads of kGroup keys before computing on any. Every warp keeps an
//   online softmax per head in the exp2 domain (running max m, sum l,
//   weighted value sum in f32); the key lanes merge in shared memory.
//   A slot with one chunk writes `out` there; otherwise the chunk writes
//   its partial (m, l, acc) in f32 to scratch.
// - paged_decode_merge: one CTA per (slot, head) of a slot with more
//   than one chunk; its threads find the chunks' weights exp2(m_c -
//   max_c m_c) together, then each merges one column over the chunks in
//   chunk order (deterministic) and writes `out` in the arena dtype. It
//   is launched as a programmatic dependent of the split grid, so its
//   launch overlaps the split grid's run.
//   A second launch was chosen over a "last CTA merges" counter: no
//   counters to keep zeroed between calls, and no atomics.
// Tried on the H100 and slower: chunks of 16 keys (more CTAs), 8 keys a
// warp in flight (more registers, one CTA an SM), the chunk's K and V
// rows staged in shared memory by TMA bulk copies in one round trip;
// level: chunks of 64 keys at 16 slots of ctx 0..511 (fewer CTAs at
// shorter contexts), a "last CTA merges" counter instead of the second
// kernel. What holds it back: the floor of one launch (~0.005 ms in
// kernel_ab.py's timing) and the dependent round trips, ctx and table,
// then the rows, then the partials and the merge.
// Keys past the slot's last key are never used: their loads re-read the
// last key and their scores are -inf, so p = 0. A warp or chunk that
// holds no live key keeps m = -inf and weighs 0 in its merge (every
// launched chunk holds its first key, so each merge has a finite max).
// An inactive slot (ctx 0, all-null table) reads key 0 of the null
// block and returns that finite row like the plain version does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 16;   // a CTA's warps: slices x key lanes
constexpr int kKeyLanes = 4;    // key lanes (KW) when the slices allow
constexpr int kGroup = 4;       // keys a warp has in flight at once
constexpr float kLog2e = 1.4426950408889634f;

// 16 bytes (4 f32 or 8 bf16) -> f32
__device__ __forceinline__ void to_f32(const uint4& r, float (&out)[4]) {
  out[0] = __uint_as_float(r.x);
  out[1] = __uint_as_float(r.y);
  out[2] = __uint_as_float(r.z);
  out[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void to_f32(const uint4& r, float (&out)[8]) {
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(b[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
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

// grid (S, max chunks); block 32 * slices * key_lanes threads; dynamic
// shared memory: the table slice, then m and l [key_lanes][N], then acc
// [key_lanes][N*H] (f32)
template <typename T, int H>
__global__ void __launch_bounds__(kMaxWarps * 32)
paged_decode_split(const T* __restrict__ q, const T* __restrict__ k_pages,
                   const T* __restrict__ v_pages,
                   const int* __restrict__ block_tables,
                   const int* __restrict__ ctx_lens, T* __restrict__ out,
                   float* __restrict__ part_acc,
                   float* __restrict__ part_ml, int n_heads, int bs, int mb,
                   int chunk, int key_lanes, float scale) {
  constexpr int V = 16 / sizeof(T);   // elements a lane loads at once
  constexpr int HL = H / V;           // lanes of one head: 8, 16 or 32
  const int s = blockIdx.x, c = blockIdx.y;
  const int c0 = c * chunk;
  const int nh = n_heads * H;
  const int tab_len = (chunk + bs - 1) / bs + 1;
  extern __shared__ float smem[];
  int* tab = reinterpret_cast<int*>(smem);
  float* sm_m = smem + tab_len;
  float* sm_l = sm_m + key_lanes * n_heads;
  float* sm_acc = sm_l + key_lanes * n_heads;
  // the merge kernel may start its launch now; it waits for this grid
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slices = blockDim.x / 32 / key_lanes;
  const int kw = warp / slices;
  const int col = ((warp % slices) * 32 + lane) * V;
  const bool live = col < nh;           // whole heads are live or not
  const int head = col / H;
  const long long nh64 = nh;
  // q, the chunk's table entries and ctx in one round trip (entries
  // past the chunk's last live key are never read)
  uint4 qr = make_uint4(0, 0, 0, 0);
  if (live) qr = *reinterpret_cast<const uint4*>(q + s * nh64 + col);
  const int b0 = c0 / bs;
  for (int i = threadIdx.x; i < tab_len && b0 + i < mb; i += blockDim.x)
    tab[i] = block_tables[(long long)s * mb + b0 + i];
  // keys beyond the table's reach do not exist; the plain version's
  // mask over mb*bs gathered keys treats a larger ctx the same way
  const int last = min(ctx_lens[s], mb * bs - 1);
  if (c0 > last) return;
  const int cend = min(c0 + chunk - 1, last);     // the chunk's last key
  const int nchunks = last / chunk + 1;
  float qv[V];
  to_f32(qr, qv);
  __syncthreads();

  const float sl2 = scale * kLog2e;
  float m = -INFINITY, l = 0.f, acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
  // key j0 + u * key_lanes for u < kGroup; j0 itself is live
  for (int j0 = c0 + kw; j0 <= cend; j0 += key_lanes * kGroup) {
    uint4 kr[kGroup], vr[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int j = min(j0 + u * key_lanes, cend);
      const long long row =
          ((long long)tab[j / bs - b0] * bs + (j % bs)) * nh64 + col;
      if (live) {
        kr[u] = *reinterpret_cast<const uint4*>(k_pages + row);
        vr[u] = *reinterpret_cast<const uint4*>(v_pages + row);
      } else {
        kr[u] = vr[u] = make_uint4(0, 0, 0, 0);
      }
    }
    float sc[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      float kf[V];
      to_f32(kr[u], kf);
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < V; ++e) dot += qv[e] * kf[e];
      sc[u] = dot;
    }
#pragma unroll
    for (int o = HL / 2; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < kGroup; ++u)
        sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], o);
    float gmax = -INFINITY;
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      sc[u] = j0 + u * key_lanes <= cend ? sc[u] * sl2 : -INFINITY;
      gmax = fmaxf(gmax, sc[u]);
    }
    const float m_new = fmaxf(m, gmax);       // finite: key j0 is live
    const float alpha = exp2f(m - m_new);     // 0 on the first group
    l *= alpha;
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] *= alpha;
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const float p = exp2f(sc[u] - m_new);   // 0 for masked keys
      float vf[V];
      to_f32(vr[u], vf);
      l += p;
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] += p * vf[e];
    }
    m = m_new;
  }

  if (live) {
    if (lane % HL == 0) {
      sm_m[kw * n_heads + head] = m;
      sm_l[kw * n_heads + head] = l;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) sm_acc[kw * nh + col + e] = acc[e];
  }
  __syncthreads();
  // merge the key lanes (lane 0 holds key c0, so the max is finite; a
  // lane that saw no key has m = -inf and weighs 0)
  const long long part = (long long)s * gridDim.y + c;
  for (int p = threadIdx.x; p < nh; p += blockDim.x) {
    const int h = p / H;
    float mx = -INFINITY;
    for (int w = 0; w < key_lanes; ++w)
      mx = fmaxf(mx, sm_m[w * n_heads + h]);
    float num = 0.f, den = 0.f;
    for (int w = 0; w < key_lanes; ++w) {
      const float mw = sm_m[w * n_heads + h];
      const float wt = mw == -INFINITY ? 0.f : exp2f(mw - mx);
      num += wt * sm_acc[w * nh + p];
      den += wt * sm_l[w * n_heads + h];
    }
    if (nchunks == 1) {
      out[s * nh64 + p] = from_f32<T>(num / den);
    } else {
      part_acc[part * nh + p] = num;
      if (p % H == 0) {
        part_ml[(part * n_heads + h) * 2] = mx;
        part_ml[(part * n_heads + h) * 2 + 1] = den;
      }
    }
  }
}

// grid (S, N), H threads: the chunks of a slot with more than one, for
// one head, merged in chunk order; dynamic shared memory: the chunks'
// weights [max_chunks]
template <typename T, int H>
__global__ void __launch_bounds__(H)
paged_decode_merge(const int* __restrict__ ctx_lens,
                   const float* __restrict__ part_acc,
                   const float* __restrict__ part_ml, T* __restrict__ out,
                   int n_heads, int bs, int mb, int chunk, int max_chunks) {
  extern __shared__ float wt[];
  __shared__ float red_m[H / 32], red_l[H / 32];
  const int s = blockIdx.x, h = blockIdx.y, d = threadIdx.x;
  const int lane = d & 31, warp = d >> 5;
  const int last = min(ctx_lens[s], mb * bs - 1);
  const int nchunks = last / chunk + 1;
  const int nh = n_heads * H;
  // launched early (programmatic dependent launch): wait for the split
  // grid to finish, in every CTA, so that this grid ends after it
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (nchunks == 1) return;
  // chunk c's (m, l) of this head at ml[c * 2N], (m, l)
  const float* ml = part_ml + ((long long)s * max_chunks * n_heads + h) * 2;
  float mx = -INFINITY;
  for (int c = d; c < nchunks; c += H) mx = fmaxf(mx, ml[c * 2 * n_heads]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (lane == 0) red_m[warp] = mx;
  __syncthreads();
  mx = red_m[0];
#pragma unroll
  for (int w = 1; w < H / 32; ++w) mx = fmaxf(mx, red_m[w]);
  float den = 0.f;
  for (int c = d; c < nchunks; c += H) {
    const float mc = ml[c * 2 * n_heads];
    const float wc = mc == -INFINITY ? 0.f : exp2f(mc - mx);
    wt[c] = wc;
    den += wc * ml[c * 2 * n_heads + 1];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    den += __shfl_xor_sync(0xffffffffu, den, o);
  if (lane == 0) red_l[warp] = den;
  __syncthreads();
  den = red_l[0];
#pragma unroll
  for (int w = 1; w < H / 32; ++w) den += red_l[w];
  const float* acc = part_acc + (long long)s * max_chunks * nh + h * H + d;
  float num = 0.f;
#pragma unroll 8
  for (int c = 0; c < nchunks; ++c) num += wt[c] * acc[(long long)c * nh];
  out[(long long)s * nh + h * H + d] = from_f32<T>(num / den);
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* block_tables, const int* ctx_lens, void* out,
           float* part_acc, float* part_ml, int S, int n_heads,
           int head_dim, int bs, int mb, int chunk, float scale,
           cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int nh = n_heads * head_dim;
  const int slices = (nh + 32 * V - 1) / (32 * V);
  if (slices > kMaxWarps || chunk <= 0) return (int)cudaErrorInvalidValue;
  const int key_lanes = max(1, min(kKeyLanes, kMaxWarps / slices));
  const int max_chunks = (mb * bs + chunk - 1) / chunk;
  const int tab_len = (chunk + bs - 1) / bs + 1;
  const size_t smem =
      (tab_len + key_lanes * (2 * n_heads + nh)) * sizeof(float);
  const dim3 grid(S, max_chunks), block(32 * slices * key_lanes);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k_pages);
  const T* vp = static_cast<const T*>(v_pages);
  T* op = static_cast<T*>(out);
  switch (head_dim) {
    case 64:
      paged_decode_split<T, 64><<<grid, block, smem, stream>>>(
          qp, kp, vp, block_tables, ctx_lens, op, part_acc, part_ml,
          n_heads, bs, mb, chunk, key_lanes, scale);
      break;
    case 128:
      paged_decode_split<T, 128><<<grid, block, smem, stream>>>(
          qp, kp, vp, block_tables, ctx_lens, op, part_acc, part_ml,
          n_heads, bs, mb, chunk, key_lanes, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (max_chunks == 1) return 0;
  // the merge may launch while the split grid runs
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, n_heads);
  cfg.blockDim = dim3(head_dim);
  cfg.dynamicSmemBytes = max_chunks * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* pa = part_acc;
  const float* pm = part_ml;
  if (head_dim == 64)
    return (int)cudaLaunchKernelEx(&cfg, paged_decode_merge<T, 64>, ctx_lens,
                                   pa, pm, op, n_heads, bs, mb, chunk,
                                   max_chunks);
  return (int)cudaLaunchKernelEx(&cfg, paged_decode_merge<T, 128>, ctx_lens,
                                 pa, pm, op, n_heads, bs, mb, chunk,
                                 max_chunks);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim 64 or 128; N*H within 16
// warps of 16-byte lanes (4096 bf16, 2048 f32 columns). `chunk` keys a
// CTA. part_acc is f32 scratch [S, ceil(mb*bs / chunk), N*H], part_ml
// f32 [S, ceil(mb*bs / chunk), N, 2]; the call fills what it reads.
// Returns a cudaError_t code.
extern "C" int paged_decode_launch(const void* q, const void* k_pages,
                                   const void* v_pages,
                                   const void* block_tables,
                                   const void* ctx_lens, void* out,
                                   void* part_acc, void* part_ml, int S,
                                   int n_heads, int head_dim, int bs, int mb,
                                   int chunk, int dtype, float scale,
                                   void* stream) {
  const int* tab = static_cast<const int*>(block_tables);
  const int* ctx = static_cast<const int*>(ctx_lens);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0) return 0;
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, tab, ctx, out, pa, pm, S,
                         n_heads, head_dim, bs, mb, chunk, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, tab, ctx, out, pa, pm,
                                 S, n_heads, head_dim, bs, mb, chunk, scale,
                                 st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
