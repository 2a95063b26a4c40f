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
// V, 2·B·(off+1)·N·H·itemsize bytes in all (9.5 MB at GPT-3 125M, batch
// 8, off 191, f32 cache: 2.8 us at 3.35 TB/s), against ~4·H flops per
// key per head: far below the card's ops-per-byte balance. At that size
// what costs is the DRAM round trips and how many bytes each SM has in
// flight, not arithmetic.
//
// Design (decode_attention_split, flash-decoding in one launch):
// - The keys 0..off are split into C chunks (the wrapper's decode_split:
//   one chunk up to 128 keys, else C a power of two up to 8 with at most
//   32 keys a chunk). A CTA (8 warps) takes one chunk of one batch row
//   and a group of heads; the C CTAs of a (row, head group) form one
//   thread-block cluster: grid (C, N / heads, B), 192 CTAs at batch 8
//   and off >= 128 on GPT-3 125M.
// - With C > 1 a CTA takes 256 contiguous columns of each key row (4
//   heads of 64, 2 of 128: 1 KB of an f32 row), 8 a lane, so a warp's
//   loads of a key are one contiguous span; with C = 1 (short contexts)
//   it takes one head, as many CTAs as (row, head) pairs.
// - The position: an argument, or an int32 the kernel reads from device
//   memory (generate's captured token step, whose position advances on
//   the device). Then the kernel computes last = min(off, L - 1) and the
//   chunk, ceil((last + 1) / C), with decode_split's formula, so the
//   keys each CTA takes, and the bits, are those of the host launch; C
//   (the grid and cluster shape) stays the host's: one captured graph a
//   chunk count.
// - Warp w takes keys w, w + 8, ... of the chunk, 32 / E at a time (E
//   the columns a lane holds: 4 keys in the wide layout, 16 for one head
//   of 64), and issues all their K and V loads before computing on any:
//   every key of the step is in flight at once (up to 128 keys a CTA).
//   It computes on them 4 at a time, as far as the live keys go. Loads
//   go straight to registers, as raw words widened afterwards, so that
//   no load waits on another. Staging the rows in shared
//   memory first (a bulk copy a row, or 2-D TMA boxes, completed on
//   mbarriers; also per warp, and with cp.async) measured slower on the
//   H100 at every offset: each value is used once, so the shared-memory
//   round trip and the barrier waits only add latency.
// - Scores sum over a head's lanes by shuffles; each warp keeps an
//   online softmax per head in f32 in the exp2 domain. The running max
//   starts at -1e30 and keys past off are never loaded (their p is 0),
//   so keys past off weigh exactly 0 and no exp(-inf + inf) can form.
//   The warps merge in warp order through shared memory.
// - The chunks merge in f32 through distributed shared memory: each
//   rank writes its (m, l, acc) into rank 0's shared memory, one cluster
//   barrier, and rank 0 adds them in rank order (deterministic), weighed
//   by exp2(m_r - max_r m_r) (every chunk holds a key; one that did not
//   would keep m = -1e30 and weigh 0). One launch, no partials in global
//   memory, where paged_decode's split needs a merge kernel.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// W 32-bit words of a lane's columns: one load of 4, 8, 16 or 32 bytes
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[1]) {
  w[0] = *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[2]) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  w[0] = r.x;
  w[1] = r.y;
}
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[4]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  w[0] = r.x;
  w[1] = r.y;
  w[2] = r.z;
  w[3] = r.w;
}
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const uint4 s = *(reinterpret_cast<const uint4*>(p) + 1);
  w[0] = r.x;
  w[1] = r.y;
  w[2] = r.z;
  w[3] = r.w;
  w[4] = s.x;
  w[5] = s.y;
  w[6] = s.z;
  w[7] = s.w;
}

// words -> E f32 values: f32 as they are, bf16 by a shift (exact)
template <typename T> struct Widen;
template <> struct Widen<float> {
  template <int E>
  __device__ __forceinline__ static void f32(const uint32_t (&w)[E],
                                             float (&o)[E]) {
#pragma unroll
    for (int i = 0; i < E; ++i) o[i] = __uint_as_float(w[i]);
  }
};
template <> struct Widen<__nv_bfloat16> {
  template <int E>
  __device__ __forceinline__ static void f32(const uint32_t (&w)[E / 2],
                                             float (&o)[E]) {
#pragma unroll
    for (int i = 0; i < E / 2; ++i) {
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// grid (C, n_heads / HG, B), in clusters of (C, 1, 1) when C > 1. A lane
// holds E columns of the CTA's W = 32·E (HG = W / H heads).
template <typename TQ, typename TC, int H, int E>
__global__ void __launch_bounds__(kThreads)
decode_attention_split(const TQ* __restrict__ q, const TC* __restrict__ k_buf,
                       const TC* __restrict__ v_buf, float* __restrict__ out,
                       int L, int n_heads, int last_arg, int chunk_arg,
                       const int* __restrict__ off_dev, float sl2) {
  constexpr int W = 32 * E;             // columns a CTA
  constexpr int HG = W / H;             // heads a CTA
  constexpr int LH = 32 / HG;           // lanes a head
  constexpr int KG = 32 / E;            // keys a warp has in flight
  __shared__ float red_m[kWarps][HG], red_l[kWarps][HG];
  __shared__ float red_acc[kWarps][W];
  // rank 0's: every rank's partial (m, l) and acc, in rank order
  __shared__ float part_ml[kMaxCluster][HG][2];
  __shared__ float part_acc[kMaxCluster][W];

  const int rank = blockIdx.x, n_ranks = gridDim.x;
  // the last key and the keys a chunk: the host's, or from q's position
  // read in device memory, split with decode_split's formula (the chunk
  // count, and so the grid, stays the host's)
  int last = last_arg, chunk = chunk_arg;
  if (off_dev != nullptr) {
    last = min(*off_dev, L - 1);
    chunk = (last + n_ranks) / n_ranks;
  }
  const int b = blockIdx.z;
  const int k0 = rank * chunk;
  const int k1 = min(k0 + chunk, last + 1);      // keys [k0, k1)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long nh = (long long)n_heads * H;
  const long long col = (long long)blockIdx.y * W + lane * E;
  // the cluster's CTAs have all started before any writes to rank 0
  if (n_ranks > 1) cluster_arrive_relaxed();

  constexpr int QW = E * sizeof(TQ) / 4, CW = E * sizeof(TC) / 4;
  float qv[E];
  {
    uint32_t w[QW];
    load_words(q + (long long)b * nh + col, w);
    Widen<TQ>::template f32<E>(w, qv);
  }
  const TC* kb = k_buf + (long long)b * L * nh + col;
  const TC* vb = v_buf + (long long)b * L * nh + col;
  float m = kNeg, l = 0.f, acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  for (int j0 = k0 + warp; j0 < k1; j0 += kWarps * KG) {
    // keys j0 + 8u: every load first, as raw words; keys past the chunk
    // are not loaded
    uint32_t kw[KG][CW], vw[KG][CW];
#pragma unroll
    for (int u = 0; u < KG; ++u) {
#pragma unroll
      for (int i = 0; i < CW; ++i) kw[u][i] = vw[u][i] = 0u;
      if (j0 + u * kWarps < k1) {
        const long long row = (long long)(j0 + u * kWarps) * nh;
        load_words(kb + row, kw[u]);
        load_words(vb + row, vw[u]);
      }
    }
    // 4 keys at a time, as far as the live keys go (warp-uniform)
#pragma unroll
    for (int g = 0; g < KG; g += 4) {
      if (j0 + g * kWarps >= k1) break;
      float sc[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float kf[E];
        Widen<TC>::template f32<E>(kw[g + u], kf);
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) x += qv[e] * kf[e];
        sc[u] = x;
      }
#pragma unroll
      for (int o = LH / 2; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], o);
      // key j0 + 8g is live, so the group max is a real score
      float gmax = kNeg;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        sc[u] *= sl2;
        if (j0 + (g + u) * kWarps < k1) gmax = fmaxf(gmax, sc[u]);
      }
      const float m_new = fmaxf(m, gmax);
      const float alpha = exp2f(m - m_new);   // 0 on the first group
      l *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] *= alpha;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float p =
            j0 + (g + u) * kWarps < k1 ? exp2f(sc[u] - m_new) : 0.f;
        float vf[E];
        Widen<TC>::template f32<E>(vw[g + u], vf);
        l += p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] += p * vf[e];
      }
      m = m_new;
    }
  }

  // the warps merge in warp order: thread c owns column c (head c / H);
  // warp 0 holds the chunk's first key, so the max is a real score, and
  // a warp that saw no key (m = -1e30) weighs 0
  if (lane % LH == 0) {
    red_m[warp][lane / LH] = m;
    red_l[warp][lane / LH] = l;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) red_acc[warp][lane * E + e] = acc[e];
  __syncthreads();
  const int c = threadIdx.x, hc = c / H;
  float cm = kNeg, cl = 0.f, ca = 0.f;
  if (c < W) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) cm = fmaxf(cm, red_m[w][hc]);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float s = exp2f(red_m[w][hc] - cm);
      cl += red_l[w][hc] * s;
      ca += red_acc[w][c] * s;
    }
  }
  float* o = out + (long long)b * nh + (long long)blockIdx.y * W + c;
  if (n_ranks == 1) {
    if (c < W) *o = ca / cl;
    return;
  }
  // push this rank's partial into rank 0, then merge there in rank order
  cluster_wait();
  cg::cluster_group cluster = cg::this_cluster();
  if (c < W) {
    *cluster.map_shared_rank(&part_acc[rank][c], 0) = ca;
    if (c % H == 0) {
      *cluster.map_shared_rank(&part_ml[rank][hc][0], 0) = cm;
      *cluster.map_shared_rank(&part_ml[rank][hc][1], 0) = cl;
    }
  }
  cluster_arrive();
  cluster_wait();
  if (rank != 0 || c >= W) return;
  float mx = kNeg;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    if (r < n_ranks) mx = fmaxf(mx, part_ml[r][hc][0]);
  float num = 0.f, den = 0.f;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    if (r < n_ranks) {
      const float s = exp2f(part_ml[r][hc][0] - mx);
      num += s * part_acc[r][c];
      den += s * part_ml[r][hc][1];
    }
  *o = num / den;
}

template <typename TQ, typename TC, int H, int E>
int launch(const void* q, const void* k_buf, const void* v_buf, float* out,
           int B, int L, int n_heads, int last, int clusters, int chunk,
           const int* off_dev, float scale, cudaStream_t stream) {
  constexpr int HG = 32 * E / H;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters, n_heads / HG, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = clusters;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = clusters > 1 ? 1 : 0;
  return (int)cudaLaunchKernelEx(
      &cfg, decode_attention_split<TQ, TC, H, E>, static_cast<const TQ*>(q),
      static_cast<const TC*>(k_buf), static_cast<const TC*>(v_buf), out, L,
      n_heads, last, chunk, off_dev, scale * kLog2e);
}

// one head a CTA when there is one chunk, else 256 columns of a row
template <typename TQ, typename TC>
int launch_h(const void* q, const void* k_buf, const void* v_buf, float* out,
             int B, int L, int n_heads, int head_dim, int last, int clusters,
             int chunk, const int* off_dev, float scale,
             cudaStream_t stream) {
  const bool wide = clusters > 1 && n_heads % (256 / head_dim) == 0;
#define DECODE_LAUNCH(H, E)                                                 \
  return launch<TQ, TC, H, E>(q, k_buf, v_buf, out, B, L, n_heads, last,    \
                              clusters, chunk, off_dev, scale, stream)
  if (head_dim == 64) {
    if (wide) DECODE_LAUNCH(64, 8);
    DECODE_LAUNCH(64, 2);
  }
  if (head_dim == 128) {
    if (wide) DECODE_LAUNCH(128, 8);
    DECODE_LAUNCH(128, 4);
  }
#undef DECODE_LAUNCH
  return (int)cudaErrorInvalidValue;
}

template <typename TQ>
int launch_q(const void* q, const void* k_buf, const void* v_buf, float* out,
             int B, int L, int n_heads, int head_dim, int last, int clusters,
             int chunk, int cache_dtype, const int* off_dev, float scale,
             cudaStream_t stream) {
  if (cache_dtype == 0)
    return launch_h<TQ, float>(q, k_buf, v_buf, out, B, L, n_heads,
                               head_dim, last, clusters, chunk, off_dev,
                               scale, stream);
  if (cache_dtype == 1)
    return launch_h<TQ, __nv_bfloat16>(q, k_buf, v_buf, out, B, L, n_heads,
                                       head_dim, last, clusters, chunk,
                                       off_dev, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [B, 1, N*H], k_buf/v_buf [B, L, N*H] (16-byte aligned), out f32
// [B, 1, N*H]; keys 0..last are read (last = min(off, L - 1)), split
// into `clusters` chunks of `chunk` keys (clusters <= 8, every chunk
// holding a key). With `off_dev` not null, q's position is the int32 it
// points at in device memory: `last` and `chunk` are then computed in the
// kernel (chunk = ceil((last + 1) / clusters), decode_split's formula)
// and ignored here, and the caller, which knows the position on the
// host, has checked that every chunk holds a key. Dtype codes: 0 =
// float32, 1 = bfloat16, for q and for the cache; head_dim 64 or 128.
// Returns a cudaError_t code.
extern "C" int decode_attention_launch(const void* q, const void* k_buf,
                                       const void* v_buf, void* out, int B,
                                       int L, int n_heads, int head_dim,
                                       int last, int clusters, int chunk,
                                       int q_dtype, int cache_dtype,
                                       float scale, const void* off_dev,
                                       void* stream) {
  if (B <= 0 || n_heads <= 0) return 0;
  const int* od = static_cast<const int*>(off_dev);
  if (L < 1 || clusters < 1 || clusters > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  if (od == nullptr &&
      (last < 0 || last >= L || chunk < 1 ||
       (long long)(clusters - 1) * chunk > last ||
       (long long)clusters * chunk <= last))
    return (int)cudaErrorInvalidValue;
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return launch_q<float>(q, k_buf, v_buf, o, B, L, n_heads, head_dim, last,
                           clusters, chunk, cache_dtype, od, scale, st);
  if (q_dtype == 1)
    return launch_q<__nv_bfloat16>(q, k_buf, v_buf, o, B, L, n_heads,
                                   head_dim, last, clusters, chunk,
                                   cache_dtype, od, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
