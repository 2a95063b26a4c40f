// add_layer_norm — residual add + LayerNorm in one pass over each row.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas_layernorm.py::_fwd
// (registry "layernorm_fwd_saved": also saves the f32 sum and rstd for
// the backward; kernel `add_ln`) and ::fused_add_layer_norm
// ("layernorm_fused", the inference form; kernel `add_ln_pair`).
//
//   s = f32(x) + f32(r);  mean, var = moments of s in f32;
//   rstd = rsqrt(var + eps);  out = ((s - mean) * rstd * w + b) -> x dtype
//
// x and r are [rows, d], contiguous, each f32 or bf16 (the training
// step adds a bf16 attention output to the f32 residual stream); w and
// b are [d], f32 or bf16.
//
// add_ln (the saving form, K6). It writes out, the f32 sum s and the f32
// rstd the backward needs, and, when its pointer is not null, the
// residual carry s -> x dtype (the JAX pair's second output,
// _pair_vjp_fwd's `s.astype(x.dtype)`), so a bf16 residual stream needs
// no separate cast launch. What bounds it: memory, ~8 flops an element
// against 14-20 bytes. At GPT-3 1.3B's full step (32768 rows of 2048, x,
// r and w in bf16) it moves 805 MB: x and r in, out, the carry and the
// f32 sum out. What held the kernel before this design back was not
// bytes but instructions: a warp a row, an element a lane at a time, 256
// memory instructions a lane at d 2048, and 64 values of s a lane in
// registers (128 spilled at d > 2048). So:
// - one row a CTA of up to 16 warps, P = 2 chunks of V = 16 / sizeof(x)
//   elements a thread (128 threads at d 2048 in bf16, 96 at d 768 in
//   f32): every access is 16 bytes a lane (r, w and b the same V
//   elements, 8, 16 or 32 bytes), the f32 sum is written as float4;
//   all of a row's loads are issued at once, 8-16 KB a row in flight;
// - a thread holds 2 V values of s and loads w and b (the same 4-16 KB
//   for every row, so L1 and L2 hits) only once the moments are known:
//   34-54 registers, no spill up to d 4096 (loaded with x and r, they
//   took 64 and one instance spilled);
// - the moments are summed in the order of the kernel this one replaced
//   (lane l adds elements l, l + 32, ... in turn, then the butterfly):
//   each thread stages its s in the row's d floats of shared memory,
//   warp 0 sums them in that order and passes mean and rstd through
//   shared memory, so out, sum and rstd are the same bits as before;
// - the sum and the carry are stored before the moments are known, so
//   those stores drain while warp 0 sums;
// - widths or pointers that do not align take the same kernel with
//   V = 1 and P = 8.
// On an H100 it moves its bytes at ~95 % of the rate of a device copy of
// as many bytes; neither moments summed without staging nor a persistent
// grid that loads the next row early was faster (PERF.md).
//
// add_ln_pair (the inference form, K7). It also writes the residual
// carry h = s -> x dtype when its pointer is not null: the JAX pair
// fused_add_layer_norm_pair returns (out, s.astype(x.dtype)) from one
// kernel, and every transformer block's residual site needs both. What
// bounds it at the rows the serving and decode paths give it (8-128
// rows of 768: 25-400 KB) is not bytes but the launch, ~5 us against
// well under 1 us of traffic. So the design spends its effort there:
// - one launch for the site: h is written from the registers that hold
//   s, so the separate add (a second launch) goes away;
// - one warp per row and few warps per CTA (the wrapper picks the
//   count), so 8-16 rows land on 8-16 SMs, not on one or two;
// - 16-byte accesses: a lane loads V = 16 / sizeof(x) consecutive
//   elements of x (r, w and b the same V elements, 8, 16 or 32 bytes),
//   all of a row's loads issued before the first shuffle, and stores y
//   and h 16 bytes at a time; widths or pointers that do not align take
//   the same kernel with V = 1 (a lane an element at a time). The
//   moments are still summed in add_ln's order (lane l over elements l,
//   l + 32, ...), read back from the row staged in shared memory, so
//   the output is the same bits as from the kernel K7 ran on before;
// - a programmatic dependent launch (cudaLaunchKernelEx with
//   programmatic stream serialization): the CTAs start while the kernel
//   before them drains, load w and b (weights, which no kernel before
//   this one writes), then `griddepcontrol.wait` before reading x and r
//   and writing anything, and `griddepcontrol.launch_dependents` once
//   the row is in registers.
// Rows wider than 4096 (GPT-3 13B's 5120) take add_ln_pair_wide: the
// register-resident layout would hold 160-320 values of s a lane there,
// which spills. It gives a row a CTA of up to 16 warps instead and keeps
// s only in the row staged in shared memory (d floats, 20 KB at 5120):
// the first pass adds x and r into the staged row and writes the carry,
// warp 0 sums the moments from it in row_moments' order (so out is the
// bits of the narrower instances' order), and the second pass reads s
// back from it for out. Every thread waits on the kernel before it
// (programmatic dependent launch) before it reads or writes anything.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float f32(float x) { return x; }
__device__ __forceinline__ float f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T cvt(float x);
template <> __device__ __forceinline__ float cvt<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16
cvt<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// V consecutive elements of T, moved with one (or, at 32 bytes, two)
// vector accesses of raw words
template <typename T, int V>
struct alignas(V * sizeof(T) < 16 ? V * sizeof(T) : 16) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_pack(const T* p) {
  constexpr int kBytes = V * sizeof(T);
  Pack<T, V> o;
  if constexpr (kBytes == 32) {
    reinterpret_cast<uint4*>(&o)[0] = reinterpret_cast<const uint4*>(p)[0];
    reinterpret_cast<uint4*>(&o)[1] = reinterpret_cast<const uint4*>(p)[1];
  } else if constexpr (kBytes == 16) {
    *reinterpret_cast<uint4*>(&o) = *reinterpret_cast<const uint4*>(p);
  } else if constexpr (kBytes == 8) {
    *reinterpret_cast<uint2*>(&o) = *reinterpret_cast<const uint2*>(p);
  } else {
    o.v[0] = *p;                        // V = 1
  }
  return o;
}

template <typename T, int V>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, V>& o) {
  constexpr int kBytes = V * sizeof(T);
  if constexpr (kBytes == 16)
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(&o);
  else
    *p = o.v[0];                        // V = 1 (x's V is 16 bytes)
}

// V f32 values to p (shared or global memory): float4 stores, or one
// store at V = 1
template <int V>
__device__ __forceinline__ void store_f32(float* p, const float (&s)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q)
      reinterpret_cast<float4*>(p)[q] = make_float4(
          s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
  } else {
    *p = s[0];                          // V = 1
  }
}

// mean and rstd of the row of d f32 values staged at srow, called by a
// whole warp: lane l adds elements l, l + 32, l + 64, ... in turn, then
// the butterfly, in the order of the one-element-a-lane kernel the
// layouts of add_ln and add_ln_pair replaced, so both give its bits
// whatever their layout; every lane gets the same values
__device__ __forceinline__ void row_moments(const float* srow, int d,
                                            int lane, float eps,
                                            float& mean, float& rstd) {
  float acc = 0.f;
#pragma unroll 8
  for (int j = lane; j < d; j += 32) acc += srow[j];
  mean = warp_sum(acc) / d;
  float sq = 0.f;
#pragma unroll 8
  for (int j = lane; j < d; j += 32) {
    const float dl = srow[j] - mean;
    sq += dl * dl;
  }
  rstd = rsqrtf(warp_sum(sq) / d + eps);
}

// ---------------------------------------------------------------------
// add_ln: the saving form (K6)
// ---------------------------------------------------------------------

constexpr int kSavedMaxWarps = 16;

// One row a CTA of blockDim.x threads; thread t holds chunks c = i *
// blockDim.x + t (i < P) of V elements each, so a warp's access i is 32
// * V consecutive elements. The CTA takes d floats of dynamic shared
// memory for the staged row.
template <typename TX, typename TR, typename TW, int P, int V>
__global__ void __launch_bounds__(32 * kSavedMaxWarps)
add_ln(const TX* __restrict__ x, const TR* __restrict__ r,
       const TW* __restrict__ w, const TW* __restrict__ b,
       TX* __restrict__ out, float* __restrict__ sum_out,
       float* __restrict__ rstd_out, TX* __restrict__ carry, int d,
       float eps) {
  const int t = threadIdx.x, nt = blockDim.x;
  const int nchunk = d / V;
  const long long base = (long long)blockIdx.x * d;
  // loads are unconditional (clamped into the row) so that all are in
  // flight at once; a load under a per-chunk branch waits out one
  // latency each
  Pack<TX, V> xp[P];
  Pack<TR, V> rp[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int cc = min(i * nt + t, nchunk - 1);
    xp[i] = load_pack<TX, V>(x + base + cc * V);
    rp[i] = load_pack<TR, V>(r + base + cc * V);
  }
  extern __shared__ float4 stage[];
  float* srow = reinterpret_cast<float*>(stage);
  __shared__ float stat[2];
  float s[P][V];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int c = i * nt + t;
#pragma unroll
    for (int k = 0; k < V; ++k) s[i][k] = f32(xp[i].v[k]) + f32(rp[i].v[k]);
    if (c >= nchunk) continue;
    store_f32<V>(srow + c * V, s[i]);
    if (sum_out) store_f32<V>(sum_out + base + c * V, s[i]);
    if (carry) {
      Pack<TX, V> ho;
#pragma unroll
      for (int k = 0; k < V; ++k) ho.v[k] = cvt<TX>(s[i][k]);
      store_pack<TX, V>(carry + base + c * V, ho);
    }
  }
  __syncthreads();
  if (t < 32) {
    float mean, rstd;
    row_moments(srow, d, t, eps, mean, rstd);
    if (t == 0) {
      stat[0] = mean;
      stat[1] = rstd;
      if (rstd_out) rstd_out[blockIdx.x] = rstd;
    }
  }
  __syncthreads();
  const float mean = stat[0], rstd = stat[1];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int c = i * nt + t;
    if (c >= nchunk) continue;
    const Pack<TW, V> wi = load_pack<TW, V>(w + c * V);
    const Pack<TW, V> bi = load_pack<TW, V>(b + c * V);
    Pack<TX, V> yo;
#pragma unroll
    for (int k = 0; k < V; ++k)
      yo.v[k] = cvt<TX>((s[i][k] - mean) * rstd * f32(wi.v[k])
                        + f32(bi.v[k]));
    store_pack<TX, V>(out + base + c * V, yo);
  }
}

struct SavedArgs {
  const void *x, *r, *w, *b;
  void* out;
  float *sum, *rstd;
  void* carry;
  int rows, d;
  float eps;
};

template <typename TX, typename TR, typename TW, int P, int V>
int saved_go(const SavedArgs& a, cudaStream_t st) {
  // the fewest warps whose P chunks a thread cover the row
  const int warps = (a.d / V + 32 * P - 1) / (32 * P);
  add_ln<TX, TR, TW, P, V><<<a.rows, 32 * warps, sizeof(float) * a.d, st>>>(
      static_cast<const TX*>(a.x), static_cast<const TR*>(a.r),
      static_cast<const TW*>(a.w), static_cast<const TW*>(a.b),
      static_cast<TX*>(a.out), a.sum, a.rstd, static_cast<TX*>(a.carry), a.d,
      a.eps);
  return (int)cudaGetLastError();
}

// 16-byte chunks, two a thread: d <= 4096 is at most 1024 chunks (f32),
// 16 warps; V = 1 (d % V or a pointer off 16 bytes) takes 8 a thread
template <typename TX, typename TR, typename TW>
int saved_dispatch(const SavedArgs& a, cudaStream_t st) {
  constexpr int V = 16 / sizeof(TX);
  const uintptr_t ptrs = (uintptr_t)a.x | (uintptr_t)a.r | (uintptr_t)a.w |
                         (uintptr_t)a.b | (uintptr_t)a.out |
                         (uintptr_t)a.sum | (uintptr_t)a.carry;
  if (a.d % V == 0 && ptrs % 16 == 0)
    return saved_go<TX, TR, TW, 2, V>(a, st);
  return saved_go<TX, TR, TW, 8, 1>(a, st);
}

template <typename TX, typename TR>
int saved_w(int w_dtype, const SavedArgs& a, cudaStream_t st) {
  if (w_dtype == 0) return saved_dispatch<TX, TR, float>(a, st);
  return saved_dispatch<TX, TR, __nv_bfloat16>(a, st);
}


// ---------------------------------------------------------------------
// add_ln_pair: the inference form (K7)
// ---------------------------------------------------------------------

constexpr int kPairMaxWarps = 8;
constexpr int kStageFloats = 48 * 1024 / sizeof(float);

// C chunks of V elements a lane; chunk c = i * 32 + lane covers elements
// c * V .. c * V + V - 1, so a warp's access i is 32 * V consecutive
// elements. V = 1 is the path for unaligned widths or pointers.
template <typename TX, typename TR, typename TW, int C, int V>
__global__ void __launch_bounds__(32 * kPairMaxWarps)
add_ln_pair(const TX* __restrict__ x, const TR* __restrict__ r,
            const TW* __restrict__ w, const TW* __restrict__ b,
            TX* __restrict__ y, TX* __restrict__ h, int rows, int d,
            float eps) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int nchunk = d / V;
  // weights first, where they fit in registers beside the row (up to 128
  // bytes of w a lane): no kernel before this one writes them. Loads are
  // unconditional (clamped into the row) so that all are in flight at
  // once; a load under a per-chunk branch waits out one latency each
  constexpr bool kEarlyWeights = C * V * sizeof(TW) <= 128;
  Pack<TW, V> wp[kEarlyWeights ? C : 1], bp[kEarlyWeights ? C : 1];
  if constexpr (kEarlyWeights) {
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int cc = min(i * 32 + lane, nchunk - 1);
      wp[i] = load_pack<TW, V>(w + cc * V);
      bp[i] = load_pack<TW, V>(b + cc * V);
    }
  }
  // every thread waits, so no CTA (and so not this grid) can finish
  // before the kernel it was launched behind: the next kernel in the
  // stream waits for this grid alone
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (row >= rows) return;              // whole warps leave together
  const long long base = (long long)row * d;
  Pack<TX, V> xp[C];
  Pack<TR, V> rp[C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int cc = min(i * 32 + lane, nchunk - 1);
    xp[i] = load_pack<TX, V>(x + base + cc * V);
    rp[i] = load_pack<TR, V>(r + base + cc * V);
  }
  float s[C][V];
#pragma unroll
  for (int i = 0; i < C; ++i)
#pragma unroll
    for (int k = 0; k < V; ++k) s[i][k] = f32(xp[i].v[k]) + f32(rp[i].v[k]);
  // the row is in registers: the next kernel may start its launch
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // The row passes once through this warp's d floats of shared memory,
  // so that row_moments sums it in its order: out is the same bits
  // whatever V is.
  extern __shared__ float4 stage[];
  float* srow = reinterpret_cast<float*>(stage) + (threadIdx.x >> 5) * d;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int c = i * 32 + lane;
    if (c < nchunk) store_f32<V>(srow + c * V, s[i]);
  }
  __syncwarp();
  float mean, rstd;
  row_moments(srow, d, lane, eps, mean, rstd);
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int c = i * 32 + lane;
    if (c >= nchunk) continue;
    Pack<TW, V> wi, bi;
    if constexpr (kEarlyWeights) {
      wi = wp[i];
      bi = bp[i];
    } else {
      wi = load_pack<TW, V>(w + c * V);
      bi = load_pack<TW, V>(b + c * V);
    }
    Pack<TX, V> yo, ho;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      yo.v[k] = cvt<TX>((s[i][k] - mean) * rstd * f32(wi.v[k])
                        + f32(bi.v[k]));
      ho.v[k] = cvt<TX>(s[i][k]);
    }
    store_pack<TX, V>(y + base + c * V, yo);
    if (h) store_pack<TX, V>(h + base + c * V, ho);
  }
}

// V f32 values from p (shared memory): float4 loads, or one at V = 1
template <int V>
__device__ __forceinline__ void load_f32(const float* p, float (&s)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(p)[q];
      s[4 * q] = v.x;
      s[4 * q + 1] = v.y;
      s[4 * q + 2] = v.z;
      s[4 * q + 3] = v.w;
    }
  } else {
    s[0] = *p;                          // V = 1
  }
}

constexpr int kPairRegMaxD = 4096;      // the register-resident instances
constexpr int kPairMaxD = 5120;         // add_ln_pair_wide up to here
constexpr int kWideMaxWarps = 16;

// A row a CTA of blockDim.x threads; thread t takes chunks t, t +
// blockDim.x, ... of V elements. s lives only in the row staged in d
// floats of dynamic shared memory.
template <typename TX, typename TR, typename TW, int V>
__global__ void __launch_bounds__(32 * kWideMaxWarps)
add_ln_pair_wide(const TX* __restrict__ x, const TR* __restrict__ r,
                 const TW* __restrict__ w, const TW* __restrict__ b,
                 TX* __restrict__ y, TX* __restrict__ h, int d, float eps) {
  const int t = threadIdx.x, nt = blockDim.x;
  const int nchunk = d / V;
  const long long base = (long long)blockIdx.x * d;
  extern __shared__ float4 stage[];
  float* srow = reinterpret_cast<float*>(stage);
  __shared__ float stat[2];
  // every thread waits before it touches x or r, and none exits first
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
#pragma unroll 2
  for (int c = t; c < nchunk; c += nt) {
    const Pack<TX, V> xp = load_pack<TX, V>(x + base + c * V);
    const Pack<TR, V> rp = load_pack<TR, V>(r + base + c * V);
    float s[V];
    Pack<TX, V> ho;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      s[k] = f32(xp.v[k]) + f32(rp.v[k]);
      ho.v[k] = cvt<TX>(s[k]);
    }
    store_f32<V>(srow + c * V, s);
    if (h) store_pack<TX, V>(h + base + c * V, ho);
  }
  // the row is read: the next kernel may start its launch
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __syncthreads();
  if (t < 32) {
    float mean, rstd;
    row_moments(srow, d, t, eps, mean, rstd);
    if (t == 0) {
      stat[0] = mean;
      stat[1] = rstd;
    }
  }
  __syncthreads();
  const float mean = stat[0], rstd = stat[1];
#pragma unroll 2
  for (int c = t; c < nchunk; c += nt) {
    float s[V];
    load_f32<V>(srow + c * V, s);
    const Pack<TW, V> wi = load_pack<TW, V>(w + c * V);
    const Pack<TW, V> bi = load_pack<TW, V>(b + c * V);
    Pack<TX, V> yo;
#pragma unroll
    for (int k = 0; k < V; ++k)
      yo.v[k] = cvt<TX>((s[k] - mean) * rstd * f32(wi.v[k]) + f32(bi.v[k]));
    store_pack<TX, V>(y + base + c * V, yo);
  }
}

struct PairArgs {
  const void *x, *r, *w, *b;
  void *y, *h;
  int rows, d;
  float eps;
};

template <typename TX, typename TR, typename TW, int V>
int wide_go(const PairArgs& a, bool pdl, cudaStream_t st) {
  // the fewest warps that leave a thread at most two chunks, up to 16
  const int warps = min(kWideMaxWarps, (a.d / V + 63) / 64);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.rows);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = sizeof(float) * a.d;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  return (int)cudaLaunchKernelEx(
      &cfg, add_ln_pair_wide<TX, TR, TW, V>, static_cast<const TX*>(a.x),
      static_cast<const TR*>(a.r), static_cast<const TW*>(a.w),
      static_cast<const TW*>(a.b), static_cast<TX*>(a.y),
      static_cast<TX*>(a.h), a.d, a.eps);
}

template <typename TX, typename TR, typename TW, int C, int V>
int pair_go(const PairArgs& a, int warps, bool pdl, cudaStream_t st) {
  // each warp stages its row as f32 in shared memory: as many warps a
  // CTA as fit the 48 KB a launch gets unasked (3 at d 4096)
  warps = min(warps, kStageFloats / a.d);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.rows + warps - 1) / warps);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = sizeof(float) * warps * a.d;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  return (int)cudaLaunchKernelEx(
      &cfg, add_ln_pair<TX, TR, TW, C, V>, static_cast<const TX*>(a.x),
      static_cast<const TR*>(a.r), static_cast<const TW*>(a.w),
      static_cast<const TW*>(a.b), static_cast<TX*>(a.y),
      static_cast<TX*>(a.h), a.rows, a.d, a.eps);
}

// the fewest chunks a lane that cover the row: vector widths up to 16
// chunks a lane (d <= 4096 in bf16, 2048 in f32), V = 1 up to 128;
// rows wider than 4096 take the staged form, 16-byte chunks or V = 1
template <typename TX, typename TR, typename TW>
int pair_dispatch(const PairArgs& a, int warps, bool pdl, cudaStream_t st) {
  constexpr int V = 16 / sizeof(TX);
  const uintptr_t ptrs = (uintptr_t)a.x | (uintptr_t)a.r | (uintptr_t)a.w |
                         (uintptr_t)a.b | (uintptr_t)a.y | (uintptr_t)a.h;
  if (a.d > kPairRegMaxD) {
    if (a.d % V == 0 && ptrs % 16 == 0)
      return wide_go<TX, TR, TW, V>(a, pdl, st);
    return wide_go<TX, TR, TW, 1>(a, pdl, st);
  }
  const int per_lane = (a.d / V + 31) / 32;
  if (a.d % V == 0 && ptrs % 16 == 0 && per_lane <= 16) {
    if (per_lane <= 1) return pair_go<TX, TR, TW, 1, V>(a, warps, pdl, st);
    if (per_lane <= 2) return pair_go<TX, TR, TW, 2, V>(a, warps, pdl, st);
    if (per_lane <= 3) return pair_go<TX, TR, TW, 3, V>(a, warps, pdl, st);
    if (per_lane <= 4) return pair_go<TX, TR, TW, 4, V>(a, warps, pdl, st);
    if (per_lane <= 8) return pair_go<TX, TR, TW, 8, V>(a, warps, pdl, st);
    return pair_go<TX, TR, TW, 16, V>(a, warps, pdl, st);
  }
  if (a.d <= 8 * 32) return pair_go<TX, TR, TW, 8, 1>(a, warps, pdl, st);
  if (a.d <= 32 * 32) return pair_go<TX, TR, TW, 32, 1>(a, warps, pdl, st);
  return pair_go<TX, TR, TW, 128, 1>(a, warps, pdl, st);
}

template <typename TX, typename TR>
int pair_w(int w_dtype, const PairArgs& a, int warps, bool pdl,
           cudaStream_t st) {
  if (w_dtype == 0) return pair_dispatch<TX, TR, float>(a, warps, pdl, st);
  return pair_dispatch<TX, TR, __nv_bfloat16>(a, warps, pdl, st);
}

}  // namespace

// The saving form (K6). dtypes: 0 = float32, 1 = bfloat16, for x (and
// out and carry_out), r, and w/b. d at most 4096. sum_out (f32 [rows,
// d]), rstd_out (f32 [rows]) and carry_out (x's dtype, [rows, d]) may
// each be null. Launches on `stream`; returns a cudaError_t.
extern "C" int add_layer_norm_launch(const void* x, const void* r,
                                     const void* w, const void* b, void* out,
                                     void* sum_out, void* rstd_out,
                                     void* carry_out, int rows, int d,
                                     int x_dtype, int r_dtype, int w_dtype,
                                     float eps, void* stream) {
  if (rows <= 0) return 0;
  if (d <= 0 || d > 4096 || x_dtype < 0 || x_dtype > 1 || r_dtype < 0 ||
      r_dtype > 1 || w_dtype < 0 || w_dtype > 1)
    return (int)cudaErrorInvalidValue;
  const SavedArgs a{x, r, w, b, out, static_cast<float*>(sum_out),
                    static_cast<float*>(rstd_out), carry_out, rows, d, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && r_dtype == 0)
    return saved_w<float, float>(w_dtype, a, st);
  if (x_dtype == 0)
    return saved_w<float, __nv_bfloat16>(w_dtype, a, st);
  if (r_dtype == 0)
    return saved_w<__nv_bfloat16, float>(w_dtype, a, st);
  return saved_w<__nv_bfloat16, __nv_bfloat16>(w_dtype, a, st);
}

extern "C" const char* add_layer_norm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The inference form (K7): y = LayerNorm(x + r) * w + b and, when h is
// not null, the carry h = x + r, both in x's dtype. dtypes as above; d
// at most 5120 (above 4096 a row a CTA); `warps` rows a CTA (1..8) up to
// 4096; `pdl` non-zero launches with programmatic stream serialization.
// Returns a cudaError_t.
extern "C" int add_layer_norm_pair_launch(const void* x, const void* r,
                                          const void* w, const void* b,
                                          void* y, void* h, int rows, int d,
                                          int x_dtype, int r_dtype,
                                          int w_dtype, float eps, int warps,
                                          int pdl, void* stream) {
  if (rows <= 0) return 0;
  if (d <= 0 || d > kPairMaxD || warps < 1 || warps > kPairMaxWarps ||
      x_dtype < 0 || x_dtype > 1 || r_dtype < 0 || r_dtype > 1 ||
      w_dtype < 0 || w_dtype > 1)
    return (int)cudaErrorInvalidValue;
  const PairArgs a{x, r, w, b, y, h, rows, d, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool p = pdl != 0;
  if (x_dtype == 0 && r_dtype == 0)
    return pair_w<float, float>(w_dtype, a, warps, p, st);
  if (x_dtype == 0)
    return pair_w<float, __nv_bfloat16>(w_dtype, a, warps, p, st);
  if (r_dtype == 0)
    return pair_w<__nv_bfloat16, float>(w_dtype, a, warps, p, st);
  return pair_w<__nv_bfloat16, __nv_bfloat16>(w_dtype, a, warps, p, st);
}
