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
// add_ln (the saving form, K6). What bounds it: memory. At the training
// shape (24576 rows of 768, an f32 stream plus a bf16 branch, f32 out)
// it moves ~264 MB (x, r, out, the f32 sum) and does ~8 flops per
// element. One warp per row (any row count; the TPU kernel's 256-row
// block is a block-spec limit). Each lane keeps its up to EPL elements
// of s in registers, so the row is read once: a warp-shuffle sum gives
// the mean, a second pass over the registers the variance (the same
// two-pass formula as the reference), a third writes the outputs. The
// loads are issued all at once. EPL is the smallest of 8, 32, 64 and 128
// that holds the row: at GPT-3 1.3B's d 2048 the 128-value instance
// spilled its s[] to local memory and ran at 0.243 ms on [16384, 2048]
// bf16 against F.layer_norm(x + r)'s 0.137; a lane's elements beyond d
// add exact zeros, so every instance sums in the same order and gives
// the same bits.
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;    // 8 warps, one row each

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

template <typename TX, typename TR, typename TW, int EPL>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
add_ln(const TX* __restrict__ x, const TR* __restrict__ r,
       const TW* __restrict__ w, const TW* __restrict__ b,
       TX* __restrict__ out, float* __restrict__ sum_out,
       float* __restrict__ rstd_out, int rows, int d, float eps) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;              // whole warps leave together
  const long long base = (long long)row * d;
  // loads are unconditional (clamped into the row) so the compiler can
  // issue them all before the first use; a load under a per-element
  // branch waits out one memory latency per element
  float s[EPL];
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    const int j = i * 32 + lane;
    const int jc = min(j, d - 1);
    const float v = f32(x[base + jc]) + f32(r[base + jc]);
    s[i] = j < d ? v : 0.f;
    acc += s[i];
  }
  const float mean = warp_sum(acc) / d;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    const int j = i * 32 + lane;
    const float dl = j < d ? s[i] - mean : 0.f;
    sq += dl * dl;
  }
  const float rstd = rsqrtf(warp_sum(sq) / d + eps);
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    const int j = i * 32 + lane;
    const int jc = min(j, d - 1);
    const float y = (s[i] - mean) * rstd * f32(w[jc]) + f32(b[jc]);
    if (j < d) {
      out[base + j] = cvt<TX>(y);
      if (sum_out) sum_out[base + j] = s[i];
    }
  }
  if (rstd_out && lane == 0) rstd_out[row] = rstd;
}

template <typename TX, typename TR, typename TW>
int launch(const void* x, const void* r, const void* w, const void* b,
           void* out, float* sum_out, float* rstd_out, int rows, int d,
           float eps, cudaStream_t st) {
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const dim3 block(32 * kRowsPerBlock);
  const TX* xp = static_cast<const TX*>(x);
  const TR* rp = static_cast<const TR*>(r);
  const TW* wp = static_cast<const TW*>(w);
  const TW* bp = static_cast<const TW*>(b);
  TX* op = static_cast<TX*>(out);
  if (d <= 8 * 32)
    add_ln<TX, TR, TW, 8><<<grid, block, 0, st>>>(
        xp, rp, wp, bp, op, sum_out, rstd_out, rows, d, eps);
  else if (d <= 32 * 32)
    add_ln<TX, TR, TW, 32><<<grid, block, 0, st>>>(
        xp, rp, wp, bp, op, sum_out, rstd_out, rows, d, eps);
  else if (d <= 64 * 32)
    add_ln<TX, TR, TW, 64><<<grid, block, 0, st>>>(
        xp, rp, wp, bp, op, sum_out, rstd_out, rows, d, eps);
  else if (d <= 128 * 32)
    add_ln<TX, TR, TW, 128><<<grid, block, 0, st>>>(
        xp, rp, wp, bp, op, sum_out, rstd_out, rows, d, eps);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

template <typename TX, typename TR>
int launch_w(int w_dtype, const void* x, const void* r, const void* w,
             const void* b, void* out, float* sum_out, float* rstd_out,
             int rows, int d, float eps, cudaStream_t st) {
  if (w_dtype == 0)
    return launch<TX, TR, float>(x, r, w, b, out, sum_out, rstd_out, rows,
                                 d, eps, st);
  if (w_dtype == 1)
    return launch<TX, TR, __nv_bfloat16>(x, r, w, b, out, sum_out, rstd_out,
                                         rows, d, eps, st);
  return (int)cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------
// add_ln_pair: the inference form (K7)
// ---------------------------------------------------------------------

constexpr int kPairMaxWarps = 8;
constexpr int kStageFloats = 48 * 1024 / sizeof(float);

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
  // The moments are summed in the order of a one-element-a-lane layout
  // (lane l adds elements l, l + 32, l + 64, ... in turn, then the
  // butterfly), the order of the kernel this one replaced, so out is
  // the same bits whatever V is. The row passes once through this
  // warp's d floats of shared memory to get there.
  extern __shared__ float4 stage[];
  float* srow = reinterpret_cast<float*>(stage) + (threadIdx.x >> 5) * d;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int c = i * 32 + lane;
    if (c >= nchunk) continue;
    if constexpr (V % 4 == 0) {
#pragma unroll
      for (int q = 0; q < V / 4; ++q)
        reinterpret_cast<float4*>(srow + c * V)[q] = make_float4(
            s[i][4 * q], s[i][4 * q + 1], s[i][4 * q + 2], s[i][4 * q + 3]);
    } else {
      srow[c] = s[i][0];                // V = 1
    }
  }
  __syncwarp();
  float acc = 0.f;
#pragma unroll 8
  for (int j = lane; j < d; j += 32) acc += srow[j];
  const float mean = warp_sum(acc) / d;
  float sq = 0.f;
#pragma unroll 8
  for (int j = lane; j < d; j += 32) {
    const float dl = srow[j] - mean;
    sq += dl * dl;
  }
  const float rstd = rsqrtf(warp_sum(sq) / d + eps);
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

struct PairArgs {
  const void *x, *r, *w, *b;
  void *y, *h;
  int rows, d;
  float eps;
};

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
// chunks a lane (d <= 4096 in bf16, 2048 in f32), V = 1 up to 128
template <typename TX, typename TR, typename TW>
int pair_dispatch(const PairArgs& a, int warps, bool pdl, cudaStream_t st) {
  constexpr int V = 16 / sizeof(TX);
  const uintptr_t ptrs = (uintptr_t)a.x | (uintptr_t)a.r | (uintptr_t)a.w |
                         (uintptr_t)a.b | (uintptr_t)a.y | (uintptr_t)a.h;
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

// dtypes: 0 = float32, 1 = bfloat16, for x (and out), r, and w/b. d at
// most 4096. sum_out (f32 [rows, d]) and rstd_out (f32 [rows]) may both
// be null. Launches on `stream`; returns a cudaError_t.
extern "C" int add_layer_norm_launch(const void* x, const void* r,
                                     const void* w, const void* b, void* out,
                                     void* sum_out, void* rstd_out, int rows,
                                     int d, int x_dtype, int r_dtype,
                                     int w_dtype, float eps, void* stream) {
  if (rows <= 0) return 0;
  float* so = static_cast<float*>(sum_out);
  float* ro = static_cast<float*>(rstd_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && r_dtype == 0)
    return launch_w<float, float>(w_dtype, x, r, w, b, out, so, ro, rows, d,
                                  eps, st);
  if (x_dtype == 0 && r_dtype == 1)
    return launch_w<float, __nv_bfloat16>(w_dtype, x, r, w, b, out, so, ro,
                                          rows, d, eps, st);
  if (x_dtype == 1 && r_dtype == 0)
    return launch_w<__nv_bfloat16, float>(w_dtype, x, r, w, b, out, so, ro,
                                          rows, d, eps, st);
  if (x_dtype == 1 && r_dtype == 1)
    return launch_w<__nv_bfloat16, __nv_bfloat16>(w_dtype, x, r, w, b, out,
                                                  so, ro, rows, d, eps, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* add_layer_norm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The inference form (K7): y = LayerNorm(x + r) * w + b and, when h is
// not null, the carry h = x + r, both in x's dtype. dtypes as above; d
// at most 4096; `warps` rows a CTA (1..8); `pdl` non-zero launches with
// programmatic stream serialization. Returns a cudaError_t.
extern "C" int add_layer_norm_pair_launch(const void* x, const void* r,
                                          const void* w, const void* b,
                                          void* y, void* h, int rows, int d,
                                          int x_dtype, int r_dtype,
                                          int w_dtype, float eps, int warps,
                                          int pdl, void* stream) {
  if (rows <= 0) return 0;
  if (d <= 0 || d > 128 * 32 || warps < 1 || warps > kPairMaxWarps ||
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
