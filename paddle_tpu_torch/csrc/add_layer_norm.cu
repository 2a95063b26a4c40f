// add_layer_norm — residual add + LayerNorm in one pass over each row.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas_layernorm.py::_fwd
// (registry "layernorm_fwd_saved": also saves the f32 sum and rstd for
// the backward) and ::fused_add_layer_norm ("layernorm_fused": the
// output only). One source serves both: the saved outputs are written
// when their pointers are not null.
//
//   s = f32(x) + f32(r);  mean, var = moments of s in f32;
//   rstd = rsqrt(var + eps);  out = ((s - mean) * rstd * w + b) -> x dtype
//
// x and r are [rows, d], contiguous, each f32 or bf16 (the training
// step adds a bf16 attention output to the f32 residual stream); w and
// b are [d], f32 or bf16.
//
// What bounds it: memory. At the training shape (24576 rows of 768, an
// f32 stream plus a bf16 branch, f32 out) the saving form moves ~264 MB
// (x, r, out, the f32 sum) and does ~8 flops per element.
//
// Design: one warp per row (any row count; the TPU kernel's 256-row
// block is a block-spec limit). Each lane keeps its up to EPL elements
// of s in registers, so the row is read once: a warp-shuffle sum gives
// the mean, a second pass over the registers the variance (the same
// two-pass formula as the reference), a third writes the outputs. The
// loads are issued all at once, which at a decode step's 16 rows (two
// CTAs) is what sets the time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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
