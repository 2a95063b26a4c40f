// moe_kernels — the MoE layer's dispatch gather and weighted combine.
//
// Replaces the TPU kernels paddle_tpu/moe/kernels.py::_gather_pallas
// (registry name "moe_gather") and ::_combine_pallas ("moe_combine").
//
// moe_gather:  out[i] = src[idx[i]] for idx[i] in [0, n_src), a zero row
//              where idx[i] == n_src (the router's "empty slot"); src
//              [n_src, d], idx int32 [m], out [m, d] in src's dtype.
// moe_combine: out[i] = sum_s w[i, s] * src[idx[i, s]], s = 0..k-1 in
//              order, in f32; a choice whose idx == n_src (dropped at
//              capacity) adds nothing; one rounding to src's dtype at the
//              end. src [n_src, d], idx int32 [n, k], w [n, k] (f32 or
//              bf16, read as f32), out [n, d].
// Any index outside [0, n_src) is the sentinel, as in the JAX kernels'
// `t < n_src` test and jnp.take(mode="fill").
//
// What bounds them: memory. Both move rows and do at most 2k flops per
// element. At the GPT-3 125M MoE training shape (n 8192 tokens, E·C =
// 20480 slots, d 768, f32) the gather reads each distinct kept token row
// once at best (~7,950 rows, 24.4 MB) and writes 62.9 MB; the combine
// reads at most n·k kept rows (50.3 MB) and writes 25.2 MB.
//
// moe_gather's design. The TPU kernel keeps all of src resident in VMEM,
// so each row crosses HBM once. Here src stays in device memory, and the
// router places slots expert by expert with the slot-0 choices before
// the slot-1 choices: a token kept twice is read twice, about an expert
// region apart, with up to 63 MB of output rows streaming through the
// 50 MB L2 in between. So the kernel:
// - Copies a row a warp over a grid of the rows; 16-byte vectors, every
//   load of the row in flight before its stores (768 f32 = 192 vectors,
//   6 a lane). Rows of 2 KB and more go one to a CTA, narrower rows
//   eight: at the f32 training rows one-warp CTAs ran ~3 % faster than
//   eight rows a CTA, at the bf16 rows ~4 % slower.
// - Reads src under an L2 evict_last policy (createpolicy, passed as the
//   loads' .L2::cache_hint), so a row chosen twice is more often still
//   in the L2 at its second read: ~1 % at both sites. out is written
//   plainly: evict_first on the stores ran slower at both sites. No
//   cudaAccessPolicyWindow and no persisting-L2 limit: those are state
//   of the whole process or stream, and would act inside the serve
//   loop's captured graphs too.
// - The lines read under evict_last stay marked after the kernel, and
//   on the H100 they outlive a 256 MB read: a gather of the same rows
//   without the hint then runs ~13 % faster, until
//   cudaCtxResetPersistingL2Cache (moe_gather_reset_l2 below). The
//   kernel does not reset them (applypriority ... L2::evict_normal on
//   every source line): that would be a second pass over the rows,
//   after the last CTA's reads, and the expert product that follows
//   the dispatch measured no slower (PERF.md §6). Timings that follow
//   a gather reset them first (chip_smoke.py, kernel_ab.py).
// Measured on the H100 and not kept (PERF.md §6): the other hint
// choices; two or four rows a CTA; two rows a one-warp CTA; persistent
// grids; an index_select-like walk over (row, vector); and Hopper's 1-D
// bulk copies (TMA without a tensor map) through a ring of mbarrier
// stages in a persistent grid, at every stage size, depth and CTAs an
// SM tried.
// It copies bytes, so one instance serves every dtype; a sentinel row
// reads nothing and is stored as zeros.
//
// moe_combine: one warp owns one output row, 8 rows to a CTA of 256
// threads, a grid over the rows; lanes 0..k-1 load the row's indices and
// weights, a shuffle hands them to the warp, and every lane then moves
// 16-byte vectors (768 f32 = 192 vectors, 6 a lane). It issues the loads
// of all k rows of a vector before it adds any, and adds them in slot
// order with explicit rounding (no FMA contraction), so each output
// element is the JAX kernel's `acc + (w * valid) * row` sequence
// exactly.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;        // the combine's output rows per CTA
constexpr int kMaxK = 8;         // the combine's largest k

// ---------------------------------------------------------------------------
// moe_gather
// ---------------------------------------------------------------------------

// rows of at least this many bytes go one to a CTA, narrower ones
// kNarrowRows to a CTA
constexpr int kWideRow = 2048;
constexpr int kNarrowRows = 8;
constexpr int kUnroll = 8;       // 16-byte vectors a lane has in flight

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, %1;"
               : "=l"(p) : "f"(1.0f));
  return p;
}

__device__ __forceinline__ uint4 load_hint(const uint4* p, uint64_t pol) {
  uint4 v;
  asm volatile(
      "ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p), "l"(pol));
  return v;
}

template <int kRowsPerCta>
__global__ void __launch_bounds__(kRowsPerCta * 32)
moe_gather_kernel(const uint4* __restrict__ src, const int* __restrict__ idx,
                  uint4* __restrict__ out, int n_src, int m, int nvec) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerCta + threadIdx.x / 32;
  if (row >= m) return;
  const uint64_t pol = evict_last_policy();
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  int t = lane == 0 ? idx[row] : 0;
  t = __shfl_sync(0xffffffffu, t, 0);
  const bool valid = static_cast<unsigned>(t) < static_cast<unsigned>(n_src);
  const uint4* s = src + static_cast<long long>(valid ? t : 0) * nvec;
  uint4* o = out + static_cast<long long>(row) * nvec;
  for (int base = lane; base < nvec; base += 32 * kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * 32;
      v[u] = valid && j < nvec ? load_hint(s + j, pol) : zero;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * 32;
      if (j < nvec) o[j] = v[u];
    }
  }
}

// 16 bytes of T <-> kVec f32 values
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void to_f32(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ static uint4 from_f32(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void to_f32(const uint4& r, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ static uint4 from_f32(const float* f) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return r;
  }
};

__device__ __forceinline__ float load_weight(const float* w, long long i) {
  return w[i];
}
__device__ __forceinline__ float load_weight(const __nv_bfloat16* w,
                                             long long i) {
  return __bfloat162float(w[i]);
}

template <typename T, typename TW>
__global__ void __launch_bounds__(kWarps * 32)
moe_combine_kernel(const uint4* __restrict__ src, const int* __restrict__ idx,
                   const TW* __restrict__ w, uint4* __restrict__ out,
                   int n_src, int n, int k, int nvec) {
  constexpr int kN = Vec<T>::kN;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= n) return;
  int t_mine = n_src;
  float w_mine = 0.f;
  if (lane < k) {
    const long long at = static_cast<long long>(row) * k + lane;
    t_mine = idx[at];
    w_mine = load_weight(w, at);
  }
  int t[kMaxK];
  float ws[kMaxK];
  bool valid[kMaxK];
#pragma unroll
  for (int s = 0; s < kMaxK; ++s) {
    t[s] = __shfl_sync(0xffffffffu, t_mine, s);
    ws[s] = __shfl_sync(0xffffffffu, w_mine, s);
    valid[s] = s < k &&
               static_cast<unsigned>(t[s]) < static_cast<unsigned>(n_src);
  }
  uint4* o = out + static_cast<long long>(row) * nvec;
  for (int j = lane; j < nvec; j += 32) {
    uint4 r[kMaxK];
#pragma unroll
    for (int s = 0; s < kMaxK; ++s)
      if (valid[s]) r[s] = src[static_cast<long long>(t[s]) * nvec + j];
    float acc[kN];
#pragma unroll
    for (int e = 0; e < kN; ++e) acc[e] = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxK; ++s) {
      if (!valid[s]) continue;
      float x[kN];
      Vec<T>::to_f32(r[s], x);
#pragma unroll
      for (int e = 0; e < kN; ++e)
        acc[e] = __fadd_rn(acc[e], __fmul_rn(ws[s], x[e]));
    }
    o[j] = Vec<T>::from_f32(acc);
  }
}

unsigned blocks_for(int rows) { return (rows + kWarps - 1) / kWarps; }

template <typename T>
int launch_combine(const void* src, const int* idx, const void* w,
                   int w_dtype, void* out, int n_src, int n, int k, int nvec,
                   cudaStream_t stream) {
  const uint4* s = static_cast<const uint4*>(src);
  uint4* o = static_cast<uint4*>(out);
  if (w_dtype == 0)
    moe_combine_kernel<T, float><<<blocks_for(n), kWarps * 32, 0, stream>>>(
        s, idx, static_cast<const float*>(w), o, n_src, n, k, nvec);
  else if (w_dtype == 1)
    moe_combine_kernel<T, __nv_bfloat16>
        <<<blocks_for(n), kWarps * 32, 0, stream>>>(
            s, idx, static_cast<const __nv_bfloat16*>(w), o, n_src, n, k,
            nvec);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src [n_src, d], idx int32 [m], out [m, d]; row_bytes = d * itemsize, a
// multiple of 16, and src and out 16-byte aligned. m > 0. Returns a
// cudaError_t code.
extern "C" int moe_gather_launch(const void* src, const void* idx, void* out,
                                 int n_src, int m, int row_bytes,
                                 void* stream) {
  if (m <= 0 || row_bytes <= 0 || row_bytes % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint4* s = static_cast<const uint4*>(src);
  const int* ip = static_cast<const int*>(idx);
  uint4* o = static_cast<uint4*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (row_bytes >= kWideRow)
    moe_gather_kernel<1><<<m, 32, 0, st>>>(s, ip, o, n_src, m,
                                           row_bytes / 16);
  else
    moe_gather_kernel<kNarrowRows>
        <<<(m + kNarrowRows - 1) / kNarrowRows, kNarrowRows * 32, 0, st>>>(
            s, ip, o, n_src, m, row_bytes / 16);
  return static_cast<int>(cudaGetLastError());
}

// src [n_src, d], idx int32 [n, k], w [n, k], out [n, d] in src's dtype;
// 1 <= k <= 8, n > 0, d * itemsize a multiple of 16, src and out 16-byte
// aligned. Dtype codes: 0 = float32, 1 = bfloat16, for src and for w.
// Returns a cudaError_t code.
extern "C" int moe_combine_launch(const void* src, const void* idx,
                                  const void* w, void* out, int n_src, int n,
                                  int k, int d, int src_dtype, int w_dtype,
                                  void* stream) {
  if (n <= 0 || k < 1 || k > kMaxK || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(idx);
  if (src_dtype == 0 && d % Vec<float>::kN == 0)
    return launch_combine<float>(src, ip, w, w_dtype, out, n_src, n, k,
                                 d / Vec<float>::kN, st);
  if (src_dtype == 1 && d % Vec<__nv_bfloat16>::kN == 0)
    return launch_combine<__nv_bfloat16>(src, ip, w, w_dtype, out, n_src, n,
                                         k, d / Vec<__nv_bfloat16>::kN, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Reset the L2 lines that accesses under evict_last left persisting, for
// timings that follow a gather (the wrappers never call it: it acts on
// the whole context). Returns a cudaError_t code.
extern "C" int moe_gather_reset_l2() {
  return static_cast<int>(cudaCtxResetPersistingL2Cache());
}

extern "C" const char* moe_kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
