// flash_attention_fwd — attention forward with the row log-sum-exp, for
// the training step.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas_attention.py::_flash_fwd
// (rectangular grid) and ::_flash_fwd_tri (triangle grid, causal with
// bq == bk); registry name "flash_fwd".
//
// q [b, sq, n, H] and k/v [b, sk, n, H] are read through their strides
// (unit stride along H); out is a contiguous [b, sq, n, H] in the input
// dtype and lse a contiguous f32 [b*n, sq]:
//   out[i] = softmax_j(q_i·k_j·scale) · v_j,  lse[i] = log sum_j exp(..)
// over keys j < sk, and when causal only j <= i + (sk - sq).
//
// What bounds it: at the training shape (b 24, s 1024, 12 heads of 64,
// causal) the work is ~39 GFLOP against ~151 MB of q/k/v/out, ~250 flops
// per byte: the tensor cores, not memory, set the bound.
//
// bf16 design: one CTA of 4 warps per (b·n, 64-row query tile); each
// warp owns 16 query rows and keeps their q fragments in registers. The
// CTA walks 64-key tiles from key 0 up to the tile's last visible key
// (tiles past the diagonal are never loaded), staging K and V in shared
// memory. Both products, S = Q K^T and O += P V, are mma.sync.m16n8k16
// bf16 -> f32; the online softmax runs in f32 on the S fragments, and P
// is rounded to bf16 for the second product, as the TPU kernel does.
// Masked keys are excluded explicitly (p = 0); the running max starts at
// -1e30, so a row whose keys are all masked so far rescales by
// exp(0) = 1 over zeros instead of forming exp(-inf + inf). Causal
// query tiles are launched last-first, so the longest ones start first.
//
// f32 design (parity runs only): one thread per query row, its q row in
// padded shared memory, its f32 accumulator in registers, 32-key tiles,
// scalar FMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kTile = 64;       // query rows and keys per tile (bf16)
constexpr int kF32Keys = 32;    // keys per tile (f32)

struct Shape {
  int b, sq, sk, n;
  long long q_sb, q_ss, q_sn, k_sb, k_ss, k_sn, v_sb, v_ss, v_sn;
  int causal;
  float scale;
};

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a · b for one m16n8k16 tile: a row-major 16x16, b 16x8 (k-major
// pairs), c 16x8 f32 — the PTX fragment layouts.
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// keys [0, end) that some row of the query tile [q0, q0 + rows) sees
__device__ __forceinline__ int key_end(const Shape& sh, int q0, int rows) {
  if (!sh.causal) return sh.sk;
  const int last = min(q0 + rows - 1, sh.sq - 1) + (sh.sk - sh.sq);
  return min(last, sh.sk - 1) + 1;
}

template <int H>
__global__ void __launch_bounds__(128)
fwd_bf16(const __nv_bfloat16* __restrict__ q,
         const __nv_bfloat16* __restrict__ k,
         const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
         float* __restrict__ lse, Shape sh) {
  constexpr int LD = H + 8;     // padded row: conflict-free fragment loads
  __shared__ __align__(16) __nv_bfloat16 ks[kTile * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[kTile * LD];
  const int bn = blockIdx.y, bi = bn / sh.n, ni = bn % sh.n;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const int off = sh.sk - sh.sq;
  const __nv_bfloat16* qb = q + bi * sh.q_sb + ni * sh.q_sn;
  const __nv_bfloat16* kb = k + bi * sh.k_sb + ni * sh.k_sn;
  const __nv_bfloat16* vb = v + bi * sh.v_sb + ni * sh.v_sn;

  uint32_t qf[H / 16][4];
#pragma unroll
  for (int kc = 0; kc < H / 16; ++kc) {
    const int c = kc * 16 + 2 * t;
    qf[kc][0] = r0 < sh.sq ? ld32(qb + r0 * sh.q_ss + c) : 0u;
    qf[kc][1] = r1 < sh.sq ? ld32(qb + r1 * sh.q_ss + c) : 0u;
    qf[kc][2] = r0 < sh.sq ? ld32(qb + r0 * sh.q_ss + c + 8) : 0u;
    qf[kc][3] = r1 < sh.sq ? ld32(qb + r1 * sh.q_ss + c + 8) : 0u;
  }
  float o[H / 8][4];
#pragma unroll
  for (int nh = 0; nh < H / 8; ++nh)
    o[nh][0] = o[nh][1] = o[nh][2] = o[nh][3] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;

  const int kend = key_end(sh, q0, kTile);
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    __syncthreads();            // the previous tile is consumed
    for (int i = threadIdx.x; i < kTile * H / 8; i += blockDim.x) {
      const int row = i / (H / 8), col = (i % (H / 8)) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
      if (k0 + row < sh.sk) {
        kv = *reinterpret_cast<const uint4*>(kb + (k0 + row) * sh.k_ss + col);
        vv = *reinterpret_cast<const uint4*>(vb + (k0 + row) * sh.v_ss + col);
      }
      *reinterpret_cast<uint4*>(ks + row * LD + col) = kv;
      *reinterpret_cast<uint4*>(vs + row * LD + col) = vv;
    }
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < H / 16; ++kc) {
        const __nv_bfloat16* kr = ks + (nt * 8 + g) * LD + kc * 16 + 2 * t;
        mma(s[nt], qf[kc], ld32(kr), ld32(kr + 8));
      }
    }
    // scale, mask, row max (rows r0: elements 0,1; r1: elements 2,3)
    float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        const bool ok = col < sh.sk && (!sh.causal || col <= row + off);
        s[nt][e] = ok ? s[nt][e] * sh.scale : kNeg;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    // the 4 threads of a quad share rows g and g + 8
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = __expf(m0 - mn0), a1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int nh = 0; nh < H / 8; ++nh) {
      o[nh][0] *= a0;
      o[nh][1] *= a0;
      o[nh][2] *= a1;
      o[nh][3] *= a1;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            s[nt][e] == kNeg ? 0.f : __expf(s[nt][e] - (e < 2 ? m0 : m1));
        s[nt][e] = p;
        if (e < 2) l0 += p; else l1 += p;
      }
    }
    // O += P V: P's C fragments of n-tiles 2c, 2c+1 are the A fragment
    // of key chunk c; V's k-pairs are read as two 16-bit loads
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t a[4] = {pack_f32(s[2 * c][0], s[2 * c][1]),
                             pack_f32(s[2 * c][2], s[2 * c][3]),
                             pack_f32(s[2 * c + 1][0], s[2 * c + 1][1]),
                             pack_f32(s[2 * c + 1][2], s[2 * c + 1][3])};
#pragma unroll
      for (int nh = 0; nh < H / 8; ++nh) {
        const __nv_bfloat16* vr = vs + (c * 16 + 2 * t) * LD + nh * 8 + g;
        mma(o[nh], a, pack_bf16(vr[0], vr[LD]),
            pack_bf16(vr[8 * LD], vr[9 * LD]));
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  l0 = l0 == 0.f ? 1.f : l0;
  l1 = l1 == 0.f ? 1.f : l1;
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  const long long rs = (long long)sh.n * H;     // out row stride
  __nv_bfloat16* ob = out + (long long)bi * sh.sq * rs + (long long)ni * H;
#pragma unroll
  for (int nh = 0; nh < H / 8; ++nh) {
    const int c = nh * 8 + 2 * t;
    if (r0 < sh.sq)
      *reinterpret_cast<uint32_t*>(ob + r0 * rs + c) =
          pack_f32(o[nh][0] * i0, o[nh][1] * i0);
    if (r1 < sh.sq)
      *reinterpret_cast<uint32_t*>(ob + r1 * rs + c) =
          pack_f32(o[nh][2] * i1, o[nh][3] * i1);
  }
  if (t == 0) {
    if (r0 < sh.sq) lse[(long long)bn * sh.sq + r0] = m0 + logf(l0);
    if (r1 < sh.sq) lse[(long long)bn * sh.sq + r1] = m1 + logf(l1);
  }
}

template <int H>
__global__ void __launch_bounds__(kTile)
fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, float* __restrict__ out,
        float* __restrict__ lse, Shape sh) {
  constexpr int QLD = H + 1;    // padded: thread r reads row r conflict-free
  extern __shared__ float smem[];
  float* qs = smem;                     // [64][H + 1]
  float* ks = qs + kTile * QLD;         // [32][H]
  float* vs = ks + kF32Keys * H;        // [32][H]
  const int bn = blockIdx.y, bi = bn / sh.n, ni = bn % sh.n;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int r = q0 + threadIdx.x;
  const int off = sh.sk - sh.sq;
  const float* qb = q + bi * sh.q_sb + ni * sh.q_sn;
  const float* kb = k + bi * sh.k_sb + ni * sh.k_sn;
  const float* vb = v + bi * sh.v_sb + ni * sh.v_sn;
  for (int i = threadIdx.x; i < kTile * H; i += kTile) {
    const int row = i / H, col = i % H;
    qs[row * QLD + col] = q0 + row < sh.sq ? qb[(q0 + row) * sh.q_ss + col]
                                           : 0.f;
  }
  const float* qr = qs + threadIdx.x * QLD;
  float acc[H];
#pragma unroll
  for (int d = 0; d < H; ++d) acc[d] = 0.f;
  float m = kNeg, l = 0.f;
  const int kend = key_end(sh, q0, kTile);
  const int last = sh.causal ? min(r + off, sh.sk - 1) : sh.sk - 1;
  for (int k0 = 0; k0 < kend; k0 += kF32Keys) {
    __syncthreads();
    for (int i = threadIdx.x; i < kF32Keys * H; i += kTile) {
      const int row = i / H, col = i % H;
      const bool in = k0 + row < sh.sk;
      ks[i] = in ? kb[(k0 + row) * sh.k_ss + col] : 0.f;
      vs[i] = in ? vb[(k0 + row) * sh.v_ss + col] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < kF32Keys && k0 + j <= last; ++j) {
      const float* kr = ks + j * H;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < H; ++d) dot += qr[d] * kr[d];
      const float sc = dot * sh.scale;
      const float mn = fmaxf(m, sc);
      const float a = expf(m - mn), p = expf(sc - mn);
      const float* vr = vs + j * H;
      l = l * a + p;
#pragma unroll
      for (int d = 0; d < H; ++d) acc[d] = acc[d] * a + p * vr[d];
      m = mn;
    }
  }
  if (r < sh.sq) {
    l = l == 0.f ? 1.f : l;
    const float inv = 1.f / l;
    float* o = out + ((long long)bi * sh.sq + r) * sh.n * H + (long long)ni * H;
#pragma unroll
    for (int d = 0; d < H; ++d) o[d] = acc[d] * inv;
    lse[(long long)bn * sh.sq + r] = m + logf(l);
  }
}

template <int H>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               float* lse, const Shape& sh, cudaStream_t st) {
  const size_t smem = (kTile * (H + 1) + 2 * kF32Keys * H) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      fwd_f32<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((sh.sq + kTile - 1) / kTile, sh.b * sh.n);
  fwd_f32<H><<<grid, kTile, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, sh);
  return (int)cudaGetLastError();
}

template <int H>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, const Shape& sh, cudaStream_t st) {
  const dim3 grid((sh.sq + kTile - 1) / kTile, sh.b * sh.n);
  fwd_bf16<H><<<grid, 128, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), lse, sh);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim 64 or 128. Strides are in
// elements (b, s, n of each input; the H axis must be unit-stride and,
// for bf16, rows 16-byte aligned — the wrapper checks). Causal needs
// sk >= sq. Launches on `stream`; returns a cudaError_t.
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int b, int sq, int sk, int n, int head_dim, long long q_sb,
    long long q_ss, long long q_sn, long long k_sb, long long k_ss,
    long long k_sn, long long v_sb, long long v_ss, long long v_sn,
    int causal, int dtype, float scale, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || n <= 0) return 0;
  const Shape sh{b, sq, sk, n, q_sb, q_ss, q_sn, k_sb, k_ss, k_sn,
                 v_sb, v_ss, v_sn, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0 && head_dim == 64) return launch_f32<64>(q, k, v, out, l, sh, st);
  if (dtype == 0 && head_dim == 128) return launch_f32<128>(q, k, v, out, l, sh, st);
  if (dtype == 1 && head_dim == 64) return launch_bf16<64>(q, k, v, out, l, sh, st);
  if (dtype == 1 && head_dim == 128) return launch_bf16<128>(q, k, v, out, l, sh, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
