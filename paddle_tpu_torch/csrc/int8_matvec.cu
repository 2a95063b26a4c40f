// int8_matvec — the weight-only-int8 LM head: h times an int8 table with
// per-row scales.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_int8.py::int8_matvec
// (registry name "int8_matvec").
//
// Computes out[b, v] = scale[v] · Σ_d bf16(h[b, d]) · wq[v, d] in f32,
// for h [B, D] (f32 or bf16), wq int8 [V, D] and scale f32 [V]. h is
// rounded to bf16 (round to nearest even) and the int8 values convert
// exactly, so every product is exact in f32; products accumulate in f32
// and the scale multiplies the sum. The dequantized table never exists.
//
// What bounds it: memory. At GPT-3 125M's head (V 51200, D 768) the
// table is 39.3 MB of int8 against 2·B·V·D operations: at decode batches
// (B <= 64) far below the card's ops-per-byte balance.
//
// Design: the products run on the tensor cores (mma.sync m16n8k16, bf16
// in, f32 accumulate): a CUDA-core loop would re-read h from shared
// memory for every multiply-add and be bound by shared memory, not by
// the table. Each warp owns tiles of 16 table rows (the mma's M) and
// walks D in blocks of 64; the batch rows are the mma's N, 8 per n-tile.
// A sum over d does not care in which order the d's come, so each lane
// reads its 16 table bytes of a block as ONE 16-byte load per row (the
// mma's own A layout would need 2-byte loads) and the k-slots of the
// block's four mma steps are assigned to match: lane t of a quad holds
// d = 16t .. 16t+15, and step j takes d = 16t + 4j .. 16t + 4j + 3 into
// the lane's slots (2t, 2t+1, 2t+8, 2t+9). h, staged once per CTA in
// shared memory as bf16 (rows padded so a warp's 16-byte reads hit
// distinct banks), is read with the same assignment: two 16-byte loads
// per lane per block. int8 turns into bf16 without a conversion unit:
// x ^ 0x80 is x + 128 as an unsigned byte; placed in the mantissa of
// 2^23 and minus 2^23 + 128 it is x as f32, whose upper 16 bits are x
// as bf16 exactly. Batches above 8·NT rows (NT <= 8) run in chunks,
// re-reading the table once per chunk.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kPad = 8;             // bf16 pad per staged h row

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte i of u (already x ^ 0x80) as the f32 value x
__device__ __forceinline__ float byte_f32(uint32_t u, int i) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) -
         8388736.f;
}

// two exact small-integer f32 values -> one bf16x2 (lo in the low half)
__device__ __forceinline__ uint32_t pack_hi(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// 16 int8 values -> 8 bf16x2, element pairs in order
__device__ __forceinline__ void int8x16_bf16(uint4 w, uint32_t out[8]) {
  const uint32_t words[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u,
                             w.z ^ 0x80808080u, w.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = pack_hi(byte_f32(words[i], 0), byte_f32(words[i], 1));
    out[2 * i + 1] = pack_hi(byte_f32(words[i], 2), byte_f32(words[i], 3));
  }
}

__device__ __forceinline__ __nv_bfloat16 to_bf16(float x) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 x) {
  return x;
}

template <typename TH, int NT>
__global__ void __launch_bounds__(kWarps * 32)
int8_matvec_kernel(const TH* __restrict__ h, const int8_t* __restrict__ wq,
                   const float* __restrict__ scale, float* __restrict__ out,
                   int B, int D, int V) {
  extern __shared__ __align__(16) __nv_bfloat16 hs[];
  constexpr int kRows = 8 * NT;     // batch rows per chunk
  const int ld = D + kPad;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int m_tiles = (V + 15) / 16;

  for (int c0 = 0; c0 < B; c0 += kRows) {
    __syncthreads();                // the previous chunk is consumed
    for (int i = threadIdx.x; i < kRows * D; i += blockDim.x) {
      const int r = i / D, d = i % D;
      hs[r * ld + d] = c0 + r < B ? to_bf16(h[(long long)(c0 + r) * D + d])
                                  : __float2bfloat16_rn(0.f);
    }
    __syncthreads();

    for (int mt = blockIdx.x * kWarps + warp; mt < m_tiles;
         mt += gridDim.x * kWarps) {
      const int v0 = mt * 16 + g, v1 = v0 + 8;
      const int8_t* w0 = wq + (long long)v0 * D + 16 * t;
      const int8_t* w1 = wq + (long long)v1 * D + 16 * t;
      float acc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

#pragma unroll 4
      for (int d0 = 0; d0 < D; d0 += 64) {
        const uint4 zero = make_uint4(0, 0, 0, 0);
        const uint4 r0 = v0 < V ? *reinterpret_cast<const uint4*>(w0 + d0)
                                : zero;
        const uint4 r1 = v1 < V ? *reinterpret_cast<const uint4*>(w1 + d0)
                                : zero;
        uint32_t a0[8], a1[8];      // rows v0 and v1 as bf16x2 pairs
        int8x16_bf16(r0, a0);
        int8x16_bf16(r1, a1);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint4* hp = reinterpret_cast<const uint4*>(
              hs + (nt * 8 + g) * ld + d0 + 16 * t);
          const uint4 h0 = hp[0], h1 = hp[1];
          const uint32_t hb[8] = {h0.x, h0.y, h0.z, h0.w,
                                  h1.x, h1.y, h1.z, h1.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t a[4] = {a0[2 * j], a1[2 * j], a0[2 * j + 1],
                                   a1[2 * j + 1]};
            mma(acc[nt], a, hb[2 * j], hb[2 * j + 1]);
          }
        }
      }

      const float s0 = v0 < V ? scale[v0] : 0.f;
      const float s1 = v1 < V ? scale[v1] : 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int b0 = c0 + nt * 8 + 2 * t, b1 = b0 + 1;
        if (v0 < V) {
          if (b0 < B) out[(long long)b0 * V + v0] = acc[nt][0] * s0;
          if (b1 < B) out[(long long)b1 * V + v0] = acc[nt][1] * s0;
        }
        if (v1 < V) {
          if (b0 < B) out[(long long)b0 * V + v1] = acc[nt][2] * s1;
          if (b1 < B) out[(long long)b1 * V + v1] = acc[nt][3] * s1;
        }
      }
    }
  }
}

template <typename TH, int NT>
int launch(const void* h, const int8_t* wq, const float* scale, float* out,
           int B, int D, int V, cudaStream_t stream) {
  const int smem = 8 * NT * (D + kPad) * (int)sizeof(__nv_bfloat16);
  auto kernel = int8_matvec_kernel<TH, NT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int m_tiles = (V + 15) / 16;
  const int grid = (m_tiles + kWarps - 1) / kWarps;
  kernel<<<grid, kWarps * 32, smem, stream>>>(static_cast<const TH*>(h), wq,
                                              scale, out, B, D, V);
  return (int)cudaGetLastError();
}

template <typename TH>
int launch_nt(const void* h, const int8_t* wq, const float* scale,
              float* out, int B, int D, int V, int nt, cudaStream_t stream) {
  switch (nt) {
    case 1: return launch<TH, 1>(h, wq, scale, out, B, D, V, stream);
    case 2: return launch<TH, 2>(h, wq, scale, out, B, D, V, stream);
    case 4: return launch<TH, 4>(h, wq, scale, out, B, D, V, stream);
    case 8: return launch<TH, 8>(h, wq, scale, out, B, D, V, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// h [B, D] (h_dtype 0 = float32, 1 = bfloat16), wq int8 [V, D] with D a
// multiple of 64 and 16-byte aligned rows, scale f32 [V], out f32 [B, V];
// nt (1, 2, 4 or 8) n-tiles of 8 batch rows per chunk, which sets the
// shared memory to 16·nt·(D + 8) bytes. Returns a cudaError_t code.
extern "C" int int8_matvec_launch(const void* h, const void* wq,
                                  const void* scale, void* out, int B, int D,
                                  int V, int nt, int h_dtype, void* stream) {
  const int8_t* w = static_cast<const int8_t*>(wq);
  const float* s = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (h_dtype == 0)
    return launch_nt<float>(h, w, s, o, B, D, V, nt, st);
  if (h_dtype == 1)
    return launch_nt<__nv_bfloat16>(h, w, s, o, B, D, V, nt, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* int8_matvec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
