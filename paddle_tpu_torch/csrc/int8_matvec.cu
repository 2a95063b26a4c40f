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
// (B <= 64) far below the card's ops-per-byte balance, so the table
// stream must set the pace and nothing else may.
//
// Design (int8_matvec_wgmma; the building blocks in hopper.cuh):
// - A persistent grid: one CTA an SM, two where h is small enough (at
//   most 16 batch rows), each with two consumer warpgroups and one
//   producer warp (288 threads). The table is cut into units of 64 rows
//   (wgmma's M); worker w (a warpgroup) takes units w, w + W, ... of the
//   W workers, warpgroup-major, so a last short round spreads over SMs.
// - The producer streams each unit as 64-row x 64-byte boxes of a 2-D
//   TMA map over [V, D] int8 into a ring of 8 stages per warpgroup (a
//   full mbarrier completed by the TMA bytes, an empty one each consumer
//   warp arrives on), 64 KB in flight a CTA. Rows past V read as zeros.
// - Meanwhile the consumers stage the CTA's rows of h once, rounded to
//   bf16, with 16-byte loads (eight in flight a thread) and no divides,
//   in wgmma's K-major core-matrix order (8 batch rows x 16 bytes a core
//   matrix; LBO N·16 bytes between the two k halves, SBO 128 bytes
//   between groups of 8 batch rows), then fence them to the async proxy.
// - A warp's 16 table rows of a stage are two 16-byte shared loads a
//   lane (the box's 64-byte rows make a quarter-warp's reads one
//   conflict-free 128-byte span); the stage is released at once, after
//   a proxy fence: without it the TMA refill raced those plain reads
//   (stale rows, seen at V 50257 with 16 batch rows). A sum over d does
//   not care in which order the d's come, so lane t of a quad holds
//   d = 16t .. 16t+15 and k-step j takes d = 16t + 4j .. 16t + 4j + 3
//   into the lane's A slots (2t, 2t+1, 2t+8, 2t+9); h is staged with
//   the same permutation, so each k slot of A meets its own d in B.
// - int8 turns into bf16 in registers without a conversion unit: x ^
//   0x80 is x + 128 as an unsigned byte; placed in the mantissa of 2^23
//   and minus 2^23 + 128 it is x as f32, whose upper 16 bits are x as
//   bf16 exactly.
// - The products are wgmma.m64nNk16 with the converted table as the
//   register A operand and h, read by the tensor cores from shared
//   memory once per 64 x 16 table slice, as B; N = 8, 16, 32 or 64, the
//   batch rows rounded up. wgmma and not mma.sync because mma.sync needs
//   h in registers: each 16-row tile reloads it from shared memory once
//   per 8 batch rows (8 KB of shared reads a KB of table at 64 rows,
//   near the SM's shared-memory rate), where wgmma reads 2 KB. The A
//   registers are double-buffered: the next stage converts while this
//   stage's four wgmmas run. The k loop takes the 64-column blocks in
//   pairs, D padded to a multiple of 128 (the pad reads as zeros): a
//   wgmma under the loop's odd-block condition made ptxas serialize
//   every wgmma (C7513).
// - A unit's sums are scaled per row and written through a per-warp
//   shared tile as 16-byte stores along V (scalar where V is not a
//   multiple of 4).
// Batches above 64 rows (or what shared memory holds of h at large D)
// run as several launches over row chunks, re-reading the table once
// per chunk. The order of summation differs from the JAX kernel's (and
// the plain version's): each f32 sum runs over k-steps of 16 d's, in
// the tensor cores' own order within a step.
#include <stdio.h>

#include "hopper.cuh"

namespace {

constexpr int kGroups = 2;                  // consumer warpgroups a CTA
constexpr int kThreads = 32 * (4 * kGroups + 1);
constexpr int kRows = 64;                   // table rows a unit
constexpr int kBlock = 64;                  // table columns a stage
constexpr int kStageBytes = kRows * kBlock;
constexpr int kStages = 8;                  // ring depth a warpgroup
constexpr int kOutLd = 20;                  // floats a row of a warp's output tile

// d (+)= A B, m64nNk16, A from registers, B K-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[4], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : WG_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
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
__device__ __forceinline__ void int8x16_bf16(uint4 w, uint32_t (&out)[8]) {
  const uint32_t words[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u,
                             w.z ^ 0x80808080u, w.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = pack_hi(byte_f32(words[i], 0), byte_f32(words[i], 1));
    out[2 * i + 1] = pack_hi(byte_f32(words[i], 2), byte_f32(words[i], 3));
  }
}

// 8 consecutive values of h as 4 bf16x2 (round to nearest even)
__device__ __forceinline__ void h8_bf16(const float* p, uint32_t (&out)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  const float4 y = *reinterpret_cast<const float4*>(p + 4);
  out[0] = pack_f32(x.x, x.y);
  out[1] = pack_f32(x.z, x.w);
  out[2] = pack_f32(y.x, y.y);
  out[3] = pack_f32(y.z, y.w);
}
__device__ __forceinline__ void h8_bf16(const __nv_bfloat16* p,
                                        uint32_t (&out)[4]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}

template <int N>
struct Smem {
  uint8_t ring[kGroups][kStages][kStageBytes];
  float tile[4 * kGroups][N][kOutLd];     // each consumer warp's outputs
  uint64_t full[kGroups][kStages], empty[kGroups][kStages];
};

// D rounded up to a multiple of 128: the k loop takes blocks in pairs
__host__ __device__ constexpr int pad_d(int D) { return (D + 127) / 128 * 128; }

// h (2·N·pad_d(D) bytes) follows the fixed part, 128-byte aligned
template <int N>
__host__ __device__ constexpr size_t h_offset() {
  return (sizeof(Smem<N>) + 127) / 128 * 128;
}

// grid: persistent (see launch); B <= N rows of h and out, 64 | D
template <typename TH, int N, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
int8_matvec_wgmma(const __grid_constant__ CUtensorMap tw,
                  const TH* __restrict__ h, const float* __restrict__ scale,
                  float* __restrict__ out, int B, int D, int V) {
  auto& S = smem_at_1024<Smem<N>>();
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(
      reinterpret_cast<unsigned char*>(&S) + h_offset<N>());
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_units = (V + kRows - 1) / kRows;
  // an even number of 64-column blocks: the pad past D reads as zeros
  const int Dp = pad_d(D);
  const int n_blocks = Dp / kBlock;
  const int workers = gridDim.x * kGroups;
  if (threadIdx.x == 0) {
    for (int g = 0; g < kGroups; ++g)
      for (int s = 0; s < kStages; ++s) {
        mbar_init(&S.full[g][s], 1);
        mbar_init(&S.empty[g][s], 4);     // every warp of the warpgroup
      }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * kGroups) {          // producer: one lane issues TMA
    if (lane == 0) {
      int it[kGroups] = {};
      // round r: warpgroup g takes unit blockIdx.x + g·gridDim.x + r·W
      for (int u0 = blockIdx.x; u0 < n_units; u0 += workers)
        for (int blk = 0; blk < n_blocks; ++blk)
#pragma unroll
          for (int g = 0; g < kGroups; ++g) {
            const int unit = u0 + g * gridDim.x;
            if (unit >= n_units) continue;
            const int s = it[g] % kStages;
            if (it[g] >= kStages)
              mbar_wait(&S.empty[g][s], ((it[g] / kStages) & 1) ^ 1);
            mbar_expect_tx(&S.full[g][s], kStageBytes);
            tma_load_2d(S.ring[g][s], &tw, &S.full[g][s], blk * kBlock,
                        unit * kRows);
            ++it[g];
          }
    }
    return;
  }

  // stage h: batch row n, d = 64·blk + 16·t + 4·j + u lands in k-step
  // 4·blk + j, half u / 2, slot 2t + u % 2 (see the note); rows past B
  // and columns past D are zeros. Thread (rs, cl) of 16 x 16 takes rows
  // rs + 16a and 8-column chunks cl + 16c, eight chunks' loads in flight
  // before their stores.
  {
    const int rs = threadIdx.x >> 4, cl = threadIdx.x & 15;
    const int cc = Dp / 128;                    // chunk blocks a row
    const int total = (N + 15) / 16 * cc;
    int a = 0, c = 0;
    for (int j0 = 0; j0 < total; j0 += 8) {
      uint32_t pr[8][4];
      int na[8], nc[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        na[u] = a;
        nc[u] = c;
        const int n = rs + 16 * a, i = cl + 16 * c;
        pr[u][0] = pr[u][1] = pr[u][2] = pr[u][3] = 0u;
        if (j0 + u < total && n < B && 8 * i < D)
          h8_bf16(h + (long long)n * D + 8 * i, pr[u]);
        if (++c == cc) {
          c = 0;
          ++a;
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int n = rs + 16 * na[u], d0 = 8 * (cl + 16 * nc[u]);
        if (j0 + u >= total || n >= N) continue;
        const int ks = 4 * (d0 >> 6) + ((d0 >> 2) & 2), tt = (d0 >> 4) & 3;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          uint32_t* lo = reinterpret_cast<uint32_t*>(
              hs + ((2 * (ks + jj)) * N + n) * 8);
          uint32_t* hi = reinterpret_cast<uint32_t*>(
              hs + ((2 * (ks + jj) + 1) * N + n) * 8);
          lo[tt] = pr[u][2 * jj];
          hi[tt] = pr[u][2 * jj + 1];
        }
      }
    }
    fence_proxy_async();
    asm volatile("bar.sync 1, %0;\n" :: "n"(128 * kGroups) : "memory");
  }

  const int grp = warp >> 2, wq = warp & 3;
  const int g8 = lane >> 2, t = lane & 3;
  // B descriptor of k-step ks: 2·N·16 bytes a k-step, LBO N·16, SBO 128
  const uint64_t hdesc = (uint64_t)(smem_u32(hs) >> 4) |
                         ((uint64_t)N << 16) | ((uint64_t)8 << 32);
  float(&tile)[N][kOutLd] = S.tile[warp];
  const bool vec = (V & 3) == 0;
  int it = 0;
  float acc[N / 2];
  uint32_t fa[4][4], fb[4][4];
  // one stage: this warp's 16 rows x 64 d -> four k-steps of wgmma
  auto step = [&](uint32_t(&fr)[4][4], int blk) {
    const int s = it % kStages;
    mbar_wait(&S.full[grp][s], (it / kStages) & 1);
    const uint8_t* st = S.ring[grp][s];
    const uint4 r0 = *reinterpret_cast<const uint4*>(
        st + (16 * wq + g8) * kBlock + 16 * t);
    const uint4 r1 = *reinterpret_cast<const uint4*>(
        st + (16 * wq + g8 + 8) * kBlock + 16 * t);
    // the TMA refill (async proxy) must not overtake these plain reads
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(&S.empty[grp][s]);
    ++it;
    uint32_t c0[8], c1[8];
    int8x16_bf16(r0, c0);
    int8x16_bf16(r1, c1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      fr[j][0] = c0[2 * j];
      fr[j][1] = c1[2 * j];
      fr[j][2] = c0[2 * j + 1];
      fr[j][3] = c1[2 * j + 1];
    }
    wg_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_rs(acc, fr[j], hdesc + (uint64_t)((4 * blk + j) * 2 * N));
    wg_commit();
    wg_wait<1>();   // the stage before is done: its A registers are free
  };

  for (int unit = grp * gridDim.x + blockIdx.x; unit < n_units;
       unit += workers) {
    const int v0 = unit * kRows + 16 * wq;      // this warp's first row
    const float s_lo = v0 + g8 < V ? scale[v0 + g8] : 0.f;
    const float s_hi = v0 + g8 + 8 < V ? scale[v0 + g8 + 8] : 0.f;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    for (int blk = 0; blk < n_blocks; blk += 2) {
      step(fa, blk);
      step(fb, blk + 1);
    }
    wg_wait<0>();
#pragma unroll
    for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");

    // rows g8 (acc[4j], acc[4j + 1]) and g8 + 8 (acc[4j + 2], acc[4j + 3])
    // at batch rows 8j + 2t, 8j + 2t + 1
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      tile[8 * j + 2 * t][g8] = acc[4 * j] * s_lo;
      tile[8 * j + 2 * t + 1][g8] = acc[4 * j + 1] * s_lo;
      tile[8 * j + 2 * t][g8 + 8] = acc[4 * j + 2] * s_hi;
      tile[8 * j + 2 * t + 1][g8 + 8] = acc[4 * j + 3] * s_hi;
    }
    __syncwarp();
    const int v = v0 + 4 * t;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int b = 8 * j + g8;
      if (b >= B) continue;
      const float4 x = *reinterpret_cast<const float4*>(&tile[b][4 * t]);
      float* o = out + (long long)b * V + v;
      if (vec && v + 3 < V) {
        *reinterpret_cast<float4*>(o) = x;
      } else {
        if (v < V) o[0] = x.x;
        if (v + 1 < V) o[1] = x.y;
        if (v + 2 < V) o[2] = x.z;
        if (v + 3 < V) o[3] = x.w;
      }
    }
    __syncwarp();
  }
}

template <typename TH, int N>
int launch(const CUtensorMap& tw, const TH* h, const float* scale,
           float* out, int B, int D, int V, cudaStream_t stream) {
  constexpr int MINB = N <= 16 ? 2 : 1;
  auto kernel = int8_matvec_wgmma<TH, N, MINB>;
  const size_t smem = h_offset<N>() + 2 * (size_t)N * pad_d(D) + 1024;
  static size_t allowed = 0, occ_smem = 0;
  static int occ = 0;
  if (smem > allowed) {
    const cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  if (smem != occ_smem) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, kernel, kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    occ_smem = smem;
  }
  if (occ < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int units = (V + kRows - 1) / kRows;
  const int grid = min((units + kGroups - 1) / kGroups, sms * min(occ, 2));
  kernel<<<grid, kThreads, smem, stream>>>(tw, h, scale, out, B, D, V);
  return (int)cudaGetLastError();
}

template <typename TH>
int launch_n(int n, const CUtensorMap& tw, const TH* h, const float* scale,
             float* out, int B, int D, int V, cudaStream_t stream) {
  switch (n) {
    case 8: return launch<TH, 8>(tw, h, scale, out, B, D, V, stream);
    case 16: return launch<TH, 16>(tw, h, scale, out, B, D, V, stream);
    case 32: return launch<TH, 32>(tw, h, scale, out, B, D, V, stream);
    default: return launch<TH, 64>(tw, h, scale, out, B, D, V, stream);
  }
}

// shared memory a CTA asks for with n batch rows of h
size_t smem_for(int n, int D) {
  const size_t hb = 2 * (size_t)n * pad_d(D) + 1024;
  switch (n) {
    case 8: return h_offset<8>() + hb;
    case 16: return h_offset<16>() + hb;
    case 32: return h_offset<32>() + hb;
    default: return h_offset<64>() + hb;
  }
}

}  // namespace

// h [B, D] (h_dtype 0 = float32, 1 = bfloat16; 16-byte aligned), wq
// int8 [V, D] with D a multiple of 64 and a 16-byte aligned base, scale
// f32 [V], out f32 [B, V]. Rows of h run in chunks of up to 64 (fewer
// where their bf16 copy would not fit in shared memory), one launch a
// chunk. Returns a cudaError_t, or kEncodeError + a CUresult when the
// table's tensor map cannot be encoded.
extern "C" int int8_matvec_launch(const void* h, const void* wq,
                                  const void* scale, void* out, int B, int D,
                                  int V, int h_dtype, void* stream) {
  if (B <= 0 || V <= 0) return 0;
  if (D <= 0 || D % kBlock || (h_dtype != 0 && h_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encode_fn();
  if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tw;
  const int rc = encode_2d(&tw, enc, wq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, D,
                           V, D, kBlock, kRows);
  if (rc) return rc;
  int dev = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int c0 = 0; c0 < B;) {
    const int rows = B - c0;
    int n = rows <= 8 ? 8 : rows <= 16 ? 16 : rows <= 32 ? 32 : 64;
    while (n > 8 && smem_for(n, D) > (size_t)max_smem) n /= 2;
    const int bc = min(rows, n);
    float* o = static_cast<float*>(out) + (long long)c0 * V;
    const int r =
        h_dtype == 0
            ? launch_n(n, tw, static_cast<const float*>(h) + (long long)c0 * D,
                       s, o, bc, D, V, st)
            : launch_n(n, tw,
                       static_cast<const __nv_bfloat16*>(h) +
                           (long long)c0 * D,
                       s, o, bc, D, V, st);
    if (r) return r;
    c0 += bc;
  }
  return 0;
}

extern "C" const char* int8_matvec_error_string(int code) {
  static char buf[96];
  if (code >= kEncodeError) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed (CUresult %d)",
             code - kEncodeError);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
