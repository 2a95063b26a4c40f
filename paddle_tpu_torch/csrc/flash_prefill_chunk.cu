// flash_prefill_chunk — one request's chunked-prefill attention over the
// paged KV arenas.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_decode.py::
// flash_prefill_chunk (registry name "flash_prefill_chunk").
//
// The chunk's C queries sit at positions p0..p0+C-1 (p0 is a runtime
// value and need not be a multiple of bs: a prefix-cache hit resumes
// anywhere; it comes as an argument or, for the serving engine's
// captured chunk, as an int32 read from device memory, on which the
// grid does not depend). Query row i of head n attends causally to keys
// 0..min(p0+i, mb*bs-1), key j living in physical block table_row[j/bs],
// row j % bs, columns n*H..n*H+H of the [num_blocks, bs, N*H] arenas:
//   out[i, n*H:(n+1)*H] = softmax_j(q_i·k_j / sqrt(H)) · v_j
//
// What bounds it: latency and launch, not FLOPs or bytes. At the serving
// shape (C 128, 12 heads of 64, p0 128) the call is ~75 MFLOP over ~1.2
// MB, microseconds of either at the card's rates; what costs is how many
// SMs take part and how long each one's chain of dependent loads and
// products is.
//
// bf16 design:
// - The work split. A warp owns 16 query rows of one head; a CTA of four
//   warps owns one (head, 16-row group), so C 128 gives 12 x 8 = 96 CTAs
//   on the 132 SMs (one per SM, no second wave). The four warps split
//   the group's keys: warp w takes the 16-key steps w, w + 4, w + 8, ...
//   up to the group's last key, so at p0 384 (32 steps) each walks eight
//   instead of one warp walking 32. The four (m, l, acc) partials merge
//   in f32 in shared memory, in warp order (deterministic). A split on
//   the grid (more CTAs, a second pass) would add a launch to a kernel
//   whose cost is launch and latency.
// - The tensor cores. S = Q K^T and O += P V are mma.sync.m16n8k16 bf16
//   -> f32 (K fragments by ldmatrix, V by ldmatrix.trans), Q's A
//   fragments in registers for the whole walk. wgmma's 64-row tiles
//   would need 64 rows of one head a CTA: 24 CTAs at C 128, the grid
//   this design replaces; 16 rows a warp is what fills the SMs here.
// - The pages. Each lane resolves its key rows through table_row and
//   copies 16-byte pieces of K and V with cp.async into the warp's own
//   double-buffered ring (bf16, rows padded by 16 bytes so ldmatrix is
//   free of bank conflicts): step i + 1's pages are in flight while
//   step i is computed. No CTA-wide barrier inside the walk.
// - Masks. A step is masked only if it crosses the last key of the
//   group's first row; keys past the group's last key are zero-filled.
//   Warp 0 always walks key 0, which every row sees, so the merged
//   running max is finite; a warp whose keys a row cannot see keeps
//   m = -inf, l = 0 for it and gets weight 0 in the merge. Rows past
//   mb*bs - 1 clamp to the last key. Padded rows past the request's real
//   tokens read whatever the null block holds, which the engine keeps
//   finite; the caller discards their outputs.
// - Rounding. P is rounded to bf16 before the PV product, as the JAX
//   fallback rounds its probabilities to q's dtype.
// Registers and shared memory: ptxas (CUDA 12.9, sm_90a) gives 96
// registers at H 64 and 166 at H 128, no spills; the ring is 4 warps x 2
// stages x (K, V) x 16 x (H + 8) bf16 = 36,864 bytes (H 64) or 69,632
// (H 128), reused by the merge, plus 512 bytes of (m, l).
//
// f32 (`--dtype float32` serving and the kernel checks): one CTA per
// (head, 64 query rows), one thread per row with q and its accumulator
// in registers, walking the logical blocks in order with K and V staged
// in shared memory as f32 and an online softmax per 8-key sub-tile (the
// CUDA cores; TF32 would change the result).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16: tensor cores over a per-warp cp.async ring
// ---------------------------------------------------------------------------

constexpr int kRowsBf16 = 16;   // query rows a CTA (one mma row tile)
constexpr int kWarps = 4;       // warps a CTA, splitting the keys
constexpr int kStep = 16;       // keys a step

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when `src_bytes` is 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int H>
__global__ void __launch_bounds__(kWarps * 32)
flash_prefill_mma(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k_pages,
                  const __nv_bfloat16* __restrict__ v_pages,
                  const int* __restrict__ table_row,
                  __nv_bfloat16* __restrict__ out, int C, int n_heads,
                  int bs, int mb, int p0_arg, const int* __restrict__ p0_dev,
                  float scale_log2) {
  // the chunk's first position: the host's value, or read from device
  // memory (a captured step replays with the position it finds there)
  const int p0 = p0_dev != nullptr ? *p0_dev : p0_arg;
  constexpr int LD = H + 8;                    // padded row, bf16
  constexpr int kMat = kStep * LD;             // one K or V step
  constexpr int kRing = 2 * 2 * kMat;          // 2 stages x (K, V)
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  float* ml = reinterpret_cast<float*>(smem + kWarps * kRing * 2);
  const int n = blockIdx.x, r0 = blockIdx.y * kRowsBf16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long nh = (long long)n_heads * H;
  const int last_key = mb * bs - 1;
  // the last key of the group's first and last rows
  const int first_last = min(p0 + r0, last_key);
  const int group_last = min(p0 + min(r0 + kRowsBf16, C) - 1, last_key);
  const int n_steps = group_last / kStep + 1;
  const int my_steps = n_steps > warp ? (n_steps - warp - 1) / kWarps + 1
                                      : 0;
  __nv_bfloat16* my = ring + warp * kRing;

  // Q's A fragments: rows r0 + g, r0 + g + 8
  uint32_t qf[H / 16][4];
  const int ra = r0 + g, rb = ra + 8;
  const __nv_bfloat16* qa = q + ra * nh + (long long)n * H;
  const __nv_bfloat16* qb = q + rb * nh + (long long)n * H;
#pragma unroll
  for (int kc = 0; kc < H / 16; ++kc) {
    const int c = kc * 16 + 2 * t;
    qf[kc][0] = ra < C ? ld32(qa + c) : 0u;
    qf[kc][1] = rb < C ? ld32(qb + c) : 0u;
    qf[kc][2] = ra < C ? ld32(qa + c + 8) : 0u;
    qf[kc][3] = rb < C ? ld32(qb + c + 8) : 0u;
  }
  // each row's last key
  const int lk[2] = {min(p0 + ra, last_key), min(p0 + rb, last_key)};

  // step i's 16 keys (K and V rows of head n) into ring stage i & 1
  auto load = [&](int i) {
    const int j0 = (warp + kWarps * i) * kStep;
    __nv_bfloat16* kd = my + (i & 1) * 2 * kMat;
    __nv_bfloat16* vd = kd + kMat;
#pragma unroll
    for (int c = lane; c < kStep * H / 8; c += 32) {
      const int row = c / (H / 8), col = (c % (H / 8)) * 8;
      const int j = j0 + row;
      const bool ok = j <= group_last;
      const long long src =
          ok ? ((long long)table_row[j / bs] * bs + j % bs) * nh +
                   (long long)n * H + col
             : 0;
      cp_async16(kd + row * LD + col, k_pages + src, ok ? 16 : 0);
      cp_async16(vd + row * LD + col, v_pages + src, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  float acc[H / 8][4];
#pragma unroll
  for (int d = 0; d < H / 8; ++d)
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  if (my_steps > 0) load(0);
#pragma unroll 1
  for (int i = 0; i < my_steps; ++i) {
    const int j0 = (warp + kWarps * i) * kStep;
    if (i + 1 < my_steps) {
      load(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const __nv_bfloat16* ks = my + (i & 1) * 2 * kMat;
    const __nv_bfloat16* vs = ks + kMat;
    // S = Q K^T over 16 keys: two n-tiles of 8
    float s[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
    for (int kc = 0; kc < H / 16; ++kc) {
      uint32_t b[4];
      ldmatrix_x4(b, ks + ((mi >> 1) * 8 + mr) * LD + kc * 16 + (mi & 1) * 8);
      mma(s[0], qf[kc], b[0], b[1]);
      mma(s[1], qf[kc], b[2], b[3]);
    }
    // online softmax in base 2; a step crossing the first row's last
    // key is masked per element
    const bool masked = j0 + kStep - 1 > first_last;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int nt = e >> 1, key = j0 + nt * 8 + 2 * t + (e & 1);
        x[e] = s[nt][2 * h + (e & 1)] * scale_log2;
        if (masked && key > lk[h]) x[e] = -INFINITY;
      }
      float mx = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      // a row that has seen no key yet keeps m = -inf: use 0 as the
      // reference so that no -inf - -inf appears
      const float ref = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[h] - ref);
      m[h] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[e] = exp2f(x[e] - ref);
        rs += x[e];
      }
      l[h] = l[h] * alpha + rs;
#pragma unroll
      for (int d = 0; d < H / 8; ++d) {
        acc[d][2 * h] *= alpha;
        acc[d][2 * h + 1] *= alpha;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s[e >> 1][2 * h + (e & 1)] = x[e];
    }
    // O += P V: P (16 rows x 16 keys) as one A fragment, rounded to bf16
    const uint32_t pa[4] = {pack_f32(s[0][0], s[0][1]),
                            pack_f32(s[0][2], s[0][3]),
                            pack_f32(s[1][0], s[1][1]),
                            pack_f32(s[1][2], s[1][3])};
#pragma unroll
    for (int dn = 0; dn < H / 16; ++dn) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vs + ((mi & 1) * 8 + mr) * LD + dn * 16 +
                               (mi >> 1) * 8);
      mma(acc[2 * dn], pa, b[0], b[1]);
      mma(acc[2 * dn + 1], pa, b[2], b[3]);
    }
    __syncwarp();               // stage i & 1 is consumed
  }

  // merge the four warps' partials: (m, l) per row, then acc scaled by
  // exp2(m_w - M) / L into the warp's own ring, summed in warp order
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (t == 0) {
      ml[(warp * kRowsBf16 + g + 8 * h) * 2] = m[h];
      ml[(warp * kRowsBf16 + g + 8 * h) * 2 + 1] = l[h];
    }
  }
  __syncthreads();
  float f[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = g + 8 * h;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      M = fmaxf(M, ml[(w * kRowsBf16 + row) * 2]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = ml[(w * kRowsBf16 + row) * 2];
      L += (mw == -INFINITY ? 0.f : exp2f(mw - M)) *
           ml[(w * kRowsBf16 + row) * 2 + 1];
    }
    f[h] = (m[h] == -INFINITY ? 0.f : exp2f(m[h] - M)) / L;
  }
  float* part = reinterpret_cast<float*>(my);   // [16][H] f32
#pragma unroll
  for (int d = 0; d < H / 8; ++d) {
    const int c = d * 8 + 2 * t;
    *reinterpret_cast<float2*>(part + g * H + c) =
        make_float2(acc[d][0] * f[0], acc[d][1] * f[0]);
    *reinterpret_cast<float2*>(part + (g + 8) * H + c) =
        make_float2(acc[d][2] * f[1], acc[d][3] * f[1]);
  }
  __syncthreads();
  for (int e = threadIdx.x * 8; e < kRowsBf16 * H; e += kWarps * 32 * 8) {
    const int row = e / H, col = e % H;
    if (r0 + row >= C) continue;
    float o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* pw =
          reinterpret_cast<const float*>(ring + w * kRing) + e;
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] += pw[i];
    }
    uint4 v;
    v.x = pack_f32(o[0], o[1]);
    v.y = pack_f32(o[2], o[3]);
    v.z = pack_f32(o[4], o[5]);
    v.w = pack_f32(o[6], o[7]);
    *reinterpret_cast<uint4*>(out + (r0 + row) * nh + (long long)n * H +
                              col) = v;
  }
}

template <int H>
int launch_bf16(const void* q, const void* k_pages, const void* v_pages,
                const int* table_row, void* out, int C, int n_heads, int bs,
                int mb, int p0, const int* p0_dev, float scale,
                cudaStream_t stream) {
  const size_t smem = (size_t)kWarps * 2 * 2 * kStep * (H + 8) * 2 +
                      kWarps * kRowsBf16 * 2 * sizeof(float);
  static bool ready = false;
  if (!ready && smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_mma<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ready = true;
  flash_prefill_mma<H><<<dim3(n_heads, (C + kRowsBf16 - 1) / kRowsBf16),
                         kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pages),
      static_cast<const __nv_bfloat16*>(v_pages), table_row,
      static_cast<__nv_bfloat16*>(out), C, n_heads, bs, mb, p0, p0_dev,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, one thread per query row
// ---------------------------------------------------------------------------

constexpr int kRows = 64;     // query rows per CTA, one thread each
constexpr int kSub = 8;       // keys per online-softmax update

template <int H>
__global__ void __launch_bounds__(kRows)
flash_prefill_f32(const float* __restrict__ q,
                  const float* __restrict__ k_pages,
                  const float* __restrict__ v_pages,
                  const int* __restrict__ table_row, float* __restrict__ out,
                  int C, int n_heads, int bs, int mb, int p0_arg,
                  const int* __restrict__ p0_dev, float scale) {
  const int p0 = p0_dev != nullptr ? *p0_dev : p0_arg;
  extern __shared__ float smem_f32[];
  float* ks = smem_f32;         // [bs][H]
  float* vs = smem_f32 + bs * H;    // [bs][H]
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
    qv[d] = live ? q[r * nh + (long long)n * H + d] : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int b = 0; b < n_blocks; ++b) {
    const long long base =
        (long long)table_row[b] * bs * nh + (long long)n * H;
    __syncthreads();            // the previous block's rows are consumed
    for (int i = threadIdx.x; i < bs * H; i += kRows) {
      const long long off = base + (long long)(i / H) * nh + (i % H);
      ks[i] = k_pages[off];
      vs[i] = v_pages[off];
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
    float* o = out + r * nh + (long long)n * H;
#pragma unroll
    for (int d = 0; d < H; ++d) o[d] = acc[d] * inv;
  }
}

template <int H>
int launch_f32(const void* q, const void* k_pages, const void* v_pages,
               const int* table_row, void* out, int C, int n_heads, int bs,
               int mb, int p0, const int* p0_dev, float scale,
               cudaStream_t stream) {
  flash_prefill_f32<H><<<dim3(n_heads, (C + kRows - 1) / kRows), kRows,
                         2 * (size_t)bs * H * sizeof(float), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pages),
      static_cast<const float*>(v_pages), table_row,
      static_cast<float*>(out), C, n_heads, bs, mb, p0, p0_dev, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim 64 or 128; bs a multiple of
// 8. f32 needs 2*bs*head_dim*4 bytes of shared memory within the 48 KB
// static limit (the wrapper checks). `p0_dev`, when not null, points at
// the chunk's first position as an int32 in device memory and takes the
// place of `p0`: the grid does not depend on it, so a captured chunk
// replays at whatever position the device buffer holds. Returns a
// cudaError_t.
extern "C" int flash_prefill_chunk_launch(const void* q, const void* k_pages,
                                          const void* v_pages,
                                          const void* table_row, void* out,
                                          int C, int n_heads, int head_dim,
                                          int bs, int mb, int p0,
                                          const void* p0_dev, int dtype,
                                          float scale, void* stream) {
  const int* tab = static_cast<const int*>(table_row);
  const int* pd = static_cast<const int*>(p0_dev);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return launch_f32<64>(q, k_pages, v_pages, tab, out, C, n_heads, bs, mb,
                          p0, pd, scale, st);
  if (dtype == 0 && head_dim == 128)
    return launch_f32<128>(q, k_pages, v_pages, tab, out, C, n_heads, bs,
                           mb, p0, pd, scale, st);
  if (dtype == 1 && head_dim == 64)
    return launch_bf16<64>(q, k_pages, v_pages, tab, out, C, n_heads, bs,
                           mb, p0, pd, scale, st);
  if (dtype == 1 && head_dim == 128)
    return launch_bf16<128>(q, k_pages, v_pages, tab, out, C, n_heads, bs,
                            mb, p0, pd, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_prefill_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
