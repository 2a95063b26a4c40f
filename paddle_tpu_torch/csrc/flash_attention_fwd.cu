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
// per byte: on the H100 the two bounds are within 15 % of each other
// (0.039 ms of bf16 tensor-core time, 0.045 ms of memory time).
//
// bf16 design (fwd_wgmma, the building blocks in hopper.cuh):
// - One CTA per (64 query rows, b·n): one consumer warpgroup and one
//   producer warp, 160 threads. The query tiles of one (b, n) are
//   neighbours in the launch order, so its K and V cross the HBM once
//   and are re-read from the L2; within a (b, n) the causal tiles
//   launch longest first.
// - The producer loads the CTA's Q once by TMA (4-D maps over the
//   strided views, 64 x 64 boxes in 128-byte swizzle) and streams the
//   64-key K and V tiles the CTA's rows can see into a ring of ST stages
//   (a full mbarrier completed by the TMA bytes, an empty one each
//   consumer warp arrives on once its warpgroup's reads are done).
// - S = Q K^T is wgmma.m64n64k16 with both operands in shared memory (K
//   is K-major); O += P V takes P as the register A operand (the S
//   accumulator rounded to bf16, as the TPU kernel rounds P) and V
//   MN-major through the descriptor's transpose bit.
// - Inside a warpgroup, tile i's S = Q K_i^T and tile i-1's O += P V_{i-1}
//   are issued together, the softmax of S_i runs while the second product
//   is on the tensor cores, and O is rescaled once that product is done.
// - The online softmax runs in the exp2 domain with scale·log2(e)
//   applied once to S (ex2.approx); the running max starts at -1e30.
//   Only the tiles that cross the diagonal, and the tile holding key
//   sk - 1, take the per-element mask: masked scores become -inf, so
//   their p is exactly 0. The TMA zero-fills key rows past sk, so the
//   last tile needs that mask: a zero row would score 0. Query rows past
//   sq (zero-filled) compute finite values nobody stores.
// - lse is the natural log, m·ln(2) + log(l), as the backward reads it.
// Instances: H 64: ST 4, three CTAs an SM (127 registers, 74,824 bytes
// of dynamic shared memory a CTA, 1,024 of it alignment slack); H 128:
// ST 2, two CTAs an SM (142 registers). Measured against this design on
// the H100 and slower: two or three consumer warpgroups a CTA sharing
// each K/V tile (one CTA an SM), 128-key tiles (m64n128k16); level: Q
// as register A operands, a TMA store of O. What holds it back
// (clock64 in a development build): most of a tile's time is the
// consumer's softmax and the products' bookkeeping, issued in turn,
// and little is spent waiting for TMA or the tensor cores; moving half
// of the exponentials to the FMA pipe ran slower, so the special-
// function unit is not the limit. FlashAttention-3's scheduling of two
// warpgroups against each other is the known remedy.
//
// f32 design (parity runs only): one thread per query row, its q row in
// padded shared memory, its f32 accumulator in registers, 32-key tiles,
// scalar FMA.
#include <math.h>
#include <stdio.h>

#include "hopper.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kTile = 64;       // query rows of a warpgroup, keys a tile
constexpr int kF32Keys = 32;    // keys a tile (f32)

struct Shape {
  int b, sq, sk, n;
  long long q_sb, q_ss, q_sn, k_sb, k_ss, k_sn, v_sb, v_ss, v_sn;
  int causal;
  float scale;
};

// keys [0, end) that some row of the query tile [q0, q0 + rows) sees
__device__ __forceinline__ int key_end(const Shape& sh, int q0, int rows) {
  if (!sh.causal) return sh.sk;
  const int last = min(q0 + rows - 1, sh.sq - 1) + (sh.sk - sh.sq);
  return min(last, sh.sk - 1) + 1;
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA
// ---------------------------------------------------------------------------

template <int H, int ST>
struct FwdSmem {
  __nv_bfloat16 q[H / 64][kPanel];
  __nv_bfloat16 k[ST][H / 64][kPanel], v[ST][H / 64][kPanel];
  uint64_t q_bar, full[ST], empty[ST];
};

template <int H, int ST, int MINB>
__global__ void __launch_bounds__(160, MINB)
fwd_wgmma(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
          Shape sh) {
  constexpr int NP = H / 64;
  constexpr uint32_t kStageBytes = 2 * NP * kPanelBytes;
  auto& S = smem_at_1024<FwdSmem<H, ST>>();
  const int bn = blockIdx.y, bi = bn / sh.n, ni = bn % sh.n;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int off = sh.sk - sh.sq;
  const int n_tiles = (key_end(sh, q0, kTile) + kTile - 1) / kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(&S.q_bar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&S.full[s], 1);
      mbar_init(&S.empty[s], 4);          // every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {                    // producer: one lane issues TMA
    if (lane == 0) {
      mbar_expect_tx(&S.q_bar, NP * kPanelBytes);
      for (int p = 0; p < NP; ++p)
        tma_load(S.q[p], &tq, &S.q_bar, 64 * p, ni, q0, bi);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % ST, k0 = it * kTile;
        if (it >= ST) mbar_wait(&S.empty[s], ((it / ST) & 1) ^ 1);
        mbar_expect_tx(&S.full[s], kStageBytes);
        for (int p = 0; p < NP; ++p) {
          tma_load(S.k[s][p], &tk, &S.full[s], 64 * p, ni, k0, bi);
          tma_load(S.v[s][p], &tv, &S.full[s], 64 * p, ni, k0, bi);
        }
      }
    }
    return;
  }

  // the consumer warpgroup: warp w owns query rows r0 = q0 + 16w + g
  // and r0 + 8 (h = 0, 1 below)
  const int w = warp;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 16 * w + g;
  const float sl2 = sh.scale * kLog2e;
  // a stage is released once per warp: its wgmma reads are complete
  // for the whole warpgroup once each thread has passed wg_wait
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&S.empty[st]);
  };
  float o[NP][32], s[32], m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  uint32_t pa[4][4];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] = 0.f;
  // S = Q K^T of stage st, both operands K-major in shared memory
  auto qk = [&](int st) {
#pragma unroll
    for (int kc = 0; kc < H / 16; ++kc)
      wgmma_ss(s, desc_sw128(S.q[kc / 4], kKMajor) + 2 * (kc % 4),
               desc_sw128(S.k[st][kc / 4], kKMajor) + 2 * (kc % 4), kc);
    wg_commit();
  };
  // O += P V of stage st: P the register A operand, V MN-major
  auto pv = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < NP; ++p)
        wgmma_rs_t(o[p], pa[kk], desc_sw128(S.v[st][p], kMNMajor) + 128 * kk);
    wg_commit();
  };
  // S of key tile `it` -> P in place (exp2 domain, masked p exactly 0),
  // the running max and sum updated; alpha rescales what O held. Row
  // h's values are s[4j + 2h], s[4j + 2h + 1] at columns 8j + 2t (+1).
  auto softmax = [&](int it, float (&alpha)[2]) {
    const int k0 = it * kTile;
    const bool masked = (sh.causal && k0 + kTile - 1 > q0 + off) ||
                        k0 + kTile > sh.sk;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * sl2;
      if (masked) {
        const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
        if (col >= sh.sk ||
            (sh.causal && col > r0 + 8 * ((i >> 1) & 1) + off))
          x = -INFINITY;
      }
      s[i] = x;
    }
    // pairwise maxima and sums, so the dependent chains stay short
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        x[j] = fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]);
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = fmaxf(x[j], x[j + 4]);
      float mx = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
      // the 4 threads of a quad share a row
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[h], mx);
      alpha[h] = ex2(m[h] - mn);
      m[h] = mn;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i)
      s[i] = ex2(s[i] - m[(i >> 1) & 1]);     // -inf -> 0
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        x[j] = s[4 * j + 2 * h] + s[4 * j + 2 * h + 1];
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] += x[j + 4];
      l[h] = l[h] * alpha[h] + ((x[0] + x[1]) + (x[2] + x[3]));
    }
  };
  float alpha[2];
  mbar_wait(&S.q_bar, 0);
  mbar_wait(&S.full[0], 0);
  fence_acc(s);
  wg_fence();
  qk(0);
  wg_wait<0>();
  fence_acc(s);
  softmax(0, alpha);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) acc_to_a(pa[kk], s, kk);
  // tile it's S = Q K^T and tile it-1's O += P V are issued together;
  // the softmax of S runs while the second product is in flight
#pragma unroll 1
  for (int it = 1; it < n_tiles; ++it) {
    const int st = it % ST, prev = (it - 1) % ST;
    mbar_wait(&S.full[st], (it / ST) & 1);
    fence_acc(s);
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_acc(o[p]);
    wg_fence();
    qk(st);
    pv(prev);
    wg_wait<1>();
    fence_acc(s);
    softmax(it, alpha);
    wg_wait<0>();
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_acc(o[p]);
    release(prev);
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[p][i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(pa[kk], s, kk);
  }
  {                                   // the last tile's O += P V
    const int st = (n_tiles - 1) % ST;
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_acc(o[p]);
    wg_fence();
    pv(st);
    wg_wait<0>();
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_acc(o[p]);
    release(st);
  }

  const long long rs = (long long)sh.n * H;     // out row stride
  __nv_bfloat16* ob = out + (long long)bi * sh.sq * rs + (long long)ni * H;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = r0 + 8 * h;
    if (r >= sh.sq) continue;
    const float ll = l[h] == 0.f ? 1.f : l[h], inv = 1.f / ll;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(ob + r * rs + 64 * p + 8 * j + 2 * t) =
            pack_f32(o[p][4 * j + 2 * h] * inv, o[p][4 * j + 2 * h + 1] * inv);
    if (t == 0) lse[(long long)bn * sh.sq + r] = m[h] * kLn2 + logf(ll);
  }
}

// ---------------------------------------------------------------------------
// f32 (parity runs)
// ---------------------------------------------------------------------------

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
  cudaError_t e = allow_smem(fwd_f32<H>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((sh.sq + kTile - 1) / kTile, sh.b * sh.n);
  fwd_f32<H><<<grid, kTile, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, sh);
  return (int)cudaGetLastError();
}

template <int H, int ST, int MINB>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, const Shape& sh, cudaStream_t st) {
  const EncodeTiled enc = encode_fn();
  if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  int rc = encode_rows(&tq, enc, q, H, sh.n, sh.sq, sh.b, sh.q_sb, sh.q_ss,
                       sh.q_sn);
  if (!rc) rc = encode_rows(&tk, enc, k, H, sh.n, sh.sk, sh.b, sh.k_sb,
                            sh.k_ss, sh.k_sn);
  if (!rc) rc = encode_rows(&tv, enc, v, H, sh.n, sh.sk, sh.b, sh.v_sb,
                            sh.v_ss, sh.v_sn);
  if (rc) return rc;
  const size_t smem = sizeof(FwdSmem<H, ST>) + 1024;
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = allow_smem(fwd_wgmma<H, ST, MINB>, smem);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  fwd_wgmma<H, ST, MINB><<<dim3((sh.sq + kTile - 1) / kTile, sh.b * sh.n),
                           160, smem, st>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, sh);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim 64 or 128. Strides are in
// elements (b, s, n of each input; the H axis must be unit-stride and,
// for bf16, rows and bases 16-byte aligned with strides falling from
// the batch axis to the head axis — the wrapper checks). Causal needs
// sk >= sq. Launches on `stream`; returns a cudaError_t, or
// kEncodeError + a CUresult when a tensor map cannot be encoded.
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
  if (dtype == 1 && head_dim == 64) return launch_bf16<64, 4, 3>(q, k, v, out, l, sh, st);
  if (dtype == 1 && head_dim == 128) return launch_bf16<128, 2, 2>(q, k, v, out, l, sh, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_fwd_error_string(int code) {
  static char buf[96];
  if (code >= kEncodeError) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed (CUresult %d)",
             code - kEncodeError);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
