// flash_attention_bwd — attention backward from the forward's lse, for
// the training step.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas_attention.py::
// _flash_bwd_merged (rectangular grid, whole-slice dq accumulator),
// ::_flash_bwd_merged_tri (triangle grid) and ::_flash_bwd (split dkv +
// dq, above the dq-scratch cap); registry name "flash_bwd".
//
// Inputs q [b, sq, n, H], k/v [b, sk, n, H], out and dout [b, sq, n, H]
// are read through their strides (unit stride along H); lse is f32
// [b*n, sq]; dq, dk, dv are contiguous and typed like the inputs. With
// P = exp(S - lse), S = q·k·scale (masked as in the forward) and
// delta = rowsum(dO * O):
//   dV = P^T dO,  dS = P ∘ (dO V^T − delta),  dQ = dS K·scale,
//   dK = dS^T Q·scale.
//
// What bounds it: at the training shape (b 24, s 1024, 12 heads of 64,
// causal) the backward does ~97 GFLOP against ~300 MB: the tensor cores
// set the bound. Three kernels run on one stream:
//
// - bwd_delta: delta[bn, i] = sum_h dO·O in f32, H/8 lanes per row, one
//   16-byte load of each input a lane and a shuffle reduction; reads dO
//   and O once (~75 MB at the training shape, bound by bytes).
// - dkdv_wgmma: one CTA per (b·n, 64·NC keys), the longest (key tile 0
//   when causal) launched first. NC consumer warpgroups each own 64 keys;
//   one producer warp feeds them. The CTA's K and V tiles are loaded once
//   by TMA and stay in shared memory; the producer streams the Q and dO
//   tiles that see the keys through a ring of ST stages (TMA into
//   128-byte-swizzled 64 x 64 panels, completion on an mbarrier, a
//   stage freed by an mbarrier every consumer thread arrives on) and
//   writes each tile's lse·log2(e) and delta beside them. The NC
//   consumers share each streamed tile, so Q and dO cross the L2 once
//   per 64·NC keys. Per tile a consumer issues S^T = K Q^T and
//   dP^T = V dO^T as wgmma.m64n64k16 with both operands in shared
//   memory (K-major), forms P^T and dS^T in registers (the accumulator
//   fragment of a 64 x 64 wgmma is, 16 columns at a time, the register
//   A fragment of the next), rounds them to bf16 and issues
//   dV += P^T dO and dK += dS^T Q with the register A operand and dO,
//   Q read MN-major through the descriptor's transpose bit.
// - dq_wgmma: the same skeleton with NC x 64 queries of Q and dO
//   resident and K, V streamed: S = Q K^T, dP = dO V^T recomputed,
//   dQ += dS K.
//
// The causal mask is applied only on tiles that cross the diagonal
// (some key > some query + offset); tiles wholly masked for the whole
// CTA are never loaded, and a consumer skips the shared tiles wholly
// masked for its own rows. Ragged edges need no mask: TMA zero-fills
// rows past sq or sk, and a query row past sq gets lse = +inf, so its P
// is 0. Every output element is written by one CTA, with no atomics and
// no dq scratch: the result is deterministic. P and dS are rounded to
// bf16 before their products, as the TPU kernel does. Cost: S and dP are
// computed in both kernels (7 products per visible tile pair where 5 are
// needed). What holds it back (H100, 700 W): each consumer runs its
// tile's products, its exponentials and its conversions one after the
// other, and registers (dK, dV, S and dP take 128 a thread) leave two
// consumer warpgroups an SM for dK/dV, three for dQ, to overlap them.
// Issuing tile i + 1's S and dP before tile i's gradient products, so
// that the exponentials overlap them, needs the packed P and dS of tile
// i live beside S and dP of tile i + 1; ptxas then serializes the wgmma
// for lack of registers (also with setmaxnreg giving the consumers 232),
// and the backward ran slower than this design.
//
// The tensor maps are 4-D over (H, n, s, b) with the views' byte
// strides, encoded on the host for each call through
// cudaGetDriverEntryPoint("cuTensorMapEncodeTiled"), so the library
// needs no -lcuda; head_dim 128 loads two 64-column panels per tile.
// These building blocks (mbarriers, TMA, wgmma, the maps) live in
// hopper.cuh, which the forward shares.
// Instances: H 64: ST 4, NC 2 (dK/dV) and 3 (dQ), one CTA an SM; H 128:
// ST 2, NC 1. Dynamic shared memory a CTA (1,024 bytes of it alignment
// slack): H 64: 101,448 (dkdv) and 115,784 (dq); H 128: 100,392 and
// 99,368. ptxas (CUDA 12.9, sm_90a): 166 (dkdv) and 127 (dq) registers
// at H 64, 236 and 166 at H 128, 24 for bwd_delta; no spills.
//
// The f32 instances (parity runs only) give one thread a key row (dkdv)
// or a query row (dq) and use scalar FMA.
#include <math.h>
#include <stdio.h>

#include "hopper.cuh"

namespace {

constexpr int kTile = 64;       // rows of every tile (keys or queries)
constexpr int kF32Step = 32;    // rows of the walked tile (f32)

struct Shape {
  int b, sq, sk, n;
  long long q_sb, q_ss, q_sn, k_sb, k_ss, k_sn, v_sb, v_ss, v_sn,
      o_sb, o_ss, o_sn,         // o_*: dout strides
      y_sb, y_ss, y_sn;         // y_*: out strides
  int causal;
  float scale;
};

// ---------------------------------------------------------------------------
// delta = rowsum(dO * O)
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ float dot16(const uint4& a, const uint4& b);

template <>
__device__ __forceinline__ float dot16<float>(const uint4& a,
                                              const uint4& b) {
  const float* x = reinterpret_cast<const float*>(&a);
  const float* y = reinterpret_cast<const float*>(&b);
  return (x[0] * y[0] + x[1] * y[1]) + (x[2] * y[2] + x[3] * y[3]);
}

template <>
__device__ __forceinline__ float dot16<__nv_bfloat16>(const uint4& a,
                                                      const uint4& b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), v = __bfloat1622float2(y[i]);
    s += u.x * v.x + u.y * v.y;
  }
  return s;
}

// grid (b*n, row blocks); H / (16 / sizeof(T)) lanes per (b, s, n) row
template <typename T, int H>
__global__ void __launch_bounds__(256)
bwd_delta(const T* __restrict__ dout, const T* __restrict__ out,
          float* __restrict__ delta, Shape sh) {
  constexpr int kVec = 16 / sizeof(T), kLanes = H / kVec,
                kRows = 256 / kLanes;
  const int bn = blockIdx.x, bi = bn / sh.n, ni = bn % sh.n;
  const int s = blockIdx.y * kRows + threadIdx.x / kLanes;
  const int part = threadIdx.x % kLanes;
  float acc = 0.f;
  if (s < sh.sq) {
    const uint4 a = *reinterpret_cast<const uint4*>(
        dout + bi * sh.o_sb + s * sh.o_ss + ni * sh.o_sn + part * kVec);
    const uint4 c = *reinterpret_cast<const uint4*>(
        out + bi * sh.y_sb + s * sh.y_ss + ni * sh.y_sn + part * kVec);
    acc = dot16<T>(a, c);
  }
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (part == 0 && s < sh.sq) delta[(long long)bn * sh.sq + s] = acc;
}

template <typename T, int H>
int launch_delta(const T* dout, const T* out, float* delta, const Shape& sh,
                 cudaStream_t st) {
  constexpr int kRows = 256 / (H / (16 / (int)sizeof(T)));
  bwd_delta<T, H><<<dim3(sh.b * sh.n, (sh.sq + kRows - 1) / kRows), 256, 0,
                    st>>>(dout, out, delta, sh);
  return (int)cudaGetLastError();
}

// rows row0 + g (+ 8) of a warp's 16 x 64 slice of an accumulator (times
// mul) into columns col0.. of a contiguous [rows, n*H] output
template <int H>
__device__ __forceinline__ void store_acc(__nv_bfloat16* base, int row0,
                                          int rows, int n, int col0,
                                          const float (&d)[32], float mul) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long rs = (long long)n * H;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = row0 + g + 8 * ((i >> 1) & 1);
    const int c = col0 + 8 * (i >> 2) + 2 * t;
    if (r < rows)
      *reinterpret_cast<uint32_t*>(base + r * rs + c) =
          pack_f32(d[i] * mul, d[i + 1] * mul);
  }
}

template <int H, int ST, int NC>
struct DkdvSmem {
  __nv_bfloat16 k[NC][H / 64][kPanel], v[NC][H / 64][kPanel];
  __nv_bfloat16 q[ST][H / 64][kPanel], o[ST][H / 64][kPanel];
  float lse2[ST][kTile], dl[ST][kTile];
  uint64_t kv_bar, full[ST], empty[ST];
};

template <int H, int ST, int NC>
struct DqSmem {
  __nv_bfloat16 q[NC][H / 64][kPanel], o[NC][H / 64][kPanel];
  __nv_bfloat16 k[ST][H / 64][kPanel], v[ST][H / 64][kPanel];
  uint64_t qo_bar, full[ST], empty[ST];
};

// ---------------------------------------------------------------------------
// bf16: dK, dV
// ---------------------------------------------------------------------------

template <int H, int ST, int NC>
__global__ void __launch_bounds__(128 * NC + 32, NC == 1 && H == 64 ? 2 : 1)
dkdv_wgmma(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv,
           const __grid_constant__ CUtensorMap to,
           const float* __restrict__ lse, const float* __restrict__ delta,
           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
           Shape sh) {
  constexpr int NP = H / 64;
  constexpr uint32_t kStageBytes = 2 * NP * kPanelBytes;
  auto& S = smem_at_1024<DkdvSmem<H, ST, NC>>();
  const int bn = blockIdx.x, bi = bn / sh.n, ni = bn % sh.n;
  const int k0 = blockIdx.y * kTile * NC;  // causal: low key tiles work most
  const int off = sh.sk - sh.sq;
  const int qt0 = sh.causal ? max(0, k0 - off) / kTile : 0;
  const int n_tiles = (sh.sq + kTile - 1) / kTile - qt0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(&S.kv_bar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&S.full[s], 33);      // the TMA issuer + 32 lse writers
      mbar_init(&S.empty[s], 128 * NC);   // every consumer thread
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * NC) {               // producer
    if (lane == 0) {
      mbar_expect_tx(&S.kv_bar, NC * kStageBytes);
      for (int c = 0; c < NC; ++c)
        for (int p = 0; p < NP; ++p) {
          tma_load(S.k[c][p], &tk, &S.kv_bar, 64 * p, ni, k0 + 64 * c, bi);
          tma_load(S.v[c][p], &tv, &S.kv_bar, 64 * p, ni, k0 + 64 * c, bi);
        }
    }
    const float* lb = lse + (long long)bn * sh.sq;
    const float* db = delta + (long long)bn * sh.sq;
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % ST, q0 = (qt0 + it) * kTile;
      if (it >= ST) mbar_wait(&S.empty[s], ((it / ST) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(&S.full[s], kStageBytes);
        for (int p = 0; p < NP; ++p) {
          tma_load(S.q[s][p], &tq, &S.full[s], 64 * p, ni, q0, bi);
          tma_load(S.o[s][p], &to, &S.full[s], 64 * p, ni, q0, bi);
        }
      }
      for (int i = lane; i < kTile; i += 32) {
        const int r = q0 + i;
        S.lse2[s][i] = r < sh.sq ? lb[r] * kLog2e : INFINITY;
        S.dl[s][i] = r < sh.sq ? db[r] : 0.f;
      }
      mbar_arrive(&S.full[s]);
    }
    return;
  }

  // consumer c: warp w of it owns keys kc0 + 16w .. kc0 + 16w + 15
  const int c = warp >> 2, w = warp & 3;
  const int kc0 = k0 + kTile * c;
  const int g = lane >> 2, t = lane & 3;
  const float sl2 = sh.scale * kLog2e;
  float dka[NP][32], dva[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[p][i] = dva[p][i] = 0.f;
  mbar_wait(&S.kv_bar, 0);
#pragma unroll 1
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % ST, q0 = (qt0 + it) * kTile;
    mbar_wait(&S.full[s], (it / ST) & 1);
    // a tile this consumer's keys cannot see (the CTA's first keys can),
    // or keys wholly past sk
    if ((sh.causal && kc0 > q0 + kTile - 1 + off) || kc0 >= sh.sk) {
      mbar_arrive(&S.empty[s]);
      continue;
    }
    float st[32], dp[32];
    // S^T = K Q^T and dP^T = V dO^T, both operands K-major in smem
    fence_acc(st);
    fence_acc(dp);
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < H / 16; ++kc)
      wgmma_ss(st, desc_sw128(S.k[c][kc / 4], kKMajor) + 2 * (kc % 4),
                  desc_sw128(S.q[s][kc / 4], kKMajor) + 2 * (kc % 4), kc);
    wg_commit();
#pragma unroll
    for (int kc = 0; kc < H / 16; ++kc)
      wgmma_ss(dp, desc_sw128(S.v[c][kc / 4], kKMajor) + 2 * (kc % 4),
                  desc_sw128(S.o[s][kc / 4], kKMajor) + 2 * (kc % 4), kc);
    wg_commit();
    wg_wait<1>();
    fence_acc(st);
    // P^T: rows are keys, columns queries; mask only across the diagonal
    const bool diag = sh.causal && kc0 + kTile - 1 > q0 + off;
    const int kr = kc0 + 16 * w + g;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qc = 8 * j + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(&S.lse2[s][qc]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(st[4 * j + e] * sl2 - ((e & 1) ? l2.y : l2.x));
        if (diag && kr + 8 * (e >> 1) > q0 + qc + (e & 1) + off) p = 0.f;
        st[4 * j + e] = p;
      }
    }
    wg_wait<0>();
    fence_acc(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d2 =
          *reinterpret_cast<const float2*>(&S.dl[s][8 * j + 2 * t]);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * j + e] = st[4 * j + e] * (dp[4 * j + e] -
                                         ((e & 1) ? d2.y : d2.x));
    }
    uint32_t pa[4][4], sa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      acc_to_a(pa[kk], st, kk);
      acc_to_a(sa[kk], dp, kk);
    }
    // dV += P^T dO and dK += dS^T Q: dO and Q MN-major (transposed)
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      fence_acc(dva[p]);
      fence_acc(dka[p]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        wgmma_rs_t(dva[p], pa[kk],
                    desc_sw128(S.o[s][p], kMNMajor) + 128 * kk);
        wgmma_rs_t(dka[p], sa[kk],
                    desc_sw128(S.q[s][p], kMNMajor) + 128 * kk);
      }
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      fence_acc(dva[p]);
      fence_acc(dka[p]);
    }
    mbar_arrive(&S.empty[s]);
  }
  const long long base = (long long)bi * sh.sk * sh.n * H + (long long)ni * H;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    store_acc<H>(dk + base, kc0 + 16 * w, sh.sk, sh.n, 64 * p, dka[p],
                 sh.scale);
    store_acc<H>(dv + base, kc0 + 16 * w, sh.sk, sh.n, 64 * p, dva[p], 1.f);
  }
}

// ---------------------------------------------------------------------------
// bf16: dQ
// ---------------------------------------------------------------------------

template <int H, int ST, int NC>
__global__ void __launch_bounds__(128 * NC + 32, NC == 1 && H == 64 ? 2 : 1)
dq_wgmma(const __grid_constant__ CUtensorMap tq,
         const __grid_constant__ CUtensorMap tk,
         const __grid_constant__ CUtensorMap tv,
         const __grid_constant__ CUtensorMap to,
         const float* __restrict__ lse, const float* __restrict__ delta,
         __nv_bfloat16* __restrict__ dq, Shape sh) {
  constexpr int NP = H / 64;
  constexpr uint32_t kStageBytes = 2 * NP * kPanelBytes;
  auto& S = smem_at_1024<DqSmem<H, ST, NC>>();
  const int bn = blockIdx.x, bi = bn / sh.n, ni = bn % sh.n;
  // long tiles first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile * NC;
  const int off = sh.sk - sh.sq;
  const int kend = sh.causal
      ? min(min(q0 + kTile * NC - 1, sh.sq - 1) + off, sh.sk - 1) + 1
      : sh.sk;
  const int n_tiles = (kend + kTile - 1) / kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(&S.qo_bar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&S.full[s], 1);
      mbar_init(&S.empty[s], 128 * NC);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * NC) {               // producer: one lane issues TMA
    if (lane == 0) {
      mbar_expect_tx(&S.qo_bar, NC * kStageBytes);
      for (int c = 0; c < NC; ++c)
        for (int p = 0; p < NP; ++p) {
          tma_load(S.q[c][p], &tq, &S.qo_bar, 64 * p, ni, q0 + 64 * c, bi);
          tma_load(S.o[c][p], &to, &S.qo_bar, 64 * p, ni, q0 + 64 * c, bi);
        }
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

  // consumer c: warp w of it owns queries qc0 + 16w .. qc0 + 16w + 15
  const int c = warp >> 2, w = warp & 3;
  const int qc0 = q0 + kTile * c;
  const int g = lane >> 2, t = lane & 3;
  const float sl2 = sh.scale * kLog2e;
  const int r0 = qc0 + 16 * w + g;
  const long long lrow = (long long)bn * sh.sq;
  float l2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    l2[h] = r < sh.sq ? lse[lrow + r] * kLog2e : INFINITY;
    dl[h] = r < sh.sq ? delta[lrow + r] : 0.f;
  }
  float dqa[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[p][i] = 0.f;
  mbar_wait(&S.qo_bar, 0);
#pragma unroll 1
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % ST, k0 = it * kTile;
    mbar_wait(&S.full[s], (it / ST) & 1);
    // a key tile past this consumer's queries (the CTA's last ones see
    // it), or queries wholly past sq
    if ((sh.causal && k0 > qc0 + kTile - 1 + off) || qc0 >= sh.sq) {
      mbar_arrive(&S.empty[s]);
      continue;
    }
    float sc[32], dp[32];
    fence_acc(sc);
    fence_acc(dp);
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < H / 16; ++kc)
      wgmma_ss(sc, desc_sw128(S.q[c][kc / 4], kKMajor) + 2 * (kc % 4),
                  desc_sw128(S.k[s][kc / 4], kKMajor) + 2 * (kc % 4), kc);
    wg_commit();
#pragma unroll
    for (int kc = 0; kc < H / 16; ++kc)
      wgmma_ss(dp, desc_sw128(S.o[c][kc / 4], kKMajor) + 2 * (kc % 4),
                  desc_sw128(S.v[s][kc / 4], kKMajor) + 2 * (kc % 4), kc);
    wg_commit();
    wg_wait<1>();
    fence_acc(sc);
    const bool diag = sh.causal && k0 + kTile - 1 > qc0 + off;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(sc[4 * j + e] * sl2 - l2[e >> 1]);
        if (diag && k0 + 8 * j + 2 * t + (e & 1) > r0 + 8 * (e >> 1) + off)
          p = 0.f;
        sc[4 * j + e] = p;
      }
    wg_wait<0>();
    fence_acc(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      dp[i] = sc[i] * (dp[i] - dl[(i >> 1) & 1]);
    uint32_t sa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(sa[kk], dp, kk);
    // dQ += dS K: K MN-major (transposed)
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_acc(dqa[p]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < NP; ++p)
        wgmma_rs_t(dqa[p], sa[kk],
                    desc_sw128(S.k[s][p], kMNMajor) + 128 * kk);
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_acc(dqa[p]);
    mbar_arrive(&S.empty[s]);
  }
  const long long base = (long long)bi * sh.sq * sh.n * H + (long long)ni * H;
#pragma unroll
  for (int p = 0; p < NP; ++p)
    store_acc<H>(dq + base, qc0 + 16 * w, sh.sq, sh.n, 64 * p, dqa[p],
                 sh.scale);
}

// ---------------------------------------------------------------------------
// f32 (parity runs)
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool visible(const Shape& sh, int qi, int kj) {
  return qi < sh.sq && kj < sh.sk &&
         (!sh.causal || kj <= qi + (sh.sk - sh.sq));
}

// f32, dkdv: one thread per key row of the CTA's 64-key tile; its K and
// V rows in padded shared memory, its dK and dV in registers
template <int H>
__global__ void __launch_bounds__(kTile)
dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
         const float* __restrict__ v, const float* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ delta,
         float* __restrict__ dk, float* __restrict__ dv, Shape sh) {
  constexpr int PLD = H + 1;
  extern __shared__ float smem[];
  float* kS = smem;                     // [64][H + 1]
  float* vS = kS + kTile * PLD;         // [64][H + 1]
  float* qS = vS + kTile * PLD;         // [32][H]
  float* oS = qS + kF32Step * H;        // [32][H]
  float* lS = oS + kF32Step * H;        // [32]
  float* dS = lS + kF32Step;            // [32]
  const int bn = blockIdx.y, bi = bn / sh.n, ni = bn % sh.n;
  const int k0 = blockIdx.x * kTile;
  const int key = k0 + threadIdx.x;
  const float* qb = q + bi * sh.q_sb + ni * sh.q_sn;
  const float* ob = dout + bi * sh.o_sb + ni * sh.o_sn;
  const float* kb = k + bi * sh.k_sb + ni * sh.k_sn;
  const float* vb = v + bi * sh.v_sb + ni * sh.v_sn;
  for (int i = threadIdx.x; i < kTile * H; i += kTile) {
    const int row = i / H, col = i % H;
    const bool in = k0 + row < sh.sk;
    kS[row * PLD + col] = in ? kb[(k0 + row) * sh.k_ss + col] : 0.f;
    vS[row * PLD + col] = in ? vb[(k0 + row) * sh.v_ss + col] : 0.f;
  }
  const float* kr = kS + threadIdx.x * PLD;
  const float* vr = vS + threadIdx.x * PLD;
  float dka[H], dva[H];
#pragma unroll
  for (int d = 0; d < H; ++d) dka[d] = dva[d] = 0.f;
  const int qfirst = sh.causal ? max(0, k0 - (sh.sk - sh.sq)) : 0;
  for (int q0 = qfirst / kF32Step * kF32Step; q0 < sh.sq; q0 += kF32Step) {
    __syncthreads();
    for (int i = threadIdx.x; i < kF32Step * H; i += kTile) {
      const int row = i / H, col = i % H;
      const bool in = q0 + row < sh.sq;
      qS[i] = in ? qb[(q0 + row) * sh.q_ss + col] : 0.f;
      oS[i] = in ? ob[(q0 + row) * sh.o_ss + col] : 0.f;
    }
    for (int i = threadIdx.x; i < kF32Step; i += kTile) {
      const bool in = q0 + i < sh.sq;
      lS[i] = in ? lse[(long long)bn * sh.sq + q0 + i] : 0.f;
      dS[i] = in ? delta[(long long)bn * sh.sq + q0 + i] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < kF32Step; ++i) {
      if (!visible(sh, q0 + i, key)) continue;
      const float* qi = qS + i * H;
      const float* oi = oS + i * H;
      float s = 0.f, dpv = 0.f;
#pragma unroll
      for (int d = 0; d < H; ++d) {
        s += qi[d] * kr[d];
        dpv += oi[d] * vr[d];
      }
      const float p = expf(s * sh.scale - lS[i]);
      const float ds = p * (dpv - dS[i]);
#pragma unroll
      for (int d = 0; d < H; ++d) {
        dva[d] += p * oi[d];
        dka[d] += ds * qi[d];
      }
    }
  }
  if (key < sh.sk) {
    const long long o = ((long long)bi * sh.sk + key) * sh.n * H +
                        (long long)ni * H;
#pragma unroll
    for (int d = 0; d < H; ++d) {
      dk[o + d] = dka[d] * sh.scale;
      dv[o + d] = dva[d];
    }
  }
}

// f32, dq: one thread per query row; its q and dO rows in padded shared
// memory, its dQ in registers
template <int H>
__global__ void __launch_bounds__(kTile)
dq_f32(const float* __restrict__ q, const float* __restrict__ k,
       const float* __restrict__ v, const float* __restrict__ dout,
       const float* __restrict__ lse, const float* __restrict__ delta,
       float* __restrict__ dq, Shape sh) {
  constexpr int PLD = H + 1;
  extern __shared__ float smem[];
  float* qS = smem;                     // [64][H + 1]
  float* oS = qS + kTile * PLD;         // [64][H + 1]
  float* kS = oS + kTile * PLD;         // [32][H]
  float* vS = kS + kF32Step * H;        // [32][H]
  const int bn = blockIdx.y, bi = bn / sh.n, ni = bn % sh.n;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int r = q0 + threadIdx.x;
  const float* qb = q + bi * sh.q_sb + ni * sh.q_sn;
  const float* ob = dout + bi * sh.o_sb + ni * sh.o_sn;
  const float* kb = k + bi * sh.k_sb + ni * sh.k_sn;
  const float* vb = v + bi * sh.v_sb + ni * sh.v_sn;
  for (int i = threadIdx.x; i < kTile * H; i += kTile) {
    const int row = i / H, col = i % H;
    const bool in = q0 + row < sh.sq;
    qS[row * PLD + col] = in ? qb[(q0 + row) * sh.q_ss + col] : 0.f;
    oS[row * PLD + col] = in ? ob[(q0 + row) * sh.o_ss + col] : 0.f;
  }
  const float* qr = qS + threadIdx.x * PLD;
  const float* orow = oS + threadIdx.x * PLD;
  const long long lrow = (long long)bn * sh.sq;
  const float lr = r < sh.sq ? lse[lrow + r] : 0.f;
  const float dl = r < sh.sq ? delta[lrow + r] : 0.f;
  float dqa[H];
#pragma unroll
  for (int d = 0; d < H; ++d) dqa[d] = 0.f;
  int kend = sh.sk;
  if (sh.causal)
    kend = min(min(q0 + kTile - 1, sh.sq - 1) + (sh.sk - sh.sq), sh.sk - 1) + 1;
  for (int k0 = 0; k0 < kend; k0 += kF32Step) {
    __syncthreads();
    for (int i = threadIdx.x; i < kF32Step * H; i += kTile) {
      const int row = i / H, col = i % H;
      const bool in = k0 + row < sh.sk;
      kS[i] = in ? kb[(k0 + row) * sh.k_ss + col] : 0.f;
      vS[i] = in ? vb[(k0 + row) * sh.v_ss + col] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < kF32Step; ++j) {
      if (!visible(sh, r, k0 + j)) continue;
      const float* kj = kS + j * H;
      const float* vj = vS + j * H;
      float s = 0.f, dpv = 0.f;
#pragma unroll
      for (int d = 0; d < H; ++d) {
        s += qr[d] * kj[d];
        dpv += orow[d] * vj[d];
      }
      const float ds = expf(s * sh.scale - lr) * (dpv - dl);
#pragma unroll
      for (int d = 0; d < H; ++d) dqa[d] += ds * kj[d];
    }
  }
  if (r < sh.sq) {
    float* o = dq + ((long long)bi * sh.sq + r) * sh.n * H + (long long)ni * H;
#pragma unroll
    for (int d = 0; d < H; ++d) o[d] = dqa[d] * sh.scale;
  }
}

template <int H>
int launch_f32(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* delta,
               float* dq, float* dk, float* dv, const Shape& sh,
               cudaStream_t st) {
  const size_t smem =
      (2 * kTile * (H + 1) + 2 * kF32Step * H + 2 * kF32Step) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      dkdv_f32<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        dq_f32<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dkdv_f32<H><<<dim3((sh.sk + kTile - 1) / kTile, sh.b * sh.n), kTile, smem,
                 st>>>(q, k, v, dout, lse, delta, dk, dv, sh);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dq_f32<H><<<dim3((sh.sq + kTile - 1) / kTile, sh.b * sh.n), kTile, smem,
               st>>>(q, k, v, dout, lse, delta, dq, sh);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <int H, int ST, int NKV, int NQ>
int launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                const __nv_bfloat16* v, const __nv_bfloat16* out,
                const __nv_bfloat16* dout, const float* lse, float* delta,
                __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv,
                const Shape& sh, cudaStream_t st) {
  const EncodeTiled enc = encode_fn();
  if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv, to;
  int rc = encode_rows(&tq, enc, q, H, sh.n, sh.sq, sh.b, sh.q_sb, sh.q_ss,
                       sh.q_sn);
  if (!rc) rc = encode_rows(&tk, enc, k, H, sh.n, sh.sk, sh.b, sh.k_sb,
                            sh.k_ss, sh.k_sn);
  if (!rc) rc = encode_rows(&tv, enc, v, H, sh.n, sh.sk, sh.b, sh.v_sb,
                            sh.v_ss, sh.v_sn);
  if (!rc) rc = encode_rows(&to, enc, dout, H, sh.n, sh.sq, sh.b, sh.o_sb,
                            sh.o_ss, sh.o_sn);
  if (rc) return rc;
  const size_t kv_smem = sizeof(DkdvSmem<H, ST, NKV>) + 1024;
  const size_t q_smem = sizeof(DqSmem<H, ST, NQ>) + 1024;
  static bool ready = false;
  if (!ready) {
    cudaError_t e = allow_smem(dkdv_wgmma<H, ST, NKV>, kv_smem);
    if (e == cudaSuccess) e = allow_smem(dq_wgmma<H, ST, NQ>, q_smem);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  rc = launch_delta<__nv_bfloat16, H>(dout, out, delta, sh, st);
  if (rc) return rc;
  const int kv_rows = kTile * NKV, q_rows = kTile * NQ;
  dkdv_wgmma<H, ST, NKV><<<dim3(sh.b * sh.n, (sh.sk + kv_rows - 1) / kv_rows),
                           128 * NKV + 32, kv_smem, st>>>(
      tq, tk, tv, to, lse, delta, dk, dv, sh);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dq_wgmma<H, ST, NQ><<<dim3(sh.b * sh.n, (sh.sq + q_rows - 1) / q_rows),
                        128 * NQ + 32, q_smem, st>>>(tq, tk, tv, to, lse,
                                                     delta, dq, sh);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim 64 or 128. Strides are in
// elements (b, s, n of q, k, v, dout and out; the H axis unit-stride,
// rows and bases 16-byte aligned — the wrapper checks). Causal needs
// sk >= sq. `delta` is f32 [b*n, sq] scratch the launch fills. Launches
// the three kernels on `stream`; returns a cudaError_t, or
// kEncodeError + a CUresult when a tensor map cannot be encoded.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int b, int sq, int sk, int n, int head_dim, long long q_sb,
    long long q_ss, long long q_sn, long long k_sb, long long k_ss,
    long long k_sn, long long v_sb, long long v_ss, long long v_sn,
    long long o_sb, long long o_ss, long long o_sn, long long y_sb,
    long long y_ss, long long y_sn, int causal, int dtype, float scale,
    void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || n <= 0) return 0;
  const Shape sh{b, sq, sk, n, q_sb, q_ss, q_sn, k_sb, k_ss, k_sn,
                 v_sb, v_ss, v_sn, o_sb, o_ss, o_sn, y_sb, y_ss, y_sn,
                 causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0) {
    const float *qp = static_cast<const float*>(q),
                *kp = static_cast<const float*>(k),
                *vp = static_cast<const float*>(v),
                *yp = static_cast<const float*>(out),
                *op = static_cast<const float*>(dout);
    float *dqp = static_cast<float*>(dq), *dkp = static_cast<float*>(dk),
          *dvp = static_cast<float*>(dv);
    if (head_dim == 64) {
      const int rc = launch_delta<float, 64>(op, yp, dl, sh, st);
      return rc ? rc
                : launch_f32<64>(qp, kp, vp, op, l, dl, dqp, dkp, dvp, sh, st);
    }
    if (head_dim == 128) {
      const int rc = launch_delta<float, 128>(op, yp, dl, sh, st);
      return rc ? rc
                : launch_f32<128>(qp, kp, vp, op, l, dl, dqp, dkp, dvp, sh,
                                  st);
    }
  } else if (dtype == 1) {
    const __nv_bfloat16 *qp = static_cast<const __nv_bfloat16*>(q),
                        *kp = static_cast<const __nv_bfloat16*>(k),
                        *vp = static_cast<const __nv_bfloat16*>(v),
                        *yp = static_cast<const __nv_bfloat16*>(out),
                        *op = static_cast<const __nv_bfloat16*>(dout);
    __nv_bfloat16 *dqp = static_cast<__nv_bfloat16*>(dq),
                  *dkp = static_cast<__nv_bfloat16*>(dk),
                  *dvp = static_cast<__nv_bfloat16*>(dv);
    if (head_dim == 64)
      return launch_bf16<64, 4, 2, 3>(qp, kp, vp, yp, op, l, dl, dqp, dkp,
                                      dvp, sh, st);
    if (head_dim == 128)
      return launch_bf16<128, 2, 1, 1>(qp, kp, vp, yp, op, l, dl, dqp, dkp,
                                       dvp, sh, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  static char buf[96];
  if (code >= kEncodeError) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed (CUresult %d)",
             code - kEncodeError);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
