// flash_attention_bwd — attention backward from the forward's lse, for
// the training step.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas_attention.py::
// _flash_bwd_merged (rectangular grid, whole-slice dq accumulator),
// ::_flash_bwd_merged_tri (triangle grid) and ::_flash_bwd (split dkv +
// dq, above the dq-scratch cap); registry name "flash_bwd".
//
// Inputs q [b, sq, n, H], k/v [b, sk, n, H] and dout [b, sq, n, H] are
// read through their strides (unit stride along H); lse and
// delta = rowsum(dout * out) are f32 [b*n, sq]; dq, dk, dv are
// contiguous and typed like the inputs. With P = exp(S - lse),
// S = q·k·scale (masked as in the forward):
//   dV = P^T dO,  dS = P ∘ (dO V^T − delta),  dQ = dS K·scale,
//   dK = dS^T Q·scale.
//
// What bounds it: at the training shape (b 24, s 1024, 12 heads of 64,
// causal) the backward does ~97 GFLOP (five products per visible tile
// pair; the split below recomputes S and dP once more) against ~300 MB:
// the tensor cores set the bound.
//
// Design — the FlashAttention-2 split, two kernels on one stream:
// - dkdv: one CTA of 4 warps per (b·n, 64-key tile); each warp owns 16
//   keys, holds their K and V fragments in registers and accumulates dK
//   and dV in f32. The CTA walks the 64-query tiles that see its keys
//   (from the diagonal down, when causal), staging Q, dO, lse and delta
//   in shared memory, 16 queries per step: S^T = K Q^T and
//   dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q.
// - dq: one CTA of 4 warps per (b·n, 64-query tile); each warp owns 16
//   queries with their q and dO fragments; the CTA walks the key tiles
//   up to the diagonal, staging K and V: S = Q K^T, dP = dO V^T,
//   dQ += dS K.
// Every output element is written by one CTA, so there are no atomics
// and no scratch cap, and the result is deterministic. All products are
// mma.sync.m16n8k16 bf16 -> f32; P and dS are rounded to bf16 before
// their products, as the TPU kernel does. The f32 instances (parity
// runs only) give one thread a key row (dkdv) or a query row (dq) and
// use scalar FMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;       // rows of the CTA's own tile
constexpr int kF32Step = 32;    // rows of the walked tile (f32)

struct Shape {
  int b, sq, sk, n;
  long long q_sb, q_ss, q_sn, k_sb, k_ss, k_sn, v_sb, v_ss, v_sn,
      o_sb, o_ss, o_sn;         // o_*: dout strides
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

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ bool visible(const Shape& sh, int qi, int kj) {
  return qi < sh.sq && kj < sh.sk &&
         (!sh.causal || kj <= qi + (sh.sk - sh.sq));
}

// the A fragment (16 rows x 16 of k) of rows r0/r1 = base rows g, g + 8
template <int H>
__device__ __forceinline__ void load_frags(uint32_t f[H / 16][4],
                                           const __nv_bfloat16* base,
                                           long long stride, int r0, int r1,
                                           int rows, int t) {
#pragma unroll
  for (int kc = 0; kc < H / 16; ++kc) {
    const int c = kc * 16 + 2 * t;
    f[kc][0] = r0 < rows ? ld32(base + r0 * stride + c) : 0u;
    f[kc][1] = r1 < rows ? ld32(base + r1 * stride + c) : 0u;
    f[kc][2] = r0 < rows ? ld32(base + r0 * stride + c + 8) : 0u;
    f[kc][3] = r1 < rows ? ld32(base + r1 * stride + c + 8) : 0u;
  }
}

// stage rows [r0, r0 + 64) of a strided [rows, H] slice into smem with
// row pitch LD, zero past `rows`
template <int H, int LD>
__device__ __forceinline__ void stage(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src,
                                      long long stride, int r0, int rows) {
  for (int i = threadIdx.x; i < kTile * H / 8; i += blockDim.x) {
    const int row = i / (H / 8), col = (i % (H / 8)) * 8;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r0 + row < rows)
      x = *reinterpret_cast<const uint4*>(src + (r0 + row) * stride + col);
    *reinterpret_cast<uint4*>(dst + row * LD + col) = x;
  }
}

template <int H>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, int r0,
                                           int r1, int rows, int n,
                                           float acc[H / 8][4], float mul,
                                           int t) {
  const long long rs = (long long)n * H;
#pragma unroll
  for (int nh = 0; nh < H / 8; ++nh) {
    const int c = nh * 8 + 2 * t;
    if (r0 < rows)
      *reinterpret_cast<uint32_t*>(base + r0 * rs + c) =
          pack_f32(acc[nh][0] * mul, acc[nh][1] * mul);
    if (r1 < rows)
      *reinterpret_cast<uint32_t*>(base + r1 * rs + c) =
          pack_f32(acc[nh][2] * mul, acc[nh][3] * mul);
  }
}

template <int H>
__global__ void __launch_bounds__(128)
dkdv_bf16(const __nv_bfloat16* __restrict__ q,
          const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v,
          const __nv_bfloat16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
          Shape sh) {
  constexpr int LD = H + 8;
  __shared__ __align__(16) __nv_bfloat16 qs[kTile * LD];
  __shared__ __align__(16) __nv_bfloat16 ds_[kTile * LD];   // dO tile
  __shared__ float lse_s[kTile], dl_s[kTile];
  const int bn = blockIdx.y, bi = bn / sh.n, ni = bn % sh.n;
  const int k0 = blockIdx.x * kTile;    // causal: low key tiles work most
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kr0 = k0 + warp * 16 + g, kr1 = kr0 + 8;
  const __nv_bfloat16* qb = q + bi * sh.q_sb + ni * sh.q_sn;
  const __nv_bfloat16* ob = dout + bi * sh.o_sb + ni * sh.o_sn;
  const float* lb = lse + (long long)bn * sh.sq;
  const float* db = delta + (long long)bn * sh.sq;

  uint32_t kf[H / 16][4], vf[H / 16][4];
  load_frags<H>(kf, k + bi * sh.k_sb + ni * sh.k_sn, sh.k_ss, kr0, kr1,
                sh.sk, t);
  load_frags<H>(vf, v + bi * sh.v_sb + ni * sh.v_sn, sh.v_ss, kr0, kr1,
                sh.sk, t);
  float dka[H / 8][4], dva[H / 8][4];
#pragma unroll
  for (int nh = 0; nh < H / 8; ++nh)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nh][e] = dva[nh][e] = 0.f;

  // first query that sees key k0: k0 - (sk - sq) when causal
  const int qfirst = sh.causal ? max(0, k0 - (sh.sk - sh.sq)) : 0;
  for (int q0 = qfirst / kTile * kTile; q0 < sh.sq; q0 += kTile) {
    __syncthreads();
    stage<H, LD>(qs, qb, sh.q_ss, q0, sh.sq);
    stage<H, LD>(ds_, ob, sh.o_ss, q0, sh.sq);
    for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
      lse_s[i] = q0 + i < sh.sq ? lb[q0 + i] : 0.f;
      dl_s[i] = q0 + i < sh.sq ? db[q0 + i] : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int qc = 0; qc < kTile; qc += 16) {
      // S^T = K Q^T and dP^T = V dO^T over 16 queries (2 n-tiles)
      float st[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dp[j][e] = 0.f;
#pragma unroll
        for (int kc = 0; kc < H / 16; ++kc) {
          const __nv_bfloat16* qr = qs + (qc + j * 8 + g) * LD + kc * 16 + 2 * t;
          mma(st[j], kf[kc], ld32(qr), ld32(qr + 8));
          const __nv_bfloat16* orow =
              ds_ + (qc + j * 8 + g) * LD + kc * 16 + 2 * t;
          mma(dp[j], vf[kc], ld32(orow), ld32(orow + 8));
        }
      }
      // P^T and dS^T (rows: keys kr0 / kr1; columns: queries)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = qc + j * 8 + 2 * t + (e & 1);
          const bool ok = visible(sh, q0 + ql, e < 2 ? kr0 : kr1);
          const float p = ok ? __expf(st[j][e] * sh.scale - lse_s[ql]) : 0.f;
          st[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dl_s[ql]);
        }
      }
      const uint32_t pa[4] = {pack_f32(st[0][0], st[0][1]),
                              pack_f32(st[0][2], st[0][3]),
                              pack_f32(st[1][0], st[1][1]),
                              pack_f32(st[1][2], st[1][3])};
      const uint32_t sa[4] = {pack_f32(dp[0][0], dp[0][1]),
                              pack_f32(dp[0][2], dp[0][3]),
                              pack_f32(dp[1][0], dp[1][1]),
                              pack_f32(dp[1][2], dp[1][3])};
      // dV += P^T dO, dK += dS^T Q: B's k-pairs run down the query axis
#pragma unroll
      for (int nh = 0; nh < H / 8; ++nh) {
        const __nv_bfloat16* orow = ds_ + (qc + 2 * t) * LD + nh * 8 + g;
        mma(dva[nh], pa, pack_bf16(orow[0], orow[LD]),
            pack_bf16(orow[8 * LD], orow[9 * LD]));
        const __nv_bfloat16* qr = qs + (qc + 2 * t) * LD + nh * 8 + g;
        mma(dka[nh], sa, pack_bf16(qr[0], qr[LD]),
            pack_bf16(qr[8 * LD], qr[9 * LD]));
      }
    }
  }
  const long long base = (long long)bi * sh.sk * sh.n * H + (long long)ni * H;
  store_rows<H>(dk + base, kr0, kr1, sh.sk, sh.n, dka, sh.scale, t);
  store_rows<H>(dv + base, kr0, kr1, sh.sk, sh.n, dva, 1.f, t);
}

template <int H>
__global__ void __launch_bounds__(128)
dq_bf16(const __nv_bfloat16* __restrict__ q,
        const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v,
        const __nv_bfloat16* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        __nv_bfloat16* __restrict__ dq, Shape sh) {
  constexpr int LD = H + 8;
  __shared__ __align__(16) __nv_bfloat16 ks[kTile * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[kTile * LD];
  const int bn = blockIdx.y, bi = bn / sh.n, ni = bn % sh.n;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // long tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const __nv_bfloat16* kb = k + bi * sh.k_sb + ni * sh.k_sn;
  const __nv_bfloat16* vb = v + bi * sh.v_sb + ni * sh.v_sn;

  uint32_t qf[H / 16][4], of[H / 16][4];
  load_frags<H>(qf, q + bi * sh.q_sb + ni * sh.q_sn, sh.q_ss, r0, r1,
                sh.sq, t);
  load_frags<H>(of, dout + bi * sh.o_sb + ni * sh.o_sn, sh.o_ss, r0, r1,
                sh.sq, t);
  const long long lrow = (long long)bn * sh.sq;
  const float lse0 = r0 < sh.sq ? lse[lrow + r0] : 0.f;
  const float lse1 = r1 < sh.sq ? lse[lrow + r1] : 0.f;
  const float dl0 = r0 < sh.sq ? delta[lrow + r0] : 0.f;
  const float dl1 = r1 < sh.sq ? delta[lrow + r1] : 0.f;
  float dqa[H / 8][4];
#pragma unroll
  for (int nh = 0; nh < H / 8; ++nh)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[nh][e] = 0.f;

  int kend = sh.sk;
  if (sh.causal)
    kend = min(min(q0 + kTile - 1, sh.sq - 1) + (sh.sk - sh.sq), sh.sk - 1) + 1;
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    __syncthreads();
    stage<H, LD>(ks, kb, sh.k_ss, k0, sh.sk);
    stage<H, LD>(vs, vb, sh.v_ss, k0, sh.sk);
    __syncthreads();
#pragma unroll 1
    for (int kc4 = 0; kc4 < kTile && k0 + kc4 < kend; kc4 += 16) {
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
        for (int kc = 0; kc < H / 16; ++kc) {
          const __nv_bfloat16* kr = ks + (kc4 + j * 8 + g) * LD + kc * 16 + 2 * t;
          mma(s[j], qf[kc], ld32(kr), ld32(kr + 8));
          const __nv_bfloat16* vr = vs + (kc4 + j * 8 + g) * LD + kc * 16 + 2 * t;
          mma(dp[j], of[kc], ld32(vr), ld32(vr + 8));
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + kc4 + j * 8 + 2 * t + (e & 1);
          const bool ok = visible(sh, e < 2 ? r0 : r1, kj);
          const float p =
              ok ? __expf(s[j][e] * sh.scale - (e < 2 ? lse0 : lse1)) : 0.f;
          dp[j][e] = p * (dp[j][e] - (e < 2 ? dl0 : dl1));
        }
      }
      const uint32_t sa[4] = {pack_f32(dp[0][0], dp[0][1]),
                              pack_f32(dp[0][2], dp[0][3]),
                              pack_f32(dp[1][0], dp[1][1]),
                              pack_f32(dp[1][2], dp[1][3])};
      // dQ += dS K: B's k-pairs run down the key axis
#pragma unroll
      for (int nh = 0; nh < H / 8; ++nh) {
        const __nv_bfloat16* kr = ks + (kc4 + 2 * t) * LD + nh * 8 + g;
        mma(dqa[nh], sa, pack_bf16(kr[0], kr[LD]),
            pack_bf16(kr[8 * LD], kr[9 * LD]));
      }
    }
  }
  store_rows<H>(dq + (long long)bi * sh.sq * sh.n * H + (long long)ni * H,
                r0, r1, sh.sq, sh.n, dqa, sh.scale, t);
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

template <int H>
int launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                const __nv_bfloat16* v, const __nv_bfloat16* dout,
                const float* lse, const float* delta, __nv_bfloat16* dq,
                __nv_bfloat16* dk, __nv_bfloat16* dv, const Shape& sh,
                cudaStream_t st) {
  dkdv_bf16<H><<<dim3((sh.sk + kTile - 1) / kTile, sh.b * sh.n), 128, 0,
                  st>>>(q, k, v, dout, lse, delta, dk, dv, sh);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dq_bf16<H><<<dim3((sh.sq + kTile - 1) / kTile, sh.b * sh.n), 128, 0,
                st>>>(q, k, v, dout, lse, delta, dq, sh);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim 64 or 128. Strides are in
// elements (b, s, n of q, k, v and dout; the H axis unit-stride and, for
// bf16, rows 16-byte aligned — the wrapper checks). Causal needs
// sk >= sq. Launches both kernels on `stream`; returns a cudaError_t.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv,
    int b, int sq, int sk, int n, int head_dim, long long q_sb,
    long long q_ss, long long q_sn, long long k_sb, long long k_ss,
    long long k_sn, long long v_sb, long long v_ss, long long v_sn,
    long long o_sb, long long o_ss, long long o_sn, int causal, int dtype,
    float scale, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || n <= 0) return 0;
  const Shape sh{b, sq, sk, n, q_sb, q_ss, q_sn, k_sb, k_ss, k_sn,
                 v_sb, v_ss, v_sn, o_sb, o_ss, o_sn, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 0) {
    const float *qp = static_cast<const float*>(q),
                *kp = static_cast<const float*>(k),
                *vp = static_cast<const float*>(v),
                *op = static_cast<const float*>(dout);
    float *dqp = static_cast<float*>(dq), *dkp = static_cast<float*>(dk),
          *dvp = static_cast<float*>(dv);
    if (head_dim == 64)
      return launch_f32<64>(qp, kp, vp, op, l, dl, dqp, dkp, dvp, sh, st);
    if (head_dim == 128)
      return launch_f32<128>(qp, kp, vp, op, l, dl, dqp, dkp, dvp, sh, st);
  } else if (dtype == 1) {
    const __nv_bfloat16 *qp = static_cast<const __nv_bfloat16*>(q),
                        *kp = static_cast<const __nv_bfloat16*>(k),
                        *vp = static_cast<const __nv_bfloat16*>(v),
                        *op = static_cast<const __nv_bfloat16*>(dout);
    __nv_bfloat16 *dqp = static_cast<__nv_bfloat16*>(dq),
                  *dkp = static_cast<__nv_bfloat16*>(dk),
                  *dvp = static_cast<__nv_bfloat16*>(dv);
    if (head_dim == 64)
      return launch_bf16<64>(qp, kp, vp, op, l, dl, dqp, dkp, dvp, sh, st);
    if (head_dim == 128)
      return launch_bf16<128>(qp, kp, vp, op, l, dl, dqp, dkp, dvp, sh, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
