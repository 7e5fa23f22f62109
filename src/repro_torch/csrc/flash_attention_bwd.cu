// flash_attention_bwd: the gradient of flash_attention's forward
// (csrc/flash_attention.cu), fp32 or bf16 in, the input's type out.
//
// The TPU package has no backward kernel: its trainer differentiates the
// jnp attention (src/repro/lm/steps.py), and flash_attention_pallas
// (src/repro/kernels/flash_attention/flash_attention.py:77) is forward
// only.  The port runs attention through the forward kernel on the LM
// path, so training needs this.  For q (B, Hq, Sq, D), k, v (B, Hkv, Skv,
// D), query head h reading kv head h / (Hq / Hkv), the output o and its
// gradient dO, with s_ij = q_i . k_j / sqrt(D) over the visible keys (j <
// Skv, and with `causal` j <= i, the forward's top-left mask):
//
//     P_ij = exp(s_ij - LSE_i),   D_i = sum_d dO_id O_id,
//     dS_ij = P_ij (dO_i . v_j - D_i),
//     dq_i = sum_j dS_ij k_j / sqrt(D),
//     dk_j = sum_{i, heads of the group} dS_ij q_i / sqrt(D),
//     dv_j = sum_{i, heads of the group} P_ij dO_i.
//
// Two launches and no atomics, so two calls give the same bits:
//
// * dQ pass, a block per (b, hq, 64 query rows), 4 warps of 16 rows.
//   q and dO stay in shared memory; a first sweep over the kv tiles
//   rebuilds each row's log-sum-exp (the online max and sum of the
//   forward, in the log2 domain), a second computes S and dP = dO V^T,
//   dS, and dq += dS K.  LSE and D are written to scratch the wrapper
//   allocates (B * Hq * Sq floats each), which the second pass reads.
//   The LSE is recomputed rather than taken from the forward, so the
//   forward kernel stays as it is.
// * dK/dV pass, a block per (b, hkv, 64 keys): 4 warps of 16 key rows (8
//   at D > 128, two warps a row group, each owning half of D's
//   accumulator columns).  K and V stay in shared memory; the block loops
//   over the group's query heads and over the query tiles the mask lets
//   see its keys, and computes S^T = K q^T and dP^T = V dO^T with the keys
//   as rows, so P^T and dS^T are already the A operands (in registers) of
//   dv += P^T dO and dk += dS^T q.
//
// Every product runs on the tensor cores with warp-level mma.sync, with
// the fragment loads of the forward's `mma` route: fp32 in 3xTF32
// (csrc/tf32x3.cuh), bf16 as m16n8k16 with fp32 accumulators; P and dS
// pass from accumulator fragments to A fragments in registers, rounded to
// bf16 for bf16 inputs (as the forward rounds P before P V).  D is padded
// to DP = 64, 128 or 256 in shared memory and the products run over DP.
// Rows past Sq or Skv load as zero and are masked, so a ragged last tile
// gives P = 0 there.
//
// What bounds it on an H100: the five products of the gradient are 2.5x
// the forward's two (olmo-1b's layer, B = 2, H = 16, S = 2048, D = 128,
// causal: 8.6e10 flop, 0.087 ms at 989 bf16 TFLOP/s; three times that
// at the TF32 peak in 3xTF32).  This first version does eight: the dQ
// pass recomputes S for the LSE, and both passes compute S and dP.  Its
// tiles load synchronously (no copy overlaps a product), one block an SM
// in fp32.  Emitting the LSE from the forward, wgmma and a copy pipeline
// are later work (ROADMAP queue 2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tf32x3.cuh"

namespace {

constexpr int kDMax = 256;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a·b for one m16n8k16 tile, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void put2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void put2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Tiles for operand type T and padded width DP.  Every tile row is DP + 8
// elements long in shared memory (fp32: even, for load_a / load_bt's
// 8-byte loads; bf16: 16 bytes over, for ldmatrix).
template <typename T, int DP>
struct Cfg {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kLd = DP + 8;
  // dQ pass: 4 warps of 16 query rows against kv tiles of kBK keys
  static constexpr int kBQ = 64;
  static constexpr int kBK = DP == 256 ? 32 : 64;
  static constexpr int kQThreads = 128;
  static constexpr int kQBytes = (int)sizeof(T) * (2 * kBQ + 2 * kBK) * kLd;
  // dK/dV pass: 4 row groups of 16 keys against query tiles of kBQ2 rows;
  // at DP = 256 two warps a row group, each kDN accumulator columns
  static constexpr int kBKV = 64;
  static constexpr int kBQ2 = DP == 64 ? 64 : 32;
  static constexpr int kGroups = DP == 256 ? 2 : 1;
  static constexpr int kDN = DP / kGroups;
  static constexpr int kKVThreads = 128 * kGroups;
  static constexpr int kKVBytes =
      (int)sizeof(T) * (2 * kBKV + 2 * kBQ2) * kLd + 2 * kBQ2 * 4;
};

// Rows [0, ROWS) of a tile whose row r starts at src + r * D, columns
// [0, DP): rows at or past `valid` and columns at or past D are zero.
// vec: every row and src 16-byte aligned, copied 16 bytes a piece.
template <typename T, int ROWS, int DP, int THREADS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int valid,
                                          int D, int vec) {
  constexpr int kLd = DP + 8;
  if (vec) {
    constexpr int kPer = 16 / (int)sizeof(T), kCpr = DP / kPer;
#pragma unroll 4
    for (int e = threadIdx.x; e < ROWS * kCpr; e += THREADS) {
      const int r = e / kCpr, c = e % kCpr * kPer;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (r < valid && c < D)
        x = __ldg(reinterpret_cast<const uint4*>(src + (long long)r * D + c));
      *reinterpret_cast<uint4*>(dst + r * kLd + c) = x;
    }
  } else {
    using Bits = std::conditional_t<sizeof(T) == 4, uint32_t, uint16_t>;
    const Bits* s = reinterpret_cast<const Bits*>(src);
    Bits* d = reinterpret_cast<Bits*>(dst);
    for (int e = threadIdx.x; e < ROWS * DP; e += THREADS) {
      const int r = e / DP, c = e % DP;
      d[r * kLd + c] = r < valid && c < D ? s[(long long)r * D + c] : Bits(0);
    }
  }
}

// s (16 x NC) = A[row0, row0 + 16) · B^T over DP, A and B row-major tiles
// in shared memory (B's NC rows are s's columns).  Accumulator fragment of
// the m16n8 tile j, lane 4 g + t: s[j] = (g, 8 j + 2t), (g, 8 j + 2t + 1),
// (g + 8, 8 j + 2t), (g + 8, 8 j + 2t + 1).
template <typename T, int DP, int NC>
__device__ __forceinline__ void gemm_nt(float (&s)[NC / 8][4], const T* a,
                                        int row0, const T* b, int lane) {
  constexpr int kLd = DP + 8;
#pragma unroll
  for (int j = 0; j < NC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  if constexpr (sizeof(T) == 4) {
#pragma unroll 2
    for (int ks = 0; ks < DP / 8; ++ks) {
      const tf32x3::Frag<4> fa =
          tf32x3::load_a<true>(a, kLd, row0, 8 * ks, lane);
#pragma unroll
      for (int j = 0; j < NC / 8; ++j)
        tf32x3::mma3(s[j], fa,
                     tf32x3::load_bt<true>(b, kLd, 8 * j, 8 * ks, lane));
    }
  } else {
#pragma unroll 2
    for (int ks = 0; ks < DP / 16; ++ks) {
      uint32_t fa[4];
      ldsm_x4(fa, a + (row0 + (lane & 15)) * kLd + 16 * ks + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < NC / 16; ++jp) {
        uint32_t fb[4];
        ldsm_x4(fb, b + (16 * jp + (lane & 7) + (lane >> 4) * 8) * kLd +
                        16 * ks + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * jp], fa, fb[0], fb[1]);
        mma_bf16(s[2 * jp + 1], fa, fb[2], fb[3]);
      }
    }
  }
}

// acc (16 x NN) += p (16 x NK, in accumulator fragments) · B[:, col0,
// col0 + NN), B a row-major NK-row tile in shared memory.  An m16n8
// accumulator tile is, lane by lane, the A fragment of the next product
// (bf16: two tiles packed; fp32: keys 2t and 2t + 1 in slots t and t + 4,
// as tf32x3's loads permute k).
template <typename T, int DP, int NK, int NN>
__device__ __forceinline__ void gemm_pv(float (&acc)[NN / 8][4],
                                        const float (&p)[NK / 8][4],
                                        const T* b, int col0, int lane) {
  constexpr int kLd = DP + 8;
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int kk = 0; kk < NK / 8; ++kk) {
      const float pa[4] = {p[kk][0], p[kk][2], p[kk][1], p[kk][3]};
      tf32x3::Frag<4> a;
      tf32x3::split_fast(a, pa);
#pragma unroll
      for (int n = 0; n < NN / 8; ++n)
        tf32x3::mma3(acc[n], a, tf32x3::load_b<true>(b, kLd, 8 * kk,
                                                     col0 + 8 * n, lane));
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                             pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                             pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                             pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < NN / 16; ++np) {
        uint32_t fb[4];
        ldsm_x4_trans(fb, b + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  kLd +
                              col0 + 16 * np + (lane >> 4) * 8);
        mma_bf16(acc[2 * np], a, fb[0], fb[1]);
        mma_bf16(acc[2 * np + 1], a, fb[2], fb[3]);
      }
    }
  }
}

// rows row_lo + g, row_lo + g + 8 of a 16 x NN accumulator, times `mul`,
// into dst (rows of D elements) at columns col0 + ..., rows below `rows`
template <typename T, int NN>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[NN / 8][4],
                                           float mul, int row_lo, int rows,
                                           int col0, int D, int lane) {
  const int g = lane / 4, t = lane % 4;
  const bool pairs =
      D % 2 == 0 && reinterpret_cast<uintptr_t>(dst) % (2 * sizeof(T)) == 0;
#pragma unroll
  for (int n = 0; n < NN / 8; ++n) {
    const int col = col0 + 8 * n + 2 * t;
    if (col >= D) break;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_lo + g + 8 * i;
      if (row >= rows) continue;
      T* p = dst + (long long)row * D + col;
      const float x0 = acc[n][2 * i] * mul, x1 = acc[n][2 * i + 1] * mul;
      if (pairs) {
        put2(p, x0, x1);
      } else {
        put(p, x0);
        if (col + 1 < D) put(p + 1, x1);
      }
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(Cfg<T, DP>::kQThreads, 1)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ o,
              const T* __restrict__ dout, T* __restrict__ dq,
              float* __restrict__ lse, float* __restrict__ dsum, int Hq,
              int group, int Sq, int Skv, int D, float scale_log2,
              float scale, int causal, int vec) {
  using C = Cfg<T, DP>;
  constexpr int kLd = C::kLd, kBQ = C::kBQ, kBK = C::kBK;
  constexpr int kThreads = C::kQThreads;
  extern __shared__ __align__(16) uint8_t dq_smem[];
  T* qs = reinterpret_cast<T*>(dq_smem);
  T* dos = qs + kBQ * kLd;
  T* ks = dos + kBQ * kLd;
  T* vs = ks + kBK * kLd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x;                              // b * Hq + h
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;      // heavy tiles first
  const long long kvh =
      (long long)(bh / Hq) * (Hq / group) + (bh % Hq) / group;
  const long long base = (long long)bh * Sq + q0;         // row of (B*Hq*Sq)
  const T* kp = k + kvh * Skv * D;
  const T* vp = v + kvh * Skv * D;
  int n_kt = (Skv + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q0 + kBQ - 1) / kBK + 1);

  load_tile<T, kBQ, DP, kThreads>(qs, q + base * D, Sq - q0, D, vec);
  load_tile<T, kBQ, DP, kThreads>(dos, dout + base * D, Sq - q0, D, vec);
  __syncthreads();

  // D_i = dO_i . O_i for my 16 rows, one row at a time over the warp
  const int row_lo = q0 + 16 * warp;    // my rows: row_lo + g, row_lo + g + 8
  float di[2] = {0.f, 0.f};
  for (int r = 0; r < 16; ++r) {
    const bool in = row_lo + r < Sq;
    float acc = 0.f;
    if (in) {
      const T* orow = o + (base + 16 * warp + r) * D;
      const T* drow = dos + (16 * warp + r) * kLd;
      for (int c = lane; c < D; c += 32)
        acc += to_f32(drow[c]) * to_f32(orow[c]);
    }
    acc = warp_sum(acc);
    if (r == g) di[0] = acc;
    if (r == g + 8) di[1] = acc;
    if (lane == 0 && in) dsum[base + 16 * warp + r] = acc;
  }
  const bool live_rows = row_lo < Sq;

  // sweep 1: each row's max and sum of exp2 over its visible keys
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                    // the last tile read
    load_tile<T, kBK, DP, kThreads>(ks, kp + (long long)k0 * D, Skv - k0, D,
                                    vec);
    __syncthreads();
    if (!live_rows || (causal && k0 > row_lo + 15)) continue;
    float s[kBK / 8][4];
    gemm_nt<T, DP, kBK>(s, qs, 16 * warp, ks, lane);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        const int row = row_lo + g + 8 * (e >> 1);
        if (col >= Skv || (causal && col > row)) s[j][e] = -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float base2[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float mnew = fmaxf(m_run[i], mx[i] * scale_log2);
      base2[i] = mnew == -INFINITY ? 0.f : mnew;
      l_run[i] *= ex2(m_run[i] - base2[i]);
      m_run[i] = mnew;
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        rsum[e >> 1] += ex2(fmaf(s[j][e], scale_log2, -base2[e >> 1]));
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] += rsum[i];
  }
  float lse2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
    lse2[i] = m_run[i] == -INFINITY ? 0.f : m_run[i] + log2f(l_run[i]);
    const int row = row_lo + g + 8 * i;
    if (t == 0 && row < Sq) lse[base + 16 * warp + g + 8 * i] = lse2[i];
  }

  // sweep 2: dS = P (dO V^T - D), dq += dS K
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    load_tile<T, kBK, DP, kThreads>(ks, kp + (long long)k0 * D, Skv - k0, D,
                                    vec);
    load_tile<T, kBK, DP, kThreads>(vs, vp + (long long)k0 * D, Skv - k0, D,
                                    vec);
    __syncthreads();
    if (!live_rows || (causal && k0 > row_lo + 15)) continue;
    float s[kBK / 8][4], dp[kBK / 8][4];
    gemm_nt<T, DP, kBK>(s, qs, 16 * warp, ks, lane);
    gemm_nt<T, DP, kBK>(dp, dos, 16 * warp, vs, lane);
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        const int row = row_lo + g + 8 * (e >> 1);
        const bool hidden = col >= Skv || (causal && col > row);
        const float p =
            hidden ? 0.f : ex2(fmaf(s[j][e], scale_log2, -lse2[e >> 1]));
        s[j][e] = p * (dp[j][e] - di[e >> 1]);
      }
    gemm_pv<T, DP, kBK, DP>(acc, s, ks, 0, lane);
  }
  if (live_rows)
    store_rows<T, DP>(dq + (long long)bh * Sq * D, acc, scale, row_lo, Sq, 0,
                      D, lane);
}

template <typename T, int DP>
__global__ void __launch_bounds__(Cfg<T, DP>::kKVThreads, 1)
bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ dsum,
               T* __restrict__ dk, T* __restrict__ dv, int Hq, int group,
               int Sq, int Skv, int D, float scale_log2, float scale,
               int causal, int vec) {
  using C = Cfg<T, DP>;
  constexpr int kLd = C::kLd, kBKV = C::kBKV, kBQ2 = C::kBQ2, kDN = C::kDN;
  constexpr int kThreads = C::kKVThreads;
  extern __shared__ __align__(16) uint8_t dkv_smem[];
  T* ks = reinterpret_cast<T*>(dkv_smem);
  T* vs = ks + kBKV * kLd;
  T* qs = vs + kBKV * kLd;
  T* dos = qs + kBQ2 * kLd;
  float* lse_s = reinterpret_cast<float*>(dos + kBQ2 * kLd);
  float* dsum_s = lse_s + kBQ2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rw = warp % 4, cg = warp / 4;   // row group, column group
  const int bkv = blockIdx.x;               // b * Hkv + hkv
  const int hkv_n = Hq / group;
  const int b = bkv / hkv_n, hkv = bkv % hkv_n;
  const int k0 = blockIdx.y * kBKV;         // key tile 0 sees the most rows
  const long long kvbase = (long long)bkv * Skv + k0;
  load_tile<T, kBKV, DP, kThreads>(ks, k + kvbase * D, Skv - k0, D, vec);
  load_tile<T, kBKV, DP, kThreads>(vs, v + kvbase * D, Skv - k0, D, vec);

  const int key_lo = k0 + 16 * rw;  // my keys: key_lo + g, key_lo + g + 8
  float adk[kDN / 8][4], adv[kDN / 8][4];
#pragma unroll
  for (int n = 0; n < kDN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;
  const int qt0 = causal ? k0 / kBQ2 : 0;
  const int n_qt = (Sq + kBQ2 - 1) / kBQ2;
  for (int hh = 0; hh < group; ++hh) {
    const long long bh = (long long)b * Hq + (long long)hkv * group + hh;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int i0 = qt * kBQ2;
      const long long qbase = bh * Sq + i0;
      __syncthreads();                  // the last q tile read
      load_tile<T, kBQ2, DP, kThreads>(qs, q + qbase * D, Sq - i0, D, vec);
      load_tile<T, kBQ2, DP, kThreads>(dos, dout + qbase * D, Sq - i0, D,
                                       vec);
      for (int r = threadIdx.x; r < kBQ2; r += kThreads) {
        const bool in = i0 + r < Sq;
        lse_s[r] = in ? lse[qbase + r] : 0.f;
        dsum_s[r] = in ? dsum[qbase + r] : 0.f;
      }
      __syncthreads();
      if (key_lo >= Skv || (causal && key_lo > i0 + kBQ2 - 1)) continue;
      float s[kBQ2 / 8][4], dp[kBQ2 / 8][4];
      gemm_nt<T, DP, kBQ2>(s, ks, 16 * rw, qs, lane);     // S^T
      gemm_nt<T, DP, kBQ2>(dp, vs, 16 * rw, dos, lane);   // dP^T
#pragma unroll
      for (int j = 0; j < kBQ2 / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * j + 2 * t + (e & 1);
          const int row = i0 + qi;
          const int key = key_lo + g + 8 * (e >> 1);
          const bool hidden = key >= Skv || row >= Sq || (causal && key > row);
          const float p =
              hidden ? 0.f : ex2(fmaf(s[j][e], scale_log2, -lse_s[qi]));
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dsum_s[qi]);
        }
      gemm_pv<T, DP, kBQ2, kDN>(adv, s, dos, cg * kDN, lane);
      gemm_pv<T, DP, kBQ2, kDN>(adk, dp, qs, cg * kDN, lane);
    }
  }
  if (key_lo < Skv) {
    const long long off = (long long)bkv * Skv * D;
    store_rows<T, kDN>(dk + off, adk, scale, key_lo, Skv, cg * kDN, D, lane);
    store_rows<T, kDN>(dv + off, adv, 1.f, key_lo, Skv, cg * kDN, D, lane);
  }
}

// sets the kernel's shared memory and launches it
template <typename... P, typename... A>
cudaError_t run(void (*kernel)(P...), dim3 grid, int threads, int smem,
                cudaStream_t stream, A... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, void* dq, void* dk, void* dv, float* lse,
                   float* dsum, int B, int Hq, int Hkv, int Sq, int Skv, int D,
                   int causal, cudaStream_t stream) {
  using C = Cfg<T, DP>;
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout);
  const int vec = addr % 16 == 0 && (D * (int)sizeof(T)) % 16 == 0;
  const float scale = (float)(1.0 / sqrt((double)D));
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  const int group = Hq / Hkv;
  const dim3 g1((unsigned)(B * Hq), (unsigned)((Sq + C::kBQ - 1) / C::kBQ));
  cudaError_t err = run(bwd_dq_kernel<T, DP>, g1, C::kQThreads, C::kQBytes,
                        stream, (const T*)q, (const T*)k, (const T*)v,
                        (const T*)o, (const T*)dout, (T*)dq, lse, dsum, Hq,
                        group, Sq, Skv, D, scale_log2, scale, causal, vec);
  if (err != cudaSuccess) return err;
  const dim3 g2((unsigned)(B * Hkv),
                (unsigned)((Skv + C::kBKV - 1) / C::kBKV));
  return run(bwd_dkv_kernel<T, DP>, g2, C::kKVThreads, C::kKVBytes, stream,
             (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
             (const float*)lse, (const float*)dsum, (T*)dk, (T*)dv, Hq, group,
             Sq, Skv, D, scale_log2, scale, causal, vec);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, void* dq, void* dk, void* dv, float* lse,
                   float* dsum, int B, int Hq, int Hkv, int Sq, int Skv, int D,
                   int causal, cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, dout, dq, dk, dv, lse, dsum, B, Hq, Hkv,
                         Sq, Skv, D, causal, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, dout, dq, dk, dv, lse, dsum, B, Hq,
                          Hkv, Sq, Skv, D, causal, stream);
  return launch<T, 256>(q, k, v, o, dout, dq, dk, dv, lse, dsum, B, Hq, Hkv,
                        Sq, Skv, D, causal, stream);
}

}  // namespace

// dq (B, Hq, Sq, D), dk and dv (B, Hkv, Skv, D) in the inputs' type (dtype
// 0 fp32, 1 bf16); lse and dsum: B * Hq * Sq floats of scratch each.  Two
// launches on `stream`; returns the first cudaError_t that is not success.
extern "C" int flash_attention_backward(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* dout, void* dq, void* dk,
                                        void* dv, void* lse, void* dsum,
                                        int B, int Hq, int Hkv, int Sq,
                                        int Skv, int D, int causal, int dtype,
                                        void* stream) {
  if (D < 1 || D > kDMax || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Skv < 1 ||
      B < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  float* l = static_cast<float*>(lse);
  float* ds = static_cast<float*>(dsum);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, o, dout, dq, dk, dv, l, ds, B, Hq, Hkv,
                              Sq, Skv, D, causal, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, l, ds, B,
                                      Hq, Hkv, Sq, Skv, D, causal, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
