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
// LSE is the forward's: flash_attention_forward stores it (B * Hq * Sq
// floats) in its log2 domain, lse2_i = LSE_i * log2(e), and both passes
// take P_ij = exp2(q_i . k_j * scale * log2(e) - lse2_i), scale =
// 1 / sqrt(D).  Two launches and no atomics, so two calls give the same
// bits:
//
// * dQ pass, a block per (b, hq, query rows): S = q K^T, dP = dO V^T, dS,
//   dq += dS K over the key tiles the mask lets the rows see (three
//   products).  It writes D_i to scratch (B * Hq * Sq floats), which the
//   second pass reads.
// * dK/dV pass, a block per (b, hkv, keys, share of the group's query
//   heads): S^T = K q^T and dP^T = V dO^T with the keys as rows, so P^T
//   and dS^T are already the A operands (in registers) of dv += P^T dO and
//   dk += dS^T q (four products).  The group's query heads run in parallel:
//   the grid launches clusters of c blocks (c the largest divisor of the
//   group up to 2, kMaxCluster below), each block walks group / c
//   heads and keeps its partial dK and dV in registers, and the cluster
//   sums the partials in rank order through distributed shared memory
//   (each block a slice of the tile, rounded once).  That costs no device
//   memory; the alternative, an fp32 partial per query head in scratch and
//   an in-order reduction pass, writes and reads B * Hq * Skv * D * 8
//   bytes again (134 MB at Qwen2-72B's layer, ~0.08 ms at 3.35 TB/s, half
//   of the 0.174 ms bound).  Key tile 0, which sees every query row when
//   causal, is launched first.
//
// Two routes, as the forward's (the caller names one, `variant`):
//
// * wgmma (bf16, D % 8 == 0, D <= 128, q, k, v, o, dO 16-byte aligned): every
//   product on wgmma (csrc/sm90.cuh).  Each block has two consumer
//   warpgroups of 64 rows (query rows in the dQ pass, keys in the dK/dV
//   pass) and one producer warpgroup whose one thread keeps TMA loads in
//   flight into a ring of two stages with "full" and "empty" mbarriers:
//   K and V tiles of 64 keys (dQ pass; q and dO of 128 rows loaded once),
//   q and dO tiles of 64 rows (dK/dV pass; K and V of 128 keys loaded
//   once), and in the dK/dV pass a producer warp copies the tile's LSE and
//   D values into the stage beside them.  S and dP (S^T, dP^T) are
//   m64n64k16 with both operands in shared memory; dS (P^T, dS^T) passes
//   from the accumulator fragments to bf16 A fragments in registers for
//   dq += dS K (dv += P^T dO, dk += dS^T q), B read N-major, as the
//   forward feeds P to P V.  Within a warpgroup the products are committed
//   in groups so that P is formed while dP's products run, and dv's run
//   while dS^T is formed (from P^T's bf16 fragments, which leaves the
//   registers the fp32 ones would hold); masks are applied in a pass of
//   their own, only
//   on tiles that cross Skv, Sq or the diagonal.  The producer gives up
//   registers to the consumers (setmaxnreg 40 / 232 in the dQ pass, 24 /
//   240 in the dK/dV pass, whose dK and dV accumulators take 128 a
//   thread at D = 128).
// * mma (every other call: f32 in 3xTF32, csrc/tf32x3.cuh, and bf16 with
//   D % 8 != 0, D > 128 or an operand off 16 bytes): warp-level mma.sync,
//   16 rows a warp, with the fragment loads of the forward's `mma` route;
//   P and dS pass from accumulator fragments to A fragments in registers,
//   rounded to bf16 for bf16 inputs (as the forward rounds P).  D is padded
//   to DP = 64, 128 or 256 in shared memory.  The tiles that stream (K and
//   V in the dQ pass, q, dO, LSE and D in the dK/dV pass) sit in two
//   stages, filled by cp.async while the other is multiplied, where two
//   stages fit 227 KB and cost no block an SM (`stages` below: fp32's
//   dK/dV pass at DP = 128 takes one, and two blocks an SM); operands off
//   16 bytes or with D * sizeof(T) % 16 != 0 load element by element into
//   the same stages.
//
// * split (D > 256, fp32 or bf16): csrc/flash_split.cuh, the same two
//   passes with D cut into slices over the blocks of a thread-block
//   cluster (up to 256 columns a block held in the dQ pass, 128 in the
//   dK/dV pass; wider slices taken in sweeps, past 256 columns streamed in
//   pieces), the partials of S and dP summed in rank order through
//   distributed shared memory, the products on mma.sync; the dK/dV pass
//   walks the group's query heads in order.
//
// Rows past Sq or Skv load as zero and are masked, so a ragged last tile
// gives P = 0 there.  What bounds it on an H100: the five products of the
// gradient are 2.5x the forward's two (olmo-1b's layer, B = 2, H = 16, S =
// 2048, D = 128, causal: 8.6e10 flop, 0.087 ms at 989 bf16 TFLOP/s; three
// times that at the TF32 peak in 3xTF32); these two passes run seven, as
// the dQ pass recomputes S and dP rather than sum dq across blocks, which
// would take atomics or a third pass.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_split.cuh"
#include "sm90.cuh"
#include "tf32x3.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kDMax = 256;     // the widest head of the mma and wgmma routes
constexpr int kSmemMax = 232448;        // shared memory a block can have
constexpr int kSmemSm = 233472;         // shared memory of an SM
// blocks a cluster at most: at Qwen2-72B's layer (group 8) clusters of 2
// measured 5-9 % faster than of 4, 10-14 % faster than of the portable 8,
// and 35-40 % faster than one block walking all 8 heads, on both routes
// (tools/flash_variants.py --backward, on an H100 SXM)
constexpr int kMaxCluster = 2;

// blocks of `threads` threads with `bytes` of shared memory an SM holds:
// 1 KB of each block's goes to the system, and the registers take two
// blocks of 128 threads at up to 255 a thread
constexpr int sm_blocks(int bytes, int threads) {
  return kSmemSm / (bytes + 1024) < 256 / threads ? kSmemSm / (bytes + 1024)
                                                  : 256 / threads;
}

// two stages of the streamed tiles where they fit and cost no block an SM
// (fp32 at DP = 128: one stage lets the dK/dV pass run two blocks an SM,
// 11 % faster at olmo-1b's layer than two stages and one block)
constexpr int stages(int one, int two, int threads) {
  return two <= kSmemMax && sm_blocks(two, threads) >= sm_blocks(one, threads)
             ? 2
             : 1;
}

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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(sm90::smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(sm90::smem_u32(p)));
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

// The dK/dV passes' last step.  Each block of the cluster holds in `part`
// (shared memory, ROWS x DP floats, rows LD apart) its partial sum over
// its share of the group's query heads; each block sums one slice of the
// tile over the cluster's blocks in rank order and stores rows below
// `valid` and columns below D of it, times `mul`, at dst (rows of D
// elements).  The caller syncs the cluster before (the partials written)
// and after (no block leaves while another reads its shared memory).
template <typename T, int ROWS, int DP, int LD>
__device__ __forceinline__ void cluster_sum(float* part, T* dst, int valid,
                                            int D, float mul, int tid,
                                            int threads) {
  cg::cluster_group cl = cg::this_cluster();
  const int c = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  constexpr int kPieces = ROWS * DP / 4;        // float4 pieces
  const int per = (kPieces + c - 1) / c;
  const int end = min(kPieces, (rank + 1) * per);
  for (int e = rank * per + tid; e < end; e += threads) {
    const int row = e / (DP / 4), col = e % (DP / 4) * 4;
    if (row >= valid || col >= D) continue;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < c; ++j) {
      const float4 x = *reinterpret_cast<const float4*>(
          cl.map_shared_rank(part, j) + row * LD + col);
      s[0] += x.x;
      s[1] += x.y;
      s[2] += x.z;
      s[3] += x.w;
    }
    T* p = dst + (long long)row * D + col;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (col + i < D) put(p + i, s[i] * mul);
  }
}

// ---- mma: mma.sync, f32 in 3xTF32 -----------------------------------------

namespace mm {

// Tiles for operand type T and padded width DP.  Every tile row is DP + 8
// elements long in shared memory (fp32: even, for load_a / load_bt's
// 8-byte loads; bf16: 16 bytes over, for ldmatrix).  The streamed tiles
// sit in two stages or one (`stages`).
template <typename T, int DP>
struct Cfg {
  static constexpr int kLd = DP + 8;
  static constexpr int kSz = (int)sizeof(T);
  // dQ pass: 4 warps of 16 query rows against kv tiles of kBK keys
  static constexpr int kBQ = 64;
  static constexpr int kBK = DP == 256 ? 32 : 64;
  static constexpr int kQThreads = 128;
  static constexpr int kQStages =
      stages(kSz * (2 * kBQ + 2 * kBK) * kLd, kSz * (2 * kBQ + 4 * kBK) * kLd,
             kQThreads);
  static constexpr int kQBytes = kSz * (2 * kBQ + 2 * kQStages * kBK) * kLd;
  // dK/dV pass: 4 row groups of 16 keys against query tiles of kBQ2 rows;
  // at DP = 256 two warps a row group, each kDN accumulator columns.  A
  // stage: q, dO, and the tile's LSE and D
  static constexpr int kBKV = 64;
  static constexpr int kBQ2 = DP == 64 ? 64 : 32;
  static constexpr int kGroups = DP == 256 ? 2 : 1;
  static constexpr int kDN = DP / kGroups;
  static constexpr int kKVThreads = 128 * kGroups;
  static constexpr int kStage = kSz * 2 * kBQ2 * kLd + 2 * kBQ2 * 4;
  static constexpr int kKV = kSz * 2 * kBKV * kLd;
  static constexpr int kKVStages =
      stages(kKV + kStage, kKV + 2 * kStage, kKVThreads);
  // the partial dK or dV (fp32, kBKV rows kLd apart) overlays the tiles
  static constexpr int kPart = 4 * kBKV * kLd;
  static constexpr int kKVBytes = kKV + kKVStages * kStage > kPart
                                      ? kKV + kKVStages * kStage
                                      : kPart;
};

// Rows [0, ROWS) of a tile whose row r starts at src + r * D, columns
// [0, DP): rows at or past `valid` and columns at or past D are zero.
// vec (every row and src 16-byte aligned): cp.async in 16-byte pieces,
// which the caller commits and waits for; else plain loads an element.
template <typename T, int ROWS, int DP, int THREADS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int valid,
                                          int D, int vec) {
  constexpr int kLd = DP + 8;
  if (vec) {
    constexpr int kPer = 16 / (int)sizeof(T), kCpr = DP / kPer;
#pragma unroll 4
    for (int e = threadIdx.x; e < ROWS * kCpr; e += THREADS) {
      const int r = e / kCpr, c = e % kCpr * kPer;
      T* d = dst + r * kLd + c;
      if (r < valid && c < D)
        tf32x3::cp_async16(d, src + (long long)r * D + c);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
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

// ROWS floats from src into dst by cp.async, zero at or past `valid`
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int valid) {
  for (int r = threadIdx.x; r < ROWS; r += THREADS) {
    if (r < valid) tf32x3::cp_async4(dst + r, src + r);
    else dst[r] = 0.f;
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

// the fragments of a 16 x NN accumulator into part (fp32 rows LD apart)
// at rows row_lo + g, row_lo + g + 8 and columns col0 + ...
template <int NN, int LD>
__device__ __forceinline__ void frag_to_part(float* part,
                                             const float (&acc)[NN / 8][4],
                                             int row_lo, int col0,
                                             int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int n = 0; n < NN / 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(part + (row_lo + g + 8 * i) * LD + col0 +
                                 8 * n + 2 * t) =
          make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
}

template <typename T, int DP>
__global__ void __launch_bounds__(Cfg<T, DP>::kQThreads, 1)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ o,
              const T* __restrict__ dout, const float* __restrict__ lse,
              T* __restrict__ dq, float* __restrict__ dsum, int Hq,
              int group, int Sq, int Skv, int D, float scale_log2,
              float scale, int causal, int vec) {
  using C = Cfg<T, DP>;
  constexpr int kLd = C::kLd, kBQ = C::kBQ, kBK = C::kBK;
  constexpr int kThreads = C::kQThreads, kStages = C::kQStages;
  extern __shared__ __align__(16) uint8_t dq_smem[];
  T* qs = reinterpret_cast<T*>(dq_smem);
  T* dos = qs + kBQ * kLd;
  T* ks = dos + kBQ * kLd;                // kStages K tiles, then V tiles
  T* vs = ks + kStages * kBK * kLd;
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
  if (causal) n_kt = min(n_kt, (min(q0 + kBQ, Sq) - 1) / kBK + 1);
  auto load_kv = [&](int kt, int buf) {
    const int k0 = kt * kBK;
    load_tile<T, kBK, DP, kThreads>(ks + buf * kBK * kLd,
                                    kp + (long long)k0 * D, Skv - k0, D, vec);
    load_tile<T, kBK, DP, kThreads>(vs + buf * kBK * kLd,
                                    vp + (long long)k0 * D, Skv - k0, D, vec);
  };

  load_tile<T, kBQ, DP, kThreads>(qs, q + base * D, Sq - q0, D, vec);
  load_tile<T, kBQ, DP, kThreads>(dos, dout + base * D, Sq - q0, D, vec);
  load_kv(0, 0);
  tf32x3::cp_async_commit();

  // D_i = dO_i . O_i for my 16 rows, one row at a time over the warp, from
  // device memory while the tiles land; the forward's LSE of my rows
  const int row_lo = q0 + 16 * warp;    // my rows: row_lo + g, row_lo + g + 8
  float di[2] = {0.f, 0.f}, lse2[2];
  for (int r = 0; r < 16; ++r) {
    const bool in = row_lo + r < Sq;
    float acc = 0.f;
    if (in) {
      const T* orow = o + (base + 16 * warp + r) * D;
      const T* drow = dout + (base + 16 * warp + r) * D;
      for (int c = lane; c < D; c += 32)
        acc += to_f32(drow[c]) * to_f32(orow[c]);
    }
    acc = warp_sum(acc);
    if (r == g) di[0] = acc;
    if (r == g + 8) di[1] = acc;
    if (lane == 0 && in) dsum[base + 16 * warp + r] = acc;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_lo + g + 8 * i;
    lse2[i] = row < Sq ? lse[base + 16 * warp + g + 8 * i] : 0.f;
  }
  const bool live_rows = row_lo < Sq;

  // dS = P (dO V^T - D), dq += dS K
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK, buf = kStages == 2 ? kt & 1 : 0;
    if (kStages == 1 && kt > 0) {
      __syncthreads();                  // tile kt - 1 read
      load_kv(kt, 0);
      tf32x3::cp_async_commit();
    }
    tf32x3::cp_async_wait<0>();
    __syncthreads();                    // tile kt in; tile kt - 1 read
    if (kStages == 2 && kt + 1 < n_kt) {
      load_kv(kt + 1, buf ^ 1);
      tf32x3::cp_async_commit();
    }
    if (!live_rows || (causal && k0 > row_lo + 15)) continue;
    const T* kb = ks + buf * kBK * kLd;
    const T* vb = vs + buf * kBK * kLd;
    float s[kBK / 8][4], dp[kBK / 8][4];
    gemm_nt<T, DP, kBK>(s, qs, 16 * warp, kb, lane);
    gemm_nt<T, DP, kBK>(dp, dos, 16 * warp, vb, lane);
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
    gemm_pv<T, DP, kBK, DP>(acc, s, kb, 0, lane);
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
  constexpr int kThreads = C::kKVThreads, kStages = C::kKVStages;
  extern __shared__ __align__(16) uint8_t dkv_smem[];
  T* ks = reinterpret_cast<T*>(dkv_smem);
  T* vs = ks + kBKV * kLd;
  uint8_t* stages = dkv_smem + C::kKV;
  float* part = reinterpret_cast<float*>(dkv_smem);
  cg::cluster_group cl = cg::this_cluster();
  const int c = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rw = warp % 4, cgi = warp / 4;  // row group, column group
  const int bkv = blockIdx.x / c;           // b * Hkv + hkv
  const int hkv_n = Hq / group;
  const int b = bkv / hkv_n, hkv = bkv % hkv_n;
  const int hpb = group / c;                // query heads a block
  const int k0 = blockIdx.y * kBKV;         // key tile 0 sees the most rows
  const long long kvbase = (long long)bkv * Skv + k0;
  const int qt0 = causal ? k0 / kBQ2 : 0;
  const int nq = max(0, (Sq + kBQ2 - 1) / kBQ2 - qt0);
  const int n_it = hpb * nq;
  // stage buf of iteration it: q, dO, LSE and D of query tile qt0 + it % nq
  // of head rank * hpb + it / nq
  auto stage_q = [&](int buf) {
    return reinterpret_cast<T*>(stages + buf * C::kStage);
  };
  auto load_stage = [&](int it, int buf) {
    const long long bh = (long long)b * Hq + (long long)hkv * group +
                         rank * hpb + it / nq;
    const int i0 = (qt0 + it % nq) * kBQ2;
    const long long qbase = bh * Sq + i0;
    T* qs = stage_q(buf);
    T* dos = qs + kBQ2 * kLd;
    float* lse_s = reinterpret_cast<float*>(dos + kBQ2 * kLd);
    load_tile<T, kBQ2, DP, kThreads>(qs, q + qbase * D, Sq - i0, D, vec);
    load_tile<T, kBQ2, DP, kThreads>(dos, dout + qbase * D, Sq - i0, D, vec);
    load_rows<kBQ2, kThreads>(lse_s, lse + qbase, Sq - i0);
    load_rows<kBQ2, kThreads>(lse_s + kBQ2, dsum + qbase, Sq - i0);
  };
  load_tile<T, kBKV, DP, kThreads>(ks, k + kvbase * D, Skv - k0, D, vec);
  load_tile<T, kBKV, DP, kThreads>(vs, v + kvbase * D, Skv - k0, D, vec);
  if (n_it > 0) load_stage(0, 0);
  tf32x3::cp_async_commit();

  const int key_lo = k0 + 16 * rw;  // my keys: key_lo + g, key_lo + g + 8
  float adk[kDN / 8][4], adv[kDN / 8][4];
#pragma unroll
  for (int n = 0; n < kDN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;
  for (int it = 0; it < n_it; ++it) {
    const int buf = kStages == 2 ? it & 1 : 0;
    if (kStages == 1 && it > 0) {
      __syncthreads();                  // stage it - 1 read
      load_stage(it, 0);
      tf32x3::cp_async_commit();
    }
    tf32x3::cp_async_wait<0>();
    __syncthreads();                    // stage it in; stage it - 1 read
    if (kStages == 2 && it + 1 < n_it) {
      load_stage(it + 1, buf ^ 1);
      tf32x3::cp_async_commit();
    }
    const int i0 = (qt0 + it % nq) * kBQ2;
    if (key_lo >= Skv || (causal && key_lo > i0 + kBQ2 - 1)) continue;
    const T* qs = stage_q(buf);
    const T* dos = qs + kBQ2 * kLd;
    const float* lse_s = reinterpret_cast<const float*>(dos + kBQ2 * kLd);
    const float* dsum_s = lse_s + kBQ2;
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
    gemm_pv<T, DP, kBQ2, kDN>(adv, s, dos, cgi * kDN, lane);
    gemm_pv<T, DP, kBQ2, kDN>(adk, dp, qs, cgi * kDN, lane);
  }

  // the cluster's partial sums, dV then dK, through `part` (which overlays
  // the tiles)
  tf32x3::cp_async_wait<0>();
  const long long off = kvbase * D;
  cl.sync();                            // every tile read
  frag_to_part<kDN, kLd>(part, adv, 16 * rw, cgi * kDN, lane);
  cl.sync();
  cluster_sum<T, kBKV, DP, kLd>(part, dv + off, Skv - k0, D, 1.f,
                                threadIdx.x, kThreads);
  cl.sync();
  frag_to_part<kDN, kLd>(part, adk, 16 * rw, cgi * kDN, lane);
  cl.sync();
  cluster_sum<T, kBKV, DP, kLd>(part, dk + off, Skv - k0, D, scale,
                                threadIdx.x, kThreads);
  cl.sync();
}

}  // namespace mm

// ---- wgmma: bf16 products on wgmma, TMA-fed --------------------------------

namespace wg {

constexpr int kStages = 2;              // ring depth of the streamed tiles
constexpr int kConsumers = 2;           // warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBQ = 128;                // dQ pass: query rows a block
constexpr int kBK = 64;                 //   keys a streamed tile
constexpr int kBKV = 128;               // dK/dV pass: keys a block
constexpr int kBQ2 = 64;                //   query rows a streamed tile
constexpr int kRow = sm90::kRowBytes;

// byte offsets from a 1024-aligned base; DP (64 or 128) is D padded
template <int DP>
struct DqLayout {
  static constexpr int kHalves = DP / 64;
  static constexpr int kQHalf = kBQ * kRow;
  static constexpr int kKHalf = kBK * kRow;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kHalves * kQHalf;
  static constexpr int kK = kDO + kHalves * kQHalf;       // kStages tiles
  static constexpr int kV = kK + kStages * kHalves * kKHalf;
  static constexpr int kBar = kV + kStages * kHalves * kKHalf;
  static constexpr int kBars = 1 + 4 * kStages;
  static constexpr int kBytes = kBar + 8 * kBars + 1024;  // + alignment
};

template <int DP>
struct DkvLayout {
  static constexpr int kHalves = DP / 64;
  static constexpr int kKHalf = kBKV * kRow;
  static constexpr int kQHalf = kBQ2 * kRow;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kHalves * kKHalf;
  static constexpr int kQ = kV + kHalves * kKHalf;         // kStages tiles
  static constexpr int kDO = kQ + kStages * kHalves * kQHalf;
  // a stage's LSE (kBQ2 floats) then D (kBQ2 floats)
  static constexpr int kRows = kDO + kStages * kHalves * kQHalf;
  static constexpr int kBar = kRows + kStages * 2 * kBQ2 * 4;
  static constexpr int kBars = 1 + 2 * kStages;
  static constexpr int kBytes = kBar + 8 * kBars + 1024;
  // the partial dK or dV (fp32, kBKV rows DP + 8 apart) overlays the tiles
  static constexpr int kLdPart = DP + 8;
  static_assert(4 * kBKV * kLdPart <= kRows, "the partial fits the tiles");
};

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __nv_bfloat16* __restrict__ o,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    __nv_bfloat16* __restrict__ dq, float* __restrict__ dsum,
                    int Hq, int group, int Sq, int Skv, int D,
                    float scale_log2, float scale, int causal) {
  using L = DqLayout<DP>;
  extern __shared__ uint8_t dq_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(dq_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* q_full = bar;                 // q and dO
  uint64_t* k_full = bar + 1;
  uint64_t* k_empty = k_full + kStages;
  uint64_t* v_full = k_empty + kStages;
  uint64_t* v_empty = v_full + kStages;

  const int bh = blockIdx.x;                             // b * Hq + h
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;     // heavy tiles first
  int n_kt = (Skv + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (min(q0 + kBQ, Sq) - 1) / kBK + 1);
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(k_full + s, 1);
      sm90::mbar_init(v_full + s, 1);
      sm90::mbar_init(k_empty + s, 128 * kConsumers);
      sm90::mbar_init(v_empty + s, 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wgi == kConsumers) {
    // ---- producer: one thread issues every copy ------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 128 * kConsumers) {
      const int kvh = (bh / Hq) * (Hq / group) + (bh % Hq) / group;
      sm90::mbar_expect_tx(q_full, 2 * L::kHalves * L::kQHalf);
#pragma unroll
      for (int h = 0; h < L::kHalves; ++h) {
        sm90::tma_load(smem + L::kQ + h * L::kQHalf, &tq, q_full, 64 * h, q0,
                       bh);
        sm90::tma_load(smem + L::kDO + h * L::kQHalf, &tdo, q_full, 64 * h,
                       q0, bh);
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages, ph = (kt / kStages) & 1;
        const int tile = s * L::kHalves * L::kKHalf;
        sm90::mbar_wait(k_empty + s, ph ^ 1);
        sm90::mbar_expect_tx(k_full + s, L::kHalves * L::kKHalf);
#pragma unroll
        for (int h = 0; h < L::kHalves; ++h)
          sm90::tma_load(smem + L::kK + tile + h * L::kKHalf, &tk, k_full + s,
                         64 * h, kt * kBK, kvh);
        sm90::mbar_wait(v_empty + s, ph ^ 1);
        sm90::mbar_expect_tx(v_full + s, L::kHalves * L::kKHalf);
#pragma unroll
        for (int h = 0; h < L::kHalves; ++h)
          sm90::tma_load(smem + L::kV + tile + h * L::kKHalf, &tv, v_full + s,
                         64 * h, kt * kBK, kvh);
      }
    }
    return;
  }

  // ---- consumers: 64 query rows each -----------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int t = threadIdx.x % 128, lane = t % 32;
  const int row_lo = q0 + 64 * wgi;                    // first row of mine
  const int row0 = row_lo + 16 * (t / 32) + lane / 4;  // and row0 + 8
  const int col0 = 2 * (lane % 4);

  // D_i = dO_i . O_i over the row's 4 threads (8 columns a load), from
  // device memory while the tiles land, and the forward's LSE
  float di[2], lse2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const long long r = (long long)bh * Sq + row;
    float acc = 0.f;
    if (row < Sq) {
      for (int c = 4 * col0; c < D; c += 32) {
        const uint4 a = __ldg(reinterpret_cast<const uint4*>(o + r * D + c));
        const uint4 b =
            __ldg(reinterpret_cast<const uint4*>(dout + r * D + c));
        const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 xf = __bfloat1622float2(x[j]);
          const float2 yf = __bfloat1622float2(y[j]);
          acc = fmaf(xf.x, yf.x, fmaf(xf.y, yf.y, acc));
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    di[i] = acc;
    lse2[i] = row < Sq ? lse[r] : 0.f;
    if (col0 == 0 && row < Sq) dsum[r] = acc;
  }

  const uint32_t q_base =
      sm90::smem_u32(smem + L::kQ) + 64 * wgi * kRow;
  const uint32_t do_base =
      sm90::smem_u32(smem + L::kDO) + 64 * wgi * kRow;
  const bool live_rows = row_lo < Sq;
  float acc[DP / 2];
#pragma unroll
  for (int r = 0; r < DP / 2; ++r) acc[r] = 0.f;

  sm90::mbar_wait(q_full, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % kStages, ph = (kt / kStages) & 1;
    const int k0 = kt * kBK;
    const uint32_t k_base =
        sm90::smem_u32(smem + L::kK + s * L::kHalves * L::kKHalf);
    const uint32_t v_base =
        sm90::smem_u32(smem + L::kV + s * L::kHalves * L::kKHalf);
    sm90::mbar_wait(k_full + s, ph);
    sm90::mbar_wait(v_full + s, ph);
    if (live_rows && !(causal && k0 > row_lo + 63)) {
      // S = q K^T and dP = dO V^T over D in steps of 16, two groups: P is
      // formed while dP's products run
      float sc[32], dp[32];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t oq = (kk / 4) * L::kQHalf + (kk % 4) * 32;
        const uint32_t ok = (kk / 4) * L::kKHalf + (kk % 4) * 32;
        sm90::wgmma_ss(sc, sm90::desc(q_base + oq, 16, 8 * kRow),
                       sm90::desc(k_base + ok, 16, 8 * kRow), kk > 0);
      }
      sm90::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t oq = (kk / 4) * L::kQHalf + (kk % 4) * 32;
        const uint32_t ok = (kk / 4) * L::kKHalf + (kk % 4) * 32;
        sm90::wgmma_ss(dp, sm90::desc(do_base + oq, 16, 8 * kRow),
                       sm90::desc(v_base + ok, 16, 8 * kRow), kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      sm90::fence_regs(sc);

      // P, masked only on the tile that crosses Skv and on causal tiles
      // that cross the diagonal of my rows (a hidden score goes to -inf,
      // so exp2 gives 0); then dS = P (dP - D)
      if (k0 + kBK > Skv || (causal && k0 + kBK - 1 > row_lo)) {
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          const int col = k0 + 8 * (r / 4) + col0 + r % 2;
          const int row = row0 + 8 * ((r / 2) % 2);
          if (col >= Skv || (causal && col > row)) sc[r] = -INFINITY;
        }
      }
#pragma unroll
      for (int r = 0; r < 32; ++r)
        sc[r] = ex2(fmaf(sc[r], scale_log2, -lse2[(r / 2) % 2]));
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dp);
      uint32_t ds[16];
#pragma unroll
      for (int r = 0; r < 32; r += 2) {
        const int i = (r / 2) % 2;
        ds[r / 2] = pack_bf16(sc[r] * (dp[r] - di[i]),
                              sc[r + 1] * (dp[r + 1] - di[i]));
      }

      // dq += dS K over the 64 keys in steps of 16 (16 rows of K)
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        sm90::wgmma_rs(acc, ds + 4 * kk,
                       sm90::desc(k_base + kk * 16 * kRow, L::kKHalf,
                                  8 * kRow));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
    }
    sm90::mbar_arrive(k_empty + s);
    sm90::mbar_arrive(v_empty + s);
  }

#pragma unroll
  for (int c = 0; c < DP / 8; ++c) {
    const int col = 8 * c + col0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row < Sq && col < D)
        *reinterpret_cast<__nv_bfloat162*>(
            dq + ((long long)bh * Sq + row) * D + col) =
            __floats2bfloat162_rn(acc[4 * c + 2 * i] * scale,
                                  acc[4 * c + 2 * i + 1] * scale);
    }
  }
}

// the accumulator fragments of a consumer warpgroup (64 x DP, thread t)
// into part (fp32 rows LD apart) from row row_lo
template <int DP, int LD>
__device__ __forceinline__ void frag_to_part(float* part,
                                             const float (&acc)[DP / 2],
                                             int row_lo, int t) {
  const int row0 = row_lo + 16 * (t / 32) + (t % 32) / 4;
  const int col0 = 2 * (t % 4);
#pragma unroll
  for (int r = 0; r < DP / 2; r += 2)
    *reinterpret_cast<float2*>(part + (row0 + 8 * ((r / 2) % 2)) * LD +
                               8 * (r / 4) + col0) =
        make_float2(acc[r], acc[r + 1]);
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse,
                     const float* __restrict__ dsum,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int Hq, int group,
                     int Sq, int Skv, int D, float scale_log2, float scale,
                     int causal) {
  using L = DkvLayout<DP>;
  extern __shared__ uint8_t dkv_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(dkv_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* kv_full = bar;
  uint64_t* full = bar + 1;             // q, dO (TMA) and LSE, D (copied)
  uint64_t* empty = full + kStages;
  float* rows = reinterpret_cast<float*>(smem + L::kRows);
  float* part = reinterpret_cast<float*>(smem);

  cg::cluster_group cl = cg::this_cluster();
  const int c = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int bkv = blockIdx.x / c;           // b * Hkv + hkv
  const int hkv_n = Hq / group;
  const int b = bkv / hkv_n, hkv = bkv % hkv_n;
  const int hpb = group / c;                // query heads a block
  const int k0 = blockIdx.y * kBKV;         // key tile 0 sees the most rows
  const int qt0 = causal ? k0 / kBQ2 : 0;
  const int nq = max(0, (Sq + kBQ2 - 1) / kBQ2 - qt0);
  const int n_it = hpb * nq;
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(full + s, 1 + 32);
      sm90::mbar_init(empty + s, 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wgi == kConsumers) {
    // ---- producer: one warp; lane 0 issues the TMA copies, every lane
    // copies two rows' LSE and D ------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    const int lane = threadIdx.x % 32;
    if (threadIdx.x / 32 == 4 * kConsumers) {
      if (lane == 0) {
        sm90::mbar_expect_tx(kv_full, 2 * L::kHalves * L::kKHalf);
#pragma unroll
        for (int h = 0; h < L::kHalves; ++h) {
          sm90::tma_load(smem + L::kK + h * L::kKHalf, &tk, kv_full, 64 * h,
                         k0, bkv);
          sm90::tma_load(smem + L::kV + h * L::kKHalf, &tv, kv_full, 64 * h,
                         k0, bkv);
        }
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kStages, ph = (it / kStages) & 1;
        const int bh = b * Hq + hkv * group + rank * hpb + it / nq;
        const int i0 = (qt0 + it % nq) * kBQ2;
        const int tile = s * L::kHalves * L::kQHalf;
        sm90::mbar_wait(empty + s, ph ^ 1);
        if (lane == 0) {
          sm90::mbar_expect_tx(full + s, 2 * L::kHalves * L::kQHalf);
#pragma unroll
          for (int h = 0; h < L::kHalves; ++h) {
            sm90::tma_load(smem + L::kQ + tile + h * L::kQHalf, &tq, full + s,
                           64 * h, i0, bh);
            sm90::tma_load(smem + L::kDO + tile + h * L::kQHalf, &tdo,
                           full + s, 64 * h, i0, bh);
          }
        }
        float* ls = rows + s * 2 * kBQ2;
        for (int r = lane; r < kBQ2; r += 32) {
          const bool in = i0 + r < Sq;
          const long long at = (long long)bh * Sq + i0 + r;
          ls[r] = in ? lse[at] : 0.f;
          ls[kBQ2 + r] = in ? dsum[at] : 0.f;
        }
        sm90::mbar_arrive(full + s);    // release: the rows above
      }
    }
    // the cluster's five syncs of the epilogue below
    for (int i = 0; i < 5; ++i) cl.sync();
    return;
  }

  // ---- consumers: 64 keys each -----------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int t = threadIdx.x % 128, lane = t % 32;
  const int key_lo = k0 + 64 * wgi;                    // first key of mine
  const int key0 = key_lo + 16 * (t / 32) + lane / 4;  // and key0 + 8
  const int col0 = 2 * (lane % 4);
  const uint32_t k_base = sm90::smem_u32(smem + L::kK) + 64 * wgi * kRow;
  const uint32_t v_base = sm90::smem_u32(smem + L::kV) + 64 * wgi * kRow;
  float adk[DP / 2], adv[DP / 2];
#pragma unroll
  for (int r = 0; r < DP / 2; ++r) adk[r] = adv[r] = 0.f;

  sm90::mbar_wait(kv_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kStages, ph = (it / kStages) & 1;
    const int i0 = (qt0 + it % nq) * kBQ2;
    const uint32_t q_base =
        sm90::smem_u32(smem + L::kQ + s * L::kHalves * L::kQHalf);
    const uint32_t do_base =
        sm90::smem_u32(smem + L::kDO + s * L::kHalves * L::kQHalf);
    const float* lse_s = rows + s * 2 * kBQ2;
    const float* dsum_s = lse_s + kBQ2;
    sm90::mbar_wait(full + s, ph);
    if (key_lo < Skv && !(causal && key_lo > i0 + kBQ2 - 1)) {
      // S^T = K q^T and dP^T = V dO^T over D in steps of 16, two groups
      float st[32], dpt[32];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t ok = (kk / 4) * L::kKHalf + (kk % 4) * 32;
        const uint32_t oq = (kk / 4) * L::kQHalf + (kk % 4) * 32;
        sm90::wgmma_ss(st, sm90::desc(k_base + ok, 16, 8 * kRow),
                       sm90::desc(q_base + oq, 16, 8 * kRow), kk > 0);
      }
      sm90::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t ok = (kk / 4) * L::kKHalf + (kk % 4) * 32;
        const uint32_t oq = (kk / 4) * L::kQHalf + (kk % 4) * 32;
        sm90::wgmma_ss(dpt, sm90::desc(v_base + ok, 16, 8 * kRow),
                       sm90::desc(do_base + oq, 16, 8 * kRow), kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      sm90::fence_regs(st);

      // P^T while dP^T's products run, masked only on tiles that cross Skv
      // or Sq and on causal tiles that cross the diagonal of my keys (a
      // hidden score goes to -inf, so exp2 gives 0); dv += P^T dO runs
      // while dS^T = P^T (dP^T - D) is formed from P^T's bf16 fragments
      // (the fp32 ones would hold 32 more registers a thread, which the
      // products' accumulators leave no room for); then dk += dS^T q.
      // Both over the 64 rows in steps of 16
      if (key_lo + 63 >= Skv || i0 + kBQ2 > Sq ||
          (causal && key_lo + 63 > i0)) {
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          const int key = key0 + 8 * ((r / 2) % 2);
          const int row = i0 + 8 * (r / 4) + col0 + r % 2;
          if (key >= Skv || row >= Sq || (causal && key > row))
            st[r] = -INFINITY;
        }
      }
      uint32_t pa[16], da[16];
#pragma unroll
      for (int r = 0; r < 32; r += 2) {
        const int qi = 8 * (r / 4) + col0;
        st[r] = ex2(fmaf(st[r], scale_log2, -lse_s[qi]));
        st[r + 1] = ex2(fmaf(st[r + 1], scale_log2, -lse_s[qi + 1]));
        pa[r / 2] = pack_bf16(st[r], st[r + 1]);
      }
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ2 / 16; ++kk)
        sm90::wgmma_rs(adv, pa + 4 * kk,
                       sm90::desc(do_base + kk * 16 * kRow, L::kQHalf,
                                  8 * kRow));
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      sm90::fence_regs(dpt);
#pragma unroll
      for (int r = 0; r < 32; r += 2) {
        const int qi = 8 * (r / 4) + col0;
        const float2 p = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(pa + r / 2));
        da[r / 2] = pack_bf16(p.x * (dpt[r] - dsum_s[qi]),
                              p.y * (dpt[r + 1] - dsum_s[qi + 1]));
      }
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ2 / 16; ++kk)
        sm90::wgmma_rs(adk, da + 4 * kk,
                       sm90::desc(q_base + kk * 16 * kRow, L::kQHalf,
                                  8 * kRow));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(adv);
      sm90::fence_regs(adk);
    }
    sm90::mbar_arrive(empty + s);
  }

  // the cluster's partial sums, dV then dK, through `part` (which overlays
  // the tiles); the producer warpgroup takes part in the five syncs
  const long long off = ((long long)bkv * Skv + k0) * D;
  cl.sync();                            // every tile read
  frag_to_part<DP, L::kLdPart>(part, adv, 64 * wgi, t);
  cl.sync();
  cluster_sum<__nv_bfloat16, kBKV, DP, L::kLdPart>(
      part, dv + off, Skv - k0, D, 1.f, threadIdx.x, 128 * kConsumers);
  cl.sync();
  frag_to_part<DP, L::kLdPart>(part, adk, 64 * wgi, t);
  cl.sync();
  cluster_sum<__nv_bfloat16, kBKV, DP, L::kLdPart>(
      part, dk + off, Skv - k0, D, scale, threadIdx.x, 128 * kConsumers);
  cl.sync();
}

}  // namespace wg

// the largest divisor of the group up to kMaxCluster: the blocks a cluster
// gives one (b, hkv, key tile)
int cluster_size(int group) {
  for (int c = min(group, kMaxCluster); c > 1; --c)
    if (group % c == 0) return c;
  return 1;
}

// sets the kernel's shared memory and launches it in clusters of
// `cluster` blocks along x
template <typename... P, typename... A>
cudaError_t run(void (*kernel)(P...), dim3 grid, int threads, int smem,
                int cluster, cudaStream_t stream, A... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  void *dq, *dk, *dv;
  float* dsum;
  int B, Hq, Hkv, Sq, Skv, D, causal;
  cudaStream_t stream;
};

template <typename T, int DP>
cudaError_t launch_mma(const Args& a) {
  using C = mm::Cfg<T, DP>;
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
      reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.dout);
  const int vec = addr % 16 == 0 && (a.D * (int)sizeof(T)) % 16 == 0;
  const float scale = (float)(1.0 / sqrt((double)a.D));
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)a.D));
  const int group = a.Hq / a.Hkv, c = cluster_size(group);
  const dim3 g1((unsigned)(a.B * a.Hq),
                (unsigned)((a.Sq + C::kBQ - 1) / C::kBQ));
  cudaError_t err = run(
      mm::bwd_dq_kernel<T, DP>, g1, C::kQThreads, C::kQBytes, 1, a.stream,
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.o,
      (const T*)a.dout, a.lse, (T*)a.dq, a.dsum, a.Hq, group, a.Sq, a.Skv,
      a.D, scale_log2, scale, a.causal, vec);
  if (err != cudaSuccess) return err;
  const dim3 g2((unsigned)(a.B * a.Hkv * c),
                (unsigned)((a.Skv + C::kBKV - 1) / C::kBKV));
  return run(mm::bwd_dkv_kernel<T, DP>, g2, C::kKVThreads, C::kKVBytes, c,
             a.stream, (const T*)a.q, (const T*)a.k, (const T*)a.v,
             (const T*)a.dout, a.lse, (const float*)a.dsum, (T*)a.dk,
             (T*)a.dv, a.Hq, group, a.Sq, a.Skv, a.D, scale_log2, scale,
             a.causal, vec);
}

template <typename T>
cudaError_t launch_mma(const Args& a) {
  if (a.D <= 64) return launch_mma<T, 64>(a);
  if (a.D <= 128) return launch_mma<T, 128>(a);
  return launch_mma<T, 256>(a);
}

template <int DP>
cudaError_t launch_wgmma(const Args& a) {
  CUtensorMap tq, tdo, tk, tv, tq2, tdo2, tk2, tv2;
  const int bhq = a.B * a.Hq, bhkv = a.B * a.Hkv;
  if (!sm90::make_map(&tq, a.q, a.D, a.Sq, bhq, wg::kBQ) ||
      !sm90::make_map(&tdo, a.dout, a.D, a.Sq, bhq, wg::kBQ) ||
      !sm90::make_map(&tk, a.k, a.D, a.Skv, bhkv, wg::kBK) ||
      !sm90::make_map(&tv, a.v, a.D, a.Skv, bhkv, wg::kBK) ||
      !sm90::make_map(&tq2, a.q, a.D, a.Sq, bhq, wg::kBQ2) ||
      !sm90::make_map(&tdo2, a.dout, a.D, a.Sq, bhq, wg::kBQ2) ||
      !sm90::make_map(&tk2, a.k, a.D, a.Skv, bhkv, wg::kBKV) ||
      !sm90::make_map(&tv2, a.v, a.D, a.Skv, bhkv, wg::kBKV))
    return cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)a.D));
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)a.D));
  const int group = a.Hq / a.Hkv, c = cluster_size(group);
  using bf = __nv_bfloat16;
  const dim3 g1((unsigned)bhq, (unsigned)((a.Sq + wg::kBQ - 1) / wg::kBQ));
  cudaError_t err =
      run(wg::bwd_dq_wgmma_kernel<DP>, g1, wg::kThreads,
          wg::DqLayout<DP>::kBytes, 1, a.stream, tq, tdo, tk, tv,
          (const bf*)a.o, (const bf*)a.dout, a.lse, (bf*)a.dq, a.dsum, a.Hq,
          group, a.Sq, a.Skv, a.D, scale_log2, scale, a.causal);
  if (err != cudaSuccess) return err;
  const dim3 g2((unsigned)(bhkv * c),
                (unsigned)((a.Skv + wg::kBKV - 1) / wg::kBKV));
  return run(wg::bwd_dkv_wgmma_kernel<DP>, g2, wg::kThreads,
             wg::DkvLayout<DP>::kBytes, c, a.stream, tk2, tv2, tq2, tdo2,
             a.lse, (const float*)a.dsum, (bf*)a.dk, (bf*)a.dv, a.Hq, group,
             a.Sq, a.Skv, a.D, scale_log2, scale, a.causal);
}

}  // namespace

// dq (B, Hq, Sq, D), dk and dv (B, Hkv, Skv, D) in the inputs' type (dtype
// 0 fp32, 1 bf16); lse: the forward's (flash_attention_forward), B * Hq *
// Sq floats; dsum: B * Hq * Sq floats of scratch.  variant: 0 mma, 1 wgmma
// (bf16, D % 8 == 0, D <= 128, q, k, v, o and dout 16-byte aligned), 2
// split (D > 256, clusters).  Two
// launches on `stream`; returns the first cudaError_t that is not success.
extern "C" int flash_attention_backward(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* dout, const void* lse,
                                        void* dq, void* dk, void* dv,
                                        void* dsum, int B, int Hq, int Hkv,
                                        int Sq, int Skv, int D, int causal,
                                        int dtype, int variant,
                                        void* stream) {
  if (D < 1 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Skv < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, dout, static_cast<const float*>(lse), dq, dk, dv,
               static_cast<float*>(dsum), B, Hq, Hkv, Sq, Skv, D, causal,
               (cudaStream_t)stream};
  if (variant == 2) {
    if (D <= kDMax) return (int)cudaErrorInvalidValue;
    const float* l = a.lse;
    if (dtype == 0)
      return (int)split::launch_bwd<float>(q, k, v, o, dout, l, dq, dk, dv,
                                           a.dsum, B, Hq, Hkv, Sq, Skv, D,
                                           causal, a.stream);
    if (dtype == 1)
      return (int)split::launch_bwd<__nv_bfloat16>(q, k, v, o, dout, l, dq,
                                                   dk, dv, a.dsum, B, Hq, Hkv,
                                                   Sq, Skv, D, causal,
                                                   a.stream);
    return (int)cudaErrorInvalidValue;
  }
  if (D > kDMax) return (int)cudaErrorInvalidValue;
  if (variant == 1) {
    if (dtype != 1 || D % 8 != 0 || D > 128) return (int)cudaErrorInvalidValue;
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
         reinterpret_cast<uintptr_t>(dout)) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
    return (int)(D <= 64 ? launch_wgmma<64>(a) : launch_wgmma<128>(a));
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch_mma<float>(a);
  if (dtype == 1) return (int)launch_mma<__nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
