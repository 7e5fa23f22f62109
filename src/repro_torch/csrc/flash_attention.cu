// flash_attention: GQA attention forward with an online softmax, fp32 or
// bf16 in, the input's type out.
//
// Replaces the Pallas TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention/flash_attention.py, body
// _flash_kernel): for q (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D), query head
// h reads kv head h / (Hq / Hkv), and
//
//     o[i] = sum_j softmax_j(q_i . k_j / sqrt(D)) v_j
//
// over the keys j < Skv, and with `causal` only j <= i (the TPU kernel's
// top-left mask, row >= col).  Keys at or past Skv are masked, so a ragged
// last kv tile is right (the TPU kernel reads its padding).  The running
// max m, sum l and accumulator live in registers; l is clamped at 1e-20 as
// the TPU kernel clamps it.  Scores and softmax are fp32.
//
// What bounds it on an H100: at Qwen2-72B's widths (Hq = 64, Hkv = 8,
// D = 128, Sq = Skv = 2048, causal) the products are 68.7 GFLOP
// (chip_smoke.py::flash_flops) against
// 75.5 MB of q, k, v, o in bf16, so the tensor cores bound it: 0.0695 ms
// at 989 bf16 TFLOP/s; in f32, done as three TF32 products, 3 x 68.7
// GFLOP at 495 TFLOP/s = 0.416 ms (on the CUDA cores' 67 TFLOP/s it would
// be 1.03 ms).  Two kernels, and the caller names which one runs
// (`variant`):
//
// * wgmma (bf16, D % 8 == 0, D <= 128, 16-byte aligned): both products on
//   the tensor cores.
//   A block takes 128 query rows of one head: two consumer warpgroups of
//   64 rows each and one producer warpgroup.  One producer thread brings
//   the q tile once and the K and V tiles of 128 keys into a ring of two
//   shared-memory stages by TMA, each stage with a "full" and an "empty"
//   mbarrier, so the copies of tile t + 1 run under the products of tile
//   t.  The tensor maps are 3-d (D, S, B * H): TMA zero-fills rows past Sq
//   or Skv and columns past D (D is padded to 64 or 128 in shared memory)
//   without reading the next head, and writes the 128-byte swizzle that
//   wgmma reads.  S = q k^T is wgmma m64n128k16 from shared memory (both
//   operands D-contiguous); the online softmax runs on the fp32
//   accumulator fragments in registers (exp2 with scale * log2(e) folded
//   into one FMA; the row max over the 4 threads of a row by two shuffles;
//   O rescaled by alpha every tile); P is rounded to bf16 in registers and
//   is the A operand of O += P V (wgmma m64nDk16 with A in registers and V
//   read D-contiguous, i.e. transposed).  Masks are applied only on the
//   tile that crosses Skv and on causal tiles that cross the diagonal;
//   tiles wholly above it are skipped, and the grid runs every head's
//   heaviest causal q tile first (x = b * Hq + h, y = q tiles from the
//   last).  The producer gives up registers (setmaxnreg 40) to the
//   consumers (232).  What still bounds it: within a warpgroup the
//   softmax waits for S and the P V product waits for the softmax, so
//   only the other warpgroup's work overlaps them; one block an SM (161
//   KB of shared memory at D = 128), and a block's prologue (q and the
//   first K tile) and epilogue (O stored from registers) are not
//   overlapped with another block.
//
// * mma (every other call up to D = 256: f32, and bf16 with D % 8 != 0,
//   D > 128 or an operand off 16 bytes, which TMA cannot read): both
//   products on the tensor cores with warp-level mma.sync.  f32 runs in
//   3xTF32 (csrc/tf32x3.cuh: each operand split in registers into a TF32
//   big part and a remainder, three m16n8k8 products, small terms first),
//   which keeps fp32 accuracy where one TF32 pass does not; bf16 runs
//   m16n8k16 with fp32 accumulation, P rounded to bf16 as on the wgmma
//   route.  D is padded to DP = 64, 128 or 256 in shared memory, and the
//   products run over all of DP (padding is zero; a guard on D inside the
//   unrolled loops cut them into blocks the loads could not run ahead
//   across).  A warp owns 16 query rows; a block 8 warps (128 rows) of one
//   head, 4 (64 rows) at DP = 256, where O alone takes 128 registers a
//   lane.  q stays in shared memory for the whole kv sweep; K and V tiles
//   of 64 keys (32 at DP = 256, so that q and two stages of K and V fit in
//   227 KB in fp32) sit in two stages, so the copies of tile t + 1 run
//   under the products of tile t: cp.async in a loop the compiler unrolls
//   where every address and row allows 16-byte pieces (8- or 4-byte
//   pieces otherwise), or, for a bf16 view at 2 bytes past a 4-byte
//   boundary or an odd D, plain loads held in registers across the
//   products and stored after them (two aligned 16-byte loads
//   funnel-shifted into place when D % 8 == 0, one load an element
//   otherwise; stored at once at DP = 256).  The online softmax runs on
//   S's accumulator fragments in registers (the row max and sum over the
//   4 lanes of a row by two shuffles, exp2 with scale * log2(e) folded
//   into one FMA, O rescaled every tile), and P passes from S's fragments
//   to the A fragments of O += P V in registers: an m16n8 accumulator
//   tile is, lane by lane, the A fragment of the next product (bf16: two
//   tiles packed; f32: with k permuted as tf32x3's loads permute it, slots
//   t and t + 4 reading keys 2t and 2t + 1, V's B fragment alike).  bf16
//   fragments come from shared memory by ldmatrix (V transposed), rows
//   padded 16 bytes; f32 rows are padded so each half-warp's 8-byte loads
//   hit 32 banks.  The grid runs every head's heaviest causal q tile
//   first; kv tiles wholly above a warp's rows are skipped by that warp,
//   and the mask is applied only on tiles that cross Skv or the diagonal.
//   What bounds it: in f32 the rate at which mma.sync runs TF32
//   products, which tools/flash_variants.py reads at about 240 TFLOP/s a
//   pass at the Qwen2-72B layer on an H100 SXM (one pass 0.56 ms, three
//   1.13 ms), half of the 495 TFLOP/s that only wgmma reaches, so three
//   passes cannot go below ~0.87 ms there; splitting the remainders in
//   registers (split_fast) and a second accumulator for the small terms
//   gained 6 % and nothing.  In bf16, a 16-row warp reads every K and V
//   fragment from shared memory for 16 rows only, and mma.sync has no
//   asynchronous pipeline to hide the softmax behind.
//
// * split (D > 256, fp32 or bf16): csrc/flash_split.cuh, D cut into
//   slices over the blocks of a thread-block cluster (up to 256 columns a
//   block held, wider slices streamed in pieces and taken in sweeps), each
//   block's partial S summed in rank order through distributed shared
//   memory, the products on mma.sync as on the mma route.
//
// The routes round differently from the TPU kernel, which multiplies p by
// v in fp32: bf16 on either route rounds P to bf16 first, as tensor-core
// flash kernels do; f32 keeps it in 3xTF32.
//
// Given a non-null `lse`, both kernels also store each row's log-sum-exp
// in their softmax's log2 domain (lse2 below), which the backward
// (csrc/flash_attention_bwd.cu) reads instead of rebuilding it; given null
// they store nothing.  The wgmma route's TMA, mbarrier and wgmma helpers
// live in csrc/sm90.cuh, which the backward shares.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_split.cuh"
#include "sm90.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kDMax = 256;     // the widest head of the mma and wgmma routes

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a row's log-sum-exp in the log2 domain of the online softmax: m the
// row's max of q_i . k_j * scale * log2(e), l the sum of exp2 of those
// minus m
__device__ __forceinline__ float lse2(float m, float l) {
  return m == -INFINITY ? 0.f : m + log2f(l);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ---- mma: both products on the tensor cores with mma.sync -----------------

namespace mm {

// copy modes (uniform over a launch): cp.async pieces of 16, 8 or 4 bytes,
// or plain loads (bf16 only): two aligned 16-byte loads shifted into place,
// or one load an element
constexpr int kShifted = 1, kScalar = 2;

// Tiles for operand type T and padded width DP.  Row strides: fp32 q and K
// rows DP + 8 floats (load_a / load_bt: a half-warp's 8-byte loads hit 32
// banks), fp32 V rows DP + 4 (load_b: rows 2t and 2t + 1 hit 32 banks),
// bf16 rows DP + 8 (16 bytes over: ldmatrix's 8 rows hit 8 distinct
// 16-byte bank groups).  Two blocks an SM where shared memory allows,
// but bf16 at DP = 128, which spills under two blocks' 128 registers and
// is faster as one block of up to 255.
template <typename T, int DP>
struct Cfg {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kWarps = DP == 256 ? 4 : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBQ = 16 * kWarps;       // query rows a block
  static constexpr int kBK = DP == 256 ? 32 : 64;  // keys a kv tile
  static constexpr int kLdQK = DP + 8;
  static constexpr int kLdV = kF32 ? DP + 4 : DP + 8;
  static constexpr int kQ = kBQ * kLdQK;        // elements of each buffer
  static constexpr int kK = kBK * kLdQK;
  static constexpr int kV = kBK * kLdV;
  static constexpr int kBytes = (int)sizeof(T) * (kQ + 2 * kK + 2 * kV);
  static constexpr int kMinBlocks =
      2 * (kBytes + 1024) <= 233472 && (kF32 || DP != 128) ? 2 : 1;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                   smem_u32(smem)),
               "l"(gmem));
}

// Rows [0, ROWS) of a tile whose row r starts at src + r * D, columns
// [0, D), by cp.async pieces of `piece` bytes (D * sizeof(T) a multiple);
// rows at or past `valid` are zeroed.  Columns D..DP are left as they are.
template <typename T, int ROWS, int LD, int THREADS, int DP>
__device__ __forceinline__ void copy_async(T* dst, const T* src, int valid,
                                           int D, int piece) {
  constexpr int kPer = 16 / (int)sizeof(T), kCpr = DP / kPer;
  if (piece == 16 && D == DP && ROWS * kCpr % THREADS == 0) {
    // whole rows of 16-byte pieces: a loop the compiler unrolls
#pragma unroll
    for (int i = 0; i < ROWS * kCpr / THREADS; ++i) {
      const int e = threadIdx.x + THREADS * i;
      const int r = e / kCpr, c = e % kCpr * kPer;
      T* d = dst + r * LD + c;
      if (r < valid) tf32x3::cp_async16(d, src + (long long)r * DP + c);
      else *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  const int per = piece / (int)sizeof(T);
  const int cpr = D / per;
  for (int e = threadIdx.x; e < ROWS * cpr; e += THREADS) {
    const int r = e / cpr, c = (e - r * cpr) * per;
    T* d = dst + r * LD + c;
    const T* s = src + (long long)r * D + c;
    if (piece == 16) {
      if (r < valid) tf32x3::cp_async16(d, s);
      else *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    } else if (piece == 8) {
      if (r < valid) cp_async8(d, s);
      else *reinterpret_cast<uint2*>(d) = make_uint2(0u, 0u);
    } else {
      if (r < valid) tf32x3::cp_async4(d, s);
      else *reinterpret_cast<uint32_t*>(d) = 0u;
    }
  }
}

// words Q..Q+4 of w funnel-shifted right by sh bits
template <int Q>
__device__ __forceinline__ uint4 shift_words(const uint32_t (&w)[8], int sh) {
  return make_uint4(__funnelshift_r(w[Q], w[Q + 1], sh),
                    __funnelshift_r(w[Q + 1], w[Q + 2], sh),
                    __funnelshift_r(w[Q + 2], w[Q + 3], sh),
                    __funnelshift_r(w[Q + 3], w[Q + 4], sh));
}

// A bf16 tile by plain loads, held in registers between fetch and store:
// the 16-byte pieces e = threadIdx.x + THREADS * i of the ROWS x DP tile
// (columns past D and rows at or past `valid` zero).  With D % 8 == 0
// every piece of a tensor sits at the same offset s from a 16-byte
// boundary, so the switch on s is taken once a tile and each piece is
// two aligned 16-byte loads funnel-shifted into place (one where s = 0);
// otherwise one load an element.
template <int ROWS, int DP, int THREADS>
struct Staged {
  static constexpr int kN = ROWS * DP / 8 / THREADS;
  static_assert(ROWS * DP / 8 % THREADS == 0, "pieces split evenly");
  uint4 x[kN];

  // Q = s / 4 (s > 0) the first word of a piece in its two blocks; Q < 0
  // for s = 0
  template <int Q>
  __device__ __forceinline__ void fetch_blocks(const __nv_bfloat16* src,
                                               int valid, int D, int sh) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int e = threadIdx.x + THREADS * i;
      const int r = e / (DP / 8), c = e % (DP / 8) * 8;
      x[i] = make_uint4(0u, 0u, 0u, 0u);
      if (r < valid && c < D) {
        const uint4* blk = reinterpret_cast<const uint4*>(
            reinterpret_cast<uintptr_t>(src + (long long)r * D + c) &
            ~uintptr_t(15));
        const uint4 lo = __ldg(blk);
        if constexpr (Q < 0) {
          x[i] = lo;
        } else {
          const uint4 hi = __ldg(blk + 1);
          const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w,
                                 hi.x, hi.y, hi.z, hi.w};
          x[i] = shift_words<Q>(w, sh);
        }
      }
    }
  }

  __device__ __forceinline__ void fetch(const __nv_bfloat16* src, int valid,
                                        int D, int copy) {
    if (copy == kShifted) {
      const int s = (int)(reinterpret_cast<uintptr_t>(src) & 15);
      const int sh = 8 * (s & 3);
      if (s == 0) fetch_blocks<-1>(src, valid, D, sh);
      else if (s < 4) fetch_blocks<0>(src, valid, D, sh);
      else if (s < 8) fetch_blocks<1>(src, valid, D, sh);
      else if (s < 12) fetch_blocks<2>(src, valid, D, sh);
      else fetch_blocks<3>(src, valid, D, sh);
      return;
    }
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int e = threadIdx.x + THREADS * i;
      const int r = e / (DP / 8), c = e % (DP / 8) * 8;
      const unsigned short* h = reinterpret_cast<const unsigned short*>(
          src + (long long)r * D + c);
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = r < valid;
        const uint32_t lo = ok && c + 2 * j < D ? __ldg(h + 2 * j) : 0u;
        const uint32_t hi = ok && c + 2 * j + 1 < D ? __ldg(h + 2 * j + 1)
                                                    : 0u;
        w[j] = lo | hi << 16;
      }
      x[i] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }

  template <int LD>
  __device__ __forceinline__ void store(__nv_bfloat16* dst) const {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int e = threadIdx.x + THREADS * i;
      const int r = e / (DP / 8), c = e % (DP / 8) * 8;
      *reinterpret_cast<uint4*>(dst + r * LD + c) = x[i];
    }
  }
};

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

// S (16 x kBK) = q (my 16 rows) K^T over DP (columns past D are zero:
// no guard splits the unrolled loop, so loads run ahead).  Accumulator
// fragment of an m16n8 tile j, lane 4 g + t: s[j] = (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1) at key 8 j + 2t.
template <typename T, int DP>
__device__ __forceinline__ void scores(float (&s)[Cfg<T, DP>::kBK / 8][4],
                                       const T* qs, const T* kb, int warp,
                                       int lane) {
  using C = Cfg<T, DP>;
#pragma unroll
  for (int j = 0; j < C::kBK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  if constexpr (C::kF32) {
#pragma unroll
    for (int ks = 0; ks < DP / 8; ++ks) {
      const tf32x3::Frag<4> a =
          tf32x3::load_a<true>(qs, C::kLdQK, 16 * warp, 8 * ks, lane);
#pragma unroll
      for (int j = 0; j < C::kBK / 8; ++j)
        tf32x3::mma3(s[j], a, tf32x3::load_bt<true>(kb, C::kLdQK, 8 * j,
                                                     8 * ks, lane));
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, qs + (16 * warp + (lane & 15)) * C::kLdQK + 16 * ks +
                     (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < C::kBK / 16; ++jp) {
        uint32_t b[4];
        ldsm_x4(b, kb + (16 * jp + (lane & 7) + (lane >> 4) * 8) * C::kLdQK +
                       16 * ks + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * jp], a, b[0], b[1]);
        mma_bf16(s[2 * jp + 1], a, b[2], b[3]);
      }
    }
  }
}

// O (16 x DP) += P V, P in S's fragments
template <typename T, int DP>
__device__ __forceinline__ void pv(float (&acc)[DP / 8][4],
                                   const float (&p)[Cfg<T, DP>::kBK / 8][4],
                                   const T* vb, int lane) {
  using C = Cfg<T, DP>;
  if constexpr (C::kF32) {
#pragma unroll
    for (int kk = 0; kk < C::kBK / 8; ++kk) {
      // slots (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4): keys 2t, 2t + 1
      const float pa[4] = {p[kk][0], p[kk][2], p[kk][1], p[kk][3]};
      tf32x3::Frag<4> a;
      tf32x3::split_fast(a, pa);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        tf32x3::mma3(acc[n], a,
                     tf32x3::load_b<true>(vb, C::kLdV, 8 * kk, 8 * n, lane));
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < C::kBK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                             pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                             pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                             pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < DP / 16; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, vb + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  C::kLdV +
                             16 * np + (lane >> 4) * 8);
        mma_bf16(acc[2 * np], a, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
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

// kPlain: the plain-load copies (bf16 only), else cp.async; the tiles
// held in registers across the products take one block an SM.  kLse: the
// rows' log-sum-exp stored too (a template argument, so that the kernel
// without it is the code it was: at DP = 256, where O takes 128 registers
// a lane, the store tips ptxas into spills)
template <typename T, int DP, bool kPlain, bool kLse>
__global__ void __launch_bounds__(Cfg<T, DP>::kThreads,
                                  kPlain ? 1 : Cfg<T, DP>::kMinBlocks)
flash_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Hq, int group, int Sq, int Skv,
                 int D, float scale_log2, int causal, int copy) {
  using C = Cfg<T, DP>;
  extern __shared__ __align__(16) uint8_t mm_smem[];
  T* qs = reinterpret_cast<T*>(mm_smem);
  T* ks = qs + C::kQ;                   // two stages of K
  T* vs = ks + 2 * C::kK;               // two stages of V
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x;                             // b * Hq + h
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::kBQ;  // heavy tiles first
  const long long kvh =
      (long long)(bh / Hq) * (Hq / group) + (bh % Hq) / group;
  const T* qp = q + ((long long)bh * Sq + q0) * D;
  const T* kp = k + kvh * Skv * D;
  const T* vp = v + kvh * Skv * D;
  int n_kt = (Skv + C::kBK - 1) / C::kBK;
  if (causal) n_kt = min(n_kt, (q0 + C::kBQ - 1) / C::kBK + 1);

  // q, K_0 and V_0; the cp.async pieces leave columns D..DP alone, so those
  // are zeroed first
  if constexpr (!kPlain) {
    if (D < DP) {
      uint4* z = reinterpret_cast<uint4*>(mm_smem);
      for (int e = threadIdx.x; e < C::kBytes / 16; e += C::kThreads)
        z[e] = make_uint4(0u, 0u, 0u, 0u);
      __syncthreads();
    }
    copy_async<T, C::kBQ, C::kLdQK, C::kThreads, DP>(qs, qp, Sq - q0, D, copy);
    copy_async<T, C::kBK, C::kLdQK, C::kThreads, DP>(ks, kp, Skv, D, copy);
    copy_async<T, C::kBK, C::kLdV, C::kThreads, DP>(vs, vp, Skv, D, copy);
    tf32x3::cp_async_commit();
  } else {
    {
      Staged<C::kBQ, DP, C::kThreads> sq;
      sq.fetch(qp, Sq - q0, D, copy);
      sq.template store<C::kLdQK>(qs);
    }
    Staged<C::kBK, DP, C::kThreads> sk;
    sk.fetch(kp, Skv, D, copy);
    sk.template store<C::kLdQK>(ks);
    sk.fetch(vp, Skv, D, copy);
    sk.template store<C::kLdV>(vs);
  }

  const int row_lo = q0 + 16 * warp;    // my rows: row_lo + g, row_lo + g + 8
  const int g = lane / 4, t = lane % 4;
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * C::kBK, buf = kt & 1;
    const bool next = kt + 1 < n_kt;
    if constexpr (!kPlain) tf32x3::cp_async_wait<0>();
    __syncthreads();                    // tile kt in, tile kt - 1 read
    const T* kb = ks + buf * C::kK;
    const T* vb = vs + buf * C::kV;
    T* kn = ks + (buf ^ 1) * C::kK;
    T* vn = vs + (buf ^ 1) * C::kV;
    const long long off = (long long)(k0 + C::kBK) * D;
    const int valid = Skv - k0 - C::kBK;          // rows of tile kt + 1
    // plain loads: held in registers across the products of tile kt, but
    // at DP = 256, where O alone takes 128 registers a lane, stored at once
    constexpr bool kHold = DP < 256;
    Staged<C::kBK, DP, C::kThreads> st;
    if (next) {
      if constexpr (!kPlain) {
        copy_async<T, C::kBK, C::kLdQK, C::kThreads, DP>(kn, kp + off, valid,
                                                         D, copy);
        copy_async<T, C::kBK, C::kLdV, C::kThreads, DP>(vn, vp + off, valid,
                                                        D, copy);
        tf32x3::cp_async_commit();
      } else {
        st.fetch(kp + off, valid, D, copy);
        if constexpr (!kHold) {
          st.template store<C::kLdQK>(kn);
          st.fetch(vp + off, valid, D, copy);
          st.template store<C::kLdV>(vn);
        }
      }
    }
    // a warp whose rows all lie above this tile (causal) or past Sq skips
    // its products
    const bool live = row_lo < Sq && !(causal && k0 > row_lo + 15);
    float s[C::kBK / 8][4];
    if (live) scores<T, DP>(s, qs, kb, warp, lane);
    if constexpr (kPlain && kHold) {
      if (next) {
        st.template store<C::kLdQK>(kn);
        st.fetch(vp + off, valid, D, copy);
      }
    }
    if (live) {
      // mask only the tile that crosses Skv and causal tiles that cross the
      // diagonal of my rows
      if (k0 + C::kBK > Skv || (causal && k0 + C::kBK - 1 > row_lo)) {
#pragma unroll
        for (int j = 0; j < C::kBK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + 8 * j + 2 * t + (e & 1);
            const int row = row_lo + g + 8 * (e >> 1);
            const bool hidden = col >= Skv || (causal && col > row);
            if (hidden) s[j][e] = -INFINITY;
          }
      }
      // online softmax in the log2 domain; row i of mine is e >> 1
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < C::kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      float base[2], corr[2], rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float mnew = fmaxf(m_run[i], mx[i] * scale_log2);
        base[i] = mnew == -INFINITY ? 0.f : mnew;
        corr[i] = ex2(m_run[i] - base[i]);
        m_run[i] = mnew;
      }
#pragma unroll
      for (int j = 0; j < C::kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = ex2(fmaf(s[j][e], scale_log2, -base[e >> 1]));
          rsum[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l_run[i] = corr[i] * l_run[i] + rsum[i];
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
      pv<T, DP>(acc, s, vb, lane);
    }
    if constexpr (kPlain && kHold) {
      if (next) st.template store<C::kLdV>(vn);
    }
  }

  // l is a partial sum over my columns: reduce over the row's 4 lanes
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
    const int row = row_lo + g + 8 * i;
    if (kLse && t == 0 && row < Sq)
      lse[(long long)bh * Sq + row] = lse2(m_run[i], l_run[i]);
    l_run[i] = 1.f / fmaxf(l_run[i], 1e-20f);
  }
  const bool pairs =
      D % 2 == 0 && reinterpret_cast<uintptr_t>(o) % (2 * sizeof(T)) == 0;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = 8 * n + 2 * t;
    if (col >= D) break;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_lo + g + 8 * i;
      if (row >= Sq) continue;
      T* dst = o + ((long long)bh * Sq + row) * D + col;
      const float x0 = acc[n][2 * i] * l_run[i];
      const float x1 = acc[n][2 * i + 1] * l_run[i];
      if (pairs) {
        put2(dst, x0, x1);              // D even: col + 1 < D
      } else {
        put(dst, x0);
        if (col + 1 < D) put(dst + 1, x1);
      }
    }
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

template <typename T, int DP, bool kLse>
cudaError_t launch_as(const void* q, const void* k, const void* v, void* o,
                      float* lse, int B, int Hq, int Hkv, int Sq, int Skv,
                      int D, int causal, cudaStream_t stream) {
  using C = Cfg<T, DP>;
  // the largest cp.async piece that every address and row allows, else
  // plain loads (a bf16 operand 2 bytes off a 4-byte boundary, or an odd
  // D)
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  const int row_bytes = D * (int)sizeof(T);
  int copy = 0;
  const int pieces[3] = {16, 8, 4};
  for (const int piece : pieces)
    if (copy == 0 && addr % piece == 0 && row_bytes % piece == 0)
      copy = piece;
  const dim3 grid((unsigned)(B * Hq), (unsigned)((Sq + C::kBQ - 1) / C::kBQ));
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  if (copy != 0)
    return run(flash_mma_kernel<T, DP, false, kLse>, grid, C::kThreads,
               C::kBytes,
               stream, (const T*)q, (const T*)k, (const T*)v, (T*)o, lse,
               Hq, Hq / Hkv, Sq, Skv, D, scale_log2, causal, copy);
  if constexpr (C::kF32) {
    return cudaErrorMisalignedAddress;
  } else {
    return run(flash_mma_kernel<T, DP, true, kLse>, grid, C::kThreads,
               C::kBytes,
               stream, (const T*)q, (const T*)k, (const T*)v, (T*)o, lse,
               Hq, Hq / Hkv, Sq, Skv, D, scale_log2, causal,
               D % 8 == 0 ? kShifted : kScalar);
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Hq, int Hkv, int Sq, int Skv, int D,
                   int causal, cudaStream_t stream) {
  if (lse != nullptr)
    return launch_as<T, DP, true>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, D,
                                  causal, stream);
  return launch_as<T, DP, false>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, D,
                                 causal, stream);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Hq, int Hkv, int Sq, int Skv, int D,
                   int causal, cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, D, causal,
                         stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, D, causal,
                          stream);
  return launch<T, 256>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, D, causal,
                        stream);
}

}  // namespace mm

// ---- wgmma: bf16 products on the tensor cores, TMA-fed --------------------

namespace wg {

constexpr int kBQ = 128;                // query rows per block
constexpr int kBK = 128;                // keys per kv tile
constexpr int kStages = 2;              // K/V ring depth
constexpr int kConsumers = 2;           // warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kHalfBytes = kBK * sm90::kRowBytes;  // 128 rows x 64 columns

// byte offsets from a 1024-aligned base; DP (64 or 128) is D padded
template <int DP>
struct Layout {
  static constexpr int kHalves = DP / 64;
  static constexpr int kTile = kHalves * kHalfBytes;  // q, K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  static constexpr int kBars = 1 + 4 * kStages;
  static constexpr int kBytes = kBar + 8 * kBars + 1024;  // + alignment
};

// Accumulator fragment of wgmma m64nNk16 (fp32), thread t of a warpgroup:
// register r holds row 16 (t / 32) + (t % 32) / 4 + 8 ((r / 2) % 2) and
// column 8 (r / 4) + 2 (t % 4) + r % 2 of the 64 x N tile.
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   int Hq, int group, int Sq, int Skv, int D,
                   float scale_log2, int causal) {
  using L = Layout<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* q_full = bar;
  uint64_t* k_full = bar + 1;
  uint64_t* k_empty = k_full + kStages;
  uint64_t* v_full = k_empty + kStages;
  uint64_t* v_empty = v_full + kStages;

  const int bh = blockIdx.x;                             // b * Hq + h
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;     // heavy tiles first
  int n_kt = (Skv + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q0 + kBQ - 1) / kBK + 1);
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
      sm90::mbar_expect_tx(q_full, L::kTile);
#pragma unroll
      for (int h = 0; h < L::kHalves; ++h)
        sm90::tma_load(smem + L::kQ + h * kHalfBytes, &tq, q_full, 64 * h,
                       q0, bh);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages, ph = (kt / kStages) & 1;
        sm90::mbar_wait(k_empty + s, ph ^ 1);
        sm90::mbar_expect_tx(k_full + s, L::kTile);
#pragma unroll
        for (int h = 0; h < L::kHalves; ++h)
          sm90::tma_load(smem + L::kK + s * L::kTile + h * kHalfBytes, &tk,
                         k_full + s, 64 * h, kt * kBK, kvh);
        sm90::mbar_wait(v_empty + s, ph ^ 1);
        sm90::mbar_expect_tx(v_full + s, L::kTile);
#pragma unroll
        for (int h = 0; h < L::kHalves; ++h)
          sm90::tma_load(smem + L::kV + s * L::kTile + h * kHalfBytes, &tv,
                         v_full + s, 64 * h, kt * kBK, kvh);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ---------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int t = threadIdx.x % 128, lane = t % 32;
    const int row_lo = q0 + 64 * wgi;                    // first row of mine
    const int row0 = row_lo + 16 * (t / 32) + lane / 4;  // and row0 + 8
    const int col0 = 2 * (lane % 4);
    const uint32_t q_base =
        sm90::smem_u32(smem + L::kQ) + 64 * wgi * sm90::kRowBytes;

    float acc[DP / 2];
#pragma unroll
    for (int r = 0; r < DP / 2; ++r) acc[r] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    sm90::mbar_wait(q_full, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % kStages, ph = (kt / kStages) & 1;
      const int k0 = kt * kBK;

      // S = q k^T over D in steps of 16 (32 bytes of a swizzle row)
      float sc[64];
      const uint32_t k_base = sm90::smem_u32(smem + L::kK + s * L::kTile);
      sm90::mbar_wait(k_full + s, ph);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk / 4) * kHalfBytes + (kk % 4) * 32;
        sm90::wgmma_ss(sc, sm90::desc(q_base + off, 16, 8 * sm90::kRowBytes),
                       sm90::desc(k_base + off, 16, 8 * sm90::kRowBytes),
                       kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait();
      sm90::fence_regs(sc);
      sm90::mbar_arrive(k_empty + s);

      // mask only the tile that crosses Skv and causal tiles that cross
      // the diagonal of my rows
      if (k0 + kBK > Skv || (causal && k0 + kBK - 1 > row_lo)) {
#pragma unroll
        for (int r = 0; r < 64; ++r) {
          const int col = k0 + 8 * (r / 4) + col0 + r % 2;
          const int row = row0 + 8 * ((r / 2) % 2);
          if (col >= Skv || (causal && col > row)) sc[r] = -INFINITY;
        }
      }

      // online softmax, in the log2 domain
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int r = 0; r < 64; ++r)
        mx[(r / 2) % 2] = fmaxf(mx[(r / 2) % 2], sc[r]);
      float base[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float mn = fmaxf(m[i], mx[i] * scale_log2);
        base[i] = mn == -INFINITY ? 0.f : mn;
        alpha[i] = ex2(m[i] - base[i]);
        m[i] = mn;
      }
      uint32_t pa[32];
#pragma unroll
      for (int r = 0; r < 64; r += 2) {
        const int i = (r / 2) % 2;
        const float p0 = ex2(fmaf(sc[r], scale_log2, -base[i]));
        const float p1 = ex2(fmaf(sc[r + 1], scale_log2, -base[i]));
        rs[i] += p0 + p1;
        pa[r / 2] = pack_bf16(p0, p1);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = alpha[i] * l[i] + rs[i];
#pragma unroll
      for (int r = 0; r < DP / 2; ++r) acc[r] *= alpha[(r / 2) % 2];

      // O += P V over the 128 keys in steps of 16 (16 rows of V)
      const uint32_t v_base = sm90::smem_u32(smem + L::kV + s * L::kTile);
      sm90::mbar_wait(v_full + s, ph);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        sm90::wgmma_rs(acc, pa + 4 * kk,
                       sm90::desc(v_base + kk * 16 * sm90::kRowBytes,
                                  kHalfBytes, 8 * sm90::kRowBytes));
      sm90::wgmma_commit();
      sm90::wgmma_wait();
      sm90::fence_regs(acc);
      sm90::mbar_arrive(v_empty + s);
    }

    // l is a partial sum over my columns: reduce over the row's 4 threads
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const int row = row0 + 8 * i;
      if (lse != nullptr && col0 == 0 && row < Sq)
        lse[(long long)bh * Sq + row] = lse2(m[i], l[i]);
      l[i] = 1.f / fmaxf(l[i], 1e-20f);
    }
#pragma unroll
    for (int c = 0; c < DP / 8; ++c) {
      const int col = 8 * c + col0;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 8 * i;
        if (row < Sq && col < D) {
          const float x0 = acc[4 * c + 2 * i] * l[i];
          const float x1 = acc[4 * c + 2 * i + 1] * l[i];
          *reinterpret_cast<__nv_bfloat162*>(
              o + ((long long)bh * Sq + row) * D + col) =
              __floats2bfloat162_rn(x0, x1);
        }
      }
    }
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Hq, int Hkv, int Sq, int Skv, int D,
                   int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!sm90::make_map(&tq, q, D, Sq, B * Hq, kBQ) ||
      !sm90::make_map(&tk, k, D, Skv, B * Hkv, kBK) ||
      !sm90::make_map(&tv, v, D, Skv, B * Hkv, kBK))
    return cudaErrorInvalidValue;
  const int smem = Layout<DP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(B * Hq), (unsigned)((Sq + kBQ - 1) / kBQ));
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  flash_wgmma_kernel<DP><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, lse, Hq, Hq / Hkv, Sq, Skv, D,
      scale_log2, causal);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

// variant: 0 mma (dtype 0 float32 or 1 bfloat16), 1 wgmma (bfloat16 with
// D % 8 == 0, D <= 128 and 16-byte aligned q, k, v); q, k, v and o of one
// dtype, D <= 256.  lse: null, or B * Hq * Sq floats that take each row's
// log-sum-exp in the kernels' log2 domain, log2(sum_j exp2(q_i . k_j *
// scale * log2(e))) over the visible keys (lse2 above), which
// flash_attention_bwd reads
// variant: 0 mma, 1 wgmma (bf16, D % 8 == 0, D <= 128, 16-byte aligned),
// 2 split (D > 256, clusters)
extern "C" int flash_attention_forward(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int B, int Hq, int Hkv, int Sq,
                                       int Skv, int D, int causal, int dtype,
                                       int variant, void* stream) {
  if (D < 1 || Hkv < 1 || Hq % Hkv != 0 || Skv < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  float* l = static_cast<float*>(lse);
  if (variant == 2) {
    if (D <= kDMax) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
      return (int)split::launch_fwd<float>(q, k, v, o, l, B, Hq, Hkv, Sq, Skv,
                                           D, causal, st);
    if (dtype == 1)
      return (int)split::launch_fwd<__nv_bfloat16>(q, k, v, o, l, B, Hq, Hkv,
                                                   Sq, Skv, D, causal, st);
    return (int)cudaErrorInvalidValue;
  }
  if (D > kDMax) return (int)cudaErrorInvalidValue;
  if (variant == 1) {
    if (dtype != 1 || D % 8 != 0 || D > 128) return (int)cudaErrorInvalidValue;
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
         reinterpret_cast<uintptr_t>(v)) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
    if (D <= 64)
      return (int)wg::launch<64>(q, k, v, o, l, B, Hq, Hkv, Sq, Skv, D,
                                 causal, st);
    return (int)wg::launch<128>(q, k, v, o, l, B, Hq, Hkv, Sq, Skv, D, causal,
                                st);
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)mm::launch<float>(q, k, v, o, l, B, Hq, Hkv, Sq, Skv, D,
                                  causal, st);
  if (dtype == 1)
    return (int)mm::launch<__nv_bfloat16>(q, k, v, o, l, B, Hq, Hkv, Sq, Skv,
                                          D, causal, st);
  return (int)cudaErrorInvalidValue;
}

namespace {

// out[5..6]: one block a cluster, the slice D padded; no sweeps, no
// backward passes
template <typename T, int DP>
void mm_layout(int* out) {
  using C = mm::Cfg<T, DP>;
  out[0] = C::kBQ;
  out[1] = C::kBK;
  out[2] = DP;
  out[3] = C::kBytes;
  out[4] = C::kThreads;
  out[5] = 1;
  out[6] = DP;
  out[13] = 1;
}

template <int DP>
void wg_layout(int* out) {
  out[0] = wg::kBQ;
  out[1] = wg::kBK;
  out[2] = DP;
  out[3] = wg::Layout<DP>::kBytes;
  out[4] = wg::kThreads;
  out[5] = 1;
  out[6] = DP;
  out[13] = 1;
}

// the split route: the forward's rows, keys and padded slice (its piece
// where streamed); its shared memory, threads, blocks a cluster and slice
// width; then each backward pass's blocks a cluster, slice and shared
// memory; then each pass's sweeps (split::layout)
template <typename T>
void split_layout(int D, int* out) {
  int lay[15];
  split::layout<T>(D, lay);
  out[0] = split::kRows;
  out[1] = split::kTile;
  out[2] = lay[2];
  out[3] = lay[3];
  out[4] = split::kThreads;
  out[5] = lay[0];
  out[6] = lay[1];
  out[7] = lay[5];
  out[8] = lay[6];
  out[9] = lay[8];
  out[10] = lay[10];
  out[11] = lay[11];
  out[12] = lay[13];
  out[13] = lay[4];
  out[14] = lay[9];
  out[15] = lay[14];
}

}  // namespace

// the tiles flash_attention_forward (and, on the split routes,
// flash_attention_backward) launches for a route (variant and dtype as it
// takes them) and D: {query rows a block, keys a kv tile, D padded (a
// block's slice of it on the split route, a piece of that where it
// streams), a block's shared memory bytes, threads, blocks a cluster,
// columns of D a block, then the dQ pass's blocks a cluster, slice and
// shared memory and the dK/dV pass's (0 where the route's backward is not
// reported), then the forward's, the dQ pass's and the dK/dV pass's
// sweeps}: 16 ints; 0, or an error for a route the call cannot take
extern "C" int flash_attention_layout(int variant, int dtype, int D,
                                      int* out) {
  for (int i = 0; i < 16; ++i) out[i] = 0;
  if (variant == 2) {
    if (D <= kDMax || (dtype != 0 && dtype != 1))
      return (int)cudaErrorInvalidValue;
    if (dtype == 0)
      split_layout<float>(D, out);
    else
      split_layout<__nv_bfloat16>(D, out);
    return 0;
  }
  if (D < 1 || D > kDMax) return (int)cudaErrorInvalidValue;
  if (variant == 1) {
    if (dtype != 1 || D % 8 != 0 || D > 128) return (int)cudaErrorInvalidValue;
    if (D <= 64)
      wg_layout<64>(out);
    else
      wg_layout<128>(out);
    return 0;
  }
  if (variant != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (D <= 64)
      mm_layout<float, 64>(out);
    else if (D <= 128)
      mm_layout<float, 128>(out);
    else
      mm_layout<float, 256>(out);
  } else {
    if (D <= 64)
      mm_layout<__nv_bfloat16, 64>(out);
    else if (D <= 128)
      mm_layout<__nv_bfloat16, 128>(out);
    else
      mm_layout<__nv_bfloat16, 256>(out);
  }
  return 0;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
