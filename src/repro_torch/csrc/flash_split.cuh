// flash_split.cuh: flash_attention's split route, forward
// (flash_attention.cu) and backward (flash_attention_bwd.cu), for every
// head wider than the tensor-core routes' 256 columns.  bf16 or fp32 in,
// the input's type out; every product on the tensor cores with mma.sync
// (bf16 m16n8k16 with fp32 accumulation, fragments by ldmatrix; fp32 in
// 3xTF32 through tf32x3.cuh), as the mma route of those files.
//
// What bounds it on an H100: the products, as on the other routes (at B =
// 1, 8 heads, S = 2048, causal, D = 512: 34.4 GFLOP forward, 0.035 ms at
// 989 bf16 TFLOP/s, three times that at the TF32 peak in 3xTF32).  What
// stands in the way is that a 16-row warp's output slice lives in
// registers (16 x 256 fp32 = 128 a lane), so no block holds a whole head
// past 256.  The design: D is cut into c slices of w columns (plan()
// below), one block of a thread-block cluster each.  A block of 4 warps
// takes 64 rows (query rows; keys in the dK/dV pass) and its slice, keeps
// its slice of O (dQ; dK and dV) in registers, and forms only its partial
// S_r = q[:, slice_r] k[:, slice_r]^T (and dP_r = dO[:, slice_r]
// v[:, slice_r]^T) of each kv tile.  Each warp stores its partial tile in
// fragment order in the block's shared memory; after a cluster barrier
// every block reads the c partials of its warps' tiles through
// distributed shared memory (map_shared_rank) and sums them in rank order,
// so every block holds the same S, bit for bit, runs the same online
// softmax (the same m, l and P) and accumulates P v[:, slice_r] into its
// slice.  Two buffers of partials, tile t in buffer t % 2, where they fit
// and cost no block an SM: one cluster barrier a tile.  Else one buffer
// (the bf16 forward at wp = 256, whose second block an SM it would cost,
// the fp32 dQ pass, past 227 KB, and the fp32 dK/dV pass, whose second
// block an SM it would cost) and a second barrier, arrived at once a
// block has read the partials and waited on just before the next tile's
// partials are stored.  A block reads its own partial from its shared
// memory, the others' through the cluster.  Nothing crosses blocks but
// those partials: no atomics, and the same inputs give the same bits.
//
// * forward: a block's q slice stays in shared memory; K and V slices of
//   kTile keys in two stages, loaded by cp.async under the products of the
//   tile before.  Rank 0 stores the rows' log-sum-exp in the log2 domain
//   of the other routes.
// * dQ pass: D_i = dO_i . O_i as per-slice partials summed the same way
//   (rank 0 stores them in dsum), then per kv tile the partials of S and
//   dP exchanged together, P = exp2(S scale log2(e) - lse_i), dS = P (dP -
//   D_i), dq_slice += dS k[:, slice].
// * dK/dV pass: keys are the rows, the group's query heads walked in
//   order; per query tile the partials of S^T and dP^T exchanged, dv_slice
//   += P^T dO[:, slice], dk_slice += dS^T q[:, slice].  dK and dV both
//   live in registers, so a pass holds half as many columns (kDkvWMax).
//
// Past 8 slices.  A portable cluster has kMaxCluster blocks, so past 8
// slices a block's slice is wider than its pass holds in registers (256
// columns of O or dQ, 128 of dK and of dV).
// * dK/dV pass, 1024 < D <= 2048: a non-portable cluster of up to
//   kDkvCluster blocks of 128 columns, as above.  (The alternative, 8
//   blocks of up to 256 columns in two sweeps of half a slice each, forms
//   S and dP twice and holds one block an SM in fp32: 1.62x slower in
//   fp32 and 1.45x in bf16 on an H100 at D = 1040.)
// * any pass, slices past 256 columns (D > 2048 in the forward and the dQ
//   pass, past 16 slices of 128 in the dK/dV pass): the streamed kernels
//   below, in sweeps.  Sweep j is a cluster of its own (grid x runs over
//   heads, sweeps and ranks), which forms the same full partial S (and
//   dP) over the block's whole slice, exchanges it as above, and
//   accumulates only its own piece of the output.  The slice is cut into
//   pieces of kPiece columns; for each tile a block loads its rows' and
//   the tile's piece at a time and sums the pieces' products into its
//   partial (the sweep's own piece last, so its q, K, dO or V is still in
//   shared memory for the output's product).  No slice stays resident, so
//   any D runs, the products of S paid once a piece and a sweep; one stage
//   and one buffer: no speed was sought.
//
// The backward's two partial products of a tile run in one k loop
// (gemm_nt2), which doubles the independent accumulators a warp has in
// flight; its tiles are 16 rows in the fp32 dK/dV pass (two blocks an
// SM).  The constants that pick these (tiles, slice widths, ranks in
// flight) and the buffers and the fusion are the choices
// tools/flash_variants.py times one at a time.  Where a row or an address is off 16 bytes (an odd D in
// bf16): fp32 is copied an element at a time by cp.async; bf16 tiles that
// stream are copied as each row's aligned 16-byte blocks, by cp.async into
// the second stage, and shifted into the first once they land (place_tile);
// the tiles loaded once, and every tile of the streamed kernels, by plain
// loads of those blocks, shifted in registers (load16).
//
// bf16 rounds P (and dS) to bf16 before their products, as the other
// routes do.  A cluster launch the card refuses returns its error; the
// caller raises.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tf32x3.cuh"

namespace split {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;       // 4 warps of 16 rows
constexpr int kDqThreads = 256;     // the dQ pass's: 2 warps a 16 rows
constexpr int kRows = 64;           // rows a block
constexpr int kTile = 32;           // keys a kv tile (forward); rows a
                                    //   tile of the backward's passes
constexpr int kDqTileF32 = 32;      //   but fp32's dQ pass
constexpr int kDkvTileF32 = 16;     //   and dK/dV pass (see Dq, Dkv)
constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr int kDkvCluster = 16;     // the dK/dV pass's, non-portable
constexpr int kFwdWMax = 256;       // columns a pass holds: forward
constexpr int kDqWMax = 256;        //   dQ pass
constexpr int kDkvWMax = 128;       //   dK/dV pass (two accumulators)
constexpr int kResMax = 256;        // widest slice kept in shared memory
constexpr int kPiece = 128;         // columns a piece (streamed kernels)
constexpr int kSmemMax = 232448;    // shared memory a block can have
constexpr int kSmemSm = 233472;     // shared memory of an SM

// blocks of kThreads an SM holds with `bytes` of shared memory each (1 KB
// more each for the system; the registers hold two at up to 255 a thread)
__host__ __device__ constexpr int sm_blocks(int bytes) {
  return kSmemSm / (bytes + 1024) < 2 ? kSmemSm / (bytes + 1024) : 2;
}

// buffers of partial tiles of a pass taking `one` bytes with one buffer
// of `part` bytes: two (one cluster barrier a tile) where they fit and
// cost no block an SM, else one (two barriers a tile)
__host__ __device__ constexpr int bufs(int one, int part) {
  return one + part <= kSmemMax && sm_blocks(one + part) >= sm_blocks(one)
             ? 2
             : 1;
}

// D cut into c slices of w columns (w a multiple of 16, the last slice
// zero-padded) for a pass holding wmax columns in registers: c =
// ceil(D / wmax) where that is at most cmax, else kMaxCluster (past
// kMaxCluster blocks, a cluster the card may refuse: the dK/dV pass asks
// for up to kDkvCluster).  A slice up to kResMax wide (then at most
// wmax) is padded to wp (128, 192 or 256) in shared memory, one sweep; a
// wider one (past cmax slices) streams (`stream`) in pieces of wp =
// kPiece columns, one sweep a piece.
struct Plan {
  int c, w, wp, sweeps, stream;
};

__host__ __device__ constexpr int padded(int w) {
  return w <= 128 ? 128 : w <= 192 ? 192 : 256;
}

__host__ __device__ constexpr Plan plan(int D, int wmax,
                                        int cmax = kMaxCluster) {
  const int c0 = (D + wmax - 1) / wmax;
  const int c = c0 <= cmax ? c0 : kMaxCluster;
  const int w = ((D + c - 1) / c + 15) / 16 * 16;
  if (w > kResMax) return Plan{c, w, kPiece, (w + kPiece - 1) / kPiece, 1};
  return Plan{c, w, padded(w), 1, 0};
}

// ---- tiles and shared memory of each pass ---------------------------------

// forward: q (64 rows), two stages of K and V (kTile keys), the buffers
// of one partial S tile (fp32, in fragment order)
template <typename T, int WP>
struct Fwd {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kLdQK = WP + 8;
  static constexpr int kLdV = kF32 ? WP + 4 : WP + 8;
  static constexpr int kQ = kRows * kLdQK;
  static constexpr int kK = kTile * kLdQK;
  static constexpr int kV = kTile * kLdV;
  static constexpr int kPart = kRows * kTile;             // floats
  static constexpr int kOne =
      4 * kPart + (int)sizeof(T) * (kQ + 2 * kK + 2 * kV);
  static constexpr int kBufs = bufs(kOne, 4 * kPart);
  static constexpr int kBytes = kOne + (kBufs - 1) * 4 * kPart;
};

// The backward's tiles: kTile rows in bf16; in fp32 kDqTileF32 and
// kDkvTileF32 (16 gives the fp32 dK/dV pass two blocks an SM; the fp32
// dQ pass at wp = 256 would take two stages and two buffers at 16, one of
// each at 32, and runs faster at 32: tools/flash_variants.py).
template <typename T>
__host__ __device__ constexpr int bwd_tile(int f32) {
  return sizeof(T) == 4 ? f32 : kTile;
}

// dQ pass: q and dO (64 rows), their LSE and D (in shared memory, not in
// the registers the fp32 pass is short of), K and V tiles of kBK keys in
// two stages where they fit with one buffer, the buffers of the partials
// of S and dP
template <typename T, int WP>
struct Dq {
  static constexpr int kBK = bwd_tile<T>(kDqTileF32);
  static constexpr int kLd = WP + 8;
  static constexpr int kPart = 2 * kRows * kBK;           // S and dP
  static constexpr int kFixed =
      4 * kPart + (int)sizeof(T) * 2 * kRows * kLd + 4 * 2 * kRows;
  static constexpr int kStage = (int)sizeof(T) * 2 * kBK * kLd;
  static constexpr int kStages = kFixed + 2 * kStage <= kSmemMax ? 2 : 1;
  static constexpr int kBufs = bufs(kFixed + kStages * kStage, 4 * kPart);
  static constexpr int kBytes =
      kFixed + kStages * kStage + (kBufs - 1) * 4 * kPart;
};

// dK/dV pass: K and V (64 keys), two stages of q, dO (kBQ rows) and their
// LSE and D, the buffers of the partials of S^T and dP^T
template <typename T>
struct Dkv {
  static constexpr int kBQ = bwd_tile<T>(kDkvTileF32);
  static constexpr int kWP = padded(kDkvWMax);
  static constexpr int kLd = kWP + 8;
  static constexpr int kPart = 2 * kRows * kBQ;           // S^T and dP^T
  static constexpr int kKV = (int)sizeof(T) * 2 * kRows * kLd;
  static constexpr int kStage =
      (int)sizeof(T) * 2 * kBQ * kLd + 2 * kBQ * 4;
  static constexpr int kOne = 4 * kPart + kKV + 2 * kStage;
  static constexpr int kBufs = bufs(kOne, 4 * kPart);
  static constexpr int kBytes = kOne + (kBufs - 1) * 4 * kPart;
};

// ---- primitives -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// the cluster barrier in two halves: arrive (release: this thread's
// shared-memory writes visible to the cluster) and wait (acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The exchange's barriers.  One buffer: a block waits, before it stores
// a tile's partials, until every block has read the last tile's (the
// arrive of xch_read, after its reads); xch_open arrives once so that the
// first tile's wait passes.  Two buffers (tile t in buffer t % 2): a block
// stores tile t's partials after the barrier of tile t - 1, by which every
// block has read tile t - 2's.  xch_close: no block leaves while another
// may still read its shared memory.
template <int BUFS>
__device__ __forceinline__ void xch_open() {
  if constexpr (BUFS == 1) cluster_arrive();
}
template <int BUFS>
__device__ __forceinline__ void xch_store() {
  if constexpr (BUFS == 1) cluster_wait();
}
__device__ __forceinline__ void xch_stored() {
  cluster_arrive();
  cluster_wait();
}
template <int BUFS>
__device__ __forceinline__ void xch_read() {
  if constexpr (BUFS == 1) cluster_arrive();
}
template <int BUFS>
__device__ __forceinline__ void xch_close() {
  if constexpr (BUFS == 1) {
    cluster_wait();
  } else {
    cluster_arrive();
    cluster_wait();
  }
}

// ---- tiles ----------------------------------------------------------------

// bytes [s, s + 16) of the 32 bytes lo, hi (s < 16)
__device__ __forceinline__ uint4 shift16(const uint4& lo, const uint4& hi,
                                         int s) {
  const int q = s >> 2;
  const uint32_t sh = 8u * (uint32_t)(s & 3);
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  uint32_t o[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    o[i] = q == 0 ? w[i] : q == 1 ? w[i + 1] : q == 2 ? w[i + 2] : w[i + 3];
  return make_uint4(__funnelshift_r(o[0], o[1], sh),
                    __funnelshift_r(o[1], o[2], sh),
                    __funnelshift_r(o[2], o[3], sh),
                    __funnelshift_r(o[3], o[4], sh));
}

// The 16 bytes at p (aligned to 2 bytes at least) from the two aligned
// 16-byte blocks that hold them.  Both blocks hold a byte of the 16, so
// neither crosses a page the 16 do not touch.
__device__ __forceinline__ uint4 load16(const void* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint4* blk = reinterpret_cast<const uint4*>(a & ~uintptr_t(15));
  const int s = (int)(a & 15);
  const uint4 lo = __ldg(blk);
  return s == 0 ? lo : shift16(lo, __ldg(blk + 1), s);
}

// the bf16 elements of x at columns c + i >= cols cleared
__device__ __forceinline__ uint4 clip8(uint4 x, int c, int cols) {
  uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (c + 2 * i >= cols) w[i] = 0u;
    else if (c + 2 * i + 1 >= cols) w[i] &= 0xffffu;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// How load_tile copies: kVec, cp.async in 16-byte pieces (src and ld *
// sizeof(T) 16-byte multiples, so cols is a multiple of a piece); kPlain,
// fp32 by cp.async an element (fp32 rows are 4-byte aligned), bf16 by
// plain loads (load16; a piece that crosses `cols` an element at a
// time); kRaw (bf16), cp.async of each row's aligned 16-byte blocks that
// hold a valid byte into dst as they are (rows LD = WP + 8 apart), which
// place_tile shifts into a tile once they land.  The caller commits and
// waits for the cp.async copies.
constexpr int kVec = 0, kPlain = 1, kRaw = 2;

// Rows [0, ROWS) and columns [0, WP) of a tile whose row r starts at src +
// r * ld (elements) into dst (rows LD apart): rows at or past `rows` and
// columns at or past `cols` are zero (kRaw: see above).
template <typename T, int ROWS, int WP, int LD, int THREADS = kThreads>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long ld,
                                          int rows, int cols, int mode) {
  constexpr int kPer = 16 / (int)sizeof(T), kCpr = WP / kPer;
  using Bits = std::conditional_t<sizeof(T) == 4, uint32_t, uint16_t>;
  const Bits* s = reinterpret_cast<const Bits*>(src);
  if (mode == kVec) {
#pragma unroll 4
    for (int e = threadIdx.x; e < ROWS * kCpr; e += THREADS) {
      const int r = e / kCpr, c = e % kCpr * kPer;
      T* d = dst + r * LD + c;
      if (r < rows && c < cols)
        tf32x3::cp_async16(d, src + r * ld + c);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else if constexpr (sizeof(T) == 4) {
    for (int e = threadIdx.x; e < ROWS * WP; e += THREADS) {
      const int r = e / WP, c = e % WP;
      T* d = dst + r * LD + c;
      if (r < rows && c < cols) tf32x3::cp_async4(d, src + r * ld + c);
      else *d = 0.f;
    }
  } else if (mode == kRaw) {
    constexpr int kBlocks = kCpr + 1;
    static_assert(kBlocks * kPer <= LD, "a raw row fits a tile row");
    for (int e = threadIdx.x; e < ROWS * kBlocks; e += THREADS) {
      const int r = e / kBlocks, b = e % kBlocks;
      const uintptr_t row = reinterpret_cast<uintptr_t>(src + r * ld);
      const uintptr_t blk = (row & ~uintptr_t(15)) + 16 * b;
      T* d = dst + r * LD + b * kPer;
      if (r < rows && blk < row + 2 * (uintptr_t)max(cols, 0))
        tf32x3::cp_async16(d, reinterpret_cast<const void*>(blk));
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
#pragma unroll 2
    for (int e = threadIdx.x; e < ROWS * kCpr; e += THREADS) {
      const int r = e / kCpr, c = e % kCpr * kPer;
      T* d = dst + r * LD + c;
      if (r < rows && c + kPer <= cols) {
        *reinterpret_cast<uint4*>(d) = load16(src + r * ld + c);
      } else {
        Bits* b = reinterpret_cast<Bits*>(d);
#pragma unroll
        for (int i = 0; i < kPer; ++i)
          b[i] = r < rows && c + i < cols ? s[r * ld + c + i] : Bits(0);
      }
    }
  }
}

// bf16: the tile load_tile(kRaw) copied to raw (the same src, rows, cols),
// shifted into dst once the copies have landed and every thread sees them
template <typename T, int ROWS, int WP, int LD, int THREADS = kThreads>
__device__ __forceinline__ void place_tile(T* dst, const T* raw,
                                           const T* src, long long ld,
                                           int rows, int cols) {
  if constexpr (sizeof(T) == 2) {
    constexpr int kCpr = WP / 8;
    for (int e = threadIdx.x; e < ROWS * kCpr; e += THREADS) {
      const int r = e / kCpr, c = e % kCpr * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows && c < cols) {
        const int sb =
            (int)(reinterpret_cast<uintptr_t>(src + r * ld) & 15);
        const uint4* p = reinterpret_cast<const uint4*>(raw + r * LD + c);
        x = sb == 0 ? p[0] : shift16(p[0], p[1], sb);
        if (c + 8 > cols) x = clip8(x, c, cols);
      }
      *reinterpret_cast<uint4*>(dst + r * LD + c) = x;
    }
  }
}

// ROWS floats from src into dst by cp.async, zero at or past `valid`
template <int ROWS, int THREADS = kThreads>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int valid) {
  for (int r = threadIdx.x; r < ROWS; r += THREADS) {
    if (r < valid) tf32x3::cp_async4(dst + r, src + r);
    else dst[r] = 0.f;
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

// s (16 x NC) = A[row0, row0 + 16) · B^T over WP columns, A and B
// row-major tiles in shared memory with rows LD apart (B's NC rows are s's
// columns).  Accumulator fragment of the m16n8 tile j, lane 4 g + t: s[j] =
// (g, 8 j + 2t), (g, 8 j + 2t + 1), (g + 8, 8 j + 2t), (g + 8, 8 j + 2t + 1).
// (ZERO false: s += A · B^T)
template <typename T, int WP, int NC, int LD, bool ZERO = true>
__device__ __forceinline__ void gemm_nt(float (&s)[NC / 8][4], const T* a,
                                        int row0, const T* b, int lane) {
  if constexpr (ZERO) zero(s);
  if constexpr (sizeof(T) == 4) {
#pragma unroll 2
    for (int ks = 0; ks < WP / 8; ++ks) {
      const tf32x3::Frag<4> fa =
          tf32x3::load_a<true>(a, LD, row0, 8 * ks, lane);
#pragma unroll
      for (int j = 0; j < NC / 8; ++j)
        tf32x3::mma3(s[j], fa,
                     tf32x3::load_bt<true>(b, LD, 8 * j, 8 * ks, lane));
    }
  } else {
#pragma unroll 2
    for (int ks = 0; ks < WP / 16; ++ks) {
      uint32_t fa[4];
      ldsm_x4(fa, a + (row0 + (lane & 15)) * LD + 16 * ks + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < NC / 16; ++jp) {
        uint32_t fb[4];
        ldsm_x4(fb, b + (16 * jp + (lane & 7) + (lane >> 4) * 8) * LD +
                        16 * ks + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * jp], fa, fb[0], fb[1]);
        mma_bf16(s[2 * jp + 1], fa, fb[2], fb[3]);
      }
    }
  }
}

// The backward's two partial products of a tile at once, s = A · B^T and
// t = A2 · B2^T (A and A2 row-major with the same rows, B and B2 with NC
// rows), in one k loop: twice the independent accumulators in flight
// (ZERO false: s and t accumulate).
template <typename T, int WP, int NC, int LD, bool ZERO = true>
__device__ __forceinline__ void gemm_nt2(float (&s)[NC / 8][4],
                                         float (&t)[NC / 8][4], const T* a,
                                         const T* a2, int row0, const T* b,
                                         const T* b2, int lane) {
  if constexpr (ZERO) {
    zero(s);
    zero(t);
  }
  if constexpr (sizeof(T) == 4) {
#pragma unroll 2
    for (int ks = 0; ks < WP / 8; ++ks) {
      const tf32x3::Frag<4> fa =
          tf32x3::load_a<true>(a, LD, row0, 8 * ks, lane);
      const tf32x3::Frag<4> fa2 =
          tf32x3::load_a<true>(a2, LD, row0, 8 * ks, lane);
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        tf32x3::mma3(s[j], fa,
                     tf32x3::load_bt<true>(b, LD, 8 * j, 8 * ks, lane));
        tf32x3::mma3(t[j], fa2,
                     tf32x3::load_bt<true>(b2, LD, 8 * j, 8 * ks, lane));
      }
    }
  } else {
#pragma unroll 2
    for (int ks = 0; ks < WP / 16; ++ks) {
      uint32_t fa[4], fa2[4];
      const int ar = (row0 + (lane & 15)) * LD + 16 * ks + (lane >> 4) * 8;
      ldsm_x4(fa, a + ar);
      ldsm_x4(fa2, a2 + ar);
#pragma unroll
      for (int jp = 0; jp < NC / 16; ++jp) {
        uint32_t fb[4], fb2[4];
        const int br = (16 * jp + (lane & 7) + (lane >> 4) * 8) * LD +
                       16 * ks + ((lane >> 3) & 1) * 8;
        ldsm_x4(fb, b + br);
        ldsm_x4(fb2, b2 + br);
        mma_bf16(s[2 * jp], fa, fb[0], fb[1]);
        mma_bf16(t[2 * jp], fa2, fb2[0], fb2[1]);
        mma_bf16(s[2 * jp + 1], fa, fb[2], fb[3]);
        mma_bf16(t[2 * jp + 1], fa2, fb2[2], fb2[3]);
      }
    }
  }
}

// acc (16 x NN) += p (16 x NK, in accumulator fragments) · B[0, NK) x [0,
// NN), B a row-major tile in shared memory with rows LD apart.  An m16n8
// accumulator tile is, lane by lane, the A fragment of the next product
// (bf16: two tiles packed, so p is rounded to bf16; fp32: keys 2t and 2t +
// 1 in slots t and t + 4, as tf32x3's loads permute k).
template <typename T, int NK, int NN, int LD>
__device__ __forceinline__ void gemm_pv(float (&acc)[NN / 8][4],
                                        const float (&p)[NK / 8][4],
                                        const T* b, int lane) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int kk = 0; kk < NK / 8; ++kk) {
      const float pa[4] = {p[kk][0], p[kk][2], p[kk][1], p[kk][3]};
      tf32x3::Frag<4> a;
      tf32x3::split_fast(a, pa);
#pragma unroll
      for (int n = 0; n < NN / 8; ++n)
        tf32x3::mma3(acc[n], a, tf32x3::load_b<true>(b, LD, 8 * kk, 8 * n,
                                                     lane));
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
                                  LD +
                              16 * np + (lane >> 4) * 8);
        mma_bf16(acc[2 * np], a, fb[0], fb[1]);
        mma_bf16(acc[2 * np + 1], a, fb[2], fb[3]);
      }
    }
  }
}

// ---- the exchange of partial tiles ----------------------------------------

// this warp's partial tile s (16 x 8 NT) into x, in fragment order: lane
// l's four values of n tile j at float4 (warp NT + j) 32 + l
template <int NT>
__device__ __forceinline__ void put_part(float* x, const float (&s)[NT][4],
                                         int warp, int lane) {
  float4* p = reinterpret_cast<float4*>(x) + warp * NT * 32 + lane;
#pragma unroll
  for (int j = 0; j < NT; ++j)
    p[32 * j] = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
}

// s += this warp's partial tile at x (put_part's layout), then s into x
template <int NT>
__device__ __forceinline__ void add_part(float* x, float (&s)[NT][4],
                                         int warp, int lane) {
  float4* p = reinterpret_cast<float4*>(x) + warp * NT * 32 + lane;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float4 o = p[32 * j];
    s[j][0] += o.x;
    s[j][1] += o.y;
    s[j][2] += o.z;
    s[j][3] += o.w;
    p[32 * j] = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
  }
}

// the two warps rg and rg + 4 of a 256-thread block (named barrier 1 + rg)
__device__ __forceinline__ void pair_sync(int rg) {
  asm volatile("bar.sync %0, 64;" ::"r"(1 + rg) : "memory");
}

// s = the sum over the cluster's blocks, in rank order, of their partial
// tiles at x (put_part's layout), RANKS ranks' loads in flight at a time
// (ranks_a_round: two in bf16, one in fp32, each the faster there by
// tools/flash_variants.py)
constexpr int kRanksBf16 = 2, kRanksF32 = 1;
template <typename T>
__host__ __device__ constexpr int ranks_a_round() {
  return sizeof(T) == 4 ? kRanksF32 : kRanksBf16;
}
template <int RANKS, int NT>
__device__ __forceinline__ void sum_parts(float (&s)[NT][4], float* x,
                                          int warp, int lane) {
  cg::cluster_group cl = cg::this_cluster();
  const int c = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int at = warp * NT * 32 + lane;
  // this block's own partial from its shared memory, the others' through
  // the cluster's window
  auto part = [&](int r) {
    return reinterpret_cast<const float4*>(
               r == rank ? x : cl.map_shared_rank(x, r)) + at;
  };
  for (int r = 0; r < c; r += RANKS) {
    const bool two = RANKS == 2 && r + 1 < c;
    const float4* p0 = part(r);
    float4 a[NT], b[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) a[j] = p0[32 * j];
    if (two) {
      const float4* p1 = part(r + 1);
#pragma unroll
      for (int j = 0; j < NT; ++j) b[j] = p1[32 * j];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (r == 0) {
        s[j][0] = a[j].x;
        s[j][1] = a[j].y;
        s[j][2] = a[j].z;
        s[j][3] = a[j].w;
      } else {
        s[j][0] += a[j].x;
        s[j][1] += a[j].y;
        s[j][2] += a[j].z;
        s[j][3] += a[j].w;
      }
      if (two) {
        s[j][0] += b[j].x;
        s[j][1] += b[j].y;
        s[j][2] += b[j].z;
        s[j][3] += b[j].w;
      }
    }
  }
}

// rows row0 + g, row0 + g + 8 of a 16 x NN accumulator, row i times
// mul[i], into dst (rows ld elements apart) at columns 8 n + 2 t below
// `cols`, rows below `rows`; pairs: two elements a store (cols and ld
// even, dst aligned to two)
template <typename T, int NN>
__device__ __forceinline__ void store_rows(T* dst, long long ld,
                                           const float (&acc)[NN / 8][4],
                                           const float (&mul)[2], int row0,
                                           int rows, int cols, bool pairs,
                                           int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int n = 0; n < NN / 8; ++n) {
    const int col = 8 * n + 2 * t;
    if (col >= cols) break;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + g + 8 * i;
      if (row >= rows) continue;
      T* p = dst + row * ld + col;
      const float x0 = acc[n][2 * i] * mul[i];
      const float x1 = acc[n][2 * i + 1] * mul[i];
      if (pairs) {
        put2(p, x0, x1);
      } else {
        put(p, x0);
        if (col + 1 < cols) put(p + 1, x1);
      }
    }
  }
}

// ---- forward --------------------------------------------------------------

// One kv tile of the forward's online softmax in the log2 domain, on a
// warp's summed S tile s (16 rows from row_lo by keys from k0): keys past
// Skv (or, causal, past a row) masked, the rows' running max m_run and sum
// l_run (a partial over the lane's columns) updated, acc rescaled and s
// replaced by P.  Row i of the lane's is e >> 1.
template <int NA>
__device__ __forceinline__ void softmax_tile(float (&s)[kTile / 8][4],
                                             float (&acc)[NA][4],
                                             float (&m_run)[2],
                                             float (&l_run)[2], int k0,
                                             int row_lo, int Skv, int causal,
                                             float scale_log2, int lane) {
  const int g = lane / 4, t = lane % 4;
  if (k0 + kTile > Skv || (causal && k0 + kTile - 1 > row_lo)) {
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        const int row = row_lo + g + 8 * (e >> 1);
        if (col >= Skv || (causal && col > row)) s[j][e] = -INFINITY;
      }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j)
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
  for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = ex2(fmaf(s[j][e], scale_log2, -base[e >> 1]));
      rsum[e >> 1] += s[j][e];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l_run[i] = corr[i] * l_run[i] + rsum[i];
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
}

// The forward's end for a warp's 16 rows from row_lo: l reduced over the
// row's 4 lanes, the log-sum-exp into lse at rows base + row (where lse is
// not null), O = acc / l into dst (rows D apart), its first `cols` columns
template <typename T, int NN>
__device__ __forceinline__ void finish_rows(T* dst, int D,
                                            const float (&acc)[NN / 8][4],
                                            const float (&m_run)[2],
                                            float (&l_run)[2], float* lse,
                                            long long base, int row_lo,
                                            int Sq, int cols, int lane) {
  const int g = lane / 4, t = lane % 4;
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
    const int row = row_lo + g + 8 * i;
    if (lse != nullptr && t == 0 && row < Sq)
      lse[base + row] =
          m_run[i] == -INFINITY ? 0.f : m_run[i] + log2f(l_run[i]);
    inv[i] = 1.f / fmaxf(l_run[i], 1e-20f);
  }
  const bool pairs =
      D % 2 == 0 && reinterpret_cast<uintptr_t>(dst) % (2 * sizeof(T)) == 0;
  if (row_lo < Sq)
    store_rows<T, NN>(dst, D, acc, inv, row_lo, Sq, cols, pairs, lane);
}

// grid (B Hq c, query tiles from the last), clusters of c along x: block
// rank r of the cluster at x takes head x / c, columns [r w, r w + w)
template <typename T, int WP>
__global__ void __launch_bounds__(kThreads, 1)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o,
           float* __restrict__ lse, int Hq, int group, int Sq, int Skv, int D,
           int w, float scale_log2, int causal, int vec) {
  using C = Fwd<T, WP>;
  extern __shared__ __align__(16) uint8_t fwd_smem[];
  float* xch = reinterpret_cast<float*>(fwd_smem);
  T* qs = reinterpret_cast<T*>(xch + C::kBufs * C::kPart);
  T* ks = qs + C::kQ;                   // two stages of K
  T* vs = ks + 2 * C::kK;               // two stages of V
  cg::cluster_group cl = cg::this_cluster();
  const int c = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x / c;                          // b * Hq + h
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;   // heavy tiles first
  const long long kvh =
      (long long)(bh / Hq) * (Hq / group) + (bh % Hq) / group;
  const int col0 = rank * w, cols = min(w, D - col0);
  const T* qp = q + ((long long)bh * Sq + q0) * D + col0;
  const T* kp = k + kvh * Skv * D + col0;
  const T* vp = v + kvh * Skv * D + col0;
  int n_kt = (Skv + kTile - 1) / kTile;
  if (causal) n_kt = min(n_kt, (min(q0 + kRows, Sq) - 1) / kTile + 1);

  // bf16 rows off 16 bytes stream through stage 1 as raw blocks, placed
  // into stage 0 a tile at a time
  const bool raw = sizeof(T) == 2 && !vec;
  const int mode = vec ? kVec : raw ? kRaw : kPlain;
  load_tile<T, kRows, WP, C::kLdQK>(qs, qp, D, Sq - q0, cols,
                                    vec ? kVec : kPlain);
  load_tile<T, kTile, WP, C::kLdQK>(ks + raw * C::kK, kp, D, Skv, cols, mode);
  load_tile<T, kTile, WP, C::kLdV>(vs + raw * C::kV, vp, D, Skv, cols, mode);
  tf32x3::cp_async_commit();
  xch_open<C::kBufs>();

  const int row_lo = q0 + 16 * warp;    // my rows: row_lo + g, row_lo + g + 8
  float acc[WP / 8][4];
  zero(acc);
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile, buf = kt & 1;
    tf32x3::cp_async_wait<0>();
    __syncthreads();                    // tile kt in, tile kt - 1 read
    if (raw) {
      const long long off = (long long)k0 * D;
      place_tile<T, kTile, WP, C::kLdQK>(ks, ks + C::kK, kp + off, D,
                                         Skv - k0, cols);
      place_tile<T, kTile, WP, C::kLdV>(vs, vs + C::kV, vp + off, D,
                                        Skv - k0, cols);
      __syncthreads();                  // placed; stage 1 free
    }
    const int cur = raw ? 0 : buf, next = raw ? 1 : buf ^ 1;
    if (kt + 1 < n_kt) {
      const long long off = (long long)(k0 + kTile) * D;
      load_tile<T, kTile, WP, C::kLdQK>(ks + next * C::kK, kp + off, D,
                                        Skv - k0 - kTile, cols, mode);
      load_tile<T, kTile, WP, C::kLdV>(vs + next * C::kV, vp + off, D,
                                       Skv - k0 - kTile, cols, mode);
      tf32x3::cp_async_commit();
    }
    const T* kb = ks + cur * C::kK;
    const T* vb = vs + cur * C::kV;
    // a warp whose rows all lie above this tile (causal) or past Sq skips
    // its products and its exchange, in every block of the cluster alike
    const bool live = row_lo < Sq && !(causal && k0 > row_lo + 15);
    float s[kTile / 8][4];
    if (live) gemm_nt<T, WP, kTile, C::kLdQK>(s, qs, 16 * warp, kb, lane);
    float* x = xch + (kt % C::kBufs) * C::kPart;
    xch_store<C::kBufs>();
    if (live) put_part(x, s, warp, lane);
    xch_stored();
    if (live) sum_parts<ranks_a_round<T>()>(s, x, warp, lane);
    xch_read<C::kBufs>();
    if (!live) continue;
    softmax_tile(s, acc, m_run, l_run, k0, row_lo, Skv, causal, scale_log2,
                 lane);
    gemm_pv<T, kTile, WP, C::kLdV>(acc, s, vb, lane);
  }
  xch_close<C::kBufs>();
  finish_rows<T, WP>(o + (long long)bh * Sq * D + col0, D, acc, m_run, l_run,
                     rank == 0 ? lse : nullptr, (long long)bh * Sq, row_lo,
                     Sq, cols, lane);
}

// ---- backward: dQ pass ----------------------------------------------------

// the rows' D_i = dO_i . O_i over the cluster's slices (each block's
// partial over its `cols` columns from col0, summed in rank order through
// xd, a buffer of partials), into di_rows, and their LSE into lse_rows,
// for the 16 rows from row_lo of warp rg; rank 0 of sweep 0 stores D_i in
// dsum.  Leaves the exchange as xch_read leaves it.
template <typename T>
__device__ __forceinline__ void dq_rows(const T* dout, const T* o,
                                        const float* lse, float* dsum,
                                        float* xd, float* lse_rows,
                                        float* di_rows, long long base,
                                        int q0, int Sq, int D, int col0,
                                        int cols, bool first, int rg,
                                        bool active, int lane) {
  cg::cluster_group cl = cg::this_cluster();
  const int c = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int g = lane / 4, t = lane % 4;
  const int row_lo = q0 + 16 * rg;
  if (active) {
#pragma unroll 4
    for (int r = 0; r < 16; ++r) {
      float a = 0.f;
      if (row_lo + r < Sq) {
        const long long at = (base + 16 * rg + r) * D + col0;
        for (int cc = lane; cc < cols; cc += 32)
          a += to_f32(dout[at + cc]) * to_f32(o[at + cc]);
      }
      a = warp_sum(a);
      if (lane == 0) xd[16 * rg + r] = a;
    }
  }
  xch_stored();
  if (active) {
    float di[2] = {0.f, 0.f};
    for (int r = 0; r < c; ++r) {
      const float* x = r == rank ? xd : cl.map_shared_rank(xd, r);
#pragma unroll
      for (int i = 0; i < 2; ++i) di[i] += x[16 * rg + g + 8 * i];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_lo + g + 8 * i;
      if (t == 0) {
        lse_rows[16 * rg + g + 8 * i] =
            row < Sq ? lse[base + 16 * rg + g + 8 * i] : 0.f;
        di_rows[16 * rg + g + 8 * i] = di[i];
      }
      if (first && rank == 0 && t == 0 && row < Sq)
        dsum[base + 16 * rg + g + 8 * i] = di[i];
    }
  }
}

// dS = P (dP - D_i) on a warp's summed S and dP tiles (16 rows from
// row_lo by keys from k0; rows' LSE and D_i at lse_rows, di_rows), into s
template <int NK>
__device__ __forceinline__ void dq_ds(float (&s)[NK / 8][4],
                                      const float (&dp)[NK / 8][4],
                                      const float* lse_rows,
                                      const float* di_rows, int k0,
                                      int row_lo, int Skv, int causal,
                                      float scale_log2, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < NK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + 8 * j + 2 * t + (e & 1);
      const int row = row_lo + g + 8 * (e >> 1);
      const bool hidden = col >= Skv || (causal && col > row);
      const float p = hidden ? 0.f
                             : ex2(fmaf(s[j][e], scale_log2,
                                        -lse_rows[g + 8 * (e >> 1)]));
      s[j][e] = p * (dp[j][e] - di_rows[g + 8 * (e >> 1)]);
    }
}


// grid (B Hq c, query tiles from the last), clusters of c along x.  Two
// warps a 16 rows (kDqThreads), warp ch of them over columns [ch WP / 2,
// + WP / 2) of the slice: each keeps half the rows' dQ slice in registers
// (the whole takes 128 a lane at WP = 256 and, beside S, dP and the
// exchange, spills) and forms S and dP over its half, which the pair sums
// (ch 0's + ch 1's) into the block's partial before the cluster's
// exchange.
template <typename T, int WP>
__global__ void __launch_bounds__(kDqThreads, 1)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ o,
          const T* __restrict__ dout, const float* __restrict__ lse,
          T* __restrict__ dq, float* __restrict__ dsum, int Hq, int group,
          int Sq, int Skv, int D, int w, float scale_log2, float scale,
          int causal, int vec) {
  using C = Dq<T, WP>;
  constexpr int kLd = C::kLd, kStages = C::kStages, kBufs = C::kBufs;
  constexpr int kBK = C::kBK, kH = WP / 2, kN = kDqThreads;
  constexpr int kPart = kRows * kBK;          // floats of one partial
  extern __shared__ __align__(16) uint8_t dq_smem[];
  float* xch = reinterpret_cast<float*>(dq_smem);   // (S, dP) a buffer
  T* qs = reinterpret_cast<T*>(xch + kBufs * C::kPart);
  T* dos = qs + kRows * kLd;
  T* ks = dos + kRows * kLd;            // kStages K tiles, then V tiles
  T* vs = ks + kStages * kBK * kLd;
  float* lse_rows = reinterpret_cast<float*>(vs + kStages * kBK * kLd);
  float* di_rows = lse_rows + kRows;    // D_i summed over the cluster
  cg::cluster_group cl = cg::this_cluster();
  const int c = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp % 4, ch = warp / 4;   // row group, column ch
  const int bh = blockIdx.x / c;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const long long kvh =
      (long long)(bh / Hq) * (Hq / group) + (bh % Hq) / group;
  const long long base = (long long)bh * Sq + q0;   // row of (B*Hq*Sq)
  const int col0 = rank * w, cols = min(w, D - col0);
  const T* kp = k + kvh * Skv * D + col0;
  const T* vp = v + kvh * Skv * D + col0;
  int n_kt = (Skv + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (min(q0 + kRows, Sq) - 1) / kBK + 1);
  // bf16 rows off 16 bytes stream through stage 1 as raw blocks, placed
  // into stage 0 a tile at a time (bf16 always has two stages)
  const bool raw = sizeof(T) == 2 && !vec && kStages == 2;
  const int mode = vec ? kVec : raw ? kRaw : kPlain;
  auto load_kv = [&](int kt, int buf) {
    const long long off = (long long)kt * kBK * D;
    const int valid = Skv - kt * kBK;
    load_tile<T, kBK, WP, kLd, kN>(ks + buf * kBK * kLd, kp + off, D, valid,
                                   cols, mode);
    load_tile<T, kBK, WP, kLd, kN>(vs + buf * kBK * kLd, vp + off, D, valid,
                                   cols, mode);
  };
  load_tile<T, kRows, WP, kLd, kN>(qs, q + base * D + col0, D, Sq - q0,
                                   cols, vec ? kVec : kPlain);
  load_tile<T, kRows, WP, kLd, kN>(dos, dout + base * D + col0, D, Sq - q0,
                                   cols, vec ? kVec : kPlain);
  load_kv(0, raw);
  tf32x3::cp_async_commit();

  // D_i = dO_i . O_i: my slice's partial of my 16 rows (ch 0's warps),
  // one row at a time over the warp, from device memory while the tiles
  // land; then the cluster's partials summed in rank order (rank 0 stores
  // them for the dK/dV pass), through the last buffer, which tile 0 leaves
  // alone
  const int row_lo = q0 + 16 * rg;      // my rows: row_lo + g, row_lo + g + 8
  dq_rows(dout, o, lse, dsum, xch + (kBufs - 1) * 2 * kPart, lse_rows,
          di_rows, base, q0, Sq, D, col0, cols, true, rg, ch == 0, lane);
  xch_read<kBufs>();
  const bool live_rows = row_lo < Sq;

  // dS = P (dO V^T - D), dq += dS K
  float acc[kH / 8][4];
  zero(acc);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK, buf = kStages == 2 ? kt & 1 : 0;
    if (kStages == 1 && kt > 0) {
      __syncthreads();                  // tile kt - 1 read
      load_kv(kt, 0);
      tf32x3::cp_async_commit();
    }
    tf32x3::cp_async_wait<0>();
    __syncthreads();                    // tile kt in; tile kt - 1 read
    if (raw) {
      const long long off = (long long)k0 * D;
      place_tile<T, kBK, WP, kLd, kN>(ks, ks + kBK * kLd, kp + off, D,
                                      Skv - k0, cols);
      place_tile<T, kBK, WP, kLd, kN>(vs, vs + kBK * kLd, vp + off, D,
                                      Skv - k0, cols);
      __syncthreads();                  // placed; stage 1 free
    }
    const int cur = raw ? 0 : buf;
    if (kStages == 2 && kt + 1 < n_kt) {
      load_kv(kt + 1, raw ? 1 : buf ^ 1);
      tf32x3::cp_async_commit();
    }
    const bool live = live_rows && !(causal && k0 > row_lo + 15);
    const T* kb = ks + cur * kBK * kLd + ch * kH;
    const T* vb = vs + cur * kBK * kLd + ch * kH;
    float s[kBK / 8][4], dp[kBK / 8][4];
    if (live)
      gemm_nt2<T, kH, kBK, kLd>(s, dp, qs + ch * kH, dos + ch * kH,
                                16 * rg, kb, vb, lane);
    float* x = xch + (kt % kBufs) * 2 * kPart;
    xch_store<kBufs>();
    // the pair's halves summed into the block's partial: ch 1's stored,
    // then ch 0 adds its own and stores the sum
    if (live && ch == 1) {
      put_part(x, s, rg, lane);
      put_part(x + kPart, dp, rg, lane);
    }
    pair_sync(rg);
    if (live && ch == 0) {
      add_part(x, s, rg, lane);
      add_part(x + kPart, dp, rg, lane);
    }
    xch_stored();
    if (live) {
      sum_parts<ranks_a_round<T>()>(s, x, rg, lane);
      sum_parts<ranks_a_round<T>()>(dp, x + kPart, rg, lane);
    }
    xch_read<kBufs>();
    if (!live) continue;
    dq_ds<kBK>(s, dp, lse_rows + 16 * rg, di_rows + 16 * rg, k0, row_lo, Skv,
               causal, scale_log2, lane);
    gemm_pv<T, kBK, kH, kLd>(acc, s, kb, lane);
  }
  xch_close<kBufs>();
  const float mul[2] = {scale, scale};
  const bool pairs =
      D % 2 == 0 && reinterpret_cast<uintptr_t>(dq) % (2 * sizeof(T)) == 0;
  if (live_rows)
    store_rows<T, kH>(dq + (long long)bh * Sq * D + col0 + ch * kH, D, acc,
                      mul, row_lo, Sq, cols - ch * kH, pairs, lane);
}

// ---- backward: dK/dV pass -------------------------------------------------

// a warp's 16 keys from key_lo of dV and dK (times scale), their first
// `cols` columns, at dk + off and dv + off (rows D apart)
template <typename T, int NN>
__device__ __forceinline__ void store_kv(T* dk, T* dv,
                                         const float (&adk)[NN / 8][4],
                                         const float (&adv)[NN / 8][4],
                                         long long off, int D, int key_lo,
                                         int Skv, int cols, float scale,
                                         int lane) {
  const bool pairs = D % 2 == 0 &&
                     (reinterpret_cast<uintptr_t>(dk) |
                      reinterpret_cast<uintptr_t>(dv)) % (2 * sizeof(T)) == 0;
  if (key_lo < Skv) {
    const float one[2] = {1.f, 1.f}, mul[2] = {scale, scale};
    store_rows<T, NN>(dv + off, D, adv, one, key_lo, Skv, cols, pairs, lane);
    store_rows<T, NN>(dk + off, D, adk, mul, key_lo, Skv, cols, pairs, lane);
  }
}

// grid (B Hkv c, key tiles), clusters of c along x; key tile 0, which sees
// every query row when causal, first
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ dsum,
           T* __restrict__ dk, T* __restrict__ dv, int Hq, int group, int Sq,
           int Skv, int D, int w, float scale_log2, float scale, int causal,
           int vec) {
  using C = Dkv<T>;
  constexpr int WP = C::kWP, kLd = C::kLd, kBufs = C::kBufs;
  constexpr int kBQ = C::kBQ;
  constexpr int kPart = kRows * kBQ;
  extern __shared__ __align__(16) uint8_t dkv_smem[];
  float* xch = reinterpret_cast<float*>(dkv_smem);  // (S^T, dP^T) a buffer
  T* ks = reinterpret_cast<T*>(xch + kBufs * C::kPart);
  T* vs = ks + kRows * kLd;
  uint8_t* stages = reinterpret_cast<uint8_t*>(vs + kRows * kLd);
  cg::cluster_group cl = cg::this_cluster();
  const int c = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bkv = blockIdx.x / c;               // b * Hkv + hkv
  const int hkv_n = Hq / group;
  const int b = bkv / hkv_n, hkv = bkv % hkv_n;
  const int k0 = blockIdx.y * kRows;
  const long long kvbase = (long long)bkv * Skv + k0;
  const int col0 = rank * w, cols = min(w, D - col0);
  const int qt0 = causal ? k0 / kBQ : 0;
  const int nq = max(0, (Sq + kBQ - 1) / kBQ - qt0);
  const int n_it = group * nq;
  // stage buf of iteration it: q, dO, LSE and D of query tile qt0 + it % nq
  // of the group's head it / nq
  // bf16 rows off 16 bytes: q and dO stream through stage 1 as raw blocks,
  // placed into stage 0 a tile at a time (the LSE and D rows stay in the
  // stage of their iteration)
  const bool raw = sizeof(T) == 2 && !vec;
  const int mode = vec ? kVec : raw ? kRaw : kPlain;
  auto stage_q = [&](int buf) {
    return reinterpret_cast<T*>(stages + buf * C::kStage);
  };
  // query tile it's row base in (B * Hq * Sq) and first row
  auto tile_of = [&](int it, long long& qbase, int& i0) {
    const long long bh = (long long)b * Hq + (long long)hkv * group + it / nq;
    i0 = (qt0 + it % nq) * kBQ;
    qbase = bh * Sq + i0;
  };
  auto load_stage = [&](int it, int buf) {
    long long qbase;
    int i0;
    tile_of(it, qbase, i0);
    T* qs = stage_q(raw ? 1 : buf);
    T* dos = qs + kBQ * kLd;
    float* rows =
        reinterpret_cast<float*>(stage_q(buf) + 2 * kBQ * kLd);
    load_tile<T, kBQ, WP, kLd>(qs, q + qbase * D + col0, D, Sq - i0, cols,
                                 mode);
    load_tile<T, kBQ, WP, kLd>(dos, dout + qbase * D + col0, D, Sq - i0,
                                 cols, mode);
    load_rows<kBQ>(rows, lse + qbase, Sq - i0);
    load_rows<kBQ>(rows + kBQ, dsum + qbase, Sq - i0);
  };
  load_tile<T, kRows, WP, kLd>(ks, k + kvbase * D + col0, D, Skv - k0, cols,
                               vec ? kVec : kPlain);
  load_tile<T, kRows, WP, kLd>(vs, v + kvbase * D + col0, D, Skv - k0, cols,
                               vec ? kVec : kPlain);
  if (n_it > 0) load_stage(0, 0);
  tf32x3::cp_async_commit();
  xch_open<kBufs>();

  const int key_lo = k0 + 16 * warp;    // my keys: key_lo + g, key_lo + g + 8
  float adk[WP / 8][4], adv[WP / 8][4];
  zero(adk);
  zero(adv);
  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    tf32x3::cp_async_wait<0>();
    __syncthreads();                    // stage it in; stage it - 1 read
    long long qbase;
    int i0;
    tile_of(it, qbase, i0);
    if (raw) {
      T* q0s = stage_q(0);
      const T* q1s = stage_q(1);
      place_tile<T, kBQ, WP, kLd>(q0s, q1s, q + qbase * D + col0, D,
                                    Sq - i0, cols);
      place_tile<T, kBQ, WP, kLd>(q0s + kBQ * kLd, q1s + kBQ * kLd,
                                    dout + qbase * D + col0, D, Sq - i0,
                                    cols);
      __syncthreads();                  // placed; stage 1's tiles free
    }
    if (it + 1 < n_it) {
      load_stage(it + 1, buf ^ 1);
      tf32x3::cp_async_commit();
    }
    const bool live =
        key_lo < Skv && !(causal && key_lo > i0 + kBQ - 1);
    const T* qs = stage_q(raw ? 0 : buf);
    const T* dos = qs + kBQ * kLd;
    const float* lse_s =
        reinterpret_cast<const float*>(stage_q(buf) + 2 * kBQ * kLd);
    const float* dsum_s = lse_s + kBQ;
    float s[kBQ / 8][4], dp[kBQ / 8][4];
    if (live) {
      // S^T and dP^T
      gemm_nt2<T, WP, kBQ, kLd>(s, dp, ks, vs, 16 * warp, qs, dos, lane);
    }
    float* x = xch + (it % kBufs) * 2 * kPart;
    xch_store<kBufs>();
    if (live) {
      put_part(x, s, warp, lane);
      put_part(x + kPart, dp, warp, lane);
    }
    xch_stored();
    if (live) {
      sum_parts<ranks_a_round<T>()>(s, x, warp, lane);
      sum_parts<ranks_a_round<T>()>(dp, x + kPart, warp, lane);
    }
    xch_read<kBufs>();
    if (!live) continue;
#pragma unroll
    for (int j = 0; j < kBQ / 8; ++j)
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
    gemm_pv<T, kBQ, WP, kLd>(adv, s, dos, lane);
    gemm_pv<T, kBQ, WP, kLd>(adk, dp, qs, lane);
  }
  tf32x3::cp_async_wait<0>();
  xch_close<kBufs>();
  store_kv<T, WP>(dk, dv, adk, adv, (long long)bkv * Skv * D + col0, D,
                  key_lo, Skv, cols, scale, lane);
}

// ---- the streamed kernels: slices past kResMax ----------------------------

// Pieces of kPiece columns, rows kLdP apart (V's ld_pv() in fp32, for
// load_b); one stage a tile, one buffer of partials.
constexpr int kLdP = kPiece + 8;
template <typename T>
__host__ __device__ constexpr int ld_pv() {
  return sizeof(T) == 4 ? kPiece + 4 : kLdP;
}

// forward: q's rows, K and V pieces of kTile keys, one partial S tile
template <typename T>
struct FwdS {
  static constexpr int kPart = kRows * kTile;             // floats
  static constexpr int kBytes =
      4 * kPart + (int)sizeof(T) * ((kRows + kTile) * kLdP +
                                    kTile * ld_pv<T>());
};

// dQ pass: q's and dO's rows, K and V pieces of kBK keys, the partials of
// S and dP, the rows' LSE and D
template <typename T>
struct DqS {
  static constexpr int kBK = bwd_tile<T>(kDqTileF32);
  static constexpr int kPart = 2 * kRows * kBK;
  static constexpr int kBytes = 4 * kPart +
                                (int)sizeof(T) * 2 * (kRows + kBK) * kLdP +
                                4 * 2 * kRows;
};

// dK/dV pass: K's and V's rows, q and dO pieces of kBQ rows and their LSE
// and D, the partials of S^T and dP^T
template <typename T>
struct DkvS {
  static constexpr int kBQ = bwd_tile<T>(kDkvTileF32);
  static constexpr int kPart = 2 * kRows * kBQ;
  static constexpr int kBytes = 4 * kPart +
                                (int)sizeof(T) * 2 * (kRows + kBQ) * kLdP +
                                4 * 2 * kBQ;
};

// the i-th piece a sweep j of `np` loads: the others first, its own last
__device__ __forceinline__ int piece(int i, int j, int np) {
  return (j + 1 + i) % np * kPiece;
}

// grid (B Hq sweeps c, query tiles from the last), clusters of c along x:
// block rank r of cluster x / c takes head x / c / sweeps, slice [r w, r w
// + w) and writes O's piece x / c % sweeps of it
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
fwd_stream_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o,
                  float* __restrict__ lse, int Hq, int group, int Sq,
                  int Skv, int D, int w, int sweeps, float scale_log2,
                  int causal, int vec) {
  using C = FwdS<T>;
  constexpr int kLdV = ld_pv<T>();
  extern __shared__ __align__(16) uint8_t fs_smem[];
  float* xch = reinterpret_cast<float*>(fs_smem);
  T* qs = reinterpret_cast<T*>(xch + C::kPart);
  T* ks = qs + kRows * kLdP;
  T* vs = ks + kTile * kLdP;
  cg::cluster_group cl = cg::this_cluster();
  const int c = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x / c / sweeps, j = blockIdx.x / c % sweeps;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const long long kvh =
      (long long)(bh / Hq) * (Hq / group) + (bh % Hq) / group;
  const int col0 = rank * w, cols = min(w, D - col0);
  const T* qp = q + ((long long)bh * Sq + q0) * D + col0;
  const T* kp = k + kvh * Skv * D + col0;
  const T* vp = v + kvh * Skv * D + col0;
  int n_kt = (Skv + kTile - 1) / kTile;
  if (causal) n_kt = min(n_kt, (min(q0 + kRows, Sq) - 1) / kTile + 1);
  const int mode = vec ? kVec : kPlain;
  xch_open<1>();

  const int row_lo = q0 + 16 * warp;
  float acc[kPiece / 8][4];
  zero(acc);
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    const long long off = (long long)k0 * D;
    const bool live = row_lo < Sq && !(causal && k0 > row_lo + 15);
    float s[kTile / 8][4];
    zero(s);
    for (int i = 0; i < sweeps; ++i) {
      const int pc = piece(i, j, sweeps);
      __syncthreads();                  // the last piece read
      load_tile<T, kRows, kPiece, kLdP>(qs, qp + pc, D, Sq - q0, cols - pc,
                                        mode);
      load_tile<T, kTile, kPiece, kLdP>(ks, kp + off + pc, D, Skv - k0,
                                        cols - pc, mode);
      if (i == sweeps - 1)
        load_tile<T, kTile, kPiece, kLdV>(vs, vp + off + pc, D, Skv - k0,
                                          cols - pc, mode);
      tf32x3::cp_async_commit();
      tf32x3::cp_async_wait<0>();
      __syncthreads();                  // the piece in, for all
      if (live)
        gemm_nt<T, kPiece, kTile, kLdP, false>(s, qs, 16 * warp, ks, lane);
    }
    xch_store<1>();
    if (live) put_part(xch, s, warp, lane);
    xch_stored();
    if (live) sum_parts<ranks_a_round<T>()>(s, xch, warp, lane);
    xch_read<1>();
    if (!live) continue;
    softmax_tile(s, acc, m_run, l_run, k0, row_lo, Skv, causal, scale_log2,
                 lane);
    gemm_pv<T, kTile, kPiece, kLdV>(acc, s, vs, lane);
  }
  xch_close<1>();
  finish_rows<T, kPiece>(o + (long long)bh * Sq * D + col0 + j * kPiece, D,
                         acc, m_run, l_run,
                         rank == 0 && j == 0 ? lse : nullptr,
                         (long long)bh * Sq, row_lo, Sq, cols - j * kPiece,
                         lane);
}

// grid (B Hq sweeps c, query tiles from the last), clusters of c along x,
// as fwd_stream_kernel; 4 warps of 16 rows
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
dq_stream_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ o,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 T* __restrict__ dq, float* __restrict__ dsum, int Hq,
                 int group, int Sq, int Skv, int D, int w, int sweeps,
                 float scale_log2, float scale, int causal, int vec) {
  using C = DqS<T>;
  constexpr int kBK = C::kBK, kPart = kRows * kBK;
  extern __shared__ __align__(16) uint8_t dqs_smem[];
  float* xch = reinterpret_cast<float*>(dqs_smem);  // S, then dP
  T* qs = reinterpret_cast<T*>(xch + C::kPart);
  T* dos = qs + kRows * kLdP;
  T* ks = dos + kRows * kLdP;
  T* vs = ks + kBK * kLdP;
  float* lse_rows = reinterpret_cast<float*>(vs + kBK * kLdP);
  float* di_rows = lse_rows + kRows;
  cg::cluster_group cl = cg::this_cluster();
  const int c = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x / c / sweeps, j = blockIdx.x / c % sweeps;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const long long kvh =
      (long long)(bh / Hq) * (Hq / group) + (bh % Hq) / group;
  const long long base = (long long)bh * Sq + q0;
  const int col0 = rank * w, cols = min(w, D - col0);
  const T* qp = q + base * D + col0;
  const T* dop = dout + base * D + col0;
  const T* kp = k + kvh * Skv * D + col0;
  const T* vp = v + kvh * Skv * D + col0;
  int n_kt = (Skv + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (min(q0 + kRows, Sq) - 1) / kBK + 1);
  const int mode = vec ? kVec : kPlain;
  const int row_lo = q0 + 16 * warp;
  dq_rows(dout, o, lse, dsum, xch, lse_rows, di_rows, base, q0, Sq, D, col0,
          cols, j == 0, warp, true, lane);
  xch_read<1>();
  const bool live_rows = row_lo < Sq;

  float acc[kPiece / 8][4];
  zero(acc);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    const long long off = (long long)k0 * D;
    const bool live = live_rows && !(causal && k0 > row_lo + 15);
    float s[kBK / 8][4], dp[kBK / 8][4];
    zero(s);
    zero(dp);
    for (int i = 0; i < sweeps; ++i) {
      const int pc = piece(i, j, sweeps);
      __syncthreads();                  // the last piece read
      load_tile<T, kRows, kPiece, kLdP>(qs, qp + pc, D, Sq - q0, cols - pc,
                                        mode);
      load_tile<T, kRows, kPiece, kLdP>(dos, dop + pc, D, Sq - q0,
                                        cols - pc, mode);
      load_tile<T, kBK, kPiece, kLdP>(ks, kp + off + pc, D, Skv - k0,
                                      cols - pc, mode);
      load_tile<T, kBK, kPiece, kLdP>(vs, vp + off + pc, D, Skv - k0,
                                      cols - pc, mode);
      tf32x3::cp_async_commit();
      tf32x3::cp_async_wait<0>();
      __syncthreads();                  // the piece in, for all
      if (live)
        gemm_nt2<T, kPiece, kBK, kLdP, false>(s, dp, qs, dos, 16 * warp, ks,
                                              vs, lane);
    }
    xch_store<1>();
    if (live) {
      put_part(xch, s, warp, lane);
      put_part(xch + kPart, dp, warp, lane);
    }
    xch_stored();
    if (live) {
      sum_parts<ranks_a_round<T>()>(s, xch, warp, lane);
      sum_parts<ranks_a_round<T>()>(dp, xch + kPart, warp, lane);
    }
    xch_read<1>();
    if (!live) continue;
    dq_ds<kBK>(s, dp, lse_rows + 16 * warp, di_rows + 16 * warp, k0, row_lo,
               Skv, causal, scale_log2, lane);
    gemm_pv<T, kBK, kPiece, kLdP>(acc, s, ks, lane);   // K's piece j
  }
  xch_close<1>();
  const float mul[2] = {scale, scale};
  const bool pairs =
      D % 2 == 0 && reinterpret_cast<uintptr_t>(dq) % (2 * sizeof(T)) == 0;
  if (live_rows)
    store_rows<T, kPiece>(dq + (long long)bh * Sq * D + col0 + j * kPiece, D,
                          acc, mul, row_lo, Sq, cols - j * kPiece, pairs,
                          lane);
}

// grid (B Hkv sweeps c, key tiles), clusters of c along x; 4 warps of 16
// keys, the group's query heads walked in order as dkv_kernel's
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
dkv_stream_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ dsum, T* __restrict__ dk,
                  T* __restrict__ dv, int Hq, int group, int Sq, int Skv,
                  int D, int w, int sweeps, float scale_log2, float scale,
                  int causal, int vec) {
  using C = DkvS<T>;
  constexpr int kBQ = C::kBQ, kPart = kRows * kBQ;
  extern __shared__ __align__(16) uint8_t dkvs_smem[];
  float* xch = reinterpret_cast<float*>(dkvs_smem);  // S^T, then dP^T
  T* ks = reinterpret_cast<T*>(xch + C::kPart);
  T* vs = ks + kRows * kLdP;
  T* qs = vs + kRows * kLdP;
  T* dos = qs + kBQ * kLdP;
  float* lse_s = reinterpret_cast<float*>(dos + kBQ * kLdP);
  float* dsum_s = lse_s + kBQ;
  cg::cluster_group cl = cg::this_cluster();
  const int c = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bkv = blockIdx.x / c / sweeps, j = blockIdx.x / c % sweeps;
  const int hkv_n = Hq / group;
  const int b = bkv / hkv_n, hkv = bkv % hkv_n;
  const int k0 = blockIdx.y * kRows;
  const long long kvbase = (long long)bkv * Skv + k0;
  const int col0 = rank * w, cols = min(w, D - col0);
  const int qt0 = causal ? k0 / kBQ : 0;
  const int nq = max(0, (Sq + kBQ - 1) / kBQ - qt0);
  const int n_it = group * nq;
  const int mode = vec ? kVec : kPlain;
  xch_open<1>();

  const int key_lo = k0 + 16 * warp;
  float adk[kPiece / 8][4], adv[kPiece / 8][4];
  zero(adk);
  zero(adv);
  for (int it = 0; it < n_it; ++it) {
    const long long bh =
        (long long)b * Hq + (long long)hkv * group + it / nq;
    const int i0 = (qt0 + it % nq) * kBQ;
    const long long qbase = bh * Sq + i0;
    const bool live = key_lo < Skv && !(causal && key_lo > i0 + kBQ - 1);
    float s[kBQ / 8][4], dp[kBQ / 8][4];
    zero(s);
    zero(dp);
    for (int i = 0; i < sweeps; ++i) {
      const int pc = col0 + piece(i, j, sweeps), pcols = cols + col0 - pc;
      __syncthreads();                  // the last piece read
      load_tile<T, kRows, kPiece, kLdP>(ks, k + kvbase * D + pc, D,
                                        Skv - k0, pcols, mode);
      load_tile<T, kRows, kPiece, kLdP>(vs, v + kvbase * D + pc, D,
                                        Skv - k0, pcols, mode);
      load_tile<T, kBQ, kPiece, kLdP>(qs, q + qbase * D + pc, D, Sq - i0,
                                      pcols, mode);
      load_tile<T, kBQ, kPiece, kLdP>(dos, dout + qbase * D + pc, D,
                                      Sq - i0, pcols, mode);
      if (i == sweeps - 1) {
        load_rows<kBQ>(lse_s, lse + qbase, Sq - i0);
        load_rows<kBQ>(dsum_s, dsum + qbase, Sq - i0);
      }
      tf32x3::cp_async_commit();
      tf32x3::cp_async_wait<0>();
      __syncthreads();                  // the piece in, for all
      if (live)
        gemm_nt2<T, kPiece, kBQ, kLdP, false>(s, dp, ks, vs, 16 * warp, qs,
                                              dos, lane);
    }
    xch_store<1>();
    if (live) {
      put_part(xch, s, warp, lane);
      put_part(xch + kPart, dp, warp, lane);
    }
    xch_stored();
    if (live) {
      sum_parts<ranks_a_round<T>()>(s, xch, warp, lane);
      sum_parts<ranks_a_round<T>()>(dp, xch + kPart, warp, lane);
    }
    xch_read<1>();
    if (!live) continue;
#pragma unroll
    for (int jj = 0; jj < kBQ / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * jj + 2 * t + (e & 1);
        const int row = i0 + qi;
        const int key = key_lo + g + 8 * (e >> 1);
        const bool hidden = key >= Skv || row >= Sq || (causal && key > row);
        const float p =
            hidden ? 0.f : ex2(fmaf(s[jj][e], scale_log2, -lse_s[qi]));
        s[jj][e] = p;
        dp[jj][e] = p * (dp[jj][e] - dsum_s[qi]);
      }
    gemm_pv<T, kBQ, kPiece, kLdP>(adv, s, dos, lane);   // dO's piece j
    gemm_pv<T, kBQ, kPiece, kLdP>(adk, dp, qs, lane);   // q's piece j
  }
  xch_close<1>();
  store_kv<T, kPiece>(dk, dv, adk, adv,
                      (long long)bkv * Skv * D + col0 + j * kPiece, D, key_lo,
                      Skv, cols - j * kPiece, scale, lane);
}

// ---- launches -------------------------------------------------------------

// sets the kernel's shared memory (and, past kMaxCluster blocks, allows a
// non-portable cluster) and launches it in clusters of c blocks along x; a
// launch the card refuses (a cluster it cannot place) returns its error
template <typename... P, typename... A>
cudaError_t run(void (*kernel)(P...), dim3 grid, int threads, int smem,
                int c, cudaStream_t stream, A... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (c > kMaxCluster) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// every row and base 16-byte aligned: the cp.async copies
inline int vec_ok(const void* const* ptrs, int n, int D, int size) {
  uintptr_t a = 0;
  for (int i = 0; i < n; ++i) a |= reinterpret_cast<uintptr_t>(ptrs[i]);
  return a % 16 == 0 && (D * size) % 16 == 0;
}

template <typename T, int WP>
cudaError_t launch_fwd_as(const void* q, const void* k, const void* v,
                          void* o, float* lse, int B, int Hq, int Hkv, int Sq,
                          int Skv, int D, int causal, cudaStream_t stream) {
  const Plan p = plan(D, kFwdWMax);
  const void* ptrs[3] = {q, k, v};
  const int vec = vec_ok(ptrs, 3, D, (int)sizeof(T));
  const dim3 grid((unsigned)((long long)B * Hq * p.c),
                  (unsigned)((Sq + kRows - 1) / kRows));
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  return run(fwd_kernel<T, WP>, grid, kThreads, Fwd<T, WP>::kBytes, p.c,
             stream,
             (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, Hq, Hq / Hkv,
             Sq, Skv, D, p.w, scale_log2, causal, vec);
}

// grid x of a pass over `heads` at plan p: heads, sweeps and ranks
inline long long grid_x(long long heads, const Plan& p) {
  return heads * p.sweeps * p.c;
}

// the forward of a head D > kDMax
template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int Hq, int Hkv, int Sq, int Skv,
                       int D, int causal, cudaStream_t stream) {
  const Plan p = plan(D, kFwdWMax);
  if (grid_x((long long)B * Hq, p) > 0x7fffffffLL ||
      (Sq + kRows - 1) / kRows > 65535)
    return cudaErrorInvalidValue;
  if (p.stream) {
    const void* ptrs[3] = {q, k, v};
    const dim3 grid((unsigned)grid_x((long long)B * Hq, p),
                    (unsigned)((Sq + kRows - 1) / kRows));
    const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
    return run(fwd_stream_kernel<T>, grid, kThreads, FwdS<T>::kBytes, p.c,
               stream, (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, Hq,
               Hq / Hkv, Sq, Skv, D, p.w, p.sweeps, scale_log2, causal,
               vec_ok(ptrs, 3, D, (int)sizeof(T)));
  }
  if (p.wp == 192)
    return launch_fwd_as<T, 192>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, D,
                                 causal, stream);
  if (p.wp == 256)
    return launch_fwd_as<T, 256>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, D,
                                 causal, stream);
  return cudaErrorInvalidValue;
}

template <typename T, int WP>
cudaError_t launch_dq_as(const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const float* lse,
                         void* dq, float* dsum, int B, int Hq, int Hkv,
                         int Sq, int Skv, int D, int causal, int vec,
                         cudaStream_t stream) {
  const Plan p = plan(D, kDqWMax);
  const dim3 grid((unsigned)((long long)B * Hq * p.c),
                  (unsigned)((Sq + kRows - 1) / kRows));
  const float scale = (float)(1.0 / sqrt((double)D));
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  return run(dq_kernel<T, WP>, grid, kDqThreads, Dq<T, WP>::kBytes, p.c,
             stream,
             (const T*)q, (const T*)k, (const T*)v, (const T*)o,
             (const T*)dout, lse, (T*)dq, dsum, Hq, Hq / Hkv, Sq, Skv, D,
             p.w, scale_log2, scale, causal, vec);
}

// the backward's two passes of a head D > kDMax: dq (and dsum, B * Hq *
// Sq floats, the rows' dO . O), then dk and dv
template <typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       void* dq, void* dk, void* dv, float* dsum, int B,
                       int Hq, int Hkv, int Sq, int Skv, int D, int causal,
                       cudaStream_t stream) {
  const Plan p = plan(D, kDqWMax), pk = plan(D, kDkvWMax, kDkvCluster);
  if (grid_x((long long)B * Hq, p) > 0x7fffffffLL ||
      grid_x((long long)B * Hkv, pk) > 0x7fffffffLL ||
      (Sq + kRows - 1) / kRows > 65535 || (Skv + kRows - 1) / kRows > 65535)
    return cudaErrorInvalidValue;
  const void* ptrs[4] = {q, k, v, dout};
  const int vec = vec_ok(ptrs, 4, D, (int)sizeof(T));
  const float scale = (float)(1.0 / sqrt((double)D));
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  cudaError_t err = cudaErrorInvalidValue;
  if (p.stream)
    err = run(dq_stream_kernel<T>,
              dim3((unsigned)grid_x((long long)B * Hq, p),
                   (unsigned)((Sq + kRows - 1) / kRows)),
              kThreads, DqS<T>::kBytes, p.c, stream, (const T*)q,
              (const T*)k, (const T*)v, (const T*)o, (const T*)dout, lse,
              (T*)dq, dsum, Hq, Hq / Hkv, Sq, Skv, D, p.w, p.sweeps,
              scale_log2, scale, causal, vec);
  else if (p.wp == 192)
    err = launch_dq_as<T, 192>(q, k, v, o, dout, lse, dq, dsum, B, Hq, Hkv,
                               Sq, Skv, D, causal, vec, stream);
  else if (p.wp == 256)
    err = launch_dq_as<T, 256>(q, k, v, o, dout, lse, dq, dsum, B, Hq, Hkv,
                               Sq, Skv, D, causal, vec, stream);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)grid_x((long long)B * Hkv, pk),
                  (unsigned)((Skv + kRows - 1) / kRows));
  if (pk.stream)
    return run(dkv_stream_kernel<T>, grid, kThreads, DkvS<T>::kBytes, pk.c,
               stream, (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
               lse, (const float*)dsum, (T*)dk, (T*)dv, Hq, Hq / Hkv, Sq, Skv,
               D, pk.w, pk.sweeps, scale_log2, scale, causal, vec);
  // a resident slice of the dK/dV pass is 128 wide at most (kDkvCluster)
  return run(dkv_kernel<T>, grid, kThreads, Dkv<T>::kBytes, pk.c, stream,
             (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse,
             (const float*)dsum, (T*)dk, (T*)dv, Hq, Hq / Hkv, Sq, Skv, D,
             pk.w, scale_log2, scale, causal, vec);
}

// shared memory of each pass's kernel at a plan
template <typename T>
int fwd_smem(const Plan& p) {
  return p.stream ? FwdS<T>::kBytes
         : p.wp == 192 ? Fwd<T, 192>::kBytes : Fwd<T, 256>::kBytes;
}
template <typename T>
int dq_smem(const Plan& p) {
  return p.stream ? DqS<T>::kBytes
         : p.wp == 192 ? Dq<T, 192>::kBytes : Dq<T, 256>::kBytes;
}
template <typename T>
int dkv_smem(const Plan& p) {
  return p.stream ? DkvS<T>::kBytes : Dkv<T>::kBytes;
}

// {clusters, slice, padded slice (a piece where streamed), shared memory,
// sweeps} of each pass at D: out[0..4] the forward, out[5..9] the dQ
// pass, out[10..14] the dK/dV pass
template <typename T>
void layout(int D, int* out) {
  const Plan ps[3] = {plan(D, kFwdWMax), plan(D, kDqWMax),
                      plan(D, kDkvWMax, kDkvCluster)};
  const int smem[3] = {fwd_smem<T>(ps[0]), dq_smem<T>(ps[1]),
                       dkv_smem<T>(ps[2])};
  for (int i = 0; i < 3; ++i) {
    out[5 * i] = ps[i].c;
    out[5 * i + 1] = ps[i].w;
    out[5 * i + 2] = ps[i].wp;
    out[5 * i + 3] = smem[i];
    out[5 * i + 4] = ps[i].sweeps;
  }
}

}  // namespace split
