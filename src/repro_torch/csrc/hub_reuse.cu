// hub_reuse: islandized FC — pool MLP + compensated reuse gather + masked
// max over K, fp32 in and out, the products on Hopper's tensor cores in
// 3xTF32.
//
// Replaces the Pallas TPU kernels hub_reuse_pallas and
// hub_reuse_batched_pallas (src/repro/kernels/hub_reuse/hub_reuse.py,
// bodies _reuse_gather, _tiled_reuse_gather, _hub_reuse_kernel,
// _hub_reuse_masked_kernel and their batched twins): for each (cloud b,
// island h)
//
//     y         = relu(pool[b,h] W1 + b1) W2 + b2                 (C, F)
//     out[m, f] = max over k with slot[m,k] >= 0 and live[m,k] of
//                 y[slot[m,k], f] + comp[m, f]                    (M, F)
//
// and -BIG (the merge identity, not 0) where a subset has no live slot.
// Slots clamp at C - 1, as the plain version's do.
//
// Two forms, which Hd fixes.  Hd > 0 is the two-layer form above.  Hd = 0
// is the one-layer form, y = pool[b,h] W1 + b1 with W1 D x F (w2 and b2
// null): the lowering of every one-layer point-MLP (each block of DGCNN,
// PointNeXt-S and PointVector-L, and any block_end MLP composed into one
// map), which the two-layer form took before as relu(x [W, -W] + [b,
// -b]) [I; -I] at Hd = 2F: 2 D 2F + 2 2F F flops a cache row for a
// function of 2 D F, 3x (DGCNN(c) block 2) to 28x (PointVector-L block 4,
// D padded to 8) the products.  The gather is the same in both forms.
//
// Two routes, which the call's widths and form fix (`layered_route`
// below; the planner's copy is kernels/tiling.py::hub_reuse_route):
// `resident`, one block an island and 64 features with the island's
// cache rows in shared memory, for the calls one launch of it covers (C
// <= 128 rows that fit a block); and `layered`, over global memory, for
// every other call (three launches for two layers, two for one).  A
// one-layer resident call whose products reach 2^28 multiply-adds takes
// a kernel of its own on wgmma instead (`linear_wgmma`; rl:: at the end).
//
// The resident route.  A launch takes a chunk of at most 64 or 128 cache
// rows (the wrapper's knob; 128 unless a plan says otherwise), rows [c0,
// c0 + chunk) of each island; a forced chunk smaller than C takes one
// launch a chunk, each merged into the last one's output by an
// elementwise max (a subset with no live slot in a chunk gives -BIG
// there, the identity of that max).  The TPU kernel gathers
// y[slot] as a one-hot matmul on the MXU; here a warp reads y[slot] from
// shared memory, which gives the same values for finite inputs.  Each
// block reads only its own island, so the TPU kernel's out-of-range-island
// masking has no counterpart.  The batch and the per-cloud entry are the
// same kernel (B = 1 for one cloud).
//
// What bounds it on an H100: at B = 8, block 1 (H=16 C=64 M=64 K=32 D=64
// Hd=64 F=128) is 0.20 GFLOP against 11.8 MB of pool inputs, int32 slots,
// bool liveness, compensation and output: 3.5 us at 3.35 TB/s, bytes.
// Block 2 (H=4 C=128 M=64 K=64 D=128 Hd=128 F=256) is 0.40 GFLOP on only
// B*H = 32 islands; held to 1e-4 of the fp32 result, which one TF32 pass
// breaks and 3xTF32 keeps, its least time is 3 x flops at the 495 TFLOP/s
// TF32 peak, 2.4 us.  The gather reads M*K*F*4 bytes of y from shared
// memory, 134 MB at each block, a floor of ~4.5 us of its own.
//
// What the design does about it:
//   * Grid (B*H, ceil(F/64)): a block takes one island and 64 output
//     features, so block 2 has 128 blocks; the max over K is per column,
//     so the F tiles are independent, and each recomputes the first layer
//     (sharing it within a thread-block cluster through distributed shared
//     memory was tried: slower at both PointNet++(c) blocks).  C rows pad
//     to 64 (8 warps) or 128 (16 warps, one block an SM); padding rows are
//     zero and no slot reaches them.
//   * x (the island's C x D inputs, D zero-padded to a multiple of 8)
//     arrives by cp.async, 16-byte copies where D % 4 == 0, else 4-byte;
//     its row stride keeps fragment loads free of bank conflicts.  So do
//     the island's slots and liveness, which no thread waits on before the
//     gather (plain loads there held each block up by microseconds).
//   * Two layers: Hd in chunks of 64: h_chunk = relu(x W1[:, chunk] + b1)
//     is summed over all of D, written to shared memory, and fed at once
//     into y += h_chunk W2[chunk, ftile], which stays in registers; whole
//     h is never resident, so shared memory does not grow with Hd.  W1
//     and W2 stream through one three-stage cp.async ring of 64 x 64
//     tiles, one barrier a stage.
//   * One layer: y += x W1 over D in the same ring, no h.
//   * The products run on mma.sync m16n8k8 TF32 in three passes
//     (tf32x3.cuh): operands fp32 in shared memory, split in registers.
//   * After the last stage, y plus its bias b2 goes to shared memory
//     over x.  A warp takes a subset, its lanes along f:
//     it turns the subset's staged slots into y rows (-1 where a slot is
//     not cached or not live), then each (m, k) reads one y row without
//     bank conflicts and a dead slot is a warp-uniform skip; comp is read
//     once per (m, f), coalesced.
//
// The layered route.  The resident route stages x (C x D) and the slots
// and liveness (M x K) whole, and each of its ceil(F / 64) feature tiles
// recomputes the whole first layer: past 128 rows, or where 128 rows of a
// wide D do not fit a block, it would take several launches merged by a
// max, and at one island an SM-starved grid (PointVector-L's block 4 at
// cache_capacity_x = 4: B = 2, H = 1, C = 128, D = 387, F = 768, 24
// blocks on 132 SMs).  The layered route forms each layer once, for all
// B*H*C cache rows at once, on the same 3xTF32 mma.sync:
//   1. two layers: h = relu(x W1 + b1) for the N = B*H*C rows, in 64 x 64
//      tiles (4 warps of 32 x 32; K in 64-deep stages of a three-stage
//      cp.async ring), into device scratch (N x Hd floats, held in L2).
//   2. y = h W2 (two layers) or y = x W1 (one layer: no h, no scratch for
//      it), the same tiles, the depth (Hd, or D) split into `nsplit`
//      ranges where the tiles are too few to fill the card
//      (`layered::plan`: ceil(SMs / tiles), as gather_mlp's wide route
//      splits H), each range's partial into its own slice of scratch: no
//      atomics.
//   3. The gather: a block of 8 warps takes 16 subsets of an island and 64
//      features, grid (island x subset tiles, feature tiles).  It first
//      sums the island's y at its features (the bias plus the nsplit
//      partials in order) into shared memory, C x 64 (up to kStagedC rows;
//      past them each slot's row is summed from L2 where it is read:
//      reading every (m, k)'s row from L2 took 45 of 79 us at
//      PointNet++(c)'s block 2 with C = 256).  A warp a subset: its lanes
//      turn 32 slots at a time into y rows (-1 where not cached or not
//      live), then each live slot's row is a warp-uniform read and a max;
//      comp once per (m, f).
// Nothing stages C x D or M x K whole, so any C, D and M*K take one call,
// and the same inputs give the same bits.
//
// The one-layer resident route on wgmma (namespace rl below), for the
// calls `linear_wgmma` names.  The one-layer form is a GEMM of B·H·C rows
// by F columns of depth D, then the gather: dgcnn_c's block 4 at B = 8
// (256 islands of C = 40, D = F = 256) is 10,240 rows, 4.0 GFLOP in
// 3xTF32 (8 us at the 495 TFLOP/s TF32 peak) against 46 MB of pool,
// slots, comp and out (13.7 us at 3.35 TB/s), and its gather reads M·K·F
// floats of y from shared memory an island, 335 MB a call (~10 us of the
// card's shared-memory bandwidth).  hub_reuse_kernel<L, true> streams W
// through L2 once an island on latency-bound mma.sync chains; only wgmma
// reaches the TF32 peak, so, as gather_mlp's linear route:
//   * W split once a call into device scratch as TF32 halves, K-major, k
//     permuted within 8-groups (tf32_split.cuh, the split gather_mlp
//     uses), which every chunk's launch reads;
//   * hub_reuse_linear_kernel: a work item is a row tile of R = 64 rows
//     (one consumer warpgroup; 128 and two where Cc passes 64) holding
//     whole islands, floor(R / Cc) of Cc cache rows each, by N output
//     columns (F in tiles of at most 128; 64 where the items would leave
//     SMs idle).  No island is split across tiles.  Two blocks an SM (one
//     at R = 128, N = 128) walk the items (persistent).  A producer
//     warpgroup fills a ring of 16-deep stages: W's halves by TMA (64-byte
//     swizzle), x's 16-column slice of the tile's rows by TMA where its
//     rows are 16-byte multiples and the tile's islands are adjacent in
//     memory, else by cp.async.  The consumers issue three wgmma.m64nNk8
//     .tf32 a k8 step (small·big, big·small, big·big; A from registers),
//     x streamed, so D is not bounded.
//   * The gather in the epilogue: y staged 64 columns at a time in a
//     buffer of its own (the ring keeps filling for the next item
//     meanwhile); a warp takes kGroup subsets at once, its lanes along f,
//     their slots, liveness and comp loaded together; a slot clamps at
//     C - 1 and counts only inside [c0, c0 + Cc) of its own island, whose
//     rows it reads; b and comp are added to the max once per (m, f)
//     (max(y) + b = max(y + b): rounding is monotone), and out is written
//     once, coalesced (max-merged where a launch follows another chunk).
// Slots and liveness are never staged whole, so D and M·K do not bound
// it.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "sm90_tf32.cuh"
#include "tf32_split.cuh"
#include "tf32x3.cuh"

namespace {

using tf32x3::Frag;

constexpr int kMT = 2;                   // m16 tiles per warp
constexpr int kNC = 64;                  // output features a block, Hd chunk
constexpr int kKC = 64;                  // rows of W per ring stage
constexpr int kStages = 3;               // ring depth
constexpr int kWS = kNC + 4;             // stage row stride (≡ 4 mod 16)
constexpr int kHS = kNC + 8;             // h and y row stride (≡ 8 mod 32)
constexpr int kN2 = kNC / kKC;           // W2 stages per Hd chunk
constexpr int kMaxC = 128;               // the most cache rows a launch takes
constexpr float kBig = 3.4e38f;          // the max-pool identity of the JAX code
constexpr long long kMaxSmem = 232448;   // a block's shared memory

struct Params {
  const float* pool;
  const int32_t* slot;
  const float* comp;
  const uint8_t* live;
  const float* w1;        // D x Hd, or D x F in one layer
  const float* b1;
  const float* w2;        // null in one layer
  const float* b2;        // null in one layer
  float* out;
  int C, M, K, D, Hd, F;  // Hd = 0: one layer
  int c0, Cc;              // the launch's cache rows [c0, c0 + Cc)
  int merge;               // out = max(out, this launch's result)
  int Dp, XD, K4;          // D to 8, the x row stride, K to 4
  int n1, nchunk;          // W1 stages per chunk, Hd chunks
  int x_vec, w1_vec, w2_vec;  // 16-byte copies allowed
  int live_words;          // an island's liveness by 4-byte copies
};

// The warps of a block as WM x WN over rows x columns: each warp holds
// kMT m16 tiles by kNT n8 tiles of a 64-column tile, for h and for y.
// 2 x 4 gives 64-row tiles of 8 warps; 4 x 4 128-row ones of 16, since
// a block of those takes an SM's shared memory alone.
template <int WM, int WN>
struct Layout {
  static constexpr int kWN = WN, kWarps = WM * WN, kThreads = 32 * kWarps;
  static constexpr int kR = 16 * kMT * WM;          // rows per block
  static constexpr int kNT = kNC / (8 * kWN);       // n8 tiles per warp
  // 128-row tiles need more than half an SM's shared memory anyway
  static constexpr int kMinBlocks = kR > 64 ? 1 : 2;
};
using Rows64 = Layout<2, 4>;
using Rows128 = Layout<4, 4>;

// Rows [k0, k0 + kKC) by columns [c0, c0 + 64) of the row-major kdim x
// ncols matrix w into a stage; rows past kdim and columns past c0 + nc
// are zero.
template <int kThreads>
__device__ __forceinline__ void load_stage(float* st, const float* w,
                                           int kdim, int ncols, int k0,
                                           int c0, int nc, bool vec) {
  for (int e = threadIdx.x; e < kKC * (kNC / 4); e += kThreads) {
    const int r = e / (kNC / 4), c = (e % (kNC / 4)) * 4;
    float* dst = st + r * kWS + c;
    const int kr = k0 + r;
    const float* src = w + (size_t)kr * ncols + c0 + c;
    if (vec && kr < kdim && c < nc) {
      tf32x3::cp_async16(dst, src);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (kr < kdim && c + i < nc) tf32x3::cp_async4(dst + i, src + i);
        else dst[i] = 0.f;
      }
    }
  }
}

// Stage q of the ring's sequence: per Hd chunk j, n1 stages of W1[:, j]
// (rows of D) then kN2 stages of W2[j, ftile] (rows of the chunk); in one
// layer (kLin) the n1 stages of W1[:, ftile].
template <int kThreads, bool kLin>
__device__ __forceinline__ void issue(float* ws, const Params& p, int q,
                                      int f0, int ft) {
  float* st = ws + (q % kStages) * kKC * kWS;
  if (kLin) {
    load_stage<kThreads>(st, p.w1, p.D, p.F, q * kKC, f0, ft,
                         p.w1_vec != 0);
    return;
  }
  const int per = p.n1 + kN2, j = q / per, r = q % per;
  if (r < p.n1)
    load_stage<kThreads>(st, p.w1, p.D, p.Hd, r * kKC, j * kNC,
                         min(kNC, p.Hd - j * kNC), p.w1_vec != 0);
  else
    load_stage<kThreads>(st, p.w2, p.Hd, p.F, j * kNC + (r - p.n1) * kKC,
                         f0, ft, p.w2_vec != 0);
}

// acc += a[rows of this warp, k0 : k0 + 8 * steps) · st[0 : 8 * steps, :]
template <class L>
__device__ __forceinline__ void mma_stage(float (&acc)[kMT][L::kNT][4],
                                          const float* a, int lda, int k0,
                                          const float* st, int steps,
                                          int wm, int wn, int lane) {
#pragma unroll
  for (int s = 0; s < kKC / 8; ++s) {     // fully unrolled: no spills
    if (s >= steps) break;
    Frag<4> af[kMT];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
      af[mt] = tf32x3::load_a(a, lda, (wm * kMT + mt) * 16, k0 + s * 8,
                              lane);
#pragma unroll
    for (int j = 0; j < L::kNT; ++j) {
      const Frag<2> bf =
          tf32x3::load_b(st, kWS, s * 8, (wn + L::kWN * j) * 8, lane);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) tf32x3::mma3(acc[mt][j], af[mt], bf);
    }
  }
}

// The accumulators plus a bias on columns below n (0 past them) as a
// row-major tile of stride kHS, relu'd if asked.
template <class L, bool kRelu>
__device__ __forceinline__ void store_tile(float* dst,
                                           const float (&acc)[kMT][L::kNT][4],
                                           const float* bias, int n, int wm,
                                           int wn, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < L::kNT; ++j) {
    const int c = (wn + L::kWN * j) * 8 + 2 * t;
    const float b0 = c < n ? __ldg(bias + c) : 0.f;
    const float b1 = c + 1 < n ? __ldg(bias + c + 1) : 0.f;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const float* v = acc[mt][j];
      float2 lo = make_float2(v[0] + b0, v[1] + b1);
      float2 hi = make_float2(v[2] + b0, v[3] + b1);
      if (kRelu) {
        lo = make_float2(fmaxf(lo.x, 0.f), fmaxf(lo.y, 0.f));
        hi = make_float2(fmaxf(hi.x, 0.f), fmaxf(hi.y, 0.f));
      }
      float* row = dst + ((wm * kMT + mt) * 16 + g) * kHS + c;
      *reinterpret_cast<float2*>(row) = lo;
      *reinterpret_cast<float2*>(row + 8 * kHS) = hi;
    }
  }
}

// Floats of shared memory an island's liveness bytes take (M x K, to 16)
__host__ __device__ __forceinline__ int live_floats(const Params& p) {
  return p.live == nullptr ? 0 : (p.M * p.K + 15) / 16 * 4;
}

// Floats of the h tile: R rows in two layers, none in one
template <class L>
__host__ __device__ __forceinline__ int h_floats(const Params& p) {
  return p.Hd == 0 ? 0 : L::kR * kHS;
}

// Floats of the x region: R rows of x, later R rows of y
template <class L>
__host__ __device__ __forceinline__ int xy_floats(const Params& p) {
  return L::kR * (p.XD > kHS ? p.XD : kHS);
}

// Floats before the x region: the island's slots and liveness
__host__ __device__ __forceinline__ int slot_floats(const Params& p) {
  return p.M * p.K4 + live_floats(p);
}

// max over a subset's live slots of y, plus comp; -BIG where none is live
__device__ __forceinline__ float merged(float m, float c) {
  return m == -INFINITY ? -kBig : m + c;
}

// kLin: the one-layer form (p.Hd == 0), else the two-layer one
template <class L, bool kLin>
__global__ void __launch_bounds__(L::kThreads, L::kMinBlocks)
hub_reuse_kernel(const Params p) {
  constexpr int R = L::kR, kNT = L::kNT, kThreads = L::kThreads;
  extern __shared__ __align__(16) float smem[];
  int* sl = reinterpret_cast<int*>(smem);              // M x K4
  uint8_t* lv = reinterpret_cast<uint8_t*>(sl + p.M * p.K4);  // M x K
  float* xs = smem + slot_floats(p);                   // R x XD
  float* ys = xs;                                      // R x kHS, after
  float* hs = xs + xy_floats<L>(p);                    // R x kHS (two layers)
  float* ws = hs + (kLin ? 0 : R * kHS);               // kStages x kKC x kWS

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / L::kWN, wn = warp % L::kWN;
  const long long isl = blockIdx.x;                    // b * H + h
  const int f0 = blockIdx.y * kNC;
  const int ft = min(kNC, p.F - f0);
  const int per = kLin ? p.n1 : p.n1 + kN2;
  const int nq = kLin ? p.n1 : p.nchunk * per;

  // ---- prologue: x by cp.async, the ring's first stages, the slots ------
  const float* poolp = p.pool + (isl * p.C + p.c0) * p.D;
  for (int e = tid; e < R * (p.Dp / 4); e += kThreads) {
    const int r = e / (p.Dp / 4), c = (e % (p.Dp / 4)) * 4;
    float* dst = xs + r * p.XD + c;
    const float* src = poolp + (size_t)r * p.D + c;
    if (p.x_vec && r < p.Cc && c < p.D) {
      tf32x3::cp_async16(dst, src);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (r < p.Cc && c + i < p.D) tf32x3::cp_async4(dst + i, src + i);
        else dst[i] = 0.f;
      }
    }
  }
  for (int q = 0; q < kStages - 1; ++q) {
    if (q < nq) issue<kThreads, kLin>(ws, p, q, f0, ft);
    tf32x3::cp_async_commit();
  }
  // slots and liveness by cp.async too (a thread that waited on loads
  // here would hold up its part of the products); rows of K4
  const long long mk = (long long)p.M * p.K;
  const int32_t* slp = p.slot + isl * mk;
  for (int m = warp; m < p.M; m += L::kWarps)
    for (int k = lane; k < p.K; k += 32)
      tf32x3::cp_async4(sl + m * p.K4 + k, slp + m * p.K + k);
  if (p.live != nullptr) {
    const uint8_t* lvp = p.live + isl * mk;
    if (p.live_words)
      for (int e = tid; e < mk / 4; e += kThreads)
        tf32x3::cp_async4(lv + 4 * e, lvp + 4 * e);
    else
      for (int e = tid; e < mk; e += kThreads) lv[e] = lvp[e];
  }

  // ---- h a chunk at a time, y += h_chunk W2 in registers (two layers);
  // ---- y += x W1 stage in registers (one layer) ------------------------
  float acc_h[kMT][kNT][4], acc_y[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc_y[mt][j][i] = 0.f;
  for (int q = 0; q < nq; ++q) {
    tf32x3::cp_async_wait<kStages - 2>();    // stage q (and x) landed
    __syncthreads();                         // for all; slot q - 1 free
    if (q + kStages - 1 < nq)
      issue<kThreads, kLin>(ws, p, q + kStages - 1, f0, ft);
    tf32x3::cp_async_commit();
    const float* st = ws + (q % kStages) * kKC * kWS;
    if (kLin) {                              // y += x · W1 stage
      mma_stage<L>(acc_y, xs, p.XD, q * kKC, st,
                   min(kKC, p.Dp - q * kKC) / 8, wm, wn, lane);
      continue;
    }
    const int j = q / per, r = q % per;
    if (r < p.n1) {                          // h_chunk += x · W1 stage
      if (r == 0) {
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int n = 0; n < kNT; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc_h[mt][n][i] = 0.f;
      }
      mma_stage<L>(acc_h, xs, p.XD, r * kKC, st,
                   min(kKC, p.Dp - r * kKC) / 8, wm, wn, lane);
      if (r == p.n1 - 1)                     // read after the next barrier
        store_tile<L, true>(hs, acc_h, p.b1 + j * kNC,
                            min(kNC, p.Hd - j * kNC), wm, wn, lane);
    } else {                                 // y += h_chunk · W2 stage
      mma_stage<L>(acc_y, hs, kHS, (r - p.n1) * kKC, st, kKC / 8, wm, wn,
                   lane);
    }
  }

  // ---- y + b2 over x, then the gather (one layer: y + b1) ---------------
  tf32x3::cp_async_wait<0>();
  __syncthreads();                           // every warp done with x
  store_tile<L, false>(ys, acc_y, (kLin ? p.b1 : p.b2) + f0, ft, wm, wn,
                       lane);
  __syncthreads();
  // a warp a subset, lanes along f: each (m, k) reads one y row without
  // bank conflicts, and a dead slot is a warp-uniform skip
  const float2* y2 = reinterpret_cast<const float2*>(ys);
  const int c = 2 * lane;
  for (int m = warp; m < p.M; m += L::kWarps) {
    const long long row = (isl * p.M + m) * p.F + f0;
    const float c0 = c < ft ? p.comp[row + c] : 0.f;
    const float c1 = c + 1 < ft ? p.comp[row + c + 1] : 0.f;
    int* e = sl + m * p.K4;                  // this warp's row: one y row
    for (int k = lane; k < p.K4; k += 32) {  // per (m, k), -1 where dead
      const bool ok = k < p.K && e[k] >= 0 &&
                      (p.live == nullptr || lv[m * p.K + k] != 0);
      const int s = ok ? min(e[k], p.C - 1) - p.c0 : -1;  // row of y
      e[k] = s >= 0 && s < p.Cc ? s : -1;
    }
    __syncwarp();
    float a0 = -INFINITY, a1 = -INFINITY;
    for (int k = 0; k < p.K4; k += 4) {
      const int4 s4 = *reinterpret_cast<const int4*>(e + k);
      const int s[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (s[i] >= 0) {                     // warp-uniform
          const float2 v = y2[s[i] * (kHS / 2) + lane];
          a0 = fmaxf(a0, v.x);
          a1 = fmaxf(a1, v.y);
        }
      }
    }
    if (c < ft) {
      const float v = merged(a0, c0);
      p.out[row + c] = p.merge ? fmaxf(p.out[row + c], v) : v;
    }
    if (c + 1 < ft) {
      const float v = merged(a1, c1);
      p.out[row + c + 1] = p.merge ? fmaxf(p.out[row + c + 1], v) : v;
    }
  }
}

// Bytes of shared memory a block of L takes (the form's: no h tile in
// one layer)
template <class L>
size_t smem_bytes(const Params& p) {
  return sizeof(float) * ((size_t)slot_floats(p) + xy_floats<L>(p) +
                          (size_t)h_floats<L>(p) +
                          (size_t)kStages * kKC * kWS);
}

template <class L, bool kLin>
int launch_form(const Params& p, long long islands, void* stream) {
  const size_t smem = smem_bytes<L>(p);
  cudaError_t err = cudaFuncSetAttribute(
      hub_reuse_kernel<L, kLin>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)islands, (p.F + kNC - 1) / kNC);
  hub_reuse_kernel<L, kLin>
      <<<grid, L::kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <class L>
int launch(const Params& p, long long islands, void* stream) {
  return p.Hd == 0 ? launch_form<L, true>(p, islands, stream)
                   : launch_form<L, false>(p, islands, stream);
}

// The shape fields of p; Cc = min(chunk, C - c0) cache rows a launch
void set_shape(Params& p, int chunk) {
  p.Cc = min(chunk, p.C - p.c0);
  p.Dp = (p.D + 7) & ~7;
  p.XD = p.Dp + ((8 - p.Dp) % 32 + 32) % 32;  // ≡ 8 mod 32: no bank conflicts
  p.K4 = (p.K + 3) & ~3;
  p.n1 = (p.Dp + kKC - 1) / kKC;
  p.nchunk = (p.Hd + kNC - 1) / kNC;
}

bool chunk_ok(int chunk) { return chunk == Rows64::kR || chunk == kMaxC; }

// Whether the weights match the form Hd names: w2 and b2 given for two
// layers (Hd > 0), both null for one (Hd = 0)
bool form_ok(int Hd, const float* w2, const float* b2) {
  return Hd > 0 ? w2 != nullptr && b2 != nullptr
                : Hd == 0 && w2 == nullptr && b2 == nullptr;
}

// Shared memory of a block of the resident launch p (its shape set)
long long resident_smem(const Params& p) {
  return (long long)(p.Cc <= Rows64::kR ? smem_bytes<Rows64>(p)
                                        : smem_bytes<Rows128>(p));
}

// Whether a call of B clouds of H islands takes the layered route on a
// card of `sms` SMs: where no single resident launch covers its C cache
// rows (a block of its min(C, 128) rows, slots and liveness, counted
// whether the call passes liveness or not as the planner counts it, and
// the form's h tile, none in one layer (Hd = 0), would pass a block's
// shared memory), unless C passes 128, a 128-row
// block fits and the resident grid, B H ceil(F / 64) blocks, covers at
// least 3/4 of the SMs (then resident in 128-row chunks: on an H100,
// PointNet++(c)'s block 2 at C = 256 took 0.063 ms at B = 8, 128 blocks,
// against the layered route's 0.080; at B = 4, 64 blocks, 0.064 against
// 0.047)
bool layered_route(int B, int H, int C, int M, int K, int D, int Hd, int F,
                   int sms) {
  Params p{};
  p.live = reinterpret_cast<const uint8_t*>(1);
  p.C = C;
  p.M = M;
  p.K = K;
  p.D = D;
  p.Hd = Hd;
  set_shape(p, kMaxC);
  const bool fits = resident_smem(p) <= kMaxSmem;
  if (C <= kMaxC) return !fits;
  const long long grid = (long long)B * H * ((F + kNC - 1) / kNC);
  return !(fits && 4 * grid >= 3LL * sms);
}

// ---- the layered route ------------------------------------------------------

namespace layered {

constexpr int kT = 64;                   // a GEMM tile: 64 x 64
constexpr int kThreads = 128;            // 4 warps of 32 x 32
constexpr int kLA = kT + 8;              // A stage row stride (≡ 8 mod 32)
constexpr int kLB = kT + 4;              // B stage row stride (≡ 4 mod 16)
constexpr int kStageFloats = kT * kLA + kKC * kLB;
constexpr int kSmem = (int)sizeof(float) * kStages * kStageFloats;
constexpr int kGatherWarps = 8;          // warps a gather block
constexpr int kGatherSubsets = 16;       // subsets a gather block
constexpr int kStagedC = 384;            // the most cache rows it stages

// out = act(A[:, ks] B[ks, :] (+ bias)) for A rows x K and B K x N (both
// row-major), split z over the K range [z kper, + kper), into out + z rows
// N; bias (null: none) and relu on split 0 only when nsplit is 1
struct Gemm {
  const float* a;
  const float* b;
  const float* bias;
  float* out;
  int rows, K, N, kper;
  int a_vec, b_vec;
};

// rows [0, 64) by columns [0, 64) of the row-major matrix at src (rows ld
// apart) into dst (rows ldd apart); rows past `rows` and columns past
// `cols` zero.  vec: 16-byte copies (src and ld 16-byte aligned)
__device__ __forceinline__ void load64(float* dst, int ldd, const float* src,
                                       long long ld, int rows, int cols,
                                       bool vec) {
  for (int e = threadIdx.x; e < kT * (kT / 4); e += kThreads) {
    const int r = e / (kT / 4), c = e % (kT / 4) * 4;
    float* d = dst + r * ldd + c;
    const float* s = src + r * ld + c;
    if (vec && r < rows && c + 4 <= cols) {
      tf32x3::cp_async16(d, s);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (r < rows && c + i < cols) tf32x3::cp_async4(d + i, s + i);
        else d[i] = 0.f;
      }
    }
  }
}

template <bool kRelu>
__global__ void __launch_bounds__(kThreads, 2) gemm_kernel(const Gemm g) {
  extern __shared__ __align__(16) float lsmem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;   // a 32 x 32 quarter
  const int r0 = blockIdx.x * kT, n0 = blockIdx.y * kT;
  const int kb = blockIdx.z * g.kper, ke = min(g.K, kb + g.kper);
  const int nst = (ke - kb + kKC - 1) / kKC;
  auto issue = [&](int q) {
    if (q < nst) {
      float* st = lsmem + (q % kStages) * kStageFloats;
      const int k0 = kb + q * kKC;
      load64(st, kLA, g.a + (long long)r0 * g.K + k0, g.K, g.rows - r0,
             ke - k0, g.a_vec != 0);
      load64(st + kT * kLA, kLB, g.b + (long long)k0 * g.N + n0, g.N,
             ke - k0, g.N - n0, g.b_vec != 0);
    }
    tf32x3::cp_async_commit();
  };
  for (int q = 0; q < kStages - 1; ++q) issue(q);
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;
  for (int q = 0; q < nst; ++q) {
    tf32x3::cp_async_wait<kStages - 2>();    // stage q landed
    __syncthreads();                         // for all; stage q - 1 read
    issue(q + kStages - 1);
    const float* as = lsmem + (q % kStages) * kStageFloats;
    const float* bs = as + kT * kLA;
#pragma unroll 2
    for (int s = 0; s < kKC / 8; ++s) {
      Frag<4> af[2];
      Frag<2> bf[4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        af[mt] = tf32x3::load_a(as, kLA, wm * 32 + mt * 16, s * 8, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bf[j] = tf32x3::load_b(bs, kLB, s * 8, wn * 32 + j * 8, lane);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) tf32x3::mma3_row(acc[mt], af[mt], bf);
    }
  }
  tf32x3::cp_async_wait<0>();
  // the tile's rows and columns inside out, plus bias, relu'd if asked
  float* out = g.out + (long long)blockIdx.z * g.rows * g.N;
  const int gr = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = n0 + wn * 32 + j * 8 + 2 * t;
    const float b0 = g.bias != nullptr && c < g.N ? __ldg(g.bias + c) : 0.f;
    const float b1 =
        g.bias != nullptr && c + 1 < g.N ? __ldg(g.bias + c + 1) : 0.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + wm * 32 + mt * 16 + gr + 8 * h;
        if (r >= g.rows) continue;
        float v0 = acc[mt][j][2 * h] + b0, v1 = acc[mt][j][2 * h + 1] + b1;
        if (kRelu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        float* o = out + (long long)r * g.N + c;
        if (c < g.N) o[0] = v0;
        if (c + 1 < g.N) o[1] = v1;
      }
  }
}

struct Gather {
  const float* y;          // nsplit partials of (N x F), N = islands x C
  const float* b2;         // y's bias: b2, or b1 in one layer
  const int32_t* slot;
  const float* comp;
  const uint8_t* live;
  float* out;
  long long part;          // floats a partial
  int C, M, K, F, nsplit, mtiles, staged;
};

// Row `row` of y (F wide, nsplit partials `part` floats apart) at
// features c, c + 1: b2 plus the partials in order
__device__ __forceinline__ float2 y_at(const float* y, long long part,
                                       int F, int nsplit, long long row,
                                       int c, float bias0, float bias1) {
  y += row * F + c;
  float v0 = 0.f, v1 = 0.f;
  for (int s = 0; s < nsplit; ++s) {         // the partials in order
    if (c < F) v0 += __ldg(y + s * part);
    if (c + 1 < F) v1 += __ldg(y + s * part + 1);
  }
  return make_float2(v0 + bias0, v1 + bias1);
}

// grid (islands x mtiles, ceil(F / 64)): block x takes kGatherSubsets
// subsets (x % mtiles) kGatherSubsets + ... of island x / mtiles, warp w
// the subsets w, w + kGatherWarps, ..., lanes features 2l and 2l + 1 of
// the block's 64.  staged (C <= kStagedC): the island's y at the block's
// features, C x 64, summed once into shared memory, each (m, k) then
// reading its row there; else each (m, k) reads and sums its row of the
// partials through L2.  (Bounds of one block an SM: without them ptxas
// held it to 48 registers and spilled.)
__global__ void __launch_bounds__(32 * kGatherWarps, 1) gather_kernel(
    const Gather g) {
  const float* y = g.y;
  const long long part = g.part;
  const int C = g.C, F = g.F, nsplit = g.nsplit;
  extern __shared__ __align__(16) float ys[];      // C x kT (staged)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long isl = blockIdx.x / g.mtiles;
  const int m0 = blockIdx.x % g.mtiles * kGatherSubsets;
  const int f0 = blockIdx.y * kT, c = f0 + 2 * lane;
  const float bias0 = c < g.F ? __ldg(g.b2 + c) : 0.f;
  const float bias1 = c + 1 < g.F ? __ldg(g.b2 + c + 1) : 0.f;
  if (g.staged) {
    for (int r = warp; r < C; r += kGatherWarps)
      reinterpret_cast<float2*>(ys + r * kT)[lane] =
          y_at(y, part, F, nsplit, isl * C + r, c, bias0, bias1);
    __syncthreads();
  }
  for (int m = m0 + warp; m < min(m0 + kGatherSubsets, g.M);
       m += kGatherWarps) {
    const long long sub = isl * g.M + m;
    const int32_t* slp = g.slot + sub * g.K;
    const uint8_t* lvp = g.live == nullptr ? nullptr : g.live + sub * g.K;
    float a0 = -INFINITY, a1 = -INFINITY;
    for (int k0 = 0; k0 < g.K; k0 += 32) {
      int mine = -1;                         // my slot's row of y, or -1
      if (k0 + lane < g.K) {
        const int v = __ldg(slp + k0 + lane);
        const bool ok = v >= 0 && (lvp == nullptr || lvp[k0 + lane] != 0);
        mine = ok ? min(v, g.C - 1) : -1;
      }
      const int n = min(32, g.K - k0);
      for (int i = 0; i < n; ++i) {
        const int row = __shfl_sync(0xffffffffu, mine, i);
        if (row < 0) continue;               // warp-uniform
        const float2 v =
            g.staged ? reinterpret_cast<const float2*>(ys + row * kT)[lane]
                     : y_at(y, part, F, nsplit, isl * C + row, c, bias0,
                            bias1);
        a0 = fmaxf(a0, v.x);
        a1 = fmaxf(a1, v.y);
      }
    }
    const long long at = sub * g.F + c;
    if (c < g.F) g.out[at] = merged(a0, g.comp[at]);
    if (c + 1 < g.F) g.out[at + 1] = merged(a1, g.comp[at + 1]);
  }
}

// What a layered call of N cache rows launches on a card of `sms` SMs:
// the splits of y's GEMM over its depth, Hd (layer 2) or in one layer
// (Hd = 0) D (ceil(sms / tiles) where its 64 x 64 tiles are fewer than
// the SMs, at most one 64-row stage each) and their range, and the
// scratch floats (h in two layers, then the partials of y)
struct Plan {
  int nsplit, kper;
  long long scratch;
};

Plan plan(long long N, int D, int Hd, int F, int sms) {
  const long long tiles = (N + kT - 1) / kT * ((F + kT - 1) / kT);
  const int nch = ((Hd > 0 ? Hd : D) + kKC - 1) / kKC;
  long long want = tiles >= sms ? 1 : (sms + tiles - 1) / tiles;
  if (want > nch) want = nch;
  const int per = (nch + (int)want - 1) / (int)want;   // stages a split
  Plan p;
  p.nsplit = (nch + per - 1) / per;
  p.kper = per * kKC;
  p.scratch = N * Hd + (long long)p.nsplit * N * F;
  return p;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

template <bool kRelu>
cudaError_t run_gemm(const Gemm& g, int nsplit, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<kRelu>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((g.rows + kT - 1) / kT),
                  (unsigned)((g.N + kT - 1) / kT), (unsigned)nsplit);
  gemm_kernel<kRelu><<<grid, kThreads, kSmem, stream>>>(g);
  return cudaGetLastError();
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace layered

// ---- the one-layer resident route on wgmma ---------------------------------

// Whether a one-layer resident call of `islands` islands takes rl:: (the
// wgmma kernel) rather than hub_reuse_kernel<L, true>: where its products,
// islands x min(C, 128) rows x D x F, reach 2^28 multiply-adds.  On an
// H100 (700 W) the wgmma kernel took DGCNN(c)'s block 4 at B = 8 (2^29.3)
// in 0.079 ms against the mma.sync kernel's 0.134, and lost at every
// smaller family block, by up to 2x (its split and persistent ring cost
// ~10 us a call; DGCNN(c)'s block 3, 2^27.3, 0.037 against 0.034)
constexpr long long kWgmmaMacs = 1LL << 28;

bool linear_wgmma(long long islands, int C, int D, int F) {
  return islands * min(C, kMaxC) * D * F >= kWgmmaMacs;
}

// W into its halves for the route (tf32_split.cuh), under a name of its own
__global__ void __launch_bounds__(tf32_split::kThreads)
hub_reuse_split_weights_kernel(const float* __restrict__ w,
                               float* __restrict__ out, int D, int F, int Dp,
                               int Fp) {
  tf32_split::split_tile(w, out, D, F, Dp, Fp);
}

namespace rl {

constexpr int kBK = tf32_split::kDepth;  // depth of a ring stage
constexpr int kXS = kBK + 8;             // x slice row stride (float2 A
                                         // loads: 4 rows hit 32 banks)
constexpr int kMaxN = 128;               // output columns a block
constexpr int kTileN = 64;               // N is a multiple of it
constexpr int kYC = 64;                  // y's columns staged at a time
constexpr int kYS = kYC + 8;             // y's row stride (≡ 8 mod 32)
constexpr int kMaxStages = 8;
constexpr int kGroup = 4;                // subsets a warp gathers at once
constexpr int kTab = 24576;              // bytes for an item's slot table
constexpr bool kXByTma = true;           // x by TMA where it may go so

struct LinParams {
  const float* pool;
  const int32_t* slot;
  const float* comp;
  const uint8_t* live;
  const float* b;
  float* out;
  long long islands;       // B * H
  int C, M, K, D, F;
  int c0, Cc, merge;       // the launch's cache rows [c0, c0 + Cc)
  int ipt;                 // islands a tile
  int nft, items;          // F tiles, tile groups x F tiles
  int nk;                  // ring stages over D
  int stages, stage_bytes;
  int x_tma, x_vec;        // x by TMA; 16-byte cp.async copies of x
};

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// bytes of a ring stage: both W halves (N rows of 64 bytes each), the x
// slice, rounded up to 1024
__host__ __device__ constexpr int stage_bytes(int R, int N) {
  return round_up(2 * N * kBK * 4 + R * kXS * 4, 1024);
}

// bytes after the ring: y's staging (R x kYS, then a row of -inf that
// every dead slot reads), the item's slot table and liveness (kTab) and
// the barriers (full and empty a stage)
__host__ __device__ constexpr int tail_bytes(int R) {
  return (R + 1) * kYS * 4 + kTab + 8 * 2 * kMaxStages;
}

// Whether an item of n slots stages its slots and liveness in the kTab
// bytes (else the gather reads them from global memory)
__host__ __device__ constexpr bool tab_fits(int n) {
  return 4 * ((n + 3) / 4 * 4) + (n + 15) / 16 * 16 <= kTab;
}

// Blocks an SM of R rows by N columns: two of one consumer warpgroup
// (R = 64), or at N = 64, where one block's gather runs beside the
// other's products; else one (R = 128 at N = 128: shared memory allows
// no more)
__host__ __device__ constexpr int blocks_per_sm(int R, int N) {
  return R <= 64 || N <= kTileN ? 2 : 1;
}

// The setmaxnreg split of the registers between the producer and the
// consumer warpgroups: at two blocks an SM 40 + 216 of 2 x 128 (R = 64)
// or 40 + 2 x 96 of 3 x 80 (R = 128, N = 64); at one (R = 128, N = 128)
// 56 + 2 x 224 of 3 x 168, as gather_mlp's linear route
template <int R, int N>
struct Regs {
  static constexpr bool kTwo = blocks_per_sm(R, N) == 2;
  static constexpr int kProducer = kTwo ? 40 : 56;
  static constexpr int kConsumer = kTwo ? (R <= 64 ? 216 : 96) : 224;
};

// a block's shared-memory budget: a block's limit, or half an SM's less
// its reserved 1 KB at two blocks an SM
__host__ __device__ constexpr int smem_budget(int R, int N) {
  return blocks_per_sm(R, N) == 2 ? 233472 / 2 - 1024 : (int)kMaxSmem;
}

// stages of the ring: as many as fit the budget, at most kMaxStages
__host__ __device__ constexpr int ring_stages(int R, int N) {
  return (smem_budget(R, N) - 1024 - tail_bytes(R)) / stage_bytes(R, N) <
                 kMaxStages
             ? (smem_budget(R, N) - 1024 - tail_bytes(R)) /
                   stage_bytes(R, N)
             : kMaxStages;
}

size_t smem_bytes(int R, int N) {
  return 1024 + (size_t)ring_stages(R, N) * stage_bytes(R, N) +
         tail_bytes(R);
}

// F's tiles at N columns, and the widest N: F in ceil(F / 128) tiles,
// each rounded up to a multiple of 64 (N = 256 took DGCNN(c)'s block 4
// in 0.115 ms against N = 128's 0.079: one block an SM, its gather
// beside nothing)
int f_tiles(int F, int N) { return (F + N - 1) / N; }
int widest(int F) {
  const int nft = (F + kMaxN - 1) / kMaxN;
  return round_up((F + nft - 1) / nft, kTileN);
}

// What a launch of Cc cache rows of each of `islands` islands tiles into
// on a card of `sms` SMs (the rules below)
struct Plan {
  int R, N, ipt, nft, stages, x_tma;
  long long groups, items;
  size_t smem, scratch;
};

// The row rule: 64 rows (one consumer warpgroup, floor(64 / Cc) islands
// a tile, two blocks an SM) where an island's Cc rows fit them, else 128
// (two, one island a tile).  DGCNN(c)'s block 4 (Cc = 40) took 0.079 ms
// in 64-row tiles against 0.097 in 128-row tiles of three islands.
int row_rule(int Cc) { return Cc > 64 ? 128 : 64; }

// The N rule: the widest N, down to 64 where the items would leave a
// quarter of the persistent grid's blocks idle
int col_rule(int R, long long groups, int F, int sms) {
  const int N = widest(F);
  return N > kTileN &&
                 4 * groups * f_tiles(F, N) < 3LL * blocks_per_sm(R, N) * sms
             ? kTileN
             : N;
}

Plan plan(long long islands, int C, int Cc, int D, int F, int sms) {
  Plan p;
  p.R = row_rule(Cc);
  p.ipt = p.R / Cc;
  p.groups = (islands + p.ipt - 1) / p.ipt;
  p.N = col_rule(p.R, p.groups, F, sms);
  p.nft = f_tiles(F, p.N);
  p.items = p.groups * p.nft;
  p.stages = ring_stages(p.R, p.N);
  p.x_tma = kXByTma && D % 4 == 0 && (p.ipt == 1 || Cc == C);
  p.smem = smem_bytes(p.R, p.N);
  // W's halves, split once a call for every launch: F to 128 rows (nft N
  // <= F to 128, N 64 or 128)
  p.scratch = 2 * sizeof(float) * (size_t)round_up(F, kMaxN) *
              round_up(D, kBK);
  return p;
}

// ties the fragments' definitions to this point (no instruction)
__device__ __forceinline__ void fence_frags(Frag<4> (&af)[kBK / 8]) {
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      asm volatile("" : "+r"(af[j].big[i]), "+r"(af[j].small[i])::"memory");
}

// An item's slots and liveness, from its first subset on: in shared
// memory (staged) or global memory, indexed alike
struct Tab {
  const int32_t* slot;
  const uint8_t* live;     // null: every slot live
};

// Where in the staged y (floats from its start) the row that slot `at`
// of the item's table (island j of the tile) reads begins, or `dead` (the
// row of -inf) where the slot is not cached, not live or outside the
// launch's rows of its island (the slot and its liveness loaded together)
__device__ __forceinline__ int slot_row(const LinParams& p, const Tab& t,
                                        int at, int j, int dead) {
  const int v = t.slot[at];
  const int lv = t.live == nullptr ? 1 : t.live[at];
  const int r = v >= 0 && lv != 0 ? min(v, p.C - 1) - p.c0 : -1;
  return r >= 0 && r < p.Cc ? (j * p.Cc + r) * kYS : dead;
}

// max over a subset's live slots of y, plus b, plus comp; -BIG where none
// is live
__device__ __forceinline__ float pooled(float m, float b, float c) {
  return m == -INFINITY ? -kBig : (m + b) + c;
}

// What a warp's group of kGroup subsets (from e0 of the tile) reads
// before its max: each subset's first 32 slots as rows of the staged y
// (lane k holds slot k's), and comp at the lane's two columns
struct Group {
  int mine[kGroup];
  float c0[kGroup], c1[kGroup];
};

__device__ __forceinline__ void load_group(const LinParams& p, const Tab& t,
                                           Group& g, long long i0, int nsub,
                                           int e0, int c, bool in0, bool in1,
                                           int lane, int dead) {
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    const int e = e0 + u;
    const bool in = e < nsub;
    const int j = in ? e / p.M : 0;
    const long long sub = (i0 + j) * p.M + (in ? e - j * p.M : 0);
    g.mine[u] = in && lane < p.K ? slot_row(p, t, e * p.K + lane, j, dead)
                                 : dead;
    const long long at = sub * p.F + c;
    g.c0[u] = in && in0 ? __ldg(p.comp + at) : 0.f;
    g.c1[u] = in && in1 ? __ldg(p.comp + at + 1) : 0.f;
  }
}

// out at columns [fc, fc + nc) of the subsets of islands [i0, i0 + nisl)
// from y staged at ys (R x kYS, those columns, then the row of -inf at
// `dead`) and the item's slots and liveness t: a warp takes kGroup
// subsets at once, its lanes columns fc + 2 lane and + 1, the next
// group's slots and comp loaded while this group's max runs
template <int kWarps>
__device__ __forceinline__ void gather(const LinParams& p, const Tab& t,
                                       const float* ys, int dead,
                                       long long i0, int nisl, int fc,
                                       int nc, int warp, int lane) {
  const float* ylane = ys + 2 * lane;
  const int c = fc + 2 * lane;
  const bool in0 = 2 * lane < nc, in1 = 2 * lane + 1 < nc;
  const float b0 = in0 ? __ldg(p.b + c) : 0.f;
  const float b1 = in1 ? __ldg(p.b + c + 1) : 0.f;
  const int nsub = nisl * p.M, step = kWarps * kGroup;
  Group cur, next;
  load_group(p, t, cur, i0, nsub, warp * kGroup, c, in0, in1, lane, dead);
  for (int e0 = warp * kGroup; e0 < nsub; e0 += step) {
    load_group(p, t, next, i0, nsub, e0 + step, c, in0, in1, lane, dead);
    float a0[kGroup], a1[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) a0[u] = a1[u] = -INFINITY;
    // branch-free, unrolled: a warp keeps 4 kGroup reads of y in flight
    // (a dead slot reads the row of -inf, the max's identity)
    const int k32 = min(p.K, 32);
#pragma unroll 4
    for (int i = 0; i < k32; ++i) {
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int r = __shfl_sync(0xffffffffu, cur.mine[u], i);
        const float2 v = *reinterpret_cast<const float2*>(ylane + r);
        a0[u] = fmaxf(a0[u], v.x);
        a1[u] = fmaxf(a1[u], v.y);
      }
    }
    for (int k0 = 32; k0 < p.K; k0 += 32) {   // slots past 32, 32 at a time
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int e = e0 + u;
        const bool in = e < nsub;
        const int j = in ? e / p.M : 0;
        const int row = in && k0 + lane < p.K
                            ? slot_row(p, t, e * p.K + k0 + lane, j, dead)
                            : dead;
        const int n = min(32, p.K - k0);
        for (int i = 0; i < n; ++i) {
          const int r = __shfl_sync(0xffffffffu, row, i);
          const float2 v = *reinterpret_cast<const float2*>(ylane + r);
          a0[u] = fmaxf(a0[u], v.x);
          a1[u] = fmaxf(a1[u], v.y);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int e = e0 + u;
      if (e >= nsub) continue;           // warp-uniform
      const int j = e / p.M;
      const long long at = ((i0 + j) * p.M + e - j * p.M) * p.F + c;
      if (in0) {
        const float v = pooled(a0[u], b0, cur.c0[u]);
        p.out[at] = p.merge ? fmaxf(p.out[at], v) : v;
      }
      if (in1) {
        const float v = pooled(a1[u], b1, cur.c1[u]);
        p.out[at + 1] = p.merge ? fmaxf(p.out[at + 1], v) : v;
      }
    }
    cur = next;
  }
}

// Consumer warpgroups 0 .. NC - 1 take 64 rows each of the R = 64 NC row
// tile; warpgroup NC is the producer.
template <int NC, int N>
__global__ void __launch_bounds__(128 * (NC + 1), blocks_per_sm(64 * NC, N))
hub_reuse_linear_kernel(const __grid_constant__ CUtensorMap wmap,
                        const __grid_constant__ CUtensorMap xmap,
                        const LinParams p) {
  constexpr int R = 64 * NC, kCons = 128 * NC;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int S = p.stages, ST = p.stage_bytes;
  float* ys = reinterpret_cast<float*>(smem + S * ST);  // (R + 1) x kYS
  int32_t* tab = reinterpret_cast<int32_t*>(ys + (R + 1) * kYS);  // kTab
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(tab) + kTab);
  uint64_t* empty = full + kMaxStages;
  // the producer threads that copy x: all where it goes by cp.async, none
  // where by TMA (thread 0 issues the TMA copies either way)
  const int copiers = p.x_tma ? 0 : 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(full + s, copiers + 1);  // their copies, the TMA
      sm90::mbar_init(empty + s, 4 * NC);      // a consumer warp each
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kCons) {
    // ---- producer: W (and x) by TMA, else x by cp.async ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(
        Regs<R, N>::kProducer));
    const int pt = threadIdx.x - kCons;
    if (pt >= (p.x_tma ? 1 : 128)) return;
    const int tx = 2 * N * kBK * 4 + (p.x_tma ? R * kXS * 4 : 0);
    int qg = 0;
    for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
      const long long i0 = (long long)(item / p.nft) * p.ipt;
      const int f0 = (item % p.nft) * N;
      const int nisl = (int)min((long long)p.ipt, p.islands - i0);
      for (int q = 0; q < p.nk; ++q, ++qg) {
        const int s = qg % S;
        sm90::mbar_wait(empty + s, ((qg / S) & 1) ^ 1);
        uint8_t* st = smem + s * ST;
        float* xs = reinterpret_cast<float*>(st + 2 * N * kBK * 4);
        const int d0 = q * kBK;
        if (pt == 0) {
          sm90::mbar_expect_tx(full + s, tx);
          sm90::tma_load(st, &wmap, full + s, d0, f0, 0);
          sm90::tma_load(st + N * kBK * 4, &wmap, full + s, d0, f0, 1);
          if (p.x_tma)
            sm90_tf32::tma_load_2d(xs, &xmap, full + s, d0,
                                   (int)(i0 * p.C + p.c0));
        }
        if (!p.x_tma) {
          // row r of the tile: row r % Cc of its island r / Cc, zero past
          // the tile's islands and past D
          for (int e = pt; e < R * (kBK / 4); e += 128) {
            const int r = e / (kBK / 4), c = (e % (kBK / 4)) * 4;
            const int j = r / p.Cc, d = d0 + c;
            float* o = xs + r * kXS + c;
            const float* src =
                p.pool + ((i0 + j) * p.C + p.c0 + (r - j * p.Cc)) * p.D + d;
            if (p.x_vec) {
              const bool ok = j < nisl && d < p.D;
              sm90_tf32::cp_async16_fill(o, ok ? src : p.pool, ok ? 16 : 0);
            } else {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const bool ok = j < nisl && d + i < p.D;
                sm90_tf32::cp_async4_fill(o + i, ok ? src + i : p.pool,
                                          ok ? 4 : 0);
              }
            }
          }
          sm90_tf32::cp_async_arrive(full + s);
        }
      }
    }
  } else {
    // ---- consumers: 64 rows each, three products a k8 step, the gather -
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(
        Regs<R, N>::kConsumer));
    const int ct = threadIdx.x, lane = ct & 31, warp = ct >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int ra = 16 * warp + g;          // rows ra and ra + 8 of mine
    // the row of -inf the dead slots read (read after the first barrier)
    for (int i = ct; i < kYS; i += kCons) ys[R * kYS + i] = -INFINITY;
    float acc[N / 2];
    int qg = 0;
    for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
      const long long i0 = (long long)(item / p.nft) * p.ipt;
      const int f0 = (item % p.nft) * N, ft = min(N, p.F - f0);
      const int nisl = (int)min((long long)p.ipt, p.islands - i0);
      // the item's slots and liveness into shared memory by cp.async,
      // waited on after the products (the last item's gather is done)
      const long long mk = (long long)p.M * p.K;
      const int nslots = (int)(nisl * mk);
      Tab tb{p.slot + i0 * mk,
             p.live == nullptr ? nullptr : p.live + i0 * mk};
      if (tab_fits(nslots)) {
        uint8_t* tl = reinterpret_cast<uint8_t*>(tab + (nslots + 3) / 4 * 4);
        for (int e = ct; e < nslots; e += kCons)
          tf32x3::cp_async4(tab + e, tb.slot + e);
        if (tb.live != nullptr) {               // 4 bytes at a time
          const int words = reinterpret_cast<uintptr_t>(tb.live) % 4 == 0
                                ? nslots / 4 : 0;
          for (int e = ct; e < words; e += kCons)
            tf32x3::cp_async4(tl + 4 * e, tb.live + 4 * e);
          for (int e = 4 * words + ct; e < nslots; e += kCons)
            tl[e] = tb.live[e];
        }
        tf32x3::cp_async_commit();
        tb = Tab{tab, tb.live == nullptr ? nullptr : tl};
      }
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
      for (int q = 0; q < p.nk; ++q, ++qg) {
        const int s = qg % S;
        const uint8_t* st = smem + s * ST;
        const float* xs = reinterpret_cast<const float*>(st + 2 * N * kBK * 4);
        sm90::mbar_wait(full + s, (qg / S) & 1);
        // both k8 steps, past D too (x and W are zero there): no branch
        // between the fence and the products, where ptxas would add a
        // warpgroup arrive and serialize them
        Frag<4> af[kBK / 8];
#pragma unroll
        for (int k8 = 0; k8 < kBK / 8; ++k8) {
          const float* px = xs + ra * kXS + 8 * k8 + 2 * t;
          const float2 lo = *reinterpret_cast<const float2*>(px);
          const float2 hi = *reinterpret_cast<const float2*>(px + 8 * kXS);
          const float v[4] = {lo.x, hi.x, lo.y, hi.y};
          tf32x3::split(af[k8], v);
        }
        const uint32_t wb = sm90::smem_u32(st);
        const uint32_t wsm = wb + N * kBK * 4;
        // acc and the fragments defined before the fence, likewise
        sm90::fence_regs(acc);
        fence_frags(af);
        sm90::wgmma_fence();
#pragma unroll
        for (int k8 = 0; k8 < kBK / 8; ++k8) {
          sm90_tf32::wgmma_tf32(acc, af[k8].small,
                                sm90_tf32::desc_sw64(wb + 32 * k8), 1);
          sm90_tf32::wgmma_tf32(acc, af[k8].big,
                                sm90_tf32::desc_sw64(wsm + 32 * k8), 1);
          sm90_tf32::wgmma_tf32(acc, af[k8].big,
                                sm90_tf32::desc_sw64(wb + 32 * k8), 1);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait();
        sm90::fence_regs(acc);
        sm90_tf32::mbar_arrive_lane0(empty + s, 1);
      }

      // ---- y 64 columns at a time, then the gather over them -----------
      for (int cc = 0; cc * kYC < ft; ++cc) {
        // chunk cc's registers, selected by constant indices (a runtime
        // index would move acc to local memory)
#pragma unroll
        for (int i = 0; i < N / 2; i += 4) {
          if (i / (kYC / 2) != cc) continue;
          float* row = ys + ra * kYS + 8 * (i / 4) - cc * kYC + 2 * t;
          *reinterpret_cast<float2*>(row) = make_float2(acc[i], acc[i + 1]);
          *reinterpret_cast<float2*>(row + 8 * kYS) =
              make_float2(acc[i + 2], acc[i + 3]);
        }
        if (cc == 0) tf32x3::cp_async_wait<0>();   // my part of the table
        sm90_tf32::named_sync(1, kCons);
        gather<4 * NC>(p, tb, ys, R * kYS, i0, nisl, f0 + cc * kYC,
                       min(kYC, ft - cc * kYC), warp, lane);
        sm90_tf32::named_sync(1, kCons);  // y read
      }
    }
  }
}

template <int NC, int N>
int launch_tile(const LinParams& p, const CUtensorMap& wmap,
                const CUtensorMap& xmap, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      hub_reuse_linear_kernel<NC, N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid =
      min(p.items, blocks_per_sm(64 * NC, N) * layered::sm_count());
  hub_reuse_linear_kernel<NC, N><<<grid, 128 * (NC + 1), smem, stream>>>(
      wmap, xmap, p);
  return (int)cudaGetLastError();
}

template <int NC>
int launch_cols(const LinParams& p, int N, const CUtensorMap& wmap,
                const CUtensorMap& xmap, size_t smem, cudaStream_t stream) {
  switch (N) {
    case 64: return launch_tile<NC, 64>(p, wmap, xmap, smem, stream);
    case 128: return launch_tile<NC, 128>(p, wmap, xmap, smem, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// One launch, the product and the gather, on W's halves as
// hub_reuse_split_weights left them (Plan::scratch bytes)
int launch(const float* pool, const int32_t* slot, const float* comp,
           const uint8_t* live, const float* halves, const float* b,
           float* out, long long islands, int C, int M, int K, int D, int F,
           int c0, int Cc, int merge, const Plan& pl, cudaStream_t stream) {
  // the rows and the items are TMA coordinates and a grid's ints
  if (halves == nullptr || islands * C >= (1LL << 31) ||
      pl.items >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const bool aligned = reinterpret_cast<uintptr_t>(pool) % 16 == 0;
  LinParams p{pool, slot, comp, live, b, out, islands, C, M, K, D, F, c0, Cc,
              merge, pl.ipt, pl.nft, (int)pl.items, (D + kBK - 1) / kBK,
              pl.stages, stage_bytes(pl.R, pl.N), pl.x_tma && aligned,
              D % 4 == 0 && aligned};
  CUtensorMap wmap, xmap;
  if (!sm90_tf32::make_weight_map(&wmap, halves, round_up(D, kBK),
                                  round_up(F, kMaxN), pl.N))
    return (int)cudaErrorInvalidValue;
  memset(&xmap, 0, sizeof(xmap));
  if (p.x_tma && !sm90_tf32::make_rows_map(&xmap, pool, D, islands * C, kXS,
                                           pl.R))
    return (int)cudaErrorInvalidValue;
  return pl.R == 128 ? launch_cols<2>(p, pl.N, wmap, xmap, pl.smem, stream)
                     : launch_cols<1>(p, pl.N, wmap, xmap, pl.smem, stream);
}

}  // namespace rl

}  // namespace

// The resident route.  chunk: cache rows a launch takes, 64 or 128
// (Rows64, or Rows128 where more than 64 are left); the wrapper covers C
// with one launch a chunk, each merged into the last (merge).  Hd = 0:
// one layer, w1 D x F, w2 and b2 null; where linear_wgmma holds, on rl::
// with W's halves in scratch (hub_reuse_split_weights, once a call: the
// floats hub_reuse_plan reports), else on hub_reuse_kernel<L, true>.
// Two layers and the mma.sync one-layer kernel take no scratch.  A call
// of the layered route (B and H as the wrapper's launch takes them), a
// chunk whose launch does not fit a block's shared memory, or weights of
// the other form are refused.
extern "C" int hub_reuse_forward(const float* pool, const int32_t* slot,
                                 const float* comp, const uint8_t* live,
                                 const float* w1, const float* b1,
                                 const float* w2, const float* b2, float* out,
                                 const float* scratch, int B, int H, int C,
                                 int M, int K, int D, int Hd, int F, int c0,
                                 int merge, int chunk, void* stream) {
  // the wrapper raises on the error: it splits C into chunks
  const int sms = layered::sm_count();
  if (C < 1 || c0 < 0 || c0 >= C || D < 1 || F < 1 || !chunk_ok(chunk) ||
      !form_ok(Hd, w2, b2) || layered_route(B, H, C, M, K, D, Hd, F, sms))
    return (int)cudaErrorInvalidValue;
  const long long islands = (long long)B * H;
  if (Hd == 0 && linear_wgmma(islands, C, D, F)) {
    const int Cc = min(chunk, C - c0);
    const rl::Plan pl = rl::plan(islands, C, Cc, D, F, sms);
    return rl::launch(pool, slot, comp, live, scratch, b1, out, islands, C,
                      M, K, D, F, c0, Cc, merge, pl, (cudaStream_t)stream);
  }
  Params p{pool, slot, comp, live, w1, b1, w2, b2, out, C, M, K, D, Hd, F,
           c0, 0, merge};
  set_shape(p, chunk);
  p.x_vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(pool) % 16 == 0;
  p.w1_vec = (Hd > 0 ? Hd : F) % 4 == 0 &&
             reinterpret_cast<uintptr_t>(w1) % 16 == 0;
  p.w2_vec = F % 4 == 0 && reinterpret_cast<uintptr_t>(w2) % 16 == 0;
  p.live_words = (long long)M * K % 4 == 0 &&
                 reinterpret_cast<uintptr_t>(live) % 4 == 0;
  if (resident_smem(p) > kMaxSmem) return (int)cudaErrorInvalidValue;
  return p.Cc <= Rows64::kR ? launch<Rows64>(p, islands, stream)
                            : launch<Rows128>(p, islands, stream);
}

// The layered route: h into scratch, y's partials after it, then the
// gather (three launches on `stream`); in one layer (Hd = 0, w2 and b2
// null) y's partials of x W1 into scratch, then the gather (two).
// scratch: the floats hub_reuse_plan reports.  A call of the resident
// route, or weights of the other form, are refused.
extern "C" int hub_reuse_layered(const float* pool, const int32_t* slot,
                                 const float* comp, const uint8_t* live,
                                 const float* w1, const float* b1,
                                 const float* w2, const float* b2, float* out,
                                 float* scratch, int B, int H, int C, int M,
                                 int K, int D, int Hd, int F, void* stream) {
  namespace ly = layered;
  const int sms = ly::sm_count();
  if (C < 1 || D < 1 || Hd < 0 || F < 1 || K < 0 || M < 1 || B < 1 ||
      H < 1 || sms < 1 || !form_ok(Hd, w2, b2) ||
      !layered_route(B, H, C, M, K, D, Hd, F, sms))
    return (int)cudaErrorInvalidValue;
  const long long N = (long long)B * H * C;
  if (N > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const ly::Plan pl = ly::plan(N, D, Hd, F, sms);
  const cudaStream_t st = (cudaStream_t)stream;
  float* h = scratch;
  float* y = scratch + N * Hd;
  cudaError_t err;
  if (Hd == 0) {                             // y = x W1, split over D
    const ly::Gemm g{pool, w1, nullptr, y, (int)N, D, F, pl.kper,
                     D % 4 == 0 && ly::aligned16(pool),
                     F % 4 == 0 && ly::aligned16(w1)};
    err = ly::run_gemm<false>(g, pl.nsplit, st);
  } else {
    const ly::Gemm g1{pool, w1, b1, h, (int)N, D, Hd,
                      ((D + kKC - 1) / kKC) * kKC,
                      D % 4 == 0 && ly::aligned16(pool),
                      Hd % 4 == 0 && ly::aligned16(w1)};
    err = ly::run_gemm<true>(g1, 1, st);
    if (err != cudaSuccess) return (int)err;
    const ly::Gemm g2{h, w2, nullptr, y, (int)N, Hd, F, pl.kper,
                      Hd % 4 == 0 && ly::aligned16(h),
                      F % 4 == 0 && ly::aligned16(w2)};
    err = ly::run_gemm<false>(g2, pl.nsplit, st);
  }
  if (err != cudaSuccess) return (int)err;
  const int mtiles = (M + ly::kGatherSubsets - 1) / ly::kGatherSubsets;
  const long long gx = (long long)B * H * mtiles;
  if (gx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int staged = C <= ly::kStagedC;
  const int gsmem = staged ? (int)sizeof(float) * C * ly::kT : 0;
  err = cudaFuncSetAttribute(ly::gather_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             gsmem);
  if (err != cudaSuccess) return (int)err;
  const ly::Gather g3{y, Hd == 0 ? b1 : b2, slot, comp, live, out, N * F,
                      C, M, K, F, pl.nsplit, mtiles, staged};
  ly::gather_kernel<<<dim3((unsigned)gx, (unsigned)((F + ly::kT - 1) / ly::kT)),
                      32 * ly::kGatherWarps, gsmem, st>>>(g3);
  return (int)cudaGetLastError();
}

// {route (0 resident, 1 layered), y's GEMM's splits (over Hd, or over D
// in one layer: Hd = 0), scratch floats, shared memory of a block} of a
// call of B clouds (one for a launch a cloud) on this card: on the
// layered route its GEMM's splits, h and y's partials in scratch and a
// GEMM block's shared memory; on the resident route no splits, a block's
// shared memory at chunk = 128 with liveness, and scratch only on rl::
// (W's halves); -1 for C < 1, D < 1, F < 1 or Hd < 0
extern "C" int hub_reuse_plan(int B, int H, int C, int M, int K, int D,
                              int Hd, int F, long long* out) {
  for (int i = 0; i < 4; ++i) out[i] = 0;
  if (C < 1 || D < 1 || F < 1 || Hd < 0) return -1;
  const int sms = layered::sm_count();
  if (!layered_route(B, H, C, M, K, D, Hd, F, sms)) {
    if (Hd == 0 && linear_wgmma((long long)B * H, C, D, F)) {
      const rl::Plan pl = rl::plan((long long)B * H, C, min(kMaxC, C), D, F,
                                   sms);
      out[2] = (long long)(pl.scratch / sizeof(float));
      out[3] = (long long)pl.smem;
      return 0;
    }
    Params p{};
    p.live = reinterpret_cast<const uint8_t*>(1);
    p.C = C;
    p.M = M;
    p.K = K;
    p.D = D;
    p.Hd = Hd;
    set_shape(p, kMaxC);
    out[3] = resident_smem(p);
    return 0;
  }
  const layered::Plan pl =
      layered::plan((long long)B * H * C, D, Hd, F, sms);
  out[0] = 1;
  out[1] = pl.nsplit;
  out[2] = pl.scratch;
  out[3] = layered::kSmem;
  return 0;
}

// Bytes of shared memory a block of the call's largest resident launch
// (its first chunk's) takes at the knob chunk, with liveness (live != 0)
// or without, in the form Hd names (0: one layer; on rl::, where
// linear_wgmma holds, its block follows B, H and F and this card's SM
// count); -1 for a chunk out of range, C < 1, D < 1, F < 1 or Hd < 0
extern "C" long long hub_reuse_smem_bytes(int B, int H, int C, int M, int K,
                                          int D, int Hd, int F, int live,
                                          int chunk) {
  if (C < 1 || D < 1 || F < 1 || Hd < 0 || !chunk_ok(chunk)) return -1;
  if (Hd == 0 && linear_wgmma((long long)B * H, C, D, F))
    return (long long)rl::plan((long long)B * H, C, min(chunk, C), D, F,
                               layered::sm_count())
        .smem;
  Params p{};
  p.live = live ? reinterpret_cast<const uint8_t*>(1) : nullptr;
  p.C = C;
  p.M = M;
  p.K = K;
  p.D = D;
  p.Hd = Hd;
  set_shape(p, chunk);
  return resident_smem(p);
}

// rl::'s plan for a one-layer call on the current device at the knob
// chunk (its first launch's), into out[10]: rows a tile, islands a tile,
// tile groups, F tiles, output columns a block (N), items, ring stages, x
// by TMA (1, where pool is 16-byte aligned) or cp.async (0), shared
// memory bytes, scratch bytes (W's halves); out[0] = -1 where the call
// does not take rl:: (the layered route, or linear_wgmma fails) or its
// widths are out of range
extern "C" void hub_reuse_linear_plan(int B, int H, int C, int M, int K,
                                      int D, int F, int chunk,
                                      long long* out) {
  const int sms = layered::sm_count();
  if (C < 1 || D < 1 || F < 1 || !chunk_ok(chunk) ||
      layered_route(B, H, C, M, K, D, 0, F, sms) ||
      !linear_wgmma((long long)B * H, C, D, F)) {
    out[0] = -1;
    return;
  }
  const rl::Plan pl = rl::plan((long long)B * H, C, min(chunk, C), D, F, sms);
  const long long v[10] = {pl.R,      pl.ipt,   pl.groups, pl.nft,
                           pl.N,      pl.items, pl.stages, pl.x_tma,
                           (long long)pl.smem, (long long)pl.scratch};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
}

// W (D x F) split into rl::'s halves at out (two F_pad x D_pad blocks,
// big then small, K-major, k permuted within 8-groups; F_pad F rounded up
// to 128, D_pad D to 16): once a call, before its launches
extern "C" int hub_reuse_split_weights(const float* w, float* out, int D,
                                       int F, void* stream) {
  if (D < 1 || F < 1) return (int)cudaErrorInvalidValue;
  const int Dp = rl::round_up(D, rl::kBK), Fp = rl::round_up(F, rl::kMaxN);
  hub_reuse_split_weights_kernel<<<tf32_split::grid(Dp, Fp),
                                   tf32_split::kThreads, 0,
                                   (cudaStream_t)stream>>>(w, out, D, F, Dp,
                                                           Fp);
  return (int)cudaGetLastError();
}

extern "C" const char* hub_reuse_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
