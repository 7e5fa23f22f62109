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
// every other call (three launches for two layers, two for one).
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
//   * One layer (a template flag of the same kernel): the ring streams
//     only W1[:, f0 : f0 + 64] over D into y's registers, ceil(D / 64)
//     stages against the two-layer form's ceil(Hd / 64) (ceil(D / 64) +
//     1); no relu, no h tile (its R x 72 floats of shared memory are not
//     taken, so 128 rows of a wider D fit a block), no second product.
//   * The products run on mma.sync m16n8k8 TF32 in three passes
//     (tf32x3.cuh): operands fp32 in shared memory, split in registers.
//   * After the last stage, y plus its bias (b2, or b1 in one layer) goes
//     to shared memory over x.  A warp takes a subset, its lanes along f:
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
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

}  // namespace

// The resident route.  chunk: cache rows a launch takes, 64 (Rows64) or
// 128 (Rows128 where more than 64 are left); the wrapper covers C with one
// launch a chunk.  Hd = 0: one layer, w1 D x F, w2 and b2 null.  A call
// of the layered route (B and H as the wrapper's launch takes them), a
// chunk whose launch does not fit a block's shared memory, or weights of
// the other form are refused.
extern "C" int hub_reuse_forward(const float* pool, const int32_t* slot,
                                 const float* comp, const uint8_t* live,
                                 const float* w1, const float* b1,
                                 const float* w2, const float* b2, float* out,
                                 int B, int H, int C, int M, int K, int D,
                                 int Hd, int F, int c0, int merge, int chunk,
                                 void* stream) {
  // the wrapper raises on the error: it splits C into chunks
  if (C < 1 || c0 < 0 || c0 >= C || D < 1 || !chunk_ok(chunk) ||
      !form_ok(Hd, w2, b2) ||
      layered_route(B, H, C, M, K, D, Hd, F, layered::sm_count()))
    return (int)cudaErrorInvalidValue;
  Params p{pool, slot, comp, live, w1, b1, w2, b2, out, C, M, K, D, Hd, F,
           c0, 0, merge};
  set_shape(p, chunk);
  p.x_vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(pool) % 16 == 0;
  p.w1_vec = (Hd > 0 ? Hd : F) % 4 == 0 &&
             reinterpret_cast<uintptr_t>(w1) % 16 == 0;
  p.w2_vec = F % 4 == 0 && reinterpret_cast<uintptr_t>(w2) % 16 == 0;
  p.live_words = (long long)M * K % 4 == 0 &&
                 reinterpret_cast<uintptr_t>(live) % 4 == 0;
  const long long islands = (long long)B * H;
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
// call of B clouds (one for a launch a cloud) on this card (the splits
// and scratch 0 on the resident route, whose shared memory is at chunk =
// 128 with liveness); -1 for C < 1, D < 1 or Hd < 0
extern "C" int hub_reuse_plan(int B, int H, int C, int M, int K, int D,
                              int Hd, int F, long long* out) {
  for (int i = 0; i < 4; ++i) out[i] = 0;
  if (C < 1 || D < 1 || Hd < 0) return -1;
  const int sms = layered::sm_count();
  if (!layered_route(B, H, C, M, K, D, Hd, F, sms)) {
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
// or without, in the form Hd names (0: one layer); -1 for a chunk out of
// range, C < 1 or Hd < 0
extern "C" long long hub_reuse_smem_bytes(int C, int M, int K, int D, int Hd,
                                          int live, int chunk) {
  if (C < 1 || D < 1 || Hd < 0 || !chunk_ok(chunk)) return -1;
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

extern "C" const char* hub_reuse_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
