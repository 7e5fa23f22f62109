// hub_reuse: islandized FC — pool MLP + compensated reuse gather + masked
// max over K, fp32 in and out, both products on Hopper's tensor cores in
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
// Slots clamp at C - 1, as the plain version's do.  A launch takes a
// chunk of at most 64 or 128 cache rows (the wrapper's knob; 128 unless a
// plan says otherwise), rows [c0, c0 + chunk) of each island; the wrapper
// covers a larger C with one launch a chunk, each merged into the last
// one's output by an elementwise max (a subset with no live slot in a
// chunk gives -BIG there, the identity of that max).  The TPU kernel gathers
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
//   * Hd in chunks of 64: h_chunk = relu(x W1[:, chunk] + b1) is summed
//     over all of D, written to shared memory, and fed at once into
//     y += h_chunk W2[chunk, ftile], which stays in registers; whole h is
//     never resident, so shared memory does not grow with Hd.  W1 and W2
//     stream through one three-stage cp.async ring of 64 x 64 tiles, one
//     barrier a stage.
//   * Both products run on mma.sync m16n8k8 TF32 in three passes
//     (tf32x3.cuh): operands fp32 in shared memory, split in registers.
//   * After the last chunk, y + b2 goes to shared memory over x.  A warp
//     takes a subset, its lanes along f: it turns the subset's staged
//     slots into y rows (-1 where a slot is not cached or not live), then
//     each (m, k) reads one y row without bank conflicts and a dead slot
//     is a warp-uniform skip; comp is read once per (m, f), coalesced.
//
// The streamed route.  The route above stages x (C x D) and the slots and
// liveness (M x K) whole, so its shared memory grows with D and M*K: past
// 227 KB at 64 rows (D of ~590, or M*K of ~28,000 slots) no chunk fits.
// Such a call streams (`streams` below; the planner's copy is
// kernels/tiling.py::hub_reuse_route): the same grid, warps and ring, but
// x arrives one 64-column slice at a time, at each W1 stage, into an R x
// 64 tile that later holds y (so layer 1 is summed over D in slices, as
// gather_mlp's wide route streams x), and each warp stages its subset's
// slots and liveness kSlotTile at a time just before its gather.  Its
// shared memory is fixed: 93 KB at 64 rows, 134 KB at 128.  The slices
// are re-read once per Hd chunk, from L2; no speed was sought.
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
constexpr int kSlotTile = 128;           // slots a warp stages (streamed)
constexpr long long kMaxSmem = 232448;   // a block's shared memory

struct Params {
  const float* pool;
  const int32_t* slot;
  const float* comp;
  const uint8_t* live;
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
  float* out;
  int C, M, K, D, Hd, F;
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
// (rows of D) then kN2 stages of W2[j, ftile] (rows of the chunk).
template <int kThreads>
__device__ __forceinline__ void issue(float* ws, const Params& p, int q,
                                      int f0, int ft) {
  const int per = p.n1 + kN2, j = q / per, r = q % per;
  float* st = ws + (q % kStages) * kKC * kWS;
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

// Floats of the x region: R rows of x (a 64-column slice of them when
// streamed), later R rows of y
template <class L, bool kStream>
__host__ __device__ __forceinline__ int xy_floats(const Params& p) {
  return L::kR * (!kStream && p.XD > kHS ? p.XD : kHS);
}

// Floats before the x region: the island's slots and liveness, or each
// warp's kSlotTile staged slots when streamed
template <class L, bool kStream>
__host__ __device__ __forceinline__ int slot_floats(const Params& p) {
  return kStream ? L::kWarps * kSlotTile : p.M * p.K4 + live_floats(p);
}

// max over a subset's live slots of y, plus comp; -BIG where none is live
__device__ __forceinline__ float merged(float m, float c) {
  return m == -INFINITY ? -kBig : m + c;
}

template <class L, bool kStream>
__global__ void __launch_bounds__(L::kThreads, L::kMinBlocks)
hub_reuse_kernel(const Params p) {
  constexpr int R = L::kR, kNT = L::kNT, kThreads = L::kThreads;
  extern __shared__ __align__(16) float smem[];
  int* sl = reinterpret_cast<int*>(smem);              // M x K4 (streamed:
                                                       // warps x kSlotTile)
  uint8_t* lv = reinterpret_cast<uint8_t*>(sl + p.M * p.K4);  // M x K
  float* xs = smem + slot_floats<L, kStream>(p);       // R x XD (R x kHS)
  float* ys = xs;                                      // R x kHS, after
  float* hs = xs + xy_floats<L, kStream>(p);           // R x kHS
  float* ws = hs + R * kHS;                            // kStages x kKC x kWS

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / L::kWN, wn = warp % L::kWN;
  const long long isl = blockIdx.x;                    // b * H + h
  const int f0 = blockIdx.y * kNC;
  const int ft = min(kNC, p.F - f0);
  const int per = p.n1 + kN2;
  const int nq = p.nchunk * per;

  // ---- prologue: x by cp.async, the ring's first stages, the slots ------
  const float* poolp = p.pool + (isl * p.C + p.c0) * p.D;
  for (int e = tid; !kStream && e < R * (p.Dp / 4); e += kThreads) {
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
    if (q < nq) issue<kThreads>(ws, p, q, f0, ft);
    tf32x3::cp_async_commit();
  }
  // slots and liveness by cp.async too (a thread that waited on loads
  // here would hold up its part of the products); rows of K4
  const long long mk = (long long)p.M * p.K;
  const int32_t* slp = p.slot + isl * mk;
  for (int m = warp; !kStream && m < p.M; m += L::kWarps)
    for (int k = lane; k < p.K; k += 32)
      tf32x3::cp_async4(sl + m * p.K4 + k, slp + m * p.K + k);
  if (!kStream && p.live != nullptr) {
    const uint8_t* lvp = p.live + isl * mk;
    if (p.live_words)
      for (int e = tid; e < mk / 4; e += kThreads)
        tf32x3::cp_async4(lv + 4 * e, lvp + 4 * e);
    else
      for (int e = tid; e < mk; e += kThreads) lv[e] = lvp[e];
  }

  // ---- h a chunk at a time, y += h_chunk W2 in registers ----------------
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
      issue<kThreads>(ws, p, q + kStages - 1, f0, ft);
    tf32x3::cp_async_commit();
    const float* st = ws + (q % kStages) * kKC * kWS;
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
      if constexpr (kStream) {               // x[:, r * kKC : + kKC]
        const int d0 = r * kKC;
        for (int e = tid; e < R * kKC; e += kThreads) {
          const int row = e / kKC, col = e % kKC;
          xs[row * kHS + col] = row < p.Cc && d0 + col < p.D
                                    ? poolp[(size_t)row * p.D + d0 + col]
                                    : 0.f;
        }
        __syncthreads();                     // the slice, for all
        mma_stage<L>(acc_h, xs, kHS, 0, st, min(kKC, p.Dp - d0) / 8, wm,
                     wn, lane);
      } else {
        mma_stage<L>(acc_h, xs, p.XD, r * kKC, st,
                     min(kKC, p.Dp - r * kKC) / 8, wm, wn, lane);
      }
      if (r == p.n1 - 1)                     // read after the next barrier
        store_tile<L, true>(hs, acc_h, p.b1 + j * kNC,
                            min(kNC, p.Hd - j * kNC), wm, wn, lane);
    } else {                                 // y += h_chunk · W2 stage
      mma_stage<L>(acc_y, hs, kHS, (r - p.n1) * kKC, st, kKC / 8, wm, wn,
                   lane);
    }
  }

  // ---- y + b2 over x, then the gather ------------------------------------
  tf32x3::cp_async_wait<0>();
  __syncthreads();                           // every warp done with x
  store_tile<L, false>(ys, acc_y, p.b2 + f0, ft, wm, wn, lane);
  __syncthreads();
  // a warp a subset, lanes along f: each (m, k) reads one y row without
  // bank conflicts, and a dead slot is a warp-uniform skip
  const float2* y2 = reinterpret_cast<const float2*>(ys);
  const int c = 2 * lane;
  if constexpr (kStream) {
    // a warp a subset as above; its slots and liveness kSlotTile at a
    // time, from device memory into the warp's own rows
    int* e = sl + warp * kSlotTile;
    const uint8_t* lvp = p.live == nullptr ? nullptr : p.live + isl * mk;
    for (int m = warp; m < p.M; m += kThreads / 32) {
      const long long row = (isl * p.M + m) * p.F + f0;
      const float c0 = c < ft ? p.comp[row + c] : 0.f;
      const float c1 = c + 1 < ft ? p.comp[row + c + 1] : 0.f;
      float a0 = -INFINITY, a1 = -INFINITY;
      for (int k0 = 0; k0 < p.K; k0 += kSlotTile) {
        const int n = min(kSlotTile, p.K - k0);
        for (int k = lane; k < n; k += 32) {
          const long long at = (long long)m * p.K + k0 + k;
          const int v = slp[at];
          const bool ok = v >= 0 && (lvp == nullptr || lvp[at] != 0);
          const int s = ok ? min(v, p.C - 1) - p.c0 : -1;
          e[k] = s >= 0 && s < p.Cc ? s : -1;
        }
        __syncwarp();
        for (int k = 0; k < n; ++k) {
          const int s = e[k];
          if (s >= 0) {                      // warp-uniform
            const float2 v = y2[s * (kHS / 2) + lane];
            a0 = fmaxf(a0, v.x);
            a1 = fmaxf(a1, v.y);
          }
        }
        __syncwarp();                        // e is rewritten next
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
    return;
  }
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

// Bytes of shared memory a block of L takes
template <class L, bool kStream>
size_t smem_bytes(const Params& p) {
  return sizeof(float) * ((size_t)slot_floats<L, kStream>(p) +
                          xy_floats<L, kStream>(p) + (size_t)L::kR * kHS +
                          (size_t)kStages * kKC * kWS);
}

template <class L, bool kStream>
int launch(const Params& p, long long islands, void* stream) {
  const size_t smem = smem_bytes<L, kStream>(p);
  cudaError_t err = cudaFuncSetAttribute(
      hub_reuse_kernel<L, kStream>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)islands, (p.F + kNC - 1) / kNC);
  hub_reuse_kernel<L, kStream>
      <<<grid, L::kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
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

// Whether a call takes the streamed route: where a 64-row launch that
// stages x, the slots and the liveness whole (counted whether the call
// passes liveness or not, as the planner counts it) would pass a block's
// shared memory
bool streams(int C, int M, int K, int D) {
  Params p{};
  p.live = reinterpret_cast<const uint8_t*>(1);
  p.C = C;
  p.M = M;
  p.K = K;
  p.D = D;
  set_shape(p, Rows64::kR);
  return (long long)smem_bytes<Rows64, false>(p) > kMaxSmem;
}

// Shared memory of a block of the launch p (its shape set) on its route
long long route_smem(const Params& p, bool stream) {
  const bool r64 = p.Cc <= Rows64::kR;
  if (stream)
    return (long long)(r64 ? smem_bytes<Rows64, true>(p)
                           : smem_bytes<Rows128, true>(p));
  return (long long)(r64 ? smem_bytes<Rows64, false>(p)
                         : smem_bytes<Rows128, false>(p));
}

}  // namespace

// chunk: cache rows a launch takes, 64 (Rows64) or 128 (Rows128 where
// more than 64 are left); the wrapper covers C with one launch a chunk.
// The route follows from C, M, K and D (`streams`); a chunk whose launch
// does not fit its route's shared memory is refused.
extern "C" int hub_reuse_forward(const float* pool, const int32_t* slot,
                                 const float* comp, const uint8_t* live,
                                 const float* w1, const float* b1,
                                 const float* w2, const float* b2, float* out,
                                 int B, int H, int C, int M, int K, int D,
                                 int Hd, int F, int c0, int merge, int chunk,
                                 void* stream) {
  // the wrapper raises on the error: it splits C into chunks
  if (C < 1 || c0 < 0 || c0 >= C || D < 1 || !chunk_ok(chunk))
    return (int)cudaErrorInvalidValue;
  Params p{pool, slot, comp, live, w1, b1, w2, b2, out, C, M, K, D, Hd, F,
           c0, 0, merge};
  set_shape(p, chunk);
  p.x_vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(pool) % 16 == 0;
  p.w1_vec = Hd % 4 == 0 && reinterpret_cast<uintptr_t>(w1) % 16 == 0;
  p.w2_vec = F % 4 == 0 && reinterpret_cast<uintptr_t>(w2) % 16 == 0;
  p.live_words = (long long)M * K % 4 == 0 &&
                 reinterpret_cast<uintptr_t>(live) % 4 == 0;
  const long long islands = (long long)B * H;
  const bool streamed = streams(C, M, K, D);
  if (route_smem(p, streamed) > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (streamed)
    return p.Cc <= Rows64::kR ? launch<Rows64, true>(p, islands, stream)
                              : launch<Rows128, true>(p, islands, stream);
  return p.Cc <= Rows64::kR ? launch<Rows64, false>(p, islands, stream)
                            : launch<Rows128, false>(p, islands, stream);
}

// Bytes of shared memory a block of the call's largest launch (its first
// chunk's) takes at the knob chunk on the call's route, with liveness
// (live != 0) or without; -1 for a chunk out of range or C < 1
extern "C" long long hub_reuse_smem_bytes(int C, int M, int K, int D, int Hd,
                                          int live, int chunk) {
  if (C < 1 || D < 1 || !chunk_ok(chunk)) return -1;
  Params p{};
  p.live = live ? reinterpret_cast<const uint8_t*>(1) : nullptr;
  p.C = C;
  p.M = M;
  p.K = K;
  p.D = D;
  p.Hd = Hd;
  set_shape(p, chunk);
  return route_smem(p, streams(C, M, K, D));
}

// 1 where a call of these widths takes the streamed route, else 0
extern "C" int hub_reuse_streams(int C, int M, int K, int D) {
  return C >= 1 && D >= 1 && streams(C, M, K, D) ? 1 : 0;
}

extern "C" const char* hub_reuse_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
