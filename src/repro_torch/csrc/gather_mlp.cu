// gather_mlp: fused center-normalize -> 2-layer MLP -> max over K, fp32 in
// and out, both products on Hopper's tensor cores in 3xTF32.
//
// Replaces the Pallas TPU kernels gather_mlp_pallas and
// gather_mlp_batched_pallas (src/repro/kernels/gather_mlp/gather_mlp.py,
// bodies _mlp_pool, _gather_mlp_kernel, _gather_mlp_masked_kernel and
// their batched twins): for each (cloud b, subset s)
//
//     x   = [raw[b,s,:,:Dc] - ctr[b,s], raw[b,s,:,Dc:]]        (K, D)
//     y   = relu(x W1 + b1) W2 + b2                           (K, F)
//     out = max over live k of y                               (F,)
//
// and a masked subset with no live position gives a zero row.  The batch
// and the per-cloud entry are the same kernel (B = 1 for one cloud).
//
// What bounds it on an H100: the products.  At the pointnet2_c shapes the
// work is 2*B*S*K*(D*H + H*F) flops against one read of raw and one write
// of out: at B = 8, block 1 (S=512 K=32 D=65 H=64 F=128) is 3.24 GFLOP
// against 36 MB, block 2 (S=128 K=64 D=129 H=128 F=256) 6.46 GFLOP against
// 35 MB.  The kernel is held to 1e-4 of the fp32 result, which one TF32
// pass breaks (its 10-bit mantissa leaves ~3e-3 here) and 3xTF32 keeps, so
// the least time is 3 x flops at the 495 TFLOP/s TF32 peak: 0.0196 ms
// (block 1) and 0.0391 ms (block 2), above the bytes' 0.011 ms.
//
// What the design does about it:
//   * Row tiles of whole subsets: a block of 8 warps takes R = 128 rows
//     (64 when 128-row tiles would give fewer than two blocks an SM), K
//     rounded up to 16 per subset, the padded rows dead in the max; a
//     subset longer than R loops over row tiles with a running max.
//   * The tile's raw rows arrive by cp.async, all in flight at once, into
//     a shared-memory x with D zero-padded to a multiple of 8 and a row
//     stride that keeps fragment loads free of bank conflicts; the centers
//     are subtracted there.  W1 and W2 stream through a two-stage cp.async
//     ring of 32 rows by 128 columns, and each product's last stage starts
//     the next product's first.
//   * h = x W1 and y = h W2 run on mma.sync m16n8k8 TF32: operands stay
//     fp32 in shared memory and are split into big and small halves in
//     registers (tf32x3.cuh); the 8 warps tile 4 x 2 (128-row tiles) or
//     2 x 4 (64-row tiles) over rows x columns, each with 32 rows of
//     accumulators.  relu(h + b1) is written over x when H fits one
//     128-column chunk.
//   * y never leaves the registers: b2 is added, dead rows become -3.4e38,
//     the rows of each m16 tile meet by shuffles and the m16 tiles of a
//     subset in shared memory, where a running max per subset is kept.
// 108 KB of shared memory at block 2 (76 KB at block 1) and at most 128
// registers a thread, so two blocks share an SM and one block's loads and
// barriers hide behind the other's products.
//
// That is the narrow route.  Where a 64-row tile's x and whole h exceed a
// block's 227 KB, gather_mlp_forward takes the wide route (namespace wide
// below), which holds y in registers and h in 32-column chunks.  A call
// with no hidden layer (H = 0: y = x W + b, one product, no relu) takes
// the linear route (namespace linear below).
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "sm90_tf32.cuh"
#include "tf32_split.cuh"
#include "tf32x3.cuh"

namespace {

using tf32x3::Frag;

constexpr int kThreads = 256;            // 8 warps
constexpr int kBlocksPerSM = 2;          // resident blocks the tiles aim at
constexpr int kMT = 2;                   // m16 tiles per warp
constexpr int kNC = 128;                 // columns of W per chunk
constexpr int kKC = 32;                  // rows of W per ring stage
constexpr int kWS = kNC + 4;             // stage row stride (≡ 4 mod 16)
constexpr float kBig = 3.4e38f;          // the max-pool identity of the JAX code
constexpr int kMaxSmem = 232448;         // a block's shared-memory limit
constexpr int kSmemSM = 233472;          // an SM's

struct Params {
  const float* raw;
  const float* ctr;
  const uint8_t* mask;
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
  float* out;
  long long bs;            // B * S subsets
  int K, D, Dc, H, F;
  int Kp, Dp, Hp, XH;      // K to 16, D and H to 8, the x/h row stride
  int spt;                 // subsets per row tile (1 when Kp > rows)
  int w1_vec, w2_vec;      // 16-byte copies of W rows allowed
};

// One W chunk streamed through the ring: columns [c0, c0 + nc) of the
// row-major kdim x ncols matrix w, kKC rows a stage.
struct Chunk {
  const float* w;
  int kdim, ncols, c0, nc;
  bool vec;                // 16-byte copies allowed
};

// Stage rows [k0, k0 + kKC) of chunk q; rows past kdim and columns past nc
// (up to the next multiple of 8) are zero.
__device__ __forceinline__ void load_stage(float* st, const Chunk& q,
                                           int k0) {
  const int nc8 = (q.nc + 7) & ~7;
  for (int e = threadIdx.x; e < kKC * (kNC / 4); e += kThreads) {
    const int r = e / (kNC / 4), c = (e % (kNC / 4)) * 4;
    if (c >= nc8) continue;
    float* dst = st + r * kWS + c;
    const int kr = k0 + r;
    const float* src = q.w + (size_t)kr * q.ncols + q.c0 + c;
    if (q.vec && kr < q.kdim && c < q.nc) {
      tf32x3::cp_async16(dst, src);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (kr < q.kdim && c + i < q.nc) tf32x3::cp_async4(dst + i, src + i);
        else dst[i] = 0.f;
      }
    }
  }
}

// The warps of a block as WM x WN over rows x columns: each warp holds
// kMT m16 tiles by kNT n8 tiles of a 128-column chunk.  4 x 2 gives
// 128-row tiles, 2 x 4 gives 64-row ones.
template <int WM>
struct Layout {
  static constexpr int kWM = WM, kWN = kThreads / 32 / WM;
  static constexpr int kR = 16 * kMT * WM;          // rows per tile
  static constexpr int kNT = kNC / (8 * kWN);       // n8 tiles per warp
};

// acc = a[:, :kp] · chunk q (this warp's 16·kMT rows and its n8 tiles).
// On entry the first stage of q is in flight in ring slot `slot`; the last
// stage's turn starts the first stage of `next` (if next.nc > 0) in the
// other slot, so the next product finds it there.  Ends with a barrier:
// every warp is done with a and with q's stages.
template <class L>
__device__ __forceinline__ void gemm(float (&acc)[kMT][L::kNT][4],
                                     const float* a, int lda, int kp,
                                     float* ws, int& slot, const Chunk& q,
                                     const Chunk& next, int wm, int wn,
                                     int lane) {
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int j = 0; j < L::kNT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;
  const int nk = (kp + kKC - 1) / kKC;
  const int nc8 = (q.nc + 7) & ~7;
  for (int kc = 0; kc < nk; ++kc) {
    float* other = ws + (slot ^ 1) * kKC * kWS;
    if (kc + 1 < nk || next.nc > 0) {
      if (kc + 1 < nk) load_stage(other, q, (kc + 1) * kKC);
      else load_stage(other, next, 0);
      tf32x3::cp_async_commit();
      tf32x3::cp_async_wait<1>();
    } else {
      tf32x3::cp_async_wait<0>();
    }
    __syncthreads();
    const float* st = ws + slot * kKC * kWS;
    const int steps = min(kKC, kp - kc * kKC) / 8;
#pragma unroll
    for (int s = 0; s < kKC / 8; ++s) {   // fully unrolled: no spills
      if (s >= steps) break;
      const int k = kc * kKC + s * 8;
      Frag<4> af[kMT];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        af[mt] = tf32x3::load_a(a, lda, (wm * kMT + mt) * 16, k, lane);
#pragma unroll
      for (int j = 0; j < L::kNT; ++j) {
        const int n0 = (wn + L::kWN * j) * 8;
        if (n0 < nc8) {
          const Frag<2> bf = tf32x3::load_b(st, kWS, s * 8, n0, lane);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
            tf32x3::mma3(acc[mt][j], af[mt], bf);
        }
      }
    }
    __syncthreads();
    slot ^= 1;
  }
}

template <class L>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
gather_mlp_kernel(const Params p) {
  constexpr int R = L::kR, kNT = L::kNT;
  extern __shared__ float smem[];
  const bool inplace = p.H <= kNC;        // h over x: one chunk holds it
  float* xs = smem;                                    // R x XH
  float* hs = inplace ? xs : xs + R * p.XH;            // R x XH
  float* ws = xs + R * p.XH * (inplace ? 1 : 2);       // 2 x kKC x kWS
  float* red = ws + 2 * kKC * kWS;                     // R/16 x kNC
  float* pool = red + (R / 16) * kNC;                  // spt x F
  float* cs = pool + p.spt * p.F;                      // spt x Dc
  int* rowlive = reinterpret_cast<int*>(cs + p.spt * p.Dc);  // R
  int* anyl = rowlive + R;                             // spt

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / L::kWN, wn = warp % L::kWN;
  const int g = lane >> 2, t = lane & 3;
  const int spt = p.spt;
  const bool multi = p.Kp > R;            // one subset over several tiles
  const int n_tiles = multi ? (p.Kp + R - 1) / R : 1;
  const int per = min(p.Kp, R) / 16;      // m16 tiles of a subset in a tile
  const long long sub0 = (long long)blockIdx.x * spt;
  const Chunk none{nullptr, 0, 0, 0, 0, false};
  auto w1_chunk = [&](int h0) {
    return Chunk{p.w1, p.D, p.H, h0, min(kNC, p.H - h0), p.w1_vec != 0};
  };
  auto w2_chunk = [&](int f0) {
    return f0 < p.F ? Chunk{p.w2, p.H, p.F, f0, min(kNC, p.F - f0),
                            p.w2_vec != 0}
                    : none;
  };
  // (subset slot, position in the subset) of row r of tile it
  auto row_at = [&](int it, int r, int& sl, int& k) {
    if (multi) {
      sl = 0;
      k = it * R + r;
    } else {
      sl = r / p.Kp;
      k = r % p.Kp;
    }
    return sl < spt && k < p.K && sub0 + sl < p.bs;
  };

  for (int e = tid; e < spt * p.F; e += kThreads) pool[e] = -kBig;
  for (int e = tid; e < spt; e += kThreads) anyl[e] = 0;
  for (int e = tid; e < spt * p.Dc; e += kThreads)
    cs[e] = sub0 + e / p.Dc < p.bs ? p.ctr[sub0 * p.Dc + e] : 0.f;
  __syncthreads();

  float acc[kMT][kNT][4];
  int slot = 0;
  for (int it = 0; it < n_tiles; ++it) {
    // ---- prologue: raw rows by cp.async, then W1's first stage ------------
    for (int r = warp; r < R; r += kThreads / 32) {
      int sl, k;
      const bool valid = row_at(it, r, sl, k);
      const float* src = p.raw + ((size_t)(sub0 + sl) * p.K + k) * p.D;
      for (int d = lane; d < p.Dp; d += 32) {
        if (valid && d < p.D) tf32x3::cp_async4(xs + r * p.XH + d, src + d);
        else xs[r * p.XH + d] = 0.f;
      }
    }
    tf32x3::cp_async_commit();
    load_stage(ws + slot * kKC * kWS, w1_chunk(0), 0);
    tf32x3::cp_async_commit();
    for (int r = tid; r < R; r += kThreads) {
      int sl, k;
      const int lv = row_at(it, r, sl, k) &&
                     (p.mask == nullptr ||
                      p.mask[(size_t)(sub0 + sl) * p.K + k] != 0);
      rowlive[r] = lv;
      if (lv) anyl[sl] = 1;
    }
    tf32x3::cp_async_wait<1>();           // the raw rows
    __syncthreads();
    for (int e = tid; e < R * p.Dc; e += kThreads) {   // x = raw - ctr
      const int r = e / p.Dc, d = e % p.Dc;
      int sl, k;
      if (row_at(it, r, sl, k)) xs[r * p.XH + d] -= cs[sl * p.Dc + d];
    }

    // ---- h = relu(x W1 + b1), 128 columns at a time -----------------------
    for (int h0 = 0; h0 < p.H; h0 += kNC) {
      const Chunk next = h0 + kNC < p.H ? w1_chunk(h0 + kNC) : w2_chunk(0);
      gemm<L>(acc, xs, p.XH, p.Dp, ws, slot, w1_chunk(h0), next, wm, wn,
               lane);
      const int nc8 = (min(kNC, p.H - h0) + 7) & ~7;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n0 = (wn + L::kWN * j) * 8;
        if (n0 >= nc8) continue;                   // a tile gemm skipped
        const int c = h0 + n0 + 2 * t;
        const float bias0 = c < p.H ? __ldg(p.b1 + c) : 0.f;
        const float bias1 = c + 1 < p.H ? __ldg(p.b1 + c + 1) : 0.f;
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          float* row = hs + ((wm * kMT + mt) * 16 + g) * p.XH + c;
          const float* v = acc[mt][j];
          row[0] = c < p.H ? fmaxf(v[0] + bias0, 0.f) : 0.f;
          row[1] = c + 1 < p.H ? fmaxf(v[1] + bias1, 0.f) : 0.f;
          row[8 * p.XH] = c < p.H ? fmaxf(v[2] + bias0, 0.f) : 0.f;
          row[8 * p.XH + 1] = c + 1 < p.H ? fmaxf(v[3] + bias1, 0.f) : 0.f;
        }
      }
    }

    // ---- y = h W2 + b2, 128 columns at a time, pooled in registers --------
    for (int f0 = 0; f0 < p.F; f0 += kNC) {
      const Chunk q = w2_chunk(f0);
      gemm<L>(acc, hs, p.XH, p.Hp, ws, slot, q, w2_chunk(f0 + kNC), wm,
               wn, lane);
      const int nc = q.nc;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int c = (wn + L::kWN * j) * 8 + 2 * t;
        const float bias0 = c < nc ? __ldg(p.b2 + f0 + c) : 0.f;
        const float bias1 = c + 1 < nc ? __ldg(p.b2 + f0 + c + 1) : 0.f;
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          const float* v = acc[mt][j];
          const int r0 = (wm * kMT + mt) * 16 + g;
          const bool l0 = rowlive[r0], l1 = rowlive[r0 + 8];
          float m0 = fmaxf(l0 ? v[0] + bias0 : -kBig, l1 ? v[2] + bias0 : -kBig);
          float m1 = fmaxf(l0 ? v[1] + bias1 : -kBig, l1 ? v[3] + bias1 : -kBig);
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
            m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
          }
          if (g == 0) {                  // columns past nc: never read
            red[(wm * kMT + mt) * kNC + c] = m0;
            red[(wm * kMT + mt) * kNC + c + 1] = m1;
          }
        }
      }
      __syncthreads();
      // each subset's m16 tiles meet in its running max
      for (int e = tid; e < spt * nc; e += kThreads) {
        const int s = e / nc, c = e % nc;
        float m = pool[s * p.F + f0 + c];
        for (int i = 0; i < per; ++i) m = fmaxf(m, red[(s * per + i) * kNC + c]);
        pool[s * p.F + f0 + c] = m;
      }
      __syncthreads();
    }
  }

  for (int e = tid; e < spt * p.F; e += kThreads) {
    const int s = e / p.F;
    if (sub0 + s < p.bs)
      p.out[(sub0 + s) * p.F + e % p.F] = anyl[s] ? pool[e] : 0.f;
  }
}

int padded_k(int K) { return K > 0 ? (K + 15) / 16 * 16 : 16; }

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 132;
  return sms;
}

size_t smem_bytes(int R, const Params& p, int spt) {
  const size_t xh = (size_t)R * p.XH * (p.H <= kNC ? 1 : 2);
  return sizeof(float) * (xh + 2 * kKC * kWS + (R / 16) * kNC +
                          (size_t)spt * (p.F + p.Dc)) +
         sizeof(int) * (R + spt);
}

template <class L>
int launch(const Params& p, size_t smem, long long grid, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gather_mlp_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  gather_mlp_kernel<L><<<(unsigned)grid, kThreads, smem,
                          (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// ---- the wide route: y in registers, h in 32-column chunks ---------------
// Where a 64-row tile's x and whole h overflow a block's shared memory
// (the widest blocks of dgcnn_c, pointnext_s and pointvector_l, whose
// one-layer MLPs two_layer_form turns into Hd = 2F, and any D past that),
// gather_mlp_forward takes the route below.  A block takes one 64-row
// tile of whole subsets, packed K rows apart with no padding (K = 20 puts
// 3 subsets in 60 rows), and up to 256 output features, whose y stays in
// registers (64 floats a thread).  For each 32 columns c of H,
// h_c = relu(x W1[:, c] + b1[c]) goes to shared memory and at once into
// y += h_c W2[c, ftile], so layer 1 runs once per block: once in all
// where F <= 256, once per 256-wide F tile above.  Where the row tiles
// times the F tiles give fewer blocks than SMs (pointnext_s blocks 3-4
// and pointvector_l block 4 at B = 2), H is split across
// blocks too; each writes its partial y to device scratch, and a second
// kernel sums the parts, adds b2, masks and pools.
//
// x is resident in shared memory where it fits beside the ring within
// half an SM (two blocks an SM; D up to 256); past that it streams
// through the ring in 64-column slices beside W1's rows, re-read from L2
// for each h chunk, so any D fits.  W1 and W2 stream through a two-stage
// cp.async ring (one barrier a stage).  The centers are subtracted by the
// thread that copied each x element, right after its copy lands (once a
// tile where x is resident).  Products in 3xTF32 as above, the small
// parts truncated (split_fast).  The pool goes through shared memory:
// y + b2 is stored over the ring, and a thread a (subset, column) takes
// the max over the subset's live rows, wherever its subset starts in the
// tile; a subset longer than a tile keeps a running max across tiles.
//
// What bounds it: the products.  dgcnn_c block 4 at B = 8 (S=1024 K=20
// D=256 Hd=512 F=256) is 85.9 GFLOP in fp32, 0.52 ms at the TF32 peak in
// three passes; the pointnext_s and pointvector_l blocks at B = 2 are 3.2
// to 7.3 GFLOP, 0.020 to 0.044 ms.  Packing K = 20 three to a tile leaves
// 6 % of the rows dead (37.5 % at K padded to 16), and the layer-1
// recompute is 1 at F <= 256 and the number of F tiles above.
namespace wide {

constexpr int kR = 64;                   // rows per tile: 8 warps as 2 x 4
constexpr int kWN = 4;                   // warps along y's columns
constexpr int kHC = 32;                  // columns of h a chunk
constexpr int kWNH = 2;                  // warps along h's columns (4 x 2)
constexpr int kNH = kHC / (8 * kWNH);    // n8 tiles of h a warp (one m16)
constexpr int kDCR = 128;                // rows of W1 a stage, x resident
constexpr int kDCS = 64;                 // rows of W1 a stage, x streamed
constexpr int kMaxFT = 256;              // output columns a block holds
constexpr int kBlocks = 2;               // blocks an SM the plan aims at
constexpr int kSmemSM = 233472;          // an SM's shared memory
constexpr int kBudget = kSmemSM / kBlocks - 1024;  // a block's share
constexpr int kW1S = kHC + 4;            // W1 stage row stride (≡ 4 mod 16)
constexpr int kXS = kDCS + 8;            // x slice row stride (≡ 8 mod 32)
constexpr int kHS = kHC + 8;             // h row stride (≡ 8 mod 32)
constexpr bool kFast = true;             // split_fast: small parts truncated

// rows of W2 a stage for FT output columns: a multiple of 8 dividing kHC,
// at most 17 KB
__host__ __device__ constexpr int rows2(int ft) {
  return 4352 / (ft + 4) / 8 * 8 < kHC ? 4352 / (ft + 4) / 8 * 8 : kHC;
}

struct WideParams {
  const float* raw;
  const float* ctr;
  const uint8_t* mask;
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
  float* out;
  float* part;             // partial y of each H split, null with one split
  long long bs;            // B * S subsets
  int K, D, Dc, H, F;
  int Kp;                  // rows a subset takes in a tile
  int spt, n_tiles;        // subsets a tile (1 when Kp > kR), tiles a subset
  int Dp, XD;              // D to 8; x's row stride, 0 where x streams
  int dc;                  // rows of W1 a stage (kDCR or kDCS)
  int n1, nchunk, cps;     // D slices, H chunks, H chunks a split
  int FT, FP;              // output columns a block, partial row stride
  int stage;               // floats of a ring stage
  int x_vec, w1_vec, w2_vec;  // 16-byte copies allowed
};

// rows x COLS (a multiple of 4) of the row-major src (row stride lds)
// into dst (row stride ldd); rows from rlim and columns from clim are zero
template <int COLS>
__device__ __forceinline__ void copy_tile(float* dst, int ldd,
                                          const float* src, int lds,
                                          int rows, int rlim, int clim,
                                          bool vec) {
  for (int e = threadIdx.x; e < rows * (COLS / 4); e += kThreads) {
    const int r = e / (COLS / 4), c = (e % (COLS / 4)) * 4;
    float* d = dst + r * ldd + c;
    const float* s = src + (size_t)r * lds + c;
    if (vec && r < rlim && c < clim) {
      tf32x3::cp_async16(d, s);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (r < rlim && c + i < clim) tf32x3::cp_async4(d + i, s + i);
        else d[i] = 0.f;
      }
    }
  }
}

// A warp's accumulators: MT m16 tiles (rows (wm * MT + mt) * 16) by NT n8
// tiles (columns (wn + WN * j) * 8), WN warps along the columns.
// acc += a[its rows, 0 : 8 * steps) · b[0 : 8 * steps, its columns]
template <int MT, int NT, int WN, int STEPS>
__device__ __forceinline__ void mma_stage(float (&acc)[MT][NT][4],
                                          const float* a, int lda,
                                          const float* b, int ldb, int steps,
                                          int wm, int wn, int lane) {
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {       // fully unrolled: no spills
    if (s >= steps) break;
    Frag<4> af[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      af[mt] = tf32x3::load_a<kFast>(a, lda, (wm * MT + mt) * 16, s * 8,
                                     lane);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const Frag<2> bf =
          tf32x3::load_b<kFast>(b, ldb, s * 8, (wn + WN * j) * 8, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) tf32x3::mma3(acc[mt][j], af[mt], bf);
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;
}

// acc plus a bias on columns below n (0 past them), relu'd if asked, as a
// row-major tile of row stride ld
template <int MT, int NT, int WN, bool kRelu>
__device__ __forceinline__ void store_acc(float* dst, int ld,
                                          const float (&acc)[MT][NT][4],
                                          const float* bias, int n, int wm,
                                          int wn, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = (wn + WN * j) * 8 + 2 * t;
    const float bias0 = c < n ? __ldg(bias + c) : 0.f;
    const float bias1 = c + 1 < n ? __ldg(bias + c + 1) : 0.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* v = acc[mt][j];
      float2 lo = make_float2(v[0] + bias0, v[1] + bias1);
      float2 hi = make_float2(v[2] + bias0, v[3] + bias1);
      if (kRelu) {
        lo = make_float2(fmaxf(lo.x, 0.f), fmaxf(lo.y, 0.f));
        hi = make_float2(fmaxf(hi.x, 0.f), fmaxf(hi.y, 0.f));
      }
      float* row = dst + ((wm * MT + mt) * 16 + g) * ld + c;
      *reinterpret_cast<float2*>(row) = lo;
      *reinterpret_cast<float2*>(row + 8 * ld) = hi;
    }
  }
}

constexpr int kTab = 3 * kR + 4;         // ints of the row tables (16-byte)

// Floats of the kernel's main region: x (resident), h and the ring, and
// later y over them
__host__ __device__ __forceinline__ int main_floats(const WideParams& p) {
  const int xhr = kR * (p.XD + kHS) + 2 * p.stage, ys = kR * (p.FT + 8);
  return xhr > ys ? xhr : ys;
}

// threadIdx.x and blockIdx read afresh for the epilogue: otherwise the
// compiler keeps values it made from the prologue's reads live across the
// main loop, and at 128 registers spills them
__device__ __forceinline__ int fresh_tid() {
  int v;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(v));
  return v;
}

template <int I>
__device__ __forceinline__ int fresh_ctaid() {
  int v;
  if constexpr (I == 0) asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(v));
  else if constexpr (I == 1) asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(v));
  else asm volatile("mov.u32 %0, %%ctaid.z;" : "=r"(v));
  return v;
}

template <int NY>
__global__ void __launch_bounds__(kThreads, kBlocks)
gather_mlp_wide_kernel(const WideParams p) {
  constexpr int FT = 32 * NY, R2 = rows2(FT), W2S = FT + 4, YS = FT + 8;
  static_assert(kHC % R2 == 0, "W2 stages tile an h chunk");
  extern __shared__ __align__(16) float smem_w[];
  const bool resident = p.XD > 0;
  // the row tables first, at fixed offsets (no registers hold them)
  int* xrow = reinterpret_cast<int*>(smem_w);          // kR: raw row
  int* rowsub = xrow + kR;                             // kR: subset slot
  int* rowlive = rowsub + kR;                          // kR
  int* anyl = rowlive + kR;                            // 1
  float* xs = smem_w + kTab;                           // kR x XD (resident)
  float* hs = xs + kR * p.XD;                          // kR x kHS
  float* ring = hs + kR * kHS;                         // 2 x stage
  float* ys = xs;                                      // kR x YS, at the end

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / kWN, wn = warp % kWN;
  const bool multi = p.n_tiles > 1;       // one subset over several tiles
  const long long grp = blockIdx.x, sub0 = grp * p.spt;
  const int f0 = blockIdx.y * FT, ft = min(FT, p.F - f0);
  const int j0 = blockIdx.z * p.cps, j1 = min(p.nchunk, j0 + p.cps);
  const int n2 = kHC / R2, per = p.n1 + n2, nq = (j1 - j0) * per;

  // x's columns [d0, d0 + width) of the tile's rows into dst (row stride
  // ld), rows past the subsets and columns past D zero
  auto load_x = [&](float* dst, int ld, int d0, int width) {
    for (int e = tid; e < kR * (width / 4); e += kThreads) {
      const int r = e / (width / 4), c = (e % (width / 4)) * 4, d = d0 + c;
      float* o = dst + r * ld + c;
      const int row = xrow[r];
      const float* src = p.raw + (size_t)row * p.D + d;
      if (p.x_vec && row >= 0 && d < p.D) {
        tf32x3::cp_async16(o, src);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (row >= 0 && d + i < p.D) tf32x3::cp_async4(o + i, src + i);
          else o[i] = 0.f;
        }
      }
    }
  };
  // x = raw - ctr on the first Dc columns: each thread on the elements
  // load_x gave it, once its own copies have landed
  auto center = [&](float* dst, int ld, int d0, int width) {
    if (d0 >= p.Dc) return;
#pragma unroll 4              // 4 quads' loads in flight (rolled: spills)
    for (int e = tid; e < kR * (width / 4); e += kThreads) {
      const int r = e / (width / 4), c = (e % (width / 4)) * 4, d = d0 + c;
      const int sl = rowsub[r];
      if (sl < 0 || d >= p.Dc) continue;
      const float* cp = p.ctr + (sub0 + sl) * p.Dc + d;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (d + i < p.Dc) dst[r * ld + c + i] -= __ldg(cp + i);
    }
  };
  // stage q of the ring's sequence: per H chunk j, n1 stages of W1[:, j]
  // (rows of D; with x's slice where x streams), then n2 of W2[j, ftile]
  auto issue = [&](int q) {
    const int j = j0 + q / per, r = q % per;
    float* st = ring + (q & 1) * p.stage;
    if (r < p.n1) {
      copy_tile<kHC>(st, kW1S, p.w1 + (size_t)r * p.dc * p.H + j * kHC,
                     p.H, p.dc, p.D - r * p.dc, min(kHC, p.H - j * kHC),
                     p.w1_vec != 0);
      if (!resident) load_x(st + p.dc * kW1S, kXS, r * kDCS, kDCS);
    } else {
      const int k0 = j * kHC + (r - p.n1) * R2;
      copy_tile<FT>(st, W2S, p.w2 + (size_t)k0 * p.F + f0, p.F, R2,
                    p.H - k0, ft, p.w2_vec != 0);
    }
  };

  float* pool = xs + main_floats(p);                   // FT (n_tiles > 1)
  if (multi)
    for (int e = tid; e < FT; e += kThreads) pool[e] = -kBig;
  if (tid == 0) anyl[0] = 0;
  float acc_y[kMT][NY][4], acc_h[1][kNH][4];
  for (int it = 0; it < p.n_tiles; ++it) {
    __syncthreads();                      // the last tile done with smem
    if (tid < kR) {                       // (subset slot, position) of row
      const int sl = multi ? 0 : tid / p.Kp;
      const int k = multi ? it * kR + tid : tid % p.Kp;
      const bool valid = sl < p.spt && k < p.K && sub0 + sl < p.bs;
      const long long at = (sub0 + sl) * p.K + k;
      rowsub[tid] = valid ? sl : -1;
      xrow[tid] = valid ? (int)at : -1;
      const int lv = valid && (!p.mask || p.mask[at] != 0);
      rowlive[tid] = lv;
      if (lv) anyl[0] = 1;
    }
    __syncthreads();
    if (resident) load_x(xs, p.XD, 0, p.Dp);
    issue(0);
    tf32x3::cp_async_commit();
    zero(acc_y);
    for (int q = 0; q < nq; ++q) {
      tf32x3::cp_async_wait<0>();         // this thread's copies of stage q
      const int j = j0 + q / per, r = q % per;
      float* st = ring + (q & 1) * p.stage;
      if (r < p.n1) {
        if (!resident) center(st + p.dc * kW1S, kXS, r * kDCS, kDCS);
        else if (q == 0) center(xs, p.XD, 0, p.Dp);
      }
      __syncthreads();                    // stage q for all; q - 1's slot free
      if (q + 1 < nq) issue(q + 1);
      tf32x3::cp_async_commit();
      if (r < p.n1) {                     // h_c += x · W1 stage
        if (r == 0) zero(acc_h);
        const float* a = resident ? xs + r * p.dc : st + p.dc * kW1S;
        mma_stage<1, kNH, kWNH, kDCR / 8>(
            acc_h, a, resident ? p.XD : kXS, st, kW1S,
            min(p.dc, p.Dp - r * p.dc) / 8, warp / kWNH, warp % kWNH, lane);
        if (r == p.n1 - 1)                // read after the next barrier
          store_acc<1, kNH, kWNH, true>(hs, kHS, acc_h, p.b1 + j * kHC,
                                        min(kHC, p.H - j * kHC),
                                        warp / kWNH, warp % kWNH, lane);
      } else {                            // y += h_c · W2 stage
#pragma unroll 1                          // one k8 step at a time: no spills
        for (int s = 0; s < R2 / 8; ++s)
          mma_stage<kMT, NY, kWN, 1>(acc_y, hs + (r - p.n1) * R2 + s * 8,
                                     kHS, st + s * 8 * W2S, W2S, 1, wm, wn,
                                     lane);
      }
    }
    tf32x3::cp_async_wait<0>();

    // the epilogue's indices, from special registers read afresh
    const int et = fresh_tid(), el = et & 31;
    const int ewm = (et >> 5) / kWN, ewn = (et >> 5) % kWN;
    const int ef0 = fresh_ctaid<1>() * FT, eft = min(FT, p.F - ef0);
    const long long egrp = fresh_ctaid<0>(), esub0 = egrp * p.spt;
    if (p.part != nullptr) {              // one split of H: raw y rows out
      const int g = el >> 2, t = el & 3;
      float* dst = p.part + ((size_t)fresh_ctaid<2>() * gridDim.x *
                             p.n_tiles + egrp * p.n_tiles + it) *
                            kR * p.FP + ef0;
#pragma unroll
      for (int j = 0; j < NY; ++j) {
        const int c = (ewn + kWN * j) * 8 + 2 * t;
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          const int r0 = (ewm * kMT + mt) * 16 + g;
          const float* v = acc_y[mt][j];
          if (rowsub[r0] >= 0)
            *reinterpret_cast<float2*>(dst + (size_t)r0 * p.FP + c) =
                make_float2(v[0], v[1]);
          if (rowsub[r0 + 8] >= 0)
            *reinterpret_cast<float2*>(dst + (size_t)(r0 + 8) * p.FP + c) =
                make_float2(v[2], v[3]);
        }
      }
      continue;
    }
    // ---- y + b2 over the ring, then a thread a (subset, column) --------
    __syncthreads();                      // every warp done with x, h, ring
    store_acc<kMT, NY, kWN, false>(ys, YS, acc_y, p.b2 + ef0, eft, ewm, ewn,
                                   el);
    __syncthreads();
    for (int e = et; e < p.spt * eft; e += kThreads) {
      const int sl = e / eft, c = e % eft;
      if (p.n_tiles > 1) {
        float m = pool[c];
        const int rows = min(kR, p.K - it * kR);
        for (int r = 0; r < rows; ++r)
          if (rowlive[r]) m = fmaxf(m, ys[r * YS + c]);
        pool[c] = m;
      } else if (esub0 + sl < p.bs) {
        float m = -kBig;
        bool any = false;
        for (int k = 0; k < p.K; ++k) {
          const int r = sl * p.Kp + k;
          if (rowlive[r]) {
            m = fmaxf(m, ys[r * YS + c]);
            any = true;
          }
        }
        p.out[(esub0 + sl) * p.F + ef0 + c] = any ? m : 0.f;
      }
    }
  }
  if (multi && p.part == nullptr) {
    __syncthreads();
    const int ef0 = fresh_ctaid<1>() * FT, eft = min(FT, p.F - ef0);
    const long long esub0 = fresh_ctaid<0>();   // one subset a block
    for (int c = fresh_tid(); c < eft; c += kThreads)
      p.out[esub0 * p.F + ef0 + c] = anyl[0] ? pool[c] : 0.f;
  }
}

// The second pass after a split of H: a thread a (subset, column), the
// parts summed in split order, b2 added, the max over the live rows, 0
// for a subset with none.
__global__ void __launch_bounds__(kThreads)
gather_mlp_wide_pool(const WideParams p, int nsplit, long long groups) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= p.bs * p.F) return;
  const long long sub = e / p.F;
  const int c = (int)(e % p.F);
  const long long grp = sub / p.spt;
  const int sl = (int)(sub % p.spt);
  const size_t split = (size_t)groups * p.n_tiles * kR * p.FP;
  const float bias = __ldg(p.b2 + c);
  float m = -kBig;
  bool any = false;
#pragma unroll 4
  for (int k = 0; k < p.K; ++k) {
    if (p.mask != nullptr && p.mask[sub * p.K + k] == 0) continue;
    const int r = p.n_tiles > 1 ? k % kR : sl * p.Kp + k;
    const float* src =
        p.part + ((size_t)(grp * p.n_tiles + k / kR) * kR + r) * p.FP + c;
    float v = src[0];
    for (int s = 1; s < nsplit; ++s) v += src[s * split];
    m = fmaxf(m, v + bias);
    any = true;
  }
  p.out[sub * p.F + c] = any ? m : 0.f;
}

// How a shape runs on sms SMs: the tiles, the F tiles, the H splits and
// where x lives
struct Plan {
  WideParams p;
  long long groups;        // row-tile groups (grid x)
  int nft, nsplit;         // F tiles (grid y), H splits (grid z)
  size_t smem;
};

size_t smem_bytes(const WideParams& p) {
  return sizeof(float) * ((size_t)kTab + main_floats(p) +
                          (p.n_tiles > 1 ? p.FT : 0));
}

int stride8(int x) { return x + ((8 - x) % 32 + 32) % 32; }  // ≡ 8 mod 32

// floats of a ring stage: W1's rows beside x's slice where x streams, or
// W2's rows, whichever is larger
int stage_floats(int dc, bool resident, int ft) {
  const int w1 = dc * kW1S + (resident ? 0 : kR * kXS);
  const int w2 = rows2(ft) * (ft + 4);
  return w1 > w2 ? w1 : w2;
}

// nsplit: 0 = split H where the blocks would leave SMs idle; n >= 1 =
// split it n ways (H chunks a split rounded up, so the splits that run
// may be fewer)
Plan make_plan(const Params& q, int sms, int nsplit_forced = 0) {
  Plan w{};
  WideParams& p = w.p;
  p = WideParams{q.raw, q.ctr, q.mask, q.w1, q.b1, q.w2, q.b2, q.out,
                 nullptr, q.bs, q.K, q.D, q.Dc, q.H, q.F};
  p.Kp = q.K > 0 ? q.K : 1;
  p.spt = p.Kp <= kR ? kR / p.Kp : 1;
  p.n_tiles = p.Kp <= kR ? 1 : (p.K + kR - 1) / kR;
  p.Dp = q.Dp;
  p.nchunk = (p.H + kHC - 1) / kHC;
  w.nft = (p.F + kMaxFT - 1) / kMaxFT;
  p.FT = ((p.F + w.nft - 1) / w.nft + 63) / 64 * 64;
  p.FP = w.nft * p.FT;
  w.groups = (p.bs + p.spt - 1) / p.spt;
  // H split where the blocks would leave SMs idle
  const long long blocks = w.groups * w.nft;
  long long nsplit = 1;
  if (nsplit_forced > 0) {
    nsplit = nsplit_forced;
  } else if (blocks < sms) {
    nsplit = (sms + blocks - 1) / blocks;
    const long long most = p.nchunk / 2 > 1 ? p.nchunk / 2 : 1;
    if (nsplit > most) nsplit = most;
  }
  p.cps = (int)((p.nchunk + nsplit - 1) / nsplit);
  w.nsplit = (p.nchunk + p.cps - 1) / p.cps;
  p.XD = stride8(p.Dp);                   // x resident where it fits
  p.dc = kDCR;
  p.stage = stage_floats(p.dc, true, p.FT);
  if (smem_bytes(p) > (size_t)kBudget) {
    p.XD = 0;                             // else x streams
    p.dc = kDCS;
    p.stage = stage_floats(p.dc, false, p.FT);
  }
  p.n1 = (p.Dp + p.dc - 1) / p.dc;
  p.x_vec = q.D % 4 == 0 && reinterpret_cast<uintptr_t>(q.raw) % 16 == 0;
  p.w1_vec = q.w1_vec;
  p.w2_vec = q.w2_vec;
  w.smem = smem_bytes(p);
  return w;
}

// Bytes of device scratch a plan's partial y takes (0 with one split)
size_t scratch_bytes(const Plan& w) {
  return w.nsplit > 1 ? sizeof(float) * w.nsplit * w.groups *
                            w.p.n_tiles * kR * w.p.FP
                      : 0;
}

template <int NY>
int launch_ny(const Plan& w, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gather_mlp_wide_kernel<NY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)w.smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)w.groups, w.nft, w.nsplit);
  gather_mlp_wide_kernel<NY><<<grid, kThreads, w.smem, stream>>>(w.p);
  err = cudaGetLastError();
  if (err != cudaSuccess || w.nsplit == 1) return (int)err;
  const long long n = w.p.bs * w.p.F;
  gather_mlp_wide_pool<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads,
                         0, stream>>>(w.p, w.nsplit, w.groups);
  return (int)cudaGetLastError();
}

int launch(Plan w, float* scratch, void* stream) {
  if (w.nsplit > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (w.p.bs * w.p.K >= (1LL << 31))     // raw rows are int in the tables
    return (int)cudaErrorInvalidValue;
  w.p.part = w.nsplit > 1 ? scratch : nullptr;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (w.p.FT / 32) {
    case 2: return launch_ny<2>(w, s);
    case 4: return launch_ny<4>(w, s);
    case 6: return launch_ny<6>(w, s);
    case 8: return launch_ny<8>(w, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace wide

// ---- the linear route: one layer, y = x W + b ----------------------------
// The one-layer point-MLPs (every block of DGCNN, PointNeXt-S and
// PointVector-L, and any block_end MLP, composed into one map) need
// neither relu nor a second product: for each (cloud b, subset s)
//
//     out = max over live k of (x[k] W + b)                    (F,)
//
// with x formed as above.  A GEMM of B·S·K rows, F columns and depth D,
// held to 1e-4 of fp32, so 3xTF32 (tf32x3.cuh's split, three products,
// small ones first).
//
// What bounds it: the product, 2·B·S·K·D·F flops, three TF32 passes at
// the 495 TFLOP/s peak; dgcnn_c block 4 at B = 8 (163,840 rows, D = F =
// 256) is 21.5 GFLOP, 0.130 ms, against 0.056 ms of bytes.  Only wgmma
// reaches that peak, and wgmma takes B from shared memory, K-major only
// for TF32, reading its fp32 bit pattern with the low 13 bits cut off.
// So, in two kernels a call:
//   * split_weights_kernel writes W once into device scratch as two
//     halves, big = rna(W) and small = rna(W - big), each F_pad rows of
//     D_pad (K-major: row n holds column n of W), zero past D and F.
//     Within each 8-group of k, logical k sits at position
//     (k % 2) * 4 + k / 2, so that wgmma's k slots t and t + 4 of a
//     thread's A fragment are x's columns 2t and 2t + 1: one 8-byte load.
//   * gather_mlp_linear_kernel: a work item is a tile of R = 128 rows
//     (two consumer warpgroups, 64 rows each; 64 rows and one where
//     128-row tiles would leave a quarter of the blocks idle) by N output
//     columns, N the whole F up to 256 (so x crosses DRAM once; past 256,
//     F tiles of at most 256, a row group's tiles adjacent in the item
//     order, so the repeated x reads hit L2).  Whole subsets are packed K
//     rows apart (K = 20: 6 to 120 rows); a subset longer than R loops
//     over row tiles with a running max.  One block an SM (two at N = 64)
//     walks the items (persistent), so the ring runs on from one item
//     into the next.  A
//     producer warpgroup fills a ring of 16-deep stages (as many as fit,
//     up to 8) behind full / empty mbarriers: both W halves by TMA (a
//     16 x N box each, 64-byte swizzle); x by TMA where its rows are
//     16-byte multiples (a 24 x R box, so the slice's row stride keeps
//     the A loads free of bank conflicts), else by cp.async (PointNeXt's
//     D = 35 ... 387, DGCNN block 1's 6); the centers by cp.async;
//     zero-filled past the rows and D.  Each consumer loads its A
//     fragments from the x slice, subtracts the centers there, splits
//     big / small in registers and issues, per k8 step, three
//     wgmma.m64nNk8 .tf32 (small·big, big·small, big·big) into N/2 fp32
//     accumulators a thread; the two warpgroups take turns on the tensor
//     cores, so one loads its next fragments while the other's products
//     run.  No block-wide barrier in the loop; a row tile's mask and bias
//     are read a tile ahead.
//   * The epilogue stages y 64 columns at a time in its own buffer (the
//     ring keeps filling meanwhile), and a thread a (subset, column)
//     takes the max over the subset's live rows and adds b once (max(y)
//     + b = max(y + b): rounding is monotone); a subset with no live row
//     gives 0.  out is written directly.
namespace linear {

constexpr int kBK = 16;                  // depth of a ring stage
constexpr int kXS = kBK + 8;             // x slice row stride (float2 A
                                         // loads: 4 rows hit 32 banks)
constexpr int kCS = kBK;                 // centers slice row stride
constexpr int kMaxN = 256;               // output columns a block
constexpr int kTileN = 64;               // N is a multiple of it
constexpr int kYC = 64;                  // y's columns staged at a time
constexpr int kYS = kYC + 8;             // y's row stride (≡ 8 mod 32)
constexpr int kMaxStages = 8;
constexpr int kCenterThreads = 32;       // producers of the centers where
                                         // x goes by TMA
constexpr bool kXByTma = true;           // x by TMA where D % 4 == 0

struct LinParams {
  const float* raw;
  const float* ctr;
  const uint8_t* mask;
  const float* b;
  float* out;
  long long bs;            // B * S subsets
  long long rows;          // B * S * K rows of raw
  int K, D, Dc, F;
  int spt, n_tiles;        // subsets a tile (1 where K > R), tiles a subset
  int nft, items;          // F tiles, row-tile groups x F tiles
  int nk;                  // ring stages over D
  int stages, stage_bytes;
  int x_tma, x_vec, c_vec; // x by TMA; 16-byte copies of x, of the centers
};

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// bytes of a ring stage: both W halves (N rows of 64 bytes each), the x
// slice, the spt centers' slice
__host__ __device__ constexpr int stage_bytes(int R, int N, int spt) {
  return round_up(2 * N * kBK * 4 + R * kXS * 4 + spt * kCS * 4, 1024);
}

// bytes after the ring: y's staging (R x kYS), the barriers (full and
// empty a stage), the live rows (one a consumer thread, 2R), the running
// max and its live flags, the tile's bias (kMaxN: one a consumer thread
// and column)
__host__ __device__ constexpr int tail_bytes(int R, int N) {
  return R * kYS * 4 + 8 * 2 * kMaxStages + 8 * R + 8 * N + 4 * kMaxN;
}

// Blocks an SM by the columns a block takes: two at N = 64, where a
// tile's products are short and a second block hides one's epilogue and
// latencies; else one (shared memory allows no more).
__host__ __device__ constexpr int blocks_per_sm(int N) {
  return N <= kTileN ? 2 : 1;
}

// The setmaxnreg split of the registers between the producer and the
// two consumer warpgroups: 40 + 2 x 96 of 3 x 80 at two blocks of 384
// threads an SM (N = 64), 56 + 2 x 224 of 3 x 168 at one.  One consumer
// keeps what it has (a block of 256 threads).
template <int N>
struct Regs {
  static constexpr int kProducer = blocks_per_sm(N) == 2 ? 40 : 56;
  static constexpr int kConsumer = blocks_per_sm(N) == 2 ? 96 : 224;
};

// a block's shared-memory budget: a block's limit, or half an SM's less
// its reserved 1 KB at two blocks an SM
__host__ __device__ constexpr int smem_budget(int N) {
  return blocks_per_sm(N) == 2 ? kSmemSM / 2 - 1024 : kMaxSmem;
}

// stages of the ring: as many as fit the budget, at most kMaxStages
__host__ __device__ constexpr int ring_stages(int R, int N, int spt) {
  return (smem_budget(N) - 1024 - tail_bytes(R, N)) /
                     stage_bytes(R, N, spt) < kMaxStages
             ? (smem_budget(N) - 1024 - tail_bytes(R, N)) /
                   stage_bytes(R, N, spt)
             : kMaxStages;
}

// F tiles and the columns a block takes: F in ceil(F / 256) tiles, each
// rounded up to a multiple of 64
int f_tiles(int F) { return (F + kMaxN - 1) / kMaxN; }
int cols(int F) {
  const int nft = f_tiles(F);
  return round_up((F + nft - 1) / nft, kTileN);
}

// Subsets a tile of R rows
int subsets(int K, int R) { return K <= R ? R / (K > 0 ? K : 1) : 1; }

size_t smem_bytes(int R, int N, int spt) {
  return 1024 + ring_stages(R, N, spt) * stage_bytes(R, N, spt) +
         tail_bytes(R, N);
}

// W's halves: each F_pad = F tiles x N rows of D_pad = D to 16
size_t scratch_bytes(int D, int F) {
  return 2 * sizeof(float) * (size_t)f_tiles(F) * cols(F) *
         round_up(D, kBK);
}

// W (D x F, row-major) into its halves at out (two F_pad x D_pad blocks,
// big then small), a 32 x 32 tile a block through shared memory
// (tf32_split.cuh, which hub_reuse.cu's one-layer route shares)
__global__ void __launch_bounds__(tf32_split::kThreads)
split_weights_kernel(const float* __restrict__ w, float* __restrict__ out,
                     int D, int F, int Dp, int Fp) {
  tf32_split::split_tile(w, out, D, F, Dp, Fp);
}

int split_weights(const float* w, float* out, int D, int F,
                  cudaStream_t stream) {
  const int Dp = round_up(D, kBK), Fp = f_tiles(F) * cols(F);
  split_weights_kernel<<<tf32_split::grid(Dp, Fp), tf32_split::kThreads, 0,
                         stream>>>(w, out, D, F, Dp, Fp);
  return (int)cudaGetLastError();
}

// ties the fragments' definitions to this point (no instruction)
__device__ __forceinline__ void fence_frags(tf32x3::Frag<4> (&af)[kBK / 8]) {
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      asm volatile("" : "+r"(af[j].big[i]), "+r"(af[j].small[i])::"memory");
}

// Consumer warpgroups 0 .. NC - 1 take 64 rows each of the R = 64 NC row
// tile; warpgroup NC is the producer.
template <int NC, int N>
__global__ void __launch_bounds__(128 * (NC + 1), blocks_per_sm(N))
gather_mlp_linear_kernel(const __grid_constant__ CUtensorMap wmap,
                         const __grid_constant__ CUtensorMap xmap,
                         const LinParams p) {
  constexpr int R = 64 * NC, kCons = 128 * NC;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int S = p.stages, ST = p.stage_bytes;
  float* ys = reinterpret_cast<float*>(smem + S * ST);     // R x kYS
  uint64_t* full = reinterpret_cast<uint64_t*>(ys + R * kYS);
  uint64_t* empty = full + kMaxStages;
  int* rowlive = reinterpret_cast<int*>(empty + kMaxStages);  // kCons
  float* pool = reinterpret_cast<float*>(rowlive + kCons);    // N
  int* pany = reinterpret_cast<int*>(pool + N);               // N
  float* bsm = reinterpret_cast<float*>(pany + N);            // kMaxN: b
  const bool multi = p.n_tiles > 1;       // one subset over several tiles
  const int Kp = p.K > 0 ? p.K : 1;
  // the producer threads that copy: all where x goes by cp.async, else
  // the centers' (thread 0 also issues the TMA copies)
  const int copiers = p.x_tma ? kCenterThreads : 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(full + s, copiers + 1);  // their copies, the TMA
      sm90::mbar_init(empty + s, 4 * NC);      // a consumer warp each
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kCons) {
    // ---- producer: W (and x) by TMA, x or the centers by cp.async ------
    if constexpr (NC == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(
          Regs<N>::kProducer));
    const int pt = threadIdx.x - kCons;
    if (pt >= copiers) return;
    const int tx = 2 * N * kBK * 4 + (p.x_tma ? R * kXS * 4 : 0);
    int qg = 0;
    for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
      const long long sub0 = (long long)(item / p.nft) * p.spt;
      const int f0 = (item % p.nft) * N;
      for (int it = 0; it < p.n_tiles; ++it) {
        const long long row0 = sub0 * p.K + (multi ? (long long)it * R : 0);
        // rows of the tile that hold its subsets' points (the rest zero)
        const long long left = multi ? p.K - (long long)it * R
                                     : min((long long)p.spt, p.bs - sub0) *
                                           p.K;
        const int nrows = (int)min((long long)R, left);
        for (int q = 0; q < p.nk; ++q, ++qg) {
          const int s = qg % S;
          sm90::mbar_wait(empty + s, ((qg / S) & 1) ^ 1);
          uint8_t* st = smem + s * ST;
          float* xs = reinterpret_cast<float*>(st + 2 * N * kBK * 4);
          float* cs = xs + R * kXS;
          const int d0 = q * kBK;
          if (pt == 0) {
            sm90::mbar_expect_tx(full + s, tx);
            sm90::tma_load(st, &wmap, full + s, d0, f0, 0);
            sm90::tma_load(st + N * kBK * 4, &wmap, full + s, d0, f0, 1);
            if (p.x_tma)
              sm90_tf32::tma_load_2d(xs, &xmap, full + s, d0, (int)row0);
          }
          if (!p.x_tma) {
            for (int e = pt; e < R * (kBK / 4); e += 128) {
              const int r = e / (kBK / 4), c = (e % (kBK / 4)) * 4;
              const int d = d0 + c;
              float* o = xs + r * kXS + c;
              const float* src = p.raw + (row0 + r) * p.D + d;
              if (p.x_vec) {
                const bool ok = r < nrows && d < p.D;
                sm90_tf32::cp_async16_fill(o, ok ? src : p.raw, ok ? 16 : 0);
              } else {
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  const bool ok = r < nrows && d + i < p.D;
                  sm90_tf32::cp_async4_fill(o + i, ok ? src + i : p.raw,
                                            ok ? 4 : 0);
                }
              }
            }
          }
          if (d0 < p.Dc) {
            for (int e = pt; e < p.spt * (kBK / 4); e += copiers) {
              const int sl = e / (kBK / 4), c = (e % (kBK / 4)) * 4;
              const int d = d0 + c;
              float* o = cs + sl * kCS + c;
              const bool in = sub0 + sl < p.bs;
              const float* src = p.ctr + (sub0 + sl) * p.Dc + d;
              if (p.c_vec) {
                const bool ok = in && d < p.Dc;
                sm90_tf32::cp_async16_fill(o, ok ? src : p.ctr, ok ? 16 : 0);
              } else {
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  const bool ok = in && d + i < p.Dc;
                  sm90_tf32::cp_async4_fill(o + i, ok ? src + i : p.ctr,
                                            ok ? 4 : 0);
                }
              }
            }
          }
          sm90_tf32::cp_async_arrive(full + s);
        }
      }
    }
  } else {
    // ---- consumers: 64 rows each, three products a k8 step -------------
    if constexpr (NC == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(
          Regs<N>::kConsumer));
    const int ct = threadIdx.x, lane = ct & 31;
    const int g = lane >> 2, t = lane & 3;
    const int ra = 16 * (ct >> 5) + g;     // rows ra and ra + 8 of mine
    // this block's row tiles: item blockIdx.x + (j / n_tiles) gridDim.x,
    // row tile j % n_tiles
    const int tiles = (p.items - blockIdx.x + gridDim.x - 1) / gridDim.x *
                      p.n_tiles;
    // row ct's liveness and columns ct, ct + kCons's bias in tile j, read
    // a tile ahead (their loads run under the tile before); without
    // branches (loads from clamped addresses, then selects), so that no
    // compiler-inserted warpgroup arrive lands in a divergent path
    constexpr int kNB = (N + kCons - 1) / kCons;
    auto ahead = [&](int j, int& live, float (&bias)[kNB]) {
      const int item = blockIdx.x + (j / p.n_tiles) * gridDim.x;
      const int it = j % p.n_tiles, f0 = (item % p.nft) * N;
      const long long sub0 = (long long)(item / p.nft) * p.spt;
      const long long row0 = sub0 * p.K + (multi ? (long long)it * R : 0);
      const int sl = multi ? 0 : ct / Kp;
      const int k = multi ? it * R + ct : ct % Kp;
      const int valid = (ct < R) & (sl < p.spt) & (k < p.K) &
                        (sub0 + sl < p.bs);
      int m = 1;
      if (p.mask != nullptr && p.rows > 0)
        m = p.mask[min(row0 + ct, p.rows - 1)] != 0;
      live = valid & m;
#pragma unroll
      for (int i = 0; i < kNB; ++i) {
        const int c = f0 + ct + i * kCons;
        const float v = __ldg(p.b + min(c, p.F - 1));
        bias[i] = (ct + i * kCons < N) & (c < p.F) ? v : 0.f;
      }
    };
    float acc[N / 2];
    int qg = 0, live_next = 0;
    float bias_next[kNB] = {};
    if (tiles > 0) ahead(0, live_next, bias_next);
    for (int j = 0; j < tiles; ++j) {
      const int item = blockIdx.x + (j / p.n_tiles) * gridDim.x;
      const int it = j % p.n_tiles;
      const long long sub0 = (long long)(item / p.nft) * p.spt;
      const int f0 = (item % p.nft) * N, ft = min(N, p.F - f0);
      const int live = live_next;
      float bias[kNB];
#pragma unroll
      for (int i = 0; i < kNB; ++i) bias[i] = bias_next[i];
      if (j + 1 < tiles) ahead(j + 1, live_next, bias_next);
      if (multi && it == 0) {
        for (int c = ct; c < N; c += kCons) pool[c] = -kBig, pany[c] = 0;
      }
      // the centers' slots of rows ra and ra + 8 (the last slot for a
      // row past the subsets: its y is never pooled)
      const int s0 = multi ? 0 : min(ra / Kp, p.spt - 1);
      const int s1 = multi ? 0 : min((ra + 8) / Kp, p.spt - 1);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
      for (int q = 0; q < p.nk; ++q, ++qg) {
        const int s = qg % S;
        const uint8_t* st = smem + s * ST;
        const float* xs = reinterpret_cast<const float*>(st + 2 * N * kBK * 4);
        const float* cs = xs + R * kXS;
        const bool centered = q * kBK < p.Dc;  // the slice holds center lanes
        sm90::mbar_wait(full + s, (qg / S) & 1);
        // both k8 steps, past D too (x, the centers and W are zero there):
        // no branch between the fence and the products, where ptxas would
        // add a warpgroup arrive and serialize them
        tf32x3::Frag<4> af[kBK / 8];
#pragma unroll
        for (int k8 = 0; k8 < kBK / 8; ++k8) {
          const float* px = xs + ra * kXS + 8 * k8 + 2 * t;
          float2 lo = *reinterpret_cast<const float2*>(px);
          float2 hi = *reinterpret_cast<const float2*>(px + 8 * kXS);
          if (centered) {
            const float2 c0 = *reinterpret_cast<const float2*>(
                cs + s0 * kCS + 8 * k8 + 2 * t);
            const float2 c1 = *reinterpret_cast<const float2*>(
                cs + s1 * kCS + 8 * k8 + 2 * t);
            lo.x -= c0.x, lo.y -= c0.y, hi.x -= c1.x, hi.y -= c1.y;
          }
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

      // ---- y 64 columns at a time, a thread a (subset, column) ---------
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
        if (cc == 0) {                    // no branch on ct (see ahead)
          rowlive[ct] = live;
#pragma unroll
          for (int i = 0; i < kNB; ++i) bsm[ct + i * kCons] = bias[i];
        }
        sm90_tf32::named_sync(1, kCons);
        const int nc = min(kYC, ft - cc * kYC), c0 = cc * kYC;
        // the max over rows r0 .. r0 + n of column c, live rows only
        // (loads unconditional: every staged row is finite)
        auto pooled = [&](int r0, int n, int c, float& m, int& any) {
#pragma unroll 4
          for (int r = r0; r < r0 + n; ++r) {
            const float v = ys[r * kYS + c];
            const int lv = rowlive[r];
            m = lv ? fmaxf(m, v) : m;
            any |= lv;
          }
        };
        if (multi) {                      // a running max across tiles
          const int rows = min(R, p.K - it * R);
          for (int c = ct; c < nc; c += kCons) {
            float m = pool[c0 + c];
            int any = pany[c0 + c];
            pooled(0, rows, c, m, any);
            pool[c0 + c] = m;
            pany[c0 + c] = any;
          }
        } else {
          for (int e = ct; e < p.spt * nc; e += kCons) {
            const int sl = e / nc, c = e % nc;
            if (sub0 + sl >= p.bs) continue;
            float m = -kBig;
            int any = 0;
            pooled(sl * Kp, p.K, c, m, any);
            p.out[(sub0 + sl) * p.F + f0 + c0 + c] =
                any ? m + bsm[c0 + c] : 0.f;
          }
        }
        sm90_tf32::named_sync(1, kCons);  // y and the tables read
      }
      if (multi && it == p.n_tiles - 1) {
        for (int c = ct; c < ft; c += kCons)
          p.out[sub0 * p.F + f0 + c] = pany[c] ? pool[c] + bsm[c] : 0.f;
        sm90_tf32::named_sync(1, kCons);  // the pool and bias read
      }
    }
  }
}

// The heuristic's rows per tile: 64 where 128-row tiles times the F tiles
// would give fewer items than 3/4 of the persistent grid's blocks, else
// 128 (on an H100, 128 rows won at 128 and 256 items, 64 at 32, 48 and
// 64, against the other tile in the same turns)
int row_tile(long long bs, int K, int F, int sms) {
  const long long items = (bs + subsets(K, 128) - 1) / subsets(K, 128) *
                          f_tiles(F);
  return 4 * items < 3LL * blocks_per_sm(cols(F)) * sms ? 64 : 128;
}

// Whether x goes by TMA: the policy, and a row stride of 16-byte
// multiples (raw's alignment is checked at the launch)
bool x_by_tma(int D) { return kXByTma && D % 4 == 0; }

LinParams make(const float* raw, const float* ctr, const uint8_t* mask,
               const float* b, float* out, long long bs, int K, int D,
               int Dc, int F, int R) {
  LinParams p{raw, ctr, mask, b, out, bs, bs * K, K, D, Dc, F};
  const int N = cols(F);
  p.spt = subsets(K, R);
  p.n_tiles = K <= R ? 1 : (K + R - 1) / R;
  p.nft = f_tiles(F);
  p.items = (int)((bs + p.spt - 1) / p.spt * p.nft);
  p.nk = (D + kBK - 1) / kBK;
  p.stages = ring_stages(R, N, p.spt);
  p.stage_bytes = stage_bytes(R, N, p.spt);
  p.x_tma = x_by_tma(D) && reinterpret_cast<uintptr_t>(raw) % 16 == 0;
  p.x_vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(raw) % 16 == 0;
  p.c_vec = Dc % 4 == 0 && reinterpret_cast<uintptr_t>(ctr) % 16 == 0;
  return p;
}

template <int NC, int N>
int launch_tile(const LinParams& p, const CUtensorMap& wmap,
                const CUtensorMap& xmap, cudaStream_t stream) {
  constexpr int R = 64 * NC;
  const size_t smem = smem_bytes(R, N, p.spt);
  cudaError_t err = cudaFuncSetAttribute(
      gather_mlp_linear_kernel<NC, N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = min(p.items, blocks_per_sm(N) * sm_count());
  gather_mlp_linear_kernel<NC, N><<<grid, 128 * (NC + 1), smem, stream>>>(
      wmap, xmap, p);
  return (int)cudaGetLastError();
}

template <int NC>
int launch_cols(const LinParams& p, const CUtensorMap& wmap,
                const CUtensorMap& xmap, cudaStream_t stream) {
  switch (cols(p.F)) {
    case 64: return launch_tile<NC, 64>(p, wmap, xmap, stream);
    case 128: return launch_tile<NC, 128>(p, wmap, xmap, stream);
    case 192: return launch_tile<NC, 192>(p, wmap, xmap, stream);
    case 256: return launch_tile<NC, 256>(p, wmap, xmap, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// W split into scratch (scratch_bytes(D, F)), then the product
int launch(const LinParams& p, const float* w, float* scratch, int R,
           void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  // the rows and the items are TMA coordinates and a grid's ints
  if (scratch == nullptr || p.rows >= (1LL << 31) ||
      (p.bs + p.spt - 1) / p.spt * p.nft >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (p.items == 0) return 0;
  const int N = cols(p.F);
  const int Dp = round_up(p.D, kBK), Fp = p.nft * N;
  CUtensorMap wmap, xmap;
  if (!sm90_tf32::make_weight_map(&wmap, scratch, Dp, Fp, N))
    return (int)cudaErrorInvalidValue;
  memset(&xmap, 0, sizeof(xmap));
  if (p.x_tma && !sm90_tf32::make_rows_map(&xmap, p.raw, p.D, p.rows, kXS,
                                           R))
    return (int)cudaErrorInvalidValue;
  const int code = split_weights(w, scratch, p.D, p.F, s);
  if (code) return code;
  return R == 128 ? launch_cols<2>(p, wmap, xmap, s)
                  : launch_cols<1>(p, wmap, xmap, s);
}

}  // namespace linear

// The shape fields of p from K, D and H: K padded to 16, D and H to 8,
// and the x/h row stride
void set_shape(Params& p) {
  p.Kp = padded_k(p.K);
  p.Dp = (p.D + 7) & ~7;
  p.Hp = (p.H + 7) & ~7;
  const int xh = p.Dp > p.Hp ? p.Dp : p.Hp;
  p.XH = xh + ((8 - xh) % 32 + 32) % 32;     // ≡ 8 mod 32: no bank conflicts
}

// The narrow route takes a shape whose 64-row tile fits shared memory
bool narrow_fits(const Params& p) {
  constexpr int small = Layout<2>::kR;
  return smem_bytes(small, p, p.Kp <= small ? small / p.Kp : 1) <=
         kMaxSmem;
}

}  // namespace

// Rows per tile for B·S subsets of K points: 64 when 128-row tiles would
// give fewer than two blocks an SM, else 128.
extern "C" int gather_mlp_row_tile(int B, int S, int K) {
  constexpr int big = Layout<4>::kR, small = Layout<2>::kR;
  const long long rows = (long long)B * S * padded_k(K);
  return rows / big < (long long)kBlocksPerSM * sm_count() ? small : big;
}

namespace {

// The shape of a call, as both routes take it
Params make_params(const float* raw, const float* ctr, const uint8_t* mask,
                   const float* w1, const float* b1, const float* w2,
                   const float* b2, float* out, int B, int S, int K, int D,
                   int Dc, int H, int F) {
  Params p{raw, ctr, mask, w1, b1, w2, b2, out, (long long)B * S,
           K, D, Dc, H, F};
  set_shape(p);
  p.w1_vec = H % 4 == 0 && reinterpret_cast<uintptr_t>(w1) % 16 == 0;
  p.w2_vec = F % 4 == 0 && reinterpret_cast<uintptr_t>(w2) % 16 == 0;
  return p;
}

}  // namespace

namespace {

// How a call launches under the knobs: rows (0 = the heuristic; 64 or 128
// force the narrow or the linear route's row tile) and nsplit (0 =
// make_plan's; 1 to the number of 32-column H chunks force the wide
// route's H split).  Each knob acts on its own routes and is ignored on
// the others.  Returns 0, or an error for a knob out of range and, where
// strict, for a forced narrow row tile whose shared memory overflows a
// block's (the heuristic drops 128 rows to 64 there instead).  l.smem is
// the launch's shared memory either way.
enum Route { kNarrow = 0, kWide = 1, kLinear = 2 };

struct Launch {
  int route;               // Route
  int R;                   // rows per tile (narrow, linear)
  wide::Plan w;            // (wide)
  size_t smem;             // bytes a block
};

int route_of(const Params& p) {
  return p.H == 0 ? kLinear : narrow_fits(p) ? kNarrow : kWide;
}

int plan_launch(Params& p, int B, int S, int rows, int nsplit, bool strict,
                Launch& l) {
  constexpr int big = Layout<4>::kR, small = Layout<2>::kR;
  if ((rows != 0 && rows != small && rows != big) || nsplit < 0)
    return (int)cudaErrorInvalidValue;
  l.route = route_of(p);
  if (l.route == kLinear) {
    l.R = rows ? rows : linear::row_tile(p.bs, p.K, p.F, sm_count());
    l.smem = linear::smem_bytes(l.R, linear::cols(p.F),
                                linear::subsets(p.K, l.R));
    return 0;
  }
  if (l.route == kWide) {
    if (nsplit > (p.H + wide::kHC - 1) / wide::kHC)
      return (int)cudaErrorInvalidValue;
    l.w = wide::make_plan(p, sm_count(), nsplit);
    l.smem = l.w.smem;
    return 0;
  }
  int R = rows ? rows : gather_mlp_row_tile(B, S, p.K);
  if (smem_bytes(R, p, p.Kp <= R ? R / p.Kp : 1) > (size_t)kMaxSmem) {
    if (rows == 0) R = small;              // the heuristic's drop
    else if (strict) return (int)cudaErrorInvalidConfiguration;
  }
  p.spt = p.Kp <= R ? R / p.Kp : 1;
  l.R = R;
  l.smem = smem_bytes(R, p, p.spt);
  return 0;
}

}  // namespace

// H = 0 means one layer: y = x w1 + b1, F = w1's columns, w2 and b2
// unused (the linear route).  scratch: gather_mlp_scratch_bytes of device
// memory (the wide route's partial y where it splits H, the linear
// route's split W; null where that is 0); rows and nsplit as plan_launch
// takes them (0, 0 = the heuristic's launch)
extern "C" int gather_mlp_forward(const float* raw, const float* ctr,
                                  const uint8_t* mask, const float* w1,
                                  const float* b1, const float* w2,
                                  const float* b2, float* out, float* scratch,
                                  int B, int S, int K, int D, int Dc, int H,
                                  int F, int rows, int nsplit, void* stream) {
  Params p = make_params(raw, ctr, mask, w1, b1, w2, b2, out, B, S, K, D,
                         Dc, H, F);
  Launch l;
  const int code = plan_launch(p, B, S, rows, nsplit, true, l);
  if (code) return code;
  if (l.route == kLinear) {
    const linear::LinParams q = linear::make(raw, ctr, mask, b1, out, p.bs,
                                             K, D, Dc, F, l.R);
    return linear::launch(q, w1, scratch, l.R, stream);
  }
  if (l.route == kWide) return wide::launch(l.w, scratch, stream);
  const long long grid = (p.bs + p.spt - 1) / p.spt;
  return l.R == Layout<4>::kR
             ? launch<Layout<4>>(p, l.smem, grid, stream)
             : launch<Layout<2>>(p, l.smem, grid, stream);
}

// The route a shape takes: 0 the narrow one (h whole), 1 the wide one (y
// in registers, h in chunks), 2 the linear one (H = 0: one layer).  Every
// shape has one.
extern "C" int gather_mlp_route(int K, int D, int Dc, int H, int F) {
  const Params p = make_params(nullptr, nullptr, nullptr, nullptr, nullptr,
                               nullptr, nullptr, nullptr, 1, 1, K, D, Dc, H,
                               F);
  return route_of(p);
}

// Bytes of shared memory a block of the call takes under the knobs (a
// forced row tile's even where it overflows); -1 for a knob out of range
extern "C" long long gather_mlp_smem_bytes(int B, int S, int K, int D,
                                           int Dc, int H, int F, int rows,
                                           int nsplit) {
  Params p = make_params(nullptr, nullptr, nullptr, nullptr, nullptr,
                         nullptr, nullptr, nullptr, B, S, K, D, Dc, H, F);
  Launch l;
  if (plan_launch(p, B, S, rows, nsplit, false, l)) return -1;
  return (long long)l.smem;
}

// Rows per tile the narrow or the linear route takes under the knob rows
// (64 or 128; the heuristic's where rows is 0); 0 where the call takes the
// wide route, -1 where the knobs are out of range or a forced narrow tile
// overflows
extern "C" int gather_mlp_rows(int B, int S, int K, int D, int Dc, int H,
                               int F, int rows) {
  Params p = make_params(nullptr, nullptr, nullptr, nullptr, nullptr,
                         nullptr, nullptr, nullptr, B, S, K, D, Dc, H, F);
  Launch l;
  if (plan_launch(p, B, S, rows, 0, true, l)) return -1;
  return l.route == kWide ? 0 : l.R;
}

// Bytes of device scratch gather_mlp_forward needs for the call
extern "C" long long gather_mlp_scratch_bytes(int B, int S, int K, int D,
                                              int Dc, int H, int F,
                                              int nsplit) {
  Params p = make_params(nullptr, nullptr, nullptr, nullptr, nullptr,
                         nullptr, nullptr, nullptr, B, S, K, D, Dc, H, F);
  Launch l;
  if (plan_launch(p, B, S, 0, nsplit, true, l)) return 0;
  if (l.route == kLinear) return (long long)linear::scratch_bytes(D, F);
  return l.route == kWide ? (long long)wide::scratch_bytes(l.w) : 0;
}

// The linear route's split of W (D x F) into out (scratch_bytes of the
// call: two F_pad x D_pad halves, big then small, K-major, k permuted
// within 8-groups), alone: the first of the route's two kernels
extern "C" int gather_mlp_split_weights(const float* w, float* out, int D,
                                        int F, void* stream) {
  return linear::split_weights(w, out, D, F, (cudaStream_t)stream);
}

// The linear route's plan for a call on the current device under the
// knob rows (0 = the heuristic's), into out[10]: rows a tile, subsets a
// tile, row tiles a subset, row-tile groups, F tiles, output columns a
// block, ring stages, x by TMA (1, where raw is 16-byte aligned) or
// cp.async (0), shared memory bytes, scratch bytes; out[0] = -1 where the
// call takes another route or rows is out of range
extern "C" void gather_mlp_linear_plan(int B, int S, int K, int D, int Dc,
                                       int F, int rows, long long* out) {
  Params p = make_params(nullptr, nullptr, nullptr, nullptr, nullptr,
                         nullptr, nullptr, nullptr, B, S, K, D, Dc, 0, F);
  Launch l;
  if (plan_launch(p, B, S, rows, 0, true, l) || l.route != kLinear) {
    out[0] = -1;
    return;
  }
  const int spt = linear::subsets(K, l.R);
  const long long v[10] = {
      l.R, spt, K <= l.R ? 1 : (K + l.R - 1) / l.R,
      (p.bs + spt - 1) / spt, linear::f_tiles(F), linear::cols(F),
      linear::ring_stages(l.R, linear::cols(F), spt), linear::x_by_tma(D),
      (long long)l.smem, (long long)linear::scratch_bytes(D, F)};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
}

// The wide route's plan for a call on the current device under the knob
// nsplit, into out[8]: x resident (1) or streamed (0), output columns a
// block, F tiles, H splits, H chunks a split, subsets a tile, row-tile
// groups, shared memory bytes; out[0] = -1 where the call takes another
// route or nsplit is out of range
extern "C" void gather_mlp_wide_plan(int B, int S, int K, int D, int Dc,
                                     int H, int F, int nsplit,
                                     long long* out) {
  Params p = make_params(nullptr, nullptr, nullptr, nullptr, nullptr,
                         nullptr, nullptr, nullptr, B, S, K, D, Dc, H, F);
  Launch l;
  if (plan_launch(p, B, S, 0, nsplit, true, l) || l.route != kWide) {
    out[0] = -1;
    return;
  }
  const wide::Plan& w = l.w;
  const long long v[8] = {w.p.XD > 0, w.p.FT, w.nft, w.nsplit, w.p.cps,
                          w.p.spt, w.groups, (long long)w.smem};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
}

extern "C" const char* gather_mlp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
