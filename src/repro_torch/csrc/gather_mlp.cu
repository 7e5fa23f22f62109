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
// below), which holds h in 64-column chunks.
#include <cuda_runtime.h>
#include <stdint.h>

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

// ---- the wide route: h in 64-column chunks ---------------------------------
// Where a 64-row tile's x and whole h overflow a block's shared memory
// (the widest blocks of dgcnn_c, pointnext_s and pointvector_l, whose
// one-layer MLPs two_layer_form turns into Hd = 2F), the kernel below
// holds x whole and h a chunk at a time, as hub_reuse does: for each 64
// columns c of H, h_c = relu(x W1[:, c] + b1[c]) goes to shared memory and
// at once into y += h_c W2[c, ftile], which stays in registers.  A block
// takes one 64-row tile of whole subsets and 64 output features (grid:
// row tiles x ceil(F / 64)), so each F tile recomputes the first layer.
// W1 and W2 stream through one three-stage cp.async ring of 64 x 64
// tiles.  Products in 3xTF32 as above; the pool is the narrow route's:
// dead rows at -3.4e38, shuffles within each m16 tile, a running max per
// subset in shared memory, 0 for a subset with no live row.
//
// What bounds it: the products again.  dgcnn_c block 4 at B = 8 (S=1024
// K=20 D=256 Hd=512 F=256) is 85.9 GFLOP in fp32, 0.52 ms at the TF32
// peak in three passes; the pointnext_s and pointvector_l blocks at B = 2
// are 3.2 to 7.3 GFLOP, 0.020 to 0.044 ms.  This first version spends
// 1.7 to 4.7 times that work (layer 1 once per F tile), with one block an
// SM (x alone is 100 KB at D = 387).
namespace wide {

constexpr int kR = 64;                   // rows per tile: 8 warps as 2 x 4
constexpr int kWN = 4;                   // warps along columns
constexpr int kNC = 64;                  // Hd chunk, output features a block
constexpr int kKC = 64;                  // rows of W per ring stage
constexpr int kStages = 3;               // ring depth
constexpr int kWS = kNC + 4;             // stage row stride (≡ 4 mod 16)
constexpr int kHS = kNC + 8;             // h row stride (≡ 8 mod 32)
constexpr int kNT = kNC / (8 * kWN);     // n8 tiles per warp

struct WideParams {
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
  int Kp, Dp, XD;          // K to 16, D to 8, the x row stride
  int spt;                 // subsets per row tile (1 when Kp > kR)
  int n1, nchunk;          // W1 stages per Hd chunk, Hd chunks
  int w1_vec, w2_vec;      // 16-byte copies of W rows allowed
};

// Rows [k0, k0 + kKC) by columns [c0, c0 + kNC) of the row-major kdim x
// ncols matrix w into a stage; rows past kdim and columns past c0 + nc
// are zero.
__device__ __forceinline__ void stage_tile(float* st, const float* w,
                                           int kdim, int ncols, int k0,
                                           int c0, int nc, bool vec) {
  constexpr int kQuads = kKC * kNC / 4;  // 16-byte pieces of a stage
  for (int e = threadIdx.x; e < kQuads; e += kThreads) {
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
// (rows of D), then one stage of W2[j, ftile] (the chunk's 64 rows).
__device__ __forceinline__ void issue(float* ws, const WideParams& p, int q,
                                      int f0, int ft) {
  const int per = p.n1 + 1, j = q / per, r = q % per;
  float* st = ws + (q % kStages) * kKC * kWS;
  if (r < p.n1)
    stage_tile(st, p.w1, p.D, p.H, r * kKC, j * kNC, min(kNC, p.H - j * kNC),
               p.w1_vec != 0);
  else
    stage_tile(st, p.w2, p.H, p.F, j * kNC, f0, ft, p.w2_vec != 0);
}

// acc += a[rows of this warp, k0 : k0 + 8 * steps) · st[0 : 8 * steps, :]
__device__ __forceinline__ void mma_stage(float (&acc)[kMT][kNT][4],
                                          const float* a, int lda, int k0,
                                          const float* st, int steps, int wm,
                                          int wn, int lane) {
#pragma unroll
  for (int s = 0; s < kKC / 8; ++s) {     // fully unrolled: no spills
    if (s >= steps) break;
    Frag<4> af[kMT];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
      af[mt] = tf32x3::load_a(a, lda, (wm * kMT + mt) * 16, k0 + s * 8,
                              lane);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const Frag<2> bf =
          tf32x3::load_b(st, kWS, s * 8, (wn + kWN * j) * 8, lane);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) tf32x3::mma3(acc[mt][j], af[mt], bf);
    }
  }
}

// The h chunk: relu(acc + b1) on the chunk's n columns, 0 past them
__device__ __forceinline__ void store_h(float* hs,
                                       const float (&acc)[kMT][kNT][4],
                                       const float* bias, int n, int wm,
                                       int wn, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int c = (wn + kWN * j) * 8 + 2 * t;
    const float bias0 = c < n ? __ldg(bias + c) : 0.f;
    const float bias1 = c + 1 < n ? __ldg(bias + c + 1) : 0.f;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const float* v = acc[mt][j];
      float* row = hs + ((wm * kMT + mt) * 16 + g) * kHS + c;
      *reinterpret_cast<float2*>(row) =
          make_float2(fmaxf(v[0] + bias0, 0.f), fmaxf(v[1] + bias1, 0.f));
      *reinterpret_cast<float2*>(row + 8 * kHS) =
          make_float2(fmaxf(v[2] + bias0, 0.f), fmaxf(v[3] + bias1, 0.f));
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
gather_mlp_wide_kernel(const WideParams p) {
  extern __shared__ __align__(16) float smem_w[];
  float* xs = smem_w;                                  // kR x XD
  float* hs = xs + kR * p.XD;                          // kR x kHS
  float* ws = hs + kR * kHS;                           // kStages x kKC x kWS
  float* red = ws + kStages * kKC * kWS;               // kR/16 x kNC
  float* pool = red + (kR / 16) * kNC;                 // spt x kNC
  float* cs = pool + p.spt * kNC;                      // spt x Dc
  int* rowlive = reinterpret_cast<int*>(cs + p.spt * p.Dc);  // kR
  int* anyl = rowlive + kR;                            // spt

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / kWN, wn = warp % kWN;
  const int g = lane >> 2, t = lane & 3;
  const int spt = p.spt;
  const bool multi = p.Kp > kR;           // one subset over several tiles
  const int n_tiles = multi ? (p.Kp + kR - 1) / kR : 1;
  const int per_sub = min(p.Kp, kR) / 16; // m16 tiles of a subset in a tile
  const long long sub0 = (long long)blockIdx.x * spt;
  const int f0 = blockIdx.y * kNC, ft = min(kNC, p.F - f0);
  const int per = p.n1 + 1;               // ring stages per Hd chunk
  const int nq = p.nchunk * per;
  // (subset slot, position in the subset) of row r of tile it
  auto row_at = [&](int it, int r, int& sl, int& k) {
    if (multi) {
      sl = 0;
      k = it * kR + r;
    } else {
      sl = r / p.Kp;
      k = r % p.Kp;
    }
    return sl < spt && k < p.K && sub0 + sl < p.bs;
  };

  for (int e = tid; e < spt * kNC; e += kThreads) pool[e] = -kBig;
  for (int e = tid; e < spt; e += kThreads) anyl[e] = 0;
  for (int e = tid; e < spt * p.Dc; e += kThreads)
    cs[e] = sub0 + e / p.Dc < p.bs ? p.ctr[sub0 * p.Dc + e] : 0.f;
  __syncthreads();

  float acc_h[kMT][kNT][4], acc_y[kMT][kNT][4];
  for (int it = 0; it < n_tiles; ++it) {
    // ---- prologue: raw rows by cp.async, the ring's first stages ---------
    for (int r = warp; r < kR; r += kThreads / 32) {
      int sl, k;
      const bool valid = row_at(it, r, sl, k);
      const float* src = p.raw + ((size_t)(sub0 + sl) * p.K + k) * p.D;
      for (int d = lane; d < p.Dp; d += 32) {
        if (valid && d < p.D) tf32x3::cp_async4(xs + r * p.XD + d, src + d);
        else xs[r * p.XD + d] = 0.f;
      }
    }
    tf32x3::cp_async_commit();
    for (int q = 0; q < kStages - 1; ++q) {
      if (q < nq) issue(ws, p, q, f0, ft);
      tf32x3::cp_async_commit();
    }
    for (int r = tid; r < kR; r += kThreads) {
      int sl, k;
      const int lv = row_at(it, r, sl, k) &&
                     (!p.mask || p.mask[(size_t)(sub0 + sl) * p.K + k] != 0);
      rowlive[r] = lv;
      if (lv) anyl[sl] = 1;
    }
    tf32x3::cp_async_wait<kStages - 1>();   // the raw rows
    __syncthreads();
    for (int e = tid; e < kR * p.Dc; e += kThreads) {  // x = raw - ctr
      const int r = e / p.Dc, d = e % p.Dc;
      int sl, k;
      if (row_at(it, r, sl, k)) xs[r * p.XD + d] -= cs[sl * p.Dc + d];
    }

    // ---- h a chunk at a time, y += h_chunk W2 in registers ---------------
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc_y[mt][j][i] = 0.f;
    for (int q = 0; q < nq; ++q) {
      tf32x3::cp_async_wait<kStages - 2>();  // stage q landed
      __syncthreads();                       // for all; slot q - 1 free
      if (q + kStages - 1 < nq) issue(ws, p, q + kStages - 1, f0, ft);
      tf32x3::cp_async_commit();
      const float* st = ws + (q % kStages) * kKC * kWS;
      const int j = q / per, r = q % per;
      if (r < p.n1) {                        // h_chunk += x · W1 stage
        if (r == 0) {
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
            for (int n = 0; n < kNT; ++n)
#pragma unroll
              for (int i = 0; i < 4; ++i) acc_h[mt][n][i] = 0.f;
        }
        mma_stage(acc_h, xs, p.XD, r * kKC, st,
                  min(kKC, p.Dp - r * kKC) / 8, wm, wn, lane);
        if (r == p.n1 - 1)                   // read after the next barrier
          store_h(hs, acc_h, p.b1 + j * kNC, min(kNC, p.H - j * kNC), wm,
                  wn, lane);
      } else {                               // y += h_chunk · W2 stage
        mma_stage(acc_y, hs, kHS, 0, st, kKC / 8, wm, wn, lane);
      }
    }
    tf32x3::cp_async_wait<0>();

    // ---- y + b2 pooled: dead rows -3.4e38, shuffles, then per subset -----
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int c = (wn + kWN * j) * 8 + 2 * t;
      const float bias0 = c < ft ? __ldg(p.b2 + f0 + c) : 0.f;
      const float bias1 = c + 1 < ft ? __ldg(p.b2 + f0 + c + 1) : 0.f;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const float* v = acc_y[mt][j];
        const int r0 = (wm * kMT + mt) * 16 + g;
        const bool l0 = rowlive[r0], l1 = rowlive[r0 + 8];
        float m0 = fmaxf(l0 ? v[0] + bias0 : -kBig, l1 ? v[2] + bias0 : -kBig);
        float m1 = fmaxf(l0 ? v[1] + bias1 : -kBig, l1 ? v[3] + bias1 : -kBig);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
          m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
        }
        if (g == 0) {                  // columns past ft: never read
          red[(wm * kMT + mt) * kNC + c] = m0;
          red[(wm * kMT + mt) * kNC + c + 1] = m1;
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < spt * ft; e += kThreads) {
      const int s = e / ft, c = e % ft;
      float m = pool[s * kNC + c];
      for (int i = 0; i < per_sub; ++i)
        m = fmaxf(m, red[(s * per_sub + i) * kNC + c]);
      pool[s * kNC + c] = m;
    }
    __syncthreads();
  }

  for (int e = tid; e < spt * ft; e += kThreads) {
    const int s = e / ft, c = e % ft;
    if (sub0 + s < p.bs)
      p.out[(sub0 + s) * p.F + f0 + c] = anyl[s] ? pool[s * kNC + c] : 0.f;
  }
}

WideParams make(const Params& q) {
  WideParams p{q.raw, q.ctr, q.mask, q.w1, q.b1, q.w2, q.b2, q.out, q.bs,
               q.K, q.D, q.Dc, q.H, q.F};
  p.Kp = q.Kp;
  p.Dp = q.Dp;
  p.XD = p.Dp + ((8 - p.Dp) % 32 + 32) % 32;  // ≡ 8 mod 32
  p.spt = p.Kp <= kR ? kR / p.Kp : 1;
  p.n1 = (p.Dp + kKC - 1) / kKC;
  p.nchunk = (p.H + kNC - 1) / kNC;
  p.w1_vec = q.w1_vec;
  p.w2_vec = q.w2_vec;
  return p;
}

size_t smem_bytes(const WideParams& p) {
  return sizeof(float) * ((size_t)kR * p.XD + kR * kHS +
                          kStages * kKC * kWS + (kR / 16) * kNC +
                          (size_t)p.spt * (kNC + p.Dc)) +
         sizeof(int) * (kR + p.spt);
}

int launch(const WideParams& p, void* stream) {
  const size_t smem = smem_bytes(p);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gather_mlp_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((p.bs + p.spt - 1) / p.spt),
                  (p.F + kNC - 1) / kNC);
  gather_mlp_wide_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace wide

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

extern "C" int gather_mlp_forward(const float* raw, const float* ctr,
                                  const uint8_t* mask, const float* w1,
                                  const float* b1, const float* w2,
                                  const float* b2, float* out, int B, int S,
                                  int K, int D, int Dc, int H, int F,
                                  void* stream) {
  Params p{raw, ctr, mask, w1, b1, w2, b2, out, (long long)B * S,
           K, D, Dc, H, F};
  set_shape(p);
  p.w1_vec = H % 4 == 0 && reinterpret_cast<uintptr_t>(w1) % 16 == 0;
  p.w2_vec = F % 4 == 0 && reinterpret_cast<uintptr_t>(w2) % 16 == 0;
  if (!narrow_fits(p)) return wide::launch(wide::make(p), stream);
  constexpr int big = Layout<4>::kR, small = Layout<2>::kR;
  int R = gather_mlp_row_tile(B, S, K);
  if (R == big && smem_bytes(big, p, p.Kp <= big ? big / p.Kp : 1) > kMaxSmem)
    R = small;
  p.spt = p.Kp <= R ? R / p.Kp : 1;
  const size_t smem = smem_bytes(R, p, p.spt);
  const long long grid = (p.bs + p.spt - 1) / p.spt;
  return R == big ? launch<Layout<4>>(p, smem, grid, stream)
                  : launch<Layout<2>>(p, smem, grid, stream);
}

// The route a shape takes: 0 the narrow one (h whole), 1 the wide one (h
// in chunks), -1 none (x of a 64-row tile alone overflows shared memory).
extern "C" int gather_mlp_route(int K, int D, int Dc, int H, int F) {
  Params p{};
  p.K = K;
  p.D = D;
  p.Dc = Dc;
  p.H = H;
  p.F = F;
  set_shape(p);
  if (narrow_fits(p)) return 0;
  return wide::smem_bytes(wide::make(p)) <= kMaxSmem ? 1 : -1;
}

extern "C" const char* gather_mlp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
