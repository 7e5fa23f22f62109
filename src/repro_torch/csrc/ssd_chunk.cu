// ssd_chunk: the Mamba-2 SSD intra-chunk block, fp32 on the tensor cores.
//
// Replaces the Pallas TPU kernel ssd_chunk_pallas
// (src/repro/kernels/ssd_chunk/ssd_chunk.py, body _ssd_chunk_kernel): for
// each (batch b, chunk n) with x (q, H, P), B and C (q, S), dt and cum
// (q, H), per head h
//
//     CB[i, j]    = C[i] . B[j]
//     M[i, j]     = CB[i, j] exp(cum[i, h] - cum[j, h]) dt[j, h]   (i >= j)
//     y[i, h, :]  = sum_{j <= i} M[i, j] x[j, h, :]
//     st[h, p, s] = sum_j x[j, h, p] exp(cum[q-1, h] - cum[j, h]) dt[j, h]
//                   B[j, s]
//
// The exponential is taken only where i >= j: above the diagonal cum_i -
// cum_j is positive and can overflow, and inf * 0 would be NaN.  Any q,
// any P and S: q <= 128 (kQMax) on the route below, which keeps the whole
// chunk's C.B^T in shared memory; longer chunks on the tiled route at the
// end of this file.
//
// What bounds it on an H100: at Mamba2-2.7B's widths (H = 80, P = 64,
// S = 128, chunk q = 64, a 2048-token sequence: 32 chunks) the outputs
// alone are 126 MB (y 42 MB, states 84 MB), 0.05 ms at 3.35 TB/s, against
// ~3.4 GFLOP, ~10 GFLOP of TF32 products in 3xTF32: about as long on
// mma.sync.  So the products run on the tensor cores and the loads hide
// under them:
//
// - A block takes one chunk and a group of HG heads (chosen on the host
//   so the grid fills the SMs in whole waves).  C.B^T is built once a
//   block into shared memory (skipping the 32-column groups wholly above
//   the diagonal); each head then runs two products on 8 warps, all in
//   3xTF32 mma.sync m16n8k8 (csrc/tf32x3.cuh: fp32 split into TF32 big
//   and small parts in registers, three products summed in fp32).
// - y = M x: a warp owns two 16-row strips r and n - 1 - r (equal work
//   under the triangle) and a share of P's n8 tiles.  M is never stored:
//   the warp loads C.B^T's A fragments, scales each value by
//   exp(cum_i - cum_j) dt_j or masks it to 0 above the diagonal in
//   registers (the exponential's value dropped, never multiplied by 0),
//   and splits it there; the k steps wholly above the diagonal are
//   skipped.  w_j = exp(cum_end - cum_j) dt_j for the states goes to
//   shared memory once a head.
// - states = (x w)^T B: a warp owns a 32 x 32 tile of the 64 x 128 (P x
//   S) tile, two m16 tiles by four n8 tiles, so each fragment serves
//   more than one product; the A fragments are read from x transposed
//   (row stride = 4 mod 32: no bank conflict) and scaled by w.
// - The next head's x, cum and dt stream into the other half of a double
//   buffer by cp.async, issued after y so the copies queue behind the
//   states' products; y and the states are written from the accumulators
//   as 8-byte pairs (each n8 tile row a whole 32-byte sector).
// - P runs in 64-column tiles and S in 128-column tiles; with S > 128 the
//   B tile is reloaded for each states tile (correct, not tuned).
//
// The tiled route (q > kQMax; Mamba-2's own chunk is 256, where C.B^T
// alone is 256 KB in fp32, past a block's 227 KB) keeps the design above
// and splits the chunk's rows across blocks: one launch, a block of 8
// warps per (chunk, group of HG heads, role r), every product on mma.sync
// in 3xTF32.  Block r takes y of the pair of 64-row strips r and n - 1 - r
// (n = q / 64 strips, so every pair has n + 1 tiles of 64 x 64 under the
// diagonal) and the states of S's 64-column tile r, so the blocks' work
// is even:
//
// - it forms C.B^T of its 128 rows against the columns j <= i once, into
//   shared memory (S in 32-column steps, the strips' C and the window's B
//   staged at once in the copy ring's space);
// - then for each head and P tile it streams x in 64-row j tiles through
//   a cp.async double buffer (the next tile, or the next head's first with
//   its cum and dt, in flight while this one computes).  Warps 0-3 run
//   y_i += M_ij x_j: a warp owns a 16-row strip of each of the two strips
//   by all 64 columns of P, so it forms each of M's fragments once (in
//   registers, from C.B^T and the decay as above) for 8 n8 tiles, and
//   every warp has the same work at every j tile.  Warps 4-7 run states
//   += (x o w)^T B on the same x tile, B's rows of the S tile held and
//   w = exp(cum_end - cum) dt formed once a head into shared memory.
// - Below the diagonal tile (j tile jt < strip s) exp(cum_i - cum_j) =
//   exp(cum_i - cum_e) exp(cum_e - cum_j), e the j tile's last row: both
//   factors at most 1, so neither overflows; the row factors are taken
//   once a step and the column factors (times dt_j) a step ahead by the
//   states warps, which leaves the y warps exponentials a k step on the
//   diagonal tile only.  A row of tiles' 3xTF32 products issues in
//   three waves (tf32x3::mma3_row): a warp issues in order, and mma3's
//   three products on one accumulator each wait out the last (the y
//   warps ran ~1.4x slower so).
// - What holds it (tools/ssd_chunk_variants.py, tiled_timeline, at chunk
//   256): the y warps, ~9K cycles a step against the states warps' ~6.5K.
// - HG is chosen on the host for whole waves on the SMs, as
//   heads_per_block does.  Where a block's strips (or B's rows) pass
//   shared memory (q over ~500), the j tiles go in windows of W: y and the
//   states are written at a window's end and read back at the next one's
//   start by the same thread, so every sum keeps its order.
//
// Rows across blocks, not a cluster of 2 sharing the triangle over
// distributed shared memory: the blocks' strips of C.B^T are disjoint,
// so C.B^T is still formed once a group, with no exchange, no remote read
// and no cluster barrier in the heads' loop; a pair's 86 KB at q = 256
// leaves room for the ring and B's rows.
#include "ssd_tiles.cuh"

namespace {

using namespace ssd;

constexpr int kQMax = 128;            // chunk length
constexpr int kST = 128;              // S tile
constexpr int kLdX = kPT + 4;         // x rows: = 4 mod 32
constexpr int kLdB = kST + 4;         // B rows: = 4 mod 16 (B fragments)
constexpr int kLdC = kST + 8;         // C rows: = 8 mod 32 (A fragments)
constexpr int kMaxSmem = 232448 - 1024;
constexpr int kMaxHeads = 16;

struct Params {
  const float* x;
  const float* B;
  const float* C;
  const float* dt;
  const float* cum;
  float* y;
  float* st;
  int H, Q, P, S;
  int QP;      // Q rounded up to 16
  int ldcb;    // row stride of C.B^T: = 8 mod 32
  int HG;      // heads a block
  int nP, nS;  // P and S tiles
  int vx;      // x rows 16-byte aligned: cp.async of 16 bytes
  int vbc;     // B and C rows 16-byte aligned
  int vy, vst; // y and the states in 8-byte pairs
};

// x of head h, P tile pt, and the head's cum and dt, into one half of the
// double buffer (rows >= Q stay zero)
__device__ __forceinline__ void load_head(const Params& p, long long bn,
                                          int h, int pt, float* xs,
                                          float* cums, float* dts) {
  const int p0 = pt * kPT, w = min(kPT, p.P - p0);
  load_rows(xs, kLdX, p.x + (bn * p.Q * p.H + h) * p.P + p0,
            (long long)p.H * p.P, p.Q, w, p.vx);
  for (int e = threadIdx.x; e < p.Q; e += kThreads) {
    tf32x3::cp_async4(cums + e, p.cum + (bn * p.Q + e) * p.H + h);
    tf32x3::cp_async4(dts + e, p.dt + (bn * p.Q + e) * p.H + h);
  }
}

// S tile sti of B (and of C, for C.B^T) into shared memory; the columns
// past S zeroed when zero_pad (C.B^T sums over them)
__device__ __forceinline__ void load_bc(const Params& p, long long bn,
                                        int sti, float* bs, float* cs,
                                        bool zero_pad) {
  const int s0 = sti * kST, w = min(kST, p.S - s0);
  const long long off = bn * p.Q * p.S + s0;
  load_rows(bs, kLdB, p.B + off, p.S, p.Q, w, p.vbc);
  if (cs) load_rows(cs, kLdC, p.C + off, p.S, p.Q, w, p.vbc);
  if (zero_pad && w < kST) {
    zero_cols(bs, kLdB, p.Q, w, kST);
    if (cs) zero_cols(cs, kLdC, p.Q, w, kST);
  }
}

template <int NT>   // n8 tiles of P a warp owns in y = M x
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int QP = p.QP;
  float* bs = smem;                          // QP x kLdB
  float* cbs = bs + QP * kLdB;               // QP x ldcb
  float* xs = cbs + QP * p.ldcb;             // 2 x QP x kLdX
  float* cs = xs;                            // QP x kLdC, until C.B^T
  float* cums = xs + 2 * QP * kLdX;          // 2 x QP
  float* dts = cums + 2 * QP;                // 2 x QP
  float* ws = dts + 2 * QP;                  // QP: the head's decay to
                                             // the chunk end, w_j
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long bn = blockIdx.x;           // b * nc + n
  const int h0 = blockIdx.y * p.HG, hg = min(p.HG, p.H - h0);
  const int nstrips = QP / 16;

  // rows Q..QP-1 of B and C, and cum and dt past Q, are zero
  if (p.Q < QP) {
    zero_cols(bs + p.Q * kLdB, kLdB, QP - p.Q, 0, kLdB);
    zero_cols(cs + p.Q * kLdC, kLdC, QP - p.Q, 0, kLdC);
  }
  for (int e = threadIdx.x; e < 4 * QP; e += kThreads)
    if (e % QP >= p.Q) cums[e] = 0.f;

  // ---- C.B^T, once a block: items (16-row strip r, 32-column group) ----
  const int ncg = (QP + 31) / 32;
  for (int sti = 0; sti < p.nS; ++sti) {
    if (sti) __syncthreads();   // the last S tile is read
    load_bc(p, bn, sti, bs, cs, true);
    tf32x3::cp_async_commit();
    tf32x3::cp_async_wait<0>();
    __syncthreads();
    for (int it = warp; it < nstrips * ncg; it += kWarps) {
      const int r = it / ncg, c0 = 32 * (it - r * ncg);
      if (c0 > 16 * r + 15) continue;   // wholly above the diagonal
      const int nj = min(4, (QP - c0) / 8);
      float acc[4][4] = {};
#pragma unroll 2
      for (int ks = 0; ks < kST / 8; ++ks) {
        const tf32x3::Frag<4> a =
            tf32x3::load_a<true>(cs, kLdC, 16 * r, 8 * ks, lane);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < nj)
            tf32x3::mma3(acc[j], a,
                         tf32x3::load_bt<true>(bs, kLdB, c0 + 8 * j, 8 * ks,
                                               lane));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= nj) break;
        float* o = cbs + (16 * r + g) * p.ldcb + c0 + 8 * j + 2 * t;
        float2 lo = make_float2(acc[j][0], acc[j][1]);
        float2 hi = make_float2(acc[j][2], acc[j][3]);
        if (sti) {
          const float2 l0 = *reinterpret_cast<float2*>(o);
          const float2 h0v = *reinterpret_cast<float2*>(o + 8 * p.ldcb);
          lo.x += l0.x; lo.y += l0.y; hi.x += h0v.x; hi.y += h0v.y;
        }
        *reinterpret_cast<float2*>(o) = lo;
        *reinterpret_cast<float2*>(o + 8 * p.ldcb) = hi;
      }
    }
  }
  __syncthreads();   // C.B^T built; C's space is x's from here
  if (p.Q < QP) {     // rows Q..QP-1 of both halves: the loads skip them
    zero_cols(xs + p.Q * kLdX, kLdX, QP - p.Q, 0, kLdX);
    zero_cols(xs + (QP + p.Q) * kLdX, kLdX, QP - p.Q, 0, kLdX);
  }

  // ---- per head and P tile: y = M x, then the states over S tiles -----
  const int items = hg * p.nP;
  const int npairs = (nstrips + 1) / 2;
  const int ps = (kPT / 8) / NT;             // P splits of the y product
  const int pr = warp / ps, pq = warp - pr * ps;
  load_head(p, bn, h0, 0, xs, cums, dts);
  tf32x3::cp_async_commit();
  for (int it = 0; it < items; ++it) {
    const int hh = it / p.nP, pt = it - hh * p.nP, h = h0 + hh;
    const int buf = it & 1, p0 = pt * kPT;
    const float* xb = xs + buf * QP * kLdX;
    const float* cum = cums + buf * QP;
    const float* dt = dts + buf * QP;
    tf32x3::cp_async_wait<0>();
    __syncthreads();   // this item's x landed; the last item is done (the
                       // other half of the buffer is free from here)

    // once a head: w_j = exp(cum_end - cum_j) dt_j for the states
    if (pt == 0) {
      const float cend = cum[p.Q - 1];
      for (int j = threadIdx.x; j < QP; j += kThreads)
        ws[j] = j < p.Q ? __expf(cend - cum[j]) * dt[j] : 0.f;
      __syncthreads();
    }

    // y = M x: strips pr and nstrips - 1 - pr, n8 tiles pq*NT.. of P
    if (pr < npairs) {
      for (int side = 0; side < 2; ++side) {
        const int r = side ? nstrips - 1 - pr : pr;
        if (side && r == pr) break;
        const int i0 = 16 * r + g, i1 = i0 + 8;
        const float ci0 = cum[i0], ci1 = cum[i1];
        float acc[NT][4] = {};
        for (int ks = 0; ks < 2 * r + 2; ++ks) {
          const int j0 = 8 * ks + 2 * t, j1 = j0 + 1;
          const float2 lo =
              *reinterpret_cast<const float2*>(cbs + i0 * p.ldcb + j0);
          const float2 hi =
              *reinterpret_cast<const float2*>(cbs + i1 * p.ldcb + j0);
          const float cj0 = cum[j0], cj1 = cum[j1];
          const float dj0 = dt[j0], dj1 = dt[j1];
          const float v[4] = {decay(lo.x, ci0, cj0, dj0, i0 >= j0),
                              decay(hi.x, ci1, cj0, dj0, i1 >= j0),
                              decay(lo.y, ci0, cj1, dj1, i0 >= j1),
                              decay(hi.y, ci1, cj1, dj1, i1 >= j1)};
          tf32x3::Frag<4> a;
          tf32x3::split_fast(a, v);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            tf32x3::mma3(acc[nt], a,
                         tf32x3::load_b<true>(xb, kLdX, 8 * ks,
                                              8 * (pq * NT + nt), lane));
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = p0 + 8 * (pq * NT + nt) + 2 * t;
          if (i0 < p.Q)
            store2(p.y, ((bn * p.Q + i0) * p.H + h) * p.P + col, col, p.P,
                   acc[nt][0], acc[nt][1], p.vy);
          if (i1 < p.Q)
            store2(p.y, ((bn * p.Q + i1) * p.H + h) * p.P + col, col, p.P,
                   acc[nt][2], acc[nt][3], p.vy);
        }
      }
    }

    // the next item's x, cum and dt into the other half of the buffer,
    // issued here, after y, so that their copies queue behind the states'
    // products rather than ahead of the work at the item's start
    if (it + 1 < items) {
      const int nh = (it + 1) / p.nP, np_ = it + 1 - nh * p.nP;
      load_head(p, bn, h0 + nh, np_, xs + (buf ^ 1) * QP * kLdX,
                cums + (buf ^ 1) * QP, dts + (buf ^ 1) * QP);
      tf32x3::cp_async_commit();
    }

    // states (x w)^T B: 32 x 32 tiles of the P x S tile (two m16 tiles of
    // P by four n8 tiles of S, so each A and B fragment serves more than
    // one product), K over the chunk
    const int pw = min(kPT, p.P - p0);
    for (int sti = 0; sti < p.nS; ++sti) {
      if (p.nS > 1) {
        __syncthreads();   // the last S tile is read
        load_bc(p, bn, sti, bs, nullptr, false);
        tf32x3::cp_async_commit();
        tf32x3::cp_async_wait<0>();
        __syncthreads();
      }
      const int s0 = sti * kST, sw = min(kST, p.S - s0);
      const int npp = (pw + 31) / 32, nsq = (sw + 31) / 32;
      for (int wi = warp; wi < npp * nsq; wi += kWarps) {
        const int pp = wi / nsq, sq = wi - pp * nsq;
        float acc[2][4][4] = {};
        const float* xc = xb + 32 * pp + g;
#pragma unroll 2
        for (int ks = 0; ks < QP / 8; ++ks) {
          const int j0 = 8 * ks + 2 * t, j1 = j0 + 1;
          const float w0 = ws[j0], w1 = ws[j1];
          tf32x3::Frag<4> a[2];
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const float* x0 = xc + j0 * kLdX + 16 * m;
            const float v[4] = {x0[0] * w0, x0[8] * w0, x0[kLdX] * w1,
                                x0[kLdX + 8] * w1};
            tf32x3::split_fast(a[m], v);
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const tf32x3::Frag<2> b = tf32x3::load_b<true>(
                bs, kLdB, 8 * ks, 32 * sq + 8 * nt, lane);
#pragma unroll
            for (int m = 0; m < 2; ++m) tf32x3::mma3(acc[m][nt], a[m], b);
          }
        }
        float* sp = p.st + (bn * p.H + h) * (long long)p.P * p.S;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int pa = p0 + 32 * pp + 16 * m + g, pb = pa + 8;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int col = s0 + 32 * sq + 8 * nt + 2 * t;
            if (pa < p.P)
              store2(sp, (long long)pa * p.S + col, col, p.S,
                     acc[m][nt][0], acc[m][nt][1], p.vst);
            if (pb < p.P)
              store2(sp, (long long)pb * p.S + col, col, p.S,
                     acc[m][nt][2], acc[m][nt][3], p.vst);
          }
        }
      }
    }
  }
}

// B, C.B^T, two x tiles, two cum and dt halves, and w
long long smem_bytes(int QP, int ldcb) {
  return 4ll * (QP * kLdB + QP * ldcb + 2 * QP * kLdX + 5 * QP);
}

// heads a block: the HG <= kMaxHeads that minimises whole waves x the
// block's work (HG heads plus its C.B^T, in multiply-adds)
int heads_per_block(int BN, int H, int QP, int P, int S, int slots) {
  const double pp = ((P + 7) / 8) * 8.0, sp = ((S + 7) / 8) * 8.0;
  const double head = QP * (QP / 2.0 + 8) * pp + pp * sp * QP;
  const double cb = (double)QP * QP * sp;
  int best = 1;
  double best_cost = 0;
  for (int hg = 1; hg <= kMaxHeads && hg <= H; ++hg) {
    const long long blocks = (long long)BN * ((H + hg - 1) / hg);
    const double waves = (double)((blocks + slots - 1) / slots);
    const double cost = waves * (hg * head + cb);
    if (hg == 1 || cost < best_cost) {
      best = hg;
      best_cost = cost;
    }
  }
  return best;
}

// the launch of a call on the current device: Q padded to 16, C.B^T's
// row stride, heads a block, the grid and a block's shared memory (what
// ssd_chunk_plan reports)
struct Launch {
  int QP, ldcb, HG;
  dim3 grid;
  long long smem;
};

Launch make_launch(int BN, int H, int Q, int P, int S) {
  Launch l;
  l.QP = (Q + 15) / 16 * 16;
  l.ldcb = (l.QP + 31) / 32 * 32 + 8;
  l.smem = smem_bytes(l.QP, l.ldcb);
  const int per_sm = (int)(233472 / (l.smem + 1024)) < 2
                         ? 1 : 2;   // __launch_bounds__(256, 2)
  l.HG = heads_per_block(BN, H, l.QP, P, S, per_sm * sm_count());
  l.grid = dim3((unsigned)BN, (unsigned)((H + l.HG - 1) / l.HG));
  return l;
}

template <int NT>
cudaError_t launch(const Params& p, long long smem, dim3 grid,
                   cudaStream_t stream) {
  static long long attr_set[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (attr_set[dev] < smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    attr_set[dev] = smem;
  }
  ssd_chunk_kernel<NT><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// ---- the tiled route: chunks of q > kQMax rows ----------------------------

namespace tl {

using namespace ssd;
using ssd::kPT;
using ssd::kThreads;
using tf32x3::Frag;

constexpr int kR = 64;             // rows of a strip, and of a j tile
constexpr int kLdX = kPT + 4;      // x stage rows: = 4 mod 32
constexpr int kStage = kR * kLdX;  // an x stage
constexpr int kSC = 32;            // S columns a C.B^T staging step
constexpr int kLdS = kSC + 8;      // staged C and B rows: = 8 mod 32
constexpr int kSS = 64;            // a block's S tile of the states
constexpr int kLdB = kSS + 4;      // its rows of B: = 4 mod 32
static_assert((2 * kR + kR) * kLdS <= 2 * kStage + kR * kLdB,
              "C.B^T's staging (two strips of C and a window's rows of B) "
              "fits the stages' and B's space, at any window");

struct Args {
  const float* x;
  const float* B;
  const float* C;
  const float* dt;
  const float* cum;
  float* y;
  float* st;
  int H, Q, P, S;
  int n;          // 64-row strips of the chunk
  int npairs;     // strip pairs p and n - 1 - p: a block's y
  int nst;        // 64-column S tiles: a block's states
  int roles;      // blocks a group: max(npairs, nst)
  int nP;         // 64-column P tiles
  int HG;         // heads a group
  int W;          // j tiles a window
  int QV;         // a head's vectors: n * 64
  int o_u, o_b, o_v;   // offsets (floats): the ring, B's rows, the vectors
  int vx;         // x rows 16-byte aligned
  int vbc;        // B and C rows 16-byte aligned
  int vy, vst;    // y and the states in 8-byte pairs
};

// floats of a block's strips of C.B^T in a window of W j tiles: at most 64
// rows by 64 min(2 W, n + 1) columns, and two 8-float pads
long long cb_floats(int n, int W) {
  return (long long)kR * (kR * (2 * W < n + 1 ? 2 * W : n + 1) + 16);
}

// a block's shared memory in bytes: C.B^T's strips, two x stages, the
// window's rows of B in the block's S tile (C.B^T's staging runs in the
// stages' and B's space before them), the vectors (cum and dt of three
// heads, w, and two j tiles' column factors)
long long smem_bytes(int n, int W, int QV) {
  return 4 * (cb_floats(n, W) + 2ll * kStage + (long long)kR * W * kLdB +
              7ll * QV + 2 * kR);
}

struct Launch {
  Args a;
  dim3 grid;
  long long smem;
};

// the widest window that fits (W = 0: none does), and the heads a group:
// one block an SM (its registers are not capped at 128), the HG that
// minimises whole waves x a block's multiply-adds (its heads' M x over
// its pair's n + 1 tiles of 64 x 64 and their (x w)^T B over the chunk in
// its S tile, and its C.B^T), as heads_per_block does
Launch make_launch(int BN, int H, int Q, int P, int S) {
  Launch l;
  Args& a = l.a;
  a = Args{};
  a.H = H;
  a.Q = Q;
  a.P = P;
  a.S = S;
  a.n = (Q + kR - 1) / kR;
  a.npairs = (a.n + 1) / 2;
  a.nst = (S + kSS - 1) / kSS;
  a.roles = a.npairs > a.nst ? a.npairs : a.nst;
  a.nP = (P + kPT - 1) / kPT;
  a.QV = a.n * kR;
  for (int w = a.n; w >= 1 && !a.W; --w)
    if (smem_bytes(a.n, w, a.QV) <= kMaxSmem) a.W = w;
  const int w = a.W ? a.W : 1;
  l.smem = smem_bytes(a.n, w, a.QV);
  a.o_u = (int)cb_floats(a.n, w);
  a.o_b = a.o_u + 2 * kStage;
  a.o_v = a.o_b + kR * w * kLdB;
  const long long slots = ssd::sm_count();
  const double pp = a.nP * (double)kPT, tiles = (a.n + 1) * (double)kR * kR;
  const double head = tiles * pp + pp * kSS * a.QV;
  const double cb = tiles * ((S + kSC - 1) / kSC * kSC);
  a.HG = 1;
  double best = 0;
  for (int hg = 1; hg <= H; ++hg) {
    const long long gy = (long long)((H + hg - 1) / hg) * a.roles;
    if (gy > 65535) continue;
    const double waves = (double)((BN * gy + slots - 1) / slots);
    const double cost = waves * (hg * head + cb);
    if (best == 0 || cost < best) {
      a.HG = hg;
      best = cost;
    }
  }
  l.grid = dim3((unsigned)BN,
                (unsigned)((long long)((H + a.HG - 1) / a.HG) * a.roles));
  return l;
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_tiled(const Args p) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem + p.o_u;        // two x stages; C.B^T's staging
  float* bw = smem + p.o_b;          // the window's rows of B, S tile s0
  float* cumv = smem + p.o_v;        // 3 x QV: a head's cum, by hh % 3
  float* dtv = cumv + 3 * p.QV;      // 3 x QV: its dt
  float* wv = dtv + 3 * p.QV;        // QV: its w
  float* ecol = wv + p.QV;           // 2 x 64: a step's column factors
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long bn = blockIdx.x;   // b * nc + n
  const int grp = blockIdx.y / p.roles, role = blockIdx.y % p.roles;
  const int h0 = grp * p.HG, hg = min(p.HG, p.H - h0);
  const int Q = p.Q, QV = p.QV, nP = p.nP;
  // the block's strips for y (one where n is odd and this is the middle
  // pair; none past the pairs) and its S tile for the states (none past
  // S), and the last j tile it reads
  const bool hy = role < p.npairs, hs = role < p.nst;
  const int sa = role, sb = p.n - 1 - role;
  const int nstr = hy ? (sa == sb ? 1 : 2) : 0;
  const int s0 = role * kSS;
  const int jlast = hs ? p.n - 1 : sb;
  // warps 0-3: y, rows 16 mi of each strip by all of the P tile; warps
  // 4-7: the states, P rows 32 pq by S columns 32 sq of the S tile
  const bool yw = warp < 4;
  const int mi = warp & 3, pq = warp & 1, sq = (warp >> 1) & 1;
  const int units = hg * nP;

  // cum and dt past Q stay zero: the loads write rows < Q
  for (int e = threadIdx.x; e < 6 * QV; e += kThreads)
    if (e % QV >= Q) cumv[e] = 0.f;

  // head hh's cum and dt into buffer hh % 3 (rows < Q)
  auto issue_vectors = [&](int hh) {
    float* cb = cumv + (hh % 3) * QV;
    float* db = dtv + (hh % 3) * QV;
    for (int e = threadIdx.x; e < Q; e += kThreads) {
      tf32x3::cp_async4(cb + e, p.cum + (bn * Q + e) * p.H + h0 + hh);
      tf32x3::cp_async4(db + e, p.dt + (bn * Q + e) * p.H + h0 + hh);
    }
  };
  // stage d of a window of nj j tiles from jt0: unit d / nj's j tile into
  // ring half d & 1; with a head's first stage (issued while the head
  // before runs its last) the next head's cum and dt, a head ahead of use
  // (three buffers: the head running, the head landing, the next)
  auto issue = [&](int d, int jt0, int nj) {
    const int u = d / nj, jt = jt0 + d - u * nj;
    const int hh = u / nP, pt = u - hh * nP, h = h0 + hh;
    const int j0 = jt * kR, p0 = pt * kPT;
    load_tile(ring + (d & 1) * kStage, kLdX,
              p.x + ((bn * Q + j0) * p.H + h) * (long long)p.P + p0,
              (long long)p.H * p.P, kR, kPT, min(kR, Q - j0),
              min(kPT, p.P - p0), p.vx);
    if (jt == jt0 && pt == 0) {
      if (hh == 0) issue_vectors(0);
      if (hh + 1 < hg) issue_vectors(hh + 1);
    }
  };
  // the column factors exp(cum_e - cum_j) dt_j of stage d's j tile (e its
  // last row), into ecol half d & 1, by 64 of the states warps' threads:
  // stage d's head's cum and dt have landed (issued a head ahead)
  auto column_factors = [&](int d, int jt0, int nj) {
    const int e = threadIdx.x - 4 * 32;
    if (e < 0 || e >= kR) return;
    const int u = d / nj, jt = jt0 + d - u * nj, hh = u / nP;
    const float* cum = cumv + (hh % 3) * QV;
    const float* dt = dtv + (hh % 3) * QV;
    const int j = jt * kR + e;
    ecol[(d & 1) * kR + e] = __expf(cum[jt * kR + kR - 1] - cum[j]) * dt[j];
  };

  const int nwin = (jlast + p.W) / p.W;
  for (int win = 0; win < nwin; ++win) {
    const int jt0 = win * p.W, jt1 = min(jt0 + p.W, jlast + 1);
    const int nj = jt1 - jt0;
    // the strips in this window: j tiles jt0 .. min(jt1, s + 1) - 1
    const int nja = hy ? max(0, min(jt1, sa + 1) - jt0) : 0;
    const int njb = nstr == 2 ? max(0, min(jt1, sb + 1) - jt0) : 0;
    const int lda = kR * nja + 8, ldb = kR * njb + 8;   // = 8 mod 32
    float* cba = smem;               // strip a's C.B^T: 64 x lda
    float* cbb = smem + kR * lda;    // strip b's: 64 x ldb
    __syncthreads();                 // the last window is read

    if (hy) {
      // C.B^T of the strips' rows against the window's columns, on or
      // below the diagonal by 32-column group: S in 32-column steps, the
      // strips' C rows and the window's B rows staged together
      float* cst = ring;                   // 2 x 64 x kLdS
      float* bst = ring + 2 * kR * kLdS;   // 64 nj x kLdS
      const int nsc = (p.S + kSC - 1) / kSC, rb = min(nj * kR, Q - jt0 * kR);
      for (int sc = 0; sc < nsc; ++sc) {
        const int c0 = sc * kSC, cw = min(kSC, p.S - c0);
        __syncthreads();   // the staging is read
        for (int k = 0; k < nstr; ++k) {
          const int r0 = (k ? sb : sa) * kR;
          load_tile(cst + k * kR * kLdS, kLdS,
                    p.C + (bn * Q + r0) * p.S + c0, p.S, kR, kSC,
                    min(kR, Q - r0), cw, p.vbc);
        }
        load_tile(bst, kLdS, p.B + (bn * Q + jt0 * kR) * p.S + c0, p.S,
                  nj * kR, kSC, rb, cw, p.vbc);
        tf32x3::cp_async_commit();
        tf32x3::cp_async_wait<0>();
        __syncthreads();
        // items (strip k, 16-row strip m, j tile, 32-column group cg)
        for (int it = warp; it < 16 * nj; it += kWarps) {
          const int k = it / (8 * nj), m = it / (2 * nj) % 4;
          const int c = it % (2 * nj), jt = jt0 + c / 2, cg = c & 1;
          const int s = k ? sb : sa;
          if (k >= nstr || jt > s || (jt == s && 32 * cg > 16 * m + 15))
            continue;
          float acc[4][4] = {};
#pragma unroll
          for (int ks = 0; ks < kSC / 8; ++ks) {
            const Frag<4> af = tf32x3::load_a<true>(cst + k * kR * kLdS,
                                                    kLdS, 16 * m, 8 * ks,
                                                    lane);
            Frag<2> b[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              b[j] = tf32x3::load_bt<true>(bst, kLdS,
                                           (jt - jt0) * kR + 32 * cg + 8 * j,
                                           8 * ks, lane);
            tf32x3::mma3_row(acc, af, b);
          }
          const int ld = k ? ldb : lda;
          float* cb = (k ? cbb : cba) + (16 * m + g) * ld +
                      (jt - jt0) * kR + 32 * cg + 2 * t;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float2* lo = reinterpret_cast<float2*>(cb + 8 * j);
            float2* hi = reinterpret_cast<float2*>(cb + 8 * ld + 8 * j);
            float2 l = make_float2(acc[j][0], acc[j][1]);
            float2 u = make_float2(acc[j][2], acc[j][3]);
            if (sc) {
              l.x += lo->x; l.y += lo->y; u.x += hi->x; u.y += hi->y;
            }
            *lo = l;
            *hi = u;
          }
        }
      }
      __syncthreads();   // C.B^T formed; the staging space is free again
    }
    if (hs)   // the window's rows of B in the S tile, with the first stage
      load_tile(bw, kLdB, p.B + (bn * Q + jt0 * kR) * p.S + s0, p.S,
                nj * kR, kSS, min(nj * kR, Q - jt0 * kR), min(kSS, p.S - s0),
                p.vbc);

    const int steps = units * nj;
    issue(0, jt0, nj);
    tf32x3::cp_async_commit();
    tf32x3::cp_async_wait<0>();
    __syncthreads();   // stage 0 and the first heads' vectors landed
    column_factors(0, jt0, nj);
    float acc[2][8][4];    // y: [strip][n8 tile of P]
    float sacc[2][4][4];   // the states: [m][n8 tile of S]
    for (int d = 0; d < steps; ++d) {
      const int u = d / nj, jt = jt0 + d - u * nj;
      const int hh = u / nP, pt = u - hh * nP, h = h0 + hh;
      const int p0 = pt * kPT;
      tf32x3::cp_async_wait<0>();
      __syncthreads();   // stage d landed; stage d - 1 is read
      if (d + 1 < steps) {
        issue(d + 1, jt0, nj);
        column_factors(d + 1, jt0, nj);
      }
      tf32x3::cp_async_commit();
      const float* xs = ring + (d & 1) * kStage;
      const float* cum = cumv + (hh % 3) * QV;
      const float* dt = dtv + (hh % 3) * QV;
      if (hs && jt == jt0 && pt == 0) {   // once a head: w
        const float cend = cum[Q - 1];
        for (int j = threadIdx.x; j < QV; j += kThreads)
          wv[j] = j < Q ? __expf(cend - cum[j]) * dt[j] : 0.f;
        __syncthreads();
      }

      if (yw && hy) {
        if (jt == jt0) {   // the unit's y: 0, or the last window's
#pragma unroll
          for (int k = 0; k < 2; ++k)
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
              const int s = k ? sb : sa;
              const int i0 = s * kR + 16 * mi + g, col = p0 + 8 * nt + 2 * t;
              float2 lo = make_float2(0.f, 0.f), hi = lo;
              if (win && k < nstr && s >= jt0) {
                const long long o = ((bn * Q + i0) * p.H + h) * (long long)p.P
                                    + col;
                if (i0 < Q) lo = load2(p.y, o, col, p.P);
                if (i0 + 8 < Q)
                  hi = load2(p.y, o + 8ll * p.H * p.P, col, p.P);
              }
              acc[k][nt][0] = lo.x; acc[k][nt][1] = lo.y;
              acc[k][nt][2] = hi.x; acc[k][nt][3] = hi.y;
            }
        }
        // y_i += M_ij x_j: k steps on or below the diagonal; x's fragments
        // serve both strips, M's each its 8 n8 tiles of P
        int kmax[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int s = k ? sb : sa;
          kmax[k] = k >= nstr || jt > s ? 0 : jt == s ? 2 * mi + 2 : kR / 8;
        }
        const float* cbr[2] = {cba + (16 * mi + g) * lda + (jt - jt0) * kR,
                               cbb + (16 * mi + g) * ldb + (jt - jt0) * kR};
        const int ldk[2] = {lda, ldb};
        // below the diagonal tile (jt < s: i > e >= j, e the j tile's last
        // row, inside the chunk) exp(cum_i - cum_j) = exp(cum_i - cum_e)
        // exp(cum_e - cum_j), both factors at most 1: a row factor a step
        // and a column factor a k step, shared by the strips; on the
        // diagonal tile the decay as above
        const float ce = cum[jt * kR + kR - 1];
        float ci[2][2], ri[2][2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int i0 = (k ? sb : sa) * kR + 16 * mi + g;
          ci[k][0] = cum[min(i0, QV - 1)];
          ci[k][1] = cum[min(i0 + 8, QV - 1)];
          const bool off = k < nstr && jt < (k ? sb : sa);
          ri[k][0] = off && i0 < Q ? __expf(ci[k][0] - ce) : 0.f;
          ri[k][1] = off && i0 + 8 < Q ? __expf(ci[k][1] - ce) : 0.f;
        }
        const int kend = max(kmax[0], kmax[1]);
        for (int ks = 0; ks < kend; ++ks) {
          const int jl = 8 * ks + 2 * t, j0 = jt * kR + jl, j1 = j0 + 1;
          const float cj0 = cum[j0], cj1 = cum[j1];
          const float dj0 = dt[j0], dj1 = dt[j1];
          const float e0 = ecol[(d & 1) * kR + jl];
          const float e1 = ecol[(d & 1) * kR + jl + 1];
          Frag<4> a[2];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            if (ks >= kmax[k]) continue;
            const int i0 = (k ? sb : sa) * kR + 16 * mi + g, i1 = i0 + 8;
            const float2 lo = *reinterpret_cast<const float2*>(cbr[k] + jl);
            const float2 hi =
                *reinterpret_cast<const float2*>(cbr[k] + 8 * ldk[k] + jl);
            if (jt < (k ? sb : sa)) {
              const float v[4] = {lo.x * ri[k][0] * e0, hi.x * ri[k][1] * e0,
                                  lo.y * ri[k][0] * e1, hi.y * ri[k][1] * e1};
              tf32x3::split_fast(a[k], v);
            } else {
              const float v[4] = {
                  decay(lo.x, ci[k][0], cj0, dj0, i0 >= j0 && j0 < Q),
                  decay(hi.x, ci[k][1], cj0, dj0, i1 >= j0 && j0 < Q),
                  decay(lo.y, ci[k][0], cj1, dj1, i0 >= j1 && j1 < Q),
                  decay(hi.y, ci[k][1], cj1, dj1, i1 >= j1 && j1 < Q)};
              tf32x3::split_fast(a[k], v);
            }
          }
          Frag<2> b[8];
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
            b[nt] = tf32x3::load_b<true>(xs, kLdX, 8 * ks, 8 * nt, lane);
#pragma unroll
          for (int k = 0; k < 2; ++k)
            if (ks < kmax[k]) tf32x3::mma3_row(acc[k], a[k], b);
        }
        if (jt == jt1 - 1) {   // the unit's last tile in this window
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int s = k ? sb : sa;
            if (k >= nstr || s < jt0) continue;
            const int i0 = s * kR + 16 * mi + g;
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
              const int col = p0 + 8 * nt + 2 * t;
              const long long o = ((bn * Q + i0) * p.H + h) * (long long)p.P
                                  + col;
              if (i0 < Q)
                store2(p.y, o, col, p.P, acc[k][nt][0], acc[k][nt][1], p.vy);
              if (i0 + 8 < Q)
                store2(p.y, o + 8ll * p.H * p.P, col, p.P, acc[k][nt][2],
                       acc[k][nt][3], p.vy);
            }
          }
        }
      } else if (!yw && hs) {
        float* sp = p.st + (bn * p.H + h) * (long long)p.P * p.S;
        if (jt == jt0) {   // the unit's states: 0, or the last window's
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const int pr = p0 + 32 * pq + 16 * m + g;
              const int col = s0 + 32 * sq + 8 * nt + 2 * t;
              float2 lo = make_float2(0.f, 0.f), hi = lo;
              if (win) {
                if (pr < p.P) lo = load2(sp, (long long)pr * p.S + col, col,
                                         p.S);
                if (pr + 8 < p.P)
                  hi = load2(sp, (long long)(pr + 8) * p.S + col, col, p.S);
              }
              sacc[m][nt][0] = lo.x; sacc[m][nt][1] = lo.y;
              sacc[m][nt][2] = hi.x; sacc[m][nt][3] = hi.y;
            }
        }
        // states += (x o w)^T B over this j tile
        const float* bt = bw + (jt - jt0) * kR * kLdB;
#pragma unroll 2
        for (int ks = 0; ks < kR / 8; ++ks) {
          const int jl = 8 * ks + 2 * t;
          const float w0 = wv[jt * kR + jl], w1 = wv[jt * kR + jl + 1];
          Frag<4> a[2];
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const float* x0 = xs + jl * kLdX + 32 * pq + 16 * m + g;
            const float v[4] = {x0[0] * w0, x0[8] * w0, x0[kLdX] * w1,
                                x0[kLdX + 8] * w1};
            tf32x3::split_fast(a[m], v);
          }
          Frag<2> b[4];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            b[nt] = tf32x3::load_b<true>(bt, kLdB, 8 * ks, 32 * sq + 8 * nt,
                                         lane);
#pragma unroll
          for (int m = 0; m < 2; ++m) tf32x3::mma3_row(sacc[m], a[m], b);
        }
        if (jt == jt1 - 1) {
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const int pr = p0 + 32 * pq + 16 * m + g;
              const int col = s0 + 32 * sq + 8 * nt + 2 * t;
              if (pr < p.P)
                store2(sp, (long long)pr * p.S + col, col, p.S, sacc[m][nt][0],
                       sacc[m][nt][1], p.vst);
              if (pr + 8 < p.P)
                store2(sp, (long long)(pr + 8) * p.S + col, col, p.S,
                       sacc[m][nt][2], sacc[m][nt][3], p.vst);
            }
        }
      }
    }
  }
}

int launch(const Launch& l, cudaStream_t stream) {
  static long long attr_set[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (attr_set[dev] < l.smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_tiled, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)l.smem);
    if (err != cudaSuccess) return (int)err;
    attr_set[dev] = l.smem;
  }
  ssd_chunk_tiled<<<l.grid, kThreads, l.smem, stream>>>(l.a);
  return (int)cudaGetLastError();
}

bool valid(const Launch& l) { return l.a.W > 0 && l.grid.y <= 65535; }

}  // namespace tl

extern "C" int ssd_chunk_forward(const float* x, const float* Bm,
                                 const float* Cm, const float* dt,
                                 const float* cum, float* y, float* st,
                                 int BN, int H, int Q, int P, int S,
                                 void* stream) {
  if (BN < 1 || H < 1 || Q < 1 || P < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  if (Q > kQMax) {
    tl::Launch l = tl::make_launch(BN, H, Q, P, S);
    if (!tl::valid(l)) return (int)cudaErrorInvalidValue;
    tl::Args& a = l.a;
    a.x = x;
    a.B = Bm;
    a.C = Cm;
    a.dt = dt;
    a.cum = cum;
    a.y = y;
    a.st = st;
    a.vx = ssd::aligned(x, 16) && P % 4 == 0;
    a.vbc = ssd::aligned(Bm, 16) && ssd::aligned(Cm, 16) && S % 4 == 0;
    a.vy = ssd::aligned(y, 8) && P % 2 == 0;
    a.vst = ssd::aligned(st, 8) && S % 2 == 0;
    return tl::launch(l, (cudaStream_t)stream);
  }
  Params p;
  p.x = x;
  p.B = Bm;
  p.C = Cm;
  p.dt = dt;
  p.cum = cum;
  p.y = y;
  p.st = st;
  p.H = H;
  p.Q = Q;
  p.P = P;
  p.S = S;
  const Launch l = make_launch(BN, H, Q, P, S);
  if (l.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  p.QP = l.QP;
  p.ldcb = l.ldcb;
  p.HG = l.HG;
  p.nP = (P + kPT - 1) / kPT;
  p.nS = (S + kST - 1) / kST;
  auto al = [](const void* a, int n) {
    return (reinterpret_cast<uintptr_t>(a) & (n - 1)) == 0;
  };
  p.vx = al(x, 16) && P % 4 == 0;
  p.vbc = al(Bm, 16) && al(Cm, 16) && S % 4 == 0;
  p.vy = al(y, 8) && P % 2 == 0;
  p.vst = al(st, 8) && S % 2 == 0;
  const cudaStream_t sm = (cudaStream_t)stream;
  // two 16-row strips a warp, P's 8 n8 tiles split over the warps a pair
  const int npairs = (p.QP / 16 + 1) / 2;
  if (npairs == 1) return (int)launch<1>(p, l.smem, l.grid, sm);
  if (npairs == 2) return (int)launch<2>(p, l.smem, l.grid, sm);
  return (int)launch<4>(p, l.smem, l.grid, sm);
}

// the launch ssd_chunk_forward makes for these widths on the current
// device: {Q padded, heads a block, grid x, grid y, shared memory bytes,
// tiled}: the tiled route (q > kQMax) pads Q to its 64-row strips and
// takes HG heads a group and (strip pairs + 64-column S tiles) blocks a
// group; 0, or an error for widths the kernel does not take
extern "C" int ssd_chunk_plan(int BN, int H, int Q, int P, int S,
                              long long* out) {
  if (BN < 1 || H < 1 || Q < 1 || P < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  if (Q > kQMax) {
    const tl::Launch l = tl::make_launch(BN, H, Q, P, S);
    out[0] = (long long)l.a.QV;
    out[1] = l.a.HG;
    out[2] = l.grid.x;
    out[3] = l.grid.y;
    out[4] = l.smem;
    out[5] = 1;
    return tl::valid(l) ? 0 : (int)cudaErrorInvalidValue;
  }
  const Launch l = make_launch(BN, H, Q, P, S);
  out[0] = l.QP;
  out[1] = l.HG;
  out[2] = l.grid.x;
  out[3] = l.grid.y;
  out[4] = l.smem;
  out[5] = 0;
  return l.smem > kMaxSmem ? (int)cudaErrorInvalidValue : 0;
}

extern "C" const char* ssd_chunk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
