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
// alone is 256 KB in fp32): the chunk's rows in tiles of 64
// (ssd_tiles.cuh, namespace tiled), fp32 on the CUDA cores, no speed
// sought.  A block takes one (chunk, head) and either a row tile i of y,
// looping over the causal column tiles j <= i (C.B^T's tile over S, the
// decay and dt_j applied in registers, then y_i += M_ij x_j through
// shared memory), or a 64 x 128 tile of the states, summing over the
// chunk's rows in order.  One launch; no atomics.
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

using ssd::kThreads;
using namespace ssd::tiled;

constexpr int kST2 = 2 * kT;   // the states' S tile

struct Args {
  const float* x;
  const float* B;
  const float* C;
  const float* dt;
  const float* cum;
  float* y;
  float* st;
  int H, Q, P, S;
  int nT, nPT, nST;   // 64-row tiles of q, 64-column of P, 128-column of S
};

// the staging, a 64 x 64 tile of M, cum of rows i, cum and dt of rows j
constexpr long long kSmem = 4ll * (kStageFloats + kT * kLdT + 3 * kT);

int tiles(const Args& p) { return p.nT + p.nPT * p.nST; }

__global__ void __launch_bounds__(kThreads)
ssd_chunk_tiled(const Args p) {
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;
  float* ms = stage + kStageFloats;
  float* cumi = ms + kT * kLdT;
  float* cumj = cumi + kT;
  float* dtj = cumj + kT;
  const long long bn = blockIdx.x;
  const int ntile = p.nT + p.nPT * p.nST;
  const int h = blockIdx.y / ntile, tile = blockIdx.y % ntile;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long HP = (long long)p.H * p.P;
  const float* xb = p.x + bn * p.Q * HP + (long long)h * p.P;  // row j: j HP
  const float* Bb = p.B + bn * p.Q * p.S;
  const float* Cb = p.C + bn * p.Q * p.S;
  const float* cumh = p.cum + bn * p.Q * p.H + h;             // row j: j H
  const float* dth = p.dt + bn * p.Q * p.H + h;
  if (tile < p.nT) {                  // y of rows [i0, i0 + 64)
    const int i0 = tile * kT;
    for (int e = tid; e < kT; e += kThreads)
      cumi[e] = i0 + e < p.Q ? cumh[(long long)(i0 + e) * p.H] : 0.f;
    for (int pt = 0; pt < p.nPT; ++pt) {
      const int p0 = pt * kT;
      float acc[4][4];
      zero(acc);
      for (int jt = 0; jt <= tile; ++jt) {
        const int j0 = jt * kT;
        for (int e = tid; e < kT; e += kThreads) {
          const bool in = j0 + e < p.Q;
          cumj[e] = in ? cumh[(long long)(j0 + e) * p.H] : 0.f;
          dtj[e] = in ? dth[(long long)(j0 + e) * p.H] : 0.f;
        }
        float m[4][4];                // C.B^T, then M, of tile (i, j)
        zero(m);
        mm_acc<4, true, true>(
            m, p.S,
            [&](int r, int k) {
              return i0 + r < p.Q ? Cb[(long long)(i0 + r) * p.S + k] : 0.f;
            },
            [&](int k, int c) {
              return j0 + c < p.Q ? Bb[(long long)(j0 + c) * p.S + k] : 0.f;
            },
            stage);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int ri = 4 * ty + a, cj = tx + 16 * b;
            const int i = i0 + ri, j = j0 + cj;
            const bool on = i >= j && i < p.Q && j < p.Q;
            m[a][b] = on ? m[a][b] * decay_l(cumi[ri], cumj[cj], on) *
                               dtj[cj]
                         : 0.f;
          }
        store_tile(ms, m);
        mm_acc<4, false, false>(
            acc, kT, [&](int r, int k) { return ms[r * kLdT + k]; },
            [&](int k, int c) {
              return j0 + k < p.Q && p0 + c < p.P
                         ? xb[(j0 + k) * HP + p0 + c]
                         : 0.f;
            },
            stage);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int i = i0 + 4 * ty + a, pc = p0 + tx + 16 * b;
          if (i < p.Q && pc < p.P)
            p.y[(bn * p.Q + i) * HP + (long long)h * p.P + pc] = acc[a][b];
        }
    }
    return;
  }
  // the states' tile: P rows [p0, p0 + 64), S columns [s0, s0 + 128)
  const int idx = tile - p.nT, pt = idx / p.nST, sti = idx % p.nST;
  const int p0 = pt * kT, s0 = sti * kST2;
  const float cend = cumh[(long long)(p.Q - 1) * p.H];
  float acc[4][8];
  zero(acc);
  mm_acc<8, false, false>(
      acc, p.Q,
      [&](int r, int k) {
        return p0 + r < p.P
                   ? xb[k * HP + p0 + r] *
                         (expf(cend - cumh[(long long)k * p.H]) *
                          dth[(long long)k * p.H])
                   : 0.f;
      },
      [&](int k, int c) {
        return s0 + c < p.S ? Bb[(long long)k * p.S + s0 + c] : 0.f;
      },
      stage);
  float* sp = p.st + (bn * p.H + h) * (long long)p.P * p.S;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int pr = p0 + 4 * ty + a, sc = s0 + tx + 16 * b;
      if (pr < p.P && sc < p.S) sp[(long long)pr * p.S + sc] = acc[a][b];
    }
}

Args make_args(int BN, int H, int Q, int P, int S) {
  Args a{};
  a.H = H;
  a.Q = Q;
  a.P = P;
  a.S = S;
  a.nT = (Q + kT - 1) / kT;
  a.nPT = (P + kT - 1) / kT;
  a.nST = (S + kST2 - 1) / kST2;
  return a;
}

int launch(Args a, int BN, cudaStream_t stream) {
  const long long gy = (long long)a.H * tiles(a);
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_tiled, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_tiled<<<dim3((unsigned)BN, (unsigned)gy), kThreads, kSmem,
                  stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace tl

extern "C" int ssd_chunk_forward(const float* x, const float* Bm,
                                 const float* Cm, const float* dt,
                                 const float* cum, float* y, float* st,
                                 int BN, int H, int Q, int P, int S,
                                 void* stream) {
  if (BN < 1 || H < 1 || Q < 1 || P < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  if (Q > kQMax) {
    tl::Args a = tl::make_args(BN, H, Q, P, S);
    a.x = x;
    a.B = Bm;
    a.C = Cm;
    a.dt = dt;
    a.cum = cum;
    a.y = y;
    a.st = st;
    return tl::launch(a, BN, (cudaStream_t)stream);
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
// tiled}: the tiled route (q > kQMax) pads Q to its 64-row tiles, takes
// one head a block and H x (row tiles + states tiles) blocks a chunk; 0,
// or an error for widths the kernel does not take
extern "C" int ssd_chunk_plan(int BN, int H, int Q, int P, int S,
                              long long* out) {
  if (BN < 1 || H < 1 || Q < 1 || P < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  if (Q > kQMax) {
    const tl::Args a = tl::make_args(BN, H, Q, P, S);
    out[0] = (long long)a.nT * tl::kT;
    out[1] = 1;
    out[2] = BN;
    out[3] = (long long)H * tl::tiles(a);
    out[4] = tl::kSmem;
    out[5] = 1;
    return out[3] > 65535 ? (int)cudaErrorInvalidValue : 0;
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
