// ssd_chunk_bwd: the gradient of ssd_chunk's forward (csrc/ssd_chunk.cu),
// fp32.
//
// The TPU package has no backward kernel: its trainer differentiates the
// jnp SSD (src/repro/nn/ssm.py), and ssd_chunk_pallas
// (src/repro/kernels/ssd_chunk/ssd_chunk.py:64) is forward only.  The port
// runs the intra-chunk block through the forward kernel, so training
// needs this.  Per (batch b, chunk n) with x, dy (q, H, P), B and C (q, S),
// dt and cum (q, H) and dst (H, P, S), per head h, with
// L[i, j] = exp(cum_i - cum_j) where i >= j (else 0), CB = C B^T,
// M = CB o L o dt_j, w_end = exp(cum_end - cum), w = w_end o dt and
// E = B dst^T (q, P):
//
//     dM  = tril(dy x^T),                G = dM o M,
//     dx  = M^T dy + w o E,              u_j = sum_p x_jp E_jp,
//     dCB = sum_h dM o L o dt_j,         dC = dCB B,
//     dB  = dCB^T C + sum_h (x o w) dst,
//     ddt_j  = sum_i (dM o CB o L)_ij + u_j w_end_j,
//     dcum_i = sum_j G_ij - sum_k G_ki - u_i w_i   (+ sum_j u_j w_j at
//              i = q - 1, cum_end's share of w; G_ii cancels and is left
//              out of both sums, so no large G_ii rounds away dcum).
//
// The exponential is taken only where i >= j: above the diagonal it can
// overflow, and inf * 0 would be NaN; every masked value is selected to 0,
// never multiplied by 0.  Any q <= 128 (kQMax), any P and S.
//
// Two launches and no atomics, so two calls give the same bits:
//
// * heads pass, a block per (chunk, group of HG heads), 8 warps.  C B^T is
//   built once a block into shared memory; then per head and 64-column P
//   tile: dM = dy x^T on the lower triangle's m16n8 tiles (accumulated in
//   registers over the P tiles), E = B dst^T over the S tiles (the
//   accumulators of dx's tiles), u from E and x, E scaled by w, then
//   dx += M^T dy with M^T's A fragments built from C B^T, cum and dt in
//   registers (M is never stored); the state term (x o w) dst of dB for
//   each (P, S) tile, added into the group's slot of a scratch buffer the
//   wrapper allocates.  After the P tiles, dM's tiles give dCB (summed over
//   the group's heads in registers, written to scratch once a block), and
//   the row and column sums of G and dM o CB o L, reduced by fixed-order
//   shuffles and per-tile partials in shared memory, give ddt and dcum.
// * chunk pass, a block per (chunk, 32 columns of S): the groups' partial
//   dCB and state terms added in group order, then dC = dCB B and
//   dB = dCB^T C + state term, on the CUDA cores in fp32 (q^2 S per chunk,
//   under 1 % of the products).
//
// The heads pass's products run in 3xTF32 on mma.sync m16n8k8
// (csrc/tf32x3.cuh).  What bounds it on an H100: at Mamba2-2.7B's layer
// (32 chunks of 64, H = 80, P = 64, S = 128) it must read x, dy (42 MB
// each) and dst (84 MB) and write dx (42 MB): ~0.065 ms at 3.35 TB/s,
// against ~6.8 GFLOP of products, ~0.041 ms at the TF32 peak in 3xTF32.
// This first version loads each tile synchronously (cp.async, then wait),
// reloads B's S tiles per head where S > 64, and reads and writes the
// state term's partial sums once per head (L2-resident); a copy pipeline
// and wgmma are later work.
#include "ssd_tiles.cuh"

namespace {

using namespace ssd;

constexpr int kQMax = 128;           // chunk length
constexpr int kT = kPT;              // P and S tiles
constexpr int kLd = kT + 8;          // tile rows: = 8 mod 32
constexpr int kMaxSmem = 232448 - 1024;
constexpr int kS2 = 32;              // the chunk pass's S columns a block

struct Params {
  const float* x;
  const float* B;
  const float* C;
  const float* dt;
  const float* cum;
  const float* dy;
  const float* dst;
  float* dx;
  float* dB;
  float* dC;
  float* ddt;
  float* dcum;
  float* part_cb;   // [BN][G][QP][QP]: each group's dCB
  float* part_st;   // [BN][G][Q][SP]: each group's state term of dB
  int H, Q, P, S;
  int QP;           // Q rounded up to 16
  int ldcb;         // row stride of C.B^T: = 8 mod 32
  int SP;           // S rounded up to even (the state term's rows)
  int HG, G;        // heads a group, groups
  int nP, nS;       // 64-column P and S tiles
  int smem_floats;  // the heads pass's shared memory
  int vx;           // x and dy rows 16-byte aligned: cp.async of 16 bytes
  int vbc;          // B and C rows 16-byte aligned
  int vst;          // dst rows 16-byte aligned
  int vdx;          // dx in 8-byte pairs
};

// S tile sti of B (and of C where cs) into shared memory, the columns
// past S zeroed (rows past Q are zero from the block's start)
__device__ __forceinline__ void load_bc(const Params& p, long long bn,
                                        int sti, float* bs, float* cs) {
  const int s0 = sti * kT, w = min(kT, p.S - s0);
  const long long off = bn * p.Q * p.S + s0;
  load_rows(bs, kLd, p.B + off, p.S, p.Q, w, p.vbc);
  if (cs) load_rows(cs, kLd, p.C + off, p.S, p.Q, w, p.vbc);
  if (w < kT) {
    zero_cols(bs, kLd, p.Q, w, kT);
    if (cs) zero_cols(cs, kLd, p.Q, w, kT);
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float column_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// QM: the largest padded chunk the instance takes (64 or 128)
template <int QM, int MinBlocks>
__global__ void __launch_bounds__(kThreads, MinBlocks)
ssd_bwd_heads(const Params p) {
  // dM's m16n8 tiles on and below the diagonal, dealt to the warps in
  // turn; dx's tiles: a 16-row strip by 32 columns, one or two a warp
  constexpr int kStrips = QM / 16;
  constexpr int kSlotsM = (kStrips * (kStrips + 1) + kWarps - 1) / kWarps;
  constexpr int kSlotsX = QM / 64;
  extern __shared__ __align__(16) float smem[];
  const int QP = p.QP, Q = p.Q, ldcb = p.ldcb;
  float* cbs = smem;                         // QP x ldcb: C.B^T
  float* bs = cbs + QP * ldcb;               // QP x kLd: B's S tile
  float* xs = bs + QP * kLd;                 // QP x kLd: x's P tile (C's
                                             // S tile while C.B^T is built)
  float* dys = xs + QP * kLd;                // QP x kLd: dy's P tile
  float* dsts = dys + QP * kLd;              // kT x kLd: dst's (P, S) tile
  float* cum = dsts + kT * kLd;              // QP: the head's cum
  float* dt = cum + QP;                      // QP
  float* wend = dt + QP;                     // QP: exp(cum_end - cum)
  float* w = wend + QP;                      // QP: w_end dt
  float* uw = w + QP;                        // QP: u w
  float* rowg = uw + QP;                     // QP/8 x QP: G's row sums by
                                             // column tile
  float* colg = rowg + (QP / 8) * QP;        // QP/16 x QP: G's column sums
                                             // by row strip
  float* colt = colg + (QP / 16) * QP;       // QP/16 x QP: dM CB L's
  float* upart = colt + (QP / 16) * QP;      // 2 x QP: u by 32-column half
                                             // of the P tile
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long bn = blockIdx.x;           // b * nc + n
  const int grp = blockIdx.y;
  const int h0 = grp * p.HG, hg = min(p.HG, p.H - h0);
  const int nstrips = QP / 16;

  // rows past Q of every tile, and cum, dt, w past Q, stay zero: the
  // loads write rows < Q only
  for (int e = threadIdx.x; e < p.smem_floats; e += kThreads) smem[e] = 0.f;
  __syncthreads();

  // ---- C.B^T, once a block: items (16-row strip r, 32-column group) ----
  const int ncg = (QP + 31) / 32;
  for (int sti = 0; sti < p.nS; ++sti) {
    if (sti) __syncthreads();   // the last S tile is read
    load_bc(p, bn, sti, bs, xs);
    tf32x3::cp_async_commit();
    tf32x3::cp_async_wait<0>();
    __syncthreads();
    for (int it = warp; it < nstrips * ncg; it += kWarps) {
      const int r = it / ncg, c0 = 32 * (it - r * ncg);
      if (c0 > 16 * r + 15) continue;   // wholly above the diagonal
      const int nj = min(4, (QP - c0) / 8);
      float acc[4][4] = {};
      for (int ks = 0; ks < kT / 8; ++ks) {
        const tf32x3::Frag<4> a =
            tf32x3::load_a<true>(xs, kLd, 16 * r, 8 * ks, lane);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < nj)
            tf32x3::mma3(acc[j], a,
                         tf32x3::load_bt<true>(bs, kLd, c0 + 8 * j, 8 * ks,
                                               lane));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= nj) break;
        float* o = cbs + (16 * r + g) * ldcb + c0 + 8 * j + 2 * t;
        float2 lo = make_float2(acc[j][0], acc[j][1]);
        float2 hi = make_float2(acc[j][2], acc[j][3]);
        if (sti) {
          const float2 l0 = *reinterpret_cast<float2*>(o);
          const float2 h0v = *reinterpret_cast<float2*>(o + 8 * ldcb);
          lo.x += l0.x; lo.y += l0.y; hi.x += h0v.x; hi.y += h0v.y;
        }
        *reinterpret_cast<float2*>(o) = lo;
        *reinterpret_cast<float2*>(o + 8 * ldcb) = hi;
      }
    }
  }
  // C.B^T built; C's space is x's from here (each x tile load writes
  // its columns and zeroes the rest)

  // this warp's dM tiles (strip mr, column tile mc; mr < 0: none), and
  // its dx strips (xr; the 32-column half xc of the P tile)
  int mr[kSlotsM], mc[kSlotsM];
#pragma unroll
  for (int s = 0; s < kSlotsM; ++s) {
    const int k = warp + kWarps * s;
    mr[s] = -1;
    mc[s] = 0;
    if (k < nstrips * (nstrips + 1)) {
      int r = 0;
      while ((r + 1) * (r + 2) <= k) ++r;
      mr[s] = r;
      mc[s] = k - r * (r + 1);
    }
  }
  int xr[kSlotsX];
  const int xc = warp & 1;
  xr[0] = (warp >> 1) < nstrips ? (warp >> 1) : -1;
  if constexpr (kSlotsX > 1) {
    const int r1 = nstrips - 1 - (warp >> 1);
    xr[kSlotsX - 1] = r1 >= 4 ? r1 : -1;   // strips past the first four
  }
  float dcb[kSlotsM][4] = {};   // the group's dCB, summed over its heads
  float* part_st = p.part_st + (bn * p.G + grp) * (long long)Q * p.SP;

  for (int hh = 0; hh < hg; ++hh) {
    const int h = h0 + hh;
    __syncthreads();   // the last head's readers are done
    for (int j = threadIdx.x; j < Q; j += kThreads) {
      cum[j] = p.cum[(bn * Q + j) * p.H + h];
      dt[j] = p.dt[(bn * Q + j) * p.H + h];
    }
    __syncthreads();
    const float cend = cum[Q - 1];
    for (int j = threadIdx.x; j < Q; j += kThreads) {
      const float we = __expf(cend - cum[j]);
      wend[j] = we;
      w[j] = we * dt[j];
    }
    float dm[kSlotsM][4] = {};
    for (int pi = 0; pi < p.nP; ++pi) {
      const int p0 = pi * kT, pw = min(kT, p.P - p0);
      __syncthreads();   // the last tiles are read; w is written
      const long long xo = (bn * Q * p.H + h) * (long long)p.P + p0;
      load_rows(xs, kLd, p.x + xo, (long long)p.H * p.P, Q, pw, p.vx);
      load_rows(dys, kLd, p.dy + xo, (long long)p.H * p.P, Q, pw, p.vx);
      if (pw < kT) {
        zero_cols(xs, kLd, Q, pw, kT);
        zero_cols(dys, kLd, Q, pw, kT);
      }
      tf32x3::cp_async_commit();
      tf32x3::cp_async_wait<0>();
      __syncthreads();
      const int kp = (pw + 7) / 8;

      // dM += dy x^T over this P tile
#pragma unroll
      for (int s = 0; s < kSlotsM; ++s) {
        if (mr[s] < 0) continue;
        for (int ks = 0; ks < kp; ++ks)
          tf32x3::mma3(dm[s],
                       tf32x3::load_a<true>(dys, kLd, 16 * mr[s], 8 * ks,
                                            lane),
                       tf32x3::load_bt<true>(xs, kLd, 8 * mc[s], 8 * ks,
                                             lane));
      }

      // E = B dst^T into dx's accumulators, and the state term of dB
      float ex[kSlotsX][4][4] = {};
      for (int si = 0; si < p.nS; ++si) {
        const int s0 = si * kT, sw = min(kT, p.S - s0);
        if (si) __syncthreads();   // the last dst (and B) tile is read
        if (p.nS > 1) load_bc(p, bn, si, bs, nullptr);
        load_rows(dsts, kLd,
                  p.dst + ((bn * p.H + h) * (long long)p.P + p0) * p.S + s0,
                  p.S, pw, sw, p.vst);
        if (sw < kT) zero_cols(dsts, kLd, pw, sw, kT);
        if (pw < kT) zero_cols(dsts + pw * kLd, kLd, kT - pw, 0, kT);
        tf32x3::cp_async_commit();
        tf32x3::cp_async_wait<0>();
        __syncthreads();
        const int kss = (sw + 7) / 8;
#pragma unroll
        for (int s = 0; s < kSlotsX; ++s) {
          if (xr[s] < 0) continue;
          for (int ks = 0; ks < kss; ++ks) {
            const tf32x3::Frag<4> a =
                tf32x3::load_a<true>(bs, kLd, 16 * xr[s], 8 * ks, lane);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              tf32x3::mma3(ex[s][nt], a,
                           tf32x3::load_bt<true>(dsts, kLd,
                                                 32 * xc + 8 * nt, 8 * ks,
                                                 lane));
          }
        }
        // (x o w) dst: items (strip, 32-column half of the S tile)
        const bool first = hh == 0 && pi == 0;
        for (int it = warp; it < nstrips * 2; it += kWarps) {
          const int r = it >> 1, ng = it & 1;
          if (32 * ng >= sw) continue;
          const int j0 = 16 * r + g, j1 = j0 + 8;
          const float w0 = w[j0], w1 = w[j1];
          float acc[4][4] = {};
          for (int ks = 0; ks < kp; ++ks) {
            const int pc = 8 * ks + 2 * t;
            const float2 lo = *reinterpret_cast<const float2*>(
                xs + j0 * kLd + pc);
            const float2 hi = *reinterpret_cast<const float2*>(
                xs + j1 * kLd + pc);
            const float v[4] = {lo.x * w0, hi.x * w1, lo.y * w0, hi.y * w1};
            tf32x3::Frag<4> a;
            tf32x3::split_fast(a, v);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              tf32x3::mma3(acc[nt], a,
                           tf32x3::load_b<true>(dsts, kLd, 8 * ks,
                                                32 * ng + 8 * nt, lane));
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int col = s0 + 32 * ng + 8 * nt + 2 * t;
            if (col >= p.S) continue;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int j = half ? j1 : j0;
              if (j >= Q) continue;
              float2* o = reinterpret_cast<float2*>(
                  part_st + (long long)j * p.SP + col);
              float2 v = make_float2(acc[nt][2 * half],
                                     acc[nt][2 * half + 1]);
              if (!first) {
                const float2 old = *o;
                v.x += old.x;
                v.y += old.y;
              }
              *o = v;
            }
          }
        }
      }

      // u from E and x; then dx = w o E + M^T dy
#pragma unroll
      for (int s = 0; s < kSlotsX; ++s) {
        if (xr[s] < 0) continue;
        const int r = xr[s], j0 = 16 * r + g, j1 = j0 + 8;
        float u0 = 0.f, u1 = 0.f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int pc = 32 * xc + 8 * nt + 2 * t;
          u0 += xs[j0 * kLd + pc] * ex[s][nt][0]
                + xs[j0 * kLd + pc + 1] * ex[s][nt][1];
          u1 += xs[j1 * kLd + pc] * ex[s][nt][2]
                + xs[j1 * kLd + pc + 1] * ex[s][nt][3];
        }
        u0 = quad_sum(u0);
        u1 = quad_sum(u1);
        if (t == 0) {
          upart[xc * QP + j0] = (pi ? upart[xc * QP + j0] : 0.f) + u0;
          upart[xc * QP + j1] = (pi ? upart[xc * QP + j1] : 0.f) + u1;
        }
        const float w0 = w[j0], w1 = w[j1];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          ex[s][nt][0] *= w0;
          ex[s][nt][1] *= w0;
          ex[s][nt][2] *= w1;
          ex[s][nt][3] *= w1;
        }
        const float cj0 = cum[j0], cj1 = cum[j1];
        const float dj0 = dt[j0], dj1 = dt[j1];
        for (int ks = 2 * r; ks < QP / 8; ++ks) {
          // M^T's A fragment: row j, column i, = M[i, j], for j <= i < Q
          const int i0 = 8 * ks + 2 * t, i1 = i0 + 1;
          const float ci0 = cum[i0], ci1 = cum[i1];
          const float v[4] = {
              decay(cbs[i0 * ldcb + j0], ci0, cj0, dj0, i0 >= j0 && i0 < Q),
              decay(cbs[i0 * ldcb + j1], ci0, cj1, dj1, i0 >= j1 && i0 < Q),
              decay(cbs[i1 * ldcb + j0], ci1, cj0, dj0, i1 >= j0 && i1 < Q),
              decay(cbs[i1 * ldcb + j1], ci1, cj1, dj1, i1 >= j1 && i1 < Q)};
          tf32x3::Frag<4> a;
          tf32x3::split_fast(a, v);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            tf32x3::mma3(ex[s][nt], a,
                         tf32x3::load_b<true>(dys, kLd, 8 * ks,
                                              32 * xc + 8 * nt, lane));
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = p0 + 32 * xc + 8 * nt + 2 * t;
          if (j0 < Q)
            store2(p.dx, ((bn * Q + j0) * p.H + h) * (long long)p.P + col,
                   col, p.P, ex[s][nt][0], ex[s][nt][1], p.vdx);
          if (j1 < Q)
            store2(p.dx, ((bn * Q + j1) * p.H + h) * (long long)p.P + col,
                   col, p.P, ex[s][nt][2], ex[s][nt][3], p.vdx);
        }
      }
    }

    // dM's tiles: dCB's share, and the row and column sums of G = dM o M
    // and of dM o CB o L, per tile, reduced in a fixed order
#pragma unroll
    for (int s = 0; s < kSlotsM; ++s) {
      if (mr[s] < 0) continue;
      const int r = mr[s], c = mc[s];
      const int i0 = 16 * r + g, j0 = 8 * c + 2 * t;
      const float ci[2] = {cum[i0], cum[i0 + 8]};
      const float cj[2] = {cum[j0], cum[j0 + 1]};
      const float dj[2] = {dt[j0], dt[j0 + 1]};
      float rg[2] = {0.f, 0.f}, cg[2] = {0.f, 0.f}, ct[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 4; ++e) {   // (i0, j0), (i0, j1), (i1, j0), (i1, j1)
        const int a = e >> 1, b = e & 1;
        const int i = i0 + 8 * a, j = j0 + b;
        const bool on = i >= j && i < Q;
        const float L = on ? __expf(ci[a] - cj[b]) : 0.f;
        const float d = on ? dm[s][e] : 0.f;
        const float dl = d * L;
        dcb[s][e] += dl * dj[b];
        const float tv = dl * cbs[i * ldcb + j];   // dM CB L
        const float gv = tv * dj[b];               // dM M
        if (i != j) {   // G_ii enters both sums and cancels
          rg[a] += gv;
          cg[b] += gv;
        }
        ct[b] += tv;
      }
      rg[0] = quad_sum(rg[0]);
      rg[1] = quad_sum(rg[1]);
      if (t == 0) {
        rowg[c * QP + i0] = rg[0];
        rowg[c * QP + i0 + 8] = rg[1];
      }
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        cg[b] = column_sum(cg[b]);
        ct[b] = column_sum(ct[b]);
      }
      if (g == 0) {
        colg[r * QP + j0] = cg[0];
        colg[r * QP + j0 + 1] = cg[1];
        colt[r * QP + j0] = ct[0];
        colt[r * QP + j0 + 1] = ct[1];
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < Q; j += kThreads)
      uw[j] = (upart[j] + upart[QP + j]) * w[j];
    __syncthreads();
    for (int j = threadIdx.x; j < Q; j += kThreads) {
      const int r = j / 16, c = j / 8;
      float rs = 0.f, cs = 0.f, cts = 0.f;
      for (int cc = 0; cc <= 2 * r + 1; ++cc) rs += rowg[cc * QP + j];
      for (int rr = c / 2; rr < nstrips; ++rr) {
        cs += colg[rr * QP + j];
        cts += colt[rr * QP + j];
      }
      float dc = rs - cs - uw[j];
      if (j == Q - 1) {
        float tot = 0.f;
        for (int k = 0; k < Q; ++k) tot += uw[k];
        dc += tot;
      }
      const long long o = (bn * Q + j) * p.H + h;
      p.ddt[o] = cts + (upart[j] + upart[QP + j]) * wend[j];
      p.dcum[o] = dc;
    }
  }

  // the group's dCB, once
  float* pc = p.part_cb + (bn * p.G + grp) * (long long)QP * QP;
#pragma unroll
  for (int s = 0; s < kSlotsM; ++s) {
    if (mr[s] < 0) continue;
    const int i0 = 16 * mr[s] + g, j0 = 8 * mc[s] + 2 * t;
    *reinterpret_cast<float2*>(pc + i0 * QP + j0) =
        make_float2(dcb[s][0], dcb[s][1]);
    *reinterpret_cast<float2*>(pc + (i0 + 8) * QP + j0) =
        make_float2(dcb[s][2], dcb[s][3]);
  }
}

// per (chunk, 32 columns of S): dCB and the state term summed over the
// groups in group order, then dC = dCB B and dB = dCB^T C + state term
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk(const Params p) {
  extern __shared__ __align__(16) float sm[];
  const int Q = p.Q, ld = Q + 1, QP = p.QP;
  float* dcb = sm;                 // Q x (Q + 1)
  float* bt = dcb + Q * ld;        // Q x kS2: B's columns
  float* ctile = bt + Q * kS2;     // Q x kS2: C's
  const long long bn = blockIdx.x;
  const int s0 = blockIdx.y * kS2, sw = min(kS2, p.S - s0);
  const float* pc = p.part_cb + bn * p.G * (long long)QP * QP;
  for (int e = threadIdx.x; e < Q * Q; e += kThreads) {
    const int i = e / Q, j = e - i * Q;
    float v = 0.f;
    if (j <= i)   // above the diagonal dCB is 0 (and not written)
      for (int gi = 0; gi < p.G; ++gi)
        v += pc[(long long)gi * QP * QP + i * QP + j];
    dcb[i * ld + j] = v;
  }
  for (int e = threadIdx.x; e < Q * kS2; e += kThreads) {
    const int r = e / kS2, c = e - r * kS2;
    const bool in = c < sw;
    const long long o = (bn * Q + r) * p.S + s0 + c;
    bt[e] = in ? p.B[o] : 0.f;
    ctile[e] = in ? p.C[o] : 0.f;
  }
  __syncthreads();
  const float* ps = p.part_st + bn * p.G * (long long)Q * p.SP;
  for (int e = threadIdx.x; e < Q * kS2; e += kThreads) {
    const int r = e / kS2, c = e - r * kS2;
    if (c >= sw) continue;
    float a = 0.f;
    for (int j = 0; j <= r; ++j) a += dcb[r * ld + j] * bt[j * kS2 + c];
    float b = 0.f;
    for (int i = r; i < Q; ++i) b += dcb[i * ld + r] * ctile[i * kS2 + c];
    for (int gi = 0; gi < p.G; ++gi)
      b += ps[((long long)gi * Q + r) * p.SP + s0 + c];
    const long long o = (bn * Q + r) * p.S + s0 + c;
    p.dC[o] = a;
    p.dB[o] = b;
  }
}

// the heads pass's shared memory, in floats: C.B^T, the B, x, dy and dst
// tiles, five vectors, the row and column partial sums, u's halves
long long heads_floats(int QP, int ldcb) {
  return (long long)QP * ldcb + 3ll * QP * kLd + kT * kLd + 5ll * QP +
         (QP / 8) * QP + 2ll * (QP / 16) * QP + 2ll * QP;
}

long long chunk_smem(int Q) { return 4ll * (Q * (Q + 1) + 2 * Q * kS2); }

struct Plan {
  int QP, ldcb, SP, HG, G, blocks_per_sm;
  long long smem;
};

// heads a group: the HG that minimises whole waves x a block's work (HG
// heads plus its C.B^T, in multiply-adds)
Plan plan(int BN, int H, int Q, int P, int S) {
  Plan pl;
  pl.QP = (Q + 15) / 16 * 16;
  pl.ldcb = (pl.QP + 31) / 32 * 32 + 8;
  pl.SP = (S + 1) / 2 * 2;
  pl.smem = 4 * heads_floats(pl.QP, pl.ldcb);
  pl.blocks_per_sm = (pl.QP <= 64 && 2 * (pl.smem + 1024) <= 233472) ? 2 : 1;
  const double qp = pl.QP, pp = (P + 7) / 8 * 8.0, sp = (S + 7) / 8 * 8.0;
  const double head = qp * qp * pp + 2.0 * qp * pp * sp;
  const double cb = qp * qp * sp / 2 + qp * sp;
  const long long slots = (long long)pl.blocks_per_sm * sm_count();
  pl.HG = 1;
  double best = 0;
  for (int hg = 1; hg <= H; ++hg) {
    const long long blocks = (long long)BN * ((H + hg - 1) / hg);
    const double waves = (double)((blocks + slots - 1) / slots);
    const double cost = waves * (hg * head + cb);
    if (hg == 1 || cost < best) {
      pl.HG = hg;
      best = cost;
    }
  }
  pl.G = (H + pl.HG - 1) / pl.HG;
  return pl;
}

template <typename K>
cudaError_t set_smem(K kernel, long long smem, long long* attr_set) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (attr_set[dev] < smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    attr_set[dev] = smem;
  }
  return cudaSuccess;
}

template <int QM, int MinBlocks>
cudaError_t launch_heads(const Params& p, long long smem, dim3 grid,
                         cudaStream_t stream) {
  static long long attr_set[64];
  const cudaError_t err = set_smem(ssd_bwd_heads<QM, MinBlocks>, smem,
                                   attr_set);
  if (err != cudaSuccess) return err;
  ssd_bwd_heads<QM, MinBlocks><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// floats of scratch a call takes: each group's partial dCB and state term
extern "C" long long ssd_chunk_backward_scratch(int BN, int H, int Q, int P,
                                                int S) {
  if (BN < 1 || H < 1 || Q < 1 || Q > kQMax || P < 1 || S < 1) return 0;
  const Plan pl = plan(BN, H, Q, P, S);
  return (long long)BN * pl.G *
         ((long long)pl.QP * pl.QP + (long long)Q * pl.SP);
}

extern "C" int ssd_chunk_backward(const float* x, const float* Bm,
                                  const float* Cm, const float* dt,
                                  const float* cum, const float* dy,
                                  const float* dst, float* dx, float* dB,
                                  float* dC, float* ddt, float* dcum,
                                  float* scratch, int BN, int H, int Q,
                                  int P, int S, void* stream) {
  if (BN < 1 || H < 1 || Q < 1 || Q > kQMax || P < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  const Plan pl = plan(BN, H, Q, P, S);
  if (pl.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.B = Bm;
  p.C = Cm;
  p.dt = dt;
  p.cum = cum;
  p.dy = dy;
  p.dst = dst;
  p.dx = dx;
  p.dB = dB;
  p.dC = dC;
  p.ddt = ddt;
  p.dcum = dcum;
  p.part_cb = scratch;
  p.part_st = scratch + (long long)BN * pl.G * pl.QP * pl.QP;
  p.H = H;
  p.Q = Q;
  p.P = P;
  p.S = S;
  p.QP = pl.QP;
  p.ldcb = pl.ldcb;
  p.SP = pl.SP;
  p.HG = pl.HG;
  p.G = pl.G;
  p.nP = (P + kT - 1) / kT;
  p.nS = (S + kT - 1) / kT;
  p.smem_floats = (int)(pl.smem / 4);
  auto al = [](const void* a, int n) {
    return (reinterpret_cast<uintptr_t>(a) & (n - 1)) == 0;
  };
  p.vx = al(x, 16) && al(dy, 16) && P % 4 == 0;
  p.vbc = al(Bm, 16) && al(Cm, 16) && S % 4 == 0;
  p.vst = al(dst, 16) && S % 4 == 0;
  p.vdx = al(dx, 8) && P % 2 == 0;
  const cudaStream_t sm = (cudaStream_t)stream;
  const dim3 grid1((unsigned)BN, (unsigned)pl.G);
  cudaError_t err = pl.QP <= 64
                        ? (pl.blocks_per_sm == 2
                               ? launch_heads<64, 2>(p, pl.smem, grid1, sm)
                               : launch_heads<64, 1>(p, pl.smem, grid1, sm))
                        : launch_heads<128, 1>(p, pl.smem, grid1, sm);
  if (err != cudaSuccess) return (int)err;
  static long long attr_set[64];
  const long long smem2 = chunk_smem(Q);
  err = set_smem(ssd_bwd_chunk, smem2, attr_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid2((unsigned)BN, (unsigned)((S + kS2 - 1) / kS2));
  ssd_bwd_chunk<<<grid2, kThreads, smem2, sm>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* ssd_chunk_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
