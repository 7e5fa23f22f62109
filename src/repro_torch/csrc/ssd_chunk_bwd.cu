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
// never multiplied by 0.  Any q, any P and S, operands at any 4-byte
// offset: q <= 128 (kQMax) on the route below; longer chunks on the tiled
// route at the end of this file.
//
// What bounds it on an H100: at Mamba2-2.7B's layer (32 chunks of 64,
// H = 80, P = 64, S = 128) it must read x, dy (42 MB each) and dst
// (84 MB) and write dx (42 MB): 0.0646 ms at 3.35 TB/s.  Its products are
// ~6.8 GFLOP, 20.3 GFLOP of TF32 in 3xTF32 (0.041 ms at the TF32 peak;
// mma.sync m16n8k8 costs ~8.7 cycles a scheduler, about half the peak), so
// copies and products take about as long and must overlap.  Two launches
// and no atomics, so two calls give the same bits:
//
// * heads pass, a block per (chunk, group of HG heads), 16 warps in two
//   groups of 8, one block an SM: the X warps compute E = B dst^T and dx,
//   the D warps dB's state term and dM, side by side.  C B^T is built once
//   a block.  The block then walks the group's units (head, T columns of
//   P) in steps of T columns of S, one __syncthreads a step.  Two streams
//   of cp.async copies run ahead in double buffers: a step's dst tile is
//   issued when the step before starts, across units, and a unit's x, dy,
//   cum and dt when the unit before starts.
//   - a head's first step: the D warps form its w_end, w and (chunk <= 64)
//     L = exp(cum_i - cum_j) once, the X warps finish the last head's ddt
//     and dcum (beside the products, not in a step of their own);
//   - each step: X: E's share of the S tile into dx's accumulators (each
//     warp the 16-row strips r and n - 1 - r by 16 columns); D: the state
//     term (x o w) dst's columns of the S tile (a strip by 32 columns a
//     warp), added into a q x S accumulator in shared memory that lives
//     across the group's heads, or where it does not fit into the group's
//     scratch slot;
//   - a unit's last step, then: X: u from E and x, E scaled by w, and
//     dx += M^T dy with M^T's fragments from C B^T, L and dt (M is never
//     stored; the strip pairing gives every X warp as many k-steps); D:
//     dM = dy x^T on the lower triangle's m16n8 tiles, three at a time, its
//     share of dCB (in registers across the group's heads, written once a
//     block) and the row and column sums of G and dM o CB o L by tile.
// * chunk pass, a block per (chunk, 64 columns of S, 32 rows): the groups'
//   dCB rows and columns and state terms added in group order, then
//   dC = dCB B and dB = dCB^T C + state term, on the CUDA cores in fp32.
//
// Shared memory, in floats (QP = q rounded to 16; T = 64 at QP <= 64, else
// 32; LD = T + 8): C B^T, and L at QP <= 64, as the lower triangle's
// strips (cb_off(QP / 16) each); B resident, QP (nS T + 8), where it fits,
// else its S tile in each D stage; the state term's accumulator
// QP (nS T + 8) where it fits after that; the U ring 2 (2 QP LD + 2 QP);
// the D ring 2 T LD; the vectors (4 + T / 16 + QP / 8 + QP / 8) QP.  At
// Mamba2-2.7B's P = 64, S = 128: at q = 64, 3328 + 3328 + 8704 + 8704 +
// 18688 + 9216 + 1536 = 53504 (214 KB), all on chip; at q = 128, 10752 +
// 17408 + 20992 + 2560 + 4864 = 56576 (226 KB): B stays, the state term
// goes through scratch and L is taken in registers.  Either way 227 KB
// holds one block an SM, so its 16 warps (128 registers a thread) are all
// an SM runs; plan() picks HG for whole waves of such blocks.
//
// Choices by measurement (tools/ssd_chunk_variants.py --backward, the
// layer): the copy pipeline is worth 8 % (sync_copies), B resident 4 %
// (b_reload), the state term on chip 4 % (st_through_scratch), L in shared
// memory 8 % (l_regs).  Bulk copies a tile row (cp.async.bulk on an
// mbarrier a stage, issued by one warp) took 0.432 ms against cp.async's
// 0.327: cp.async stays.  A tensor-map TMA needs swizzled tiles and
// fragment loads to match, and wgmma in TF32 K-major operands with big and
// small parts in shared memory: later work.  What holds it at ~20 % of its
// bound is the warps' own latency, four a scheduler: with no copies at all
// it is 11 % faster, with one TF32 pass in place of three 20 %.
//
// The tiled route (q > kQMax, where C.B^T alone passes 64 KB): the
// forward's tiled route's tiles (ssd_tiles.cuh, namespace tiled), fp32 on
// the CUDA cores, the same two passes, no scratch and no atomics; no
// speed sought.
// * heads pass, a block per (chunk, head, 64-row tile t): as columns j of
//   t, over the row tiles i >= t, C.B^T's and dM's tiles (over S and P),
//   M, the column sums of dM o CB o L and of G, and dx_j += M^T dy_i; then
//   E = B dst^T of its rows, dx += w E and u; as rows i of t, over the
//   column tiles j <= t, the row sums of G; the last tile's block also
//   sums u_j w_j over the chunk, tile by tile in order.
// * chunk pass, a block per (chunk, dC or dB, 64-row tile, 128 columns of
//   S): dCB's tiles summed over the heads in order, dC_i = sum_j dCB_ij
//   B_j and dB_j = sum_i dCB_ij C_i + sum_h (x o w) dst_h.
#include "ssd_tiles.cuh"

namespace {

using namespace ssd;

constexpr int kQMax = 128;           // chunk length
constexpr int kWarpsH = 16;          // the heads pass: X warps, then D warps
constexpr int kThreadsH = kWarpsH * 32;
constexpr int kMaxSmem = 232448 - 1024;
constexpr int kS2 = 64;              // the chunk pass's S columns a block
constexpr int kR2 = 32;              // and its rows

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
  int cbf;          // C.B^T's (and L's) floats: cb_off(QP / 16)
  int SP;           // S rounded up to even (the state term's rows)
  int HG, G;        // heads a group, groups
  int nP, nS;       // T-column P and S tiles
  int b_res, ldb;   // B resident (row stride ldb), else in the D ring
  int st_res, ldst; // the state term in shared memory, else in scratch
  // offsets in floats: L, B, the state term, the U ring, the D ring, the
  // vectors; the rings' stage sizes
  int o_l, o_b, o_st, o_u, o_d, o_v, u_stage, d_stage;
  int smem_floats;  // the heads pass's shared memory
  int vx;           // x and dy rows 16-byte aligned: cp.async of 16 bytes
  int vbc;          // B and C rows 16-byte aligned
  int vst;          // dst rows 16-byte aligned
  int vdx;          // dx in 8-byte pairs
};

// C.B^T and L keep the lower triangle's 16-row strips: strip r's rows hold
// its 16 (r + 1) columns, padded to cb_ld(r) floats (= 4 mod 32: M^T's
// fragments read them across rows without a bank conflict)
__host__ __device__ __forceinline__ int cb_ld(int r) {
  return 32 * ((r + 2) / 2) + 4;
}

// the first float of strip r: 16 sum_{r' < r} cb_ld(r')
__host__ __device__ __forceinline__ int cb_off(int r) {
  const int m = r / 2, s = (r & 1) ? (m + 1) * (m + 1) : m * (m + 1);
  return 16 * (4 * r + 32 * s);
}

__device__ __forceinline__ int cb_row(int i) {
  return cb_off(i >> 4) + (i & 15) * cb_ld(i >> 4);
}

// x and dy's P tile at p0 of head h, and the head's cum and dt, into a U
// stage (rows past Q stay zero: the copies write rows < Q only)
template <int T>
__device__ __forceinline__ void load_unit(const Params& p, long long bn,
                                          int h, int p0, float* xs,
                                          float* dys, float* cum,
                                          float* dt) {
  const int pw = min(T, p.P - p0);
  const long long o = (bn * p.Q * p.H + h) * (long long)p.P + p0;
  const long long rs = (long long)p.H * p.P;
  load_rows<kThreadsH>(xs, T + 8, p.x + o, rs, p.Q, pw, p.vx);
  load_rows<kThreadsH>(dys, T + 8, p.dy + o, rs, p.Q, pw, p.vx);
  if (pw < T) {
    zero_cols<kThreadsH>(xs, T + 8, p.Q, pw, T);
    zero_cols<kThreadsH>(dys, T + 8, p.Q, pw, T);
  }
  const int e = threadIdx.x;
  if (e < p.Q)
    tf32x3::cp_async4(cum + e, p.cum + (bn * p.Q + e) * p.H + h);
  else if (e >= kQMax && e < kQMax + p.Q)
    tf32x3::cp_async4(dt + e - kQMax,
                      p.dt + (bn * p.Q + e - kQMax) * p.H + h);
}

// B's S tile at s0 into bt (row stride ld), its columns past S zeroed:
// E and C.B^T sum over them, and the other operand's are not zeroed
template <int T>
__device__ __forceinline__ void load_b_tile(const Params& p, long long bn,
                                            int s0, float* bt, int ld) {
  const int w = min(T, p.S - s0);
  load_rows<kThreadsH>(bt, ld, p.B + bn * p.Q * p.S + s0, p.S, p.Q, w,
                       p.vbc);
  if (w < T) zero_cols<kThreadsH>(bt, ld, p.Q, w, T);
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

// the m16n8 tiles on and below the diagonal, strip by strip: tile k's
// strip (its column tile is k - r (r + 1))
__device__ __forceinline__ int tile_strip(int k) {
  int r = 0;
  while ((r + 1) * (r + 2) <= k) ++r;
  return r;
}

// ddt and dcum of one head (row j at o + j H) from the sums its units
// left: row j by thread j (Q <= kQMax), and cum_end's share of w,
// sum_k u_k w_k, by the warp holding row Q - 1 (lanes in fixed strides,
// then a butterfly).  Not inlined: it runs once a head, and out of the
// steps' loop the heads pass at chunk 128 takes 122 registers, not 128.
template <int QM>
__device__ __noinline__ void finish(float* ddt, float* dcum, long long o,
                                    int H, int Q, int QP,
                                    const float* upart, const float* rowg,
                                    const float* colg, const float* colt,
                                    const float* w, const float* wend) {
  constexpr int kNcg = (QM == 64 ? 64 : 32) / 16;
  const int j = threadIdx.x, lane = j & 31, nstrips = QP / 16;
  float tot = 0.f;
  if (j >> 5 == (Q - 1) >> 5) {
    for (int k = lane; k < Q; k += 32) {
      float uk = 0.f;
#pragma unroll
      for (int cg = 0; cg < kNcg; ++cg) uk += upart[cg * QP + k];
      tot += uk * w[k];
    }
#pragma unroll
    for (int s = 16; s; s >>= 1) tot += __shfl_xor_sync(0xffffffffu, tot, s);
  }
  if (j >= Q) return;
  const int r = j / 16, c = j / 8;
  float us = 0.f;
#pragma unroll
  for (int cg = 0; cg < kNcg; ++cg) us += upart[cg * QP + j];
  // the sums in a fixed order, unrolled to the chunk's largest shape so
  // the loads issue together
  float rs = 0.f, cs = 0.f, cts = 0.f;
#pragma unroll
  for (int cc = 0; cc < QM / 8; ++cc)
    if (cc <= 2 * r + 1) rs += rowg[cc * QP + j];
#pragma unroll
  for (int rr = 0; rr < QM / 16; ++rr)
    if (rr >= c / 2 && rr < nstrips) {
      cs += colg[rr * QP + j];
      cts += colt[rr * QP + j];
    }
  float dc = rs - cs - us * w[j];
  if (j == Q - 1) dc += tot;
  ddt[o + (long long)j * H] = cts + us * wend[j];
  dcum[o + (long long)j * H] = dc;
}

// QM: the largest padded chunk the instance takes (64 or 128)
template <int QM>
__global__ void __launch_bounds__(kThreadsH, 1)
ssd_bwd_heads(const Params p) {
  constexpr int T = QM == 64 ? 64 : 32;      // P and S tiles
  constexpr int LD = T + 8;                  // tile rows: = 8 mod 32
  constexpr bool kL = QM == 64;              // L in shared memory
  constexpr int kNcg = T / 16;               // X warps' column groups
  constexpr int kStrips = QM / 16;
  constexpr int kSlotsM = (kStrips * (kStrips + 1) + 7) / 8;
  constexpr int kKeep = kSlotsM > 4 ? kSlotsM : 4;
  extern __shared__ __align__(16) float smem[];
  const int QP = p.QP, Q = p.Q, nS = p.nS, nP = p.nP;
  float* cbs = smem;                         // C.B^T's strips (cb_row)
  float* Lm = smem + p.o_l;                  // the head's L, the same way
  float* bres = smem + p.o_b;                // QP x ldb: B, if resident
  float* sta = smem + p.o_st;                // QP x ldst: the state term
  float* ubase = smem + p.o_u;               // 2 x (x, dy, cum, dt)
  float* dbase = smem + p.o_d;               // 2 x (dst, [B's S tile])
  float* wend2 = smem + p.o_v;               // 2 x QP: exp(cum_end - cum)
  float* w2 = wend2 + 2 * QP;                // 2 x QP: w_end dt
  float* upart = w2 + 2 * QP;                // kNcg x QP: u by column group
  float* rowg = upart + kNcg * QP;           // QP/8 x QP: G's row sums by
                                             // column tile
  float* colg = rowg + (QP / 8) * QP;        // QP/16 x QP: G's column sums
                                             // by row strip
  float* colt = colg + (QP / 16) * QP;       // QP/16 x QP: dM CB L's
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool xw = warp < 8;                  // an X warp, else a D warp
  const int gw = warp & 7;
  const long long bn = blockIdx.x;           // b * nc + n
  const int grp = blockIdx.y;
  const int h0 = grp * p.HG, hg = min(p.HG, p.H - h0);
  const int nstrips = QP / 16, ntiles = nstrips * (nstrips + 1);
  const int units = hg * nP, steps = units * nS;

  // rows past Q of every tile, and cum, dt past Q, stay zero: the loads
  // write rows < Q only; the state term's accumulator starts at zero
  for (int e = threadIdx.x; e < p.smem_floats; e += kThreadsH) smem[e] = 0.f;
  __syncthreads();

  // Two streams of copies into double buffers: unit it + 1's x, dy, cum
  // and dt, issued when unit it starts, and the steps' dst tiles (and B's
  // S tiles), step d + 1's when step d starts, across units.  A unit's
  // first step commits its tile's group, then the next unit's; the other
  // steps one group (each empty at the ends), so a step waits for its own
  // copies with a fixed count.
  auto issue_unit = [&](int it) {
    const int hh = it / nP, pi = it - hh * nP;
    float* xs = ubase + (it & 1) * p.u_stage;
    load_unit<T>(p, bn, h0 + hh, pi * T, xs, xs + QP * LD, xs + 2 * QP * LD,
                 xs + 2 * QP * LD + QP);
  };
  auto issue_tile = [&](int d) {
    const int it = d / nS, si = d - it * nS;
    const int hh = it / nP, pi = it - hh * nP, h = h0 + hh;
    const int s0 = si * T, p0 = pi * T;
    float* ds = dbase + (d & 1) * p.d_stage;
    load_rows<kThreadsH>(
        ds, LD, p.dst + ((bn * p.H + h) * (long long)p.P + p0) * p.S + s0,
        p.S, min(T, p.P - p0), min(T, p.S - s0), p.vst);
    if (!p.b_res) load_b_tile<T>(p, bn, s0, ds + T * LD, LD);
  };
  // at step d: the copies each stream runs ahead
  auto prefetch = [&](int d) {
    if (d + 1 < steps) issue_tile(d + 1);
    tf32x3::cp_async_commit();
    const int it = d / nS;
    if (d == it * nS) {
      if (it + 1 < units) issue_unit(it + 1);
      tf32x3::cp_async_commit();
    }
  };
  issue_unit(0);   // the first unit's copies run under C.B^T
  tf32x3::cp_async_commit();

  // ---- C.B^T, once a block: items (16-row strip r, 32-column group) ----
  {
    float* cs = ubase + p.u_stage;   // C's S tile in the second U stage
    const int ncg = (QP + 31) / 32;
    for (int sti = 0; sti < nS; ++sti) {
      if (sti) __syncthreads();   // the last S tile is read
      const int s0 = sti * T, w = min(T, p.S - s0);
      float* bt = p.b_res ? bres + s0 : dbase + T * LD;
      const int ldbt = p.b_res ? p.ldb : LD;
      load_b_tile<T>(p, bn, s0, bt, ldbt);
      load_rows<kThreadsH>(cs, LD, p.C + bn * Q * p.S + s0, p.S, Q, w,
                           p.vbc);
      tf32x3::cp_async_commit();
      tf32x3::cp_async_wait<0>();
      __syncthreads();
      for (int it = warp; it < nstrips * ncg; it += kWarpsH) {
        const int r = it / ncg, c0 = 32 * (it - r * ncg);
        if (c0 > 16 * r + 15) continue;   // wholly above the diagonal
        const int nj = min(4, (QP - c0) / 8);
        float acc[4][4] = {};
        for (int ks = 0; ks < T / 8; ++ks) {
          const tf32x3::Frag<4> a =
              tf32x3::load_a<true>(cs, LD, 16 * r, 8 * ks, lane);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < nj)
              tf32x3::mma3(acc[j], a,
                           tf32x3::load_bt<true>(bt, ldbt, c0 + 8 * j,
                                                 8 * ks, lane));
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j >= nj) break;
          float* o = cbs + cb_row(16 * r + g) + c0 + 8 * j + 2 * t;
          float2 lo = make_float2(acc[j][0], acc[j][1]);
          float2 hi = make_float2(acc[j][2], acc[j][3]);
          if (sti) {
            const float2 l0 = *reinterpret_cast<float2*>(o);
            const float2 h0v =
                *reinterpret_cast<float2*>(o + 8 * cb_ld(r));
            lo.x += l0.x; lo.y += l0.y; hi.x += h0v.x; hi.y += h0v.y;
          }
          *reinterpret_cast<float2*>(o) = lo;
          *reinterpret_cast<float2*>(o + 8 * cb_ld(r)) = hi;
        }
      }
    }
  }
  __syncthreads();   // C.B^T built; B's ring tile and C's are read
  issue_tile(0);
  tf32x3::cp_async_commit();

  // X warps: dx's strips xr (r and nstrips - 1 - r, so every warp has
  // as many k-steps of M^T dy) and 16-column group xcg of the P tile
  int xr[2];
  const int xpr = gw / kNcg, xcg = gw - xpr * kNcg;
  xr[0] = xpr <= nstrips - 1 - xpr ? xpr : -1;
  xr[1] = nstrips - 1 - xpr > xpr ? nstrips - 1 - xpr : -1;
  // accumulators that live across steps: an X warp's E and dx tiles
  // (strip s, n8 tile nt: keep[2 s + nt]); a D warp's share of the
  // group's dCB, summed over its heads (its tile gw + 8 s: keep[s])
  float keep[kKeep][4] = {};
  float* part_st = p.part_st + (bn * p.G + grp) * (long long)Q * p.SP;

  // ddt and dcum of the group's head hh from the sums its units left
  auto finish_head = [&](int hh) {
    finish<QM>(p.ddt, p.dcum, (bn * Q) * p.H + h0 + hh, p.H, Q, QP, upart,
               rowg, colg, colt, w2 + (hh & 1) * QP, wend2 + (hh & 1) * QP);
  };

  for (int d = 0; d < steps; ++d) {
    const int it = d / nS, si = d - it * nS;
    // pending: this step's group, and at the unit's second step the next
    // unit's (younger); at its first step this unit's (older) too
    if (si == 1) tf32x3::cp_async_wait<1>();
    else tf32x3::cp_async_wait<0>();
    __syncthreads();   // step d's copies landed; step d - 1 is read
    prefetch(d);
    const int hh = it / nP, pi = it - hh * nP, h = h0 + hh;
    const int p0 = pi * T, pw = min(T, p.P - p0), kp = (pw + 7) / 8;
    const float* xs = ubase + (it & 1) * p.u_stage;
    const float* dys = xs + QP * LD;
    const float* cum = dys + QP * LD;
    const float* dt = cum + QP;
    const float* w = w2 + (hh & 1) * QP;
    const float cend = cum[Q - 1];
    const int s0 = si * T, sw = min(T, p.S - s0);
    const float* ds = dbase + (d & 1) * p.d_stage;

    // a head's first step: the X warps finish the last head (ddt, dcum);
    // the D warps form this head's w_end, w and L, read from the next
    // step on (and after a barrier where this is the unit's last step)
    if (si == 0 && pi == 0) {
      if (xw) {
        if (hh) finish_head(hh - 1);
      } else {
        for (int j = threadIdx.x - 256; j < QP; j += 256) {
          const float we = j < Q ? __expf(cend - cum[j]) : 0.f;
          wend2[(hh & 1) * QP + j] = we;
          w2[(hh & 1) * QP + j] = we * dt[j];
        }
        if constexpr (kL) {   // rows by warp, columns by lane
#pragma unroll
          for (int ii = 0; ii < QM / 8; ++ii)
#pragma unroll
            for (int jj = 0; jj < QM / 32; ++jj) {
              const int i = gw + 8 * ii, j = lane + 32 * jj;
              if (i < QP && j < 16 * ((i >> 4) + 1))
                Lm[cb_row(i) + j] =
                    i >= j && i < Q ? __expf(cum[i] - cum[j]) : 0.f;
            }
        }
      }
      if (nS == 1) __syncthreads();
    }

    if (xw) {
      // E += B[:, S tile] dst[P tile, S tile]^T
      if (si == 0) {
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int e = 0; e < 4; ++e) keep[s][e] = 0.f;
      }
      const float* bsrc = p.b_res ? bres + s0 : ds + T * LD;
      const int ldbs = p.b_res ? p.ldb : LD;
      if (xr[0] >= 0) {
        const int kss = (sw + 7) / 8;
        for (int ks = 0; ks < kss; ++ks) {
          const tf32x3::Frag<4> a0 =
              tf32x3::load_a<true>(bsrc, ldbs, 16 * xr[0], 8 * ks, lane);
          tf32x3::Frag<4> a1 = a0;
          if (xr[1] >= 0)
            a1 = tf32x3::load_a<true>(bsrc, ldbs, 16 * xr[1], 8 * ks, lane);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const tf32x3::Frag<2> b = tf32x3::load_bt<true>(
                ds, LD, 16 * xcg + 8 * nt, 8 * ks, lane);
            tf32x3::mma3(keep[nt], a0, b);
            if (xr[1] >= 0) tf32x3::mma3(keep[2 + nt], a1, b);
          }
        }
      }
    } else {
      // the state term (x o w) dst: items (strip, 32 columns of the tile)
      for (int it2 = gw; it2 < nstrips * (T / 32); it2 += 8) {
        const int r = it2 / (T / 32), ng = it2 - r * (T / 32);
        if (32 * ng >= sw) continue;
        const int j0 = 16 * r + g, j1 = j0 + 8;
        // w as the head's first step forms it in w2 (the same bits)
        const float w0 = j0 < Q ? __expf(cend - cum[j0]) * dt[j0] : 0.f;
        const float w1 = j1 < Q ? __expf(cend - cum[j1]) * dt[j1] : 0.f;
        float acc[4][4] = {};
        for (int ks = 0; ks < kp; ++ks) {
          const int pc = 8 * ks + 2 * t;
          const float2 lo = *reinterpret_cast<const float2*>(
              xs + j0 * LD + pc);
          const float2 hi = *reinterpret_cast<const float2*>(
              xs + j1 * LD + pc);
          const float v[4] = {lo.x * w0, hi.x * w1, lo.y * w0, hi.y * w1};
          tf32x3::Frag<4> a;
          tf32x3::split_fast(a, v);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            tf32x3::mma3(acc[nt], a,
                         tf32x3::load_b<true>(ds, LD, 8 * ks,
                                              32 * ng + 8 * nt, lane));
        }
        const int c0 = s0 + 32 * ng + 2 * t;
        if (p.st_res) {   // the block's accumulator, rows past Q zero
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              float2* o = reinterpret_cast<float2*>(
                  sta + (half ? j1 : j0) * p.ldst + c0 + 8 * nt);
              const float2 old = *o;
              *o = make_float2(old.x + acc[nt][2 * half],
                               old.y + acc[nt][2 * half + 1]);
            }
        } else {          // the group's scratch slot: all loads, then stores
          float2 old[4][2];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int j = half ? j1 : j0, col = c0 + 8 * nt;
              old[nt][half] = it && col < p.S && j < Q
                  ? *reinterpret_cast<const float2*>(
                        part_st + (long long)j * p.SP + col)
                  : make_float2(0.f, 0.f);
            }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int j = half ? j1 : j0, col = c0 + 8 * nt;
              if (col < p.S && j < Q)
                *reinterpret_cast<float2*>(
                    part_st + (long long)j * p.SP + col) =
                    make_float2(old[nt][half].x + acc[nt][2 * half],
                                old[nt][half].y + acc[nt][2 * half + 1]);
            }
        }
      }
    }
    if (si < nS - 1) continue;

    // ---- after the unit's last D step ----------------------------------
    if (xw) {
      // u from E and x; then dx = w o E + M^T dy
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (xr[s] < 0) continue;
        float (&ex0)[4] = keep[2 * s];
        float (&ex1)[4] = keep[2 * s + 1];
        const int r = xr[s], j0 = 16 * r + g, j1 = j0 + 8;
        const int pc = 16 * xcg + 2 * t;
        float u0 = xs[j0 * LD + pc] * ex0[0] + xs[j0 * LD + pc + 1] * ex0[1]
                   + xs[j0 * LD + pc + 8] * ex1[0]
                   + xs[j0 * LD + pc + 9] * ex1[1];
        float u1 = xs[j1 * LD + pc] * ex0[2] + xs[j1 * LD + pc + 1] * ex0[3]
                   + xs[j1 * LD + pc + 8] * ex1[2]
                   + xs[j1 * LD + pc + 9] * ex1[3];
        u0 = quad_sum(u0);
        u1 = quad_sum(u1);
        if (t == 0) {
          upart[xcg * QP + j0] = (pi ? upart[xcg * QP + j0] : 0.f) + u0;
          upart[xcg * QP + j1] = (pi ? upart[xcg * QP + j1] : 0.f) + u1;
        }
        const float w0 = w[j0], w1 = w[j1];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          keep[2 * s + nt][0] *= w0;
          keep[2 * s + nt][1] *= w0;
          keep[2 * s + nt][2] *= w1;
          keep[2 * s + nt][3] *= w1;
        }
        const float cj0 = cum[j0], cj1 = cum[j1];
        const float dj0 = dt[j0], dj1 = dt[j1];
        for (int ks = 2 * r; ks < QP / 8; ++ks) {
          // M^T's A fragment: row j, column i, = M[i, j], for j <= i < Q
          const int i0 = 8 * ks + 2 * t, i1 = i0 + 1;
          const int o0 = cb_row(i0), o1 = o0 + cb_ld(ks >> 1);
          float v[4];
          if constexpr (kL) {
            v[0] = cbs[o0 + j0] * Lm[o0 + j0] * dj0;
            v[1] = cbs[o0 + j1] * Lm[o0 + j1] * dj1;
            v[2] = cbs[o1 + j0] * Lm[o1 + j0] * dj0;
            v[3] = cbs[o1 + j1] * Lm[o1 + j1] * dj1;
          } else {
            const float ci0 = cum[i0], ci1 = cum[i1];
            v[0] = decay(cbs[o0 + j0], ci0, cj0, dj0, i0 >= j0 && i0 < Q);
            v[1] = decay(cbs[o0 + j1], ci0, cj1, dj1, i0 >= j1 && i0 < Q);
            v[2] = decay(cbs[o1 + j0], ci1, cj0, dj0, i1 >= j0 && i1 < Q);
            v[3] = decay(cbs[o1 + j1], ci1, cj1, dj1, i1 >= j1 && i1 < Q);
          }
          tf32x3::Frag<4> a;
          tf32x3::split_fast(a, v);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            tf32x3::mma3(keep[2 * s + nt], a,
                         tf32x3::load_b<true>(dys, LD, 8 * ks,
                                              16 * xcg + 8 * nt, lane));
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = p0 + 16 * xcg + 8 * nt + 2 * t;
          const float(&e)[4] = keep[2 * s + nt];
          if (j0 < Q)
            store2(p.dx, ((bn * Q + j0) * p.H + h) * (long long)p.P + col,
                   col, p.P, e[0], e[1], p.vdx);
          if (j1 < Q)
            store2(p.dx, ((bn * Q + j1) * p.H + h) * (long long)p.P + col,
                   col, p.P, e[2], e[3], p.vdx);
        }
      }
    } else {
      // dM = dy x^T over this P tile, three tiles at a time (kSlotsM is 3
      // or 9), then their share of dCB and the row and column sums of
      // G = dM o M and of dM o CB o L
#pragma unroll
      for (int s3 = 0; s3 < kSlotsM; s3 += 3) {
        float dm[3][4] = {};
#pragma unroll
        for (int s = s3; s < s3 + 3; ++s) {
          const int kt = gw + 8 * s;
          if (kt >= ntiles) continue;
          const int r = tile_strip(kt), c = kt - r * (r + 1);
          for (int ks = 0; ks < kp; ++ks)
            tf32x3::mma3(dm[s - s3],
                         tf32x3::load_a<true>(dys, LD, 16 * r, 8 * ks, lane),
                         tf32x3::load_bt<true>(xs, LD, 8 * c, 8 * ks, lane));
        }
#pragma unroll
        for (int s = s3; s < s3 + 3; ++s) {
          const int kt = gw + 8 * s;
          if (kt >= ntiles) continue;
          const int r = tile_strip(kt), c = kt - r * (r + 1);
          const int i0 = 16 * r + g, j0 = 8 * c + 2 * t;
          const float ci[2] = {cum[i0], cum[i0 + 8]};
          const float cj[2] = {cum[j0], cum[j0 + 1]};
          const float dj[2] = {dt[j0], dt[j0 + 1]};
          float rg[2] = {0.f, 0.f}, cg[2] = {0.f, 0.f}, ct[2] = {0.f, 0.f};
#pragma unroll
          for (int e = 0; e < 4; ++e) {   // (i0, j0), (i0, j1), (i1, j0),
            const int a = e >> 1, b = e & 1;   // (i1, j1)
            const int i = i0 + 8 * a, j = j0 + b;
            const bool on = i >= j && i < Q;
            float L;
            if constexpr (kL) L = Lm[cb_row(i) + j];
            else L = on ? __expf(ci[a] - cj[b]) : 0.f;
            const float dd = on ? dm[s - s3][e] : 0.f;
            const float dl = dd * L;
            keep[s][e] += dl * dj[b];                  // dCB
            const float tv = dl * cbs[cb_row(i) + j];  // dM CB L
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
            float* o = rowg + c * QP + i0;
            o[0] = (pi ? o[0] : 0.f) + rg[0];
            o[8] = (pi ? o[8] : 0.f) + rg[1];
          }
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            cg[b] = column_sum(cg[b]);
            ct[b] = column_sum(ct[b]);
          }
          if (g == 0) {
            float* og = colg + r * QP + j0;
            float* ot = colt + r * QP + j0;
            og[0] = (pi ? og[0] : 0.f) + cg[0];
            og[1] = (pi ? og[1] : 0.f) + cg[1];
            ot[0] = (pi ? ot[0] : 0.f) + ct[0];
            ot[1] = (pi ? ot[1] : 0.f) + ct[1];
          }
        }
      }
    }
  }
  __syncthreads();   // the last unit's sums and the state term are written
  finish_head(hg - 1);

  // the group's dCB and (where kept here) state term, once
  if (!xw) {
    float* pc = p.part_cb + (bn * p.G + grp) * (long long)QP * QP;
#pragma unroll
    for (int s = 0; s < kSlotsM; ++s) {
      const int kt = gw + 8 * s;
      if (kt >= ntiles) continue;
      const int r = tile_strip(kt), c = kt - r * (r + 1);
      const int i0 = 16 * r + g, j0 = 8 * c + 2 * t;
      *reinterpret_cast<float2*>(pc + i0 * QP + j0) =
          make_float2(keep[s][0], keep[s][1]);
      *reinterpret_cast<float2*>(pc + (i0 + 8) * QP + j0) =
          make_float2(keep[s][2], keep[s][3]);
    }
  }
  if (p.st_res)
    for (int e = threadIdx.x; e < Q * p.S; e += kThreadsH) {
      const int j = e / p.S, c = e - j * p.S;
      part_st[(long long)j * p.SP + c] = sta[j * p.ldst + c];
    }
}

// per (chunk, 32 columns of S, 32 rows): dCB's rows and columns of those
// rows summed over the groups in group order, then dC = dCB B and
// dB = dCB^T C + the groups' state terms
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk(const Params p) {
  extern __shared__ __align__(16) float sm[];
  const int Q = p.Q, QP = p.QP;
  const int r0 = blockIdx.z * kR2, nr = min(kR2, Q - r0);
  float* rows = sm;                // kR2 x Q: dCB[r0 + a, j], j <= r0 + a
  float* cols = rows + kR2 * Q;    // kR2 x Q: dCB[i, r0 + a], i >= r0 + a
  float* bt = cols + kR2 * Q;      // Q x kS2: B's columns
  float* ctile = bt + Q * kS2;     // Q x kS2: C's
  const long long bn = blockIdx.x;
  const int s0 = blockIdx.y * kS2, sw = min(kS2, p.S - s0);
  const float* pc = p.part_cb + bn * p.G * (long long)QP * QP;
  for (int e = threadIdx.x; e < nr * Q; e += kThreads) {
    const int a = e / Q, j = e - a * Q, r = r0 + a;
    float v = 0.f, u = 0.f;   // above the diagonal dCB is 0 (not written)
    for (int gi = 0; gi < p.G; ++gi) {
      const float* pg = pc + (long long)gi * QP * QP;
      if (j <= r) v += pg[r * QP + j];
      if (j >= r) u += pg[j * QP + r];
    }
    rows[e] = v;
    cols[e] = u;
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
  for (int e = threadIdx.x; e < nr * kS2; e += kThreads) {
    const int a = e / kS2, c = e - a * kS2, r = r0 + a;
    if (c >= sw) continue;
    float x = 0.f;
    for (int j = 0; j <= r; ++j) x += rows[a * Q + j] * bt[j * kS2 + c];
    float y = 0.f;
    for (int i = r; i < Q; ++i) y += cols[a * Q + i] * ctile[i * kS2 + c];
    for (int gi = 0; gi < p.G; ++gi)
      y += ps[((long long)gi * Q + r) * p.SP + s0 + c];
    const long long o = (bn * Q + r) * p.S + s0 + c;
    p.dC[o] = x;
    p.dB[o] = y;
  }
}

long long chunk_smem(int Q) { return 4ll * (2 * kR2 * Q + 2 * Q * kS2); }

struct Plan {
  int QP, cbf, SP, HG, G, T, nP, nS, b_res, ldb, st_res, ldst;
  int o_l, o_b, o_st, o_u, o_d, o_v, u_stage, d_stage;
  long long smem;
};

// The heads pass's shared memory (the layout in the header), with B
// resident and the state term in shared memory where they fit, in that
// order; and the heads a group.  One 16-warp block an SM (its shared
// memory allows no second), so a wave is sm_count() blocks.  A head's time
// is the larger of its copies (x, dy and dst in, dx out, at an SM's share
// of 3.35 TB/s, 25 bytes a ns) and its products (3xTF32 on mma.sync, at
// ~1100 TF32 multiply-adds a ns an SM, ~60 % of the tensor cores' peak):
// the pipeline overlaps the two.  A block adds C.B^T and its B and C.  HG
// minimises whole waves x a block's time.
Plan plan(int BN, int H, int Q, int P, int S) {
  Plan pl;
  pl.QP = (Q + 15) / 16 * 16;
  const int QP = pl.QP;
  pl.T = QP <= 64 ? 64 : 32;
  const int T = pl.T, LD = T + 8;
  pl.cbf = cb_off(QP / 16);
  pl.SP = (S + 1) / 2 * 2;
  pl.nP = (P + T - 1) / T;
  pl.nS = (S + T - 1) / T;
  pl.ldb = pl.ldst = pl.nS * T + 8;
  const long long res = (long long)QP * (pl.nS * T + 8);
  long long o = (long long)pl.cbf * (QP <= 64 ? 2 : 1);
  pl.u_stage = 2 * QP * LD + 2 * QP;
  const long long vecs = 4ll * QP + (T / 16) * QP + (QP / 8) * QP +
                         2ll * (QP / 16) * QP;
  const long long base = o + 2ll * pl.u_stage + 2ll * T * LD + vecs;
  const long long max_f = kMaxSmem / 4;
  pl.b_res = base + res <= max_f;
  pl.d_stage = T * LD + (pl.b_res ? 0 : QP * LD);
  long long total = base + (pl.b_res ? res : 2ll * QP * LD);
  pl.st_res = total + res <= max_f;
  if (pl.st_res) total += res;
  pl.o_l = pl.cbf;
  pl.o_b = (int)o;
  if (pl.b_res) o += res;
  pl.o_st = (int)o;
  if (pl.st_res) o += res;
  pl.o_u = (int)o;
  o += 2ll * pl.u_stage;
  pl.o_d = (int)o;
  o += 2ll * pl.d_stage;
  pl.o_v = (int)o;
  pl.smem = 4 * total;

  const double qp = QP, pp = (P + 7) / 8 * 8.0, sp = (S + 7) / 8 * 8.0;
  const double tri = qp * (qp + 16) / 2;
  const double head = fmax(4.0 * (3.0 * Q * P + (double)P * S) / 25.0,
                               3.0 * (2 * tri * pp + 2 * qp * pp * sp) /
                                   1100.0);
  const double block = fmax(8.0 * Q * S / 25.0, 3.0 * tri * sp / 1100.0);
  const long long slots = sm_count();
  pl.HG = 1;
  double best = 0;
  for (int hg = 1; hg <= H; ++hg) {
    const long long blocks = (long long)BN * ((H + hg - 1) / hg);
    const double waves = (double)((blocks + slots - 1) / slots);
    const double cost = waves * (hg * head + block);
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

template <int QM>
cudaError_t launch_heads(const Params& p, long long smem, dim3 grid,
                         cudaStream_t stream) {
  static long long attr_set[64];
  const cudaError_t err = set_smem(ssd_bwd_heads<QM>, smem, attr_set);
  if (err != cudaSuccess) return err;
  ssd_bwd_heads<QM><<<grid, kThreadsH, smem, stream>>>(p);
  return cudaGetLastError();
}

bool valid(int BN, int H, int Q, int P, int S) {
  return BN >= 1 && H >= 1 && Q >= 1 && P >= 1 && S >= 1;
}

}  // namespace

// ---- the tiled route: chunks of q > kQMax rows ----------------------------

namespace tlb {

using ssd::kThreads;
using namespace ssd::tiled;

constexpr int kST2 = 2 * kT;   // the chunk pass's S columns a block

struct Args {
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
  int H, Q, P, S;
  int nT, nPT, nST;   // 64-row tiles of q, 64-column of P, 128-column of S
};

// the heads pass: the staging, a 64 x 64 tile, the sums' reduction, and
// nine vectors of a tile's rows (cum and dt of tile t and of the other
// tile, ddt's and G's column sums, G's row sums, u and another tile's u)
constexpr long long kSmemHeads =
    4ll * (kStageFloats + kT * kLdT + 16 * kT + 9 * kT);
// the chunk pass: the staging and a 64 x 64 tile
constexpr long long kSmemChunk = 4ll * (kStageFloats + kT * kLdT);

__global__ void __launch_bounds__(kThreads)
ssd_bwd_heads_tiled(const Args p) {
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;
  float* ms = stage + kStageFloats;
  float* red = ms + kT * kLdT;
  float* cumt = red + 16 * kT;
  float* dtt = cumt + kT;
  float* cumo = dtt + kT;
  float* dto = cumo + kT;
  float* ddts = dto + kT;
  float* colg = ddts + kT;
  float* rowg = colg + kT;
  float* us = rowg + kT;
  float* uo = us + kT;
  __shared__ float tot;
  const long long bn = blockIdx.x;
  const int h = blockIdx.y / p.nT, t = blockIdx.y % p.nT, t0 = t * kT;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long HP = (long long)p.H * p.P;
  const int Q = p.Q;
  const float* xb = p.x + bn * Q * HP + (long long)h * p.P;    // row j: j HP
  const float* dyb = p.dy + bn * Q * HP + (long long)h * p.P;
  const float* Bb = p.B + bn * Q * p.S;
  const float* Cb = p.C + bn * Q * p.S;
  const float* cumh = p.cum + bn * Q * p.H + h;                // row j: j H
  const float* dth = p.dt + bn * Q * p.H + h;
  const float* dstb = p.dst + (bn * p.H + h) * (long long)p.P * p.S;
  const float cend = cumh[(long long)(Q - 1) * p.H];
  auto rows_of = [&](int r0, float* cm, float* dm) {
    for (int e = tid; e < kT; e += kThreads) {
      const bool in = r0 + e < Q;
      cm[e] = in ? cumh[(long long)(r0 + e) * p.H] : 0.f;
      if (dm) dm[e] = in ? dth[(long long)(r0 + e) * p.H] : 0.f;
    }
  };
  // C.B^T's and dM's tiles of rows [i0, + 64) by columns [j0, + 64)
  auto cb_dm = [&](float (&cb)[4][4], float (&dm)[4][4], int i0, int j0) {
    zero(cb);
    mm_acc<4, true, true>(
        cb, p.S,
        [&](int r, int k) {
          return i0 + r < Q ? Cb[(long long)(i0 + r) * p.S + k] : 0.f;
        },
        [&](int k, int c) {
          return j0 + c < Q ? Bb[(long long)(j0 + c) * p.S + k] : 0.f;
        },
        stage);
    zero(dm);
    mm_acc<4, true, true>(
        dm, p.P,
        [&](int r, int k) { return i0 + r < Q ? dyb[(i0 + r) * HP + k] : 0.f; },
        [&](int k, int c) { return j0 + c < Q ? xb[(j0 + c) * HP + k] : 0.f; },
        stage);
  };
  // E = B dst^T's tile of rows [r0, + 64) by P columns [p0, + 64)
  auto e_tile = [&](float (&e)[4][4], int r0, int p0) {
    zero(e);
    mm_acc<4, true, true>(
        e, p.S,
        [&](int r, int k) {
          return r0 + r < Q ? Bb[(long long)(r0 + r) * p.S + k] : 0.f;
        },
        [&](int k, int c) {
          return p0 + c < p.P ? dstb[(long long)(p0 + c) * p.S + k] : 0.f;
        },
        stage);
  };
  // u of rows [r0, + 64) (sum over p of x E), the E tile of p0 in e
  auto u_part = [&](float (&e)[4][4], int r0, int p0, float* dst) {
    float v[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = r0 + 4 * ty + a, pc = p0 + tx + 16 * b;
        v[a][b] = j < Q && pc < p.P ? xb[j * HP + pc] * e[a][b] : 0.f;
      }
    row_sums(v, red, dst);
  };

  rows_of(t0, cumt, dtt);
  for (int e = tid; e < kT; e += kThreads)
    ddts[e] = colg[e] = rowg[e] = us[e] = 0.f;
  float cb[4][4], dm[4][4];
  // as columns j of tile t: over the row tiles i >= t
  for (int pt = 0; pt < p.nPT; ++pt) {
    const int p0 = pt * kT;
    float dxa[4][4];
    zero(dxa);
    for (int it = t; it < p.nT; ++it) {
      const int i0 = it * kT;
      rows_of(i0, cumo, nullptr);
      cb_dm(cb, dm, i0, t0);
      // M to shared memory; in place, dm o CB o L (dm) and G (cb)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int ri = 4 * ty + a, cj = tx + 16 * b;
          const int i = i0 + ri, j = t0 + cj;
          const bool on = i >= j && i < Q && j < Q;
          const float cbl = cb[a][b] * decay_l(cumo[ri], cumt[cj], on);
          const float mv = cbl * dtt[cj];
          const float d = on ? dm[a][b] : 0.f;
          ms[ri * kLdT + cj] = on ? mv : 0.f;
          dm[a][b] = d * cbl;
          cb[a][b] = i > j ? d * mv : 0.f;
        }
      if (pt == 0) {
        col_sums(dm, red, ddts);
        col_sums(cb, red, colg);
      }
      mm_acc<4, false, false>(
          dxa, kT, [&](int r, int k) { return ms[k * kLdT + r]; },
          [&](int k, int c) {
            return i0 + k < Q && p0 + c < p.P ? dyb[(i0 + k) * HP + p0 + c]
                                              : 0.f;
          },
          stage);
    }
    float e[4][4];
    e_tile(e, t0, p0);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int rj = 4 * ty + a, j = t0 + rj, pc = p0 + tx + 16 * b;
        if (j < Q && pc < p.P) {
          const float w = expf(cend - cumt[rj]) * dtt[rj];
          p.dx[(bn * Q + j) * HP + (long long)h * p.P + pc] =
              dxa[a][b] + w * e[a][b];
        }
      }
    u_part(e, t0, p0, us);
  }
  // as rows i of tile t: over the column tiles j <= t, G's row sums
  for (int jt = 0; jt <= t; ++jt) {
    const int j0 = jt * kT;
    rows_of(j0, cumo, dto);
    cb_dm(cb, dm, t0, j0);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int ri = 4 * ty + a, cj = tx + 16 * b;
        const int i = t0 + ri, j = j0 + cj;
        const bool on = i > j && i < Q && j < Q;
        cb[a][b] = on ? dm[a][b] * (cb[a][b] * decay_l(cumt[ri], cumo[cj],
                                                       on) * dto[cj])
                      : 0.f;                    // G
      }
    row_sums(cb, red, rowg);
  }
  // the last tile: cum_end's share, sum over the chunk of u_j w_j, tile
  // by tile in order
  if (tid == 0) tot = 0.f;
  if (t == p.nT - 1) {
    for (int tt = 0; tt < p.nT; ++tt) {
      const float* u = us;
      if (tt != t) {
        for (int e = tid; e < kT; e += kThreads) uo[e] = 0.f;
        for (int pt = 0; pt < p.nPT; ++pt) {
          float e[4][4];
          e_tile(e, tt * kT, pt * kT);
          u_part(e, tt * kT, pt * kT, uo);
        }
        u = uo;
      }
      __syncthreads();
      if (tid == 0) {
        float sum = 0.f;
        for (int r = 0; r < kT && tt * kT + r < Q; ++r) {
          const long long j = tt * kT + r;
          sum += u[r] * (expf(cend - cumh[j * p.H]) * dth[j * p.H]);
        }
        tot += sum;
      }
      __syncthreads();
    }
  }
  __syncthreads();
  if (tid < kT && t0 + tid < Q) {
    const int j = t0 + tid;
    const float wend = expf(cend - cumt[tid]), w = wend * dtt[tid];
    const long long o = (bn * Q + j) * p.H + h;
    p.ddt[o] = ddts[tid] + us[tid] * wend;
    p.dcum[o] = rowg[tid] - colg[tid] - us[tid] * w + (j == Q - 1 ? tot : 0.f);
  }
}

__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk_tiled(const Args p) {
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;
  float* ms = stage + kStageFloats;
  const long long bn = blockIdx.x;
  const int per = p.nT * p.nST;
  const int role = blockIdx.y / per, t = blockIdx.y % per / p.nST;
  const int s0 = blockIdx.y % p.nST * kST2, t0 = t * kT;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long HP = (long long)p.H * p.P;
  const int Q = p.Q;
  const float* xb = p.x + bn * Q * HP;
  const float* dyb = p.dy + bn * Q * HP;
  const float* Bb = p.B + bn * Q * p.S;
  const float* Cb = p.C + bn * Q * p.S;
  const float* cumb = p.cum + bn * Q * p.H;
  const float* dtb = p.dt + bn * Q * p.H;
  // dCB's tile of rows [i0, + 64) by columns [j0, + 64): the heads' dM o L
  // o dt_j, summed over the heads in order, into ms
  auto dcb_tile = [&](int i0, int j0) {
    float v[4][4];
    zero(v);
    for (int h = 0; h < p.H; ++h) {
      float dm[4][4];
      zero(dm);
      const long long ho = (long long)h * p.P;
      mm_acc<4, true, true>(
          dm, p.P,
          [&](int r, int k) {
            return i0 + r < Q ? dyb[(i0 + r) * HP + ho + k] : 0.f;
          },
          [&](int k, int c) {
            return j0 + c < Q ? xb[(j0 + c) * HP + ho + k] : 0.f;
          },
          stage);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int i = i0 + 4 * ty + a, j = j0 + tx + 16 * b;
          const bool on = i >= j && i < Q && j < Q;
          if (on)
            v[a][b] += dm[a][b] * decay_l(cumb[(long long)i * p.H + h],
                                          cumb[(long long)j * p.H + h], on) *
                       dtb[(long long)j * p.H + h];
        }
    }
    store_tile(ms, v);
  };
  float acc[4][8];
  zero(acc);
  if (role == 0) {                    // dC of rows [t0, + 64)
    for (int jt = 0; jt <= t; ++jt) {
      const int j0 = jt * kT;
      dcb_tile(t0, j0);
      mm_acc<8, false, false>(
          acc, kT, [&](int r, int k) { return ms[r * kLdT + k]; },
          [&](int k, int c) {
            return j0 + k < Q && s0 + c < p.S
                       ? Bb[(long long)(j0 + k) * p.S + s0 + c]
                       : 0.f;
          },
          stage);
    }
  } else {                            // dB of rows [t0, + 64)
    for (int it = t; it < p.nT; ++it) {
      const int i0 = it * kT;
      dcb_tile(i0, t0);
      mm_acc<8, false, false>(
          acc, kT, [&](int r, int k) { return ms[k * kLdT + r]; },
          [&](int k, int c) {
            return i0 + k < Q && s0 + c < p.S
                       ? Cb[(long long)(i0 + k) * p.S + s0 + c]
                       : 0.f;
          },
          stage);
    }
    // + sum over the heads of (x o w) dst_h
    for (int h = 0; h < p.H; ++h) {
      const float cend = cumb[(long long)(Q - 1) * p.H + h];
      const long long ho = (long long)h * p.P;
      const float* dsth = p.dst + (bn * p.H + h) * (long long)p.P * p.S;
      mm_acc<8, true, false>(
          acc, p.P,
          [&](int r, int k) {
            const long long j = t0 + r;
            return j < Q ? xb[j * HP + ho + k] *
                               (expf(cend - cumb[j * p.H + h]) *
                                dtb[j * p.H + h])
                         : 0.f;
          },
          [&](int k, int c) {
            return s0 + c < p.S ? dsth[(long long)k * p.S + s0 + c] : 0.f;
          },
          stage);
    }
  }
  float* out = role == 0 ? p.dC : p.dB;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int r = t0 + 4 * ty + a, sc = s0 + tx + 16 * b;
      if (r < Q && sc < p.S) out[(bn * Q + r) * p.S + sc] = acc[a][b];
    }
}

Args make_args(int H, int Q, int P, int S) {
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

int launch(const Args& a, int BN, cudaStream_t stream) {
  const long long g1 = (long long)a.H * a.nT, g2 = 2ll * a.nT * a.nST;
  if (g1 > 65535 || g2 > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_heads_tiled, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemHeads);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ssd_bwd_chunk_tiled,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemChunk);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_heads_tiled<<<dim3((unsigned)BN, (unsigned)g1), kThreads,
                        kSmemHeads, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_chunk_tiled<<<dim3((unsigned)BN, (unsigned)g2), kThreads,
                        kSmemChunk, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace tlb

// floats of scratch a call takes: each group's partial dCB and state term
// (none on the tiled route)
extern "C" long long ssd_chunk_backward_scratch(int BN, int H, int Q, int P,
                                                int S) {
  if (!valid(BN, H, Q, P, S) || Q > kQMax) return 0;
  const Plan pl = plan(BN, H, Q, P, S);
  return (long long)BN * pl.G *
         ((long long)pl.QP * pl.QP + (long long)Q * pl.SP);
}

// the heads pass's plan: out[0..7] = heads a group, groups, warps a block,
// blocks an SM, shared memory bytes, B resident, state term on chip,
// tiled (the tiled route, q > kQMax: a head a block, 8 warps, blocks an SM
// as its shared memory allows, nothing kept on chip across tiles)
extern "C" int ssd_chunk_backward_plan(int BN, int H, int Q, int P, int S,
                                       long long* out) {
  if (!valid(BN, H, Q, P, S)) return (int)cudaErrorInvalidValue;
  if (Q > kQMax) {
    const int per_sm = (int)(233472 / (tlb::kSmemHeads + 1024));
    const long long v[8] = {1, H, ssd::kWarps, per_sm < 8 ? per_sm : 8,
                            tlb::kSmemHeads, 0, 0, 1};
    for (int i = 0; i < 8; ++i) out[i] = v[i];
    return 0;
  }
  const Plan pl = plan(BN, H, Q, P, S);
  const long long v[8] = {pl.HG, pl.G, kWarpsH, 1, pl.smem, pl.b_res,
                          pl.st_res, 0};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

extern "C" int ssd_chunk_backward(const float* x, const float* Bm,
                                  const float* Cm, const float* dt,
                                  const float* cum, const float* dy,
                                  const float* dst, float* dx, float* dB,
                                  float* dC, float* ddt, float* dcum,
                                  float* scratch, int BN, int H, int Q,
                                  int P, int S, void* stream) {
  if (!valid(BN, H, Q, P, S)) return (int)cudaErrorInvalidValue;
  if (Q > kQMax) {
    tlb::Args a = tlb::make_args(H, Q, P, S);
    a.x = x;
    a.B = Bm;
    a.C = Cm;
    a.dt = dt;
    a.cum = cum;
    a.dy = dy;
    a.dst = dst;
    a.dx = dx;
    a.dB = dB;
    a.dC = dC;
    a.ddt = ddt;
    a.dcum = dcum;
    return tlb::launch(a, BN, (cudaStream_t)stream);
  }
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
  p.cbf = pl.cbf;
  p.SP = pl.SP;
  p.HG = pl.HG;
  p.G = pl.G;
  p.nP = pl.nP;
  p.nS = pl.nS;
  p.b_res = pl.b_res;
  p.ldb = pl.ldb;
  p.st_res = pl.st_res;
  p.ldst = pl.ldst;
  p.o_l = pl.o_l;
  p.o_b = pl.o_b;
  p.o_st = pl.o_st;
  p.o_u = pl.o_u;
  p.o_d = pl.o_d;
  p.o_v = pl.o_v;
  p.u_stage = pl.u_stage;
  p.d_stage = pl.d_stage;
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
  cudaError_t err = pl.QP <= 64 ? launch_heads<64>(p, pl.smem, grid1, sm)
                                : launch_heads<128>(p, pl.smem, grid1, sm);
  if (err != cudaSuccess) return (int)err;
  static long long attr_set[64];
  const long long smem2 = chunk_smem(Q);
  err = set_smem(ssd_bwd_chunk, smem2, attr_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid2((unsigned)BN, (unsigned)((S + kS2 - 1) / kS2),
                   (unsigned)((Q + kR2 - 1) / kR2));
  ssd_bwd_chunk<<<grid2, kThreads, smem2, sm>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* ssd_chunk_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
