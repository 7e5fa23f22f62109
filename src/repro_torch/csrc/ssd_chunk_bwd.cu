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
// The tiled route (q > kQMax, where C.B^T alone passes 64 KB) has the
// same two passes and no atomics, with the chunk's columns split across
// blocks; every product on mma.sync in 3xTF32:
// * heads pass, a block of 8 warps per (chunk, group of HG heads, role):
//   - "cols" blocks, each the pair of 32-column strips p and n - 1 - p of
//     the chunk's columns j (n = q / 32; every pair has about as many
//     entries under the diagonal): the block forms C.B^T of its columns
//     against the rows i >= j once a group, into shared memory.  For
//     each head and P tile it first runs E = B_J dst^T over S (dst
//     staged 32 columns at a time) into dx's accumulators, then streams
//     dy in 64-row i tiles through a cp.async double buffer; a tile's
//     L = exp(cum_i - cum_j) is formed once into shared memory (the
//     exponential only where i >= j), then dx_J += M^T dy_i (a warp a
//     16-row strip of both strips, so every warp has the same work) and
//     dM = dy_i x_J^T, once a head (a warp a 16 x 32 item), with its
//     share of the group's dCB (added in shared memory, in head order),
//     G's row sums (to scratch by strip) and column sums, and dM o CB o
//     L's column sums.  At a head's end it writes ddt_J, dcum_J's own
//     terms (- colsum G - u w) and the block's share of sum_j u_j w_j.
//   - "state" blocks, 128 rows j by 128 columns of S: dB's state term
//     sum_h (x o w) dst_h for the group, w formed once a head.
//   The group's dCB (lower triangle) and state term go to scratch.  Where
//   a cols block's strips pass shared memory (q over ~400), the i tiles
//   go in windows: dx, ddt and dcum are read back at the next window.
// * chunk pass, a block per (chunk, 64 rows, 64 columns of S, dC or dB):
//   the groups' dCB summed in group order as it is staged, dC = dCB B
//   and dB = dCB^T C + the groups' state terms; the dC blocks of the first
//   S tile add to dcum the strips' row sums of G, in strip order, and at
//   the chunk's last row the blocks' shares of sum_j u_j w_j.  dM is not
//   formed again.
// What holds it (tools/ssd_chunk_variants.py --backward at chunk 256):
// the heads pass, ~0.77 of ~0.9 ms at bs 1; the products issue in waves
// (tf32x3::mma3_row, as the forward's), which took the chunk pass from
// 0.15 to 0.07 ms and left the heads pass as it was.
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

using namespace ssd;
using tf32x3::Frag;

constexpr int kCW = 32;              // columns j of a strip
constexpr int kJ = 2 * kCW;          // a cols block's columns: two strips
constexpr int kIT = 64;              // rows of an i tile (a dy stage)
constexpr int kLdC = kCW + 4;        // C.B^T's and dCB's strip rows, = 4
                                     // mod 32 (M^T's fragments read across
                                     // rows)
constexpr int kLdL = kJ + 4;         // a tile's L rows: = 4 mod 32
constexpr int kLdD = kPT + 4;        // dy stage rows: = 4 mod 32 (load_b)
constexpr int kLdXJ = kPT + 8;       // x_J rows: = 8 mod 32 (load_bt)
constexpr int kSE = 32;              // S columns an E step (and a C.B^T one)
constexpr int kLdE = kSE + 8;        // staged B_J, dst and C rows: = 8 mod 32
constexpr int kStage = 2 * kJ * kLdE;      // an E stage: B_J and dst
constexpr int kXJ = kJ * kLdXJ;            // an x_J tile
constexpr int kSlots = 12 * kJ;      // a head's sums: u by P quarter, G's
                                     // and dM CB L's column sums by i strip
static_assert(kIT * kLdD <= kStage, "a dy stage fits an E stage");
// the state blocks: 128 rows j by 128 columns of S
constexpr int kSJ = 128, kSS = 128;
constexpr int kLdSX = kPT + 8;       // x rows: = 8 mod 32 (A fragments)
constexpr int kLdSD = kSS + 4;       // dst rows: = 4 mod 32 (B fragments)
constexpr int kSStage = kSJ * kLdSX + kPT * kLdSD;
// the chunk pass: 64 rows by 64 columns of S, k staged 32 at a time
constexpr int kCR = 64, kCS = 64, kCK = 32;
constexpr int kLdA = kCK + 8;        // staged dCB (or dCB^T) rows: = 8 mod 32
constexpr int kLdK = kCS + 4;        // staged B (or C) rows: = 4 mod 32

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
  float* part_cb;   // [BN][G][Q][Q]: each group's dCB, lower triangle
  float* part_st;   // [BN][G][Q][S]: each group's state term of dB
  float* rowg;      // [BN][n32][QV][H]: G's row sums by column strip
  float* totp;      // [BN][npairs][H]: each cols block's sum of u w
  int H, Q, P, S;
  int n32;          // 32-column strips
  int n64;          // 64-row i tiles
  int npairs;       // cols blocks a group: strips p and n32 - 1 - p
  int roles;        // blocks a group: npairs, then the state blocks
  int nP;           // 64-column P tiles
  int HG, G;        // heads a group, groups
  int W;            // i tiles a window
  int QV;           // n64 * 64
  int o_l, o_r, o_x, o_v;   // offsets (floats): L, the ring, x_J, vectors
  int vx;           // x and dy rows 16-byte aligned
  int vbc;          // B and C rows 16-byte aligned
  int vst;          // dst rows 16-byte aligned
  int vdx;          // dx in 8-byte pairs
  int vs2;          // dB, dC and the state term in 8-byte pairs
};

// a strip's rows of C.B^T in a window of i tiles [it0, it1): from its
// first row's i tile, or the window's
__host__ __device__ __forceinline__ int strip_lo(int s, int it0) {
  const int a = kIT * (s / 2), b = kIT * it0;
  return a > b ? a : b;
}

int strip_rows(int s, int it0, int it1) {
  const int r = kIT * it1 - strip_lo(s, it0);
  return r > 0 ? r : 0;
}

// floats of a cols block's C.B^T and dCB (the most any pair and window
// takes at W i tiles a window) and of a block's shared memory: the
// region, a tile's L, two stages, two x_J tiles (or the state blocks'
// two stages), the vectors (cum and dt by head parity, w and w_end by
// head parity, the sums by head parity)
long long region_floats(const Args& a, int W) {
  long long most = 0;
  for (int pr = 0; pr < a.npairs; ++pr) {
    const int sa = pr, sb = a.n32 - 1 - pr;
    for (int it0 = sa / 2; it0 < a.n64; it0 += W) {
      const int it1 = it0 + W < a.n64 ? it0 + W : a.n64;
      const long long r = strip_rows(sa, it0, it1) +
                          (sb != sa ? strip_rows(sb, it0, it1) : 0);
      if (r > most) most = r;
    }
  }
  return 2 * kLdC * most;
}

struct Launch {
  Args a;
  dim3 grid1, grid2;
  long long smem, scratch;
};

void set_offsets(Args& a, long long region) {
  a.o_l = (int)region;
  a.o_r = a.o_l + kIT * kLdL;
  a.o_x = a.o_r + 2 * kStage;
  a.o_v = a.o_x + 2 * kXJ > 2 * kSStage ? a.o_x + 2 * kXJ : 2 * kSStage;
}

long long smem_bytes(const Args& a) {
  return 4 * ((long long)a.o_v + 4ll * a.QV + 4 * kJ + 2 * kSlots);
}

long long round4(long long n) { return (n + 3) / 4 * 4; }

// The widest window that fits (W = 0: none does), and the heads a group:
// one 8-warp block an SM (its shared memory allows no second), the HG
// that minimises whole waves x the slower block's multiply-adds (a cols
// block: its heads' E, M^T dy and dM and its C.B^T; a state block: its
// heads' state term).  Scratch: each section rounded to 4 floats.
Launch make_launch(int BN, int H, int Q, int P, int S) {
  Launch l;
  Args& a = l.a;
  a = Args{};
  a.H = H;
  a.Q = Q;
  a.P = P;
  a.S = S;
  a.n32 = (Q + kCW - 1) / kCW;
  a.n64 = (Q + kIT - 1) / kIT;
  a.npairs = (a.n32 + 1) / 2;
  a.roles = a.npairs + ((Q + kSJ - 1) / kSJ) * ((S + kSS - 1) / kSS);
  a.nP = (P + kPT - 1) / kPT;
  a.QV = a.n64 * kIT;
  for (int w = a.n64; w >= 1 && !a.W; --w) {
    set_offsets(a, region_floats(a, w));
    if (smem_bytes(a) <= kMaxSmem) a.W = w;
  }
  if (!a.W) set_offsets(a, region_floats(a, 1));
  l.smem = smem_bytes(a);
  const long long slots = ssd::sm_count();
  const double pp = a.nP * (double)kPT, sp = (S + kSE - 1) / kSE * kSE;
  const double tri = (a.n64 + 1.0) * kIT * kCW;   // a pair's entries
  const double cols_head = pp * (kJ * sp + 2 * tri), cols_cb = tri * sp;
  const double st_head = pp * kSJ * kSS;
  a.HG = 1;
  double best = 0;
  for (int hg = 1; hg <= H; ++hg) {
    const long long gy = (long long)((H + hg - 1) / hg) * a.roles;
    if (gy > 65535) continue;
    const double waves = (double)((BN * gy + slots - 1) / slots);
    const double cost = waves * fmax(hg * cols_head + cols_cb, hg * st_head);
    if (best == 0 || cost < best) {
      a.HG = hg;
      best = cost;
    }
  }
  a.G = (H + a.HG - 1) / a.HG;
  l.grid1 = dim3((unsigned)BN, (unsigned)((long long)a.G * a.roles));
  l.grid2 = dim3((unsigned)BN, (unsigned)a.n64,
                 (unsigned)(2 * ((S + kCS - 1) / kCS)));
  l.scratch = round4((long long)BN * a.G * Q * Q) +
              round4((long long)BN * a.G * Q * S) +
              round4((long long)BN * a.n32 * a.QV * H) +
              round4((long long)BN * a.npairs * H);
  return l;
}

bool valid(const Launch& l) { return l.a.W > 0 && l.grid1.y <= 65535; }

__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_heads_tiled(const Args p) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long bn = blockIdx.x;   // b * nc + n
  const int grp = blockIdx.y / p.roles, role = blockIdx.y % p.roles;
  const int h0 = grp * p.HG, hg = min(p.HG, p.H - h0);
  const int Q = p.Q, QV = p.QV, nP = p.nP, units = hg * nP;
  const long long HP = (long long)p.H * p.P;
  float* cumv = smem + p.o_v;        // 2 x QV: a head's cum, by parity
  float* dtv = cumv + 2 * QV;        // 2 x QV: its dt
  for (int e = threadIdx.x; e < 4 * QV; e += kThreads)
    if (e % QV >= Q) cumv[e] = 0.f;   // past Q: zero (the loads skip it)
  auto issue_vectors = [&](int hh) {
    const int h = h0 + hh;
    float* cb = cumv + (hh & 1) * QV;
    float* db = dtv + (hh & 1) * QV;
    for (int e = threadIdx.x; e < Q; e += kThreads) {
      tf32x3::cp_async4(cb + e, p.cum + (bn * Q + e) * p.H + h);
      tf32x3::cp_async4(db + e, p.dt + (bn * Q + e) * p.H + h);
    }
  };

  if (role >= p.npairs) {
    // ---- a state block: sum over the group's heads of (x o w) dst_h ----
    const int sr = role - p.npairs, nst = (p.S + kSS - 1) / kSS;
    const int j0 = (sr / nst) * kSJ, c0 = (sr % nst) * kSS;
    const int jm = warp >> 1, sn = warp & 1;   // rows 32 jm, columns 64 sn
    auto issue = [&](int u) {
      const int hh = u / nP, pt = u - hh * nP, h = h0 + hh, p0 = pt * kPT;
      float* xs = smem + (u & 1) * kSStage;
      load_tile(xs, kLdSX, p.x + ((bn * Q + j0) * p.H + h) * (long long)p.P
                + p0, HP, kSJ, kPT, min(kSJ, Q - j0), min(kPT, p.P - p0),
                p.vx);
      load_tile(xs + kSJ * kLdSX, kLdSD,
                p.dst + ((bn * p.H + h) * (long long)p.P + p0) * p.S + c0,
                p.S, kPT, kSS, min(kPT, p.P - p0), min(kSS, p.S - c0), p.vst);
      if (pt == 0) issue_vectors(hh);
    };
    float acc[2][8][4] = {};
    issue(0);
    tf32x3::cp_async_commit();
    for (int u = 0; u < units; ++u) {
      const int hh = u / nP;
      tf32x3::cp_async_wait<0>();
      __syncthreads();   // unit u landed; unit u - 1 is read
      if (u + 1 < units) issue(u + 1);
      tf32x3::cp_async_commit();
      const float* xs = smem + (u & 1) * kSStage;
      const float* ds = xs + kSJ * kLdSX;
      const float* cum = cumv + (hh & 1) * QV;
      const float* dt = dtv + (hh & 1) * QV;
      const float cend = cum[Q - 1];
      float w[2][2];   // the warp's rows' w, once a unit
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int j = j0 + 32 * jm + 16 * m + g + 8 * a;
          w[m][a] = j < Q ? __expf(cend - cum[j]) * dt[j] : 0.f;
        }
#pragma unroll 2
      for (int ks = 0; ks < kPT / 8; ++ks) {
        Frag<4> af[2];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const float* x0 = xs + (32 * jm + 16 * m + g) * kLdSX + 8 * ks
                            + 2 * t;
          const float2 lo = *reinterpret_cast<const float2*>(x0);
          const float2 hi = *reinterpret_cast<const float2*>(x0 + 8 * kLdSX);
          const float v[4] = {lo.x * w[m][0], hi.x * w[m][1], lo.y * w[m][0],
                              hi.y * w[m][1]};
          tf32x3::split_fast(af[m], v);
        }
        Frag<2> b[8];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          b[nt] = tf32x3::load_b<true>(ds, kLdSD, 8 * ks, 64 * sn + 8 * nt,
                                       lane);
#pragma unroll
        for (int m = 0; m < 2; ++m) tf32x3::mma3_row(acc[m], af[m], b);
      }
    }
    float* ps = p.part_st + (bn * p.G + grp) * (long long)Q * p.S;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int j = j0 + 32 * jm + 16 * m + g;
        const int col = c0 + 64 * sn + 8 * nt + 2 * t;
        if (j < Q)
          store2(ps, (long long)j * p.S + col, col, p.S, acc[m][nt][0],
                 acc[m][nt][1], p.vs2);
        if (j + 8 < Q)
          store2(ps, (long long)(j + 8) * p.S + col, col, p.S, acc[m][nt][2],
                 acc[m][nt][3], p.vs2);
      }
    return;
  }

  // ---- a cols block: the strips sa and sb of the chunk's columns --------
  const int pair = role, sa = pair, sb = p.n32 - 1 - pair;
  const int nstr = sa == sb ? 1 : 2;
  const int sk[2] = {sa, sb};
  float* Lt = smem + p.o_l;            // kIT x kLdL: the tile's L
  float* ring = smem + p.o_r;          // 2 stages
  float* xjb = smem + p.o_x;           // 2 x_J tiles, by unit parity
  float* wv = dtv + 2 * QV;            // 2 x kJ: w_J, by head parity
  float* wendv = wv + 2 * kJ;          // 2 x kJ: w_end
  float* slots = wendv + 2 * kJ;       // 2 x kSlots, by head parity
  const int mi = warp & 1, pq = warp >> 1;   // dx: rows 16 mi of each
                                             // strip, P columns 16 pq
  const int im = warp & 3, kw = warp >> 2;   // dM: rows 16 im of the
                                             // tile, strip kw
  const int first_it = sa / 2;
  const int nE = (p.S + kSE - 1) / kSE;
  const int nwin = (p.n64 - first_it + p.W - 1) / p.W;
  for (int e = threadIdx.x; e < 2 * kSlots; e += kThreads) slots[e] = 0.f;

  for (int win = 0; win < nwin; ++win) {
    const int it0 = first_it + win * p.W, it1 = min(it0 + p.W, p.n64);
    int lo[2], nr[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      lo[k] = strip_lo(sk[k], it0);
      nr[k] = k < nstr ? max(0, kIT * it1 - lo[k]) : 0;
    }
    // strip k's row i at cbk[k] + (i - lo[k]) kLdC (dCB: dck[k])
    float* cbk[2] = {smem, smem + nr[0] * kLdC};
    float* dck[2] = {smem + (nr[0] + nr[1]) * kLdC,
                     smem + (2 * nr[0] + nr[1]) * kLdC};
    const int ne = win == 0 ? nE : 0;          // E steps a unit
    const int nsu = ne + it1 - it0;            // steps a unit
    const int steps = units * nsu;

    // ddt, dcum and the share of sum u w of the group's head hf from the
    // sums its steps left (warp 0, two columns a lane; the slots are
    // zeroed as they are read, for the head two after)
    auto finish = [&](int hf) {
      const int pf = hf & 1, h = h0 + hf;
      float* sl = slots + pf * kSlots;
      float tot = 0.f;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int jl = lane + kCW * k, j = kCW * sk[k] + lane;
        float u = 0.f, cg = 0.f, ct = 0.f;
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4) {
          u += sl[q4 * kJ + jl];
          cg += sl[(4 + q4) * kJ + jl];
          ct += sl[(8 + q4) * kJ + jl];
          sl[q4 * kJ + jl] = sl[(4 + q4) * kJ + jl] =
              sl[(8 + q4) * kJ + jl] = 0.f;
        }
        if (k < nstr && j < Q) {
          const long long o = (bn * Q + j) * p.H + h;
          if (win == 0) {
            const float uw = u * wv[pf * kJ + jl];
            p.ddt[o] = ct + u * wendv[pf * kJ + jl];
            p.dcum[o] = -cg - uw;
            tot += uw;
          } else {
            p.ddt[o] += ct;
            p.dcum[o] -= cg;
          }
        }
      }
      if (win == 0) {
#pragma unroll
        for (int s = 16; s; s >>= 1) tot += __shfl_xor_sync(0xffffffffu, tot, s);
        if (lane == 0) p.totp[(bn * p.npairs + pair) * p.H + h] = tot;
      }
    };

    __syncthreads();   // the last window is read
    for (int e = threadIdx.x; e < 2 * (nr[0] + nr[1]) * kLdC; e += kThreads)
      smem[e] = 0.f;   // entries never formed read as 0
    // C.B^T of the window's rows against the strips' columns: a warp an
    // item (16 rows of the i tile, a strip), S in 32-column steps with
    // the tile's C and B_J staged in the ring
    {
      float* cst = ring;
      float* bst = ring + kIT * kLdE;
      for (int it = it0; it < it1; ++it) {
        const bool act = kw < nstr && kIT * it + 16 * im + 15 >=
                         kCW * (kw ? sb : sa) && kIT * it + 16 * im < Q;
        float c[4][4] = {};
        for (int sc = 0; sc < nE; ++sc) {
          const int c0 = sc * kSE, cw = min(kSE, p.S - c0);
          __syncthreads();   // the staging is read (and the zeroing done)
          load_tile(cst, kLdE, p.C + (bn * Q + kIT * it) * p.S + c0, p.S,
                    kIT, kSE, min(kIT, Q - kIT * it), cw, p.vbc);
#pragma unroll
          for (int k = 0; k < 2; ++k)
            load_tile(bst + k * kCW * kLdE, kLdE,
                      p.B + (bn * Q + kCW * sk[k]) * p.S + c0, p.S, kCW, kSE,
                      k < nstr ? min(kCW, Q - kCW * sk[k]) : 0, cw, p.vbc);
          tf32x3::cp_async_commit();
          tf32x3::cp_async_wait<0>();
          __syncthreads();
          if (act) {
#pragma unroll
            for (int ks = 0; ks < kSE / 8; ++ks) {
              const Frag<4> af = tf32x3::load_a<true>(cst, kLdE, 16 * im,
                                                      8 * ks, lane);
              Frag<2> b[4];
#pragma unroll
              for (int n = 0; n < 4; ++n)
                b[n] = tf32x3::load_bt<true>(bst, kLdE, kCW * kw + 8 * n,
                                             8 * ks, lane);
              tf32x3::mma3_row(c, af, b);
            }
          }
        }
        if (act) {
          float* o = (kw ? cbk[1] : cbk[0]) +
                     (kIT * it + 16 * im + g - (kw ? lo[1] : lo[0])) * kLdC
                     + 2 * t;
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            *reinterpret_cast<float2*>(o + 8 * n) = make_float2(c[n][0],
                                                                c[n][1]);
            *reinterpret_cast<float2*>(o + 8 * kLdC + 8 * n) =
                make_float2(c[n][2], c[n][3]);
          }
        }
      }
    }
    __syncthreads();   // C.B^T formed; the staging is the ring's again

    // step d of the window: unit d / nsu's E step (B_J's and dst_h's 32
    // columns of S) or dy's i tile, into ring half d & 1; with a unit's
    // first step its x_J, and with a head's its cum and dt
    auto issue = [&](int d) {
      const int u = d / nsu, ks = d - u * nsu;
      const int hh = u / nP, pt = u - hh * nP, h = h0 + hh, p0 = pt * kPT;
      float* st = ring + (d & 1) * kStage;
      if (ks < ne) {
        const int c0 = ks * kSE, cw = min(kSE, p.S - c0);
#pragma unroll
        for (int k = 0; k < 2; ++k)
          load_tile(st + k * kCW * kLdE, kLdE,
                    p.B + (bn * Q + kCW * sk[k]) * p.S + c0, p.S, kCW, kSE,
                    k < nstr ? min(kCW, Q - kCW * sk[k]) : 0, cw, p.vbc);
        load_tile(st + kJ * kLdE, kLdE,
                  p.dst + ((bn * p.H + h) * (long long)p.P + p0) * p.S + c0,
                  p.S, kPT, kSE, min(kPT, p.P - p0), cw, p.vst);
      } else {
        const int r0 = kIT * (it0 + ks - ne);
        load_tile(st, kLdD, p.dy + ((bn * Q + r0) * p.H + h) * (long long)p.P
                  + p0, HP, kIT, kPT, min(kIT, Q - r0), min(kPT, p.P - p0),
                  p.vx);
      }
      if (ks == 0) {
        float* xj = xjb + (u & 1) * kXJ;
#pragma unroll
        for (int k = 0; k < 2; ++k)
          load_tile(xj + k * kCW * kLdXJ, kLdXJ,
                    p.x + ((bn * Q + kCW * sk[k]) * p.H + h) * (long long)p.P
                    + p0, HP, kCW, kPT,
                    k < nstr ? min(kCW, Q - kCW * sk[k]) : 0,
                    min(kPT, p.P - p0), p.vx);
        if (pt == 0) issue_vectors(hh);
      }
    };

    issue(0);
    tf32x3::cp_async_commit();
    float acc[2][2][4];   // dx (E first): strip k's rows 16 mi, n8 tile nt
    for (int d = 0; d < steps; ++d) {
      const int u = d / nsu, ks = d - u * nsu;
      const int hh = u / nP, pt = u - hh * nP, h = h0 + hh, par = hh & 1;
      const int p0 = pt * kPT;
      tf32x3::cp_async_wait<0>();
      __syncthreads();   // step d landed; step d - 1 is read
      if (d + 1 < steps) issue(d + 1);
      tf32x3::cp_async_commit();
      const float* st = ring + (d & 1) * kStage;
      const float* xj = xjb + (u & 1) * kXJ;
      const float* cum = cumv + par * QV;
      const float* dt = dtv + par * QV;
      float* sl = slots + par * kSlots;

      if (ks == 0 && pt == 0) {   // a head's first step
        if (hh && warp == 0) finish(hh - 1);
        const int jl = threadIdx.x - 64;   // w and w_end of its columns
        if (jl >= 0 && jl < kJ) {
          const int k = jl / kCW, j = kCW * (k ? sb : sa) + jl % kCW;
          const bool in = k < nstr && j < Q;
          const float we = in ? __expf(cum[Q - 1] - cum[j]) : 0.f;
          wendv[par * kJ + jl] = we;
          wv[par * kJ + jl] = in ? we * dt[j] : 0.f;
        }
      }
      if (ks == 0) {   // the unit's dx: 0 (E comes first), or the last
                       // window's
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            float2 l0 = make_float2(0.f, 0.f), l1 = l0;
            const int j = kCW * sk[k] + 16 * mi + g;
            const int col = p0 + 16 * pq + 8 * nt + 2 * t;
            if (win && k < nstr) {
              const long long o = ((bn * Q + j) * p.H + h) * (long long)p.P
                                  + col;
              if (j < Q) l0 = load2(p.dx, o, col, p.P);
              if (j + 8 < Q) l1 = load2(p.dx, o + 8 * HP, col, p.P);
            }
            acc[k][nt][0] = l0.x; acc[k][nt][1] = l0.y;
            acc[k][nt][2] = l1.x; acc[k][nt][3] = l1.y;
          }
      }

      if (ks < ne) {   // E += B_J dst_h^T over 32 columns of S
        const float* ds = st + kJ * kLdE;
#pragma unroll
        for (int k8 = 0; k8 < kSE / 8; ++k8) {
          Frag<4> af[2];
#pragma unroll
          for (int k = 0; k < 2; ++k)
            af[k] = tf32x3::load_a<true>(st, kLdE, kCW * k + 16 * mi, 8 * k8,
                                         lane);
          Frag<2> b[2];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            b[nt] = tf32x3::load_bt<true>(ds, kLdE, 16 * pq + 8 * nt, 8 * k8,
                                          lane);
#pragma unroll
          for (int k = 0; k < 2; ++k)
            if (k < nstr) tf32x3::mma3_row(acc[k], af[k], b);
        }
        continue;
      }

      const int r0 = kIT * (it0 + ks - ne);
      // the tile's L against the block's columns, the exponential only
      // where i >= j
      for (int e = threadIdx.x; e < kIT * kJ; e += kThreads) {
        const int il = e / kJ, jl = e - il * kJ, k = jl / kCW;
        const int i = r0 + il, j = kCW * (k ? sb : sa) + jl % kCW;
        const bool on = k < nstr && i >= j && i < Q && j < Q;
        Lt[il * kLdL + jl] = on ? __expf(cum[i] - cum[j]) : 0.f;
      }
      if (ks == ne && win == 0) {
        // E is complete: u = sum_p x E (by P quarter), then dx = w E
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int jl0 = kCW * k + 16 * mi + g, jl1 = jl0 + 8;
          float u0 = 0.f, u1 = 0.f;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int pc = 16 * pq + 8 * nt + 2 * t;
            u0 += xj[jl0 * kLdXJ + pc] * acc[k][nt][0] +
                  xj[jl0 * kLdXJ + pc + 1] * acc[k][nt][1];
            u1 += xj[jl1 * kLdXJ + pc] * acc[k][nt][2] +
                  xj[jl1 * kLdXJ + pc + 1] * acc[k][nt][3];
          }
          u0 = quad_sum(u0);
          u1 = quad_sum(u1);
          if (t == 0) {
            sl[pq * kJ + jl0] += u0;
            sl[pq * kJ + jl1] += u1;
          }
          const float w0 = wv[par * kJ + jl0], w1 = wv[par * kJ + jl1];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            acc[k][nt][0] *= w0;
            acc[k][nt][1] *= w0;
            acc[k][nt][2] *= w1;
            acc[k][nt][3] *= w1;
          }
        }
      }
      __syncthreads();   // L formed

      // dx_J += M^T dy_i: M^T's fragments from C.B^T, L and dt_j
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int jd = kCW * sk[k] + 16 * mi;   // the 16 rows' first j
        if (k >= nstr || r0 + kIT <= jd) continue;
        const int jl = kCW * k + 16 * mi + g;
        const int j0 = jd + g;
        const float dj0 = dt[j0], dj1 = dt[j0 + 8];
        // row i of the strip's C.B^T at cb + (i - r0) kLdC
        const float* cb = cbk[k] + (r0 - lo[k]) * kLdC + 16 * mi + g;
        for (int k8 = max(0, (jd - r0) / 8); k8 < kIT / 8; ++k8) {
          const int il0 = 8 * k8 + 2 * t;
          const float v[4] = {
              cb[il0 * kLdC] * Lt[il0 * kLdL + jl] * dj0,
              cb[il0 * kLdC + 8] * Lt[il0 * kLdL + jl + 8] * dj1,
              cb[(il0 + 1) * kLdC] * Lt[(il0 + 1) * kLdL + jl] * dj0,
              cb[(il0 + 1) * kLdC + 8] * Lt[(il0 + 1) * kLdL + jl + 8] * dj1};
          Frag<4> af;
          tf32x3::split_fast(af, v);
          Frag<2> b[2];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            b[nt] = tf32x3::load_b<true>(st, kLdD, 8 * k8, 16 * pq + 8 * nt,
                                         lane);
          tf32x3::mma3_row(acc[k], af, b);
        }
      }

      // dM = dy_i x_J^T for the warp's item, then its share of dCB and
      // the sums of G = dM o M (i != j: G_ii cancels) and dM o CB o L
      {
        const int s = kw ? sb : sa, ri = r0 + 16 * im;
        if (kw < nstr && ri + 15 >= kCW * s && ri < Q) {
          float dm[4][4] = {};
#pragma unroll 2
          for (int k8 = 0; k8 < kPT / 8; ++k8) {
            const Frag<4> af = tf32x3::load_a<true>(st, kLdD, 16 * im, 8 * k8,
                                                    lane);
            Frag<2> b[4];
#pragma unroll
            for (int n = 0; n < 4; ++n)
              b[n] = tf32x3::load_bt<true>(xj, kLdXJ, kCW * kw + 8 * n,
                                           8 * k8, lane);
            tf32x3::mma3_row(dm, af, b);
          }
          // row il of the tile at cb + il kLdC (dCB: dc)
          const int ro = (r0 - (kw ? lo[1] : lo[0])) * kLdC;
          const float* cb = (kw ? cbk[1] : cbk[0]) + ro;
          float* dc = (kw ? dck[1] : dck[0]) + ro;
          float rg[2] = {0.f, 0.f}, cg[4][2] = {}, ct[4][2] = {};
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int a = e >> 1, b = e & 1;
              const int il = 16 * im + g + 8 * a, i = r0 + il;
              const int jl = 8 * n + 2 * t + b, j = kCW * s + jl;
              const bool on = i >= j && i < Q && j < Q;
              const float dl = (on ? dm[n][e] : 0.f) *
                               Lt[il * kLdL + kCW * kw + jl];
              const float dj = dt[j];
              if (on) dc[il * kLdC + jl] += dl * dj;   // dCB
              const float tv = dl * cb[il * kLdC + jl];  // dM CB L
              const float gv = tv * dj;                  // dM M
              if (i != j) {
                rg[a] += gv;
                cg[n][b] += gv;
              }
              ct[n][b] += tv;
            }
          rg[0] = quad_sum(rg[0]);
          rg[1] = quad_sum(rg[1]);
          if (t == 0) {   // G's row sums of strip s, summed over P tiles
            float* o = p.rowg + ((bn * p.n32 + s) * QV + ri + g) * p.H + h;
            o[0] = (pt ? o[0] : 0.f) + rg[0];
            o[8 * p.H] = (pt ? o[8 * p.H] : 0.f) + rg[1];
          }
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int b = 0; b < 2; ++b) {
              const float vg = column_sum(cg[n][b]);
              const float vt = column_sum(ct[n][b]);
              if (g == 0) {
                const int jl = kCW * kw + 8 * n + 2 * t + b;
                sl[(4 + im) * kJ + jl] += vg;
                sl[(8 + im) * kJ + jl] += vt;
              }
            }
        }
      }

      if (ks == nsu - 1) {   // the unit's last step: dx
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          if (k >= nstr) continue;
          const int j = kCW * sk[k] + 16 * mi + g;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int col = p0 + 16 * pq + 8 * nt + 2 * t;
            const long long o = ((bn * Q + j) * p.H + h) * (long long)p.P
                                + col;
            if (j < Q)
              store2(p.dx, o, col, p.P, acc[k][nt][0], acc[k][nt][1], p.vdx);
            if (j + 8 < Q)
              store2(p.dx, o + 8 * HP, col, p.P, acc[k][nt][2],
                     acc[k][nt][3], p.vdx);
          }
        }
      }
    }
    __syncthreads();   // the last head's sums and the window's dCB written
    if (warp == 0) finish(hg - 1);
    // the group's dCB of the window's rows, lower triangle
    float* pc = p.part_cb + (bn * p.G + grp) * (long long)Q * Q;
#pragma unroll
    for (int k = 0; k < 2; ++k)
      for (int e = threadIdx.x; e < nr[k] * kCW; e += kThreads) {
        const int r = e / kCW, c = e - r * kCW;
        const int i = lo[k] + r, j = kCW * sk[k] + c;
        if (i < Q && j < Q && i >= j)
          pc[(long long)i * Q + j] = dck[k][r * kLdC + c];
      }
  }
}

// a block per (chunk, 64 rows r0, 64 columns of S, dC or dB): dC_i =
// sum_{j <= i} dCB_ij B_j, dB_j = sum_{i >= j} dCB_ij C_i + the state
// terms, dCB summed over the groups in order as it is staged; then (dC
// blocks of the first S tile) dcum's strips' row sums of G and cum_end's
// share
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk_tiled(const Args p) {
  __shared__ __align__(16) float as[kCR * kLdA];
  __shared__ __align__(16) float bs[kCK * kLdK];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long bn = blockIdx.x;
  const int Q = p.Q, S = p.S, r0 = blockIdx.y * kCR;
  const int nsc = (S + kCS - 1) / kCS;
  const bool dc = (int)blockIdx.z < nsc;
  const int c0 = (blockIdx.z % nsc) * kCS;
  const long long QQ = (long long)Q * Q;
  const float* pc = p.part_cb + bn * p.G * QQ;
  const int mi = warp >> 1, nh = warp & 1;   // rows 16 mi, columns 32 nh
  float acc[4][4] = {};
  const int klo = dc ? 0 : r0, khi = dc ? min(r0 + kCR, Q) : Q;
  for (int k0 = klo; k0 < khi; k0 += kCK) {
    __syncthreads();   // the staging is read
    for (int e = threadIdx.x; e < kCR * kCK; e += kThreads) {
      // dC: row a, k = j (contiguous); dB: k = i, row a = j (contiguous)
      const int a = dc ? e / kCK : e % kCR, kk = dc ? e % kCK : e / kCR;
      const int i = dc ? r0 + a : k0 + kk, j = dc ? k0 + kk : r0 + a;
      float v = 0.f;
      if (i >= j && i < Q && j < Q)
        for (int gi = 0; gi < p.G; ++gi) v += pc[gi * QQ + (long long)i * Q + j];
      as[a * kLdA + kk] = v;
    }
    load_tile(bs, kLdK, (dc ? p.B : p.C) + (bn * Q + k0) * S + c0, S, kCK,
              kCS, min(kCK, Q - k0), min(kCS, S - c0), p.vbc);
    tf32x3::cp_async_commit();
    tf32x3::cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kCK / 8; ++ks) {
      const Frag<4> af = tf32x3::load_a<true>(as, kLdA, 16 * mi, 8 * ks, lane);
      Frag<2> b[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        b[nt] = tf32x3::load_b<true>(bs, kLdK, 8 * ks, 32 * nh + 8 * nt, lane);
      tf32x3::mma3_row(acc, af, b);
    }
  }
  float* out = dc ? p.dC : p.dB;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int r = r0 + 16 * mi + g + 8 * a;
      const int col = c0 + 32 * nh + 8 * nt + 2 * t;
      if (r >= Q) continue;
      float v0 = acc[nt][2 * a], v1 = acc[nt][2 * a + 1];
      if (!dc)
        for (int gi = 0; gi < p.G; ++gi) {
          const float2 s2 = load2(p.part_st, ((bn * p.G + gi) * Q + r) *
                                                 (long long)S + col, col, S);
          v0 += s2.x;
          v1 += s2.y;
        }
      store2(out, (bn * Q + r) * S + col, col, S, v0, v1, p.vs2);
    }
  if (dc && c0 == 0)
    for (int e = threadIdx.x; e < kCR * p.H; e += kThreads) {
      const int i = r0 + e / p.H, h = e % p.H;
      if (i >= Q) continue;
      const long long o = (bn * Q + i) * p.H + h;
      float v = p.dcum[o];
      for (int s = 0; s <= i / kCW; ++s)
        v += p.rowg[((bn * p.n32 + s) * p.QV + i) * p.H + h];
      if (i == Q - 1)
        for (int pr = 0; pr < p.npairs; ++pr)
          v += p.totp[(bn * p.npairs + pr) * p.H + h];
      p.dcum[o] = v;
    }
}

int launch(const Launch& l, cudaStream_t stream) {
  static long long attr_set[64];
  cudaError_t err = set_smem(ssd_bwd_heads_tiled, l.smem, attr_set);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_heads_tiled<<<l.grid1, kThreads, l.smem, stream>>>(l.a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_chunk_tiled<<<l.grid2, kThreads, 0, stream>>>(l.a);
  return (int)cudaGetLastError();
}

}  // namespace tlb

// floats of scratch a call takes: each group's partial dCB and state term
// (on the tiled route also G's row sums by strip and the cols blocks'
// shares of sum u w)
extern "C" long long ssd_chunk_backward_scratch(int BN, int H, int Q, int P,
                                                int S) {
  if (!valid(BN, H, Q, P, S)) return 0;
  if (Q > kQMax) return tlb::make_launch(BN, H, Q, P, S).scratch;
  const Plan pl = plan(BN, H, Q, P, S);
  return (long long)BN * pl.G *
         ((long long)pl.QP * pl.QP + (long long)Q * pl.SP);
}

// the heads pass's plan: out[0..9] = heads a group, groups, warps a block,
// blocks an SM, shared memory bytes, B resident, state term on chip,
// tiled, the heads pass's grid y and the scratch's floats (the tiled route,
// q > kQMax: 8 warps, one block an SM, groups x (cols + state blocks) a
// chunk)
extern "C" int ssd_chunk_backward_plan(int BN, int H, int Q, int P, int S,
                                       long long* out) {
  if (!valid(BN, H, Q, P, S)) return (int)cudaErrorInvalidValue;
  if (Q > kQMax) {
    const tlb::Launch l = tlb::make_launch(BN, H, Q, P, S);
    const long long v[10] = {l.a.HG, l.a.G, ssd::kWarps, 1, l.smem, 0, 0, 1,
                             l.grid1.y, l.scratch};
    for (int i = 0; i < 10; ++i) out[i] = v[i];
    return tlb::valid(l) ? 0 : (int)cudaErrorInvalidValue;
  }
  const Plan pl = plan(BN, H, Q, P, S);
  const long long v[10] = {pl.HG, pl.G, kWarpsH, 1, pl.smem, pl.b_res,
                           pl.st_res, 0, pl.G,
                           ssd_chunk_backward_scratch(BN, H, Q, P, S)};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
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
    tlb::Launch l = tlb::make_launch(BN, H, Q, P, S);
    if (!tlb::valid(l)) return (int)cudaErrorInvalidValue;
    tlb::Args& a = l.a;
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
    a.part_cb = scratch;
    a.part_st = a.part_cb + tlb::round4((long long)BN * a.G * Q * Q);
    a.rowg = a.part_st + tlb::round4((long long)BN * a.G * Q * S);
    a.totp = a.rowg + tlb::round4((long long)BN * a.n32 * a.QV * H);
    a.vx = ssd::aligned(x, 16) && ssd::aligned(dy, 16) && P % 4 == 0;
    a.vbc = ssd::aligned(Bm, 16) && ssd::aligned(Cm, 16) && S % 4 == 0;
    a.vst = ssd::aligned(dst, 16) && S % 4 == 0;
    a.vdx = ssd::aligned(dx, 8) && P % 2 == 0;
    a.vs2 = ssd::aligned(dB, 8) && ssd::aligned(dC, 8) &&
            ssd::aligned(scratch, 8) && S % 2 == 0;
    return tlb::launch(l, (cudaStream_t)stream);
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
