// ssd_chunk: the Mamba-2 SSD intra-chunk block, fp32.
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
// cum_j is positive and can overflow, and inf * 0 would be NaN.
//
// What bounds it on an H100: at Mamba2-2.7B's widths (H = 80, P = 64,
// S = 128, chunk q = 64, a 2048-token sequence: 32 chunks) the outputs
// alone are 126 MB (y 42 MB, states 84 MB) against ~3.4 GFLOP, so bytes
// and operations bound it about equally, near 0.05 ms each.  The TPU
// kernel loops over all heads of a chunk in one grid step; here heads are
// in the grid, as groups of kHeads = 4 that share one CB tile (grid
// (bs * nc, H / 4): 640 blocks at full width).  A block holds B (q x S),
// C (q x S, whose space M and x[:, h, :] take once CB is built), CB (q x q)
// and the head's decay weights in shared memory, 84 KB at full width, so
// two blocks fit on an SM.  Every product runs from shared memory with each
// thread owning a 4 x 4 (CB, y) or 4 x 8 (states) register tile, strided by
// 16 so a warp's reads hit distinct banks (rows padded by one).  y and the
// states stream out once, contiguous along P and S.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTx = 16, kTy = 16;
constexpr int kHeads = 4;               // heads per block, sharing CB
constexpr int kQMax = 64, kPMax = 64, kSMax = 128;
constexpr int kQT = kQMax / kTy;        // CB and y rows per thread
constexpr int kCT = kQMax / kTx;        // CB columns per thread
constexpr int kPT = kPMax / kTx;        // y columns / state rows per thread
constexpr int kST = kSMax / kTx;        // state columns per thread

__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, const float* __restrict__ dt,
                 const float* __restrict__ cum, float* __restrict__ y,
                 float* __restrict__ st, int H, int Q, int P, int S) {
  extern __shared__ float smem[];
  const int ls = S + 1, lq = Q + 1, lp = P + 1;
  float* bs = smem;                               // Q x ls
  float* cs = bs + Q * ls;                        // Q x ls, until CB is built
  float* ms = cs;                                 // Q x lq, per head
  float* xs = ms + Q * lq;                        // Q x lp, per head
  float* cb = cs + max(Q * ls, Q * lq + Q * lp);  // Q x lq
  float* ws = cb + Q * lq;                        // Q: decay to chunk end
  float* cums = ws + Q;                           // Q
  float* dts = cums + Q;                          // Q
  const int tid = threadIdx.x, tx = tid % kTx, ty = tid / kTx;
  const long long bn = blockIdx.x;                // b * nc + n
  const int h0 = blockIdx.y * kHeads;

  for (int e = tid; e < Q * S; e += kThreads) {
    const int r = e / S, c = e - r * S;
    bs[r * ls + c] = Bm[bn * Q * S + e];
    cs[r * ls + c] = Cm[bn * Q * S + e];
  }
  __syncthreads();
  {  // CB[i, j], i = ty + 16 a, j = tx + 16 c
    float acc[kQT][kCT] = {};
    for (int s = 0; s < S; ++s) {
      float a[kQT], b[kCT];
#pragma unroll
      for (int t = 0; t < kQT; ++t) a[t] = cs[min(ty + kTy * t, Q - 1) * ls + s];
#pragma unroll
      for (int t = 0; t < kCT; ++t) b[t] = bs[min(tx + kTx * t, Q - 1) * ls + s];
#pragma unroll
      for (int i = 0; i < kQT; ++i)
#pragma unroll
        for (int j = 0; j < kCT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kQT; ++i)
#pragma unroll
      for (int j = 0; j < kCT; ++j) {
        const int r = ty + kTy * i, c = tx + kTx * j;
        if (r < Q && c < Q) cb[r * lq + c] = acc[i][j];
      }
  }

  for (int hh = 0; hh < kHeads; ++hh) {
    const int h = h0 + hh;
    if (h >= H) break;                            // uniform over the block
    __syncthreads();  // CB built and C dead; the last head's reads done
    for (int e = tid; e < Q * P; e += kThreads) {
      const int r = e / P, p = e - r * P;
      xs[r * lp + p] = x[((bn * Q + r) * H + h) * P + p];
    }
    for (int e = tid; e < Q; e += kThreads) {
      cums[e] = cum[(bn * Q + e) * H + h];
      dts[e] = dt[(bn * Q + e) * H + h];
    }
    __syncthreads();
    for (int e = tid; e < Q * Q; e += kThreads) {
      const int i = e / Q, j = e - i * Q;
      ms[i * lq + j] =
          i >= j ? cb[i * lq + j] * expf(cums[i] - cums[j]) * dts[j] : 0.f;
    }
    for (int e = tid; e < Q; e += kThreads)
      ws[e] = expf(cums[Q - 1] - cums[e]) * dts[e];
    __syncthreads();

    {  // y[i, p] = sum_j M[i, j] x[j, p], i = ty + 16 a, p = tx + 16 c
      float acc[kQT][kPT] = {};
      for (int j = 0; j < Q; ++j) {
        float a[kQT], b[kPT];
#pragma unroll
        for (int t = 0; t < kQT; ++t) a[t] = ms[min(ty + kTy * t, Q - 1) * lq + j];
#pragma unroll
        for (int t = 0; t < kPT; ++t) b[t] = xs[j * lp + min(tx + kTx * t, P - 1)];
#pragma unroll
        for (int i = 0; i < kQT; ++i)
#pragma unroll
          for (int c = 0; c < kPT; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
      }
#pragma unroll
      for (int i = 0; i < kQT; ++i)
#pragma unroll
        for (int c = 0; c < kPT; ++c) {
          const int r = ty + kTy * i, p = tx + kTx * c;
          if (r < Q && p < P) y[((bn * Q + r) * H + h) * P + p] = acc[i][c];
        }
    }
    {  // st[p, s] = sum_j (x[j, p] w_j) B[j, s], p = ty + 16 a, s = tx + 16 c
      float acc[kPT][kST] = {};
      for (int j = 0; j < Q; ++j) {
        const float w = ws[j];
        float a[kPT], b[kST];
#pragma unroll
        for (int t = 0; t < kPT; ++t) a[t] = xs[j * lp + min(ty + kTy * t, P - 1)] * w;
#pragma unroll
        for (int t = 0; t < kST; ++t) b[t] = bs[j * ls + min(tx + kTx * t, S - 1)];
#pragma unroll
        for (int i = 0; i < kPT; ++i)
#pragma unroll
          for (int c = 0; c < kST; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
      }
      float* sp = st + (bn * H + h) * (long long)P * S;
#pragma unroll
      for (int i = 0; i < kPT; ++i)
#pragma unroll
        for (int c = 0; c < kST; ++c) {
          const int p = ty + kTy * i, s = tx + kTx * c;
          if (p < P && s < S) sp[p * S + s] = acc[i][c];
        }
    }
  }
}

}  // namespace

extern "C" int ssd_chunk_forward(const float* x, const float* Bm,
                                 const float* Cm, const float* dt,
                                 const float* cum, float* y, float* st,
                                 int BN, int H, int Q, int P, int S,
                                 void* stream) {
  if (Q < 1 || Q > kQMax || P < 1 || P > kPMax || S < 1 || S > kSMax)
    return (int)cudaErrorInvalidValue;
  const size_t ls = S + 1, lq = Q + 1, lp = P + 1;
  const size_t c_region = Q * ls > Q * (lq + lp) ? Q * ls : Q * (lq + lp);
  const size_t smem =
      sizeof(float) * (Q * ls + c_region + Q * lq + 3 * (size_t)Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)BN, (unsigned)((H + kHeads - 1) / kHeads));
  ssd_chunk_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, Bm, Cm, dt, cum, y, st, H, Q, P, S);
  return (int)cudaGetLastError();
}

extern "C" const char* ssd_chunk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
