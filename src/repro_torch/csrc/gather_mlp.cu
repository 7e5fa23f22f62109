// gather_mlp: fused center-normalize -> 2-layer MLP -> max over K, fp32.
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
// What bounds it on an H100: fp32 FMAs.  At the pointnet2_c shapes the
// work is 2*B*S*K*(D*H + H*F) flops against one read of raw and one write
// of out: at B = 8, block 1 (S=512 K=32 D=65 H=64 F=128) is 3.24 GFLOP
// against 36.7 MB, about 48 us at the 67 TFLOP/s fp32 peak and 11 us at
// 3.35 TB/s; block 2 (S=128 K=64 D=129 H=128 F=256) is 6.46 GFLOP, about
// 96 us.  Compute-bound, so the design keeps every intermediate on chip:
// one thread block per subset stages x and h = relu(x W1 + b1) (at most
// 64 x 129 and 64 x 128 floats) in shared memory, more than 48 KB at
// block 2, so the launch opts in to a larger dynamic allocation.  Each
// thread computes 4 rows of one column at a time, so a weight loaded once
// (W1, W2: small, read through L1/L2, never staged) feeds 4 FMAs and the
// x/h operand is a warp-wide shared-memory broadcast.  The output
// features are split over the threads and, where F < 256, the K rows over
// thread groups whose maxima meet in shared memory.  The y tile (K x F)
// never exists: each thread keeps a running max.  IEEE fp32 FMA
// throughout; no tensor cores yet (a later step).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;            // rows per thread tile
constexpr float kBig = 3.4e38f;     // the max-pool identity of the JAX code

__global__ void __launch_bounds__(kThreads)
gather_mlp_kernel(const float* __restrict__ raw, const float* __restrict__ ctr,
                  const uint8_t* __restrict__ mask,
                  const float* __restrict__ w1, const float* __restrict__ b1,
                  const float* __restrict__ w2, const float* __restrict__ b2,
                  float* __restrict__ out, int K, int D, int Dc, int H, int F) {
  extern __shared__ float smem[];
  float* xs = smem;                                 // K * D
  float* hs = xs + K * D;                           // K * H
  float* red = hs + K * H;                          // max(F, kThreads)
  int* live = reinterpret_cast<int*>(red + max(F, kThreads));  // K
  const int tid = threadIdx.x;
  const long long sub = blockIdx.x;                 // b * S + s
  const float* rawp = raw + sub * K * D;
  const float* ctrp = ctr + sub * Dc;

  // 1. normalized inputs and live flags
  for (int e = tid; e < K * D; e += kThreads) {
    const int d = e % D;
    const float v = rawp[e];
    xs[e] = d < Dc ? v - ctrp[d] : v;
  }
  int any = 0;
  for (int k = tid; k < K; k += kThreads) {
    live[k] = mask == nullptr || mask[sub * K + k] != 0;
    any |= live[k];
  }
  any = __syncthreads_or(any);

  // 2. h = relu(x W1 + b1): kRows rows of one column per work item
  const int row_tiles = (K + kRows - 1) / kRows;
  for (int e = tid; e < row_tiles * H; e += kThreads) {
    const int j = e % H, k0 = (e / H) * kRows;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = b1[j];
    for (int d = 0; d < D; ++d) {
      const float w = __ldg(w1 + d * H + j);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        acc[r] = fmaf(xs[min(k0 + r, K - 1) * D + d], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (k0 + r < K) hs[(k0 + r) * H + j] = fmaxf(acc[r], 0.f);
  }
  __syncthreads();

  // 3. y = h W2 + b2 with a running max over the live rows; G groups of
  //    threads split the rows when F < kThreads
  const int G = max(1, kThreads / F);
  for (int e = tid; e < F * G; e += kThreads) {
    const int f = e % F, g = e / F;
    const float bias = b2[f];
    float m = -kBig;
    for (int k0 = g * kRows; k0 < K; k0 += G * kRows) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = bias;
      for (int j = 0; j < H; ++j) {
        const float w = __ldg(w2 + j * F + f);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          acc[r] = fmaf(hs[min(k0 + r, K - 1) * H + j], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (k0 + r < K && live[k0 + r]) m = fmaxf(m, acc[r]);
    }
    red[g * F + f] = m;
  }
  __syncthreads();
  for (int f = tid; f < F; f += kThreads) {
    float m = red[f];
    for (int g = 1; g < G; ++g) m = fmaxf(m, red[g * F + f]);
    out[sub * F + f] = any ? m : 0.f;
  }
}

}  // namespace

extern "C" int gather_mlp_forward(const float* raw, const float* ctr,
                                  const uint8_t* mask, const float* w1,
                                  const float* b1, const float* w2,
                                  const float* b2, float* out, int B, int S,
                                  int K, int D, int Dc, int H, int F,
                                  void* stream) {
  const size_t smem = sizeof(float) * ((size_t)K * D + (size_t)K * H +
                                       (F > kThreads ? F : kThreads) + K);
  cudaError_t err = cudaFuncSetAttribute(
      gather_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  gather_mlp_kernel<<<(unsigned)((long long)B * S), kThreads, smem,
                      (cudaStream_t)stream>>>(raw, ctr, mask, w1, b1, w2, b2,
                                              out, K, D, Dc, H, F);
  return (int)cudaGetLastError();
}

extern "C" const char* gather_mlp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
