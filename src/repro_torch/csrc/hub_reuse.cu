// hub_reuse: islandized FC — pool MLP + compensated reuse gather + masked
// max over K, fp32.
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
// The TPU kernel gathers y[slot] as a one-hot matmul on the MXU; here each
// thread reads y[slot] from shared memory directly, which gives the same
// values for finite inputs (1*y + 0*rest).  Each block reads only its own
// island, so the TPU kernel's out-of-range-island masking has no
// counterpart.  The batch and the per-cloud entry are the same kernel
// (B = 1 for one cloud).
//
// What bounds it on an H100: at B = 8, block 1 (H=16 C=64 M=64 K=32 D=64
// Hd=64 F=128) is 0.20 GFLOP against 11.8 MB of pool inputs, int32 slots,
// bool liveness, compensation and output, about 3.5 us at 3.35 TB/s:
// memory-bound.  Block 2 (H=4 C=128
// M=64 K=64 D=128 Hd=128 F=256) is 0.40 GFLOP, about 6.0 us at the 67
// TFLOP/s fp32 peak: compute-bound, on only B*H = 32 islands.  The design
// tiles the output features: grid (B*H, ceil(F/64)), so block 2 has 128
// blocks instead of 32 to spread over 132 SMs; the max over K is per
// column, so the tiles are independent, and each recomputes h, the cheap
// first layer.  Per block, shared memory holds the pool inputs (C x D)
// and h (C x Hd); the y tile (C x 64) then overwrites the dead inputs.  At
// block 2 that is 128 KB, more than 48 KB, so the launch opts in to a
// larger dynamic allocation.  Slots, liveness and compensation stream
// from device memory once, coalesced along the feature axis.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;            // rows per thread tile
constexpr int kFTile = 64;          // output features per block
constexpr float kBig = 3.4e38f;     // the max-pool identity of the JAX code

__global__ void __launch_bounds__(kThreads)
hub_reuse_kernel(const float* __restrict__ pool,
                 const int32_t* __restrict__ slot,
                 const float* __restrict__ comp,
                 const uint8_t* __restrict__ live,
                 const float* __restrict__ w1, const float* __restrict__ b1,
                 const float* __restrict__ w2, const float* __restrict__ b2,
                 float* __restrict__ out, int C, int M, int K, int D, int Hd,
                 int F) {
  extern __shared__ float smem[];
  float* xs = smem;                                 // C * D, then C * kFTile
  float* hs = xs + max(C * D, C * kFTile);          // C * Hd
  float* ys = xs;
  const int tid = threadIdx.x;
  const long long isl = blockIdx.x;                 // b * H + h
  const int f0 = blockIdx.y * kFTile;
  const int ft = min(kFTile, F - f0);
  const int row_tiles = (C + kRows - 1) / kRows;

  // 1. the island's cached inputs
  const float* poolp = pool + isl * C * D;
  for (int e = tid; e < C * D; e += kThreads) xs[e] = poolp[e];
  __syncthreads();

  // 2. h = relu(x W1 + b1): kRows rows of one column per work item
  for (int e = tid; e < row_tiles * Hd; e += kThreads) {
    const int j = e % Hd, c0 = (e / Hd) * kRows;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = b1[j];
    for (int d = 0; d < D; ++d) {
      const float w = __ldg(w1 + d * Hd + j);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        acc[r] = fmaf(xs[min(c0 + r, C - 1) * D + d], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (c0 + r < C) hs[(c0 + r) * Hd + j] = fmaxf(acc[r], 0.f);
  }
  __syncthreads();

  // 3. the y tile, y[c, f0 + f] = h[c] W2[:, f0 + f] + b2, over the inputs
  for (int e = tid; e < row_tiles * ft; e += kThreads) {
    const int f = e % ft, c0 = (e / ft) * kRows;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = b2[f0 + f];
    for (int j = 0; j < Hd; ++j) {
      const float w = __ldg(w2 + j * F + f0 + f);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        acc[r] = fmaf(hs[min(c0 + r, C - 1) * Hd + j], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (c0 + r < C) ys[(c0 + r) * kFTile + f] = acc[r];
  }
  __syncthreads();

  // 4. compensated reuse gather + max over the live slots of each subset
  for (int e = tid; e < M * ft; e += kThreads) {
    const int f = e % ft;
    const long long row = isl * M + e / ft;         // (b, h, m)
    const int32_t* sl = slot + row * K;
    const uint8_t* lv = live == nullptr ? nullptr : live + row * K;
    const float cf = comp[row * F + f0 + f];
    float m = -kBig;
    for (int k = 0; k < K; ++k) {
      const int s = sl[k];
      if (s >= 0 && (lv == nullptr || lv[k] != 0))
        m = fmaxf(m, ys[min(s, C - 1) * kFTile + f] + cf);
    }
    out[row * F + f0 + f] = m;
  }
}

}  // namespace

extern "C" int hub_reuse_forward(const float* pool, const int32_t* slot,
                                 const float* comp, const uint8_t* live,
                                 const float* w1, const float* b1,
                                 const float* w2, const float* b2, float* out,
                                 int B, int H, int C, int M, int K, int D,
                                 int Hd, int F, void* stream) {
  const size_t xs = (size_t)C * (D > kFTile ? D : kFTile);
  const size_t smem = sizeof(float) * (xs + (size_t)C * Hd);
  cudaError_t err = cudaFuncSetAttribute(
      hub_reuse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((long long)B * H), (F + kFTile - 1) / kFTile);
  hub_reuse_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      pool, slot, comp, live, w1, b1, w2, b2, out, C, M, K, D, Hd, F);
  return (int)cudaGetLastError();
}

extern "C" const char* hub_reuse_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
