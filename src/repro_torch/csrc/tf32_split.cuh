// tf32_split.cuh: fp32 weights W (D x F) split into the TF32 halves that
// wgmma's B operand takes, for the one-layer products on 3xTF32 wgmma
// (csrc/gather_mlp.cu's linear route, csrc/hub_reuse.cu's one-layer
// resident route).
//
// TF32 wgmma takes B from shared memory K-major only and reads its fp32
// bit pattern with the low 13 bits cut off.  So W is written once a call
// into device scratch as two halves, big = rna(W) and small = rna(W -
// big), each F_pad rows of D_pad (K-major: row n holds column n of W),
// zero past D and F; D_pad is D rounded up to kDepth, F_pad the caller's
// F tiles times its columns a block.  Within each 8-group of k, logical k
// sits at position (k % 2) * 4 + k / 2, so that wgmma's k slots t and
// t + 4 of a thread's A fragment are x's columns 2t and 2t + 1: one
// 8-byte load.  Each library wraps split_tile in a kernel of its own
// name, so that a profile tells the two apart.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace tf32_split {

constexpr int kDepth = 16;               // D_pad: D to a multiple of it
constexpr int kThreads = 256;            // a split block

// Block (x, y) of a kernel of kThreads threads: W's 32 x 32 tile at rows
// 32 x, columns 32 y, through shared memory, into its halves at out (two
// Fp x Dp blocks, big then small)
__device__ __forceinline__ void split_tile(const float* __restrict__ w,
                                           float* __restrict__ out, int D,
                                           int F, int Dp, int Fp) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int i = ty; i < 32; i += 8) {
    const int k = k0 + i, n = n0 + tx;
    tile[i][tx] = k < D && n < F ? w[(size_t)k * F + n] : 0.f;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int n = n0 + i, pos = k0 + tx;
    if (n >= Fp || pos >= Dp) continue;
    const int j = pos & 7;               // position j holds k 2 (j % 4) + j / 4
    const float v = tile[(tx & ~7) | ((j & 3) * 2 + (j >> 2))][i];
    const uint32_t big = tf32x3::to_tf32(v);
    const uint32_t small = tf32x3::to_tf32(v - __uint_as_float(big));
    out[(size_t)n * Dp + pos] = __uint_as_float(big);
    out[((size_t)Fp + n) * Dp + pos] = __uint_as_float(small);
  }
}

// The grid of a split of W into Fp x Dp halves
inline dim3 grid(int Dp, int Fp) { return dim3((Dp + 31) / 32, (Fp + 31) / 32); }

}  // namespace tf32_split
