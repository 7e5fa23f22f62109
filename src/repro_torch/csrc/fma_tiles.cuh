// fma_tiles.cuh: tile products on the CUDA cores in fp32, for the route
// that takes the shapes the tensor-core routes do not (flash_attention's
// split_fma route, heads over 1024 wide).
//
// A block of 256 threads owns one 64 x (16 NB) output tile: a thread rows
// 4 ty .. 4 ty + 3 and columns tx + 16 b (ty = tid / 16, tx = tid % 16;
// the 16 threads of a row group are half a warp).  Every product is a sum
// over k of A(r, k) B(k, c), both operands read through functors and
// staged in shared memory kKS values of k at a time; every sum runs in a
// fixed order, so the same inputs give the same bits.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace fma_tiles {

constexpr int kBlock = 256;      // threads a block
constexpr int kT = 64;            // rows of an output tile
constexpr int kKS = 32;           // k staged at a time
constexpr int kLd = 2 * kT + 1;   // stage row stride (up to 128 columns)
constexpr int kLdT = kT + 1;      // a 64 x 64 tile's row stride

// floats of shared memory the staging of mm_acc takes (A and B)
constexpr int kStageFloats = 2 * kKS * kLd;

// acc[a][b] += sum over k < kn of A(4 ty + a, k) * B(k, tx + 16 b), A and
// B read through fa(r, k) and fb(k, c) (each returns 0 out of range);
// kAK / kBK: the functor's operand is contiguous along k (the staging
// loop then runs k fastest across threads).  Starts with a barrier, so
// shared memory written before the call is visible to fa and fb.
template <int NB, bool kAK, bool kBK, class FA, class FB>
__device__ __forceinline__ void mm_acc(float (&acc)[4][NB], int kn, FA fa,
                                       FB fb, float* stage) {
  float* sa = stage;
  float* sb = stage + kKS * kLd;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  for (int k0 = 0; k0 < kn; k0 += kKS) {
    __syncthreads();                       // the last stage is read
    for (int e = tid; e < kKS * kT; e += kBlock) {
      const int kk = kAK ? e % kKS : e / kT, r = kAK ? e / kKS : e % kT;
      sa[kk * kLd + r] = k0 + kk < kn ? fa(r, k0 + kk) : 0.f;
    }
    for (int e = tid; e < kKS * 16 * NB; e += kBlock) {
      const int kk = kBK ? e % kKS : e / (16 * NB);
      const int c = kBK ? e / kKS : e % (16 * NB);
      sb[kk * kLd + c] = k0 + kk < kn ? fb(k0 + kk, c) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kKS; ++kk) {
      float av[4], bv[NB];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = sa[kk * kLd + 4 * ty + a];
#pragma unroll
      for (int b = 0; b < NB; ++b) bv[b] = sb[kk * kLd + tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < NB; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
  }
}

template <int NB>
__device__ __forceinline__ void zero(float (&acc)[4][NB]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[a][b] = 0.f;
}

// a thread's share of a 64 x 64 tile into shared memory (row stride kLdT)
__device__ __forceinline__ void store_tile(float* t, const float (&v)[4][4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) t[(4 * ty + a) * kLdT + tx + 16 * b] = v[a][b];
}

// dst[c] += sum over the tile's rows of v (its columns' sums), in a fixed
// order; red: 16 x 64 floats.  Every thread must call it.
__device__ __forceinline__ void col_sums(const float (&v)[4][4], float* red,
                                         float* dst) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    red[ty * kT + tx + 16 * b] = (v[0][b] + v[1][b]) + (v[2][b] + v[3][b]);
  __syncthreads();
  if (tid < kT) {
    float s = 0.f;
    for (int y = 0; y < 16; ++y) s += red[y * kT + tid];
    dst[tid] += s;
  }
  __syncthreads();
}

// dst[r] += sum over the tile's columns of v (its rows' sums), likewise
__device__ __forceinline__ void row_sums(const float (&v)[4][4], float* red,
                                         float* dst) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int a = 0; a < 4; ++a)
    red[tx * kT + 4 * ty + a] = (v[a][0] + v[a][1]) + (v[a][2] + v[a][3]);
  __syncthreads();
  if (tid < kT) {
    float s = 0.f;
    for (int x = 0; x < 16; ++x) s += red[x * kT + tid];
    dst[tid] += s;
  }
  __syncthreads();
}

}  // namespace fma_tiles
