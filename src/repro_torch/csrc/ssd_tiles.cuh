// ssd_tiles.cuh: what the ssd_chunk forward (csrc/ssd_chunk.cu) and its
// gradient (csrc/ssd_chunk_bwd.cu) share: blocks of 8 warps (the
// gradient's heads pass takes 16: the loads' NT), 64-column P tiles, tile
// loads by cp.async, the decay M[i, j] taken only where i >= j, pair
// stores, and the SM count.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fma_tiles.cuh"
#include "tf32x3.cuh"

namespace ssd {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPT = 64;   // P tile

// n floats of each of rows rows, from src + r * stride to dst + r * ld,
// 16 bytes at a time where vec, else 4, by a block of NT threads
template <int NT = kThreads>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* src, long long stride,
                                          int rows, int n, bool vec) {
  if (vec && n == kPT) {
    for (int e = threadIdx.x; e < rows * (kPT / 4); e += NT) {
      const int r = e >> 4, c = (e & 15) << 2;
      tf32x3::cp_async16(dst + r * ld + c, src + r * stride + c);
    }
  } else if (vec) {
    const int per = n >> 2;
    for (int e = threadIdx.x; e < rows * per; e += NT) {
      const int r = e / per, c = (e - r * per) << 2;
      tf32x3::cp_async16(dst + r * ld + c, src + r * stride + c);
    }
  } else {
    for (int e = threadIdx.x; e < rows * n; e += NT) {
      const int r = e / n, c = e - r * n;
      tf32x3::cp_async4(dst + r * ld + c, src + r * stride + c);
    }
  }
}

// zero columns [c0, c1) of rows rows
template <int NT = kThreads>
__device__ __forceinline__ void zero_cols(float* dst, int ld, int rows,
                                          int c0, int c1) {
  const int w = c1 - c0;
  if (w <= 0) return;
  for (int e = threadIdx.x; e < rows * w; e += NT) {
    const int r = e / w;
    dst[r * ld + c0 + e - r * w] = 0.f;
  }
}

// M[i, j] from CB[i, j]: the decay exp(cum_i - cum_j) dt_j where i >= j
// (on), else 0 (the exponential's value is dropped, not multiplied by 0)
__device__ __forceinline__ float decay(float cb, float ci, float cj, float dj,
                                       bool on) {
  return on ? cb * __expf(ci - cj) * dj : 0.f;
}

// a pair of outputs at (row, col) and (row, col + 1) of a row-major
// matrix with cols columns: one 8-byte store where vec
__device__ __forceinline__ void store2(float* out, long long off, int col,
                                       int cols, float a, float b, bool vec) {
  if (vec) {
    if (col < cols)
      *reinterpret_cast<float2*>(out + off) = make_float2(a, b);
  } else {
    if (col < cols) out[off] = a;
    if (col + 1 < cols) out[off + 1] = b;
  }
}

// ---- the tiled route (chunks of q > 128 rows) -----------------------------
//
// What the forward and backward of a long chunk share: the chunk's rows in
// 64-row tiles, every product through fma_tiles.cuh (a block of 256
// threads a 64 x (16 NB) output tile), fp32 on the CUDA cores; each sum
// runs in a fixed order and no block sums into another's output.
namespace tiled {

using namespace fma_tiles;

// the decay L[i, j] = exp(cum_i - cum_j) where i >= j and both rows lie
// in the chunk, else 0 (the exponential is taken only there)
__device__ __forceinline__ float decay_l(float ci, float cj, bool on) {
  return on ? expf(ci - cj) : 0.f;
}

}  // namespace tiled

inline int sm_count() {
  static int cache[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (cache[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cache[dev] = n > 0 ? n : 132;
  }
  return cache[dev];
}

}  // namespace ssd
