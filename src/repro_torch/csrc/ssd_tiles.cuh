// ssd_tiles.cuh: what the ssd_chunk forward (csrc/ssd_chunk.cu) and its
// gradient (csrc/ssd_chunk_bwd.cu) share: blocks of 8 warps (the
// gradient's heads pass takes 16: the loads' NT), 64-column P tiles, tile
// loads by cp.async (zero-filled past the operand's edge on the tiled
// route), the decay M[i, j] taken only where i >= j, pair loads and
// stores, and the SM count.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// rows x cols floats (cols a multiple of 4) at src, row stride stride,
// into dst, row stride ld (a multiple of 4, dst 16-byte aligned): rows <
// rv and columns < cv by cp.async, 16 bytes at a time where vec (then cv
// is a multiple of 4 and src 16-byte aligned), the rest zeroed, so that
// nothing stale reaches a product
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* src, long long stride,
                                          int rows, int cols, int rv, int cv,
                                          bool vec) {
  if (vec) {
    const int per = cols >> 2;
    for (int e = threadIdx.x; e < rows * per; e += kThreads) {
      const int r = e / per, c = (e - r * per) << 2;
      float* d = dst + r * ld + c;
      if (r < rv && c < cv)
        tf32x3::cp_async16(d, src + r * stride + c);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
      const int r = e / cols, c = e - r * cols;
      if (r < rv && c < cv)
        tf32x3::cp_async4(dst + r * ld + c, src + r * stride + c);
      else
        dst[r * ld + c] = 0.f;
    }
  }
}

// a at an n-byte boundary (n a power of 2)
inline bool aligned(const void* a, int n) {
  return (reinterpret_cast<uintptr_t>(a) & (n - 1)) == 0;
}

// the pair at (row, col) and (row, col + 1) of a row-major matrix with
// cols columns, 0 past its edge (store2's counterpart)
__device__ __forceinline__ float2 load2(const float* in, long long off,
                                        int col, int cols) {
  return make_float2(col < cols ? in[off] : 0.f,
                     col + 1 < cols ? in[off + 1] : 0.f);
}

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
