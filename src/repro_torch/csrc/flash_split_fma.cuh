// flash_split_fma.cuh: flash_attention's split_fma route, forward
// (flash_attention.cu) and backward (flash_attention_bwd.cu), for heads
// wider than the split route's cluster reaches (D > 1024: flash_split.cuh
// slices D over at most 8 blocks of a cluster, 128 columns each in its
// dK/dV pass); flash_attention_pallas takes any D, so this route takes
// every D past that.  fp32 on the CUDA cores, through fma_tiles.cuh; bf16
// or fp32 in, the input's type out.  No speed sought.
//
// A block of 256 threads takes 64 rows (query rows; keys in the dK/dV
// pass) of one head and one 64-column slice of D, so O, dQ, dK and dV are
// split into D / 64 slices across blocks.  Each block forms S = q k^T
// (and dP = dO v^T) of its rows whole, summing over all of D 32 columns
// at a time, and keeps only its slice of the output in registers; blocks
// of one row tile recompute S, and nothing crosses blocks but the
// forward's log-sum-exp and the backward's row sums of dO o O, each
// written once (by the blocks of the first slice).  The online softmax
// runs in the log2 domain of the other routes (exp2 of q . k scale
// log2(e)); bf16 rounds P (and the backward's dS) to bf16 before their
// products, as the tensor-core routes do.  No atomics: the same inputs
// give the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "fma_tiles.cuh"

namespace split_fma {

using namespace fma_tiles;

// shared memory of each kernel: the staging, and one 64 x 64 tile (P;
// dS in the dQ pass) or two (P and dS in the dK/dV pass), and two vectors
// of the rows (the dQ and dK/dV passes: the log-sum-exp and dO . O)
constexpr long long kFwdSmem = 4ll * (kStageFloats + kT * kLdT);
constexpr long long kDqSmem = 4ll * (kStageFloats + kT * kLdT + 2 * kT);
constexpr long long kDkvSmem = 4ll * (kStageFloats + 2 * kT * kLdT + 2 * kT);

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// v as the products of T take it: bf16 rounds it to bf16
template <typename T>
__device__ __forceinline__ float as_t(float v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __bfloat162float(__float2bfloat16(v));
  else
    return v;
}

struct Shape {
  int Hq, group, Sq, Skv, D, causal;
  float scale_log2, scale;
};

// s = a_i . b_j over all of D, rows [i0, + 64) of a (na rows) by rows
// [j0, + 64) of b (nb rows); rows past na or nb give 0
template <typename T>
__device__ __forceinline__ void dots(float (&s)[4][4], const T* a, int na,
                                     int i0, const T* b, int nb, int j0,
                                     int D, float* stage) {
  zero(s);
  mm_acc<4, true, true>(
      s, D,
      [&](int r, int k) {
        return i0 + r < na ? ld(a + (long long)(i0 + r) * D + k) : 0.f;
      },
      [&](int k, int c) {
        return j0 + c < nb ? ld(b + (long long)(j0 + c) * D + k) : 0.f;
      },
      stage);
}

// q_i . k_j scale log2(e) of query rows [i0, + 64) and keys [j0, + 64),
// -inf where the key is not visible (j >= Skv, or causal j > i)
template <typename T>
__device__ __forceinline__ void scores(float (&s)[4][4], const T* qh,
                                       int i0, const T* kh, int j0,
                                       const Shape& sh, float* stage) {
  dots(s, qh, sh.Sq, i0, kh, sh.Skv, j0, sh.D, stage);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = i0 + 4 * ty + a, j = j0 + tx + 16 * b;
      const bool vis = j < sh.Skv && (!sh.causal || j <= i);
      s[a][b] = vis ? s[a][b] * sh.scale_log2 : -INFINITY;
    }
}

// the 16 threads of a row group (half a warp): max and sum
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// a 64 x 64 tile of T-rounded values into shared memory (row stride kLdT)
template <typename T>
__device__ __forceinline__ void put(float* t, const float (&v)[4][4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      t[(4 * ty + a) * kLdT + tx + 16 * b] = as_t<T>(v[a][b]);
}

// keys a query tile at i0 sees: all of Skv, or with `causal` those <= its
// last row
__device__ __forceinline__ int key_end(int i0, const Shape& sh) {
  return sh.causal ? min(sh.Skv, i0 + kT) : sh.Skv;
}

// grid (query tiles, B * Hq, D slices)
template <typename T>
__global__ void __launch_bounds__(kBlock)
flash_split_fwd(const T* q, const T* k, const T* v, T* o, float* lse,
                const Shape sh) {
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;
  float* ps = stage + kStageFloats;
  const int i0 = blockIdx.x * kT, d0 = blockIdx.z * kT;
  const long long bh = blockIdx.y, bk = bh / sh.group;  // kv: b Hkv + h / g
  const long long D = sh.D;
  const T* qh = q + bh * sh.Sq * D;
  const T* kh = k + bk * sh.Skv * D;
  const T* vh = v + bk * sh.Skv * D;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
  }
  zero(acc);
  const int jend = key_end(i0, sh);
  for (int j0 = 0; j0 < jend; j0 += kT) {
    float s[4][4];
    scores(s, qh, i0, kh, j0, sh, stage);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float mt = s[a][0];
#pragma unroll
      for (int b = 1; b < 4; ++b) mt = fmaxf(mt, s[a][b]);
      const float mn = fmaxf(m[a], row_max(mt));
      const float alpha = mn == -INFINITY ? 1.f : exp2f(m[a] - mn);
      float sum = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[a][b] = mn == -INFINITY ? 0.f : exp2f(s[a][b] - mn);
        sum += s[a][b];
      }
      l[a] = l[a] * alpha + row_sum(sum);
      m[a] = mn;
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] *= alpha;
    }
    put<T>(ps, s);
    mm_acc<4, false, false>(
        acc, kT, [&](int r, int kk) { return ps[r * kLdT + kk]; },
        [&](int kk, int c) {
          return j0 + kk < sh.Skv && d0 + c < sh.D
                     ? ld(vh + (j0 + kk) * D + d0 + c)
                     : 0.f;
        },
        stage);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + 4 * ty + a;
    if (i >= sh.Sq) continue;
    const float inv = 1.f / fmaxf(l[a], 1e-20f);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int d = d0 + tx + 16 * b;
      if (d < sh.D) st(o + (bh * sh.Sq + i) * D + d, acc[a][b] * inv);
    }
    if (lse != nullptr && blockIdx.z == 0 && tx == 0)
      lse[bh * sh.Sq + i] = m[a] == -INFINITY ? 0.f : m[a] + log2f(l[a]);
  }
}

// the row sums dO_i . O_i of query rows [i0, + 64) into ds_rows (and, by
// the first slice's blocks, into dsum for the dK/dV pass): four threads a
// row, strided partials and then a fixed tree
template <typename T>
__device__ __forceinline__ void do_o_rows(const T* doh, const T* oh,
                                          int i0, const Shape& sh,
                                          float* ds_rows, float* dsum) {
  const int r = threadIdx.x >> 2, part = threadIdx.x & 3, i = i0 + r;
  float s = 0.f;
  if (i < sh.Sq)
    for (int d = part; d < sh.D; d += 4)
      s += ld(doh + (long long)i * sh.D + d) * ld(oh + (long long)i * sh.D + d);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  if (part == 0) {
    ds_rows[r] = s;
    if (dsum != nullptr && i < sh.Sq) dsum[i] = s;
  }
}

// P and dS of query rows [i0, + 64) by keys [j0, + 64), from the scores
// and dP: P = exp2(s - lse_i) (0 where masked), dS = P (dP - dO_i . O_i)
__device__ __forceinline__ void p_ds(float (&s)[4][4], float (&dp)[4][4],
                                     const float* lse_rows,
                                     const float* ds_rows) {
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float p = s[a][b] == -INFINITY
                          ? 0.f
                          : exp2f(s[a][b] - lse_rows[4 * ty + a]);
      s[a][b] = p;
      dp[a][b] = p * (dp[a][b] - ds_rows[4 * ty + a]);
    }
}

// grid (query tiles, B * Hq, D slices): dq = scale sum_j dS_ij k_j
template <typename T>
__global__ void __launch_bounds__(kBlock)
flash_split_dq(const T* q, const T* k, const T* v, const T* o,
               const T* dout, const float* lse, T* dq, float* dsum,
               const Shape sh) {
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;
  float* dss = stage + kStageFloats;
  float* lse_rows = dss + kT * kLdT;
  float* ds_rows = lse_rows + kT;
  const int i0 = blockIdx.x * kT, d0 = blockIdx.z * kT;
  const long long bh = blockIdx.y, bk = bh / sh.group;
  const long long D = sh.D;
  const T* qh = q + bh * sh.Sq * D;
  const T* doh = dout + bh * sh.Sq * D;
  const T* kh = k + bk * sh.Skv * D;
  const T* vh = v + bk * sh.Skv * D;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  if (tid < kT)
    lse_rows[tid] = i0 + tid < sh.Sq ? lse[bh * sh.Sq + i0 + tid] : 0.f;
  do_o_rows(doh, o + bh * sh.Sq * D, i0, sh, ds_rows,
            blockIdx.z == 0 ? dsum + bh * sh.Sq : nullptr);
  float acc[4][4];
  zero(acc);
  const int jend = key_end(i0, sh);
  for (int j0 = 0; j0 < jend; j0 += kT) {
    float s[4][4], dp[4][4];
    scores(s, qh, i0, kh, j0, sh, stage);
    dots(dp, doh, sh.Sq, i0, vh, sh.Skv, j0, sh.D, stage);
    p_ds(s, dp, lse_rows, ds_rows);
    put<T>(dss, dp);
    mm_acc<4, false, false>(
        acc, kT, [&](int r, int kk) { return dss[r * kLdT + kk]; },
        [&](int kk, int c) {
          return j0 + kk < sh.Skv && d0 + c < sh.D
                     ? ld(kh + (j0 + kk) * D + d0 + c)
                     : 0.f;
        },
        stage);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = i0 + 4 * ty + a, d = d0 + tx + 16 * b;
      if (i < sh.Sq && d < sh.D)
        st(dq + (bh * sh.Sq + i) * D + d, acc[a][b] * sh.scale);
    }
}

// grid (key tiles, B * Hkv, D slices): dv = sum over the group's query
// heads and rows of P_ij dO_i, dk = scale sum dS_ij q_i, in order
template <typename T>
__global__ void __launch_bounds__(kBlock)
flash_split_dkv(const T* q, const T* k, const T* v, const T* dout,
                const float* lse, const float* dsum, T* dk, T* dv,
                const Shape sh) {
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;
  float* ps = stage + kStageFloats;
  float* dss = ps + kT * kLdT;
  float* lse_rows = dss + kT * kLdT;
  float* ds_rows = lse_rows + kT;
  const int j0 = blockIdx.x * kT, d0 = blockIdx.z * kT;
  const long long bk = blockIdx.y, D = sh.D;
  const T* kh = k + bk * sh.Skv * D;
  const T* vh = v + bk * sh.Skv * D;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  float adk[4][4], adv[4][4];
  zero(adk);
  zero(adv);
  // with `causal` the query tiles from the key tile's own on see its keys
  const int ibeg = sh.causal ? j0 : 0;
  for (int g = 0; g < sh.group; ++g) {
    const long long bh = bk * sh.group + g;
    const T* qh = q + bh * sh.Sq * D;
    const T* doh = dout + bh * sh.Sq * D;
    for (int i0 = ibeg; i0 < sh.Sq; i0 += kT) {
      if (tid < kT) {
        const bool in = i0 + tid < sh.Sq;
        lse_rows[tid] = in ? lse[bh * sh.Sq + i0 + tid] : 0.f;
        ds_rows[tid] = in ? dsum[bh * sh.Sq + i0 + tid] : 0.f;
      }
      float s[4][4], dp[4][4];
      scores(s, qh, i0, kh, j0, sh, stage);
      dots(dp, doh, sh.Sq, i0, vh, sh.Skv, j0, sh.D, stage);
      p_ds(s, dp, lse_rows, ds_rows);
      put<T>(ps, s);
      put<T>(dss, dp);
      mm_acc<4, false, false>(
          adv, kT, [&](int r, int kk) { return ps[kk * kLdT + r]; },
          [&](int kk, int c) {
            return i0 + kk < sh.Sq && d0 + c < sh.D
                       ? ld(doh + (i0 + kk) * D + d0 + c)
                       : 0.f;
          },
          stage);
      mm_acc<4, false, false>(
          adk, kT, [&](int r, int kk) { return dss[kk * kLdT + r]; },
          [&](int kk, int c) {
            return i0 + kk < sh.Sq && d0 + c < sh.D
                       ? ld(qh + (i0 + kk) * D + d0 + c)
                       : 0.f;
          },
          stage);
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = j0 + 4 * ty + a, d = d0 + tx + 16 * b;
      if (j < sh.Skv && d < sh.D) {
        st(dk + (bk * sh.Skv + j) * D + d, adk[a][b] * sh.scale);
        st(dv + (bk * sh.Skv + j) * D + d, adv[a][b]);
      }
    }
}

inline Shape make_shape(int Hq, int Hkv, int Sq, int Skv, int D,
                        int causal) {
  Shape sh;
  sh.Hq = Hq;
  sh.group = Hq / Hkv;
  sh.Sq = Sq;
  sh.Skv = Skv;
  sh.D = D;
  sh.causal = causal;
  sh.scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  sh.scale = (float)(1.0 / sqrt((double)D));
  return sh;
}

// grid (rows / 64, heads, D / 64)
inline dim3 grid(int rows, long long heads, int D) {
  return dim3((unsigned)((rows + kT - 1) / kT), (unsigned)heads,
              (unsigned)((D + kT - 1) / kT));
}

template <typename K>
cudaError_t smem_attr(K kernel, long long bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace split_fma
