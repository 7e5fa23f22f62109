// knn: brute-force k nearest neighbours, fp32.
//
// Replaces the Pallas TPU kernel knn_pallas (src/repro/kernels/knn/knn.py,
// body _knn_kernel): for each center c of (S, 3) against the points p of
// (N, 3),
//
//     d[j] = (|c|^2 + |p_j|^2) - 2 c.p_j                      (expanded form)
//
// and the k smallest, nearest first, in lexicographic (distance, index)
// order: ties go to the lower index.  The TPU kernel rebuilds its running
// best with K rounds of argmin over [tile ++ best] because Mosaic has no
// sort, which breaks exact ties across point tiles toward the higher index;
// this kernel does not copy that.
//
// What bounds it on an H100: nothing the roofline sees.  At PointNet++(c)'s
// shapes (S = 512 centers against up to 1024 points, k = 32; S = 128 against
// 512, k = 64) a call moves ~0.1 MB and does ~5 MFLOP, both under a
// microsecond; the time is launch latency and the serial work of keeping
// each sorted list.  The design keeps that serial work short and on-chip:
// one warp per center, its k-list spread over the lanes' registers (entry
// r * 32 + lane in register r of that lane, R = ceil(k / 32) <= 2).  The
// block's 8 warps share tiles of the cloud staged in shared memory with
// |p|^2 precomputed.  Each warp computes 32 distances at once, takes a
// ballot of those below its current k-th entry, and inserts those in lane
// (= index) order: an insert counts the entries <= d with a ballot and
// shifts the tail one place with shuffles.  Because points arrive in index
// order, the strict < against the k-th entry and the <= in the position
// keep ties at the lower index.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                  // centers per block
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 1024;                // points staged per pass
constexpr unsigned kFull = 0xffffffffu;

template <int R>
__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ centers,
           const float* __restrict__ points, float* __restrict__ dists,
           int32_t* __restrict__ idx, int S, int N, int K) {
  __shared__ float ps[kTile * 3];
  __shared__ float p2s[kTile];
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool active = s < S;                // uniform over the warp
  float cx = 0.f, cy = 0.f, cz = 0.f;
  if (active) {
    cx = centers[3 * s];
    cy = centers[3 * s + 1];
    cz = centers[3 * s + 2];
  }
  // no FMA contraction in the norms: (x*x + y*y) + z*z, as the plain sum
  const float c2 = __fadd_rn(__fadd_rn(__fmul_rn(cx, cx), __fmul_rn(cy, cy)),
                             __fmul_rn(cz, cz));
  float ld[R];
  int li[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    ld[r] = INFINITY;
    li[r] = -1;
  }
  const int last_lane = (K - 1) & 31, last_reg = (K - 1) >> 5;

  for (int t0 = 0; t0 < N; t0 += kTile) {
    const int tn = min(kTile, N - t0);
    __syncthreads();                        // the previous tile is read
    for (int e = threadIdx.x; e < tn * 3; e += kThreads)
      ps[e] = points[3LL * t0 + e];
    __syncthreads();
    for (int e = threadIdx.x; e < tn; e += kThreads) {
      const float x = ps[3 * e], y = ps[3 * e + 1], z = ps[3 * e + 2];
      p2s[e] = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                         __fmul_rn(z, z));
    }
    __syncthreads();
    if (!active) continue;

    for (int j0 = 0; j0 < tn; j0 += 32) {
      const int j = j0 + lane;
      const bool ok = j < tn;
      float d = INFINITY;
      if (ok) {
        const float cross = fmaf(cz, ps[3 * j + 2],
                                 fmaf(cy, ps[3 * j + 1],
                                      __fmul_rn(cx, ps[3 * j])));
        d = __fsub_rn(__fadd_rn(c2, p2s[j]), __fmul_rn(2.f, cross));
      }
      // the current k-th entry: a candidate must beat it strictly
      float kd = 0.f;
      int ki = 0;
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r == last_reg) {
          kd = __shfl_sync(kFull, ld[r], last_lane);
          ki = __shfl_sync(kFull, li[r], last_lane);
        }
      unsigned cand = __ballot_sync(kFull, ok && (ki < 0 || d < kd));
      while (cand) {
        const int src = __ffs(cand) - 1;
        cand &= cand - 1;
        const float v = __shfl_sync(kFull, d, src);
        const int vi = t0 + j0 + src;
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (r == last_reg) {
            kd = __shfl_sync(kFull, ld[r], last_lane);
            ki = __shfl_sync(kFull, li[r], last_lane);
          }
        if (!(ki < 0 || v < kd)) continue;  // uniform: v, kd, ki shuffled
        // entries <= v stay ahead of it (all have lower indices)
        int pos = 0;
#pragma unroll
        for (int r = 0; r < R; ++r)
          pos += __popc(__ballot_sync(kFull, li[r] >= 0 && ld[r] <= v));
        // entry e takes entry e - 1 for e > pos; entry pos takes v.  Lane
        // 0 of register r takes lane 31 of register r - 1 (entry 0 never
        // shifts, since pos >= 0)
        float pd[R];
        int pi[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          pd[r] = __shfl_up_sync(kFull, ld[r], 1);
          pi[r] = __shfl_up_sync(kFull, li[r], 1);
          const int prev = r > 0 ? r - 1 : 0;
          const float cd = __shfl_sync(kFull, ld[prev], 31);
          const int ci = __shfl_sync(kFull, li[prev], 31);
          if (lane == 0) {
            pd[r] = cd;
            pi[r] = ci;
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int e = r * 32 + lane;
          if (e > pos) {
            ld[r] = pd[r];
            li[r] = pi[r];
          } else if (e == pos) {
            ld[r] = v;
            li[r] = vi;
          }
        }
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = r * 32 + lane;
    if (e < K) {
      dists[(long long)s * K + e] = ld[r];
      idx[(long long)s * K + e] = li[r];
    }
  }
}

template <int R>
cudaError_t launch(const float* centers, const float* points, float* dists,
                   int32_t* idx, int S, int N, int K, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((S + kWarps - 1) / kWarps);
  knn_kernel<R><<<blocks, kThreads, 0, stream>>>(centers, points, dists, idx,
                                                 S, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" int knn_forward(const float* centers, const float* points,
                           float* dists, int32_t* idx, int S, int N, int K,
                           void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (K < 1 || K > N) return (int)cudaErrorInvalidValue;
  if (K <= 32) return (int)launch<1>(centers, points, dists, idx, S, N, K, st);
  if (K <= 64) return (int)launch<2>(centers, points, dists, idx, S, N, K, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* knn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
