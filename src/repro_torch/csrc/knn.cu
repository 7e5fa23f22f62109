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
// this kernel does not copy that.  Any 1 <= k <= N; finite distances (a
// point at infinite distance is never ranked).
//
// What bounds it on an H100: the per-pair work is 9 flops, so at the
// main path's shapes (S = 512 centers against ~800 points, k = 32; S = 128
// against 512, k = 64) a call is latency, and at dgcnn_s's (S = N = 8192,
// k = 20) the issue rate of the scan and the selection.  The design:
//
// - A warp takes one center; W warps of the block's 8 share a center's
//   points, each scanning a contiguous slice of L points (W > 1 only when
//   there are too few centers to fill the SMs).
// - The cloud streams through shared memory in tiles of 1024 points: raw
//   xyz by cp.async (16 bytes where the address allows), double-buffered,
//   then |p|^2 computed once a point per block into a float4 tile (+inf
//   past a slice's points, which never qualify).
// - Each warp keeps a sorted list of its best n = min(k, slice) (distance,
//   index) entries and the n-th distance in a register.  A scan step
//   takes 64 points, two a lane; the lanes whose distance beats the n-th
//   (strict: a warp's points come in index order, so a tie with the n-th
//   loses) append to a candidate buffer in shared memory.  No candidate
//   is inserted alone: per 32 buffered, the warp sorts them with a
//   bitonic network over its lanes and merges them into the list, so the
//   first n points go in as ceil(n / 32) batches, not n inserts.  Lists
//   of up to 256 live in registers (R = ceil(n / 32) a lane; merged by a
//   bitonic merge down the registers); longer ones in shared memory (in
//   device memory past 1024 entries), merged by rank (an entry's place is
//   its position plus the count of the other sequence's keys below it).
// - With W > 1, the W sorted lists of a center merge by rank in shared
//   memory and the entries of rank < k are written.  Every comparison is
//   on the full (distance, index) key, so the merges are exact and ties
//   stay at the lower index.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"   // cp.async

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 1024;            // points staged per pass
constexpr int kBuf = 96;               // candidate buffer of a list
constexpr int kSmemLists = 1024;       // longest list kept in shared memory
constexpr int kMaxSmem = 232448 - 1024;  // 227 KB a block, less static
constexpr long long kScratchBudget = 256ll << 20;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 0x7fffffff;      // index of an empty list slot
// tiles, buffers and every warp's two list halves of kSmemLists entries
static_assert(40 * kTile + 8 * kWarps * kBuf + 16 * kWarps * kSmemLists <=
                  kMaxSmem,
              "lists of kSmemLists entries fit in shared memory");

struct Entry {
  float d;
  int i;
};

struct Params {
  const float* centers;
  const float* points;
  float* dists;
  int32_t* idx;
  Entry* scratch;   // lists in device memory; nullptr: in shared memory
  int S, N, K;
  int W;            // warps sharing one center's points
  int L;            // points a warp slice (a multiple of 32)
  int kcap;         // list length reserved a (warp, center)
  int ngroups;      // blocks' worth of centers: kWarps / W each
  int tw_shift;     // log2 of the points a slice a tile, kTile / W
  int aligned;      // points 16-byte aligned: cp.async of 16 bytes
};

__device__ __forceinline__ bool key_less(float ad, int ai, float bd, int bi) {
  return ad < bd || (ad == bd && ai < bi);
}

// d = (|c|^2 + |p|^2) - 2 c.p, with |p|^2 in p.w; no FMA in the norms.
// 2 c.p is exact, so one FMA rounds the difference as a subtraction would
__device__ __forceinline__ float dist(float cx, float cy, float cz, float c2,
                                      float4 p) {
  const float cross = fmaf(cz, p.z, fmaf(cy, p.y, __fmul_rn(cx, p.x)));
  return fmaf(-2.f, cross, __fadd_rn(c2, p.w));
}

__device__ __forceinline__ float norm2(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// one compare-exchange stage of a bitonic network over the lanes: the lane
// keeps the smaller key of itself and lane ^ stride where it is the lower
// lane of the pair and up, or the upper and not up
__device__ __forceinline__ void exchange(float& d, int& i, int lane,
                                         int stride, bool up) {
  const float od = __shfl_xor_sync(kFull, d, stride);
  const int oi = __shfl_xor_sync(kFull, i, stride);
  const bool keep_min = ((lane & stride) == 0) == up;
  if (keep_min ? key_less(od, oi, d, i) : key_less(d, i, od, oi)) {
    d = od;
    i = oi;
  }
}

// bitonic sort of one key a lane, ascending in lane order
__device__ __forceinline__ void sort32(float& d, int& i, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      exchange(d, i, lane, stride, (lane & size) == 0);
}

// a bitonic sequence over the lanes sorted, ascending if up
__device__ __forceinline__ void merge32(float& d, int& i, int lane, bool up) {
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1)
    exchange(d, i, lane, stride, up);
}

// count of the 32 sorted keys held one a lane (bd, bi) below (d, i)
__device__ __forceinline__ int rank_in_lanes(float bd, int bi, float d,
                                             int i) {
  int pos = 0;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const float vd = __shfl_sync(kFull, bd, pos + s - 1);
    const int vi = __shfl_sync(kFull, bi, pos + s - 1);
    if (key_less(vd, vi, d, i)) pos += s;
  }
  const float vd = __shfl_sync(kFull, bd, pos);
  const int vi = __shfl_sync(kFull, bi, pos);
  return pos + (key_less(vd, vi, d, i) ? 1 : 0);
}

// count of the n sorted entries of l below (d, i)
__device__ __forceinline__ int rank_in_list(const Entry* l, int n, float d,
                                            int i) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const Entry e = l[mid];
    if (key_less(e.d, e.i, d, i)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The first min(cnt, 32) buffered candidates of a list, sorted over the
// lanes (sentinels past cnt); the rest of the buffer (up to 63) moves to
// its front.
__device__ __forceinline__ void take_batch(Entry* buf, int& cnt, float& bd,
                                           int& bi, int lane) {
  __syncwarp();
  bd = INFINITY;
  bi = kNone;
  if (lane < cnt) {
    const Entry e = buf[lane];
    bd = e.d;
    bi = e.i;
  }
  Entry r0{}, r1{};
  const bool h0 = lane + 32 < cnt, h1 = lane + 64 < cnt;
  if (h0) r0 = buf[lane + 32];
  if (h1) r1 = buf[lane + 64];
  __syncwarp();
  if (h0) buf[lane] = r0;
  if (h1) buf[lane + 32] = r1;
  cnt = max(cnt - 32, 0);
  sort32(bd, bi, lane);
}

// A list of up to 32 R entries in registers: entry r * 32 + lane in
// register r of that lane, ascending; the n-th entry is the threshold.
// Merging a sorted batch: the 32 largest keys of list and batch are all in
// the list's last register and the batch (the list's other entries lie
// below that register's 32), so the last register and the batch reversed
// give, lane by lane, the 32 smallest of those 64 (a bitonic sequence) in
// M; M then goes down the registers: the smaller half of register r and M
// (sorted descending) is the new M, the larger half sorted the new
// register r + 1, and the last M, sorted, register 0.  -> the n-th
// distance.
template <int R>
__device__ __forceinline__ float reg_merge(float (&d)[R], int (&i)[R],
                                           float bd, int bi, int n,
                                           int lane) {
  float md = __shfl_sync(kFull, bd, 31 - lane);
  int mi = __shfl_sync(kFull, bi, 31 - lane);
  if (key_less(d[R - 1], i[R - 1], md, mi)) {
    md = d[R - 1];
    mi = i[R - 1];
  }
#pragma unroll
  for (int r = R - 2; r >= 0; --r) {
    merge32(md, mi, lane, false);
    float hd = d[r];
    int hi = i[r];
    if (key_less(hd, hi, md, mi)) {
      const float td = hd;
      const int ti = hi;
      hd = md;
      hi = mi;
      md = td;
      mi = ti;
    }
    merge32(hd, hi, lane, true);
    d[r + 1] = hd;
    i[r + 1] = hi;
  }
  merge32(md, mi, lane, true);
  d[0] = md;
  i[0] = mi;
  float kd = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (r == (n - 1) >> 5) kd = __shfl_sync(kFull, d[r], (n - 1) & 31);
  return kd;
}

// A list of n entries in memory (shared, or device memory for long
// lists), double-buffered: a merge writes the other half.  An entry's
// place is its position plus the count of the other sequence's keys below
// it.  -> the n-th distance.
__device__ __forceinline__ float mem_merge(Entry*& cur, Entry*& nxt, float bd,
                                           int bi, int n, int lane) {
  for (int e0 = 0; e0 < n; e0 += 32) {
    const int e = e0 + lane;
    const Entry v = e < n ? cur[e] : Entry{INFINITY, kNone};
    const int pos = e + rank_in_lanes(bd, bi, v.d, v.i);
    if (e < n && pos < n) nxt[pos] = v;
  }
  const int pos = lane + rank_in_list(cur, n, bd, bi);
  if (pos < n) nxt[pos] = Entry{bd, bi};
  __syncwarp();
  Entry* t = cur;
  cur = nxt;
  nxt = t;
  return cur[n - 1].d;
}

// length of the list of slice wl: the points it scans, at most K
__device__ __forceinline__ int list_len(const Params& p, int wl) {
  const int lo = wl * p.L;
  return max(0, min(p.K, min(p.N, lo + p.L) - lo));
}

// tile t of every slice's points, raw xyz, into dst (slice wl at 3 wl TW)
__device__ __forceinline__ void stage_tile(float* dst, const Params& p,
                                           int t, int tw) {
  for (int wl = 0; wl < p.W; ++wl) {
    const int a = wl * p.L + t * tw;
    const int e = min(min(p.N, (wl + 1) * p.L), a + tw);
    if (a >= e) continue;
    const int nf = 3 * (e - a);
    const float* src = p.points + 3ll * a;   // a % 4 == 0: 16-byte steps
    float* out = dst + 3 * wl * tw;
    int q0 = 0;
    if (p.aligned) {
      const int n16 = nf >> 2;
      for (int q = threadIdx.x; q < n16; q += kThreads)
        tf32x3::cp_async16(out + 4 * q, src + 4 * q);
      q0 = 4 * n16;
    }
    for (int q = q0 + threadIdx.x; q < nf; q += kThreads)
      tf32x3::cp_async4(out + q, src + q);
  }
}

// the merge of a sorted batch into a warp's list, by where the list lives
template <int R>
__device__ __forceinline__ float merge(float (&ld)[R > 0 ? R : 1],
                                       int (&li)[R > 0 ? R : 1], Entry*& cur,
                                       Entry*& nxt, float bd, int bi, int n,
                                       int lane) {
  if constexpr (R > 0) return reg_merge<R>(ld, li, bd, bi, n, lane);
  else return mem_merge(cur, nxt, bd, bi, n, lane);
}

template <int R>   // R = 0: the list in memory, else in R registers a lane
__global__ void __launch_bounds__(kThreads, R > 4 ? 2 : 4)
knn_kernel(const Params p) {
  constexpr int RR = R > 0 ? R : 1;
  extern __shared__ __align__(16) float smem[];
  float* raw = smem;                                      // 2 x 3 kTile
  float4* pts = reinterpret_cast<float4*>(smem + 6 * kTile);  // kTile
  Entry* bufs = reinterpret_cast<Entry*>(pts + kTile);   // kWarps x kBuf
  Entry* shared_lists = bufs + kWarps * kBuf;
  __shared__ const Entry* final_list[kWarps];   // each warp's merged list
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int W = p.W, G = kWarps / W, g = warp / W, w = warp - g * W;
  const int tw = kTile / W;
  // memory lists: two halves a warp; register lists: one copy a warp in
  // shared memory for the merge across warps
  const long long per_warp = (R > 0 ? 1ll : 2ll) * p.kcap;
  Entry* lists = p.scratch ? p.scratch + blockIdx.x * kWarps * per_warp
                           : shared_lists;
  Entry* mine = lists + warp * per_warp;
  Entry* buf = bufs + warp * kBuf;
  const int lo = w * p.L, hi = min(p.N, lo + p.L);
  const int n = list_len(p, w);
  const int nt = (p.L + tw - 1) / tw;
  const unsigned below = (1u << lane) - 1;

  for (int grp = blockIdx.x; grp < p.ngroups; grp += gridDim.x) {
    const int s = grp * G + g;
    const int sc = min(s, p.S - 1);
    const float cx = p.centers[3 * sc], cy = p.centers[3 * sc + 1],
                cz = p.centers[3 * sc + 2];
    const float c2 = norm2(cx, cy, cz);
    // an idle warp or an empty slice takes no candidate: d < -inf
    float kd = (s < p.S && n > 0) ? INFINITY : -INFINITY;
    int cnt = 0;
    float ld[RR];   // the list in registers
    int li[RR];
#pragma unroll
    for (int r = 0; r < RR; ++r) {
      ld[r] = INFINITY;
      li[r] = kNone;
    }
    Entry* cur = mine;   // the list in memory
    Entry* nxt = mine + p.kcap;
    if (R == 0)
      for (int e = lane; e < n; e += 32) cur[e] = Entry{INFINITY, kNone};

    stage_tile(raw, p, 0, tw);
    tf32x3::cp_async_commit();
    for (int t = 0; t < nt; ++t) {
      if (t + 1 < nt) {
        stage_tile(raw + ((t + 1) & 1) * 3 * kTile, p, t + 1, tw);
        tf32x3::cp_async_commit();
        tf32x3::cp_async_wait<1>();
      } else {
        tf32x3::cp_async_wait<0>();
      }
      __syncthreads();   // tile t staged; the last tile's scan is done
      const float* rb = raw + (t & 1) * 3 * kTile;
      for (int e = threadIdx.x; e < kTile; e += kThreads) {
        // a slot past its slice's points gets |p|^2 = inf: never a
        // candidate
        const int wl = e >> p.tw_shift;
        const bool real = wl * p.L + t * tw + (e & (tw - 1)) <
                          min(p.N, (wl + 1) * p.L);
        const float x = rb[3 * e], y = rb[3 * e + 1], z = rb[3 * e + 2];
        pts[e] = real ? make_float4(x, y, z, norm2(x, y, z))
                      : make_float4(0.f, 0.f, 0.f, INFINITY);
      }
      __syncthreads();
      // two steps of 32 points at once (tw is a multiple of 64)
      const int base = lo + t * tw, end = min(hi, base + tw);
      const float4* mypts = pts + w * tw + lane;
      for (int j0 = 0; base + j0 < end; j0 += 64) {
        const float4 q0 = mypts[j0], q1 = mypts[j0 + 32];
        const float d0 = dist(cx, cy, cz, c2, q0);
        const float d1 = dist(cx, cy, cz, c2, q1);
        const bool a0 = d0 < kd, a1 = d1 < kd;
        const unsigned m0 = __ballot_sync(kFull, a0);
        const unsigned m1 = __ballot_sync(kFull, a1);
        if (m0 | m1) {
          const int gi = base + j0 + lane;
          if (a0) buf[cnt + __popc(m0 & below)] = Entry{d0, gi};
          cnt += __popc(m0);
          if (a1) buf[cnt + __popc(m1 & below)] = Entry{d1, gi + 32};
          cnt += __popc(m1);
          while (cnt >= 32) {
            float bd;
            int bi;
            take_batch(buf, cnt, bd, bi, lane);
            kd = merge<R>(ld, li, cur, nxt, bd, bi, n, lane);
          }
        }
      }
    }
    if (cnt > 0) {
      float bd;
      int bi;
      take_batch(buf, cnt, bd, bi, lane);
      kd = merge<R>(ld, li, cur, nxt, bd, bi, n, lane);
    }

    if (W == 1) {
      if (s < p.S) {
        float* od = p.dists + (long long)s * p.K;
        int32_t* oi = p.idx + (long long)s * p.K;
        if constexpr (R > 0) {
#pragma unroll
          for (int r = 0; r < RR; ++r)
            if (r * 32 + lane < p.K) {
              od[r * 32 + lane] = ld[r];
              oi[r * 32 + lane] = li[r];
            }
        } else {
          for (int e = lane; e < p.K; e += 32) {
            const Entry v = cur[e];
            od[e] = v.d;
            oi[e] = v.i;
          }
        }
      }
    } else {   // merge the W lists of center s by rank
      if constexpr (R > 0) {
#pragma unroll
        for (int r = 0; r < RR; ++r)
          if (r * 32 + lane < n) mine[r * 32 + lane] = Entry{ld[r], li[r]};
        if (lane == 0) final_list[warp] = mine;
      } else {
        if (lane == 0) final_list[warp] = cur;
      }
      __syncthreads();
      if (s < p.S) {
        for (int e = w * 32 + lane; e < W * p.kcap; e += W * 32) {
          const int wl = e / p.kcap, i = e - wl * p.kcap;
          const int n2 = list_len(p, wl);
          if (i >= n2) continue;
          const Entry v = final_list[g * W + wl][i];
          int rank = i;
          for (int o = 0; o < W; ++o)
            if (o != wl)
              rank += rank_in_list(final_list[g * W + o], list_len(p, o),
                                   v.d, v.i);
          if (rank < p.K) {
            p.dists[(long long)s * p.K + rank] = v.d;
            p.idx[(long long)s * p.K + rank] = v.i;
          }
        }
      }
    }
    __syncthreads();   // lists, buffers and tiles free for the next group
  }
}

struct Plan {
  int R, W, L, kcap, ngroups, grid;
  long long smem, scratch;
};

int sm_count() {
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

// The split of the work for S centers, N points and k: W warps a center
// while S * W stays within the 16 warps an SM that fill the card (at most
// 2 while k <= 128: more slices cost more in their merge than they save
// in the scan), lists of up to 256 entries in registers (R = ceil(n /
// 32)), longer ones in shared memory while they fit (always for k <=
// kSmemLists), else in device memory with a grid that walks the centers.
Plan make_plan(int S, int N, int K) {
  const int sms = sm_count();
  Plan pl{};
  const int w_max = K > 128 ? kWarps : 2;
  int W = 1;
  while (W < w_max && 2ll * S * W <= 16ll * sms && N >= 64 * W) W *= 2;
  pl.W = W;
  pl.L = ((N + W - 1) / W + 31) / 32 * 32;
  pl.kcap = K < pl.L ? K : pl.L;
  pl.R = pl.kcap <= 8 * 32 ? (pl.kcap + 31) / 32 : 0;
  const long long base = 4ll * 10 * kTile + 8ll * kWarps * kBuf;
  const long long lists = pl.R > 0 ? (W > 1 ? 8ll * kWarps * pl.kcap : 0)
                                   : 16ll * kWarps * pl.kcap;
  pl.ngroups = (S + kWarps / W - 1) / (kWarps / W);
  if (base + lists <= kMaxSmem) {
    pl.smem = base + lists;
    pl.grid = pl.ngroups;
    pl.scratch = 0;
  } else {
    pl.smem = base;
    long long blocks = kScratchBudget / lists;
    if (blocks < 1) blocks = 1;
    pl.grid = (int)(blocks < pl.ngroups ? blocks : pl.ngroups);
    pl.scratch = pl.grid * lists;
  }
  return pl;
}

template <int R>
cudaError_t launch(const Plan& pl, const Params& p, cudaStream_t stream) {
  static long long attr_set[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (attr_set[dev] < pl.smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)pl.smem);
    if (err != cudaSuccess) return err;
    attr_set[dev] = pl.smem;
  }
  knn_kernel<R><<<pl.grid, kThreads, pl.smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch(const Plan& pl, const Params& p, cudaStream_t st) {
  switch (pl.R) {
    case 1: return launch<1>(pl, p, st);
    case 2: return launch<2>(pl, p, st);
    case 3: return launch<3>(pl, p, st);
    case 4: return launch<4>(pl, p, st);
    case 5: return launch<5>(pl, p, st);
    case 6: return launch<6>(pl, p, st);
    case 7: return launch<7>(pl, p, st);
    case 8: return launch<8>(pl, p, st);
    default: return launch<0>(pl, p, st);
  }
}

}  // namespace

// bytes of device memory the lists need beyond shared memory (0 for
// k <= 1024)
extern "C" long long knn_scratch_bytes(int S, int N, int K) {
  if (K < 1 || K > N || S < 1) return 0;
  return make_plan(S, N, K).scratch;
}

// the plan of a call: {W, R (0: lists in memory), lists in device
// memory, grid}
extern "C" void knn_plan(int S, int N, int K, int* out) {
  const Plan pl = make_plan(S, N, K);
  out[0] = pl.W;
  out[1] = pl.R;
  out[2] = pl.scratch > 0;
  out[3] = pl.grid;
}

// a block's shared memory bytes in the launch of a call (0 for widths
// the kernel does not take)
extern "C" long long knn_smem_bytes(int S, int N, int K) {
  if (K < 1 || K > N || S < 1) return 0;
  return make_plan(S, N, K).smem;
}

extern "C" int knn_forward(const float* centers, const float* points,
                           float* dists, int32_t* idx, int S, int N, int K,
                           void* scratch, long long scratch_bytes,
                           void* stream) {
  if (K < 1 || K > N || S < 1) return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(S, N, K);
  if (pl.scratch > 0 && (scratch == nullptr || scratch_bytes < pl.scratch))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.centers = centers;
  p.points = points;
  p.dists = dists;
  p.idx = idx;
  p.scratch = pl.scratch > 0 ? static_cast<Entry*>(scratch) : nullptr;
  p.S = S;
  p.N = N;
  p.K = K;
  p.W = pl.W;
  p.L = pl.L;
  p.kcap = pl.kcap;
  p.ngroups = pl.ngroups;
  p.tw_shift = 0;
  while ((kTile / pl.W) >> (p.tw_shift + 1)) ++p.tw_shift;
  p.aligned = (reinterpret_cast<uintptr_t>(points) & 15) == 0;
  return (int)dispatch(pl, p, (cudaStream_t)stream);
}

extern "C" const char* knn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
