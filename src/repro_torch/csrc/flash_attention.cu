// flash_attention: GQA attention forward with an online softmax, fp32 or
// bf16 in, the input's type out.
//
// Replaces the Pallas TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention/flash_attention.py, body
// _flash_kernel): for q (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D), query head
// h reads kv head h / (Hq / Hkv), and
//
//     o[i] = sum_j softmax_j(q_i . k_j / sqrt(D)) v_j
//
// over the keys j < Skv, and with `causal` only j <= i (the TPU kernel's
// top-left mask, row >= col).  Keys at or past Skv are masked, so a ragged
// last kv tile is right (the TPU kernel reads its padding).  The running
// max m, sum l and accumulator live in registers; l is clamped at 1e-20 as
// the TPU kernel clamps it.
//
// What bounds it on an H100: at Qwen2-72B's widths (Hq = 64, Hkv = 8,
// D = 128, Sq = Skv = 2048, causal) the products are 68.7 GFLOP against
// 75.5 MB of q, k, v, o in bf16, so the tensor cores' 989 TFLOP/s bound it
// (0.07 ms); in fp32 on the CUDA cores' 67 TFLOP/s it is 1.03 ms.  Two
// kernels, and the caller names which one runs (`variant`):
//
// * wgmma (bf16, D % 8 == 0, D <= 128): both products on the tensor cores.
//   A block takes 128 query rows of one head: two consumer warpgroups of
//   64 rows each and one producer warpgroup.  One producer thread brings
//   the q tile once and the K and V tiles of 128 keys into a ring of two
//   shared-memory stages by TMA, each stage with a "full" and an "empty"
//   mbarrier, so the copies of tile t + 1 run under the products of tile
//   t.  The tensor maps are 3-d (D, S, B * H): TMA zero-fills rows past Sq
//   or Skv and columns past D (D is padded to 64 or 128 in shared memory)
//   without reading the next head, and writes the 128-byte swizzle that
//   wgmma reads.  S = q k^T is wgmma m64n128k16 from shared memory (both
//   operands D-contiguous); the online softmax runs on the fp32
//   accumulator fragments in registers (exp2 with scale * log2(e) folded
//   into one FMA; the row max over the 4 threads of a row by two shuffles;
//   O rescaled by alpha every tile); P is rounded to bf16 in registers and
//   is the A operand of O += P V (wgmma m64nDk16 with A in registers and V
//   read D-contiguous, i.e. transposed).  Masks are applied only on the
//   tile that crosses Skv and on causal tiles that cross the diagonal;
//   tiles wholly above it are skipped, and the grid runs every head's
//   heaviest causal q tile first (x = b * Hq + h, y = q tiles from the
//   last).  The producer gives up registers (setmaxnreg 40) to the
//   consumers (232).  What still bounds it: within a warpgroup the
//   softmax waits for S and the P V product waits for the softmax, so
//   only the other warpgroup's work overlaps them; one block an SM (161
//   KB of shared memory at D = 128), and a block's prologue (q and the
//   first K tile) and epilogue (O stored from registers) are not
//   overlapped with another block.
//
// * simt (fp32, or bf16 with D % 8 != 0 or an operand that is not 16-byte
//   aligned, which TMA cannot read): both products on the CUDA cores
//   in fp32, at most the 67 TFLOP/s fp32 peak.  One block per (b * Hq + h,
//   64-row q tile), heaviest causal tiles first; the scaled q tile stays in
//   shared memory for the whole kv sweep; one 64 x D buffer holds the K
//   tile and then the V tile, so a block needs 86 KB and two blocks fit on
//   an SM; kv tiles wholly above the diagonal are skipped.  Each thread
//   owns 4 query rows, strided by 16 (the rows' max and sum reduce over 16
//   lanes of one warp with shuffles), and 4 score columns or 8 output
//   columns, strided by 16 so that the shared-memory reads of a warp hit
//   distinct banks (rows padded to D + 1).  It is held by FMA and
//   shared-memory issue (8 loads per 16 FMAs in the q k^T loop).
//
// The two round differently: the TPU kernel multiplies p by v in fp32;
// the wgmma kernel rounds P to bf16 first, as tensor-core flash kernels do.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---- simt: fp32 arithmetic on the CUDA cores ------------------------------

constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 64;                 // keys per kv tile
constexpr int kTx = 16, kTy = 16;       // thread grid over (rows, columns)
constexpr int kThreads = kTx * kTy;
constexpr int kRows = kBQ / kTy;        // query rows per thread
constexpr int kCols = kBK / kTx;        // score columns per thread
constexpr int kDMax = 128;
constexpr int kDCols = kDMax / kTx;     // output columns per thread, at most
constexpr int kPStride = kBK + 16;      // two row groups of a warp: 16 banks apart
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Hq, int group,
             int Sq, int Skv, int D, float scale, int causal) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* qs = smem;                     // kBQ x ld, scaled q tile
  float* kv = qs + kBQ * ld;            // kBK x ld, the K tile then the V tile
  float* ps = kv + kBK * ld;            // kBQ x kPStride, probabilities
  const int tid = threadIdx.x, tx = tid % kTx, ty = tid / kTx;
  const int bh = blockIdx.y;                             // b * Hq + h
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;     // heavy tiles first
  const long long kvh =
      (long long)(bh / Hq) * (Hq / group) + (bh % Hq) / group;
  const T* qp = q + ((long long)bh * Sq + q0) * D;
  const T* kp = k + kvh * Skv * D;
  const T* vp = v + kvh * Skv * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    qs[r * ld + d] = q0 + r < Sq ? to_f32(qp[e]) * scale : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kDCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDCols; ++c) acc[i][c] = 0.f;
  }

  int n_kt = (Skv + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q0 + kBQ - 1) / kBK + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                    // q tile written, last V tile read
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, d = e - r * D;
      kv[r * ld + d] = k0 + r < Skv ? to_f32(kp[(long long)k0 * D + e]) : 0.f;
    }
    __syncthreads();

    // scores of rows ty + 16 i against keys tx + 16 j
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[kRows], b[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = qs[(ty + kTy * i) * ld + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) b[j] = kv[(tx + kTx * j) * ld + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

    // online softmax over the visible keys of the tile
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty + kTy * i;
      float mc = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = k0 + tx + kTx * j;
        const bool vis = col < Skv && (!causal || row >= col);
        s[i][j] = vis ? s[i][j] : -INFINITY;
        mc = fmaxf(mc, s[i][j]);
      }
#pragma unroll
      for (int off = kTx / 2; off > 0; off >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(kFull, mc, off));
      const float mn = fmaxf(m[i], mc);
      const float alpha = mn == -INFINITY ? 1.f : expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - mn);
        ps[(ty + kTy * i) * kPStride + tx + kTx * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = kTx / 2; off > 0; off >>= 1)
        rs += __shfl_xor_sync(kFull, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < kDCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();                    // K tile read, probabilities written

    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, d = e - r * D;
      kv[r * ld + d] = k0 + r < Skv ? to_f32(vp[(long long)k0 * D + e]) : 0.f;
    }
    __syncthreads();

    // acc[row, d] += p[row, :] . V[:, d] for d = tx + 16 c
#pragma unroll 2
    for (int j = 0; j < kBK; ++j) {
      float p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = ps[(ty + kTy * i) * kPStride + j];
#pragma unroll
      for (int c = 0; c < kDCols; ++c) {
        const int d = tx + kTx * c;
        if (d < D) {
          const float vv = kv[j * ld + d];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + kTy * i;
    if (row >= Sq) continue;
    const float lc = fmaxf(l[i], 1e-20f);
    T* op = o + ((long long)bh * Sq + row) * D;
#pragma unroll
    for (int c = 0; c < kDCols; ++c) {
      const int d = tx + kTx * c;
      if (d < D) put(op + d, acc[i][c] / lc);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Hq, int Hkv, int Sq, int Skv, int D, int causal,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(kBQ + kBK) * (D + 1) + (size_t)kBQ * kPStride);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((Sq + kBQ - 1) / kBQ), (unsigned)(B * Hq));
  const float scale = (float)(1.0 / sqrt((double)D));
  flash_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Hq, Hq / Hkv, Sq, Skv, D,
      scale, causal);
  return cudaGetLastError();
}

// ---- wgmma: bf16 products on the tensor cores, TMA-fed --------------------

namespace wg {

constexpr int kBQ = 128;                // query rows per block
constexpr int kBK = 128;                // keys per kv tile
constexpr int kStages = 2;              // K/V ring depth
constexpr int kConsumers = 2;           // warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kRowBytes = 128;          // a swizzle row: 64 bf16 of D
constexpr int kHalfBytes = kBK * kRowBytes;   // 128 rows x 64 columns

// byte offsets from a 1024-aligned base; DP (64 or 128) is D padded
template <int DP>
struct Layout {
  static constexpr int kHalves = DP / 64;
  static constexpr int kTile = kHalves * kHalfBytes;  // q, K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  static constexpr int kBars = 1 + 4 * kStages;
  static constexpr int kBytes = kBar + 8 * kBars + 1024;  // + alignment
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// returns once the barrier's phase with the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// one box of the 3-d map (D, S, B * H) at (c0, c1, c2) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keeps the compiler from moving reads of an accumulator above the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D8(i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),        \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128) = or += A (64 x 16) B (16 x 128), both from shared memory,
// both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16\n{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63},\n"
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40),
        WG_D8(48), WG_D8(56)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128) += A (64 x 16, registers) B (16 x 128, shared, N-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16\n{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63},\n"
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40),
        WG_D8(48), WG_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64) += A (64 x 16, registers) B (16 x 64, shared, N-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16\n{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31},\n"
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef WG_D8

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Accumulator fragment of wgmma m64nNk16 (fp32), thread t of a warpgroup:
// register r holds row 16 (t / 32) + (t % 32) / 4 + 8 ((r / 2) % 2) and
// column 8 (r / 4) + 2 (t % 4) + r % 2 of the 64 x N tile.
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ o, int Hq, int group, int Sq,
                   int Skv, int D, float scale_log2, int causal) {
  using L = Layout<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* q_full = bar;
  uint64_t* k_full = bar + 1;
  uint64_t* k_empty = k_full + kStages;
  uint64_t* v_full = k_empty + kStages;
  uint64_t* v_empty = v_full + kStages;

  const int bh = blockIdx.x;                             // b * Hq + h
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;     // heavy tiles first
  int n_kt = (Skv + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q0 + kBQ - 1) / kBK + 1);
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, 128 * kConsumers);
      mbar_init(v_empty + s, 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wgi == kConsumers) {
    // ---- producer: one thread issues every copy ------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 128 * kConsumers) {
      const int kvh = (bh / Hq) * (Hq / group) + (bh % Hq) / group;
      mbar_expect_tx(q_full, L::kTile);
#pragma unroll
      for (int h = 0; h < L::kHalves; ++h)
        tma_load(smem + L::kQ + h * kHalfBytes, &tq, q_full, 64 * h, q0, bh);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages, ph = (kt / kStages) & 1;
        mbar_wait(k_empty + s, ph ^ 1);
        mbar_expect_tx(k_full + s, L::kTile);
#pragma unroll
        for (int h = 0; h < L::kHalves; ++h)
          tma_load(smem + L::kK + s * L::kTile + h * kHalfBytes, &tk,
                   k_full + s, 64 * h, kt * kBK, kvh);
        mbar_wait(v_empty + s, ph ^ 1);
        mbar_expect_tx(v_full + s, L::kTile);
#pragma unroll
        for (int h = 0; h < L::kHalves; ++h)
          tma_load(smem + L::kV + s * L::kTile + h * kHalfBytes, &tv,
                   v_full + s, 64 * h, kt * kBK, kvh);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ---------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int t = threadIdx.x % 128, lane = t % 32;
    const int row_lo = q0 + 64 * wgi;                    // first row of mine
    const int row0 = row_lo + 16 * (t / 32) + lane / 4;  // and row0 + 8
    const int col0 = 2 * (lane % 4);
    const uint32_t q_base = smem_u32(smem + L::kQ) + 64 * wgi * kRowBytes;

    float acc[DP / 2];
#pragma unroll
    for (int r = 0; r < DP / 2; ++r) acc[r] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % kStages, ph = (kt / kStages) & 1;
      const int k0 = kt * kBK;

      // S = q k^T over D in steps of 16 (32 bytes of a swizzle row)
      float sc[64];
      const uint32_t k_base = smem_u32(smem + L::kK + s * L::kTile);
      mbar_wait(k_full + s, ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk / 4) * kHalfBytes + (kk % 4) * 32;
        wgmma_ss_n128(sc, desc(q_base + off, 16, 8 * kRowBytes),
                      desc(k_base + off, 16, 8 * kRowBytes), kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(sc);
      mbar_arrive(k_empty + s);

      // mask only the tile that crosses Skv and causal tiles that cross
      // the diagonal of my rows
      if (k0 + kBK > Skv || (causal && k0 + kBK - 1 > row_lo)) {
#pragma unroll
        for (int r = 0; r < 64; ++r) {
          const int col = k0 + 8 * (r / 4) + col0 + r % 2;
          const int row = row0 + 8 * ((r / 2) % 2);
          if (col >= Skv || (causal && col > row)) sc[r] = -INFINITY;
        }
      }

      // online softmax, in the log2 domain
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int r = 0; r < 64; ++r)
        mx[(r / 2) % 2] = fmaxf(mx[(r / 2) % 2], sc[r]);
      float base[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float mn = fmaxf(m[i], mx[i] * scale_log2);
        base[i] = mn == -INFINITY ? 0.f : mn;
        alpha[i] = ex2(m[i] - base[i]);
        m[i] = mn;
      }
      uint32_t pa[32];
#pragma unroll
      for (int r = 0; r < 64; r += 2) {
        const int i = (r / 2) % 2;
        const float p0 = ex2(fmaf(sc[r], scale_log2, -base[i]));
        const float p1 = ex2(fmaf(sc[r + 1], scale_log2, -base[i]));
        rs[i] += p0 + p1;
        pa[r / 2] = pack_bf16(p0, p1);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = alpha[i] * l[i] + rs[i];
#pragma unroll
      for (int r = 0; r < DP / 2; ++r) acc[r] *= alpha[(r / 2) % 2];

      // O += P V over the 128 keys in steps of 16 (16 rows of V)
      const uint32_t v_base = smem_u32(smem + L::kV + s * L::kTile);
      mbar_wait(v_full + s, ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_rs(acc, pa + 4 * kk,
                 desc(v_base + kk * 16 * kRowBytes, kHalfBytes,
                      8 * kRowBytes));
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc);
      mbar_arrive(v_empty + s);
    }

    // l is a partial sum over my columns: reduce over the row's 4 threads
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      l[i] = 1.f / fmaxf(l[i], 1e-20f);
    }
#pragma unroll
    for (int c = 0; c < DP / 8; ++c) {
      const int col = 8 * c + col0;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 8 * i;
        if (row < Sq && col < D) {
          const float x0 = acc[4 * c + 2 * i] * l[i];
          const float x1 = acc[4 * c + 2 * i + 1] * l[i];
          *reinterpret_cast<__nv_bfloat162*>(
              o + ((long long)bh * Sq + row) * D + col) =
              __floats2bfloat162_rn(x0, x1);
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime, so
// the library links no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (D, S, BH) bf16, boxes of 64 columns x `rows` rows of one head
bool make_map(CUtensorMap* map, const void* base, int D, int S, int BH,
              int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Hq, int Hkv, int Sq, int Skv, int D, int causal,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, D, Sq, B * Hq, kBQ) ||
      !make_map(&tk, k, D, Skv, B * Hkv, kBK) ||
      !make_map(&tv, v, D, Skv, B * Hkv, kBK))
    return cudaErrorInvalidValue;
  const int smem = Layout<DP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(B * Hq), (unsigned)((Sq + kBQ - 1) / kBQ));
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  flash_wgmma_kernel<DP><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, Hq, Hq / Hkv, Sq, Skv, D, scale_log2,
      causal);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

// variant: 0 simt (dtype 0 float32 or 1 bfloat16), 1 wgmma (bfloat16 with
// D % 8 == 0 and 16-byte aligned q, k, v); q, k, v and o of one dtype
extern "C" int flash_attention_forward(const void* q, const void* k,
                                       const void* v, void* o, int B, int Hq,
                                       int Hkv, int Sq, int Skv, int D,
                                       int causal, int dtype, int variant,
                                       void* stream) {
  if (D < 1 || D > kDMax || Hkv < 1 || Hq % Hkv != 0 || Skv < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (variant == 1) {
    if (dtype != 1 || D % 8 != 0) return (int)cudaErrorInvalidValue;
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
         reinterpret_cast<uintptr_t>(v)) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
    if (D <= 64)
      return (int)wg::launch<64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal,
                                 st);
    return (int)wg::launch<128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal,
                                st);
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D,
                                      causal, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
