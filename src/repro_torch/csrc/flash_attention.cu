// flash_attention: GQA attention forward with an online softmax, fp32 or
// bf16 in, fp32 arithmetic, the input's type out.
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
// (0.07 ms); in fp32 on the CUDA cores' 67 TFLOP/s it is 1.03 ms.  This
// first kernel runs both products on the CUDA cores in fp32, so it cannot
// come near the bf16 bound; wgmma is later work.  What the design does
// for the CUDA cores: one block per (b * Hq + h, 64-row q tile), heaviest
// causal tiles first; the scaled q tile stays in shared memory for the
// whole kv sweep; one 64 x D buffer holds the K tile and then the V tile,
// so a block needs 86 KB and two blocks fit on an SM; kv tiles wholly above
// the diagonal are skipped.  Each thread owns 4 query rows, strided by 16
// (the rows' max and sum reduce over 16 lanes of one warp with shuffles),
// and 4 score columns or 8 output columns, strided by 16 so that the
// shared-memory reads of a warp hit distinct banks (rows padded to D + 1).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and o alike)
extern "C" int flash_attention_forward(const void* q, const void* k,
                                       const void* v, void* o, int B, int Hq,
                                       int Hkv, int Sq, int Skv, int D,
                                       int causal, int dtype, void* stream) {
  if (D < 1 || D > kDMax || Hkv < 1 || Hq % Hkv != 0 || Skv < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
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
