// Hopper (sm_90a) primitives for fp32 products in 3xTF32 on wgmma (the
// linear route of csrc/gather_mlp.cu): TF32 warpgroup products with A in
// registers and B K-major in shared memory under the 64-byte swizzle,
// fp32 tensor maps, 2-d TMA loads, cp.async copies that zero-fill and
// signal an mbarrier, named barriers.  The bf16 flash kernels do not
// include it; it builds on csrc/sm90.cuh's mbarriers, fences and
// cuTensorMapEncodeTiled lookup, which it leaves as they are.
//
// Layouts they assume:
// * B (K x N, K-major): N rows of 16 fp32 (64 bytes, one swizzle row)
//   a 16-deep stage, as a TMA box of 16 x N writes it under
//   CU_TENSOR_MAP_SWIZZLE_64B into a 512-byte-aligned buffer; k8 step j
//   of the stage starts j * 32 bytes in, 8-row groups 512 bytes apart.
// * A fragment of m64nNk8 .tf32 (registers), thread 32 w + 4 g + t of a
//   warpgroup: a[0] row 16 w + g, k t; a[1] row 16 w + g + 8, k t; a[2]
//   and a[3] the same rows at k t + 4 (mma.sync m16n8k8's A fragment).
// * Accumulator: register r holds row 16 w + g + 8 ((r / 2) % 2) and
//   column 8 (r / 4) + 2 t + r % 2 of the 64 x N tile (as in sm90.cuh).
// wgmma reads a TF32 operand's fp32 bit pattern with the low 13 bits
// cut off, so operands split into TF32 halves beforehand (tf32x3::
// to_tf32: those bits already 0) go in exactly.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace sm90_tf32 {

constexpr int kSwizzleBytes = 64;       // a B row: 16 fp32
constexpr int kGroupBytes = 8 * kSwizzleBytes;  // an 8-row group of B

// shared-memory matrix descriptor, 64-byte swizzle, K-major: 8-row groups
// kGroupBytes apart (the leading offset is unused there)
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(kGroupBytes >> 4) << 32) | (2ull << 62);
}

#define WG_D8(i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),        \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 64) = or += A (64 x 8, registers) B (8 x 64, shared, K-major)
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32\n{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "},\n"
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 128) = or += A (64 x 8, registers) B (8 x 128, shared, K-major)
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32\n{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "},\n"
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40),
        WG_D8(48), WG_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 192) = or += A (64 x 8, registers) B (8 x 192, shared, K-major)
__device__ __forceinline__ void wgmma_tf32(float (&d)[96],
                                           const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32\n{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "},\n"
      "{%96, %97, %98, %99}, %100, p, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40),
        WG_D8(48), WG_D8(56), WG_D8(64), WG_D8(72), WG_D8(80), WG_D8(88)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 256) = or += A (64 x 8, registers) B (8 x 256, shared, K-major)
__device__ __forceinline__ void wgmma_tf32(float (&d)[128],
                                           const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32\n{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "},\n"
      "{%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40),
        WG_D8(48), WG_D8(56), WG_D8(64), WG_D8(72), WG_D8(80), WG_D8(88),
        WG_D8(96), WG_D8(104), WG_D8(112), WG_D8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

#undef WG_D8

// one box of the 2-d map at (c0, c1) into shared memory
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(
          sm90::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(sm90::smem_u32(bar)),
      "r"(c0), "r"(c1)
      : "memory");
}

// cp.async of 16 (or 4) bytes, of which the first `bytes` come from
// global memory and the rest are zero (bytes = 0: src is not read)
__device__ __forceinline__ void cp_async16_fill(void* smem, const void* gmem,
                                                int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   sm90::smem_u32(smem)),
               "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4_fill(void* smem, const void* gmem,
                                               int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   sm90::smem_u32(smem)),
               "l"(gmem), "r"(bytes)
               : "memory");
}

// an arrival on bar once this thread's earlier cp.async copies have
// landed; counted in the barrier's initial count (noinc)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];" ::"r"(
                   sm90::smem_u32(bar))
               : "memory");
}

// an arrival on bar by lane 0 of the warp where `arrive` is nonzero, as
// a predicated instruction: no divergent branch among a warpgroup's
// products in flight
__device__ __forceinline__ void mbar_arrive_lane0(uint64_t* bar,
                                                  int arrive) {
  asm volatile(
      "{\n.reg .pred p, q;\n.reg .b32 l;\nmov.u32 l, %%laneid;\n"
      "setp.eq.u32 p, l, 0;\nsetp.ne.b32 q, %1, 0;\nand.pred p, p, q;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(
          sm90::smem_u32(bar)),
      "r"(arrive)
      : "memory");
}

// a barrier among `count` threads (a multiple of 32) under id (1..15)
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// (D, F, 2) fp32 weights (two halves of F rows of D), boxes of 16
// columns x `rows` rows of one half, 64-byte swizzle
inline bool make_weight_map(CUtensorMap* map, const float* base, int D,
                            int F, int rows) {
  const sm90::EncodeTiled encode = sm90::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)F, 2};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 4, (cuuint64_t)D * F * 4};
  const cuuint32_t box[3] = {kSwizzleBytes / 4, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<float*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// (D, rows) fp32 row-major (D % 4 == 0, base 16-byte aligned), boxes of
// `cols` columns x `box_rows` rows, no swizzle; columns and rows past the
// tensor read as zero
inline bool make_rows_map(CUtensorMap* map, const float* base, int D,
                          long long rows, int cols, int box_rows) {
  const sm90::EncodeTiled encode = sm90::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 4};
  const cuuint32_t box[2] = {(cuuint32_t)cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<float*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90_tf32
