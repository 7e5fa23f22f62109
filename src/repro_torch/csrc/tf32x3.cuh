// tf32x3.cuh: fp32 matrix products on Hopper's tensor cores at close to
// fp32 accuracy (3xTF32), from warp-level mma.sync.
//
// Each fp32 operand is split into a TF32 "big" part, big = rna(a), and a
// TF32 "small" remainder, small = rna(a - big), where rna is the rounding
// of cvt.rna.tf32.f32.  The product keeps three of
// the four terms,
//
//     a·b ≈ a_small·b_big + a_big·b_small + a_big·b_big,
//
// summed in the fp32 accumulator, small terms first.  The operands stay
// plain fp32 in shared memory; the split happens in registers right after
// a fragment is loaded.  One mma.sync.m16n8k8 tile: A is 16x8 row-major,
// B 8x8 column-major (read here from a row-major K x N matrix), C 16x8 in
// fp32; lane = 4·g + t holds A (g, t), (g+8, t), (g, t+4), (g+8, t+4),
// B (t, g), (t+4, g) and C (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
#pragma once

#include <stdint.h>

namespace tf32x3 {

template <int N>
struct Frag {
  uint32_t big[N], small[N];
};

// cvt.rna.tf32.f32 for finite x: the 13 low mantissa bits rounded off,
// ties away from zero.  Two integer operations, where the cvt instruction
// compiles to a compare-and-select sequence on sm_90a.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

template <int N>
__device__ __forceinline__ void split(Frag<N>& f, const float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    f.big[i] = to_tf32(v[i]);
    f.small[i] = to_tf32(v[i] - __uint_as_float(f.big[i]));
  }
}

// As split, but the remainder is handed over as it is: mma.sync reads a
// TF32 operand's top 19 bits, so the remainder is truncated there instead
// of rounded (CUTLASS's fast 3xTF32).  Its error grows from 2^-12 to
// 2^-11 of itself, about 2^-22 of the value, for one integer operation
// less an element.
template <int N>
__device__ __forceinline__ void split_fast(Frag<N>& f, const float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    f.big[i] = to_tf32(v[i]);
    f.small[i] = __float_as_uint(v[i] - __uint_as_float(f.big[i]));
  }
}

template <bool Fast, int N>
__device__ __forceinline__ void split_as(Frag<N>& f, const float (&v)[N]) {
  if constexpr (Fast) split_fast(f, v);
  else split(f, v);
}

// Fragment loads.  The A and B loads below agree on a permutation of k
// inside each k8 step: the k = t and k = t + 4 slots of lane 4·g + t
// read memory k 2t and 2t + 1.  The product sums over k, so it is unchanged,
// and A's two values become one 8-byte load.

// A fragment of the 16x8 tile at (row0, k0) of a row-major fp32 matrix in
// shared memory with a row stride of lda floats (even; with lda ≡ 8 mod 32
// each half-warp's 8-byte loads hit 32 distinct banks).  Fast: split_fast.
template <bool Fast = false>
__device__ __forceinline__ Frag<4> load_a(const float* s, int lda, int row0,
                                          int k0, int lane) {
  const float* p = s + (row0 + (lane >> 2)) * lda + k0 + 2 * (lane & 3);
  const float2 lo = *reinterpret_cast<const float2*>(p);
  const float2 hi = *reinterpret_cast<const float2*>(p + 8 * lda);
  const float v[4] = {lo.x, hi.x, lo.y, hi.y};
  Frag<4> f;
  split_as<Fast>(f, v);
  return f;
}

// B fragment of the 8x8 tile at (k0, n0) of a row-major K x N fp32 matrix
// in shared memory with a row stride of ldb floats (with ldb ≡ 4 mod 16
// each load hits 32 distinct banks).
template <bool Fast = false>
__device__ __forceinline__ Frag<2> load_b(const float* s, int ldb, int k0,
                                          int n0, int lane) {
  const float* p = s + (k0 + 2 * (lane & 3)) * ldb + n0 + (lane >> 2);
  const float v[2] = {p[0], p[ldb]};
  Frag<2> f;
  split_as<Fast>(f, v);
  return f;
}

// B fragment of the 8x8 tile at (k0, n0) of B = Xᵀ, read from X, a
// row-major N x K fp32 matrix in shared memory with a row stride of ldx
// floats (X's rows are B's columns; with ldx ≡ 8 mod 32 each half-warp's
// 8-byte loads hit 32 distinct banks).  Slots t and t + 4 read k 2t and
// 2t + 1, as load_a's do.
template <bool Fast = false>
__device__ __forceinline__ Frag<2> load_bt(const float* s, int ldx, int n0,
                                           int k0, int lane) {
  const float2 p = *reinterpret_cast<const float2*>(
      s + (n0 + (lane >> 2)) * ldx + k0 + 2 * (lane & 3));
  const float v[2] = {p.x, p.y};
  Frag<2> f;
  split_as<Fast>(f, v);
  return f;
}

// c += a·b for one m16n8k8 tile, TF32 in, fp32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a·b in 3xTF32: the two small products, then the big one
__device__ __forceinline__ void mma3(float (&c)[4], const Frag<4>& a,
                                     const Frag<2>& b) {
  mma(c, a.small, b.big);
  mma(c, a.big, b.small);
  mma(c, a.big, b.big);
}

// c[i] += a·b[i] in 3xTF32 for N tiles that share a: each tile's three
// products in mma3's order, issued in waves across the tiles, so that no
// product waits on the one just issued to its accumulator (a warp issues
// in order)
template <int N>
__device__ __forceinline__ void mma3_row(float (&c)[N][4], const Frag<4>& a,
                                         const Frag<2> (&b)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) mma(c[i], a.small, b[i].big);
#pragma unroll
  for (int i = 0; i < N; ++i) mma(c[i], a.big, b[i].small);
#pragma unroll
  for (int i = 0; i < N; ++i) mma(c[i], a.big, b[i].big);
}

// cp.async: 16-byte (L2 only) and 4-byte copies from global to shared
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

}  // namespace tf32x3
