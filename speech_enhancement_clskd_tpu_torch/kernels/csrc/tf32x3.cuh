// Split-TF32 ("3xTF32") tensor-core helpers shared by the 3x3 conv tiles:
// conv3x3_mma.cuh (K3f's route "mma", K5f's conv and K5b's adjoint) and
// conv3x3_tiles.cuh (K3w's wgrad route "mma", which K5b's dw2 also runs).
// Each source includes this header and is built into its own library;
// kernels/_build.py hashes the headers with the source, so an edit here
// rebuilds every library.
//
// Each f32 operand a is split into hi = cvt.rna.tf32(a) and lo =
// cvt.rna.tf32(a - hi), and each product is taken as lo_a*hi_b + hi_a*lo_b +
// hi_a*hi_b by mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32.  Only
// lo_a*lo_b (~2^-22 of the product) is dropped.  The tensor cores add into
// their f32 accumulator with truncation, so a caller runs a short stretch of
// the reduction into a fresh accumulator and adds the stretches in f32
// registers with round-to-nearest adds (tests/test_torch_tf32x3.py emulates
// both on the CPU).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tf32x3 {

__device__ __forceinline__ uint32_t to_tf32(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return r;
}

// a = hi + lo, each a TF32 value held in a 32-bit register
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(a);
  lo = to_tf32(a - __uint_as_float(hi));
}

// d += a (m16 x k8, row) * b (k8 x n8, col), TF32 in, f32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b as the three TF32 products lo_a*hi_b + hi_a*lo_b + hi_a*hi_b
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// bytes (16 or 4) from src to shared dst, or zeros where !valid
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace tf32x3
