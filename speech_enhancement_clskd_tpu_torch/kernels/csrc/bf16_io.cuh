// Loads and stores of float or bf16 maps as float32 values, for the kernels
// templated on their maps' element type (abf_block_fwd.cu, abf_block_bwd.cu):
// a bf16 value widens to float32 exactly, and a float32 value is stored to
// bf16 rounded to nearest even.  Each source includes this header and is
// built into its own library; kernels/_build.py hashes the headers with the
// source, so an edit here rebuilds every library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace bf16_io {

using bf16 = __nv_bfloat16;

// the bf16 in the low / high half of a 32-bit word, widened
__device__ __forceinline__ float lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ float ld1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld1(const bf16* p) {
  return lo(__ldg(reinterpret_cast<const unsigned short*>(p)));
}

// p[0 .. 3]; p 16-byte (float) or 8-byte (bf16) aligned
__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(lo(v.x), hi(v.x), lo(v.y), hi(v.y));
}

__device__ __forceinline__ void st1(float* p, float v) { *p = v; }
__device__ __forceinline__ void st1(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // a in the low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

// p[0 .. 3] = v; p aligned as for ld4
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void st4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack2(v.x, v.y), pack2(v.z, v.w));
}

// v rounded to E and read back as float32: bf16's rounding, or v itself
template <class E>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (sizeof(E) == 2)
    return __bfloat162float(__float2bfloat16_rn(v));
  else
    return v;
}

}  // namespace bf16_io
