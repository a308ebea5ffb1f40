// ABF attention fuse, backward, for Hopper (sm_90a): all five gradients in one
// pass over the maps, the three small ones in a deterministic second pass.
//
// Replaces speech_enhancement_clskd_tpu/ops/pallas/attfuse.py::_bwd_kernel
// (reached through _bwd_raw).  Same function: given the forward's x
// [B, D, T, C], res [B, D/k, T, C], its z [B, D, T, 2], Wx and Wy [C, 2] and
// the incoming gradient g [B, D, T, C], with y[b, d, t] = res[b, d / k, t], per
// row
//     dz  = (g . x, g . y),  dp = z (1 - z) dz
//     dx  = z0 g + dp0 Wx[:, 0] + dp1 Wx[:, 1]
//     dy  = z1 g + dp0 Wy[:, 0] + dp1 Wy[:, 1]
// and dres[b, r, t] = sum of dy over the k rows d = r*k .. r*k + k - 1,
// dWx = sum x^T dp, dWy = sum y^T dp, dbias = sum dp over all rows.  All
// arithmetic is f32.  The kernel on bf16 maps (attfuse_bwd_bf16) is
// attfuse_bf16.cu.
//
// What bounds it on this card.  About 14C operations per row against reading
// x, g and z and a row of res and writing dx and a row of dres: bytes, at
// 3.35 TB/s.
//
// Design.
//   1. attfuse_bwd_kernel: one warp per res row (b, r, t); it walks the k
//      upscaled rows that read it, writes their dx and sums their dy in
//      registers, then writes dres once, so no two warps write the same dres
//      and nothing is added atomically.  As in the forward, lane l holds
//      channels l, l + 32, ... (C <= 256) and the two dot products are summed
//      over the warp with an xor butterfly (same bits in every lane).  Each
//      lane also keeps its channels' sums of x dp and y dp, and lane 0 the sum
//      of dp.  A block owns a fixed contiguous range of res rows, its 8 warps
//      take every 8th row of it, and at the end the block adds its warps'
//      sums in warp order and writes one [4C + 2] partial to scratch.
//   2. attfuse_bwd_reduce_kernel adds the blocks' partials in block order into
//      [dWx (C x 2) | dWy (C x 2) | dbias (2)].
// The number of blocks is the caller's, fixed by the shape, so every run
// gives the same bits.  Offsets are 64-bit.
//
// Interface: plain C, bound with ctypes.  Pointers and the stream are passed
// as void*; the return value is cudaGetLastError() after each launch.  The
// caller allocates dx [B, D, T, C], dres [B, D/k, T, C], grads [4C + 2] and
// the scratch of blocks * (4C + 2) floats.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxC = 256;
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }

template <int CPL>
__global__ void __launch_bounds__(32 * kWarps)
attfuse_bwd_kernel(const float* __restrict__ x, const float* __restrict__ res,
                   const float* __restrict__ z, const float* __restrict__ g,
                   const float* __restrict__ wx, const float* __restrict__ wy,
                   float* __restrict__ dx, float* __restrict__ dres,
                   float* __restrict__ partial, long res_rows, long rows_per_block, int Dp,
                   int k, int T, int C) {
  __shared__ float red[kWarps][4 * kMaxC + 2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x / 32;
  const int D = Dp * k;
  const long begin = (long)blockIdx.x * rows_per_block;
  const long end = begin + rows_per_block < res_rows ? begin + rows_per_block : res_rows;

  float wx0[CPL], wx1[CPL], wy0[CPL], wy1[CPL];
  float awx0[CPL], awx1[CPL], awy0[CPL], awy1[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    const bool in = c < C;
    wx0[i] = in ? load(wx + 2 * c) : 0.0f;
    wx1[i] = in ? load(wx + 2 * c + 1) : 0.0f;
    wy0[i] = in ? load(wy + 2 * c) : 0.0f;
    wy1[i] = in ? load(wy + 2 * c + 1) : 0.0f;
    awx0[i] = awx1[i] = awy0[i] = awy1[i] = 0.0f;
  }
  float adb0 = 0.0f, adb1 = 0.0f;

  for (long rr = begin + warp; rr < end; rr += kWarps) {
    const long bdp = rr / T;  // b * Dp + r
    const int t = (int)(rr - bdp * T);
    const long b = bdp / Dp;
    const int r = (int)(bdp - b * Dp);
    float yv[CPL], dy[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      yv[i] = c < C ? load(res + rr * C + c) : 0.0f;
      dy[i] = 0.0f;
    }
    for (int kk = 0; kk < k; ++kk) {
      const long row = (b * D + (long)r * k + kk) * T + t;
      float xv[CPL], gv[CPL];
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = lane + 32 * i;
        xv[i] = c < C ? load(x + row * C + c) : 0.0f;
        gv[i] = c < C ? load(g + row * C + c) : 0.0f;
        s0 = fmaf(gv[i], xv[i], s0);
        s1 = fmaf(gv[i], yv[i], s1);
      }
      s0 = warp_sum(s0);
      s1 = warp_sum(s1);
      const float z0 = load(z + 2 * row), z1 = load(z + 2 * row + 1);
      const float dp0 = z0 * (1.0f - z0) * s0;
      const float dp1 = z1 * (1.0f - z1) * s1;
      float* dxr = dx + row * C;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = lane + 32 * i;
        if (c < C) dxr[c] = fmaf(dp1, wx1[i], fmaf(dp0, wx0[i], z0 * gv[i]));
        dy[i] += fmaf(dp1, wy1[i], fmaf(dp0, wy0[i], z1 * gv[i]));
        awx0[i] = fmaf(xv[i], dp0, awx0[i]);
        awx1[i] = fmaf(xv[i], dp1, awx1[i]);
        awy0[i] = fmaf(yv[i], dp0, awy0[i]);
        awy1[i] = fmaf(yv[i], dp1, awy1[i]);
      }
      adb0 += dp0;
      adb1 += dp1;
    }
    float* dr = dres + rr * C;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      if (c < C) dr[c] = dy[i];
    }
  }

  // the block's sums, warp by warp in warp order
  const int n = 4 * C + 2;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    if (c < C) {
      red[warp][2 * c] = awx0[i];
      red[warp][2 * c + 1] = awx1[i];
      red[warp][2 * C + 2 * c] = awy0[i];
      red[warp][2 * C + 2 * c + 1] = awy1[i];
    }
  }
  if (lane == 0) {
    red[warp][4 * C] = adb0;
    red[warp][4 * C + 1] = adb1;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][idx];
    partial[(size_t)blockIdx.x * n + idx] = s;
  }
}

// grads[idx] = sum over blocks of partial[block][idx], in block order.
__global__ void __launch_bounds__(kReduceThreads)
attfuse_bwd_reduce_kernel(const float* __restrict__ partial, float* __restrict__ grads,
                          int blocks, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float s = 0.0f;
  for (int p = 0; p < blocks; ++p) s += partial[(size_t)p * n + idx];
  grads[idx] = s;
}

template <int CPL>
cudaError_t launch(const float* x, const float* res, const float* z, const float* g,
                   const float* wx, const float* wy, float* dx, float* dres, float* partial,
                   long res_rows, int blocks, int Dp, int k, int T, int C, cudaStream_t stream) {
  const long per_block = (res_rows + blocks - 1) / blocks;
  attfuse_bwd_kernel<CPL><<<blocks, 32 * kWarps, 0, stream>>>(
      x, res, z, g, wx, wy, dx, dres, partial, res_rows, per_block, Dp, k, T, C);
  return cudaGetLastError();
}

int run(const void* x, const void* res, const void* z, const void* g, const void* wx,
        const void* wy, void* dx, void* dres, void* grads, void* scratch, int B, int D, int Dp,
        int T, int C, int blocks, void* stream) {
  if (B < 1 || D < 1 || Dp < 1 || D % Dp || T < 1 || C < 1 || C > kMaxC || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const long res_rows = (long)B * Dp * T;
  const int k = D / Dp;
  const float* xi = static_cast<const float*>(x);
  const float* ri = static_cast<const float*>(res);
  const float* zi = static_cast<const float*>(z);
  const float* gi = static_cast<const float*>(g);
  const float* a = static_cast<const float*>(wx);
  const float* b = static_cast<const float*>(wy);
  float* dxo = static_cast<float*>(dx);
  float* dro = static_cast<float*>(dres);
  float* part = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (C <= 32)
    err = launch<1>(xi, ri, zi, gi, a, b, dxo, dro, part, res_rows, blocks, Dp, k, T, C, s);
  else if (C <= 64)
    err = launch<2>(xi, ri, zi, gi, a, b, dxo, dro, part, res_rows, blocks, Dp, k, T, C, s);
  else if (C <= 128)
    err = launch<4>(xi, ri, zi, gi, a, b, dxo, dro, part, res_rows, blocks, Dp, k, T, C, s);
  else
    err = launch<8>(xi, ri, zi, gi, a, b, dxo, dro, part, res_rows, blocks, Dp, k, T, C, s);
  if (err != cudaSuccess) return (int)err;
  const int n = 4 * C + 2;
  attfuse_bwd_reduce_kernel<<<(n + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0, s>>>(
      part, static_cast<float*>(grads), blocks, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int attfuse_bwd(const void* x, const void* res, const void* z, const void* g,
                           const void* wx, const void* wy, void* dx, void* dres, void* grads,
                           void* scratch, int B, int D, int Dp, int T, int C, int blocks,
                           void* stream) {
  return run(x, res, z, g, wx, wy, dx, dres, grads, scratch, B, D, Dp, T, C, blocks, stream);
}
