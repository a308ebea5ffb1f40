// ABF attention fuse, forward, for Hopper (sm_90a): the k-fold freq upscale
// of the residual, the 2-way sigmoid attention and the blend in one pass.
//
// Replaces speech_enhancement_clskd_tpu/ops/pallas/attfuse.py::_fwd_kernel
// (reached through _fwd_raw).  Same function: for x [B, D, T, C], the
// residual res [B, D/k, T, C], Wx and Wy [C, 2] and the bias [2], with
// y[b, d, t] = res[b, d / k, t] (nearest upscale),
//     z   = sigmoid(x . Wx + y . Wy + bias)      [B, D, T, 2]
//     out = x * z0 + y * z1                      [B, D, T, C]
// and z is written too, for the backward.  All arithmetic is f32.  The
// kernel on bf16 maps (attfuse_fwd_bf16) is attfuse_bf16.cu.
//
// What bounds it on this card.  About 8C operations per row against reading
// x and a row of res and writing out and z: bytes, at 3.35 TB/s.  The
// upscaled residual is never formed in device memory; each res row is read
// once per upscaled row that uses it, and the k readers sit next to each
// other in time, so the repeats come from L2.
//
// Design.  One warp per (b, d, t) row, 8 rows per block.  Lane l holds
// channels l, l + 32, ... of x and y in registers (CPL of them; C <= 256),
// so every load and store of a warp covers 128 consecutive bytes.  The two
// dot products are summed per lane and then over the warp with an xor
// butterfly, which leaves the same bits in every lane (each step adds the
// same two numbers in either order), so all lanes blend with the same z.
// Lane 0 writes z.  Offsets are 64-bit (the largest map has 253 M elements).
//
// Interface: plain C, bound with ctypes.  Pointers and the stream are passed
// as void*; the return value is cudaGetLastError() after the launch.  The
// caller allocates out [B, D, T, C] and z [B, D, T, 2].

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // rows per block
constexpr int kMaxC = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }

template <int CPL>
__global__ void __launch_bounds__(32 * kWarps)
attfuse_fwd_kernel(const float* __restrict__ x, const float* __restrict__ res,
                   const float* __restrict__ wx, const float* __restrict__ wy,
                   const float* __restrict__ bias, float* __restrict__ out,
                   float* __restrict__ z, long rows, int D, int k, int T, int C) {
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;  // the whole warp leaves together
  const long bd = row / T;
  const int t = (int)(row - bd * T);
  const long b = bd / D;
  const int d = (int)(bd - b * D);
  const long rrow = (b * (D / k) + d / k) * T + t;
  const float* xr = x + row * C;
  const float* yr = res + rrow * C;

  float xv[CPL], yv[CPL];
  float p0 = 0.0f, p1 = 0.0f;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    xv[i] = 0.0f;
    yv[i] = 0.0f;
    if (c < C) {
      xv[i] = load(xr + c);
      yv[i] = load(yr + c);
      p0 = fmaf(xv[i], load(wx + 2 * c), p0);
      p1 = fmaf(xv[i], load(wx + 2 * c + 1), p1);
      p0 = fmaf(yv[i], load(wy + 2 * c), p0);
      p1 = fmaf(yv[i], load(wy + 2 * c + 1), p1);
    }
  }
  p0 = warp_sum(p0);
  p1 = warp_sum(p1);
  const float z0 = 1.0f / (1.0f + expf(-(p0 + load(bias))));
  const float z1 = 1.0f / (1.0f + expf(-(p1 + load(bias + 1))));
  float* orow = out + row * C;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    if (c < C) orow[c] = fmaf(xv[i], z0, yv[i] * z1);
  }
  if (lane == 0) {
    z[2 * row] = z0;
    z[2 * row + 1] = z1;
  }
}

template <int CPL>
cudaError_t launch(const float* x, const float* res, const float* wx, const float* wy,
                   const float* bias, float* out, float* z, long rows, int D, int k, int T, int C,
                   cudaStream_t stream) {
  const long blocks = (rows + kWarps - 1) / kWarps;
  attfuse_fwd_kernel<CPL><<<(unsigned)blocks, 32 * kWarps, 0, stream>>>(
      x, res, wx, wy, bias, out, z, rows, D, k, T, C);
  return cudaGetLastError();
}

int run(const void* x, const void* res, const void* wx, const void* wy, const void* bias,
        void* out, void* z, int B, int D, int Dp, int T, int C, void* stream) {
  if (B < 1 || D < 1 || Dp < 1 || D % Dp || T < 1 || C < 1 || C > kMaxC)
    return (int)cudaErrorInvalidValue;
  const long rows = (long)B * D * T;
  const int k = D / Dp;
  const float* xi = static_cast<const float*>(x);
  const float* ri = static_cast<const float*>(res);
  const float* a = static_cast<const float*>(wx);
  const float* b = static_cast<const float*>(wy);
  const float* bi = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  float* zo = static_cast<float*>(z);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (C <= 32)
    err = launch<1>(xi, ri, a, b, bi, o, zo, rows, D, k, T, C, s);
  else if (C <= 64)
    err = launch<2>(xi, ri, a, b, bi, o, zo, rows, D, k, T, C, s);
  else if (C <= 128)
    err = launch<4>(xi, ri, a, b, bi, o, zo, rows, D, k, T, C, s);
  else
    err = launch<8>(xi, ri, a, b, bi, o, zo, rows, D, k, T, C, s);
  return (int)err;
}

}  // namespace

extern "C" int attfuse_fwd(const void* x, const void* res, const void* wx, const void* wy,
                           const void* bias, void* out, void* z, int B, int D, int Dp, int T,
                           int C, void* stream) {
  return run(x, res, wx, wy, bias, out, z, B, D, Dp, T, C, stream);
}
