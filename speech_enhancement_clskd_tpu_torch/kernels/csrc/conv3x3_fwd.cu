// Bias-free 3x3 SAME convolution over channels-last maps, for Hopper (sm_90a).
//
// Replaces speech_enhancement_clskd_tpu/ops/pallas/conv3x3.py::_fwd_kernel
// (reached through _conv3x3_raw).  Same function: for x [B, D, T, C] and
// w [3, 3, C, O] (HWIO),
//     out[b, d, t, o] = sum_{dd, tt, c} x[b, d+dd-1, t+tt-1, c] * w[dd, tt, c, o]
// with x read as zero outside [0, D) x [0, T).  The backward's dx pass is this
// kernel on the incoming gradient with the flipped, transposed weights
// w_flip[dd, tt, o, c] = w[2-dd, 2-tt, c, o].  All arithmetic is f32 FMA (no
// TF32), summed in the order (c chunk, dd, c, tt).
//
// What bounds it on this card.  An implicit GEMM with M = B*D*T rows, N = O
// and K = 9C: 2*M*N*K operations against reading x once and writing out
// once.  At the ABF shapes (C = 64, O from 2 to 256) that is 18-4600
// operations per byte moved, so the f32 FMA rate (67 TFLOP/s) bounds every
// call with O >= 8; at O = 2 the bytes do.
//
// Design.  A block owns one freq row (b, d), a tile of BM time steps and a
// tile of BN output channels.  For each chunk of kKC input channels it stages
// in shared memory the x halo (3 freq rows x (BM + 2) time steps x kKC, zeros
// at the edges, so ragged T and D down to 1 need no special case) and the
// nine weight slices [9, kKC, BN] (zeros past C and O).  Each thread keeps a
// 4 (time) x 4 (channel) tile of f32 sums in registers: per (dd, c) it reads
// 6 consecutive staged time steps, which serve the 3 time shifts of its 4
// rows, and one float4 of weights per shift, then does 48 FMAs.  The staged
// time step has a padded stride of kKC + 1 floats, so the threads of a warp
// that read different rows hit different banks.  The tile shape follows O:
// 64 x 64 for O >= 64, 128 x 32, 256 x 16, and 256 x 4 for the narrowest
// maps (O = 2 wastes half of its tile instead of 31/32).  The weight staging,
// the FMA loop and the store are in conv3x3_tiles.cuh, shared with K5f/K5b.
//
// Offsets are 64-bit: the largest ABF map (32 x 256 x 483 x 64) has 253 M
// elements.
//
// Interface: plain C, bound with ctypes.  Pointers and the stream are passed
// as void*; the return value is cudaGetLastError() after the launch.  The
// caller allocates out [B, D, T, O].

#include <cuda_runtime.h>

#include "conv3x3_tiles.cuh"

namespace {

using namespace conv3x3_tiles;

template <int BM, int BN>
__global__ void __launch_bounds__(fwd_threads<BM, BN>())
conv3x3_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ out, int D, int T, int C, int O, int t_tiles) {
  constexpr int kThreads = fwd_threads<BM, BN>();
  constexpr int kRows = BM + 2;  // staged time steps, halo included
  __shared__ float xs[3][kRows][kXs];
  __shared__ __align__(16) float ws[9][kKC][BN];

  const long bd = blockIdx.x / t_tiles;  // b * D + d
  const int t0 = (int)(blockIdx.x - bd * t_tiles) * BM;
  const int d = (int)(bd % D);
  const int o0 = blockIdx.y * BN;
  const int tx = threadIdx.x % (BN / kTN);
  const int ty = threadIdx.x / (BN / kTN);

  float acc[kTM][kTN];
  zero_tile(acc);

  for (int c0 = 0; c0 < C; c0 += kKC) {
    // x halo: xs[r][j][c] = x[b, d + r - 1, t0 + j - 1, c0 + c]
    for (int e = threadIdx.x; e < 3 * kRows * kKC; e += kThreads) {
      const int c = e % kKC;
      const int j = (e / kKC) % kRows;
      const int r = e / (kKC * kRows);
      const int dr = d + r - 1, t = t0 + j - 1, cc = c0 + c;
      float v = 0.0f;
      if (dr >= 0 && dr < D && t >= 0 && t < T && cc < C)
        v = __ldg(x + ((bd + r - 1) * T + t) * (long)C + cc);
      xs[r][j][c] = v;
    }
    stage_weights<BM, BN>(ws, w, c0, o0, C, O);
    __syncthreads();
    fma_chunk<BM, BN>(xs, ws, acc, tx, ty);
    __syncthreads();
  }
  store_tile(out, acc, bd, t0, T, o0, O, tx, ty);
}

template <int BM, int BN>
cudaError_t launch(const float* x, const float* w, float* out, int B, int D, int T, int C,
                   int O, cudaStream_t stream) {
  const int t_tiles = (T + BM - 1) / BM;
  const dim3 grid((unsigned)((long)B * D * t_tiles), (unsigned)((O + BN - 1) / BN));
  conv3x3_fwd_kernel<BM, BN><<<grid, fwd_threads<BM, BN>(), 0, stream>>>(x, w, out, D, T, C, O,
                                                                       t_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" int conv3x3_fwd(const void* x, const void* w, void* out, int B, int D, int T, int C,
                           int O, void* stream) {
  if (B < 1 || D < 1 || T < 1 || C < 1 || O < 1) return (int)cudaErrorInvalidValue;
  const float* xi = static_cast<const float*>(x);
  const float* wi = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (O >= 64)
    err = launch<64, 64>(xi, wi, o, B, D, T, C, O, s);
  else if (O >= 32)
    err = launch<128, 32>(xi, wi, o, B, D, T, C, O, s);
  else if (O >= 16)
    err = launch<256, 16>(xi, wi, o, B, D, T, C, O, s);
  else
    err = launch<256, 4>(xi, wi, o, B, D, T, C, O, s);
  return (int)err;
}
