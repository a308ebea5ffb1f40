// Bias-free 3x3 SAME convolution over channels-last maps, for Hopper (sm_90a).
//
// Replaces speech_enhancement_clskd_tpu/ops/pallas/conv3x3.py::_fwd_kernel
// (reached through _conv3x3_raw).  Same function: for x [B, D, T, C] and
// w [3, 3, C, O] (HWIO),
//     out[b, d, t, o] = sum_{dd, tt, c} x[b, d+dd-1, t+tt-1, c] * w[dd, tt, c, o]
// with x read as zero outside [0, D) x [0, T).  The backward's dx pass is this
// kernel on the incoming gradient with the flipped, transposed weights
// w_flip[dd, tt, o, c] = w[2-dd, 2-tt, c, o].
//
// What bounds it on this card.  An implicit GEMM with M = B*D*T rows, N = O
// and K = 9C: 2*M*N*K operations against reading x once and writing out
// once.  At the ABF shapes (C = 64, O from 2 to 256) that is 18-4600
// operations per byte moved.  In f32 FMA (67 TFLOP/s) the operations bound
// every call with O >= 8: 1.089 ms at x [32, 64, 483, 64] -> 64, where the
// first design of this kernel (a 4 x 4 FMA register tile) took 3.65 ms and
// cuDNN's f32 convolution 2.18 ms.
//
// Design: split TF32 on the tensor cores (route "mma", O >= 8 and C >= 4;
// the tile is conv3x3_mma.cuh's, which K5f and K5b run too, and the helpers
// tf32x3.cuh's, shared with K3w).
//   - Each f32 operand a is split into a TF32 high part hi = cvt.rna.tf32(a)
//     and a TF32 residual lo = cvt.rna.tf32(a - hi), and each product is
//     taken as lo_a*hi_b + hi_a*lo_b + hi_a*hi_b ("3xTF32"), accumulated in
//     f32 registers by mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32.
//     Only lo_a*lo_b (~2^-22 of the product) is dropped, so the result is
//     within f32 rounding of an f32 sum (the tolerance against the plain
//     version stays KERNEL_ATOL = 1e-4; measured errors are in PERF.md).  One
//     TF32 pass keeps ~3 decimal digits and misses that tolerance at K = 576
//     (tests/test_torch_tf32x3.py); bf16 would be worse.  The three products
//     at the 495 TFLOP/s TF32 peak take at least 0.442 ms at the reference
//     shape: the bound this route is held against (the f32 FMA bound, 1.089
//     ms, beside it).
//   - The weights are split once per call by a small pass
//     (conv3x3_split_weights_kernel) into the caller's scratch, as float4s
//     (hi, hi, lo, lo) of two neighbouring input channels, in the layout the
//     B fragments want and zero-padded to whole tiles; only x is split in
//     the inner loop.
//   - A block owns one freq row (b, d), BM time steps and BN output channels
//     (8 warps, each a 32 x WN tile of m16n8 fragments; at most 128
//     registers a thread and ~100 KB of shared memory, so two blocks share
//     an SM).  K runs over chunks of 8 input channels; per chunk the block
//     stages the x halo xs[3][BM + 2][8] and the nine split weight slices,
//     and the three time shifts of one halo row are row offsets into the
//     same buffer.  A k8 step's k = q and q + 4 stand for channels 2q and
//     2q + 1, so a lane's two A values of a row are one float2 and its B
//     values one float4.
//   - Staging is cp.async into a ring of two stages: the next chunk's copies
//     are in flight while the tensor cores work on this one.  16-byte copies
//     (cp.async.cg) of x when C is a multiple of 4 and x 16-byte aligned,
//     4-byte copies (cp.async.ca) otherwise; halo pixels outside the map and
//     channels past C are zero-filled by the src-size operand.
//   - Bank conflicts: none in the fragment loads.  A half warp's float2
//     reads of x cover words 8 g + 2 q of a time step of 8 floats (all 32
//     banks, no padding needed); a quarter warp's float4 reads of the
//     weights cover 16-byte slots 2 q + g (mod 8) of a row padded to BN + 2
//     float4s.
//   - The tensor cores add into their f32 accumulator with truncation, so
//     one accumulator over all of K drifts (3e-5 at K = 576, 1e-4 at K =
//     2304 against the plain version on the H100).  Each chunk's 27 products
//     a fragment go into a fresh accumulator, and the chunks are added in
//     registers with round-to-nearest f32 adds.
//   - Determinism: each output element is owned by one thread of one block
//     and summed in a fixed order (chunk, dd, tt, lo*hi, hi*lo, hi*hi); no
//     atomics and no split K, so repeated runs give the same bits.
// Shape route, by shape alone: O < 8 (the decoder's mask block, O = 2) or
// C < 4 (its dx pass, C = 2) would leave an m16n8k8 tile mostly padding, so
// those shapes take route "fma": the 4 x 4 f32 FMA register tile of
// conv3x3_tiles.cuh, with the tile shape picked by O.  Both routes are
// kernels of this library; neither stands in for the other.
//
// Offsets are 64-bit: the largest ABF map (32 x 256 x 483 x 64) has 253 M
// elements.
//
// Interface: plain C, bound with ctypes.  Pointers and the stream are passed
// as void*; the return value is cudaGetLastError() after the launches.  The
// caller allocates out [B, D, T, O] and the split weights' scratch of
// conv3x3_fwd_scratch_floats(C, O) floats (none on route "fma").
// conv3x3_fwd_route(C, O) names the route a shape takes: 0 fma, 1 mma.

#include <cuda_runtime.h>

#include <cstdint>

#include "conv3x3_mma.cuh"
#include "conv3x3_tiles.cuh"

namespace {

using namespace conv3x3_tiles;

// ---- route "fma": the f32 FMA register tile

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
cudaError_t launch_fma(const float* x, const float* w, float* out, int B, int D, int T, int C,
                       int O, cudaStream_t stream) {
  const int t_tiles = (T + BM - 1) / BM;
  const dim3 grid((unsigned)((long)B * D * t_tiles), (unsigned)((O + BN - 1) / BN));
  conv3x3_fwd_kernel<BM, BN><<<grid, fwd_threads<BM, BN>(), 0, stream>>>(x, w, out, D, T, C, O,
                                                                       t_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" int conv3x3_fwd_route(int C, int O) { return conv3x3_mma::fwd_route(C, O); }

// Floats of the scratch the caller passes for the split weights (0 on route
// "fma").
extern "C" long conv3x3_fwd_scratch_floats(int C, int O) {
  return conv3x3_mma::fwd_scratch_floats(C, O);
}

extern "C" int conv3x3_fwd(const void* x, const void* w, void* scratch, void* out, int B, int D,
                           int T, int C, int O, void* stream) {
  if (B < 1 || D < 1 || T < 1 || C < 1 || O < 1) return (int)cudaErrorInvalidValue;
  const float* xi = static_cast<const float*>(x);
  const float* wi = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (conv3x3_mma::fwd_route(C, O) == 1)
    err = conv3x3_mma::fwd_mma_run<false>(xi, wi, static_cast<float4*>(scratch), nullptr, o, B,
                                          D, T, C, O, s);
  else if (O >= 64)
    err = launch_fma<64, 64>(xi, wi, o, B, D, T, C, O, s);
  else if (O >= 32)
    err = launch_fma<128, 32>(xi, wi, o, B, D, T, C, O, s);
  else if (O >= 16)
    err = launch_fma<256, 16>(xi, wi, o, B, D, T, C, O, s);
  else
    err = launch_fma<256, 4>(xi, wi, o, B, D, T, C, O, s);
  return (int)err;
}
