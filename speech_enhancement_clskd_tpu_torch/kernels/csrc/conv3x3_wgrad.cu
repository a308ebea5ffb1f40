// Weight gradient of the bias-free 3x3 SAME convolution over channels-last
// maps, for Hopper (sm_90a): a split reduction in two deterministic passes.
//
// Replaces speech_enhancement_clskd_tpu/ops/pallas/conv3x3.py::_wgrad_kernel
// (reached through _wgrad_raw).  Same function: for x [B, D, T, C] and the
// incoming gradient g [B, D, T, O],
//     dw[dd, tt, c, o] = sum_{b, d, t} x[b, d+dd-1, t+tt-1, c] * g[b, d, t, o]
// with x read as zero outside [0, D) x [0, T).
//
// What bounds it on this card.  The same 2 * B*D*T * 9C * O operations as the
// forward, against reading x and g once and writing the small [3, 3, C, O]
// result: the operations bound it at every ABF shape but O = 2.  In f32 FMA
// (67 TFLOP/s) that is 1.089 ms at x, g [32, 64, 483, 64], where the first
// design of this kernel (a 4 x 4 f32 FMA register tile per thread, 64 bytes
// of shared memory read per 48 FMAs, so bound by shared memory) took 4.05 ms
// and cuDNN's f32 weight gradient 3.14 ms on an H100.
//
// Design: an implicit GEMM on the tensor cores in split TF32 (route "mma",
// O > 8), the product dw[(dd, tt, c), o] = sum_m x_shifted[m, c] g[m, o] with
// the pixels m as its reduction.
//   - 3xTF32 as in K3f (tf32x3.cuh): each f32 operand split into TF32 hi and
//     lo parts by cvt.rna.tf32, three mma.sync.m16n8k8 products a pair, only
//     lo*lo dropped, so the result stays within f32 rounding of an f32 sum.
//     Held against the 495 TFLOP/s TF32 peak for three products: 0.442 ms at
//     the reference shape.
//   - The TPU kernel summed into one block over a grid that ran in order.
//     CUDA blocks run at the same time, so the B*D freq rows are split into
//     chunks (about 1024 blocks in all, at most one chunk per freq row) and
//     pass 1 (conv3x3_wgrad_mma_kernel) gives each block one chunk and one
//     output tile: 32 input channels x 32 output channels x all nine shifts,
//     6 warps, warp (dd, 16 channels) holding its three time shifts.  It
//     writes its partial sum to scratch [chunk, 3, 3, C, O]; pass 2
//     (reduce_partials_kernel) adds the chunks in chunk order.
//   - Staging: per stage (one freq row, 64 time steps) the x halo (3 rows x
//     66 steps x 32 channels) and g (64 steps x 32 output channels) go by
//     cp.async into a ring of two stages, the next in flight while the tensor
//     cores work on this one.  A k8 step's k = q and q + 4 stand for time
//     steps 2q and 2q + 1, so a lane's three time shifts read halo rows
//     2q .. 2q + 3 of its two channels: 8 values split once serve 3 shifts x
//     4 output tiles, and each staged x row serves three shifts.  Strides of
//     36 floats make every fragment load free of bank conflicts.
//   - Fresh accumulators: the tensor cores add into their f32 accumulator
//     with truncation, and a block's share of the reduction runs over
//     thousands of pixels (8 freq rows x 483 steps at the step's shapes).
//     Each stage's 64 pixels (24 products a fragment) go into a fresh
//     accumulator that is added into f32 registers with round-to-nearest adds (tests/test_torch_tf32x3.py shows one
//     accumulator over tens of thousands of pixels missing the tolerance).
//   - Determinism: the split depends only on the shape and every sum runs in
//     a fixed order; no atomics, so every run gives the same bits.
// Route "narrow" (O <= 8; the decoder's mask block has O = 2, where an n8
// tile would be mostly padding): conv3x3_wgrad_narrow_kernel, one thread per
// input channel walking whole freq rows along time with a 3 x 3 window of x
// in registers, f32 FMA, up to 4096 units of rows, then the same reduce.
// Both passes live in conv3x3_tiles.cuh, which K5b (abf_block_bwd.cu) runs
// for its own weight gradient dw2.
//
// Interface: plain C, bound with ctypes.  conv3x3_wgrad_chunks(C, O, BD) gives
// the number of chunks for B*D = BD freq rows; the caller allocates the
// scratch of chunks * 9 * C * O floats and dw [3, 3, C, O].  conv3x3_wgrad
// returns cudaGetLastError() after each launch.  conv3x3_wgrad_route(C, O)
// names the route a shape takes: 0 narrow, 1 mma.

#include <cuda_runtime.h>

#include "conv3x3_tiles.cuh"

extern "C" int conv3x3_wgrad_route(int C, int O) { return conv3x3_tiles::wgrad_route(C, O); }

extern "C" int conv3x3_wgrad_chunks(int C, int O, int BD) {
  return conv3x3_tiles::wgrad_chunks(C, O, BD);
}

extern "C" int conv3x3_wgrad(const void* x, const void* g, void* dw, void* scratch, int B, int D,
                             int T, int C, int O, int chunks, void* stream) {
  return (int)conv3x3_tiles::wgrad_run(
      static_cast<const float*>(x), static_cast<const float*>(g), static_cast<float*>(dw),
      static_cast<float*>(scratch), B, D, T, C, O, chunks, static_cast<cudaStream_t>(stream));
}
