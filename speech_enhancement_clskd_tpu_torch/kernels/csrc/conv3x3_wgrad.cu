// Weight gradient of the bias-free 3x3 SAME convolution over channels-last
// maps, for Hopper (sm_90a): a split reduction in two deterministic passes.
//
// Replaces speech_enhancement_clskd_tpu/ops/pallas/conv3x3.py::_wgrad_kernel
// (reached through _wgrad_raw).  Same function: for x [B, D, T, C] and the
// incoming gradient g [B, D, T, O],
//     dw[dd, tt, c, o] = sum_{b, d, t} x[b, d+dd-1, t+tt-1, c] * g[b, d, t, o]
// with x read as zero outside [0, D) x [0, T).  All arithmetic is f32 FMA.
//
// What bounds it on this card.  The same 2 * B*D*T * 9C * O operations as the
// forward, against reading x and g once and writing the small [3, 3, C, O]
// result: the f32 FMA rate bounds it at every ABF shape but O = 2.
//
// Design.  The TPU kernel summed into one block over a grid that ran in order.
// CUDA blocks run at the same time, so the B*D freq rows are split into
// chunks (about 1024 blocks in all, at most one chunk per freq row), and
//   1. conv3x3_wgrad_partial_kernel gives each block one chunk and one
//      output tile (CT input channels x BN output channels, all nine shifts),
//      walks its rows in order in tiles of kBT time steps, and writes its
//      partial sum to scratch [chunk, 3, 3, C, O].  Per time tile it stages the x halo (3 freq
//      rows x (kBT + 2) steps x CT) and g (kBT x BN) in shared memory; thread
//      (dd, c group, o group) keeps 3 shifts x 4 x 4 sums in registers and,
//      per time step, reads one float4 of g and three float4s of x for 48 FMAs.
//   2. reduce_partials_kernel adds the chunks in chunk order.
// For O <= 8 (the decoder's mask block has O = 2) a tile of output channels
// leaves most threads idle and each block re-stages a 3-row halo per row
// (7.8 ms for that block's 9 GFLOP on an H100), so
// conv3x3_wgrad_narrow_kernel takes pass 1 instead: one thread per input
// channel walks whole freq rows along time with a 3 x 3 window of x in
// registers, up to 4096 units of rows.
// No atomics: the split depends only on the shape, so every run on any card
// gives the same bits.  This is K1b's dW_hh pattern (lstm_seq_bwd.cu).  Both
// passes are in conv3x3_tiles.cuh, which K5b (abf_block_bwd.cu) shares for its
// own weight gradient.
//
// Interface: plain C, bound with ctypes.  conv3x3_wgrad_chunks(C, O, BD) gives
// the number of chunks for B*D = BD freq rows; the caller allocates the
// scratch of chunks * 9 * C * O floats and dw [3, 3, C, O].  conv3x3_wgrad
// returns cudaGetLastError() after each launch.

#include <cuda_runtime.h>

#include "conv3x3_tiles.cuh"

extern "C" int conv3x3_wgrad_chunks(int C, int O, int BD) {
  return conv3x3_tiles::wgrad_chunks(C, O, BD);
}

extern "C" int conv3x3_wgrad(const void* x, const void* g, void* dw, void* scratch, int B, int D,
                             int T, int C, int O, int chunks, void* stream) {
  return (int)conv3x3_tiles::wgrad_run(
      static_cast<const float*>(x), static_cast<const float*>(g), static_cast<float*>(dw),
      static_cast<float*>(scratch), B, D, T, C, O, chunks, static_cast<cudaStream_t>(stream));
}
