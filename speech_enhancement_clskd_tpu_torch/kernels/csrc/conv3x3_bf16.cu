// Bias-free 3x3 SAME convolution over channels-last bf16 maps and its weight
// gradient, for Hopper (sm_90a): the bf16 instantiations of K3f and K3w.
//
// Replaces speech_enhancement_clskd_tpu/ops/pallas/conv3x3.py::_fwd_kernel
// (via _conv3x3_raw) and ::_wgrad_kernel (via _wgrad_raw) as they run on bf16
// operands, i.e. under distill.taps_dtype = bfloat16 with abf_conv_pallas:
//     out[b, d, t, o] = bf16( sum_{dd, tt, c} x[b, d+dd-1, t+tt-1, c] * w[dd, tt, c, o] )
//     dw[dd, tt, c, o] = sum_{b, d, t} x[b, d+dd-1, t+tt-1, c] * g[b, d, t, o]
// for x [B, D, T, C], w [3, 3, C, O] (HWIO) and g [B, D, T, O] in bf16, x read
// as zero outside [0, D) x [0, T).  The Pallas bodies dot bf16 tiles with
// preferred_element_type=f32 (conv3x3.py:127, :198): each product of two
// bf16 values is exact in f32, the products are summed in f32, and the
// forward rounds its output once to bf16 (:132); dw stays f32 (:186, :203).
// The backward's dx pass is the forward on the incoming gradient with the
// flipped, transposed weights in bf16 (:222).
//
// What bounds them on this card.  At the reference shape (x [32, 64, 483,
// 64] -> 64) the forward does 72.9 GFLOP against ~253 MB read and written in
// bf16: 0.074 ms at the 989 TFLOP/s bf16 dense peak, 0.076 ms at 3.35 TB/s.
// chip_smoke.py recomputes both from its shapes.
//
// Design (a simple correct kernel first; see PERF.md for its times; the code
// is in conv3x3_bf16.cuh, which K5f and K5b share).
//   - Forward, route "mma" (O >= 8 and C >= 8): an implicit GEMM on the
//     tensor cores, mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, one
//     product where the f32 route (conv3x3_mma.cuh) takes three TF32 ones.
//     A block owns one freq row (b, d), BM time steps and BN output channels,
//     8 warps of 32 x WN.  K runs over chunks of 16 input channels; per chunk
//     the block stages the x halo xs[3][BM + 2][16] and the nine weight
//     slices ws[9][BN][16] (the weights are packed once per call into
//     [9][O][C] by conv3x3_bf16_pack_weights_kernel, zero-padded to whole
//     tiles), so each A and B fragment register is one 32-bit load of two
//     neighbouring channels.  Staged rows are padded to 24 bf16 (48 bytes):
//     a quarter warp's loads then fall on words 12 g + q, all 32 banks.
//   - Staging is cp.async (16-byte copies of 8 channels, when C is a multiple
//     of 8 and x is aligned; otherwise plain loads) into a ring of two
//     stages, the next chunk in flight while the tensor cores work.
//   - The tensor cores add into their f32 accumulator with truncation, so
//     each chunk's 9 products a fragment go into a fresh accumulator and the
//     chunks are added in registers with round-to-nearest f32 adds; the
//     output is rounded once to bf16.  Each output element is owned by one
//     thread and summed in a fixed order (chunk, dd, tt), so repeated runs
//     give the same bits.
//   - Forward, route "fma" (O < 8 or C < 8: the decoder's mask block, O = 2,
//     and its dx pass, C = 2): a direct kernel, one thread per (time step,
//     up to 4 output channels) of a 64-step tile, the x halo and the weights
//     staged as f32 in shared memory in chunks of 32 channels, f32 FMA in a
//     fixed order, one rounding to bf16.
//   - Weight gradient, route "mma" (O > 8): the GEMM dw[(dd, tt, c), o] =
//     sum_m x_shifted[m, c] g[m, o] over the pixels m in m16n8k16 bf16
//     products.  The B*D freq rows are split into chunks by shape alone (K3w's
//     conv3x3_tiles.cuh::wgrad_chunks: about 1024 blocks of 32 input x 32
//     output channels x all nine shifts), each block writes one f32 partial
//     [3, 3, C, O] of its chunk, and conv3x3_tiles.cuh's reduce_partials
//     adds the partials in chunk order.  A stage is one freq row x 64 time
//     steps (x halo 3 x 66 x 32 and g 64 x 32, by cp.async into a ring of
//     two); a k16 step's k are time steps, so a lane packs its fragment
//     registers from 16-bit loads of two neighbouring time steps (strides of
//     40 bf16 keep those loads free of bank conflicts); each stage's 64 steps
//     go into a fresh accumulator added with round-to-nearest f32 adds.
//   - Weight gradient, route "narrow" (O <= 8): K3w's narrow pass on bf16
//     loads, one thread per input channel walking whole freq rows, f32 FMA.
//
// Offsets are 64-bit.  Interface: plain C, bound with ctypes; pointers and
// the stream are passed as void*, and the return value is cudaGetLastError()
// after the launches.  The caller allocates out [B, D, T, O] (bf16), the
// packed weights' scratch of conv3x3_bf16_fwd_scratch_elems(C, O) bf16
// (none on route "fma"), dw [3, 3, C, O] (f32) and the partials' scratch of
// conv3x3_bf16_wgrad_chunks(C, O, B * D) * 9 * C * O floats.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "conv3x3_bf16.cuh"

using conv3x3_bf16::bf16;

// Forward route of a shape: 0 fma, 1 mma.
extern "C" int conv3x3_bf16_fwd_route(int C, int O) { return conv3x3_bf16::fwd_route(C, O); }

// bf16 elements of the packed weights' scratch (0 on route "fma").
extern "C" long conv3x3_bf16_fwd_scratch_elems(int C, int O) {
  return conv3x3_bf16::fwd_scratch_elems(C, O);
}

extern "C" int conv3x3_bf16_fwd(const void* x, const void* w, void* scratch, void* out, int B,
                                int D, int T, int C, int O, void* stream) {
  return (int)conv3x3_bf16::fwd_run<false>(static_cast<const bf16*>(x),
                                           static_cast<const bf16*>(w), static_cast<bf16*>(scratch),
                                           nullptr, out, B, D, T, C, O,
                                           static_cast<cudaStream_t>(stream));
}

// Weight-gradient route of a shape: 0 narrow, 1 mma (K3w's, by shape alone).
extern "C" int conv3x3_bf16_wgrad_route(int C, int O) { return conv3x3_tiles::wgrad_route(C, O); }

// The number of f32 partials for B*D = BD freq rows (K3w's split).
extern "C" int conv3x3_bf16_wgrad_chunks(int C, int O, int BD) {
  return conv3x3_tiles::wgrad_chunks(C, O, BD);
}

extern "C" int conv3x3_bf16_wgrad(const void* x, const void* g, void* dw, void* scratch, int B,
                                  int D, int T, int C, int O, int chunks, void* stream) {
  return (int)conv3x3_bf16::wgrad_run(static_cast<const bf16*>(x), static_cast<const bf16*>(g),
                                      static_cast<float*>(dw), static_cast<float*>(scratch), B, D,
                                      T, C, O, chunks, static_cast<cudaStream_t>(stream));
}
