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
// bf16: 0.074 ms at the 989 TFLOP/s bf16 dense peak, 0.076 ms at 3.35 TB/s,
// the two nearly level, so a kernel has to stream the maps and keep the
// tensor cores fed at once.  chip_smoke.py recomputes both from its shapes.
// The m16n8k16 tile that came first (route "mma" below) spent its time
// elsewhere: it restaged all nine weight slices with every 16-channel chunk
// (three quarters of a stage's bytes, ~600 MB from L2 a call at the reference
// shape), built each fragment register from its own 32-bit shared load, and
// ran a ring of two stages behind two barriers a chunk.
//
// Design (the code is in conv3x3_bf16.cuh, which K5f and K5b share; the
// probes behind each choice are scripts/conv_bf16_variants.py's).
//   - Forward, route "wgmma" (C and O multiples of 8, C <= 256, the maps
//     16-byte aligned): a persistent block per SM owns BN output channels
//     (64, or 32 for O <= 32 and for C > 128) and loads their nine weight
//     slices for every input channel once, by TMA, into shared memory (73.7
//     KB at C = 64, BN = 64; at most 147 KB); it then walks a fixed list of
//     (b, d, 64-step) tiles.  One producer thread keeps TMA loads in flight
//     into a ring of 3 to 8 stages on mbarriers; a stage is one tile's 64
//     input channels of the three halo rows d - 1, d, d + 1 over time steps
//     t0 - 1 .. t0 + 64, three 4-D boxes of x [B, D, T, C] with 128-byte
//     swizzle, whose zeros outside the map are the SAME padding and the
//     ragged last tile (no masking code).  Two consumer warpgroups take the
//     tiles in turn.  Per 16-channel group one staged halo serves all nine
//     shifts: wgmma.mma_async m64nBNk16 with A the halo row dd read through a
//     descriptor whose start is tt 128-byte rows on (the swizzle follows the
//     address, so the shifted view reads the right data: its outputs' bits
//     equal those of A loaded by ldmatrix.x4) and B the weight slice (dd,
//     tt), both K-major.  A in shared memory rather than in registers lets a
//     warpgroup keep two groups in flight (loading A's registers during a
//     group made ptxas serialize the products, C7513) and was faster at
//     every step shape but one (PERF.md, PR 15).
//   - The tensor cores add into their f32 accumulator with truncation, so
//     each 16-channel group's nine products go into a fresh accumulator
//     (scale-d = 0 on the first) and the groups are added in registers with
//     round-to-nearest f32 adds in order; the output is rounded once to bf16.
//     Each output element is owned by one thread and summed in a fixed order
//     (16-channel group, dd, tt), so repeated runs give the same bits.  A
//     stage goes back to the producer once the products that read it are
//     complete.
//   - Weight gradient, route "wgmma" (O > 8, C and O multiples of 8, x and g
//     16-byte aligned): the GEMM dw[(dd, tt), c, o] = sum_m x_shifted[m, c]
//     g[m, o] over the pixels m.  The B*D freq rows are split into chunks by
//     shape alone (K3w's conv3x3_tiles.cuh::wgrad_chunks), a block owns one
//     chunk and a tile of 64 input x 64 output channels and writes one f32
//     partial [3, 3, C, O], and conv3x3_tiles.cuh's reduce_partials adds the
//     partials in chunk order.  A stage (one freq row x 64 time steps) is
//     x's three halo rows, as the forward's, and g's 64 x 64 box, by TMA into
//     a ring of six.  Three consumer warpgroups, one per halo row dd, each
//     hold their three shifts' sums (M = 64 input channels): A is the
//     shifted halo transposed (ldmatrix.x4.trans: rows are channels, k is
//     time steps), B is g N-major through the descriptor's transpose bit, in
//     two halves of 32 output channels (m64n32k16; at n64 the sums spilled
//     from the consumers' 160 registers); each stage's 64 steps go into a
//     fresh accumulator added with round-to-nearest f32 adds.
//   - setmaxnreg moves registers from the producer warpgroup (one thread
//     issues the copies) to the consumers.
//   - Forward, route "mma" (O >= 8 and C >= 8, off "wgmma": C = 12 in the
//     tests, C > 256, or a map not 16-byte aligned): the first design, an
//     implicit GEMM on mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32.
//     A block owns one freq row (b, d), BM time steps and BN output channels,
//     8 warps of 32 x WN; per 16-channel chunk it stages the x halo
//     xs[3][BM + 2][16] and the nine weight slices ws[9][BN][16] (packed
//     [9][O][C] by conv3x3_bf16_pack_weights_kernel, which the "wgmma" route
//     reads too) by cp.async into a ring of two, fresh accumulators a chunk.
//   - Forward, route "fma" (O < 8 or C < 8: the decoder's mask block, O = 2,
//     and its dx pass, C = 2): a direct kernel, one thread per (time step,
//     up to 4 output channels) of a 64-step tile, the x halo and the weights
//     staged as f32 in shared memory in chunks of 32 channels, f32 FMA in a
//     fixed order, one rounding to bf16.
//   - Weight gradient, route "mma" (O > 8, off "wgmma"): the first design's
//     m16n8k16 products over the pixels, blocks of 32 input x 32 output
//     channels on the same chunks and reduction.  Route "narrow" (O <= 8):
//     K3w's narrow pass on bf16 loads, one thread per input channel walking
//     whole freq rows, f32 FMA.
//
// Offsets are 64-bit.  Interface: plain C, bound with ctypes; pointers and
// the stream are passed as void*, and the return value is the first CUDA
// error of the call (a refused launch included).  The tensor maps are encoded
// with the driver's cuTensorMapEncodeTiled, found through the runtime
// (cudaGetDriverEntryPoint), so the library needs no -lcuda.  The caller
// allocates out [B, D, T, O] (bf16), the packed weights' scratch of
// conv3x3_bf16_fwd_scratch_elems(C, O) bf16 (none on route "fma"), dw [3,
// 3, C, O] (f32) and the partials' scratch of conv3x3_bf16_wgrad_chunks(C, O,
// B * D) * 9 * C * O floats.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "conv3x3_bf16.cuh"

using conv3x3_bf16::bf16;

// Forward route of a shape, for maps 16-byte aligned or not: 0 fma, 1 mma,
// 2 wgmma.
extern "C" int conv3x3_bf16_fwd_route(int C, int O, int aligned) {
  const int route = conv3x3_bf16::fwd_route(C, O);
  return route == 2 && !aligned ? 1 : route;
}

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

// Weight-gradient route of a shape, for maps 16-byte aligned or not: 0
// narrow, 1 mma, 2 wgmma.
extern "C" int conv3x3_bf16_wgrad_route(int C, int O, int aligned) {
  const int route = conv3x3_bf16::wgrad_route(C, O);
  return route == 2 && !aligned ? 1 : route;
}

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
