// The whole ABF block, forward, for Hopper (sm_90a): 1x1 conv with bn1's
// affine folded in, attention fuse with the upscaled residual, and the 3x3
// SAME conv; one call writes xf and the raw conv output.
//
// Replaces speech_enhancement_clskd_tpu/ops/pallas/abf_block.py::_fwd_kernel
// (with _recompute_xf; reached through _fwd_raw).  Same function: for tap
// [B, D, T, Cs], res [B, D/k, T, M] (or none: the deepest block, no fuse),
// w1a [Cs, M], bvec [M], wxt [Cs, 2], wy [M, 2], zoff [2], w2 [3, 3, M, O],
// with y[b, d, t] = res[b, d / k, t],
//     xhat = tap @ w1a + bvec
//     z    = sigmoid(tap @ wxt + y @ wy + zoff)
//     xf   = xhat * z0 + y * z1           (xf = xhat without a residual)
//     out  = conv3x3_same(xf, w2)         (zeros outside [0, D) x [0, T))
//
// What bounds it on this card.  The 3x3 conv's 2 * B*D*T * 9M * O operations
// (at every ABF block but the decoder's mask block; done as three TF32
// tensor-core products each, route "mma") against reading tap and res once
// and writing xf and out once: the bytes of xf and res at the mask block
// (O = 2, 1 GB of xf), the operations elsewhere.
//
// Design.  Two routes, by shape alone (abf_block_fwd_route, the same test as
// K3f's route: O >= 8 output and M >= 4 mid channels take "mma"):
//   - "mma": two launches behind one call.  abf_block_xf_kernel forms xf and
//     writes it: xf has to reach memory anyway (the backward's dw2 reads it),
//     and forming it once costs Cs * M + 2 (Cs + M) FMAs a pixel, where the
//     first design formed each pixel again for 3 rows x every output tile in
//     the conv's staging.  4 lanes a pixel, lane g holding mid channels
//     16 kk + 4 g .. + 3: each forms xhat for its channels from the pixel's
//     tap row (read by the four lanes through the L1) and w1a in shared
//     memory, and sums its share of the two logits; the lanes' sums are
//     added by xor shuffles, then the blend is written once, as float4s
//     where M allows.  No barrier in its loop: warps walk the map's pixels
//     on their own, a persistent grid of one wave of blocks.  Then the conv runs
//     on K3f's split-TF32 tensor-core tile over xf (conv3x3_mma.cuh: weights
//     split once a call into a scratch, x split in the inner loop, a fresh
//     accumulator per 8-channel chunk against the tensor cores' truncating
//     adds).
//   - "direct" (O < 8, the mask block; or M < 4): abf_block_direct_kernel
//     forms xf and convolves it in one launch, so the mask block's 1 GB of
//     xf is written once and read by no second pass.  A block owns a strip
//     of kBT time steps of one batch row and walks kRowsConv freq rows in
//     order, keeping xf rows (with a time step of halo on each side) in a
//     ring of four in shared memory: the conv of row d reads rows d - 1, d
//     and d + 1 while the tap and res runs of row d + 2 arrive by cp.async
//     into the fourth, so each xf row is formed once per strip (the two rows
//     beyond the walk again by the neighbouring blocks) and its loads are in
//     flight under the previous row's work.  Forming a row (finish_row): 4
//     lanes a pixel sum the logits; a thread forms 4 pixels x 4 mid channels
//     (float4s of w1a); pixels outside the map stage 0, the conv's zero
//     padding (not the blend of zeros, which is bvec-valued).  The conv of a
//     row: thread (4 pixels, lane q of 16) sums mid channels q (mod 16) for
//     all (up to 8) output channels of the block, 6 staged values of a
//     channel serving the 3 time shifts of its 4 pixels; the 16 lanes'
//     partials are added by xor shuffles.  Shared memory is sized by the
//     call's widths (83 KB at the mask block, two blocks an SM).  More than
//     8 output channels (only when M < 4) take more blocks in y, each
//     forming the same xf again.
// x1/xhat, the upscaled residual and z never reach device memory.  Both
// routes are f32 FMA outside the tensor-core tile and sum in a fixed order:
// every run gives the same bits.  The residual's row is indexed by d / k
// directly.  Offsets are 64-bit (the mask block's xf has 253 M elements).
//
// The bf16 instantiation (abf_block_fwd_bf16: the Pallas kernel on bf16
// operands, as distill/abf.py hands them over under distill.taps_dtype =
// bfloat16) takes tap, res, w1a, wxt, wy and w2 in bf16 and bvec and zoff in
// float32, and writes xf and out in bf16.  It rounds where the Pallas body
// rounds (abf_block.py:159-178, :216): xhat = bf16(tap . w1a + bvec) (the dot
// summed from zero, bvec added after), z in float32 rounded to bf16 for the
// blend, each product of the blend and their sum rounded to bf16, and out
// rounded once from float32 sums.  The widened weights and maps live in
// shared memory as float32, every product of two bf16 values is exact in
// float32, and the sums run in the same fixed orders.  Its routes follow the
// bf16 tile (conv3x3_bf16.cuh, O >= 8 and M >= 8): "mma" is the xf pass, then
// the conv on the bf16 K3f's m16n8k16 tensor-core tile (a fresh float32
// accumulator per 16-channel chunk); "direct" (the mask block, or M < 8) is
// abf_block_direct_kernel on bf16, whose rows are loaded and widened by the
// threads (cp.async does not widen), so they are not in flight under the
// previous row's work.  Bound at the reference block: the bytes, half the
// f32 ones (tap 31.7 MB + res 63.3 MB read, xf and out 126.6 MB written:
// 0.104 ms), above the 75.5 GFLOP at the bf16 tensor-core peak (0.076 ms).
// The block-config step's shapes take route "fused" of abf_block_bf16.cu
// instead (its xf pass on the tensor cores); this instantiation keeps the
// other bf16 shapes.
//
// Interface: plain C, bound with ctypes.  Pointers and the stream are passed
// as void*; res == NULL means no fuse (wxt, wy, zoff are then not read).  The
// return value is cudaGetLastError() after the launches.  The caller
// allocates xf [B, D, T, M], out [B, D, T, O] and, on route "mma", the split
// weights' scratch of abf_block_fwd_scratch_floats(M, O) floats (16-byte
// aligned); abf_block_fwd_route(M, O) names the route: 0 direct, 1 mma.  The
// bf16 entries: abf_block_fwd_bf16 (the same arguments, the packed weights'
// scratch abf_block_fwd_bf16_scratch_elems(M, O) bf16) and
// abf_block_fwd_bf16_route(M, O).

#include <cuda_runtime.h>

#include <cstdint>

#include "bf16_io.cuh"
#include "conv3x3_bf16.cuh"
#include "conv3x3_mma.cuh"

namespace {

constexpr int kMaxCs = 64;   // tap channels
constexpr int kMaxM = 64;    // mid channels
constexpr int kThreads = 256;
constexpr int kBT = 64;      // time steps of a strip
constexpr int kLd = 68;      // stride of a staged pixel (4 p + q covers the 32 banks)
constexpr int kRowsConv = 32;  // freq rows a block walks on route "direct"
constexpr int kMaxOC = 8;      // output channels of a direct block

__device__ __forceinline__ float sigmoid_f32(float x) { return 1.0f / (1.0f + expf(-x)); }

// Route "direct"'s shared memory, in floats, sized by the call's widths: a
// ring of four xf rows of kBT + 2 pixels (three read by a row's conv while
// the fourth is loaded), two tap rows, the small weights and the conv's.
struct Layout {
  static constexpr int kPix = kBT + 2;                // pixels a formed row holds
  static constexpr int kPixPad = (kPix + 3) / 4 * 4;  // whole pixel quads
  static constexpr int kSlots = 4;
  int ldt, w1, bv, wx, wy, z, taps, xo, w2, floats;
  __host__ __device__ Layout(int Cs, int M, int OC) {
    const int cs4 = (Cs + 3) / 4 * 4;
    ldt = cs4 % 32 == 4 ? cs4 : cs4 + (36 - cs4 % 32) % 32;  // 4 (mod 32): logit reads
    w1 = 0;                                  // w1a [Cs][M]
    bv = w1 + (Cs * M + 3) / 4 * 4;          // bvec [M]
    wx = bv + (M + 3) / 4 * 4;               // wxt [Cs][2]
    wy = wx + (2 * Cs + 3) / 4 * 4;          // wy [M][2]
    z = wy + (2 * M + 3) / 4 * 4;            // z [kPixPad][2]
    taps = z + 2 * kPixPad;                  // tap rows [2][kPixPad][ldt]
    xo = taps + 2 * kPixPad * ldt;           // xf rows [kSlots][kPixPad][kLd]
    w2 = xo + kSlots * kPixPad * kLd;        // conv weights [9][M][OC]
    floats = w2 + 9 * M * OC;
  }
};

// E: the maps' and the weights' element type (float or bf16); bvec and zoff
// are float32 either way
template <class E>
struct Args {
  const E* tap;
  const E* res;
  const E* w1a;
  const float* bvec;
  const E* wxt;
  const E* wy;
  const float* zoff;
  const E* w2;
  E* xf;
  E* out;
  int D, Dp, k, T, Cs, M, O, t_tiles, d_chunks;
};

// Row `row` of the strip (pixels ta .. ta + kPix - 1 of batch row b): its
// tap run into taps[j][c] and its y run into xo[j][m] (zeros outside [0,
// T)), as float32: by cp.async for float maps; bf16 maps are loaded and
// widened by the threads (cp.async copies, it does not widen), so their
// loads are not in flight under the previous row's work.  Nothing for a row
// outside the map.
__device__ __forceinline__ void issue_row(const Args<bf16_io::bf16>& a, float* taps, float* xo,
                                          int ldt, long b, int row, int ta) {
  constexpr int n = Layout::kPix;
  const int tid = threadIdx.x, Cs = a.Cs, M = a.M, T = a.T;
  if (row < 0 || row >= a.D) return;
  const long bd = b * a.D + row;
  const bf16_io::bf16* tp = a.tap + (bd * T + ta) * (long)Cs;
  for (int e = tid; e < n * Cs; e += kThreads) {
    const int j = e / Cs, c = e - j * Cs, t = ta + j;
    taps[j * ldt + c] = t >= 0 && t < T ? bf16_io::ld1(tp + e) : 0.0f;
  }
  if (a.res == nullptr) return;
  const bf16_io::bf16* yp = a.res + ((b * a.Dp + row / a.k) * T + ta) * (long)M;
  for (int e = tid; e < n * M; e += kThreads) {
    const int j = e / M, m = e - j * M, t = ta + j;
    xo[j * kLd + m] = t >= 0 && t < T ? bf16_io::ld1(yp + e) : 0.0f;
  }
}

__device__ __forceinline__ void issue_row(const Args<float>& a, float* taps, float* xo, int ldt,
                                          long b, int row, int ta) {
  constexpr int n = Layout::kPix;
  const int tid = threadIdx.x, Cs = a.Cs, M = a.M, T = a.T;
  if (row < 0 || row >= a.D) return;
  const long bd = b * a.D + row;
  const float* tp = a.tap + (bd * T + ta) * (long)Cs;
  if (Cs % 4 == 0) {
    for (int e = tid; e < n * Cs / 4; e += kThreads) {
      const int j = 4 * e / Cs, c = 4 * e - j * Cs, t = ta + j;
      const bool in = t >= 0 && t < T;
      tf32x3::cp_async<16>(taps + j * ldt + c, in ? tp + 4 * e : a.tap, in);
    }
  } else {
    for (int e = tid; e < n * Cs; e += kThreads) {
      const int j = e / Cs, c = e - j * Cs, t = ta + j;
      const bool in = t >= 0 && t < T;
      tf32x3::cp_async<4>(taps + j * ldt + c, in ? tp + e : a.tap, in);
    }
  }
  if (a.res == nullptr) return;
  const float* yp = a.res + ((b * a.Dp + row / a.k) * T + ta) * (long)M;
  if (M % 4 == 0) {
    for (int e = tid; e < n * M / 4; e += kThreads) {
      const int j = 4 * e / M, m = 4 * e - j * M, t = ta + j;
      const bool in = t >= 0 && t < T;
      tf32x3::cp_async<16>(xo + j * kLd + m, in ? yp + 4 * e : a.res, in);
    }
  } else {
    for (int e = tid; e < n * M; e += kThreads) {
      const int j = e / M, m = e - j * M, t = ta + j;
      const bool in = t >= 0 && t < T;
      tf32x3::cp_async<4>(xo + j * kLd + m, in ? yp + e : a.res, in);
    }
  }
}

// xo[j][m] = xf[b, row, ta + j, m] (zeros outside the map) from the staged
// tap and y rows, which the caller has waited for and synced; where the pixel
// is the block's own (row in [own_d0, own_d1), ta + j in [t0, t1)) also into
// a.xf.  For bf16 with the xf pass's roundings (abf_block_xf_kernel), so xo
// holds xf's bf16 values.  Ends before the caller's barrier.
template <class E>
__device__ __forceinline__ void finish_row(const Args<E>& a, const Layout& L, float* smem,
                                           const float* taps, float* xo, long b, int row, int ta,
                                           int own_d0, int own_d1, int t0, int t1) {
  using bf16_io::round_to;
  constexpr bool kBf = sizeof(E) == 2;
  constexpr int n = Layout::kPix;
  const int tid = threadIdx.x;
  const int Cs = a.Cs, M = a.M, T = a.T, ldt = L.ldt;
  const bool fuse = a.res != nullptr;
  if (row < 0 || row >= a.D) {  // the conv's zero padding above and below the map
    for (int e = tid; e < n * kLd; e += kThreads) xo[e] = 0.0f;
    return;
  }
  float* zs = smem + L.z;
  const float* w1s = smem + L.w1;
  const float* bvs = smem + L.bv;
  // z: 4 lanes a pixel, each over channels l (mod 4), added by xor shuffles
  if (fuse) {
    const float* wxs = smem + L.wx;
    const float* wys = smem + L.wy;
    const float zo0 = __ldg(a.zoff), zo1 = __ldg(a.zoff + 1);
    for (int base = 0; base < n; base += kThreads / 4) {
      const int j = base + tid / 4, l = tid % 4;
      float s0 = 0.0f, s1 = 0.0f;
      if (j < n) {
        const float* tp = taps + j * ldt;
        const float* yp = xo + j * kLd;
        for (int c = l; c < Cs; c += 4) {
          s0 = fmaf(tp[c], wxs[2 * c], s0);
          s1 = fmaf(tp[c], wxs[2 * c + 1], s1);
        }
        for (int m = l; m < M; m += 4) {
          s0 = fmaf(yp[m], wys[2 * m], s0);
          s1 = fmaf(yp[m], wys[2 * m + 1], s1);
        }
      }
      s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
      s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
      if (j < n && l == 0) {
        zs[2 * j] = sigmoid_f32(s0 + zo0);
        zs[2 * j + 1] = sigmoid_f32(s1 + zo1);
      }
    }
    __syncthreads();
  }
  const bool own_row = row >= own_d0 && row < own_d1;
  E* xg = a.xf + (b * a.D + row) * T * (long)M;
  if (M % 4 == 0) {
    // 4 pixels x 4 mid channels a thread: xhat from w1a's float4s, then the
    // blend over y in place
    const int quads = M / 4;
    for (int it = tid; it < (n + 3) / 4 * quads; it += kThreads) {
      const int j0 = 4 * (it / quads), m0 = 4 * (it % quads);
      const float4 bv = *reinterpret_cast<const float4*>(bvs + m0);
      // f32: bvec first; bf16: bvec added after the dot and the sum rounded
      const float4 b0 = kBf ? make_float4(0.0f, 0.0f, 0.0f, 0.0f) : bv;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][0] = b0.x, acc[i][1] = b0.y, acc[i][2] = b0.z, acc[i][3] = b0.w;
#pragma unroll 4
      for (int c = 0; c < Cs; ++c) {
        const float4 w = *reinterpret_cast<const float4*>(w1s + c * M + m0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = taps[(j0 + i) * ldt + c];
          acc[i][0] = fmaf(x, w.x, acc[i][0]);
          acc[i][1] = fmaf(x, w.y, acc[i][1]);
          acc[i][2] = fmaf(x, w.z, acc[i][2]);
          acc[i][3] = fmaf(x, w.w, acc[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = j0 + i, t = ta + j;
        if (j >= n) break;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (t >= 0 && t < T) {
          v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          if constexpr (kBf)
            v = make_float4(round_to<E>(v.x + bv.x), round_to<E>(v.y + bv.y),
                            round_to<E>(v.z + bv.z), round_to<E>(v.w + bv.w));
          if (fuse) {
            const float z0 = round_to<E>(zs[2 * j]), z1 = round_to<E>(zs[2 * j + 1]);
            const float4 y = *reinterpret_cast<const float4*>(xo + j * kLd + m0);
            if constexpr (kBf)
              v = make_float4(round_to<E>(round_to<E>(v.x * z0) + round_to<E>(y.x * z1)),
                              round_to<E>(round_to<E>(v.y * z0) + round_to<E>(y.y * z1)),
                              round_to<E>(round_to<E>(v.z * z0) + round_to<E>(y.z * z1)),
                              round_to<E>(round_to<E>(v.w * z0) + round_to<E>(y.w * z1)));
            else
              v = make_float4(fmaf(y.x, z1, v.x * z0), fmaf(y.y, z1, v.y * z0),
                              fmaf(y.z, z1, v.z * z0), fmaf(y.w, z1, v.w * z0));
          }
          if (own_row && t >= t0 && t < t1) bf16_io::st4(xg + (long)t * M + m0, v);
        }
        *reinterpret_cast<float4*>(xo + j * kLd + m0) = v;
      }
    }
  } else {
    for (int e = tid; e < n * M; e += kThreads) {
      const int j = e / M, m = e - j * M, t = ta + j;
      float v = 0.0f;
      if (t >= 0 && t < T) {
        v = kBf ? 0.0f : bvs[m];
        for (int c = 0; c < Cs; ++c) v = fmaf(taps[j * ldt + c], w1s[c * M + m], v);
        if constexpr (kBf) {
          v = round_to<E>(v + bvs[m]);
          if (fuse)
            v = round_to<E>(round_to<E>(v * round_to<E>(zs[2 * j])) +
                            round_to<E>(xo[j * kLd + m] * round_to<E>(zs[2 * j + 1])));
        } else if (fuse) {
          v = fmaf(xo[j * kLd + m], zs[2 * j + 1], v * zs[2 * j]);
        }
        if (own_row && t >= t0 && t < t1) bf16_io::st1(xg + (long)t * M + m, v);
      }
      xo[j * kLd + m] = v;
    }
  }
}

// Route "mma"'s xf pass: kXfLanes lanes a pixel, lane g holding mid channels
// 4 g + 32 kk .. + 3 (kk < 2; 4-wide loads and stores where M allows).  Each
// lane loads its y first (its latency under the xhat loop), forms xhat for
// its channels from the pixel's tap row (read by the pixel's lanes through
// the L1) and w1a in shared memory, and sums its channels' share of the two
// logits (and tap channels 8 g .. 8 g + 7 of the tap's); the lanes' sums are
// added by xor shuffles, then the blend is written once.  No barrier in the
// loop: the block's warps walk pixels on their own, a persistent grid of one
// wave.  E is the maps' and the weights' element type (bvec and zoff are
// float32 either way); the weights are widened into shared memory, and for
// bf16 the pass rounds where the Pallas body rounds on bf16 operands: xhat =
// bf16(tap . w1a + bvec), z in float32 rounded to bf16 for the blend, each
// product of the blend and their sum rounded to bf16.
constexpr int kXfLanes = 8;
constexpr int kXfPix = kThreads / kXfLanes;  // pixels a block takes at a time

template <class E>
__global__ void __launch_bounds__(kThreads, 4)
abf_block_xf_kernel(Args<E> a, long pixels) {
  using namespace bf16_io;
  constexpr bool kBf = sizeof(E) == 2;
  extern __shared__ __align__(16) float smem[];
  float* w1s = smem;                  // [Cs][M]
  float* bvs = w1s + kMaxCs * kMaxM;  // [M]
  float* wxs = bvs + kMaxM;           // [Cs][2]
  float* wys = wxs + 2 * kMaxCs;      // [M][2]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int Cs = a.Cs, M = a.M, T = a.T;
  const bool fuse = a.res != nullptr;
  for (int e = tid; e < Cs * M; e += kThreads) w1s[e] = ld1(a.w1a + e);
  for (int e = tid; e < M; e += kThreads) bvs[e] = __ldg(a.bvec + e);
  if (fuse) {
    for (int e = tid; e < 2 * Cs; e += kThreads) wxs[e] = ld1(a.wxt + e);
    for (int e = tid; e < 2 * M; e += kThreads) wys[e] = ld1(a.wy + e);
  }
  __syncthreads();
  const int g = lane % kXfLanes;
  const bool vec_m = M % 4 == 0, vec_c = Cs % 4 == 0;
  const float zo0 = fuse ? __ldg(a.zoff) : 0.0f, zo1 = fuse ? __ldg(a.zoff + 1) : 0.0f;
  const long stride = (long)gridDim.x * kXfPix;
  // warp-uniform trip count: the shuffles need every lane of the warp
  for (long base = (long)blockIdx.x * kXfPix + warp * (32 / kXfLanes); base < pixels;
       base += stride) {
    const long pix = base + lane / kXfLanes;
    const bool valid = pix < pixels;
    float acc[2][4], y[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int m = 32 * kk + 4 * g;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // f32: bvec first, as the f32 design sums; bf16: added after the dot
        acc[kk][e] = !kBf && m + e < M ? bvs[m + e] : 0.0f;
        y[kk][e] = 0.0f;
      }
    }
    float s0 = 0.0f, s1 = 0.0f;
    if (valid) {
      const E* tp = a.tap + pix * Cs;
      if (fuse) {
        const long bd = pix / T;
        const int t = (int)(pix - bd * T), d = (int)(bd % a.D);
        const long b = bd / a.D;
        const E* yp = a.res + ((b * a.Dp + d / a.k) * T + t) * (long)M;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int m = 32 * kk + 4 * g;
          if (m >= M) continue;
          if (vec_m) {
            const float4 v = ld4(yp + m);
            y[kk][0] = v.x, y[kk][1] = v.y, y[kk][2] = v.z, y[kk][3] = v.w;
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) y[kk][q] = m + q < M ? ld1(yp + m + q) : 0.0f;
          }
        }
      }
      if (vec_c && vec_m) {
#pragma unroll 2
        for (int c = 0; c < Cs; c += 4) {
          const float4 t4 = ld4(tp + c);
          const float tv[4] = {t4.x, t4.y, t4.z, t4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int kk = 0; kk < 2; ++kk) {
              const int m = 32 * kk + 4 * g;
              if (m < M) {
                const float4 w = *reinterpret_cast<const float4*>(w1s + (c + e) * M + m);
                acc[kk][0] = fmaf(tv[e], w.x, acc[kk][0]);
                acc[kk][1] = fmaf(tv[e], w.y, acc[kk][1]);
                acc[kk][2] = fmaf(tv[e], w.z, acc[kk][2]);
                acc[kk][3] = fmaf(tv[e], w.w, acc[kk][3]);
              }
            }
        }
      } else {
        for (int c = 0; c < Cs; ++c) {
          const float tv = ld1(tp + c);
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            const int m = 32 * kk + 4 * g;
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (m + q < M) acc[kk][q] = fmaf(tv, w1s[c * M + m + q], acc[kk][q]);
          }
        }
      }
      if (fuse) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int m = 32 * kk + 4 * g;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (m + q < M) {
              s0 = fmaf(y[kk][q], wys[2 * (m + q)], s0);
              s1 = fmaf(y[kk][q], wys[2 * (m + q) + 1], s1);
            }
          }
        }
        for (int c = 8 * g; c < 8 * g + 8 && c < Cs; ++c) {
          const float tv = ld1(tp + c);
          s0 = fmaf(tv, wxs[2 * c], s0);
          s1 = fmaf(tv, wxs[2 * c + 1], s1);
        }
      }
    }
    if (fuse) {
#pragma unroll
      for (int off = 1; off < kXfLanes; off <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      }
    }
    if (!valid) continue;
    float z0 = fuse ? sigmoid_f32(s0 + zo0) : 1.0f, z1 = fuse ? sigmoid_f32(s1 + zo1) : 0.0f;
    if constexpr (kBf) z0 = round_to<E>(z0), z1 = round_to<E>(z1);
    E* dst = a.xf + pix * M;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int m = 32 * kk + 4 * g;
      if (m >= M) continue;
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if constexpr (kBf) {
          const float xh = round_to<E>(acc[kk][q] + (m + q < M ? bvs[m + q] : 0.0f));
          v[q] = fuse ? round_to<E>(xh * z0) + round_to<E>(y[kk][q] * z1) : xh;
        } else {
          v[q] = fuse ? fmaf(y[kk][q], z1, acc[kk][q] * z0) : acc[kk][q];
        }
      }
      if (vec_m) {
        st4(dst + m, make_float4(v[0], v[1], v[2], v[3]));
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (m + q < M) st1(dst + m + q, v[q]);
      }
    }
  }
}

// Route "direct": block (b, strip, chunk of kRowsConv rows; output tile
// blockIdx.y of OC channels) forms xf in a ring of rows and convolves; only
// output tile 0 writes xf.  Row x lives in ring slot (x - d0 + 1) % 4 and its
// tap row in buffer (x - d0 + 1) % 2; the loads of row d + 2 are in flight
// (cp.async) while row d + 1 is formed and row d convolved.  The conv of a
// row: thread (pixel quad pq, lane q of 16) sums, for its 4 pixels and all
// OC outputs, the mid channels m = q (mod 16): per (row r, channel) 6 staged
// values serve the 3 time shifts of its 4 pixels; the 16 lanes' partials are
// added by xor shuffles.
template <int OC, class E>
__global__ void __launch_bounds__(kThreads, 2) abf_block_direct_kernel(Args<E> a) {
  using bf16_io::ld1;
  extern __shared__ __align__(16) float smem[];
  const Layout L(a.Cs, a.M, OC);
  const int tid = threadIdx.x;
  const int chunk = (int)(blockIdx.x % a.d_chunks);
  const long strip = blockIdx.x / a.d_chunks;  // b * t_tiles + time tile
  const long b = strip / a.t_tiles;
  const int t0 = (int)(strip - b * a.t_tiles) * kBT;
  const int d0 = chunk * kRowsConv;
  const int d1 = d0 + kRowsConv < a.D ? d0 + kRowsConv : a.D;
  const int Cs = a.Cs, M = a.M;
  const bool fuse = a.res != nullptr;
  const int o0 = blockIdx.y * OC;

  for (int e = tid; e < Cs * M; e += kThreads) smem[L.w1 + e] = ld1(a.w1a + e);
  for (int e = tid; e < M; e += kThreads) smem[L.bv + e] = __ldg(a.bvec + e);
  if (fuse) {
    for (int e = tid; e < 2 * Cs; e += kThreads) smem[L.wx + e] = ld1(a.wxt + e);
    for (int e = tid; e < 2 * M; e += kThreads) smem[L.wy + e] = ld1(a.wy + e);
  }
  float* w2s = smem + L.w2;  // w2s[(k * M + m) * OC + o] = w2[k, m, o0 + o]
  for (int e = tid; e < 9 * M * OC; e += kThreads) {
    const int o = e % OC, km = e / OC;
    w2s[e] = o0 + o < a.O ? ld1(a.w2 + (long)km * a.O + o0 + o) : 0.0f;
  }
  const int t1 = t0 + kBT < a.T ? t0 + kBT : a.T;
  const int own0 = blockIdx.y == 0 ? d0 : 0, own1 = blockIdx.y == 0 ? d1 : 0;
  constexpr int kSlot = Layout::kPixPad * kLd;
  const int tslot = Layout::kPixPad * L.ldt;
  auto xo = [&](int x) { return smem + L.xo + ((x - d0 + 1) % Layout::kSlots) * kSlot; };
  auto tp = [&](int x) { return smem + L.taps + ((x - d0 + 1) % 2) * tslot; };
  auto issue = [&](int x) {
    if (x <= d1) issue_row(a, tp(x), xo(x), L.ldt, b, x, t0 - 1);
    tf32x3::cp_async_commit();
  };
  auto finish = [&](int x) {
    finish_row(a, L, smem, tp(x), xo(x), b, x, t0 - 1, own0, own1, t0, t1);
  };
  issue(d0 - 1);
  issue(d0);
  tf32x3::cp_async_wait<1>();
  __syncthreads();  // row d0 - 1's loads, and the weights
  finish(d0 - 1);
  __syncthreads();  // row d0 + 1's tap buffer is row d0 - 1's
  issue(d0 + 1);
  tf32x3::cp_async_wait<1>();
  __syncthreads();
  finish(d0);
  const int pq = tid / 16, q = tid % 16;
  for (int d = d0; d < d1; ++d) {
    __syncthreads();  // the conv of d - 1 and the forming of d are done
    issue(d + 2);     // into row d - 2's slot and row d's tap buffer
    tf32x3::cp_async_wait<1>();
    __syncthreads();  // row d + 1's loads
    finish(d + 1);
    __syncthreads();
    // out[b, d, t0 + 4 pq + i, o0 + o]
    float acc[4][OC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int o = 0; o < OC; ++o) acc[i][o] = 0.0f;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float* xr = xo(d + r - 1) + 4 * pq * kLd;
      const float* wr = w2s + r * 3 * M * OC;
      for (int m = q; m < M; m += 16) {
        float x[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) x[i] = xr[i * kLd + m];
#pragma unroll
        for (int s = 0; s < 3; ++s) {
          float w[OC];
#pragma unroll
          for (int o = 0; o < OC; ++o) w[o] = wr[(s * M + m) * OC + o];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int o = 0; o < OC; ++o) acc[i][o] = fmaf(x[i + s], w[o], acc[i][o]);
        }
      }
    }
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int o = 0; o < OC; ++o) acc[i][o] += __shfl_xor_sync(0xffffffffu, acc[i][o], off);
    E* dst = a.out + ((b * a.D + d) * a.T + t0 + 4 * pq) * (long)a.O + o0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int o = 0; o < OC; ++o)
        if ((i * OC + o) % 16 == q && t0 + 4 * pq + i < a.T && o0 + o < a.O)
          bf16_io::st1(dst + (long)i * a.O + o, acc[i][o]);
  }
}

template <class E>
cudaError_t launch_xf(const Args<E>& a, long pixels, cudaStream_t stream) {
  constexpr int kBytes = (kMaxCs * kMaxM + kMaxM + 2 * kMaxCs + 2 * kMaxM) * (int)sizeof(float);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, abf_block_xf_kernel<E>, kThreads,
                                                        kBytes);
  if (err != cudaSuccess) return err;
  const long tiles = (pixels + kXfPix - 1) / kXfPix;
  const long most = (long)sms * (per_sm > 0 ? per_sm : 1);  // one wave of blocks
  abf_block_xf_kernel<E><<<(unsigned)(tiles < most ? tiles : most), kThreads, kBytes, stream>>>(
      a, pixels);
  return cudaGetLastError();
}

template <int OC, class E>
cudaError_t launch_direct(const Args<E>& a0, int B, cudaStream_t stream) {
  Args<E> a = a0;
  a.t_tiles = (a.T + kBT - 1) / kBT;
  a.d_chunks = (a.D + kRowsConv - 1) / kRowsConv;
  const int bytes = Layout(a.Cs, a.M, OC).floats * (int)sizeof(float);
  // above 48 KB needs the opt-in: set on every call
  const cudaError_t err = cudaFuncSetAttribute(
      abf_block_direct_kernel<OC, E>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((long)B * a.t_tiles * a.d_chunks),
                  (unsigned)((a.O + OC - 1) / OC));
  abf_block_direct_kernel<OC, E><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <class E>
cudaError_t launch_direct_for(const Args<E>& a, int B, int O, cudaStream_t s) {
  if (O <= 2) return launch_direct<2>(a, B, s);
  if (O <= 4) return launch_direct<4>(a, B, s);
  return launch_direct<kMaxOC>(a, B, s);
}

}  // namespace

extern "C" int abf_block_fwd_route(int M, int O) { return conv3x3_mma::fwd_route(M, O); }

extern "C" long abf_block_fwd_scratch_floats(int M, int O) {
  return conv3x3_mma::fwd_scratch_floats(M, O);
}

extern "C" int abf_block_fwd(const void* tap, const void* res, const void* w1a, const void* bvec,
                             const void* wxt, const void* wy, const void* zoff, const void* w2,
                             void* wscratch, void* xf, void* out, int B, int D, int Dp, int T,
                             int Cs, int M, int O, void* stream) {
  const bool fuse = res != nullptr;
  if (B < 1 || D < 1 || T < 1 || Cs < 1 || Cs > kMaxCs || M < 1 || M > kMaxM || O < 1 ||
      (fuse && (Dp < 1 || D % Dp)) || (fuse && (!wxt || !wy || !zoff)))
    return (int)cudaErrorInvalidValue;
  Args<float> a{static_cast<const float*>(tap), static_cast<const float*>(res),
         static_cast<const float*>(w1a), static_cast<const float*>(bvec),
         static_cast<const float*>(wxt), static_cast<const float*>(wy),
         static_cast<const float*>(zoff), static_cast<const float*>(w2),
         static_cast<float*>(xf), static_cast<float*>(out),
         D, fuse ? Dp : D, fuse ? D / Dp : 1, T, Cs, M, O, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (conv3x3_mma::fwd_route(M, O) == 1) {
    cudaError_t err = launch_xf(a, (long)B * D * T, s);
    if (err != cudaSuccess) return (int)err;
    return (int)conv3x3_mma::fwd_mma_run<false>(a.xf, a.w2, static_cast<float4*>(wscratch),
                                                nullptr, a.out, B, D, T, M, O, s);
  }
  return (int)launch_direct_for(a, B, O, s);
}

// The bf16 instantiation: tap, res, w1a, wxt, wy, w2, xf and out in bf16,
// bvec and zoff float32, with the Pallas body's roundings on bf16 operands
// (abf_block_xf_kernel).  Route "mma" (O >= 8 and M >= 8, the bf16 tile's
// test): the xf pass writes xf, then the conv over xf runs on the bf16 K3f's
// m16n8k16 tensor-core tile (conv3x3_bf16.cuh) through the packed weights'
// scratch of abf_block_fwd_bf16_scratch_elems(M, O) bf16, out rounded once.
// Route "direct" (the mask block, O = 2; or M < 8): abf_block_direct_kernel
// on bf16, xf formed in its ring of rows and convolved in f32 FMA.
extern "C" int abf_block_fwd_bf16_route(int M, int O) { return conv3x3_bf16::fwd_route(M, O); }

extern "C" long abf_block_fwd_bf16_scratch_elems(int M, int O) {
  return conv3x3_bf16::fwd_scratch_elems(M, O);
}

extern "C" int abf_block_fwd_bf16(const void* tap, const void* res, const void* w1a,
                                  const void* bvec, const void* wxt, const void* wy,
                                  const void* zoff, const void* w2, void* wscratch, void* xf,
                                  void* out, int B, int D, int Dp, int T, int Cs, int M, int O,
                                  void* stream) {
  using bf16_io::bf16;
  const bool fuse = res != nullptr;
  if (B < 1 || D < 1 || T < 1 || Cs < 1 || Cs > kMaxCs || M < 1 || M > kMaxM || O < 1 ||
      (fuse && (Dp < 1 || D % Dp)) || (fuse && (!wxt || !wy || !zoff)))
    return (int)cudaErrorInvalidValue;
  const Args<bf16> a{static_cast<const bf16*>(tap), static_cast<const bf16*>(res),
                     static_cast<const bf16*>(w1a), static_cast<const float*>(bvec),
                     static_cast<const bf16*>(wxt), static_cast<const bf16*>(wy),
                     static_cast<const float*>(zoff), static_cast<const bf16*>(w2),
                     static_cast<bf16*>(xf), static_cast<bf16*>(out),
                     D, fuse ? Dp : D, fuse ? D / Dp : 1, T, Cs, M, O, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (conv3x3_bf16::fwd_route(M, O) == 0) return (int)launch_direct_for(a, B, O, s);
  const cudaError_t err = launch_xf(a, (long)B * D * T, s);
  if (err != cudaSuccess) return (int)err;
  return (int)conv3x3_bf16::fwd_run<false>(a.xf, a.w2, static_cast<bf16*>(wscratch), nullptr, out,
                                           B, D, T, M, O, s);
}
