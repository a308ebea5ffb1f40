// The whole ABF block, forward, for Hopper (sm_90a): 1x1 conv with bn1's
// affine folded in, attention fuse with the upscaled residual, and the 3x3
// SAME conv, in one launch that writes only xf and the raw conv output.
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
// All arithmetic is f32 FMA (no TF32).
//
// What bounds it on this card.  The 3x3 conv's 2 * B*D*T * 9M * O operations
// against reading tap and res once and writing xf and out once: the f32 FMA
// rate at every ABF block but the decoder's mask block (O = 2), where the
// bytes of xf and res do.
//
// Design.  K3f's tile (conv3x3_tiles.cuh): a block owns one freq row (b, d),
// BM time steps and BN output channels, and per chunk of kKC mid channels
// stages the xf halo of 3 freq rows x (BM + 2) time steps in shared memory,
// then runs the FMA loop.  Here the halo is computed, not loaded, by all
// kThreads = 256 threads of the block, while the FMA loop runs on the tile's
// own (BM / 4) * (BN / 4) threads (64 of them for O < 16, where 256 x 4 tiles
// would otherwise leave 13 halo pixels to each thread):
//   1. one thread per halo pixel sums tap . wxt and y . wy (its loads
//      independent, so they overlap) and keeps z in shared memory;
//   2. per chunk, one thread per halo pixel forms xhat for the chunk's kKC
//      channels (the chunk of w1a in shared memory, read as float4s), blends
//      it with y, and stages the result; pixels outside the map stage 0, the
//      conv's zero padding (not the blend of zeros, which is bvec-valued);
//      the blocks of the first output tile write their own row's xf.  Where
//      M is a multiple of 8 (and Cs of 4) y, xf (and tap) move as float4s.
// x1/xhat, the upscaled residual and z never reach device memory.  The halo
// rows are formed again by the neighbouring rows' blocks and by every output
// tile: at Cs channels that is 3 * Cs * M FMAs a pixel and output tile,
// against the conv's 9 * M * min(O, BN).  The residual's row is indexed by
// g / k directly, so k need not divide any tile.  Offsets are 64-bit (the
// mask block's xf has 253 M elements).
//
// Interface: plain C, bound with ctypes.  Pointers and the stream are passed
// as void*; res == NULL means no fuse (wxt, wy, zoff are then not read).  The
// return value is cudaGetLastError() after the launch.  The caller allocates
// xf [B, D, T, M] and out [B, D, T, O].

#include <cuda_runtime.h>

#include "conv3x3_tiles.cuh"

namespace {

using namespace conv3x3_tiles;

constexpr int kMaxCs = 64;  // tap channels (the chunk of w1a is staged whole)

__device__ __forceinline__ float sigmoid_f32(float x) { return 1.0f / (1.0f + expf(-x)); }

// v[cc] += a * w1c_row[cc] for the chunk's kKC channels (two float4 reads)
__device__ __forceinline__ void xhat_step(float (&v)[kKC], float a, const float* w1c_row) {
  const float4 wa = *reinterpret_cast<const float4*>(w1c_row);
  const float4 wb = *reinterpret_cast<const float4*>(w1c_row + 4);
  v[0] = fmaf(a, wa.x, v[0]);
  v[1] = fmaf(a, wa.y, v[1]);
  v[2] = fmaf(a, wa.z, v[2]);
  v[3] = fmaf(a, wa.w, v[3]);
  v[4] = fmaf(a, wb.x, v[4]);
  v[5] = fmaf(a, wb.y, v[5]);
  v[6] = fmaf(a, wb.z, v[6]);
  v[7] = fmaf(a, wb.w, v[7]);
}

constexpr int kThreads = 256;

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads)
abf_block_fwd_kernel(const float* __restrict__ tap, const float* __restrict__ res,
                     const float* __restrict__ w1a, const float* __restrict__ bvec,
                     const float* __restrict__ wxt, const float* __restrict__ wy,
                     const float* __restrict__ zoff, const float* __restrict__ w2,
                     float* __restrict__ xf, float* __restrict__ out, int D, int k, int T,
                     int Cs, int M, int O, int t_tiles) {
  constexpr int kConvThreads = fwd_threads<BM, BN>();
  static_assert(kConvThreads <= kThreads, "the tile needs more threads than the block has");
  constexpr int kRows = BM + 2;    // staged time steps, halo included
  constexpr int kPix = 3 * kRows;  // halo pixels
  __shared__ float xs[3][kRows][kXs];
  __shared__ __align__(16) float ws[9][kKC][BN];
  __shared__ __align__(16) float w1c[kMaxCs][kKC];
  __shared__ float zs[kPix][2];

  const long bd = blockIdx.x / t_tiles;  // b * D + d
  const int t0 = (int)(blockIdx.x - bd * t_tiles) * BM;
  const int d = (int)(bd % D);
  const long b = bd / D;
  const int Dp = D / k;
  const int o0 = blockIdx.y * BN;
  const int tx = threadIdx.x % (BN / kTN);
  const int ty = threadIdx.x / (BN / kTN);
  const bool fuse = res != nullptr;
  const bool vec_m = M % kKC == 0, vec_c = Cs % 4 == 0;

  // 1. z of every in-map halo pixel, one thread a pixel
  if (fuse) {
    const float zo0 = __ldg(zoff), zo1 = __ldg(zoff + 1);
    for (int p = threadIdx.x; p < kPix; p += kThreads) {
      const int r = p / kRows, j = p % kRows;
      const int g = d + r - 1, t = t0 + j - 1;
      if (g < 0 || g >= D || t < 0 || t >= T) continue;
      const float* tp = tap + ((bd + r - 1) * T + t) * (long)Cs;
      const float* yp = res + ((b * Dp + g / k) * T + t) * (long)M;
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll 8
      for (int c = 0; c < Cs; ++c) {
        const float v = __ldg(tp + c);
        s0 = fmaf(v, __ldg(wxt + 2 * c), s0);
        s1 = fmaf(v, __ldg(wxt + 2 * c + 1), s1);
      }
      if (vec_m) {
#pragma unroll 4
        for (int m = 0; m < M; m += 4) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(yp + m));
          const float4 w0 = __ldg(reinterpret_cast<const float4*>(wy + 2 * m));
          const float4 w1 = __ldg(reinterpret_cast<const float4*>(wy + 2 * m + 4));
          s0 = fmaf(v.w, w1.z, fmaf(v.z, w1.x, fmaf(v.y, w0.z, fmaf(v.x, w0.x, s0))));
          s1 = fmaf(v.w, w1.w, fmaf(v.z, w1.y, fmaf(v.y, w0.w, fmaf(v.x, w0.y, s1))));
        }
      } else {
#pragma unroll 8
        for (int m = 0; m < M; ++m) {
          const float v = __ldg(yp + m);
          s0 = fmaf(v, __ldg(wy + 2 * m), s0);
          s1 = fmaf(v, __ldg(wy + 2 * m + 1), s1);
        }
      }
      zs[p][0] = sigmoid_f32(s0 + zo0);
      zs[p][1] = sigmoid_f32(s1 + zo1);
    }
  }

  float acc[kTM][kTN];
  zero_tile(acc);
  for (int c0 = 0; c0 < M; c0 += kKC) {
    // w1c[c][cc] = w1a[c, c0 + cc] (zeros past M)
    for (int e = threadIdx.x; e < Cs * kKC; e += kThreads) {
      const int cc = e % kKC, c = e / kKC, m = c0 + cc;
      w1c[c][cc] = m < M ? __ldg(w1a + (long)c * M + m) : 0.0f;
    }
    stage_weights<BM, BN, kThreads>(ws, w2, c0, o0, M, O);
    __syncthreads();  // also orders step 1's zs before its first read
    // 2. xs[r][j][cc] = xf[b, d + r - 1, t0 + j - 1, c0 + cc], zero outside
    for (int p = threadIdx.x; p < kPix; p += kThreads) {
      const int r = p / kRows, j = p % kRows;
      const int g = d + r - 1, t = t0 + j - 1;
      float v[kKC];
#pragma unroll
      for (int cc = 0; cc < kKC; ++cc) v[cc] = 0.0f;
      if (g >= 0 && g < D && t >= 0 && t < T) {
#pragma unroll
        for (int cc = 0; cc < kKC; ++cc) v[cc] = c0 + cc < M ? __ldg(bvec + c0 + cc) : 0.0f;
        const float* tp = tap + ((bd + r - 1) * T + t) * (long)Cs;
        if (vec_c) {
#pragma unroll 2
          for (int c = 0; c < Cs; c += 4) {
            const float4 a4 = __ldg(reinterpret_cast<const float4*>(tp + c));
            const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) xhat_step(v, a[i], w1c[c + i]);
          }
        } else {
#pragma unroll 4
          for (int c = 0; c < Cs; ++c) xhat_step(v, __ldg(tp + c), w1c[c]);
        }
        if (fuse) {
          const float z0 = zs[p][0], z1 = zs[p][1];
          const float* yp = res + ((b * Dp + g / k) * T + t) * (long)M + c0;
          float y[kKC];
          if (vec_m) {
            const float4 ya = __ldg(reinterpret_cast<const float4*>(yp));
            const float4 yb = __ldg(reinterpret_cast<const float4*>(yp + 4));
            y[0] = ya.x, y[1] = ya.y, y[2] = ya.z, y[3] = ya.w;
            y[4] = yb.x, y[5] = yb.y, y[6] = yb.z, y[7] = yb.w;
          } else {
#pragma unroll
            for (int cc = 0; cc < kKC; ++cc) y[cc] = c0 + cc < M ? __ldg(yp + cc) : 0.0f;
          }
#pragma unroll
          for (int cc = 0; cc < kKC; ++cc) v[cc] = fmaf(y[cc], z1, v[cc] * z0);
        }
        if (r == 1 && j >= 1 && j <= BM && blockIdx.y == 0) {  // own pixels, written once
          float* dst = xf + (bd * T + t) * (long)M + c0;
          if (vec_m) {
            reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
            reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
          } else {
#pragma unroll
            for (int cc = 0; cc < kKC; ++cc)
              if (c0 + cc < M) dst[cc] = v[cc];
          }
        }
      }
#pragma unroll
      for (int cc = 0; cc < kKC; ++cc) xs[r][j][cc] = v[cc];
    }
    __syncthreads();
    if (threadIdx.x < kConvThreads) fma_chunk<BM, BN>(xs, ws, acc, tx, ty);
    __syncthreads();
  }
  if (threadIdx.x < kConvThreads) store_tile(out, acc, bd, t0, T, o0, O, tx, ty);
}

template <int BM, int BN>
cudaError_t launch(const float* tap, const float* res, const float* w1a, const float* bvec,
                   const float* wxt, const float* wy, const float* zoff, const float* w2,
                   float* xf, float* out, int B, int D, int k, int T, int Cs, int M, int O,
                   cudaStream_t stream) {
  const int t_tiles = (T + BM - 1) / BM;
  const dim3 grid((unsigned)((long)B * D * t_tiles), (unsigned)((O + BN - 1) / BN));
  abf_block_fwd_kernel<BM, BN><<<grid, kThreads, 0, stream>>>(
      tap, res, w1a, bvec, wxt, wy, zoff, w2, xf, out, D, k, T, Cs, M, O, t_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" int abf_block_fwd(const void* tap, const void* res, const void* w1a, const void* bvec,
                             const void* wxt, const void* wy, const void* zoff, const void* w2,
                             void* xf, void* out, int B, int D, int Dp, int T, int Cs, int M,
                             int O, void* stream) {
  const bool fuse = res != nullptr;
  if (B < 1 || D < 1 || T < 1 || Cs < 1 || Cs > kMaxCs || M < 1 || O < 1 ||
      (fuse && (Dp < 1 || D % Dp)) || (fuse && (!wxt || !wy || !zoff)))
    return (int)cudaErrorInvalidValue;
  const int k = fuse ? D / Dp : 1;
  const float* a = static_cast<const float*>(tap);
  const float* r = static_cast<const float*>(res);
  const float* w1 = static_cast<const float*>(w1a);
  const float* bv = static_cast<const float*>(bvec);
  const float* wt = static_cast<const float*>(wxt);
  const float* wyy = static_cast<const float*>(wy);
  const float* zo = static_cast<const float*>(zoff);
  const float* w = static_cast<const float*>(w2);
  float* x = static_cast<float*>(xf);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (O >= 64)
    err = launch<64, 64>(a, r, w1, bv, wt, wyy, zo, w, x, o, B, D, k, T, Cs, M, O, s);
  else if (O >= 32)
    err = launch<128, 32>(a, r, w1, bv, wt, wyy, zo, w, x, o, B, D, k, T, Cs, M, O, s);
  else if (O >= 16)
    err = launch<256, 16>(a, r, w1, bv, wt, wyy, zo, w, x, o, B, D, k, T, Cs, M, O, s);
  else
    err = launch<256, 4>(a, r, w1, bv, wt, wyy, zo, w, x, o, B, D, k, T, Cs, M, O, s);
  return (int)err;
}
