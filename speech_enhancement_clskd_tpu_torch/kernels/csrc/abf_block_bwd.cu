// The whole ABF block, backward, for Hopper (sm_90a): every gradient of the
// block in one main pass over the maps, the conv weight gradient in a split
// reduction, and the small gradients' partials added in a fixed order.
//
// Replaces speech_enhancement_clskd_tpu/ops/pallas/abf_block.py::_bwd_kernel
// (reached through _bwd_raw).  Same function: given the forward's inputs (see
// abf_block_fwd.cu), its xf, the incoming g_xf [B, D, T, M] and g_out
// [B, D, T, O], and w2f[dd, tt, o, m] = w2[2 - dd, 2 - tt, m, o],
//     dxf    = g_xf + conv3x3_same(g_out, w2f)        (the conv adjoint)
//     dz     = (dxf . xhat, dxf . y),  dp = z (1 - z) dz
//     g_xhat = dxf z0                                  (dxf without a residual)
//     g_y    = dxf z1 + dp0 wy[:, 0] + dp1 wy[:, 1]
//     g_tap  = g_xhat @ w1a^T + dp0 wxt[:, 0] + dp1 wxt[:, 1]
//     g_res[b, r, t] = sum of g_y over the k rows d = r*k .. r*k + k - 1
//     dw1a = sum tap^T g_xhat, dbvec = sum g_xhat, dwxt = sum tap^T dp,
//     dwy = sum y^T dp, dzoff = sum dp, dw2 = the conv weight gradient of
//     (xf, g_out)
// with xhat and z recomputed from tap and res.  All arithmetic is f32 FMA.
//
// What bounds it on this card.  Two 3x3 convs' worth of operations (the
// adjoint and dw2, 2 * B*D*T * 9M * O each) plus 4 * Cs * M a pixel for the
// 1x1 conv's two products, against reading tap, res, xf, g_xf and g_out and
// writing g_tap and g_res once: the f32 FMA rate at every block but the mask
// block (O = 2), where the bytes do.
//
// Design.
//   1. abf_block_bwd_kernel.  A work item is one residual row (b, r) and
//      kBM time steps; a fixed number of blocks (kBlocks, fewer for small
//      maps) each take a fixed contiguous range of items and walk them in
//      order.  Per item the block keeps the residual tile y and the sum of
//      g_y in shared memory and walks the k freq rows d that read it:
//        a. the conv adjoint for the row's tile, in K3f's tile
//           (conv3x3_tiles.cuh) over a 1-row halo of g_out: kBM time steps x
//           all M <= 64 mid channels, one 4 x 4 register tile a thread; plus
//           g_xf, into dxf in shared memory (never device memory), zero past
//           T, so the pad columns add nothing to dbvec/dzoff;
//        b. the tap tile into shared memory (over the conv's staging);
//        c. each warp 8 pixels: xhat, the logits, dz and dp, the 32 lane
//           sums reduced together (xor butterfly);
//        d. g_y added into the tile's sum, g_xhat over dxf in place;
//        e. g_tap, 4 pixels x 4 channels a thread, written; and the
//           parameter sums: dw1a 4 x 4 a thread in registers, dbvec, dwxt,
//           dwy and dzoff in registers of the first n_small threads.
//      After its k rows the item writes g_res once: no two blocks write the
//      same g_res, nothing is added atomically.  At the end each block writes
//      one partial [dw1a | dbvec | dwxt | dwy | dzoff].
//   2. reduce_partials_kernel adds the blocks' partials in block order.
//   3. dw2: K3w's split reduction (conv3x3_tiles.cuh::wgrad_run, on K3w's
//      route by shape: split TF32 on the tensor cores for O > 8) over xf and
//      g_out, not K3w's wrapper, so K3w's launch count stays at 0 on this path.
// Every split depends only on the shape, so every run gives the same bits.
// Offsets are 64-bit.
//
// Interface: plain C, bound with ctypes.  res == NULL means no fuse (wxt, wy,
// zoff, g_res are then not touched, and the dwxt/dwy/dzoff slots come out 0).
// abf_block_bwd_blocks(B, Dp, T) gives the main pass's block count (pass
// Dp = D without a residual) and abf_block_bwd_wgrad_chunks(M, O, B*D) the
// dw2 pass's chunks; the caller allocates g_tap, g_res, grads [Cs*M + 3M +
// 2Cs + 2], dw2 [3, 3, M, O], the partials (blocks x the grads' length) and
// the dw2 scratch (chunks * 9 * M * O).  The return value is
// cudaGetLastError() after each launch.

#include <cuda_runtime.h>

#include "conv3x3_tiles.cuh"

namespace {

using namespace conv3x3_tiles;

constexpr int kBM = 64;        // time steps of a work item
constexpr int kBN = 64;        // mid channels of the adjoint's tile: all of M
constexpr int kMaxCs = 64;
constexpr int kMaxM = kBN;
constexpr int kLd = 68;        // row stride of the [kBM][64] tiles (float4-aligned)
constexpr int kThreads = fwd_threads<kBM, kBN>();  // 256
constexpr int kWarps = kThreads / 32;
constexpr int kPixPerWarp = kBM / kWarps;  // 8
constexpr int kBlocks = 264;   // two a streaming multiprocessor on an H100
// shared memory, in floats: the conv staging (g_out halo + weights), which
// the tap tile later reuses; dxf, y, the g_y sum, w1a; z and dp a pixel
constexpr int kGs = 3 * (kBM + 2) * kXs;          // 1782
constexpr int kGsPad = (kGs + 3) / 4 * 4;         // 1784
constexpr int kConv = kGsPad + 9 * kKC * kBN;     // + 4608
constexpr int kTile = kBM * kLd;                  // 4352
constexpr int kUnion = kConv > kTile ? kConv : kTile;
constexpr int kSmemFloats = kUnion + 4 * kTile + 4 * kBM;
constexpr int kSmemBytes = kSmemFloats * 4;       // 96,224

__device__ __forceinline__ float sigmoid_f32(float x) { return 1.0f / (1.0f + expf(-x)); }

__global__ void __launch_bounds__(kThreads, 2)
abf_block_bwd_kernel(const float* __restrict__ tap, const float* __restrict__ res,
                     const float* __restrict__ w1a, const float* __restrict__ bvec,
                     const float* __restrict__ wxt, const float* __restrict__ wy,
                     const float* __restrict__ zoff, const float* __restrict__ w2f,
                     const float* __restrict__ gxf, const float* __restrict__ gout,
                     float* __restrict__ gtap, float* __restrict__ gres,
                     float* __restrict__ partial, long items, long items_per_block, int D,
                     int k, int T, int Cs, int M, int O) {
  extern __shared__ __align__(16) float smem[];
  auto gs = reinterpret_cast<float (*)[kBM + 2][kXs]>(smem);
  auto ws = reinterpret_cast<float (*)[kKC][kBN]>(smem + kGsPad);
  float* taps = smem;  // [kBM][kLd], over the conv staging
  float* dxs = smem + kUnion;
  float* ys = dxs + kTile;
  float* gys = ys + kTile;
  float* w1s = gys + kTile;  // w1s[c * kLd + m] = w1a[c, m]
  float* zdp = w1s + kTile;  // [kBM][4]: z0, z1, dp0, dp1

  const bool fuse = res != nullptr;
  const int Dp = D / k;
  const int t_tiles = (T + kBM - 1) / kBM;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid / 32;
  const int tx = tid % (kBN / kTN), ty = tid / (kBN / kTN);  // the adjoint's tile
  const int lo = tid % 16, hi = tid / 16;                     // 16 x 16 thread grid
  const int n_small = 3 * M + 2 * Cs + 2;

  for (int e = tid; e < kTile; e += kThreads) {
    const int c = e / kLd, m = e % kLd;
    w1s[e] = (c < Cs && m < M) ? __ldg(w1a + (long)c * M + m) : 0.0f;
  }
  float aw[4][4];  // dw1a[c = hi + 16 i, m = 4 lo + j]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) aw[i][j] = 0.0f;
  float as[2] = {0.0f, 0.0f};  // small gradient slots tid and tid + kThreads

  const long begin = (long)blockIdx.x * items_per_block;
  const long end = begin + items_per_block < items ? begin + items_per_block : items;
  for (long item = begin; item < end; ++item) {
    const long br = item / t_tiles;  // b * Dp + r
    const int t0 = (int)(item - br * t_tiles) * kBM;
    const long b = br / Dp;
    const int r = (int)(br - b * Dp);
    // the residual tile and the g_y sum
    for (int e = tid; e < kTile; e += kThreads) {
      const int p = e / kLd, m = e % kLd, t = t0 + p;
      ys[e] = (fuse && t < T && m < M) ? __ldg(res + (br * T + t) * (long)M + m) : 0.0f;
      gys[e] = 0.0f;
    }
    for (int kk = 0; kk < k; ++kk) {
      const int d = r * k + kk;
      const long bd = b * D + d;
      // a. conv adjoint: acc[i][j] = dxf at (t0 + 4 ty + i, 4 tx + j) less g_xf
      float acc[kTM][kTN];
      zero_tile(acc);
      for (int c0 = 0; c0 < O; c0 += kKC) {
        for (int e = tid; e < 3 * (kBM + 2) * kKC; e += kThreads) {
          const int c = e % kKC;
          const int j = (e / kKC) % (kBM + 2);
          const int rr = e / (kKC * (kBM + 2));
          const int dr = d + rr - 1, t = t0 + j - 1, cc = c0 + c;
          float v = 0.0f;
          if (dr >= 0 && dr < D && t >= 0 && t < T && cc < O)
            v = __ldg(gout + ((bd + rr - 1) * T + t) * (long)O + cc);
          gs[rr][j][c] = v;
        }
        stage_weights<kBM, kBN>(ws, w2f, c0, 0, O, M);
        __syncthreads();
        fma_chunk<kBM, kBN>(gs, ws, acc, tx, ty);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int p = ty * kTM + i, t = t0 + p;
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          const int m = tx * kTN + j;
          dxs[p * kLd + m] =
              (t < T && m < M) ? acc[i][j] + __ldg(gxf + (bd * T + t) * (long)M + m) : 0.0f;
        }
      }
      // b. the tap tile (the conv staging is free after the last sync)
      for (int e = tid; e < kTile; e += kThreads) {
        const int p = e / kLd, c = e % kLd, t = t0 + p;
        taps[e] = (t < T && c < Cs) ? __ldg(tap + (bd * T + t) * (long)Cs + c) : 0.0f;
      }
      __syncthreads();
      // c. z and dp: warp w takes pixels w, w + 8, ...; per pixel the lane
      //    sums (dxf . xhat, dxf . y, logit 0, logit 1), all reduced together
      if (fuse) {
        float part[kPixPerWarp][4];
#pragma unroll
        for (int i = 0; i < kPixPerWarp; ++i) {
          const int p = warp + i * kWarps;
          const float* tp = taps + p * kLd;
          const float* dp_ = dxs + p * kLd;
          const float* yp = ys + p * kLd;
          float s0 = 0.0f, s1 = 0.0f, l0 = 0.0f, l1 = 0.0f;
          for (int m = lane; m < M; m += 32) {
            float xh = __ldg(bvec + m);
            for (int c = 0; c < Cs; ++c) xh = fmaf(tp[c], w1s[c * kLd + m], xh);
            const float dx = dp_[m], y = yp[m];
            s0 = fmaf(dx, xh, s0);
            s1 = fmaf(dx, y, s1);
            l0 = fmaf(y, __ldg(wy + 2 * m), l0);
            l1 = fmaf(y, __ldg(wy + 2 * m + 1), l1);
          }
          for (int c = lane; c < Cs; c += 32) {
            l0 = fmaf(tp[c], __ldg(wxt + 2 * c), l0);
            l1 = fmaf(tp[c], __ldg(wxt + 2 * c + 1), l1);
          }
          part[i][0] = s0;
          part[i][1] = s1;
          part[i][2] = l0;
          part[i][3] = l1;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
#pragma unroll
          for (int i = 0; i < kPixPerWarp; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              part[i][q] += __shfl_xor_sync(0xffffffffu, part[i][q], off);
        if (lane < kPixPerWarp) {  // lane i writes pixel warp + 8 i
          float s0 = 0.0f, s1 = 0.0f, l0 = 0.0f, l1 = 0.0f;
#pragma unroll
          for (int i = 0; i < kPixPerWarp; ++i)
            if (lane == i) s0 = part[i][0], s1 = part[i][1], l0 = part[i][2], l1 = part[i][3];
          const float z0 = sigmoid_f32(l0 + __ldg(zoff)), z1 = sigmoid_f32(l1 + __ldg(zoff + 1));
          float* q = zdp + 4 * (warp + lane * kWarps);
          q[0] = z0;
          q[1] = z1;
          q[2] = z0 * (1.0f - z0) * s0;
          q[3] = z1 * (1.0f - z1) * s1;
        }
      } else if (lane < kPixPerWarp) {
        float* q = zdp + 4 * (warp + lane * kWarps);
        q[0] = 1.0f;
        q[1] = q[2] = q[3] = 0.0f;
      }
      __syncthreads();
      // d. g_y into its sum, g_xhat over dxf
      for (int e = tid; e < kTile; e += kThreads) {
        const int p = e / kLd, m = e % kLd;
        if (m >= M) continue;  // dxs stays 0 there
        const float* q = zdp + 4 * p;
        const float dx = dxs[e];
        if (fuse)
          gys[e] += fmaf(q[3], __ldg(wy + 2 * m + 1), fmaf(q[2], __ldg(wy + 2 * m), dx * q[1]));
        dxs[e] = dx * q[0];
      }
      __syncthreads();
      // e. g_tap[p = hi + 16 i, c = lo + 16 j]
      {
        float ga[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) ga[i][j] = 0.0f;
        for (int m = 0; m < M; m += 4) {
          float4 gx[4], wv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            gx[i] = *reinterpret_cast<const float4*>(dxs + (hi + 16 * i) * kLd + m);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wv[j] = *reinterpret_cast<const float4*>(w1s + (lo + 16 * j) * kLd + m);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              ga[i][j] = fmaf(gx[i].x, wv[j].x, ga[i][j]);
              ga[i][j] = fmaf(gx[i].y, wv[j].y, ga[i][j]);
              ga[i][j] = fmaf(gx[i].z, wv[j].z, ga[i][j]);
              ga[i][j] = fmaf(gx[i].w, wv[j].w, ga[i][j]);
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = hi + 16 * i, t = t0 + p;
          if (t >= T) continue;
          const float dp0 = zdp[4 * p + 2], dp1 = zdp[4 * p + 3];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = lo + 16 * j;
            if (c >= Cs) continue;
            float v = ga[i][j];
            if (fuse) v = fmaf(dp1, __ldg(wxt + 2 * c + 1), fmaf(dp0, __ldg(wxt + 2 * c), v));
            gtap[(bd * T + t) * (long)Cs + c] = v;
          }
        }
      }
      // dw1a[c, m] += tap[p, c] g_xhat[p, m] over the tile's pixels
      for (int p = 0; p < kBM; ++p) {
        const float4 g4 = *reinterpret_cast<const float4*>(dxs + p * kLd + 4 * lo);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = taps[p * kLd + hi + 16 * i];
          aw[i][0] = fmaf(a, g4.x, aw[i][0]);
          aw[i][1] = fmaf(a, g4.y, aw[i][1]);
          aw[i][2] = fmaf(a, g4.z, aw[i][2]);
          aw[i][3] = fmaf(a, g4.w, aw[i][3]);
        }
      }
      // the small gradients: [dbvec M | dwxt 2Cs | dwy 2M | dzoff 2]
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int e = tid + s * kThreads;
        if (e >= n_small) continue;
        float v = as[s];
        if (e < M) {
#pragma unroll 8
          for (int p = 0; p < kBM; ++p) v += dxs[p * kLd + e];
        } else if (e < M + 2 * Cs) {
          const int c = (e - M) >> 1, jj = (e - M) & 1;
#pragma unroll 8
          for (int p = 0; p < kBM; ++p) v = fmaf(taps[p * kLd + c], zdp[4 * p + 2 + jj], v);
        } else if (e < 3 * M + 2 * Cs) {
          const int m = (e - M - 2 * Cs) >> 1, jj = (e - M - 2 * Cs) & 1;
#pragma unroll 8
          for (int p = 0; p < kBM; ++p) v = fmaf(ys[p * kLd + m], zdp[4 * p + 2 + jj], v);
        } else {
          const int jj = e - 3 * M - 2 * Cs;
#pragma unroll 8
          for (int p = 0; p < kBM; ++p) v += zdp[4 * p + 2 + jj];
        }
        as[s] = v;
      }
      __syncthreads();  // taps, dxs and zdp are rewritten by the next row
    }
    if (fuse) {
      for (int e = tid; e < kTile; e += kThreads) {
        const int p = e / kLd, m = e % kLd, t = t0 + p;
        if (t < T && m < M) gres[(br * T + t) * (long)M + m] = gys[e];
      }
    }
    __syncthreads();  // ys and gys are rewritten by the next item
  }

  const int n = Cs * M + n_small;
  float* dst = partial + (size_t)blockIdx.x * n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = hi + 16 * i;
    if (c >= Cs) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = 4 * lo + j;
      if (m < M) dst[c * M + m] = aw[i][j];
    }
  }
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int e = tid + s * kThreads;
    if (e < n_small) dst[Cs * M + e] = as[s];
  }
}

long work_items(int B, int Dp, int T) { return (long)B * Dp * ((T + kBM - 1) / kBM); }

}  // namespace

extern "C" int abf_block_bwd_blocks(int B, int Dp, int T) {
  if (B < 1 || Dp < 1 || T < 1) return 1;
  const long items = work_items(B, Dp, T);
  return (int)(items < kBlocks ? items : kBlocks);
}

extern "C" int abf_block_bwd_wgrad_chunks(int M, int O, int BD) { return wgrad_chunks(M, O, BD); }

extern "C" int abf_block_bwd(const void* tap, const void* res, const void* w1a, const void* bvec,
                             const void* wxt, const void* wy, const void* zoff, const void* w2f,
                             const void* xf, const void* gxf, const void* gout, void* gtap,
                             void* gres, void* grads, void* partial, void* dw2, void* wscratch,
                             int B, int D, int Dp, int T, int Cs, int M, int O, int blocks,
                             int chunks, void* stream) {
  const bool fuse = res != nullptr;
  if (B < 1 || D < 1 || Dp < 1 || D % Dp || (!fuse && Dp != D) || T < 1 || Cs < 1 ||
      Cs > kMaxCs || M < 1 || M > kMaxM || O < 1 || blocks < 1 ||
      (fuse && (!wxt || !wy || !zoff || !gres)))
    return (int)cudaErrorInvalidValue;
  const long items = work_items(B, Dp, T);
  if (blocks > items) return (int)cudaErrorInvalidValue;
  const long per_block = (items + blocks - 1) / blocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(abf_block_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  abf_block_bwd_kernel<<<blocks, kThreads, kSmemBytes, s>>>(
      static_cast<const float*>(tap), static_cast<const float*>(res),
      static_cast<const float*>(w1a), static_cast<const float*>(bvec),
      static_cast<const float*>(wxt), static_cast<const float*>(wy),
      static_cast<const float*>(zoff), static_cast<const float*>(w2f),
      static_cast<const float*>(gxf), static_cast<const float*>(gout), static_cast<float*>(gtap),
      static_cast<float*>(gres), static_cast<float*>(partial), items, per_block, D, D / Dp, T,
      Cs, M, O);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = reduce_partials(static_cast<const float*>(partial), static_cast<float*>(grads), blocks,
                        (long)Cs * M + 3 * M + 2 * Cs + 2, s);
  if (err != cudaSuccess) return (int)err;
  return (int)wgrad_run(static_cast<const float*>(xf), static_cast<const float*>(gout),
                        static_cast<float*>(dw2), static_cast<float*>(wscratch), B, D, T, M, O,
                        chunks, s);
}
