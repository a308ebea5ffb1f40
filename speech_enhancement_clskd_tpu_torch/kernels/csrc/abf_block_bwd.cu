// The whole ABF block, backward, for Hopper (sm_90a): the conv adjoint, one
// pass over the pixels for every other gradient of the block, the small
// gradients' partials added in a fixed order, and the conv weight gradient.
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
// with xhat and z recomputed from tap and res.
//
// What bounds it on this card.  Two 3x3 convs' worth of operations (the
// adjoint and dw2, 2 * B*D*T * 9M * O each, as three TF32 tensor-core
// products each where O > 8) plus 6 * Cs * M a pixel for the 1x1 conv's
// products, against reading tap, res, xf, g_xf and g_out and writing g_tap
// and g_res once: the operations at every block but the mask block (O = 2),
// where the bytes do.
//
// Design.  The adjoint takes one of two routes by shape alone
// (abf_block_bwd_route: K3f's test with O input and M output channels, O >= 4
// and M >= 8 take "mma"):
//   1. route "mma": the adjoint on K3f's split-TF32 tensor-core tile
//      (conv3x3_mma.cuh, weights split once a call, a fresh accumulator per
//      8-channel chunk against the tensor cores' truncating adds), with g_xf
//      added in its epilogue, writes dxf once to a scratch [B, D, T, M]: a
//      map's worth of bytes each way, where the first design ran the adjoint
//      in the f32 FMA tile inside the pass at 3-7x the tile's time.
//   2. abf_block_bwd_pass_kernel: a work item is one residual row (b, r) and
//      kBM time steps; a fixed number of blocks (kBlocks, two an SM, fewer
//      for small maps) each take a fixed contiguous range of items and walk
//      them in order.  Thread (hi, lo) of 256 owns pixels hi + 16 i and mid
//      channels 4 lo + j (i, j < 4) of the item's tile; its y and its sum of
//      g_y over the k rows stay in shared memory it alone touches.  Per freq
//      row d, three barriers:
//        a. the tap tile into shared memory (one contiguous run, float4s,
//           zeros past T and up to a whole quad of channels), and the
//           thread's dxf from the scratch; on route "direct" (the mask
//           block, O = 2, or M < 8) dxf is formed here instead from the g_out
//           halo of 3 rows x (kBM + 2) steps x kOCh channels and w2f's slices
//           staged, 9 x O FMAs a dxf element, plus g_xf;
//        b. xhat (4 x 4 a thread: float4s of the tap tile against float4s of
//           w1a; none without a residual), the thread's parts of dxf . xhat,
//           dxf . y and the two logits, added over the 16 lanes of a pixel by
//           xor shuffles; z (the SFU's exp and reciprocal), dp; g_xhat into
//           shared memory, g_y into the thread's sum, and the small sums
//           (dbvec, dwxt, dwy, dzoff) in registers;
//        c. g_tap on 4 pixels x 4 tap channels a thread over a part of the
//           mid channels: below 64 tap channels the mid channels are split
//           16 / (tap quads) ways so that every thread works, the parts added
//           by xor shuffles; written;
//        d. dw1a on 4 tap channels x 4 mid channels a thread over a part of
//           the tile's pixels (split the same way), added to the thread's
//           float4s in shared memory (registers only while it adds).
//      After its k rows the item writes g_res once: no two blocks write the
//      same g_res, nothing is added atomically.  At the end each block adds
//      its dw1a parts and its threads' small sums in a fixed order and writes
//      one partial [dw1a | dbvec | dwxt | dwy | dzoff].
//   3. reduce_partials_kernel adds the blocks' partials in block order.
//   4. dw2: K3w's split reduction (conv3x3_tiles.cuh::wgrad_run, on K3w's
//      route by shape: split TF32 on the tensor cores for O > 8) over xf and
//      g_out, not K3w's wrapper, so K3w's launch count stays at 0 on this path.
// The 1x1 conv's products and the blend are f32 FMA.  Every split depends
// only on the shape, so every run gives the same bits.  Offsets are 64-bit.
//
// The bf16 instantiation (abf_block_bwd_bf16) takes the maps and w1a, wxt, wy,
// w2f in bf16 (bvec, zoff float32) and writes g_tap and g_res in bf16, the
// parameter gradients in float32.  It rounds where the Pallas body rounds on
// bf16 operands (abf_block.py:255-343): dxf is the float32 adjoint plus g_xf;
// xhat is recomputed and not rounded; z, dp, g_xhat and g_y are float32;
// g_tap's product and dw1a take g_xhat rounded to bf16, dwxt and dwy dp
// rounded to bf16; dbvec and dzoff sum them unrounded.  The adjoint runs on
// the bf16 K3f's tile (conv3x3_bf16.cuh, route "mma" for O >= 8 and M >= 8)
// with g_xf added in its epilogue into the float32 dxf scratch, or in the
// pass ("direct"); the pass loads bf16 and computes in float32 in the same
// order as the float32 pass; dw2 runs on the bf16 K3w's routes from the bf16
// xf and g_out, its chunks' partials added in chunk order.  Bound at the
// reference block: the bytes, ~570 MB (0.170 ms).  The block-config step's
// shapes take route "fused" of abf_block_bf16.cu instead (no dxf scratch);
// this instantiation keeps the other bf16 shapes (M off a multiple of 8, Cs
// off one above 4, odd k > 1, maps off 16 bytes).
//
// Interface: plain C, bound with ctypes.  res == NULL means no fuse (wxt, wy,
// zoff, g_res are then not touched, and the dwxt/dwy/dzoff slots come out 0).
// abf_block_bwd_blocks(B, Dp, T) gives the pass's block count (pass Dp = D
// without a residual), abf_block_bwd_wgrad_chunks(M, O, B*D) the dw2 pass's
// chunks, abf_block_bwd_route(M, O) the adjoint's route (0 direct, 1 mma) and
// abf_block_bwd_split_floats(M, O) its split weights' floats; the caller
// allocates g_tap, g_res, grads [Cs*M + 3M + 2Cs + 2], dw2 [3, 3, M, O], the
// partials (blocks x the grads' length), the dw2 scratch (chunks * 9 * M * O)
// and, on route "mma", dxf [B, D, T, M] and the split weights (16-byte
// aligned).  The return value is cudaGetLastError() after each launch.  The
// bf16 entries: abf_block_bwd_bf16 (the same arguments; the packed weights of
// abf_block_bwd_bf16_pack_elems(M, O) bf16 in the split weights' place) and
// abf_block_bwd_bf16_route(M, O).

#include <cuda_runtime.h>

#include "bf16_io.cuh"
#include "conv3x3_bf16.cuh"
#include "conv3x3_mma.cuh"
#include "conv3x3_tiles.cuh"

namespace {

constexpr int kBM = 64;        // time steps of a work item
constexpr int kMaxCs = 64;
constexpr int kMaxM = 64;
constexpr int kLd = 68;        // row stride of the [kBM][64] tiles (float4-aligned)
constexpr int kThreads = 256;  // 16 (pixels) x 16 (channel quads)
constexpr int kBlocks = 264;   // two a streaming multiprocessor on an H100
constexpr int kOCh = 2;        // g_out channels a stage of the direct adjoint (the mask block's O)
// shared memory, in floats
constexpr int kTile = kBM * kLd;             // 4352
constexpr int kW1 = 0;                       // w1a [kMaxCs][kLd], zeros past Cs, M
constexpr int kTaps = kW1 + kMaxCs * kLd;    // tap tile [kBM][kLd]
constexpr int kGx = kTaps + kTile;           // g_xhat tile
constexpr int kYs = kGx + kTile;             // y tile (thread-owned)
constexpr int kGys = kYs + kTile;            // the g_y sum (thread-owned)
constexpr int kBv = kGys + kTile;            // bvec [kMaxM]
constexpr int kWx = kBv + kMaxM;             // wxt [kMaxCs][2]
constexpr int kWy = kWx + 2 * kMaxCs;        // wy [kMaxM][2]
constexpr int kZdp = kWy + 2 * kMaxM;        // dp [kBM][2]
constexpr int kAw = kZdp + 2 * kBM;          // dw1a sums [4][kThreads] float4s (thread-owned)
constexpr int kGs = kAw + 16 * kThreads;     // direct: g_out halo [3][kBM + 2][kOCh]
constexpr int kWs = kGs + 3 * (kBM + 2) * kOCh;  // direct: w2f [9][kOCh][kMaxM]
constexpr int kSmemDirect = (kWs + 9 * kOCh * kMaxM) * 4;  // 111,408
constexpr int kSmemMma = kGs * 4;                          // 105,216

// the logistic through the SFU's exp2 and reciprocal (a few ulp; every lane
// of a pixel row computes its 4 pixels' gates, so this sits on the pass's path)
__device__ __forceinline__ float sigmoid_f32(float x) { return __fdividef(1.0f, 1.0f + __expf(-x)); }

using bf16_io::bf16;
using bf16_io::ld1;
using bf16_io::ld4;
using bf16_io::round_to;
using bf16_io::st1;
using bf16_io::st4;

// p[m0 .. m0 + 3] as floats, zeros at and past M (VEC: one 4-wide load; p +
// m0 aligned to 4 elements)
template <class E>
__device__ __forceinline__ float4 load4(const E* p, int m0, int M, bool vec) {
  if (m0 >= M) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (vec) return ld4(p + m0);
  return make_float4(ld1(p + m0), m0 + 1 < M ? ld1(p + m0 + 1) : 0.0f,
                     m0 + 2 < M ? ld1(p + m0 + 2) : 0.0f, m0 + 3 < M ? ld1(p + m0 + 3) : 0.0f);
}

template <class E>
__device__ __forceinline__ void store4(E* p, int m0, int M, bool vec, float4 v) {
  if (m0 >= M) return;
  if (vec) {
    st4(p + m0, v);
    return;
  }
  st1(p + m0, v.x);
  if (m0 + 1 < M) st1(p + m0 + 1, v.y);
  if (m0 + 2 < M) st1(p + m0 + 2, v.z);
  if (m0 + 3 < M) st1(p + m0 + 3, v.w);
}

// E: the maps' and the weights' element type (bvec, zoff, dxf and the
// partials are float32 either way)
template <class E>
struct Args {
  const E* tap;
  const E* res;
  const E* w1a;
  const float* bvec;
  const E* wxt;
  const E* wy;
  const float* zoff;
  const E* w2f;
  const E* gxf;
  const E* gout;
  const float* dxf;  // route "mma": the adjoint with g_xf added
  E* gtap;
  E* gres;
  float* partial;
  long items, items_per_block;
  int D, k, T, Cs, M, O;
};

// ws[k][o][m] = w2f[k, o0 + o, m] (zeros past O and M)
template <class E>
__device__ __forceinline__ void stage_w2f(float* ws, const Args<E>& a, int o0) {
  for (int e = threadIdx.x; e < 9 * kOCh * kMaxM; e += kThreads) {
    const int m = e % kMaxM, o = (e / kMaxM) % kOCh, kk = e / (kMaxM * kOCh);
    ws[e] = (o0 + o < a.O && m < a.M) ? ld1(a.w2f + ((long)kk * a.O + o0 + o) * a.M + m) : 0.0f;
  }
}

// E = bf16: the Pallas body's roundings on bf16 operands.  xhat, z, dp,
// g_xhat and g_y are float32 (xhat is not rounded here, where the forward
// rounds it); g_tap's product and dw1a take g_xhat rounded to bf16, dwxt and
// dwy dp rounded to bf16; dbvec and dzoff sum them unrounded; g_tap and g_res
// are stored rounded to bf16.
template <bool DIRECT, class E>
__global__ void __launch_bounds__(kThreads, 2) abf_block_bwd_pass_kernel(Args<E> a) {
  extern __shared__ __align__(16) float smem[];
  float* w1s = smem + kW1;
  float* taps = smem + kTaps;
  float* gxs = smem + kGx;
  float* ys = smem + kYs;
  float* gys = smem + kGys;
  const float* bvs = smem + kBv;
  const float* wxs = smem + kWx;
  const float* wys = smem + kWy;
  float* zdp = smem + kZdp;
  float* gs = smem + kGs;
  float* ws = smem + kWs;

  const bool fuse = a.res != nullptr;
  const int D = a.D, k = a.k, T = a.T, Cs = a.Cs, M = a.M, O = a.O;
  const int Dp = D / k;
  const int t_tiles = (T + kBM - 1) / kBM;
  const int tid = threadIdx.x;
  const int lo = tid % 16, hi = tid / 16;
  const int m0 = 4 * lo;
  const bool vec_m = M % 4 == 0, vec_c = Cs % 4 == 0;
  const int mq4 = (M + 3) / 4;   // quads of mid channels
  const int cq4 = (Cs + 3) / 4;  // quads of tap channels (the tap tile is zero past Cs)
  // The 1x1 conv's products on 4 x 4 register tiles with float4 operands.
  // ncq: cq4 rounded up to a power of two; nsp = 16 / ncq ways to split the
  // rest of the work, so that every thread works at any tap width:
  //   g_tap: thread (pixel quad pq, channel quad cq, part sp) over mid quads
  //          sp, sp + nsp, ...; the nsp parts added by xor shuffles;
  //   dw1a:  thread (pixel part sp, channel quad cq, mid quad lo) over pixels
  //          sp, sp + nsp, ...; the parts added in order at the end.
  int ncq = 1;
  while (ncq < cq4) ncq *= 2;
  const int nsp = 16 / ncq;
  const int sp_g = tid % nsp, cq_g = (tid / nsp) % ncq, pq_g = tid / 16;
  const int cq_w = hi % ncq, sp_w = hi / ncq;

  for (int e = tid; e < kMaxCs * kLd; e += kThreads) {
    const int c = e / kLd, m = e % kLd;
    w1s[e] = (c < Cs && m < M) ? ld1(a.w1a + (long)c * M + m) : 0.0f;
  }
  for (int e = tid; e < kMaxM; e += kThreads) smem[kBv + e] = e < M ? __ldg(a.bvec + e) : 0.0f;
  for (int e = tid; e < 2 * kMaxCs; e += kThreads)
    smem[kWx + e] = (fuse && e < 2 * Cs) ? ld1(a.wxt + e) : 0.0f;
  for (int e = tid; e < 2 * kMaxM; e += kThreads)
    smem[kWy + e] = (fuse && e < 2 * M) ? ld1(a.wy + e) : 0.0f;
  if (DIRECT && O <= kOCh) stage_w2f(ws, a, 0);  // one stage holds all of w2f
  __syncthreads();
  const float zo0 = fuse ? __ldg(a.zoff) : 0.0f, zo1 = fuse ? __ldg(a.zoff + 1) : 0.0f;

  // dw1a[4 cq_w + e][m0 + j] over pixels sp_w (mod nsp): the thread's own
  // float4s of shared memory, in registers only while step d adds to them
  float4* aws = reinterpret_cast<float4*>(smem + kAw) + tid;
#pragma unroll
  for (int e = 0; e < 4; ++e) aws[e * kThreads] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float sb[4];     // dbvec[m0 + j]
  float sy[4][2];  // dwy[m0 + j][jj]
  float sx[4][2];  // dwxt[lo + 16 cc][jj]
  float sz[2];     // dzoff[jj] (the same in every lane of a pixel row)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    sb[i] = 0.0f;
    sy[i][0] = sy[i][1] = sx[i][0] = sx[i][1] = 0.0f;
  }
  sz[0] = sz[1] = 0.0f;

  const long begin = (long)blockIdx.x * a.items_per_block;
  const long end = begin + a.items_per_block < a.items ? begin + a.items_per_block : a.items;
  for (long item = begin; item < end; ++item) {
    const long br = item / t_tiles;  // b * Dp + r
    const int t0 = (int)(item - br * t_tiles) * kBM;
    const long b = br / Dp;
    const int r = (int)(br - b * Dp);
    // the thread's y and g_y sum
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = hi + 16 * i, t = t0 + p;
      const float4 y = (fuse && t < T) ? load4(a.res + (br * T + t) * (long)M, m0, M, vec_m)
                                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      *reinterpret_cast<float4*>(ys + p * kLd + m0) = y;
      *reinterpret_cast<float4*>(gys + p * kLd + m0) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    for (int kk = 0; kk < k; ++kk) {
      const int d = r * k + kk;
      const long bd = b * D + d;
      // a. the tap tile, one contiguous run (zeros past T and past Cs up to a
      //    whole quad), and the thread's dxf
      {
        const long tbase = (bd * T + t0) * (long)Cs;
        const int n = (T - t0 < kBM ? T - t0 : kBM) * Cs;  // floats in the map
        if (vec_c) {
          for (int e = tid; e < kBM * Cs / 4; e += kThreads) {
            const int p = 4 * e / Cs, c = 4 * e - p * Cs;
            *reinterpret_cast<float4*>(taps + p * kLd + c) =
                4 * e < n ? ld4(a.tap + tbase + 4 * e) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          }
        } else {
          for (int e = tid; e < kBM * 4 * cq4; e += kThreads) {
            const int p = e / (4 * cq4), c = e - p * 4 * cq4, f = p * Cs + c;
            taps[p * kLd + c] = (c < Cs && f < n) ? ld1(a.tap + tbase + f) : 0.0f;
          }
        }
      }
      float dx[4][4];  // the thread's dxf
      if constexpr (DIRECT) {
        // dxf = g_xf + conv3x3(g_out, w2f) for the thread's pixels and channels
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dx[i][j] = 0.0f;
        for (int o0 = 0; o0 < O; o0 += kOCh) {
          if (o0 > 0) __syncthreads();  // the previous stage is read
          for (int e = tid; e < 3 * (kBM + 2) * kOCh; e += kThreads) {
            const int o = e % kOCh, j = (e / kOCh) % (kBM + 2), rr = e / (kOCh * (kBM + 2));
            const int dr = d + rr - 1, t = t0 + j - 1, oc = o0 + o;
            gs[e] = (dr >= 0 && dr < D && t >= 0 && t < T && oc < O)
                        ? ld1(a.gout + ((bd + rr - 1) * T + t) * (long)O + oc)
                        : 0.0f;
          }
          if (O > kOCh) stage_w2f(ws, a, o0);
          __syncthreads();
          const int on = O - o0 < kOCh ? O - o0 : kOCh;
          for (int rs = 0; rs < 9; ++rs) {
            const int rr = rs / 3, s = rs - 3 * rr;
            const float* gr = gs + (rr * (kBM + 2) + hi + s) * kOCh;
            for (int o = 0; o < on; ++o) {
              const float4 w = *reinterpret_cast<const float4*>(ws + (rs * kOCh + o) * kMaxM + m0);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float g = gr[16 * i * kOCh + o];
                dx[i][0] = fmaf(g, w.x, dx[i][0]);
                dx[i][1] = fmaf(g, w.y, dx[i][1]);
                dx[i][2] = fmaf(g, w.z, dx[i][2]);
                dx[i][3] = fmaf(g, w.w, dx[i][3]);
              }
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + hi + 16 * i;
          const float4 g = t < T ? load4(a.gxf + (bd * T + t) * (long)M, m0, M, vec_m)
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          const bool in = t < T;
          dx[i][0] = in && m0 < M ? g.x + dx[i][0] : 0.0f;
          dx[i][1] = in && m0 + 1 < M ? g.y + dx[i][1] : 0.0f;
          dx[i][2] = in && m0 + 2 < M ? g.z + dx[i][2] : 0.0f;
          dx[i][3] = in && m0 + 3 < M ? g.w + dx[i][3] : 0.0f;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + hi + 16 * i;
          const float4 g = t < T ? load4(a.dxf + (bd * T + t) * (long)M, m0, M, vec_m)
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          dx[i][0] = g.x, dx[i][1] = g.y, dx[i][2] = g.z, dx[i][3] = g.w;
        }
      }
      __syncthreads();  // the tap tile
      // b. xhat (4 pixels x 4 mid channels, tap quads against w1a quads), the
      //    per-pixel sums, z and dp; g_xhat, g_y and the small sums
      float dp0[4], dp1[4];
      {
        float xh[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) xh[i][j] = bvs[m0 + j];
        for (int cq = 0; fuse && cq < cq4; ++cq) {
          float4 tq[4], wq[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            tq[i] = *reinterpret_cast<const float4*>(taps + (hi + 16 * i) * kLd + 4 * cq);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            wq[e] = *reinterpret_cast<const float4*>(w1s + (4 * cq + e) * kLd + m0);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float tv[4] = {tq[i].x, tq[i].y, tq[i].z, tq[i].w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              xh[i][0] = fmaf(tv[e], wq[e].x, xh[i][0]);
              xh[i][1] = fmaf(tv[e], wq[e].y, xh[i][1]);
              xh[i][2] = fmaf(tv[e], wq[e].z, xh[i][2]);
              xh[i][3] = fmaf(tv[e], wq[e].w, xh[i][3]);
            }
          }
        }
        float part[4][4];  // [pixel i][dxf . xhat, dxf . y, logit 0, logit 1]
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = hi + 16 * i;
          if (!fuse) break;  // no residual: z and dp stay (1, 0) and (0, 0)
          const float4 y4 = *reinterpret_cast<const float4*>(ys + p * kLd + m0);
          const float y[4] = {y4.x, y4.y, y4.z, y4.w};
          float s0 = 0.0f, s1 = 0.0f, l0 = 0.0f, l1 = 0.0f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s0 = fmaf(dx[i][j], xh[i][j], s0);
            s1 = fmaf(dx[i][j], y[j], s1);
            l0 = fmaf(y[j], wys[2 * (m0 + j)], l0);
            l1 = fmaf(y[j], wys[2 * (m0 + j) + 1], l1);
          }
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const int c = lo + 16 * cc;
            if (c < Cs) {
              const float x = taps[p * kLd + c];
              l0 = fmaf(x, wxs[2 * c], l0);
              l1 = fmaf(x, wxs[2 * c + 1], l1);
            }
          }
          part[i][0] = s0, part[i][1] = s1, part[i][2] = l0, part[i][3] = l1;
        }
        if (fuse) {  // over the 16 lanes of a pixel
#pragma unroll
          for (int off = 1; off < 16; off <<= 1)
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int v = 0; v < 4; ++v)
                part[i][v] += __shfl_xor_sync(0xffffffffu, part[i][v], off);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = hi + 16 * i;
          float z0 = 1.0f, z1 = 0.0f;
          dp0[i] = dp1[i] = 0.0f;
          if (fuse) {
            z0 = sigmoid_f32(part[i][2] + zo0);
            z1 = sigmoid_f32(part[i][3] + zo1);
            dp0[i] = z0 * (1.0f - z0) * part[i][0];
            dp1[i] = z1 * (1.0f - z1) * part[i][1];
          }
          if (lo == 0) zdp[2 * p] = dp0[i], zdp[2 * p + 1] = dp1[i];
          const float4 y4 = *reinterpret_cast<const float4*>(ys + p * kLd + m0);
          const float y[4] = {y4.x, y4.y, y4.z, y4.w};
          float gx[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float v = dx[i][j] * z0;
            sb[j] += v;
            gx[j] = round_to<E>(v);
          }
          *reinterpret_cast<float4*>(gxs + p * kLd + m0) = make_float4(gx[0], gx[1], gx[2], gx[3]);
          if (fuse) {
            const float dr0 = round_to<E>(dp0[i]), dr1 = round_to<E>(dp1[i]);
            const float4 gy4 = *reinterpret_cast<const float4*>(gys + p * kLd + m0);
            float gy[4] = {gy4.x, gy4.y, gy4.z, gy4.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              gy[j] += fmaf(dp1[i], wys[2 * (m0 + j) + 1], fmaf(dp0[i], wys[2 * (m0 + j)], dx[i][j] * z1));
              sy[j][0] = fmaf(y[j], dr0, sy[j][0]);
              sy[j][1] = fmaf(y[j], dr1, sy[j][1]);
            }
            *reinterpret_cast<float4*>(gys + p * kLd + m0) = make_float4(gy[0], gy[1], gy[2], gy[3]);
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
              const int c = lo + 16 * cc;
              const float x = c < Cs ? taps[p * kLd + c] : 0.0f;
              sx[cc][0] = fmaf(x, dr0, sx[cc][0]);
              sx[cc][1] = fmaf(x, dr1, sx[cc][1]);
            }
            sz[0] += dp0[i];
            sz[1] += dp1[i];
          }
        }
      }
      __syncthreads();  // g_xhat and dp
      // c. g_tap[4 pq_g + i][4 cq_g + e]: this part's mid quads, then the nsp
      //    parts added by xor shuffles (adjacent lanes; every lane shuffles, a
      //    quad past the tap's channels with nothing to add)
      {
        float ga[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) ga[i][e] = 0.0f;
        for (int mq = sp_g; cq_g < cq4 && mq < mq4; mq += nsp) {
          float4 gx[4], wv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            gx[i] = *reinterpret_cast<const float4*>(gxs + (4 * pq_g + i) * kLd + 4 * mq);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            wv[e] = *reinterpret_cast<const float4*>(w1s + (4 * cq_g + e) * kLd + 4 * mq);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              ga[i][e] = fmaf(gx[i].x, wv[e].x, ga[i][e]);
              ga[i][e] = fmaf(gx[i].y, wv[e].y, ga[i][e]);
              ga[i][e] = fmaf(gx[i].z, wv[e].z, ga[i][e]);
              ga[i][e] = fmaf(gx[i].w, wv[e].w, ga[i][e]);
            }
        }
        for (int off = 1; off < nsp; off <<= 1)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) ga[i][e] += __shfl_xor_sync(0xffffffffu, ga[i][e], off);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = 4 * pq_g + i, t = t0 + p;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 4 * cq_g + e;
            if ((4 * i + e) % nsp != sp_g || t >= T || c >= Cs) continue;
            float v = ga[i][e];
            if (fuse) v = fmaf(zdp[2 * p + 1], wxs[2 * c + 1], fmaf(zdp[2 * p], wxs[2 * c], v));
            st1(a.gtap + (bd * T + t) * (long)Cs + c, v);
          }
        }
      }
      // d. dw1a[4 cq_w + e][m0 + j] over pixels sp_w, sp_w + nsp, ...
      if (cq_w < cq4) {
        float aw[4][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 v = aws[e * kThreads];
          aw[e][0] = v.x, aw[e][1] = v.y, aw[e][2] = v.z, aw[e][3] = v.w;
        }
        for (int p = sp_w; p < kBM; p += nsp) {
          const float4 g4 = *reinterpret_cast<const float4*>(gxs + p * kLd + m0);
          const float4 t4 = *reinterpret_cast<const float4*>(taps + p * kLd + 4 * cq_w);
          const float tv[4] = {t4.x, t4.y, t4.z, t4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            aw[e][0] = fmaf(tv[e], g4.x, aw[e][0]);
            aw[e][1] = fmaf(tv[e], g4.y, aw[e][1]);
            aw[e][2] = fmaf(tv[e], g4.z, aw[e][2]);
            aw[e][3] = fmaf(tv[e], g4.w, aw[e][3]);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) aws[e * kThreads] = make_float4(aw[e][0], aw[e][1], aw[e][2], aw[e][3]);
      }
      __syncthreads();  // the next row restages taps, g_xhat and dp
    }
    if (fuse) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = hi + 16 * i, t = t0 + p;
        if (t < T)
          store4(a.gres + (br * T + t) * (long)M, m0, M, vec_m,
                 *reinterpret_cast<const float4*>(gys + p * kLd + m0));
      }
    }
  }

  // the block's partial: dw1a added over the nsp pixel parts in order, and
  // the small sums over the 16 pixel rows hi in order, through shared memory
  // (the tiles are free)
  const int n_small = 3 * M + 2 * Cs + 2;
  const int n = Cs * M + n_small;
  float* dst = a.partial + (size_t)blockIdx.x * n;
  float* red = smem + kTaps;  // over the tap and g_xhat tiles
  // [nsp][4 ncq][kMaxM] floats: 16 / ncq * 4 ncq * 64 = 4096
#pragma unroll
  for (int e = 0; e < 4; ++e)
    *reinterpret_cast<float4*>(red + ((sp_w * ncq + cq_w) * 4 + e) * kMaxM + m0) = aws[e * kThreads];
  __syncthreads();
  for (int e = tid; e < Cs * M; e += kThreads) {
    const int c = e / M, m = e - c * M;
    float v = 0.0f;
    for (int h = 0; h < nsp; ++h) v += red[(h * 4 * ncq + c) * kMaxM + m];
    dst[e] = v;
  }
  __syncthreads();
  float* mine = red + hi * n_small;  // [16][n_small]
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = m0 + j;
    if (m >= M) continue;
    mine[m] = sb[j];
    mine[M + 2 * Cs + 2 * m] = sy[j][0];
    mine[M + 2 * Cs + 2 * m + 1] = sy[j][1];
  }
#pragma unroll
  for (int cc = 0; cc < 4; ++cc) {
    const int c = lo + 16 * cc;
    if (c >= Cs) continue;
    mine[M + 2 * c] = sx[cc][0];
    mine[M + 2 * c + 1] = sx[cc][1];
  }
  if (lo == 0) {
    mine[3 * M + 2 * Cs] = sz[0];
    mine[3 * M + 2 * Cs + 1] = sz[1];
  }
  __syncthreads();
  for (int e = tid; e < n_small; e += kThreads) {
    float v = 0.0f;
#pragma unroll
    for (int h = 0; h < 16; ++h) v += red[h * n_small + e];
    dst[Cs * M + e] = v;
  }
}

long work_items(int B, int Dp, int T) { return (long)B * Dp * ((T + kBM - 1) / kBM); }

template <bool DIRECT, class E>
cudaError_t launch_pass(const Args<E>& a, int blocks, cudaStream_t stream) {
  constexpr int kSmem = DIRECT ? kSmemDirect : kSmemMma;
  // above 48 KB needs the opt-in: set on every call
  const cudaError_t err = cudaFuncSetAttribute(abf_block_bwd_pass_kernel<DIRECT, E>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  abf_block_bwd_pass_kernel<DIRECT, E><<<blocks, kThreads, kSmem, stream>>>(a);
  return cudaGetLastError();
}

// the adjoint's route: K3f's test with O input and M output channels
int route_of(int M, int O) { return conv3x3_mma::fwd_route(O, M); }

}  // namespace

extern "C" int abf_block_bwd_blocks(int B, int Dp, int T) {
  if (B < 1 || Dp < 1 || T < 1) return 1;
  const long items = work_items(B, Dp, T);
  return (int)(items < kBlocks ? items : kBlocks);
}

extern "C" int abf_block_bwd_wgrad_chunks(int M, int O, int BD) {
  return conv3x3_tiles::wgrad_chunks(M, O, BD);
}

extern "C" int abf_block_bwd_route(int M, int O) { return route_of(M, O); }

extern "C" long abf_block_bwd_split_floats(int M, int O) {
  return conv3x3_mma::fwd_scratch_floats(O, M);
}

extern "C" int abf_block_bwd(const void* tap, const void* res, const void* w1a, const void* bvec,
                             const void* wxt, const void* wy, const void* zoff, const void* w2f,
                             const void* xf, const void* gxf, const void* gout, void* gtap,
                             void* gres, void* grads, void* partial, void* dw2, void* wscratch,
                             void* dxf, void* wsplit, int B, int D, int Dp, int T, int Cs, int M,
                             int O, int blocks, int chunks, void* stream) {
  const bool fuse = res != nullptr;
  const bool mma = route_of(M, O) == 1;
  if (B < 1 || D < 1 || Dp < 1 || D % Dp || (!fuse && Dp != D) || T < 1 || Cs < 1 ||
      Cs > kMaxCs || M < 1 || M > kMaxM || O < 1 || blocks < 1 ||
      (fuse && (!wxt || !wy || !zoff || !gres)) || (mma && (!dxf || !wsplit)))
    return (int)cudaErrorInvalidValue;
  const long items = work_items(B, Dp, T);
  if (blocks > items) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args<float> a{static_cast<const float*>(tap), static_cast<const float*>(res),
         static_cast<const float*>(w1a), static_cast<const float*>(bvec),
         static_cast<const float*>(wxt), static_cast<const float*>(wy),
         static_cast<const float*>(zoff), static_cast<const float*>(w2f),
         static_cast<const float*>(gxf), static_cast<const float*>(gout),
         static_cast<const float*>(dxf), static_cast<float*>(gtap), static_cast<float*>(gres),
         static_cast<float*>(partial), items, (items + blocks - 1) / blocks, D, D / Dp, T, Cs,
         M, O};
  cudaError_t err;
  if (mma) {
    err = conv3x3_mma::fwd_mma_run<true>(a.gout, a.w2f, static_cast<float4*>(wsplit), a.gxf,
                                         static_cast<float*>(dxf), B, D, T, O, M, s);
    if (err != cudaSuccess) return (int)err;
    err = launch_pass<false>(a, blocks, s);
  } else {
    err = launch_pass<true>(a, blocks, s);
  }
  if (err != cudaSuccess) return (int)err;
  err = conv3x3_tiles::reduce_partials(a.partial, static_cast<float*>(grads), blocks,
                                       (long)Cs * M + 3 * M + 2 * Cs + 2, s);
  if (err != cudaSuccess) return (int)err;
  return (int)conv3x3_tiles::wgrad_run(static_cast<const float*>(xf), a.gout,
                                       static_cast<float*>(dw2), static_cast<float*>(wscratch),
                                       B, D, T, M, O, chunks, s);
}

// The bf16 instantiation: tap, res, w1a, wxt, wy, w2f, xf, g_xf, g_out,
// g_tap and g_res in bf16; bvec, zoff, grads, the partials, dw2 and dxf
// float32.  The adjoint takes the bf16 K3f's routes (conv3x3_bf16.cuh's test
// with O input and M output channels): "mma" (O >= 8 and M >= 8) on its
// m16n8k16 tile through the packed weights' scratch of
// abf_block_bwd_bf16_pack_elems(M, O) bf16, with g_xf added in its epilogue
// into the float32 dxf; else formed in the pass (f32 FMA on the widened
// values).  dw2 runs on the bf16 K3w's code over the bf16 xf and g_out.
extern "C" int abf_block_bwd_bf16_route(int M, int O) { return conv3x3_bf16::fwd_route(O, M); }

extern "C" long abf_block_bwd_bf16_pack_elems(int M, int O) {
  return conv3x3_bf16::fwd_scratch_elems(O, M);
}

extern "C" int abf_block_bwd_bf16(const void* tap, const void* res, const void* w1a,
                                  const void* bvec, const void* wxt, const void* wy,
                                  const void* zoff, const void* w2f, const void* xf,
                                  const void* gxf, const void* gout, void* gtap, void* gres,
                                  void* grads, void* partial, void* dw2, void* wscratch, void* dxf,
                                  void* wpack, int B, int D, int Dp, int T, int Cs, int M, int O,
                                  int blocks, int chunks, void* stream) {
  const bool fuse = res != nullptr;
  const bool mma = conv3x3_bf16::fwd_route(O, M) != 0;  // "mma" or "wgmma"
  if (B < 1 || D < 1 || Dp < 1 || D % Dp || (!fuse && Dp != D) || T < 1 || Cs < 1 ||
      Cs > kMaxCs || M < 1 || M > kMaxM || O < 1 || blocks < 1 ||
      (fuse && (!wxt || !wy || !zoff || !gres)) || (mma && (!dxf || !wpack)))
    return (int)cudaErrorInvalidValue;
  const long items = work_items(B, Dp, T);
  if (blocks > items) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args<bf16> a{static_cast<const bf16*>(tap), static_cast<const bf16*>(res),
               static_cast<const bf16*>(w1a), static_cast<const float*>(bvec),
               static_cast<const bf16*>(wxt), static_cast<const bf16*>(wy),
               static_cast<const float*>(zoff), static_cast<const bf16*>(w2f),
               static_cast<const bf16*>(gxf), static_cast<const bf16*>(gout),
               static_cast<const float*>(dxf), static_cast<bf16*>(gtap), static_cast<bf16*>(gres),
               static_cast<float*>(partial), items, (items + blocks - 1) / blocks, D, D / Dp, T, Cs,
               M, O};
  cudaError_t err;
  if (mma) {
    err = conv3x3_bf16::fwd_run<true>(a.gout, a.w2f, static_cast<bf16*>(wpack), a.gxf, dxf, B, D,
                                      T, O, M, s);
    if (err != cudaSuccess) return (int)err;
    err = launch_pass<false>(a, blocks, s);
  } else {
    err = launch_pass<true>(a, blocks, s);
  }
  if (err != cudaSuccess) return (int)err;
  err = conv3x3_tiles::reduce_partials(a.partial, static_cast<float*>(grads), blocks,
                                       (long)Cs * M + 3 * M + 2 * Cs + 2, s);
  if (err != cudaSuccess) return (int)err;
  return (int)conv3x3_bf16::wgrad_run(static_cast<const bf16*>(xf), a.gout,
                                      static_cast<float*>(dw2), static_cast<float*>(wscratch), B,
                                      D, T, M, O, chunks, s);
}
