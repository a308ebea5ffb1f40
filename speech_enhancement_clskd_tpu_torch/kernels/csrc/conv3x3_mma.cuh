// The split-TF32 tensor-core tile of the bias-free 3x3 SAME convolution over
// channels-last maps (K3f's route "mma", see conv3x3_fwd.cu for its design),
// shared by conv3x3_fwd.cu (K3f), abf_block_fwd.cu (K5f's conv over xf) and
// abf_block_bwd.cu (K5b's conv adjoint over g_out, with g_xf added in the
// epilogue).  Each source includes this header and is built into its own
// library; kernels/_build.py hashes the headers with the source, so an edit
// here rebuilds every library.
//
// fwd_mma_run<ADD>() is the host side: one pass splits the weights into TF32
// parts (conv3x3_split_weights_kernel, into the caller's scratch of
// fwd_scratch_floats(C, O) floats), then conv3x3_fwd_mma_kernel writes
//     out[b, d, t, o] = (add[b, d, t, o] +) sum_{dd, tt, c}
//                       x[b, d+dd-1, t+tt-1, c] * w[dd, tt, c, o]
// for x [B, D, T, C] and w [3, 3, C, O].  fwd_route(C, O) says whether a
// shape belongs on this tile (O >= 8 and C >= 4).  Nothing here holds state
// between calls: the shared-memory opt-in is set on every call (a function-
// local static of header code would be shared by the dynamic linker between
// the libraries, STB_GNU_UNIQUE, while each library has its own kernels).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "tf32x3.cuh"

namespace conv3x3_mma {

using namespace tf32x3;

constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMK = 8;  // input channels per stage: one k8 step per shift
constexpr int kStages = 2;

template <int BM, int BN>
struct MmaTile {
  static constexpr int kWs4 = BN + 2;  // padded float4 stride of one staged weight row
  static constexpr int kXsFloats = 3 * (BM + 2) * kMK;
  static constexpr int kWsFloats = 9 * (kMK / 2) * kWs4 * 4;
  static constexpr int kStageFloats = kXsFloats + kWsFloats;
  static constexpr int kSmemBytes = kStages * kStageFloats * (int)sizeof(float);
};

// The route of a shape: 1 this tile, 0 a shape that would leave an m16n8k8
// tile mostly padding (O < 8 output or C < 4 input channels).
inline int fwd_route(int C, int O) { return (O >= 8 && C >= 4) ? 1 : 0; }

// The block tile's output channels, by O (see fwd_mma_run).
inline int mma_bn(int O) { return O >= 64 ? 64 : O >= 32 ? 32 : 16; }

// The weights in the layout the B fragments want, split once per call:
// wp[k][p][o] = (hi(w[k, 2p, o]), hi(w[k, 2p + 1, o]), lo(..2p..), lo(..2p + 1..))
// for p < pairs = 4 ceil(C / 8) and o < opad = ceil(O / BN) BN, zeros past C
// and O, so every chunk's weights are whole 16-byte rows.
__global__ void __launch_bounds__(256)
conv3x3_split_weights_kernel(const float* __restrict__ w, float4* __restrict__ wp, int C,
                             int O, int pairs, int opad) {
  const long n = 9L * pairs * opad;
  for (long idx = (long)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (long)gridDim.x * blockDim.x) {
    const int o = (int)(idx % opad);
    const int p = (int)((idx / opad) % pairs);
    const int k = (int)(idx / ((long)opad * pairs));
    const int c = 2 * p;
    const float v0 = (c < C && o < O) ? w[((long)k * C + c) * O + o] : 0.0f;
    const float v1 = (c + 1 < C && o < O) ? w[((long)k * C + c + 1) * O + o] : 0.0f;
    uint32_t h0, l0, h1, l1;
    split_tf32(v0, h0, l0);
    split_tf32(v1, h1, l1);
    wp[idx] = make_float4(__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(l0),
                          __uint_as_float(l1));
  }
}

// Stage chunk c0 into one stage: xs[r][j][c] = x[b, d + r - 1, t0 + j - 1,
// c0 + c] (zeros outside the map and past C) and ws[k][q][n] = wp[k][c0 / 2 +
// q][o0 + n].  VEC: 16-byte copies of 4 channels of x (C a multiple of 4, x
// aligned); the weights are always whole 16-byte rows.
template <int BM, int BN, bool VEC>
__device__ __forceinline__ void stage_chunk(float* xs, float* ws, const float* __restrict__ x,
                                            const float4* __restrict__ wp, long bd, int d,
                                            int t0, int o0, int c0, int D, int T, int C,
                                            int pairs, int opad) {
  constexpr int kRows = BM + 2;
  constexpr int kWs4 = MmaTile<BM, BN>::kWs4;
  constexpr int kV = VEC ? 4 : 1;  // floats a copy
  for (int e = threadIdx.x; e < 3 * kRows * (kMK / kV); e += kMmaThreads) {
    const int c = (e % (kMK / kV)) * kV;
    const int j = (e / (kMK / kV)) % kRows;
    const int r = e / ((kMK / kV) * kRows);
    const int dr = d + r - 1, t = t0 + j - 1, cc = c0 + c;
    const bool valid = dr >= 0 && dr < D && t >= 0 && t < T && cc < C;
    const float* src = valid ? x + ((bd + r - 1) * T + t) * (long)C + cc : x;
    cp_async<4 * kV>(xs + (r * kRows + j) * kMK + c, src, valid);
  }
  for (int e = threadIdx.x; e < 9 * (kMK / 2) * BN; e += kMmaThreads) {
    const int n = e % BN;
    const int q = (e / BN) % (kMK / 2);
    const int k = e / (BN * (kMK / 2));
    const float4* src = wp + ((long)k * pairs + c0 / 2 + q) * opad + o0 + n;
    cp_async<16>(ws + ((k * (kMK / 2) + q) * kWs4 + n) * 4, reinterpret_cast<const float*>(src),
                 true);
  }
}

// One staged chunk into the warp's 32 x WN accumulator tile: per shift
// (r, s), the A fragment of time rows i reads halo rows i + s of xs[r], the B
// fragment ws[r * 3 + s]; three products per fragment pair.  Fragment layouts
// of the PTX ISA, with g = lane / 4 and q = lane % 4:
//   A (m16 x k8, row): a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4)
//   B (k8 x n8, col): b0 (q, g), b1 (q + 4, g)
// The k8 step's k = q and q + 4 stand for channels 2q and 2q + 1 (the sum over
// k does not care which channel each k is, as long as A and B agree), so a0
// and a2 are one float2 of a staged time step, and b0, b1 and their residuals
// one float4 of the split weights.  Bank conflicts: a half warp's float2 reads
// cover words 8 g + 2 q, all 32 banks; a quarter warp's float4 reads cover
// 16-byte slots 2 q + g (mod 8) of a row stride of BN + 2 float4s.
template <int BM, int BN, int WN>
__device__ __forceinline__ void mma_chunk(const float* xs, const float* ws,
                                          float (&acc)[2][WN / 8][4], int m0, int n0, int g,
                                          int q) {
  constexpr int kRows = BM + 2;
  constexpr int kWs4 = MmaTile<BM, BN>::kWs4;
  const float4* ws4 = reinterpret_cast<const float4*>(ws);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* row = xs + (r * kRows + m0 + mt * 16 + g + s) * kMK + 2 * q;
        const float2 top = *reinterpret_cast<const float2*>(row);
        const float2 bottom = *reinterpret_cast<const float2*>(row + 8 * kMK);
        split_tf32(top.x, ah[mt][0], al[mt][0]);
        split_tf32(bottom.x, ah[mt][1], al[mt][1]);
        split_tf32(top.y, ah[mt][2], al[mt][2]);
        split_tf32(bottom.y, ah[mt][3], al[mt][3]);
      }
      const float4* wk = ws4 + ((r * 3 + s) * (kMK / 2) + q) * kWs4 + n0 + g;
#pragma unroll
      for (int nt = 0; nt < WN / 8; ++nt) {
        const float4 b = wk[nt * 8];
        const uint32_t bh[2] = {__float_as_uint(b.x), __float_as_uint(b.y)};
        const uint32_t bl[2] = {__float_as_uint(b.z), __float_as_uint(b.w)};
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_3xtf32(acc[mt][nt], ah[mt], al[mt], bh, bl);
      }
    }
  }
}

// A block: one freq row, BM time steps, BN output channels; 8 warps of
// 32 x WN.  C/D fragment: d0 (g, 2q), d1 (g, 2q + 1), d2 (g + 8, 2q), d3 (g + 8,
// 2q + 1).  ADD: each output is add[] at the same index plus the sum.
template <int BM, int BN, int WN, bool VEC, bool ADD>
__global__ void __launch_bounds__(kMmaThreads, 2)
conv3x3_fwd_mma_kernel(const float* __restrict__ x, const float4* __restrict__ wp,
                       const float* __restrict__ add, float* __restrict__ out, int D, int T,
                       int C, int O, int t_tiles, int pairs, int opad) {
  static_assert((BM / 32) * (BN / WN) == kMmaWarps, "8 warps of 32 x WN");
  using Tile = MmaTile<BM, BN>;
  extern __shared__ __align__(16) float smem[];

  const long bd = blockIdx.x / t_tiles;  // b * D + d
  const int t0 = (int)(blockIdx.x - bd * t_tiles) * BM;
  const int d = (int)(bd % D);
  const int o0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = (warp % (BM / 32)) * 32;
  const int n0 = (warp / (BM / 32)) * WN;
  const int g = lane / 4, q = lane % 4;

  float acc[2][WN / 8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < WN / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;

  // The tensor cores add into their f32 accumulator with truncation, so a
  // long run of mma into one accumulator drifts (3e-5 at K = 576 and 1e-4 at
  // K = 2304 against the plain version, measured on the H100).  Each chunk's
  // 27 products a fragment go into `part` from zero; acc adds the chunks
  // with round-to-nearest f32 adds.
  float part[2][WN / 8][4];
  const int chunks = (C + kMK - 1) / kMK;
  stage_chunk<BM, BN, VEC>(smem, smem + Tile::kXsFloats, x, wp, bd, d, t0, o0, 0, D, T, C,
                           pairs, opad);
  cp_async_commit();
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) {
      float* next = smem + ((ch + 1) % kStages) * Tile::kStageFloats;
      stage_chunk<BM, BN, VEC>(next, next + Tile::kXsFloats, x, wp, bd, d, t0, o0,
                               (ch + 1) * kMK, D, T, C, pairs, opad);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* cur = smem + (ch % kStages) * Tile::kStageFloats;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < WN / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.0f;
    mma_chunk<BM, BN, WN>(cur, cur + Tile::kXsFloats, part, m0, n0, g, q);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < WN / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
    __syncthreads();  // the next iteration's copies overwrite this stage
  }

  const bool even = (O % 2) == 0;  // float2 stores of (d0, d1) and (d2, d3)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = t0 + m0 + mt * 16 + g + half * 8;
      if (t >= T) continue;
      const long row = (bd * T + t) * (long)O;
#pragma unroll
      for (int nt = 0; nt < WN / 8; ++nt) {
        const int o = o0 + n0 + nt * 8 + 2 * q;
        float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        if (even && o + 1 < O) {
          if constexpr (ADD) {
            const float2 a = __ldg(reinterpret_cast<const float2*>(add + row + o));
            v0 = a.x + v0;
            v1 = a.y + v1;
          }
          *reinterpret_cast<float2*>(out + row + o) = make_float2(v0, v1);
        } else {
          if constexpr (ADD) {
            if (o < O) v0 = __ldg(add + row + o) + v0;
            if (o + 1 < O) v1 = __ldg(add + row + o + 1) + v1;
          }
          if (o < O) out[row + o] = v0;
          if (o + 1 < O) out[row + o + 1] = v1;
        }
      }
    }
}

// The split weights' pairs and padded O of a shape on this tile.
inline void split_dims(int C, int O, int* pairs, int* opad) {
  const int bn = mma_bn(O);
  *pairs = ((C + kMK - 1) / kMK) * (kMK / 2);
  *opad = ((O + bn - 1) / bn) * bn;
}

// Floats of the split weights' scratch (0 off this tile's route).
inline long fwd_scratch_floats(int C, int O) {
  if (C < 1 || O < 1 || fwd_route(C, O) == 0) return 0;
  int pairs, opad;
  split_dims(C, O, &pairs, &opad);
  return 9L * pairs * opad * 4;
}

template <int BM, int BN, int WN, bool VEC, bool ADD>
cudaError_t launch_mma_vec(const float* x, const float4* wp, const float* add, float* out, int B,
                           int D, int T, int C, int O, int pairs, int opad,
                           cudaStream_t stream) {
  constexpr int kSmem = MmaTile<BM, BN>::kSmemBytes;
  // above 48 KB needs the opt-in: set on every call (see the head note)
  const cudaError_t err = cudaFuncSetAttribute(conv3x3_fwd_mma_kernel<BM, BN, WN, VEC, ADD>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kSmem);
  if (err != cudaSuccess) return err;
  const int t_tiles = (T + BM - 1) / BM;
  const dim3 grid((unsigned)((long)B * D * t_tiles), (unsigned)((O + BN - 1) / BN));
  conv3x3_fwd_mma_kernel<BM, BN, WN, VEC, ADD><<<grid, kMmaThreads, kSmem, stream>>>(
      x, wp, add, out, D, T, C, O, t_tiles, pairs, opad);
  return cudaGetLastError();
}

template <int BM, int BN, int WN, bool ADD>
cudaError_t launch_mma(const float* x, const float* w, float4* wp, const float* add, float* out,
                       int B, int D, int T, int C, int O, cudaStream_t stream) {
  int pairs, opad;
  split_dims(C, O, &pairs, &opad);
  const long n = 9L * pairs * opad;
  const unsigned blocks = (unsigned)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  conv3x3_split_weights_kernel<<<blocks, 256, 0, stream>>>(w, wp, C, O, pairs, opad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const bool vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  return vec ? launch_mma_vec<BM, BN, WN, true, ADD>(x, wp, add, out, B, D, T, C, O, pairs,
                                                     opad, stream)
             : launch_mma_vec<BM, BN, WN, false, ADD>(x, wp, add, out, B, D, T, C, O, pairs,
                                                      opad, stream);
}

// out = (add +) conv3x3_same(x, w) on this tile, through the scratch wp of
// fwd_scratch_floats(C, O) floats (16-byte aligned); ADD reads add [B, D, T,
// O] (16-byte aligned), else add is not read.  Block tiles of 8 warps of
// 32 x WN: 128 x 64 for O >= 64, else 256 x 32 or 256 x 16 (T = 483 fills 2
// time tiles of 256 to 94 %); mma_bn.
template <bool ADD>
cudaError_t fwd_mma_run(const float* x, const float* w, float4* wp, const float* add,
                        float* out, int B, int D, int T, int C, int O, cudaStream_t stream) {
  if (B < 1 || D < 1 || T < 1 || fwd_route(C, O) == 0 || wp == nullptr ||
      reinterpret_cast<uintptr_t>(wp) % 16 != 0 || (ADD && add == nullptr))
    return cudaErrorInvalidValue;
  if (O >= 64) return launch_mma<128, 64, 32, ADD>(x, w, wp, add, out, B, D, T, C, O, stream);
  if (O >= 32) return launch_mma<256, 32, 32, ADD>(x, w, wp, add, out, B, D, T, C, O, stream);
  return launch_mma<256, 16, 16, ADD>(x, w, wp, add, out, B, D, T, C, O, stream);
}

}  // namespace conv3x3_mma
