// The bf16 tensor-core tiles of the bias-free 3x3 SAME convolution over
// channels-last bf16 maps and its weight gradient (the bf16 K3f and K3w; see
// conv3x3_bf16.cu for their design), shared by conv3x3_bf16.cu (K3f, K3w),
// abf_block_fwd.cu (the bf16 K5f's conv over xf) and abf_block_bwd.cu (the
// bf16 K5b's conv adjoint over g_out, with g_xf added in the epilogue into a
// float32 dxf, and its dw2).  Each source includes this header and is built
// into its own library; kernels/_build.py hashes the headers with the source,
// so an edit here rebuilds every library.
//
// fwd_run<F32OUT>() and wgrad_run() are the host side; fwd_route(C, O) and
// wgrad_route(C, O) name the route of a shape (route "wgmma", TMA and wgmma,
// where TMA takes the maps; the m16n8k16 "mma" tile for the other
// tensor-core shapes; "fma" and "narrow" for the narrow ones), and
// fwd_scratch_elems(C, O) the packed weights' scratch.  Nothing here holds
// state between calls: the shared-memory opt-in is set and the driver's
// tensor-map encoder looked up on every call (a function-local static of
// header code would be shared by the dynamic linker between the libraries,
// STB_GNU_UNIQUE, while each library has its own kernels).

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "conv3x3_tiles.cuh"

namespace conv3x3_bf16 {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes from src to shared dst, or zeros where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// two bf16 bit patterns as one fragment register, lo at the lower k index
__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint16_t ld16(const bf16* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

__device__ __forceinline__ float bf(const bf16* p) { return __bfloat162float(*p); }

// ---------------------------------------------------------------- forward

constexpr int kFK = 16;       // input channels a chunk: one k16 step a shift
constexpr int kFS = kFK + 8;  // padded bf16 stride of a staged pixel or weight row
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;

template <int BM, int BN>
struct FwdTile {
  static constexpr int kXs = 3 * (BM + 2) * kFS;  // bf16 elements
  static constexpr int kWs = 9 * BN * kFS;
  static constexpr int kStage = kXs + kWs;
  static constexpr int kSmemBytes = kStages * kStage * 2;
};

// The forward's route by shape: 0 "fma" (O < 8 or C < 8), 2 "wgmma" (C and O
// multiples of 8, C <= 256: TMA takes the maps), else 1 "mma".  fwd_run
// takes "mma" in place of "wgmma" where a map is not 16-byte aligned.
constexpr int kMaxWgmmaFwdC = 256;
inline int fwd_route(int C, int O) {
  if (O < 8 || C < 8) return 0;
  return (C % 8 == 0 && O % 8 == 0 && C <= kMaxWgmmaFwdC) ? 2 : 1;
}
inline int fwd_bn(int O) { return O >= 64 ? 64 : O >= 32 ? 32 : 16; }
inline void fwd_pad(int C, int O, int* cpad, int* opad) {
  const int bn = fwd_bn(O);
  *cpad = ((C + kFK - 1) / kFK) * kFK;
  *opad = ((O + bn - 1) / bn) * bn;
}

// wp[k][o][c] = w[k, c, o] for o < opad, c < cpad, zeros past O and C
__global__ void __launch_bounds__(256)
conv3x3_bf16_pack_weights_kernel(const bf16* __restrict__ w, bf16* __restrict__ wp, int C, int O,
                                 int cpad, int opad) {
  const long n = 9L * opad * cpad;
  for (long idx = (long)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (long)gridDim.x * blockDim.x) {
    const int c = (int)(idx % cpad);
    const int o = (int)((idx / cpad) % opad);
    const int k = (int)(idx / ((long)cpad * opad));
    wp[idx] = (c < C && o < O) ? w[((long)k * C + c) * O + o] : __float2bfloat16_rn(0.0f);
  }
}

// Chunk c0 into one stage: xs[r][j][c] = x[b, d + r - 1, t0 + j - 1, c0 + c]
// (zeros outside the map and past C), ws[k][n][c] = wp[k][o0 + n][c0 + c].
template <int BM, int BN, bool VEC>
__device__ __forceinline__ void fwd_stage(bf16* xs, bf16* ws, const bf16* __restrict__ x,
                                          const bf16* __restrict__ wp, long bd, int d, int t0,
                                          int o0, int c0, int D, int T, int C, int cpad,
                                          int opad) {
  constexpr int kRows = BM + 2;
  if constexpr (VEC) {
    for (int e = threadIdx.x; e < 3 * kRows * 2; e += kThreads) {
      const int half = e % 2;
      const int j = (e / 2) % kRows;
      const int r = e / (2 * kRows);
      const int dr = d + r - 1, t = t0 + j - 1, cc = c0 + 8 * half;
      const bool valid = dr >= 0 && dr < D && t >= 0 && t < T && cc < C;
      const bf16* src = valid ? x + ((bd + r - 1) * T + t) * (long)C + cc : x;
      cp_async16(xs + (r * kRows + j) * kFS + 8 * half, src, valid);
    }
  } else {
    for (int e = threadIdx.x; e < 3 * kRows * kFK; e += kThreads) {
      const int c = e % kFK;
      const int j = (e / kFK) % kRows;
      const int r = e / (kFK * kRows);
      const int dr = d + r - 1, t = t0 + j - 1, cc = c0 + c;
      const bool valid = dr >= 0 && dr < D && t >= 0 && t < T && cc < C;
      xs[(r * kRows + j) * kFS + c] =
          valid ? x[((bd + r - 1) * T + t) * (long)C + cc] : __float2bfloat16_rn(0.0f);
    }
  }
  for (int e = threadIdx.x; e < 9 * BN * 2; e += kThreads) {
    const int half = e % 2;
    const int n = (e / 2) % BN;
    const int k = e / (2 * BN);
    cp_async16(ws + (k * BN + n) * kFS + 8 * half,
               wp + ((long)k * opad + o0 + n) * cpad + c0 + 8 * half, true);
  }
}

// One staged chunk into the warp's 32 x WN tile: per shift (r, s) the A
// fragment of time rows i reads halo rows i + s of xs[r], the B fragment
// ws[r * 3 + s].  m16n8k16 fragments (PTX ISA), g = lane / 4, q = lane % 4:
//   A (row): a0 (g, 2q..2q+1), a1 (g + 8, 2q..), a2 (g, 2q+8..), a3 (g + 8, 2q+8..)
//   B (col): b0 (2q..2q+1, g), b1 (2q+8..2q+9, g)
template <int BM, int BN, int WN>
__device__ __forceinline__ void fwd_mma_chunk(const bf16* xs, const bf16* ws,
                                              float (&part)[2][WN / 8][4], int m0, int n0,
                                              int g, int q) {
  constexpr int kRows = BM + 2;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const bf16* row = xs + (r * kRows + m0 + mt * 16 + g + s) * kFS + 2 * q;
        a[mt][0] = ld32(row);
        a[mt][1] = ld32(row + 8 * kFS);
        a[mt][2] = ld32(row + 8);
        a[mt][3] = ld32(row + 8 * kFS + 8);
      }
      const bf16* wk = ws + ((r * 3 + s) * BN + n0 + g) * kFS + 2 * q;
#pragma unroll
      for (int nt = 0; nt < WN / 8; ++nt) {
        const uint32_t b[2] = {ld32(wk + nt * 8 * kFS), ld32(wk + nt * 8 * kFS + 8)};
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16(part[mt][nt], a[mt], b);
      }
    }
  }
}

// F32OUT: out is float and each output is add[] (bf16, at the same index)
// plus the sum, unrounded (K5b's adjoint with g_xf added); else out is bf16,
// the sum rounded once.
template <int BM, int BN, int WN, bool VEC, bool F32OUT>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_bf16_fwd_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wp,
                            const bf16* __restrict__ add, void* __restrict__ out_, int D, int T,
                            int C, int O, int t_tiles, int cpad, int opad) {
  static_assert((BM / 32) * (BN / WN) == kWarps, "8 warps of 32 x WN");
  using Tile = FwdTile<BM, BN>;
  extern __shared__ __align__(16) bf16 smem[];

  const long bd = blockIdx.x / t_tiles;  // b * D + d
  const int t0 = (int)(blockIdx.x - bd * t_tiles) * BM;
  const int d = (int)(bd % D);
  const int o0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = (warp % (BM / 32)) * 32;
  const int n0 = (warp / (BM / 32)) * WN;
  const int g = lane / 4, q = lane % 4;

  float acc[2][WN / 8][4], part[2][WN / 8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < WN / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;

  const int chunks = cpad / kFK;
  fwd_stage<BM, BN, VEC>(smem, smem + Tile::kXs, x, wp, bd, d, t0, o0, 0, D, T, C, cpad, opad);
  cp_async_commit();
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) {
      bf16* next = smem + ((ch + 1) % kStages) * Tile::kStage;
      fwd_stage<BM, BN, VEC>(next, next + Tile::kXs, x, wp, bd, d, t0, o0, (ch + 1) * kFK, D, T,
                             C, cpad, opad);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cur = smem + (ch % kStages) * Tile::kStage;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < WN / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.0f;
    fwd_mma_chunk<BM, BN, WN>(cur, cur + Tile::kXs, part, m0, n0, g, q);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < WN / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
    __syncthreads();  // the next iteration's copies overwrite this stage
  }

  const bool even = (O % 2) == 0;  // paired stores of (d0, d1) and (d2, d3)
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
        if constexpr (F32OUT) {
          float* out = static_cast<float*>(out_);
          if (o < O) v0 = bf(add + row + o) + v0;
          if (o + 1 < O) v1 = bf(add + row + o + 1) + v1;
          if (even && o + 1 < O) {
            *reinterpret_cast<float2*>(out + row + o) = make_float2(v0, v1);
          } else {
            if (o < O) out[row + o] = v0;
            if (o + 1 < O) out[row + o + 1] = v1;
          }
        } else {
          bf16* out = static_cast<bf16*>(out_);
          if (even && o + 1 < O) {
            *reinterpret_cast<__nv_bfloat162*>(out + row + o) = __floats2bfloat162_rn(v0, v1);
          } else {
            if (o < O) out[row + o] = __float2bfloat16_rn(v0);
            if (o + 1 < O) out[row + o + 1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
}

template <int BM, int BN, int WN, bool F32OUT>
cudaError_t launch_fwd_mma(const bf16* x, const bf16* w, bf16* wp, const bf16* add, void* out,
                           int B, int D, int T, int C, int O, cudaStream_t stream) {
  int cpad, opad;
  fwd_pad(C, O, &cpad, &opad);
  const long n = 9L * opad * cpad;
  const unsigned blocks = (unsigned)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  conv3x3_bf16_pack_weights_kernel<<<blocks, 256, 0, stream>>>(w, wp, C, O, cpad, opad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int kSmem = FwdTile<BM, BN>::kSmemBytes;
  const bool vec = C % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  // above 48 KB needs the opt-in: set on every call (no function-local statics)
  err = vec ? cudaFuncSetAttribute(conv3x3_bf16_fwd_mma_kernel<BM, BN, WN, true, F32OUT>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem)
            : cudaFuncSetAttribute(conv3x3_bf16_fwd_mma_kernel<BM, BN, WN, false, F32OUT>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const int t_tiles = (T + BM - 1) / BM;
  const dim3 grid((unsigned)((long)B * D * t_tiles), (unsigned)((O + BN - 1) / BN));
  if (vec)
    conv3x3_bf16_fwd_mma_kernel<BM, BN, WN, true, F32OUT><<<grid, kThreads, kSmem, stream>>>(
        x, wp, add, out, D, T, C, O, t_tiles, cpad, opad);
  else
    conv3x3_bf16_fwd_mma_kernel<BM, BN, WN, false, F32OUT><<<grid, kThreads, kSmem, stream>>>(
        x, wp, add, out, D, T, C, O, t_tiles, cpad, opad);
  return cudaGetLastError();
}

// Route "fma": block (freq row, 64 time steps, 16 output channels), thread
// (t, og) sums output channels og, og + 4, og + 8, og + 12 of time step t.
constexpr int kDT = 64;  // time steps a block
constexpr int kDC = 32;  // input channels a chunk
constexpr int kDN = 16;  // output channels a block

__global__ void __launch_bounds__(256)
conv3x3_bf16_fwd_direct_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                               bf16* __restrict__ out, int D, int T, int C, int O, int t_tiles) {
  __shared__ float xs[3][kDC][kDT + 2];  // channel-major: lanes read neighbouring steps
  __shared__ float ws[9][kDC][kDN];
  const long bd = blockIdx.x / t_tiles;
  const int t0 = (int)(blockIdx.x - bd * t_tiles) * kDT;
  const int d = (int)(bd % D);
  const int o0 = blockIdx.y * kDN;
  const int tl = threadIdx.x % kDT, og = threadIdx.x / kDT;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int c0 = 0; c0 < C; c0 += kDC) {
    const int cn = C - c0 < kDC ? C - c0 : kDC;
    for (int e = threadIdx.x; e < 3 * (kDT + 2) * kDC; e += 256) {
      const int c = e % kDC;
      const int j = (e / kDC) % (kDT + 2);
      const int r = e / (kDC * (kDT + 2));
      const int dr = d + r - 1, t = t0 + j - 1;
      const bool valid = c < cn && dr >= 0 && dr < D && t >= 0 && t < T;
      xs[r][c][j] = valid ? bf(x + ((bd + r - 1) * T + t) * (long)C + c0 + c) : 0.0f;
    }
    for (int e = threadIdx.x; e < 9 * kDC * kDN; e += 256) {
      const int n = e % kDN;
      const int c = (e / kDN) % kDC;
      const int k = e / (kDN * kDC);
      const int o = o0 + n;
      ws[k][c][n] = (c < cn && o < O) ? bf(w + ((long)k * C + c0 + c) * O + o) : 0.0f;
    }
    __syncthreads();
    for (int r = 0; r < 3; ++r)
      for (int s = 0; s < 3; ++s)
        for (int c = 0; c < cn; ++c) {
          const float xv = xs[r][c][tl + s];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j] = fmaf(xv, ws[r * 3 + s][c][og + 4 * j], acc[j]);
        }
    __syncthreads();
  }
  const int t = t0 + tl;
  if (t >= T) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int o = o0 + og + 4 * j;
    if (o < O) out[(bd * T + t) * (long)O + o] = __float2bfloat16_rn(acc[j]);
  }
}

// ---------------------------------------------------------- weight gradient

constexpr int kWgCT = 32;           // input channels of a block: 2 m16 tiles
constexpr int kWgBN = 32;           // output channels of a block: 4 n8 tiles
constexpr int kWgBT = 64;           // time steps a stage: 4 k16 steps
constexpr int kWgWarps = 6;         // (dd, m tile)
constexpr int kWgThreads = kWgWarps * 32;
constexpr int kWgS = 40;            // padded bf16 stride of a staged time step
constexpr int kWgXs = 3 * (kWgBT + 2) * kWgS;
constexpr int kWgStage = kWgXs + kWgBT * kWgS;
constexpr int kWgSmemBytes = kStages * kWgStage * 2;

// One stage (freq row bd, time steps t0 ..): xs[r][j][c] = x[b, d + r - 1,
// t0 + j - 1, c0 + c] and gs[j][o] = g[b, d, t0 + j, o0 + o], zeros outside
// the map and past T, C and O.  VEC: 16-byte copies (C and O multiples of 8,
// x and g aligned), else plain loads.
template <bool VEC>
__device__ __forceinline__ void wgrad_stage(bf16* xs, bf16* gs, const bf16* __restrict__ x,
                                            const bf16* __restrict__ g, long bd, int t0,
                                            int c0, int o0, int D, int T, int C, int O) {
  constexpr int kV = VEC ? 8 : 1;
  const int d = (int)(bd % D);
  for (int e = threadIdx.x; e < 3 * (kWgBT + 2) * (kWgCT / kV); e += kWgThreads) {
    const int c = (e % (kWgCT / kV)) * kV;
    const int j = (e / (kWgCT / kV)) % (kWgBT + 2);
    const int r = e / ((kWgCT / kV) * (kWgBT + 2));
    const int dr = d + r - 1, t = t0 + j - 1, cc = c0 + c;
    const bool valid = dr >= 0 && dr < D && t >= 0 && t < T && cc < C;
    bf16* dst = xs + (r * (kWgBT + 2) + j) * kWgS + c;
    const bf16* src = x + ((bd + r - 1) * T + t) * (long)C + cc;
    if constexpr (VEC)
      cp_async16(dst, valid ? src : x, valid);
    else
      *dst = valid ? *src : __float2bfloat16_rn(0.0f);
  }
  for (int e = threadIdx.x; e < kWgBT * (kWgBN / kV); e += kWgThreads) {
    const int o = (e % (kWgBN / kV)) * kV;
    const int j = e / (kWgBN / kV);
    const int t = t0 + j, oo = o0 + o;
    const bool valid = t < T && oo < O;
    bf16* dst = gs + j * kWgS + o;
    const bf16* src = g + (bd * T + t) * (long)O + oo;
    if constexpr (VEC)
      cp_async16(dst, valid ? src : g, valid);
    else
      *dst = valid ? *src : __float2bfloat16_rn(0.0f);
  }
}

// One staged stage into a warp's fragments from zero: part[s][nt] of shift
// (dd = r, tt = s), channels c0 + 16 mt .. + 15 and output channels 8 nt ..
// 8 nt + 7 of the block's tile.  The product's rows are channels, its columns
// output channels and its k the stage's time steps: a lane's A registers are
// two neighbouring time steps of one channel, packed from 16-bit loads, and
// its three time shifts read halo rows 2q .. 2q + 3 and 2q + 8 .. 2q + 11.
// Bank conflicts: none; a lane's loads fall on word 20 (2q + i) + g / 2 (+ 4)
// of a stride of 40 bf16, i.e. banks 8q + g / 2 (+ 4).
__device__ __forceinline__ void wgrad_mma_stage(const bf16* xs, const bf16* gs,
                                                float (&part)[3][4][4], int r, int mt, int g,
                                                int q) {
#pragma unroll
  for (int ks = 0; ks < kWgBT / 16; ++ks) {
    const bf16* xr = xs + (r * (kWgBT + 2) + ks * 16 + 2 * q) * kWgS + mt * 16 + g;
    uint16_t xv[2][2][4];  // [channel g, g + 8][rows 2q.. or 2q + 8..][i]
#pragma unroll
    for (int ch = 0; ch < 2; ++ch)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[ch][h][i] = ld16(xr + (h * 8 + i) * kWgS + ch * 8);
    const bf16* gr = gs + (ks * 16 + 2 * q) * kWgS + g;
    uint32_t b[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      b[nt][0] = pack2(ld16(gr + nt * 8), ld16(gr + kWgS + nt * 8));
      b[nt][1] = pack2(ld16(gr + 8 * kWgS + nt * 8), ld16(gr + 9 * kWgS + nt * 8));
    }
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const uint32_t a[4] = {pack2(xv[0][0][s], xv[0][0][s + 1]), pack2(xv[1][0][s], xv[1][0][s + 1]),
                             pack2(xv[0][1][s], xv[0][1][s + 1]), pack2(xv[1][1][s], xv[1][1][s + 1])};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_bf16(part[s][nt], a, b[nt]);
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kWgThreads, 2)
conv3x3_bf16_wgrad_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                              float* __restrict__ partial, int D, int T, int C, int O, long BD,
                              int rows_per_chunk) {
  extern __shared__ __align__(16) bf16 smem[];
  const int tiles_o = (O + kWgBN - 1) / kWgBN;
  const int c0 = (blockIdx.x / tiles_o) * kWgCT;
  const int o0 = (blockIdx.x % tiles_o) * kWgBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = warp / 2, mt = warp % 2;
  const int gl = lane / 4, q = lane % 4;
  const long row_begin = (long)blockIdx.y * rows_per_chunk;
  const long row_end = row_begin + rows_per_chunk < BD ? row_begin + rows_per_chunk : BD;
  const int t_tiles = (T + kWgBT - 1) / kWgBT;
  const int stages = (int)(row_end - row_begin) * t_tiles;

  float acc[3][4][4], part[3][4][4];
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[s][nt][i] = 0.0f;

  wgrad_stage<VEC>(smem, smem + kWgXs, x, g, row_begin, 0, c0, o0, D, T, C, O);
  cp_async_commit();
  for (int st = 0; st < stages; ++st) {
    if (st + 1 < stages) {
      bf16* next = smem + ((st + 1) % kStages) * kWgStage;
      wgrad_stage<VEC>(next, next + kWgXs, x, g, row_begin + (st + 1) / t_tiles,
                       ((st + 1) % t_tiles) * kWgBT, c0, o0, D, T, C, O);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cur = smem + (st % kStages) * kWgStage;
#pragma unroll
    for (int s = 0; s < 3; ++s)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[s][nt][i] = 0.0f;
    wgrad_mma_stage(cur, cur + kWgXs, part, r, mt, gl, q);
#pragma unroll
    for (int s = 0; s < 3; ++s)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[s][nt][i] += part[s][nt][i];
    __syncthreads();  // the next iteration's copies overwrite this stage
  }

  float* dst = partial + (size_t)blockIdx.y * 9 * C * O;
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = c0 + mt * 16 + gl + half * 8;
      if (c >= C) continue;
      float* row = dst + ((long)(r * 3 + s) * C + c) * O;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int o = o0 + nt * 8 + 2 * q;
        if (o < O) row[o] = acc[s][nt][2 * half];
        if (o + 1 < O) row[o + 1] = acc[s][nt][2 * half + 1];
      }
    }
}

// Route "narrow" (O <= OMAX <= 8): K3w's narrow pass (conv3x3_tiles.cuh) on
// bf16 loads.  Thread (c, unit) owns input channel c and one contiguous range
// of freq rows, walks each row along time with the 3 x 3 window of x in
// registers and keeps 9 x OMAX f32 sums.
template <int OMAX>
__global__ void __launch_bounds__(conv3x3_tiles::kNarrowC * conv3x3_tiles::kNarrowGroups)
conv3x3_bf16_wgrad_narrow_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                                 float* __restrict__ partial, int D, int T, int C, int O,
                                 long BD, int units, int rows_per_unit) {
  using conv3x3_tiles::kNarrowC;
  using conv3x3_tiles::kNarrowGroups;
  const int c = blockIdx.y * kNarrowC + threadIdx.x % kNarrowC;
  const int unit = blockIdx.x * kNarrowGroups + threadIdx.x / kNarrowC;
  if (unit >= units || c >= C) return;  // no barrier below
  float acc[9][OMAX];
#pragma unroll
  for (int k = 0; k < 9; ++k)
#pragma unroll
    for (int o = 0; o < OMAX; ++o) acc[k][o] = 0.0f;
  const long row_begin = (long)unit * rows_per_unit;
  const long row_end = row_begin + rows_per_unit < BD ? row_begin + rows_per_unit : BD;
  for (long bd = row_begin; bd < row_end; ++bd) {
    const int d = (int)(bd % D);
    const bf16* xr[3];
    bool ok[3];
    float w[3][3];  // w[r][s] = x[b, d + r - 1, t + s - 1, c]
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      ok[r] = d + r - 1 >= 0 && d + r - 1 < D;
      xr[r] = ok[r] ? x + (bd + r - 1) * T * (long)C + c : x;
      w[r][0] = 0.0f;
      w[r][1] = ok[r] ? bf(xr[r]) : 0.0f;
      w[r][2] = ok[r] && T > 1 ? bf(xr[r] + C) : 0.0f;
    }
    const bf16* gr = g + bd * T * (long)O;
#pragma unroll 2
    for (int t = 0; t < T; ++t) {
      float gv[OMAX];
#pragma unroll
      for (int o = 0; o < OMAX; ++o) gv[o] = o < O ? bf(gr + (long)t * O + o) : 0.0f;
      float nx[3];
#pragma unroll
      for (int r = 0; r < 3; ++r) nx[r] = ok[r] && t + 2 < T ? bf(xr[r] + (long)(t + 2) * C) : 0.0f;
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int s = 0; s < 3; ++s)
#pragma unroll
          for (int o = 0; o < OMAX; ++o) acc[r * 3 + s][o] = fmaf(w[r][s], gv[o], acc[r * 3 + s][o]);
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        w[r][0] = w[r][1];
        w[r][1] = w[r][2];
        w[r][2] = nx[r];
      }
    }
  }
  float* dst = partial + (size_t)unit * 9 * C * O;
#pragma unroll
  for (int k = 0; k < 9; ++k)
#pragma unroll
    for (int o = 0; o < OMAX; ++o)
      if (o < O) dst[((long)k * C + c) * O + o] = acc[k][o];
}

// ------------------------------------------------- route "wgmma": TMA + wgmma
//
// The forward (conv3x3_bf16_fwd_wgmma_kernel) and the weight gradient
// (conv3x3_bf16_wgrad_wgmma_kernel) for C and O multiples of 8 and 16-byte
// aligned maps (the forward also C <= 256).  One producer thread keeps TMA
// loads in flight into a ring of stages on mbarriers; one staged halo serves
// all nine shifts, a time shift being a row offset of the 128-byte-swizzled
// halo (the swizzle follows the address): the forward's consumers read A
// through a wgmma descriptor whose start is shifted, the weight gradient's
// load A by ldmatrix.x4.trans from the shifted rows.  See conv3x3_bf16.cu.

constexpr int kTile = 64;                        // time steps of a tile: one m64 (or k) extent
constexpr int kHaloRows = kTile + 2;             // with the rows t0 - 1 and t0 + 64
constexpr int kSwRow = 128;                      // bytes of a staged row: 64 bf16 channels
constexpr int kHaloBox = kHaloRows * kSwRow;     // bytes of one halo row's TMA box
constexpr int kHaloPitch = 9 * 1024;             // the box's place, 1024-aligned for the swizzle
constexpr int kHaloStage = 3 * kHaloPitch;       // the three halo rows d - 1, d, d + 1
constexpr int kGBox = kTile * kSwRow;            // g's box: 64 time steps x 64 output channels
constexpr int kWgStageBytes = kHaloStage + kGBox;
constexpr int kSmemLimit = 232448;               // the opt-in limit of a block
constexpr int kSmemSlack = 1024 + 256;           // alignment of the base and the barriers
constexpr int kMaxStages = 8;
// A producer warpgroup (one thread issues the copies) beside the consumers:
// ptxas gives a kernel with setmaxnreg 65536 / threads registers a thread at
// launch, and the counts below add up to that pool (168 x 384 and 128 x 512).
constexpr int kFwdConsumers = 2;                 // warpgroups, each on its own tiles
constexpr int kFwdThreads = (kFwdConsumers + 1) * 128;
constexpr int kFwdProducerRegs = 40, kFwdConsumerRegs = 232;
constexpr int kWgConsumers = 3;                  // warpgroups, one per halo row dd
constexpr int kWgmmaThreads = (kWgConsumers + 1) * 128;
constexpr int kWgProducerRegs = 24, kWgConsumerRegs = 160;
constexpr int kWgStages = 6;
constexpr int kWgSmem = kSmemSlack + kWgStages * kWgStageBytes;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// until the phase of parity `parity` has completed; a wait of more than
// ~2^35 cycles (some 20 s) means a copy that never lands, and traps, so that
// the launch fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  const long long start = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 35)) __trap();
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// four 8x8 bf16 matrices, transposed; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// The 16-byte unit `unit` of staged row `row` under the 128-byte swizzle
// (the unit's index XOR the row's low three bits; the tile 1024-aligned).
__device__ __forceinline__ uint32_t sw128(uint32_t base, int row, int unit) {
  return base + row * kSwRow + ((unit ^ (row & 7)) << 4);
}

// A wgmma shared-memory descriptor, 128-byte swizzle: start, leading and
// stride byte offsets (in 16 bytes).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Registers the wgmma reads or writes asynchronously, pinned across the wait:
// the compiler neither moves their uses above it nor reuses them before it.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&a)[4]) {
  asm volatile("" : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3])::"memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// wgmma.mma_async m64n32k16, f32 += bf16 x bf16, A from registers (the
// m16n8k16 A fragment in each warp's 16 rows), B through its descriptor
// (TRANS_B: N-major); scale_d = 0 starts from zero.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(TRANS_B));
}

// wgmma.mma_async m64nNk16, f32 += bf16 x bf16, A and B through their
// descriptors (both K-major); scale_d = 0 starts from zero.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_ss_bn(float (&d)[BN / 2], uint64_t da, uint64_t db,
                                            int scale_d) {
  if constexpr (BN == 64)
    wgmma_ss_n64(d, da, db, scale_d);
  else
    wgmma_ss_n32(d, da, db, scale_d);
}

// A completed group's sum pinned past the wait and added into the running
// one with round-to-nearest f32 adds.
template <int N>
__device__ __forceinline__ void fold(float (&acc)[N], float (&part)[N]) {
  pin(part);
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] += part[i];
}

// The forward.  Block: a fixed output-channel block nb of BN channels (its
// nine weight slices for every channel, resident for the block's life) and a
// fixed list of (b, d, 64-step tile) tiles; consumer warpgroup w takes the
// block's tiles w, w + 2, ...  A tile's stages are its 64-channel chunks: the
// halo rows d - 1, d, d + 1, time steps t0 - 1 .. t0 + 64, by three TMA boxes
// that bring zeros outside the map.  Per 16-channel group the nine shifts
// (dd, tt) go into a fresh accumulator (scale_d = 0 first), both operands
// K-major with the 128-byte swizzle, the start advanced 32 bytes a group: A
// the 64 rows of halo row dd from its row tt (a start tt 128-byte rows on;
// the output bits are those of an ldmatrix.x4 of the shifted rows), B the
// slice (dd, tt) of the weights; the group's sum is added into the running
// sum with a round-to-nearest f32 add.  With no registers of A, two groups
// are in flight (an ldmatrix into A's registers during a group makes ptxas
// serialize the wgmma, C7513).  F32OUT: out float, add[] (bf16) plus the
// sum; else bf16, the sum rounded once.
template <int BN, bool F32OUT>
__global__ void __launch_bounds__(kFwdThreads, 1)
conv3x3_bf16_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                              const __grid_constant__ CUtensorMap wmap, const bf16* __restrict__ add,
                              void* __restrict__ out_, int D, int T, int C, int O, int t_tiles,
                              long tiles, int n_blocks, int kch, int stages) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int wbytes = kch * 9 * BN * kSwRow;
  uint8_t* ring = smem + wbytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * kHaloStage);
  uint64_t* empty = full + kMaxStages;
  uint64_t* wbar = empty + kMaxStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // the consuming warpgroup's warps
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int nb = (int)(blockIdx.x % n_blocks);
  const long group = blockIdx.x / n_blocks, groups = gridDim.x / n_blocks;
  const long my_tiles = group < tiles ? (tiles - group + groups - 1) / groups : 0;
  const int wg = threadIdx.x / 128;

  if (wg == kFwdConsumers) {  // the producer warpgroup: its first thread issues
    setmaxnreg_dec<kFwdProducerRegs>();
    if (threadIdx.x == kFwdConsumers * 128) {
      mbar_expect_tx(wbar, (uint32_t)wbytes);
      for (int kc = 0; kc < kch; ++kc)
        for (int k = 0; k < 9; ++k)
          tma_load_3d(smem + (kc * 9 + k) * BN * kSwRow, &wmap, wbar, 64 * kc, nb * BN, k);
      for (long li = 0; li < my_tiles; ++li) {
        const long j = group + li * groups;
        const long bd = j / t_tiles;
        const int t0 = (int)(j - bd * t_tiles) * kTile;
        const int b = (int)(bd / D), d = (int)(bd % D);
        for (int kc = 0; kc < kch; ++kc) {
          const long s = li * kch + kc;
          const int slot = (int)(s % stages);
          mbar_wait(&empty[slot], (uint32_t)(((s / stages) & 1) ^ 1));
          mbar_expect_tx(&full[slot], 3 * kHaloBox);
          uint8_t* st = ring + slot * kHaloStage;
          for (int r = 0; r < 3; ++r)
            tma_load_4d(st + r * kHaloPitch, &xmap, &full[slot], 64 * kc, t0 - 1, d + r - 1, b);
        }
      }
    }
  } else {  // consumer warpgroup wg
    setmaxnreg_inc<kFwdConsumerRegs>();
    const int wi = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, q = lane % 4;
    mbar_wait(wbar, 0);
    const uint64_t wdesc = sw128_desc(smem_u32(smem), 16, 1024);
    // Two 16-channel groups in flight: group kk's products go into part[kk %
    // 2] while the group before (the other parity; a chunk's first group
    // follows the previous chunk's fourth) is summed.  A stage is handed back
    // once its last group's products are complete.
    float acc[BN / 2], part[2][BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) part[0][i] = part[1][i] = 0.0f;
    for (long li = wg; li < my_tiles; li += kFwdConsumers) {
      const long j = group + li * groups;
      const long bd = j / t_tiles;
      const int t0 = (int)(j - bd * t_tiles) * kTile;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      bool pending = false;   // a group in flight
      int pending_slot = -1;  // its stage, where it is the stage's last group
      int last_kk = 0;
      for (int kc = 0; kc < kch; ++kc) {
        const long s = li * kch + kc, n = s / stages;
        const int slot = (int)(s % stages);
        // The slot's previous use may be the other warpgroup's: wait for its
        // release first, so that the parity below names this use's phase
        // (safe as fwd_plan sizes the ring: 2 stages >= kch + 1).
        if (n > 0) mbar_wait(&empty[slot], (uint32_t)((n - 1) & 1));
        mbar_wait(&full[slot], (uint32_t)(n & 1));
        const uint32_t xs = smem_u32(ring + slot * kHaloStage);
        const int groups16 = min(4, (C - 64 * kc + 15) / 16);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk >= groups16) break;
          wg_fence();
#pragma unroll
          for (int k = 0; k < 9; ++k)  // shift (dd, tt) = (k / 3, k % 3)
            wgmma_ss_bn<BN>(
                part[kk & 1],
                sw128_desc(xs + (k / 3) * kHaloPitch + (k % 3) * kSwRow + 32 * kk, 16, 1024),
                wdesc + (uint64_t)((((kc * 9 + k) * BN * kSwRow) + 32 * kk) >> 4), k);
          wg_commit();
          if (pending) {
            wg_wait<1>();
            fold(acc, part[(kk & 1) ^ 1]);
            if (pending_slot >= 0) {
              __syncwarp();
              if (lane == 0) mbar_arrive(&empty[pending_slot]);
            }
          }
          pending = true;
          pending_slot = kk == groups16 - 1 ? slot : -1;
          last_kk = kk;
        }
      }
      wg_wait<0>();
      if (last_kk & 1)
        fold(acc, part[1]);
      else
        fold(acc, part[0]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[pending_slot]);
      // accumulator (m64nN): d[4 jn + 2 h + e] is row 16 wi + g + 8 h, column 8 jn + 2 q + e
      const int o_base = nb * BN + 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + 16 * wi + g + 8 * h;
        if (t >= T) continue;
        const long row = (bd * T + t) * (long)O;
#pragma unroll
        for (int jn = 0; jn < BN / 8; ++jn) {
          const int o = o_base + 8 * jn;
          if (o >= O) continue;  // O is a multiple of 8: o + 1 < O too
          const float v0 = acc[4 * jn + 2 * h], v1 = acc[4 * jn + 2 * h + 1];
          if constexpr (F32OUT) {
            const float2 a2 = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(add + row + o));
            *reinterpret_cast<float2*>(static_cast<float*>(out_) + row + o) =
                make_float2(a2.x + v0, a2.y + v1);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out_) + row + o) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
  }
}

// The weight gradient.  Block: input channels c0 .. c0 + 63, output channels
// o0 .. o0 + 63, one chunk of freq rows (blockIdx.y), as the "mma" route.  A
// stage is one freq row x 64 time steps: x's three halo rows (as the
// forward's) and g's 64 x 64 box.  Consumer warpgroup dd holds the three
// shifts (dd, tt) of the block's tile: per stage and shift, A is halo row dd's
// rows k + tt transposed (ldmatrix.x4.trans: rows are channels, k the stage's
// time steps), B is g (N-major: the descriptor's transpose bit) in two halves
// of 32 output channels (m64n32k16: n64 with its 32 accumulator registers
// spilled at the consumers' 160 and ran 0.25 ms slower at the reference
// shape), each half's four k16 products into a fresh accumulator, added
// into the running sum with a round-to-nearest f32 add.  Writes the chunk's
// partial [3, 3, C, O].
__global__ void __launch_bounds__(kWgmmaThreads, 1)
conv3x3_bf16_wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                                const __grid_constant__ CUtensorMap gmap,
                                float* __restrict__ partial, int D, int T, int C, int O, long BD,
                                int rows_per_chunk) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kWgStages * kWgStageBytes);
  uint64_t* empty = full + kMaxStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kWgConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int tiles_o = (O + 63) / 64;
  const int c0 = (blockIdx.x / tiles_o) * 64;
  const int o0 = (blockIdx.x % tiles_o) * 64;
  const long row_begin = (long)blockIdx.y * rows_per_chunk;
  const long row_end = row_begin + rows_per_chunk < BD ? row_begin + rows_per_chunk : BD;
  const int t_tiles = (T + kTile - 1) / kTile;
  const int n_stages = (int)(row_end - row_begin) * t_tiles;
  const int wg = threadIdx.x / 128;

  if (wg == kWgConsumers) {  // the producer warpgroup: its first thread issues
    setmaxnreg_dec<kWgProducerRegs>();
    if (threadIdx.x == kWgConsumers * 128) {
      for (int st = 0; st < n_stages; ++st) {
        const long bd = row_begin + st / t_tiles;
        const int t0 = (st % t_tiles) * kTile;
        const int b = (int)(bd / D), d = (int)(bd % D);
        const int slot = st % kWgStages;
        mbar_wait(&empty[slot], (uint32_t)(((st / kWgStages) & 1) ^ 1));
        mbar_expect_tx(&full[slot], 3 * kHaloBox + kGBox);
        uint8_t* stage = smem + slot * kWgStageBytes;
        for (int r = 0; r < 3; ++r)
          tma_load_4d(stage + r * kHaloPitch, &xmap, &full[slot], c0, t0 - 1, d + r - 1, b);
        tma_load_4d(stage + kHaloStage, &gmap, &full[slot], o0, t0, d, b);
      }
    }
  } else {  // consumer warpgroup dd = wg
    setmaxnreg_inc<kWgConsumerRegs>();
    const int dd = wg;
    const int wi = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, q = lane % 4;
    // ldmatrix.x4.trans: lane l addresses time row (l % 8) + 8 (l / 16) of the
    // k16 step and the channel unit 2 wi + (l / 8) % 2: the A fragment of
    // channels 16 wi .. 16 wi + 15 (rows) x 16 time steps (k)
    const int lrow = (lane & 7) + (lane >> 4) * 8;
    const int lunit = 2 * wi + ((lane >> 3) & 1);
    // acc[tt][hf][.]: shift (dd, tt), output channels o0 + 32 hf .. + 31
    // (m64n32: acc[4 jn + 2 h + e] is channel row 16 wi + g + 8 h, output
    // column 8 jn + 2 q + e); the upper half only where the tile has channels
    float acc[3][2][16], part[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      part[i] = 0.0f;
#pragma unroll
      for (int tt = 0; tt < 3; ++tt) acc[tt][0][i] = acc[tt][1][i] = 0.0f;
    }
    const bool upper = O - o0 > 32;
    for (int st = 0; st < n_stages; ++st) {
      const int slot = st % kWgStages;
      mbar_wait(&full[slot], (uint32_t)((st / kWgStages) & 1));
      const uint32_t stage = smem_u32(smem + slot * kWgStageBytes);
      const uint32_t xs = stage + dd * kHaloPitch;
      // g's box, N-major: 128-byte rows of 64 output channels, one a time
      // step; 8-row groups 1024 bytes apart, a k16 step 2048 bytes on, the
      // upper 32 channels 64 bytes into each row
      const uint64_t gdesc = sw128_desc(stage + kHaloStage, 1024, 1024);
#pragma unroll
      for (int tt = 0; tt < 3; ++tt) {
        uint32_t a[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) ldsm_x4_trans(a[ks], sw128(xs, 16 * ks + lrow + tt, lunit));
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          if (hf == 1 && !upper) break;
          wg_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma_n32<1>(part, a[ks], gdesc + (uint64_t)((ks * 2048 + 64 * hf) >> 4), ks);
          wg_commit();
          wg_wait<0>();
          pin(part);
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) pin(a[ks]);
#pragma unroll
          for (int i = 0; i < 16; ++i) acc[tt][hf][i] += part[i];
        }
      }
      __syncwarp();  // the stage's wgmma are complete: hand it back
      if (lane == 0) mbar_arrive(&empty[slot]);
    }
    float* dst = partial + (size_t)blockIdx.y * 9 * C * O;
#pragma unroll
    for (int tt = 0; tt < 3; ++tt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + 16 * wi + g + 8 * h;
        if (c >= C) continue;
        float* row = dst + ((long)(dd * 3 + tt) * C + c) * O;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int jn = 0; jn < 4; ++jn) {
            const int o = o0 + 32 * hf + 8 * jn + 2 * q;
            if (o < O)
              *reinterpret_cast<float2*>(row + o) =
                  make_float2(acc[tt][hf][4 * jn + 2 * h], acc[tt][hf][4 * jn + 2 * h + 1]);
          }
      }
  }
}

// The driver's cuTensorMapEncodeTiled, through the runtime (the libraries
// are not linked against libcuda), looked up on each call.
inline cudaError_t encode_map(CUtensorMap* map, const void* base, cuuint32_t rank,
                              const cuuint64_t* dims, const cuuint64_t* strides,
                              const cuuint32_t* box) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err =
      cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault,
                                       &found);
#else
  cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                            &found);
#endif
  if (err != cudaSuccess) return err;
  if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn)(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides, box,
      elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A map over a channels-last bf16 map [B, D, T, W] in boxes of 64 channels x
// `rows` time steps of one (b, d): 128-byte swizzle, zeros outside the map.
inline cudaError_t encode_map_bdtw(CUtensorMap* map, const bf16* base, int B, int D, int T, int W,
                                   int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)T, (cuuint64_t)D, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)W * 2, (cuuint64_t)T * W * 2,
                                 (cuuint64_t)D * T * W * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  return encode_map(map, base, 4, dims, strides, box);
}

inline cudaError_t sm_count(int* n) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
}

// The forward's plan for C input and O output channels on route "wgmma":
// output-channel blocks of BN = 64 (O > 32 and the weights of every 64-channel
// chunk fit beside three stages) or 32; the ring fills the rest, up to 8.
// The consumers' waits need 2 stages >= kch + 1 (the stage two uses back of a
// slot is then released when a warpgroup reaches it): at C <= 256 the ring
// holds 3 stages or more, so it holds.
struct FwdPlan {
  int bn, kch, stages, smem;
};

inline FwdPlan fwd_plan(int C, int O) {
  FwdPlan p;
  p.kch = (C + 63) / 64;
  const int room = kSmemLimit - kSmemSlack;
  p.bn = (O > 32 && p.kch * 9 * 64 * kSwRow + 3 * kHaloStage <= room) ? 64 : 32;
  const int wbytes = p.kch * 9 * p.bn * kSwRow;
  p.stages = (room - wbytes) / kHaloStage;
  if (p.stages > kMaxStages) p.stages = kMaxStages;
  p.smem = kSmemSlack + wbytes + p.stages * kHaloStage;
  return p;
}

template <int BN, bool F32OUT>
cudaError_t launch_fwd_wgmma(const CUtensorMap& xmap, const CUtensorMap& wmap, const bf16* add,
                             void* out, int B, int D, int T, int C, int O, const FwdPlan& p,
                             cudaStream_t stream) {
  auto kernel = conv3x3_bf16_fwd_wgmma_kernel<BN, F32OUT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  int sms;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int t_tiles = (T + kTile - 1) / kTile;
  const long tiles = (long)B * D * t_tiles;
  const int n_blocks = (O + BN - 1) / BN;
  long groups = sms / n_blocks;
  if (groups < 1) groups = 1;
  if (groups > tiles) groups = tiles;
  kernel<<<(unsigned)(groups * n_blocks), kFwdThreads, p.smem, stream>>>(
      xmap, wmap, add, out, D, T, C, O, t_tiles, tiles, n_blocks, p.kch, p.stages);
  return cudaGetLastError();
}

template <bool F32OUT>
cudaError_t fwd_wgmma_run(const bf16* x, const bf16* w, bf16* wp, const bf16* add, void* out,
                          int B, int D, int T, int C, int O, cudaStream_t stream) {
  int cpad, opad;
  fwd_pad(C, O, &cpad, &opad);
  const long n = 9L * opad * cpad;
  const unsigned blocks = (unsigned)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  conv3x3_bf16_pack_weights_kernel<<<blocks, 256, 0, stream>>>(w, wp, C, O, cpad, opad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const FwdPlan p = fwd_plan(C, O);
  CUtensorMap xmap, wmap;
  err = encode_map_bdtw(&xmap, x, B, D, T, C, kHaloRows);
  if (err != cudaSuccess) return err;
  // the packed weights [9][opad][cpad] in boxes of 64 channels x BN outputs
  const cuuint64_t wdims[3] = {(cuuint64_t)cpad, (cuuint64_t)opad, 9};
  const cuuint64_t wstrides[2] = {(cuuint64_t)cpad * 2, (cuuint64_t)opad * cpad * 2};
  const cuuint32_t wbox[3] = {64, (cuuint32_t)p.bn, 1};
  err = encode_map(&wmap, wp, 3, wdims, wstrides, wbox);
  if (err != cudaSuccess) return err;
  return p.bn == 64 ? launch_fwd_wgmma<64, F32OUT>(xmap, wmap, add, out, B, D, T, C, O, p, stream)
                    : launch_fwd_wgmma<32, F32OUT>(xmap, wmap, add, out, B, D, T, C, O, p, stream);
}

inline cudaError_t wgrad_wgmma_launch(const bf16* x, const bf16* g, float* part, int B, int D,
                                      int T, int C, int O, int chunks, int rows,
                                      cudaStream_t stream) {
  CUtensorMap xmap, gmap;
  cudaError_t err = encode_map_bdtw(&xmap, x, B, D, T, C, kHaloRows);
  if (err != cudaSuccess) return err;
  err = encode_map_bdtw(&gmap, g, B, D, T, O, kTile);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(conv3x3_bf16_wgrad_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
  if (err != cudaSuccess) return err;
  const int tiles = ((C + 63) / 64) * ((O + 63) / 64);
  conv3x3_bf16_wgrad_wgmma_kernel<<<dim3(tiles, chunks), kWgmmaThreads, kWgSmem, stream>>>(
      xmap, gmap, part, D, T, C, O, (long)B * D, rows);
  return cudaGetLastError();
}

// ------------------------------------------------------------- host side

// bf16 elements of the packed weights' scratch (0 on route "fma").
inline long fwd_scratch_elems(int C, int O) {
  if (C < 1 || O < 1 || fwd_route(C, O) == 0) return 0;
  int cpad, opad;
  fwd_pad(C, O, &cpad, &opad);
  return 9L * cpad * opad;
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// out = conv3x3_same(x, w) for x [B, D, T, C] and w [3, 3, C, O] in bf16, on
// the route of fwd_route(C, O): "wgmma" and "mma" through the packed weights'
// scratch wp of fwd_scratch_elems(C, O) bf16 (16-byte aligned), "fma"
// without it; "wgmma" becomes "mma" where x, out or add is not 16-byte
// aligned.  F32OUT (the tensor-core routes only): out is float [B, D, T, O],
// each element add[] (bf16 [B, D, T, O]) plus the sum; else out is bf16, the
// sum rounded once.  Route "mma": block tiles of 8 warps of 32 x WN, 128 x 64
// for O >= 64, else 256 x 32 or 256 x 16.
template <bool F32OUT>
cudaError_t fwd_run(const bf16* x, const bf16* w, bf16* wp, const bf16* add, void* out, int B,
                    int D, int T, int C, int O, cudaStream_t s) {
  if (B < 1 || D < 1 || T < 1 || C < 1 || O < 1 || (F32OUT && add == nullptr))
    return cudaErrorInvalidValue;
  const int route = fwd_route(C, O);
  if (route != 0) {
    if (wp == nullptr || !aligned16(wp)) return cudaErrorInvalidValue;
    if (route == 2 && aligned16(x) && aligned16(out) && (!F32OUT || aligned16(add)))
      return fwd_wgmma_run<F32OUT>(x, w, wp, add, out, B, D, T, C, O, s);
    if (O >= 64) return launch_fwd_mma<128, 64, 32, F32OUT>(x, w, wp, add, out, B, D, T, C, O, s);
    if (O >= 32) return launch_fwd_mma<256, 32, 32, F32OUT>(x, w, wp, add, out, B, D, T, C, O, s);
    return launch_fwd_mma<256, 16, 16, F32OUT>(x, w, wp, add, out, B, D, T, C, O, s);
  }
  if (F32OUT) return cudaErrorInvalidValue;
  const int t_tiles = (T + kDT - 1) / kDT;
  const dim3 grid((unsigned)((long)B * D * t_tiles), (unsigned)((O + kDN - 1) / kDN));
  conv3x3_bf16_fwd_direct_kernel<<<grid, 256, 0, s>>>(x, w, static_cast<bf16*>(out), D, T, C, O,
                                                        t_tiles);
  return cudaGetLastError();
}

// The weight gradient's route by shape: 0 "narrow" (O <= 8), 2 "wgmma" (C and
// O multiples of 8), else 1 "mma".  wgrad_run takes "mma" in place of
// "wgmma" where x or g is not 16-byte aligned.
inline int wgrad_route(int C, int O) {
  if (conv3x3_tiles::wgrad_route(C, O) == 0) return 0;
  return (C % 8 == 0 && O % 8 == 0) ? 2 : 1;
}

// dw [3, 3, C, O] (f32) of x [B, D, T, C] and g [B, D, T, O] in bf16, through
// the scratch part of chunks * 9 * C * O floats; chunks from
// conv3x3_tiles::wgrad_chunks(C, O, B * D) (K3w's split), the route from
// wgrad_route(C, O).  The partials are added in chunk order.
inline cudaError_t wgrad_run(const bf16* x, const bf16* g, float* dw, float* part, int B, int D,
                             int T, int C, int O, int chunks, cudaStream_t s) {
  if (B < 1 || D < 1 || T < 1 || C < 1 || O < 1 || chunks < 1 || chunks > 65535)
    return cudaErrorInvalidValue;
  const long BD = (long)B * D;
  const int rows = (int)((BD + chunks - 1) / chunks);
  if ((long)(chunks - 1) * rows >= BD) return cudaErrorInvalidValue;
  cudaError_t err;
  if (conv3x3_tiles::wgrad_route(C, O) == 0) {
    using conv3x3_tiles::kNarrowC;
    using conv3x3_tiles::kNarrowGroups;
    const dim3 grid((chunks + kNarrowGroups - 1) / kNarrowGroups, (C + kNarrowC - 1) / kNarrowC);
    if (O <= 4)
      conv3x3_bf16_wgrad_narrow_kernel<4><<<grid, kNarrowC * kNarrowGroups, 0, s>>>(
          x, g, part, D, T, C, O, BD, chunks, rows);
    else
      conv3x3_bf16_wgrad_narrow_kernel<8><<<grid, kNarrowC * kNarrowGroups, 0, s>>>(
          x, g, part, D, T, C, O, BD, chunks, rows);
    err = cudaGetLastError();
  } else if (wgrad_route(C, O) == 2 && aligned16(x) && aligned16(g)) {
    err = wgrad_wgmma_launch(x, g, part, B, D, T, C, O, chunks, rows, s);
  } else {
    const bool vec = C % 8 == 0 && O % 8 == 0 && aligned16(x) && aligned16(g);
    err = vec ? cudaFuncSetAttribute(conv3x3_bf16_wgrad_mma_kernel<true>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmemBytes)
              : cudaFuncSetAttribute(conv3x3_bf16_wgrad_mma_kernel<false>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmemBytes);
    if (err != cudaSuccess) return err;
    const int tiles = ((C + kWgCT - 1) / kWgCT) * ((O + kWgBN - 1) / kWgBN);
    if (vec)
      conv3x3_bf16_wgrad_mma_kernel<true><<<dim3(tiles, chunks), kWgThreads, kWgSmemBytes, s>>>(
          x, g, part, D, T, C, O, BD, rows);
    else
      conv3x3_bf16_wgrad_mma_kernel<false><<<dim3(tiles, chunks), kWgThreads, kWgSmemBytes, s>>>(
          x, g, part, D, T, C, O, BD, rows);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  return conv3x3_tiles::reduce_partials(part, dw, chunks, 9L * C * O, s);
}

}  // namespace conv3x3_bf16
