// The bf16 tensor-core tile of the bias-free 3x3 SAME convolution over
// channels-last bf16 maps and its weight gradient (the bf16 K3f and K3w; see
// conv3x3_bf16.cu for their design), shared by conv3x3_bf16.cu (K3f, K3w),
// abf_block_fwd.cu (the bf16 K5f's conv over xf) and abf_block_bwd.cu (the
// bf16 K5b's conv adjoint over g_out, with g_xf added in the epilogue into a
// float32 dxf, and its dw2).  Each source includes this header and is built
// into its own library; kernels/_build.py hashes the headers with the source,
// so an edit here rebuilds every library.
//
// fwd_run<F32OUT>() and wgrad_run() are the host side; fwd_route(C, O) says
// whether a shape takes the tensor-core tile (O >= 8 and C >= 8) or the FMA
// kernel, fwd_scratch_elems(C, O) the packed weights' scratch.  Nothing here
// holds state between calls: the shared-memory opt-in is set on every call
// (a function-local static of header code would be shared by the dynamic
// linker between the libraries, STB_GNU_UNIQUE, while each library has its
// own kernels).

#pragma once

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

inline int fwd_route(int C, int O) { return (O >= 8 && C >= 8) ? 1 : 0; }
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

// ------------------------------------------------------------- host side

// bf16 elements of the packed weights' scratch (0 on route "fma").
inline long fwd_scratch_elems(int C, int O) {
  if (C < 1 || O < 1 || fwd_route(C, O) == 0) return 0;
  int cpad, opad;
  fwd_pad(C, O, &cpad, &opad);
  return 9L * cpad * opad;
}

// out = conv3x3_same(x, w) for x [B, D, T, C] and w [3, 3, C, O] in bf16, on
// the route of fwd_route(C, O): "mma" through the packed weights' scratch wp
// of fwd_scratch_elems(C, O) bf16 (16-byte aligned), "fma" without it.
// F32OUT (route "mma" only): out is float [B, D, T, O], each element add[]
// (bf16 [B, D, T, O]) plus the sum; else out is bf16, the sum rounded once.
// Block tiles of 8 warps of 32 x WN: 128 x 64 for O >= 64, else 256 x 32 or
// 256 x 16.
template <bool F32OUT>
cudaError_t fwd_run(const bf16* x, const bf16* w, bf16* wp, const bf16* add, void* out, int B,
                    int D, int T, int C, int O, cudaStream_t s) {
  if (B < 1 || D < 1 || T < 1 || C < 1 || O < 1 || (F32OUT && add == nullptr))
    return cudaErrorInvalidValue;
  if (fwd_route(C, O) == 1) {
    if (wp == nullptr || reinterpret_cast<uintptr_t>(wp) % 16 != 0) return cudaErrorInvalidValue;
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

// dw [3, 3, C, O] (f32) of x [B, D, T, C] and g [B, D, T, O] in bf16, through
// the scratch part of chunks * 9 * C * O floats; chunks from
// conv3x3_tiles::wgrad_chunks(C, O, B * D), the route from
// conv3x3_tiles::wgrad_route(C, O) ("narrow" for O <= 8, else "mma").  The
// partials are added in chunk order.
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
  } else {
    const bool vec = C % 8 == 0 && O % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(g) % 16 == 0;
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
