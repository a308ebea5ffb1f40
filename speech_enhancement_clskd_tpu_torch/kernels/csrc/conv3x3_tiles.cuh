// Tile code of the bias-free 3x3 SAME convolution over channels-last maps,
// shared by conv3x3_fwd.cu (K3f's route "fma"), conv3x3_wgrad.cu (K3w) and
// abf_block_bwd.cu (K5b's dw2 and its partials' sum).  Each source includes
// this header and is built into its own library; kernels/_build.py hashes the
// headers with the source, so an edit here rebuilds all of them.
//
// Forward FMA tile (K3f's route "fma", see conv3x3_fwd.cu).  A block owns one
// freq row, BM time steps and BN output channels; per chunk of kKC input
// channels the caller stages the input halo xs[3][BM + 2][kKC + 1] (zeros
// outside the map) and stage_weights() the nine weight slices; fma_chunk()
// adds the chunk into each thread's 4 (time) x 4 (channel) register tile;
// store_tile() writes it.
//
// Weight gradient (K3w's design, see conv3x3_wgrad.cu; K5b's dw2 runs it
// too): per-block partial sums over chunks of freq rows, on route "mma"
// (conv3x3_wgrad_mma_kernel, split TF32 on the tensor cores, helpers from
// tf32x3.cuh) for O > 8 and route "narrow" (conv3x3_wgrad_narrow_kernel,
// f32 FMA, one range of rows per thread group) for O <= 8; then
// reduce_partials_kernel adds the partials in partial order.  wgrad_route(),
// wgrad_chunks() and wgrad_run() are the host side.  No atomics: the split
// depends only on the shape, so every run gives the same bits.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "tf32x3.cuh"

namespace conv3x3_tiles {

constexpr int kKC = 8;  // input channels staged per pass
constexpr int kTM = 4;  // time steps per thread
constexpr int kTN = 4;  // output channels per thread (one float4 of weights)
constexpr int kXs = kKC + 1;  // padded stride of one staged time step

template <int BM, int BN>
__host__ __device__ constexpr int fwd_threads() {
  return (BM / kTM) * (BN / kTN);
}

// ws[k][c][o] = w[k, c0 + c, o0 + o] for w [3, 3, C, O], k = dd * 3 + tt;
// zeros past C and O; NT threads stage.
template <int BM, int BN, int NT = fwd_threads<BM, BN>()>
__device__ __forceinline__ void stage_weights(float (*ws)[kKC][BN], const float* __restrict__ w,
                                              int c0, int o0, int C, int O) {
  for (int e = threadIdx.x; e < 9 * kKC * BN; e += NT) {
    const int o = e % BN;
    const int c = (e / BN) % kKC;
    const int k = e / (BN * kKC);
    const int cc = c0 + c, oo = o0 + o;
    ws[k][c][o] = (cc < C && oo < O) ? __ldg(w + ((long)k * C + cc) * O + oo) : 0.0f;
  }
}

// acc[i][j] += sum_{r, c, s} xs[r][ty * kTM + i + s][c] * ws[r * 3 + s][c][tx * kTN + j]:
// per (r, c) a thread reads 6 consecutive staged time steps, which serve the
// 3 time shifts of its 4 rows, and one float4 of weights per shift.
template <int BM, int BN>
__device__ __forceinline__ void fma_chunk(const float (*xs)[BM + 2][kXs],
                                          const float (*ws)[kKC][BN], float (&acc)[kTM][kTN],
                                          int tx, int ty) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < kKC; ++c) {
      float a[kTM + 2];
#pragma unroll
      for (int i = 0; i < kTM + 2; ++i) a[i] = xs[r][ty * kTM + i][c];
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const float4 b = *reinterpret_cast<const float4*>(&ws[r * 3 + s][c][tx * kTN]);
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          acc[i][0] = fmaf(a[i + s], b.x, acc[i][0]);
          acc[i][1] = fmaf(a[i + s], b.y, acc[i][1]);
          acc[i][2] = fmaf(a[i + s], b.z, acc[i][2]);
          acc[i][3] = fmaf(a[i + s], b.w, acc[i][3]);
        }
      }
    }
  }
}

__device__ __forceinline__ void zero_tile(float (&acc)[kTM][kTN]) {
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
}

// out[bd, t0 + ty * kTM + i, o0 + tx * kTN + j] = acc[i][j] inside [T) x [O).
__device__ __forceinline__ void store_tile(float* __restrict__ out, const float (&acc)[kTM][kTN],
                                           long bd, int t0, int T, int o0, int O, int tx,
                                           int ty) {
  const int oc = o0 + tx * kTN;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int t = t0 + ty * kTM + i;
    if (t >= T) break;
    float* dst = out + (bd * T + t) * (long)O + oc;
#pragma unroll
    for (int j = 0; j < kTN; ++j)
      if (oc + j < O) dst[j] = acc[i][j];
  }
}

// ---- weight gradient: dw[dd, tt, c, o] = sum_{b, d, t} x[b, d+dd-1, t+tt-1, c] g[b, d, t, o]

constexpr int kTargetBlocks = 1024;  // blocks of the partial pass (chunks x tiles)
constexpr int kReduceThreads = 256;

// Route "mma" (O > 8): the GEMM dw[(dd, tt, c), o] = sum_m x_shifted[m, c] g[m, o]
// over the pixels m on the tensor cores in split TF32 (tf32x3.cuh).  A block
// owns one chunk of freq rows and an output tile of kWgCT input channels x
// kWgBN output channels x all nine shifts; 6 warps, warp (dd, m tile) holding
// the 16 x 32 tiles of its three time shifts (3 x 4 m16n8 fragments).
constexpr int kWgCT = 32;                 // input channels of a block: 2 m16 tiles
constexpr int kWgBN = 32;                 // output channels of a block: 4 n8 tiles
constexpr int kWgBT = 64;                 // time steps a stage: 8 k8 steps
constexpr int kWgWarps = 6;               // (dd, m tile)
constexpr int kWgThreads = kWgWarps * 32;
constexpr int kWgXs = kWgCT + 4;          // padded stride of a staged time step of x
constexpr int kWgGs = kWgBN + 4;          // padded stride of a staged time step of g
constexpr int kWgXsFloats = 3 * (kWgBT + 2) * kWgXs;
constexpr int kWgStageFloats = kWgXsFloats + kWgBT * kWgGs;
constexpr int kWgStages = 2;
constexpr int kWgSmemBytes = kWgStages * kWgStageFloats * (int)sizeof(float);

// One stage (freq row bd, time steps t0 .. t0 + kWgBT - 1) into shared memory
// by cp.async: the x halo xs[r][j][c] = x[b, d + r - 1, t0 + j - 1, c0 + c]
// and gs[j][o] = g[b, d, t0 + j, o0 + o], zeros outside the map, past T, C
// and O.  VEC: 16-byte copies (C and O multiples of 4, x and g aligned).
template <bool VEC>
__device__ __forceinline__ void wgrad_stage(float* xs, float* gs, const float* __restrict__ x,
                                            const float* __restrict__ g, long bd, int t0,
                                            int c0, int o0, int D, int T, int C, int O) {
  constexpr int kV = VEC ? 4 : 1;  // floats a copy
  const int d = (int)(bd % D);
  for (int e = threadIdx.x; e < 3 * (kWgBT + 2) * (kWgCT / kV); e += kWgThreads) {
    const int c = (e % (kWgCT / kV)) * kV;
    const int j = (e / (kWgCT / kV)) % (kWgBT + 2);
    const int r = e / ((kWgCT / kV) * (kWgBT + 2));
    const int dr = d + r - 1, t = t0 + j - 1, cc = c0 + c;
    const bool valid = dr >= 0 && dr < D && t >= 0 && t < T && cc < C;
    const float* src = valid ? x + ((bd + r - 1) * T + t) * (long)C + cc : x;
    tf32x3::cp_async<4 * kV>(xs + (r * (kWgBT + 2) + j) * kWgXs + c, src, valid);
  }
  for (int e = threadIdx.x; e < kWgBT * (kWgBN / kV); e += kWgThreads) {
    const int o = (e % (kWgBN / kV)) * kV;
    const int j = e / (kWgBN / kV);
    const int t = t0 + j, oo = o0 + o;
    const bool valid = t < T && oo < O;
    const float* src = valid ? g + (bd * T + t) * (long)O + oo : g;
    tf32x3::cp_async<4 * kV>(gs + j * kWgGs + o, src, valid);
  }
}

// One staged stage into a warp's fragments, from zero: part[s][nt] of shift
// (dd = r, tt = s), channels c0 + 16 mt .. + 15 and output channels 8 nt ..
// 8 nt + 7 of the block's tile.  The product's rows are channels, its
// columns output channels and its k the stage's time steps.  Fragment
// layouts of the PTX ISA, with g = lane / 4 and q = lane % 4:
//   A (m16 x k8, row): a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4)
//   B (k8 x n8, col): b0 (q, g), b1 (q + 4, g)
// A k8 step's k = q and q + 4 stand for time steps 2q and 2q + 1 (A and B
// agree, and the sum over k does not care which step each k is).  Shift tt
// reads halo row tau + tt for time step tau, so the three shifts of a lane
// need halo rows 2q .. 2q + 3 of its two channels: 8 values, split once and
// used by all three.  Bank conflicts: none; a lane's reads fall on word
// 36 (2q + i) + g (+ 8) of a stride of 36 floats, i.e. banks 8q + g (+ 4i).
__device__ __forceinline__ void wgrad_mma_stage(const float* xs, const float* gs,
                                                float (&part)[3][4][4], int r, int mt, int g,
                                                int q) {
#pragma unroll
  for (int ks = 0; ks < kWgBT / 8; ++ks) {
    const float* xr = xs + (r * (kWgBT + 2) + ks * 8 + 2 * q) * kWgXs + mt * 16 + g;
    uint32_t xh[2][4], xl[2][4];  // [channel g, g + 8][halo row 2q + i]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      tf32x3::split_tf32(xr[i * kWgXs], xh[0][i], xl[0][i]);
      tf32x3::split_tf32(xr[i * kWgXs + 8], xh[1][i], xl[1][i]);
    }
    const float* gr = gs + (ks * 8 + 2 * q) * kWgGs + g;
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      tf32x3::split_tf32(gr[nt * 8], bh[nt][0], bl[nt][0]);
      tf32x3::split_tf32(gr[kWgGs + nt * 8], bh[nt][1], bl[nt][1]);
    }
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const uint32_t ah[4] = {xh[0][s], xh[1][s], xh[0][s + 1], xh[1][s + 1]};
      const uint32_t al[4] = {xl[0][s], xl[1][s], xl[0][s + 1], xl[1][s + 1]};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) tf32x3::mma_3xtf32(part[s][nt], ah, al, bh[nt], bl[nt]);
    }
  }
}

// Route "mma"'s pass 1: block (output tile blockIdx.x, chunk blockIdx.y)
// walks the chunk's freq rows and their time tiles in order, each stage
// staged by cp.async into a ring of two while the tensor cores work on the
// other.  The tensor cores add into their accumulator with truncation, so
// each stage's 64 time steps (24 products a fragment) go into `part` from
// zero and `acc` adds the stages with round-to-nearest f32 adds.  Writes
// partial[chunk, 3, 3, C, O] for the tile.  C/D fragment: d0 (g, 2q), d1
// (g, 2q + 1), d2 (g + 8, 2q), d3 (g + 8, 2q + 1).
template <bool VEC>
__global__ void __launch_bounds__(kWgThreads, 2)
conv3x3_wgrad_mma_kernel(const float* __restrict__ x, const float* __restrict__ g,
                         float* __restrict__ partial, int D, int T, int C, int O, long BD,
                         int rows_per_chunk) {
  extern __shared__ __align__(16) float smem[];
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

  wgrad_stage<VEC>(smem, smem + kWgXsFloats, x, g, row_begin, 0, c0, o0, D, T, C, O);
  tf32x3::cp_async_commit();
  for (int st = 0; st < stages; ++st) {
    if (st + 1 < stages) {
      float* next = smem + ((st + 1) % kWgStages) * kWgStageFloats;
      wgrad_stage<VEC>(next, next + kWgXsFloats, x, g, row_begin + (st + 1) / t_tiles,
                       ((st + 1) % t_tiles) * kWgBT, c0, o0, D, T, C, O);
      tf32x3::cp_async_commit();
      tf32x3::cp_async_wait<1>();
    } else {
      tf32x3::cp_async_wait<0>();
    }
    __syncthreads();
    const float* cur = smem + (st % kWgStages) * kWgStageFloats;
#pragma unroll
    for (int s = 0; s < 3; ++s)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[s][nt][i] = 0.0f;
    wgrad_mma_stage(cur, cur + kWgXsFloats, part, r, mt, gl, q);
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

// For O <= OMAX <= 8 output channels, where a tile of output channels would
// leave most of its threads idle: thread (c, group) owns input channel c and
// one contiguous range of freq rows (a unit), walks each row along time with
// the 3 x 3 window x[d-1..d+1, t-1..t+1, c] in registers (3 new values a
// step, coalesced over c), reads g[b, d, t, :] (the same for every c) and
// keeps 9 x OMAX sums.  Writes partial[unit, 3, 3, C, O] for its channels.
constexpr int kNarrowC = 64;      // input channels of a block
constexpr int kNarrowGroups = 4;  // units of a block
constexpr int kNarrowUnits = 4096;

template <int OMAX>
__global__ void __launch_bounds__(kNarrowC * kNarrowGroups)
conv3x3_wgrad_narrow_kernel(const float* __restrict__ x, const float* __restrict__ g,
                            float* __restrict__ partial, int D, int T, int C, int O, long BD,
                            int units, int rows_per_unit) {
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
    const float* xr[3];
    bool ok[3];
    float w[3][3];  // w[r][s] = x[b, d + r - 1, t + s - 1, c]
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      ok[r] = d + r - 1 >= 0 && d + r - 1 < D;
      xr[r] = ok[r] ? x + (bd + r - 1) * T * (long)C + c : x;
      w[r][0] = 0.0f;
      w[r][1] = ok[r] ? __ldg(xr[r]) : 0.0f;
      w[r][2] = ok[r] && T > 1 ? __ldg(xr[r] + C) : 0.0f;
    }
    const float* gr = g + bd * T * (long)O;
#pragma unroll 2
    for (int t = 0; t < T; ++t) {
      float gv[OMAX];
#pragma unroll
      for (int o = 0; o < OMAX; ++o) gv[o] = o < O ? __ldg(gr + (long)t * O + o) : 0.0f;
      float nx[3];
#pragma unroll
      for (int r = 0; r < 3; ++r)
        nx[r] = ok[r] && t + 2 < T ? __ldg(xr[r] + (long)(t + 2) * C) : 0.0f;
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

// out[idx] = sum over p of partial[p][idx], in p order.
__global__ void __launch_bounds__(kReduceThreads)
reduce_partials_kernel(const float* __restrict__ partial, float* __restrict__ out, int parts,
                       long n) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float s = 0.0f;
  for (int p = 0; p < parts; ++p) s += partial[(size_t)p * n + idx];
  out[idx] = s;
}

inline cudaError_t reduce_partials(const float* partial, float* out, int parts, long n,
                                   cudaStream_t stream) {
  reduce_partials_kernel<<<(unsigned)((n + kReduceThreads - 1) / kReduceThreads),
                           kReduceThreads, 0, stream>>>(partial, out, parts, n);
  return cudaGetLastError();
}

// The route of a shape: 0 "narrow" (O <= 8, conv3x3_wgrad_narrow_kernel),
// 1 "mma" (conv3x3_wgrad_mma_kernel).  By shape alone.
inline int wgrad_route(int C, int O) { return O <= 8 ? 0 : 1; }

// The number of partials (chunks or units of freq rows) for B*D = BD rows
// (none empty).
inline int wgrad_chunks(int C, int O, int BD) {
  if (C < 1 || O < 1 || BD < 1) return 1;
  if (wgrad_route(C, O) == 0) {
    const int units = BD < kNarrowUnits ? BD : kNarrowUnits;
    const int rows = (BD + units - 1) / units;
    return (BD + rows - 1) / rows;
  }
  const int tiles = ((C + kWgCT - 1) / kWgCT) * ((O + kWgBN - 1) / kWgBN);
  int chunks = kTargetBlocks / tiles;
  if (chunks < 1) chunks = 1;
  if (chunks > BD) chunks = BD;
  if (chunks > 65535) chunks = 65535;
  const int rows = (BD + chunks - 1) / chunks;
  return (BD + rows - 1) / rows;
}

template <bool VEC>
cudaError_t launch_wgrad_mma(const float* x, const float* g, float* partial, int D, int T, int C,
                             int O, long BD, int chunks, int rows_per_chunk,
                             cudaStream_t stream) {
  // Above 48 KB needs the opt-in, set on every call: a flag remembering it
  // would be a static of this inline function, which the dynamic linker
  // shares between K3w's and K5b's libraries (STB_GNU_UNIQUE) while each
  // library holds its own copy of the kernel.
  const cudaError_t err = cudaFuncSetAttribute(
      conv3x3_wgrad_mma_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmemBytes);
  if (err != cudaSuccess) return err;
  const int tiles = ((C + kWgCT - 1) / kWgCT) * ((O + kWgBN - 1) / kWgBN);
  conv3x3_wgrad_mma_kernel<VEC><<<dim3(tiles, chunks), kWgThreads, kWgSmemBytes, stream>>>(
      x, g, partial, D, T, C, O, BD, rows_per_chunk);
  return cudaGetLastError();
}

template <int OMAX>
cudaError_t launch_wgrad_narrow(const float* x, const float* g, float* partial, int D, int T,
                                int C, int O, long BD, int units, int rows_per_unit,
                                cudaStream_t stream) {
  const dim3 grid((units + kNarrowGroups - 1) / kNarrowGroups, (C + kNarrowC - 1) / kNarrowC);
  conv3x3_wgrad_narrow_kernel<OMAX><<<grid, kNarrowC * kNarrowGroups, 0, stream>>>(
      x, g, partial, D, T, C, O, BD, units, rows_per_unit);
  return cudaGetLastError();
}

// dw [3, 3, C, O] of x [B, D, T, C] and g [B, D, T, O], through scratch of
// chunks * 9 * C * O floats; chunks (the partials) from wgrad_chunks(), the
// route from wgrad_route().
inline cudaError_t wgrad_run(const float* x, const float* g, float* dw, float* scratch, int B,
                             int D, int T, int C, int O, int chunks, cudaStream_t stream) {
  if (B < 1 || D < 1 || T < 1 || C < 1 || O < 1 || chunks < 1 || chunks > 65535)
    return cudaErrorInvalidValue;
  const long BD = (long)B * D;
  const int rows_per_chunk = (int)((BD + chunks - 1) / chunks);
  if ((long)(chunks - 1) * rows_per_chunk >= BD) return cudaErrorInvalidValue;
  cudaError_t err;
  if (wgrad_route(C, O) == 0) {
    err = O <= 4 ? launch_wgrad_narrow<4>(x, g, scratch, D, T, C, O, BD, chunks, rows_per_chunk,
                                          stream)
                 : launch_wgrad_narrow<8>(x, g, scratch, D, T, C, O, BD, chunks, rows_per_chunk,
                                          stream);
  } else {
    const bool vec = C % 4 == 0 && O % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(g) % 16 == 0;
    err = vec ? launch_wgrad_mma<true>(x, g, scratch, D, T, C, O, BD, chunks, rows_per_chunk,
                                       stream)
              : launch_wgrad_mma<false>(x, g, scratch, D, T, C, O, BD, chunks, rows_per_chunk,
                                        stream);
  }
  if (err != cudaSuccess) return err;
  return reduce_partials(scratch, dw, chunks, 9L * C * O, stream);
}

}  // namespace conv3x3_tiles
