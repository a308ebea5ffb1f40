// Tile code of the bias-free 3x3 SAME convolution over channels-last maps,
// shared by conv3x3_fwd.cu (K3f), conv3x3_wgrad.cu (K3w) and the whole-ABF-
// block kernels abf_block_fwd.cu (K5f) and abf_block_bwd.cu (K5b).  Each
// source includes this header and is built into its own library;
// kernels/_build.py hashes the headers with the source, so an edit here
// rebuilds all four.
//
// Forward tile (K3f's design, see conv3x3_fwd.cu).  A block owns one freq row,
// BM time steps and BN output channels; per chunk of kKC input channels the
// caller stages the input halo xs[3][BM + 2][kKC + 1] (zeros outside the map)
// and stage_weights() the nine weight slices; fma_chunk() adds the chunk into
// each thread's 4 (time) x 4 (channel) register tile; store_tile() writes it.
//
// Weight gradient (K3w's design, see conv3x3_wgrad.cu):
// conv3x3_wgrad_partial_kernel sums one chunk of freq rows per block into a
// partial (conv3x3_wgrad_narrow_kernel one range of rows per thread group,
// for O <= 8), and reduce_partials_kernel adds partials in partial order.  wgrad_chunks() and
// wgrad_run() are the host side.  No atomics: the split depends only on the
// shape, so every run gives the same bits.

#pragma once

#include <cuda_runtime.h>

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

constexpr int kBT = 32;              // time steps staged per pass
constexpr int kTargetBlocks = 1024;  // blocks of the partial pass (chunks x tiles)
constexpr int kReduceThreads = 256;

// Each block: one chunk of freq rows (blockIdx.y) and one output tile (CT input
// x BN output channels, all nine shifts); thread (dd, c group, o group) keeps
// 3 shifts x 4 x 4 sums in registers.  Writes partial[chunk, 3, 3, C, O].
template <int CT, int BN>
__global__ void __launch_bounds__(3 * (CT / 4) * (BN / 4))
conv3x3_wgrad_partial_kernel(const float* __restrict__ x, const float* __restrict__ g,
                             float* __restrict__ partial, int D, int T, int C, int O, long BD,
                             int rows_per_chunk) {
  constexpr int kThreads = 3 * (CT / 4) * (BN / 4);
  __shared__ __align__(16) float xs[3][kBT + 2][CT];
  __shared__ __align__(16) float gs[kBT][BN];

  const int tiles_o = (O + BN - 1) / BN;
  const int c0 = (blockIdx.x / tiles_o) * CT;
  const int o0 = (blockIdx.x % tiles_o) * BN;
  const int og = threadIdx.x % (BN / 4);
  const int cg = (threadIdx.x / (BN / 4)) % (CT / 4);
  const int dd = threadIdx.x / ((BN / 4) * (CT / 4));
  const long row_begin = (long)blockIdx.y * rows_per_chunk;
  const long row_end = row_begin + rows_per_chunk < BD ? row_begin + rows_per_chunk : BD;

  float acc[3][4][4];
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[s][i][j] = 0.0f;

  for (long bd = row_begin; bd < row_end; ++bd) {
    const int d = (int)(bd % D);
    for (int t0 = 0; t0 < T; t0 += kBT) {
      // xs[r][j][c] = x[b, d + r - 1, t0 + j - 1, c0 + c]
      for (int e = threadIdx.x; e < 3 * (kBT + 2) * CT; e += kThreads) {
        const int c = e % CT;
        const int j = (e / CT) % (kBT + 2);
        const int r = e / (CT * (kBT + 2));
        const int dr = d + r - 1, t = t0 + j - 1, cc = c0 + c;
        float v = 0.0f;
        if (dr >= 0 && dr < D && t >= 0 && t < T && cc < C)
          v = __ldg(x + ((bd + r - 1) * T + t) * (long)C + cc);
        xs[r][j][c] = v;
      }
      // gs[j][o] = g[b, d, t0 + j, o0 + o]
      for (int e = threadIdx.x; e < kBT * BN; e += kThreads) {
        const int o = e % BN;
        const int j = e / BN;
        const int t = t0 + j, oo = o0 + o;
        gs[j][o] = (t < T && oo < O) ? __ldg(g + (bd * T + t) * (long)O + oo) : 0.0f;
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kBT; ++j) {
        const float4 gv = *reinterpret_cast<const float4*>(&gs[j][og * 4]);
#pragma unroll
        for (int s = 0; s < 3; ++s) {
          const float4 xv = *reinterpret_cast<const float4*>(&xs[dd][j + s][cg * 4]);
          const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[s][i][0] = fmaf(xa[i], gv.x, acc[s][i][0]);
            acc[s][i][1] = fmaf(xa[i], gv.y, acc[s][i][1]);
            acc[s][i][2] = fmaf(xa[i], gv.z, acc[s][i][2]);
            acc[s][i][3] = fmaf(xa[i], gv.w, acc[s][i][3]);
          }
        }
      }
      __syncthreads();
    }
  }

  float* dst = partial + (size_t)blockIdx.y * 9 * C * O;
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + cg * 4 + i;
      if (c >= C) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = o0 + og * 4 + j;
        if (o < O) dst[((long)(dd * 3 + s) * C + c) * O + o] = acc[s][i][j];
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

// The output tile (CT input x BN output channels) for O > 8 output channels
// (conv3x3_wgrad_narrow_kernel takes O <= 8).
inline void wgrad_tile_of(int O, int* ct, int* bn) {
  *ct = 32;
  *bn = O >= 32 ? 32 : 16;
}

// The number of partials (chunks or units of freq rows) for B*D = BD rows
// (none empty).
inline int wgrad_chunks(int C, int O, int BD) {
  if (C < 1 || O < 1 || BD < 1) return 1;
  if (O <= 8) {
    const int units = BD < kNarrowUnits ? BD : kNarrowUnits;
    const int rows = (BD + units - 1) / units;
    return (BD + rows - 1) / rows;
  }
  int ct, bn;
  wgrad_tile_of(O, &ct, &bn);
  const int tiles = ((C + ct - 1) / ct) * ((O + bn - 1) / bn);
  int chunks = kTargetBlocks / tiles;
  if (chunks < 1) chunks = 1;
  if (chunks > BD) chunks = BD;
  if (chunks > 65535) chunks = 65535;
  const int rows = (BD + chunks - 1) / chunks;
  return (BD + rows - 1) / rows;
}

template <int CT, int BN>
cudaError_t launch_wgrad_partial(const float* x, const float* g, float* partial, int D, int T,
                                 int C, int O, long BD, int chunks, int rows_per_chunk,
                                 cudaStream_t stream) {
  const int tiles = ((C + CT - 1) / CT) * ((O + BN - 1) / BN);
  conv3x3_wgrad_partial_kernel<CT, BN><<<dim3(tiles, chunks), 3 * (CT / 4) * (BN / 4), 0,
                                         stream>>>(x, g, partial, D, T, C, O, BD,
                                                   rows_per_chunk);
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
// chunks * 9 * C * O floats; chunks (the partials) from wgrad_chunks().
inline cudaError_t wgrad_run(const float* x, const float* g, float* dw, float* scratch, int B,
                             int D, int T, int C, int O, int chunks, cudaStream_t stream) {
  if (B < 1 || D < 1 || T < 1 || C < 1 || O < 1 || chunks < 1 || chunks > 65535)
    return cudaErrorInvalidValue;
  const long BD = (long)B * D;
  const int rows_per_chunk = (int)((BD + chunks - 1) / chunks);
  if ((long)(chunks - 1) * rows_per_chunk >= BD) return cudaErrorInvalidValue;
  if (O <= 8) {
    const cudaError_t err =
        O <= 4 ? launch_wgrad_narrow<4>(x, g, scratch, D, T, C, O, BD, chunks, rows_per_chunk,
                                        stream)
               : launch_wgrad_narrow<8>(x, g, scratch, D, T, C, O, BD, chunks, rows_per_chunk,
                                        stream);
    if (err != cudaSuccess) return err;
    return reduce_partials(scratch, dw, chunks, 9L * C * O, stream);
  }
  int ct, bn;
  wgrad_tile_of(O, &ct, &bn);
  cudaError_t err;
  if (bn == 32)
    err = launch_wgrad_partial<32, 32>(x, g, scratch, D, T, C, O, BD, chunks, rows_per_chunk,
                                       stream);
  else
    err = launch_wgrad_partial<32, 16>(x, g, scratch, D, T, C, O, BD, chunks, rows_per_chunk,
                                       stream);
  if (err != cudaSuccess) return err;
  return reduce_partials(scratch, dw, chunks, 9L * C * O, stream);
}

}  // namespace conv3x3_tiles
