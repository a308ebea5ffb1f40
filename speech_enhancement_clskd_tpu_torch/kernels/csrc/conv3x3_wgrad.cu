// Weight gradient of the bias-free 3x3 SAME convolution over channels-last
// maps, for Hopper (sm_90a): a split reduction in two deterministic passes.
//
// Replaces speech_enhancement_clskd_tpu/ops/pallas/conv3x3.py::_wgrad_kernel
// (reached through _wgrad_raw).  Same function: for x [B, D, T, C] and the
// incoming gradient g [B, D, T, O],
//     dw[dd, tt, c, o] = sum_{b, d, t} x[b, d+dd-1, t+tt-1, c] * g[b, d, t, o]
// with x read as zero outside [0, D) x [0, T).  All arithmetic is f32 FMA.
//
// What bounds it on this card.  The same 2 * B*D*T * 9C * O operations as the
// forward, against reading x and g once and writing the small [3, 3, C, O]
// result: the f32 FMA rate bounds it at every ABF shape but O = 2.
//
// Design.  The TPU kernel summed into one block over a grid that ran in order.
// CUDA blocks run at the same time, so the B*D freq rows are split into
// chunks (about 1024 blocks in all, at most one chunk per freq row), and
//   1. conv3x3_wgrad_partial_kernel gives each block one chunk and one output
//      tile (CT input channels x BN output channels, all nine shifts), walks
//      its rows in order in tiles of kBT time steps, and writes its partial
//      sum to scratch [chunk, 3, 3, C, O].  Per time tile it stages the x halo
//      (3 freq rows x (kBT + 2) steps x CT) and g (kBT x BN) in shared memory;
//      thread (dd, c group, o group) keeps 3 shifts x 4 x 4 sums in registers
//      and, per time step, reads one float4 of g and three float4s of x for
//      48 FMAs.
//   2. conv3x3_wgrad_reduce_kernel adds the chunks in chunk order.
// No atomics: the split depends only on the shape, so every run on any card
// gives the same bits.  This is K1b's dW_hh pattern (lstm_seq_bwd.cu).
//
// Interface: plain C, bound with ctypes.  conv3x3_wgrad_chunks(C, O, BD) gives
// the number of chunks for B*D = BD freq rows; the caller allocates the
// scratch of chunks * 9 * C * O floats and dw [3, 3, C, O].  conv3x3_wgrad
// returns cudaGetLastError() after each launch.

#include <cuda_runtime.h>

namespace {

constexpr int kBT = 32;             // time steps staged per pass
constexpr int kTargetBlocks = 1024;  // blocks of the partial pass (chunks x tiles)
constexpr int kReduceThreads = 256;

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

// dw[idx] = sum over chunks of partial[chunk][idx], in chunk order.
__global__ void __launch_bounds__(kReduceThreads)
conv3x3_wgrad_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                            int chunks, long n) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float s = 0.0f;
  for (int p = 0; p < chunks; ++p) s += partial[(size_t)p * n + idx];
  dw[idx] = s;
}

// The output tile (CT input x BN output channels) for O output channels.
void tile_of(int O, int* ct, int* bn) {
  if (O >= 32) {
    *ct = 32;
    *bn = 32;
  } else if (O >= 16) {
    *ct = 32;
    *bn = 16;
  } else {
    *ct = 64;
    *bn = 4;
  }
}

template <int CT, int BN>
cudaError_t launch_partial(const float* x, const float* g, float* partial, int D, int T, int C,
                           int O, long BD, int chunks, int rows_per_chunk, cudaStream_t stream) {
  const int tiles = ((C + CT - 1) / CT) * ((O + BN - 1) / BN);
  conv3x3_wgrad_partial_kernel<CT, BN><<<dim3(tiles, chunks), 3 * (CT / 4) * (BN / 4), 0,
                                         stream>>>(x, g, partial, D, T, C, O, BD,
                                                   rows_per_chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" int conv3x3_wgrad_chunks(int C, int O, int BD) {
  if (C < 1 || O < 1 || BD < 1) return 1;
  int ct, bn;
  tile_of(O, &ct, &bn);
  const int tiles = ((C + ct - 1) / ct) * ((O + bn - 1) / bn);
  int chunks = kTargetBlocks / tiles;
  if (chunks < 1) chunks = 1;
  if (chunks > BD) chunks = BD;
  if (chunks > 65535) chunks = 65535;
  const int rows = (BD + chunks - 1) / chunks;
  return (BD + rows - 1) / rows;  // no empty chunk
}

extern "C" int conv3x3_wgrad(const void* x, const void* g, void* dw, void* scratch, int B, int D,
                             int T, int C, int O, int chunks, void* stream) {
  if (B < 1 || D < 1 || T < 1 || C < 1 || O < 1 || chunks < 1 || chunks > 65535)
    return (int)cudaErrorInvalidValue;
  const long BD = (long)B * D;
  const int rows_per_chunk = (int)((BD + chunks - 1) / chunks);
  if ((long)(chunks - 1) * rows_per_chunk >= BD) return (int)cudaErrorInvalidValue;
  const float* xi = static_cast<const float*>(x);
  const float* gi = static_cast<const float*>(g);
  float* part = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int ct, bn;
  tile_of(O, &ct, &bn);
  cudaError_t err;
  if (bn == 32)
    err = launch_partial<32, 32>(xi, gi, part, D, T, C, O, BD, chunks, rows_per_chunk, s);
  else if (bn == 16)
    err = launch_partial<32, 16>(xi, gi, part, D, T, C, O, BD, chunks, rows_per_chunk, s);
  else
    err = launch_partial<64, 4>(xi, gi, part, D, T, C, O, BD, chunks, rows_per_chunk, s);
  if (err != cudaSuccess) return (int)err;
  const long n = 9L * C * O;
  conv3x3_wgrad_reduce_kernel<<<(unsigned)((n + kReduceThreads - 1) / kReduceThreads),
                                kReduceThreads, 0, s>>>(part, static_cast<float*>(dw), chunks,
                                                        n);
  return (int)cudaGetLastError();
}
