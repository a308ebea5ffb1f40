// The SPKD Gram pair, S S^T and T T^T, for Hopper (sm_90a): a split reduction
// over D in two deterministic passes.
//
// Replaces speech_enhancement_clskd_tpu/ops/pallas/gram.py::_gram_pair_kernel
// (reached through _gram_pair_raw).  Same function: for s [B, Ds] and
// t [B, Dt] (Ds and Dt may differ), gs = s s^T and gt = t t^T, [B, B] each,
// summed in f32 FMA.  Nothing is padded in memory: each matrix is read with
// its own length and the columns past it count as zero.
//
// What bounds it on this card.  2 B^2 (Ds + Dt) operations (half of them for
// the upper triangle alone) against reading s and t once: for the SPKD
// strategy's waveforms (B 2..32, D ~528,000) the bytes, at 3.35 TB/s; from
// B ~ 64 the f32 FMA rate.
//
// Design.  The TPU kernel carried one [B, B] block over all D tiles in order.
// CUDA blocks run at the same time, so
//   1. gram_partial_kernel gives each block one chunk of kChunk columns of one
//      matrix (blocks [0, ns) the chunks of s, [ns, ns + nt) those of t: the
//      count depends only on the shape, not on the card).  A block walks its
//      chunk in sub-tiles of KT columns, stages [Bp, KT] (B rounded up to 4,
//      rows past B as zeros) in shared memory with float4 loads where the
//      row length and the pointer allow it, scalar loads otherwise, columns
//      past D as zeros.  Thread (tile, lane) owns one 4 x 4 tile of the upper
//      triangle of 4-row groups and every lanes-th group of 4 columns; per
//      group it reads 8 float4 of shared memory for 64 FMAs.  At the end the
//      block adds its lanes' tiles in lane order and writes the upper
//      triangle (i <= j) of its partial Gram, packed, to scratch.
//   2. gram_reduce_kernel adds a matrix's partials in chunk order and writes
//      each sum to (i, j) and (j, i).
// No atomics; the order of every sum depends only on the shape, so repeated
// runs on any card give the same bits, and the output is exactly symmetric.
//
// Interface: plain C, bound with ctypes.  gram_pair_chunk_cols() and
// gram_pair_max_batch() give kChunk and kMaxBatch; the caller allocates gs,
// gt [B, B] and the scratch of (cdiv(Ds, kChunk) + cdiv(Dt, kChunk)) *
// B (B + 1) / 2 floats.  gram_pair_fwd returns cudaGetLastError() after each
// launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 2048;    // columns per block of pass 1
constexpr int kMaxBatch = 64;   // rows; the tiles of 4 rows fill at most 136 threads
constexpr int kThreads = 256;
constexpr int kStageFloats = 8192;  // [Bp, KT] of one sub-tile, before padding
constexpr int kPad = 4;             // floats after each staged row (keeps float4 alignment)
constexpr int kSmemFloats = 8448;   // max over Bp of Bp * (KT + kPad), at Bp = 64
constexpr int kReduceThreads = 256;

// KT: the largest power of two, at most kChunk, with Bp * KT <= kStageFloats
__host__ __device__ inline int sub_tile_cols(int bp) {
  int kt = kChunk;
  while (bp * kt > kStageFloats) kt >>= 1;
  return kt;
}

// the upper-triangle tile (a, b), a <= b, with index `tile` in row-major order
__device__ inline void tile_rows(int tile, int nb, int* a, int* b) {
  int r = 0;
  while (tile >= nb - r) {
    tile -= nb - r;
    ++r;
  }
  *a = r;
  *b = r + tile;
}

// index of (i, j), i <= j, in the packed upper triangle of a B x B matrix
__host__ __device__ inline int packed(int i, int j, int B) { return i * B - i * (i - 1) / 2 + (j - i); }

__global__ void __launch_bounds__(kThreads)
gram_partial_kernel(const float* __restrict__ s, const float* __restrict__ t,
                    float* __restrict__ partial, int B, long long Ds, long long Dt, int ns) {
  __shared__ __align__(16) float sh[kSmemFloats];
  const bool is_s = (int)blockIdx.x < ns;
  const float* __restrict__ z = is_s ? s : t;
  const long long D = is_s ? Ds : Dt;
  const long long col0 = (long long)(is_s ? blockIdx.x : blockIdx.x - ns) * kChunk;
  const bool vec = (D % 4 == 0) && ((reinterpret_cast<uintptr_t>(z) & 15) == 0);

  const int nb = (B + 3) / 4;
  const int bp = 4 * nb;
  const int kt = sub_tile_cols(bp);
  const int stride = kt + kPad;
  const int tiles = nb * (nb + 1) / 2;
  int lanes = 1;
  while (tiles * lanes * 2 <= kThreads) lanes *= 2;
  const int tid = threadIdx.x;
  const bool computes = tid < tiles * lanes;
  const int tile = tid / lanes, lane = tid % lanes;
  int ta = 0, tb = 0;
  if (computes) tile_rows(tile, nb, &ta, &tb);

  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.0f;

  for (int k0 = 0; k0 < kChunk; k0 += kt) {
    const long long base = col0 + k0;
    if (base >= D) break;  // the rest of the chunk lies past the row: zeros
    if (vec) {
      const int per_row = kt / 4;
      for (int idx = tid; idx < bp * per_row; idx += kThreads) {
        const int r = idx / per_row, c4 = idx % per_row;
        const long long col = base + 4 * c4;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        // D % 4 == 0, so a group of 4 lies wholly inside or wholly past the row
        if (r < B && col < D) v = __ldg(reinterpret_cast<const float4*>(z + r * D + col));
        *reinterpret_cast<float4*>(sh + r * stride + 4 * c4) = v;
      }
    } else {
      for (int idx = tid; idx < bp * kt; idx += kThreads) {
        const int r = idx / kt, c = idx % kt;
        const long long col = base + c;
        sh[r * stride + c] = (r < B && col < D) ? __ldg(z + r * D + col) : 0.0f;
      }
    }
    __syncthreads();
    if (computes) {
      const float* ra = sh + 4 * ta * stride;
      const float* rb = sh + 4 * tb * stride;
      for (int g = lane; g < kt / 4; g += lanes) {
        float4 av[4], bv[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          av[p] = *reinterpret_cast<const float4*>(ra + p * stride + 4 * g);
          bv[p] = *reinterpret_cast<const float4*>(rb + p * stride + 4 * g);
        }
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float a = acc[p][q];
            a = fmaf(av[p].x, bv[q].x, a);
            a = fmaf(av[p].y, bv[q].y, a);
            a = fmaf(av[p].z, bv[q].z, a);
            a = fmaf(av[p].w, bv[q].w, a);
            acc[p][q] = a;
          }
      }
    }
    __syncthreads();
  }

  // the lanes' tiles, added in lane order (tiles * lanes * 16 <= 4096 floats)
  if (computes) {
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) sh[(tile * lanes + lane) * 16 + 4 * p + q] = acc[p][q];
  }
  __syncthreads();
  const int P = B * (B + 1) / 2;
  float* __restrict__ out = partial + (long long)blockIdx.x * P;
  for (int o = tid; o < tiles * 16; o += kThreads) {
    const int tl = o / 16, e = o % 16;
    int a, b;
    tile_rows(tl, nb, &a, &b);
    const int i = 4 * a + e / 4, j = 4 * b + e % 4;
    if (i > j || j >= B) continue;
    float sum = 0.0f;
    for (int l = 0; l < lanes; ++l) sum += sh[(tl * lanes + l) * 16 + e];
    out[packed(i, j, B)] = sum;
  }
}

__global__ void __launch_bounds__(kReduceThreads)
gram_reduce_kernel(const float* __restrict__ partial, float* __restrict__ gs,
                   float* __restrict__ gt, int B, int ns, int nt) {
  const int idx = blockIdx.x * kReduceThreads + threadIdx.x;
  if (idx >= 2 * B * B) return;
  const bool is_s = idx < B * B;
  const int i = (idx % (B * B)) / B, j = idx % B;
  if (j < i) return;
  const int P = B * (B + 1) / 2;
  const int n = is_s ? ns : nt;
  const float* __restrict__ p = partial + (long long)(is_s ? 0 : ns) * P + packed(i, j, B);
  float sum = 0.0f;
#pragma unroll 8
  for (int c = 0; c < n; ++c) sum += p[(long long)c * P];
  float* __restrict__ g = is_s ? gs : gt;
  g[i * B + j] = sum;
  g[j * B + i] = sum;
}

int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

}  // namespace

extern "C" int gram_pair_chunk_cols() { return kChunk; }

extern "C" int gram_pair_max_batch() { return kMaxBatch; }

extern "C" int gram_pair_fwd(const void* s, const void* t, void* gs, void* gt, void* partial, int B,
                             long long Ds, long long Dt, void* stream) {
  if (B < 1 || B > kMaxBatch || Ds < 1 || Dt < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ns = cdiv(Ds, kChunk), nt = cdiv(Dt, kChunk);
  gram_partial_kernel<<<ns + nt, kThreads, 0, st>>>(
      static_cast<const float*>(s), static_cast<const float*>(t), static_cast<float*>(partial), B,
      Ds, Dt, ns);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gram_reduce_kernel<<<cdiv(2LL * B * B, kReduceThreads), kReduceThreads, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(gs), static_cast<float*>(gt), B, ns,
      nt);
  return (int)cudaGetLastError();
}
