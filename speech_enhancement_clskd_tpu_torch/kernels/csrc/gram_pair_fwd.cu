// The SPKD Gram pair, S S^T and T T^T, for Hopper (sm_90a): a pipelined split
// reduction over D on f32 FMA register tiles, then a parallel fixed-order sum
// of the partials.
//
// Replaces speech_enhancement_clskd_tpu/ops/pallas/gram.py::_gram_pair_kernel
// (reached through _gram_pair_raw).  Same function: for s [B, Ds] and
// t [B, Dt] (Ds and Dt may differ), gs = s s^T and gt = t t^T, [B, B] each,
// float32 in and out.  Nothing is padded in memory: each matrix is read with
// its own length and the columns past it count as zero.
//
// What bounds it on this card.  Reading s and t once, 4 B (Ds + Dt) bytes at
// 3.35 TB/s, against B^2 (Ds + Dt) multiply-adds for the upper triangles: for
// the spkd strategy's waveforms (B 2..64, D ~528,000) the bytes up to B ~ 50,
// f32 FMA at 67 TFLOP/s above.  On the tensor cores, three TF32 (or six
// BF16) products a multiply-add through mma.sync ran no faster than f32 FMA
// on these tiles at any B (PERF.md).
//
// Design.  The TPU kernel carried one [B, B] block over all D tiles in order.
// CUDA blocks run at the same time, so
//   1. gram_partial_kernel splits each matrix into chunks of kChunk columns
//      (chunks [0, ns) of s, then [ns, ns + nt) of t: the count depends only on
//      the shape).  One persistent block an SM walks the chunks with a fixed
//      stride and writes each chunk's partial Gram (its upper triangle,
//      packed) to the chunk's own slot, so no sum depends on the grid size.
//      The block's last warp is the producer: it keeps a ring of stages of
//      [Bp, KT] (Bp = B rounded up to the row tile, rows past B zero) full,
//      one 1-D bulk asynchronous copy a staged row where D % 4 == 0 and the
//      base is 16-byte aligned, 4-byte cp.async with zero-fill otherwise; each
//      stage completes on an mbarrier ("full"), and the consumers free it on
//      another ("empty").  The other warps consume.  A thread owns a unit of
//      the upper triangle of Z Z^T, an R x R tile (R = 4 to B = 16, 8 above)
//      or, above B = 32, the upper triangles of two diagonal blocks, and every
//      L-th group of 4 columns (L = 32 lanes a unit to B = 32, 8 above); a
//      group is 2R float4 loads of shared memory for up to 4 R^2 FMA, and the
//      units fill whole warps with equal work.  At a chunk's end the L
//      lanes of a unit add their sums by recursive halving over warp shuffles
//      (a fixed tree), and each lane writes the sums it ends with.
//   2. gram_sum_kernel adds each matrix's partials in chunk order, one
//      thread a packed element, as the TPU kernel and the plain version do:
//      a block's warps stage up to kSumSpan chunks' partials of its 32
//      elements in shared memory, all loads in flight at once, and its first
//      warp adds them in order; it writes each sum to (i, j) and (j, i).  It
//      is launched as a programmatic dependent of pass 1 and waits on it
//      (griddepcontrol), so its launch overlaps the end of pass 1.
// No atomics; the order of every sum depends only on the shape, so repeated
// runs on any card give the same bits, and the output is exactly symmetric.
//
// The bf16 K2 (bf16 products on the tensor cores) is gram_pair_bf16.cu.
//
// Interface: plain C, bound with ctypes.  gram_pair_chunk_cols() and
// gram_pair_max_batch() give kChunk and kMaxBatch.  The caller allocates one buffer of 2 B^2 + (cdiv(Ds, kChunk) + cdiv(Dt,
// kChunk)) * B (B + 1) / 2 floats: gs, then gt, then the partials.
// gram_pair_fwd returns cudaGetLastError() after each launch.

#include <cuda_runtime.h>

#include <cstdint>

#include "tf32x3.cuh"

namespace {

constexpr int kChunk = 2048;  // columns of one partial
constexpr int kMaxBatch = 64;
constexpr int kSumWarps = 16;   // pass 2: warps a block
constexpr int kSumSpan = 320;   // pass 2: chunks a block stages at a time (655,360 columns)
constexpr int kMaxDevices = 64;
constexpr int kRingBudget = 200 * 1024;  // bytes of shared memory for the ring

// R x R register tiles over NB row blocks, L lanes a unit, KT columns a
// stage.  Where several units share a warp (L < 32) the diagonal blocks go in
// pairs, so that the units (off-diagonal tiles, then pairs) fill whole warps
// of equal work; with a warp a unit, whole tiles keep more warps busy.
template <int R, int NB, int L, int KT>
struct Plan {
  static constexpr int kR = R, kNB = NB, kL = L, kKT = KT;
  static constexpr int kBp = R * NB;
  static constexpr int kStride = KT + 4;  // floats a staged row (4-wide and bulk-copy aligned)
  static constexpr int kPairs = L < 32 && NB % 2 == 0 ? NB / 2 : 0;
  static constexpr int kOff = kPairs > 0 ? NB * (NB - 1) / 2 : NB * (NB + 1) / 2;  // tile units
  static constexpr int kPerWarp = 32 / L;
  static constexpr int kTileSlots = (kOff + kPerWarp - 1) / kPerWarp * kPerWarp;
  static constexpr int kPairSlots = (kPairs + kPerWarp - 1) / kPerWarp * kPerWarp;
  static constexpr int kWarps = (kTileSlots + kPairSlots) / kPerWarp;
  static constexpr int kStageBytes = kBp * kStride * 4;
  static constexpr int kStages = kRingBudget / kStageBytes < 12 ? kRingBudget / kStageBytes : 12;
};

template <class P>
struct Layout {
  static constexpr int kThreads = 32 * (P::kWarps + 1);
  static constexpr int kRingBytes = P::kStages * P::kStageBytes;
  static constexpr int kSmemBytes = kRingBytes + 2 * P::kStages * 8;
};

// the FMA tile (a, b), a <= b, with index `tile` in row-major order over nb blocks
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

__device__ inline void unpack(int e, int B, int* i, int* j) {
  int r = 0, start = 0;
  while (e >= start + (B - r)) {
    start += B - r;
    ++r;
  }
  *i = r;
  *j = r + (e - start);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// bytes from global src to shared dst, completing as tx bytes on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// bar tracks this thread's earlier cp.async copies as one of its arrivals
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// four staged columns
__device__ __forceinline__ float4 staged4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// The producer warp: fills the ring in the order the consumers read it.  A
// staged row is one bulk copy where the row length is whole 16-byte units and
// the base is 16-byte aligned; otherwise 4-byte cp.async.
template <class P>
__device__ void produce(float* ring, uint64_t* full, uint64_t* empty, const float* __restrict__ s,
                        const float* __restrict__ t, int B, long long Ds, long long Dt, int ns, int nchunks,
                        int lane) {
  constexpr int kKT = P::kKT, kStride = P::kStride, kBp = P::kBp, kStages = P::kStages;
  int fill = 0;
  // the slots this warp or its cp.async copies last wrote through the generic
  // proxy: a proxy fence before the next bulk copy into them
  unsigned generic = 0;
  for (int c = blockIdx.x; c < nchunks; c += gridDim.x) {
    const bool is_s = c < ns;
    const float* __restrict__ z = is_s ? s : t;
    const long long D = is_s ? Ds : Dt;
    const long long col0 = (long long)(is_s ? c : c - ns) * kChunk;
    const bool bulk = (D % 4 == 0) && ((reinterpret_cast<uintptr_t>(z) & 15) == 0);
    for (long long c0 = col0; c0 < col0 + kChunk && c0 < D; c0 += kKT, ++fill) {
      const int slot = fill % kStages;
      if (fill >= kStages) mbar_wait(&empty[slot], (fill / kStages - 1) & 1);
      float* dst = ring + slot * kBp * kStride;
      const int n = (int)(D - c0 < kKT ? D - c0 : kKT);
      if (bulk) {
        if (generic & (1u << slot)) {
          fence_proxy_async();
          generic &= ~(1u << slot);
        }
        if (n < kKT) {
          for (int idx = lane; idx < B * (kKT - n); idx += 32)  // the last stage's columns past D
            dst[(idx / (kKT - n)) * kStride + n + idx % (kKT - n)] = 0.0f;
          generic |= 1u << slot;
        }
        __syncwarp();
        if (lane == 0)
          mbar_arrive_expect_tx(&full[slot], (uint32_t)(B * n * 4));
        else
          mbar_arrive(&full[slot]);
        __syncwarp();
        for (int r = lane; r < B; r += 32)
          bulk_copy(dst + r * kStride, z + r * D + c0, n * 4, &full[slot]);
      } else {
        for (int idx = lane; idx < B * kKT; idx += 32) {
          const int r = idx / kKT, cc = idx % kKT;
          const bool valid = c0 + cc < D;
          tf32x3::cp_async<4>(dst + r * kStride + cc, valid ? z + r * D + c0 + cc : z, valid);
        }
        cp_async_arrive(&full[slot]);
        generic |= 1u << slot;
      }
    }
  }
}

// v[0 .. C) of each lane of a group of lanes (the lane bits of O and below)
// summed over the group in a fixed tree: while C is even, a lane keeps half of
// its values, sends the other half to lane ^ O and adds what it receives
// (recursive halving); after that each step adds the partner's values to all
// C.  The same bits every run.
template <int K, int C, int O>
__device__ __forceinline__ void halve(float (&v)[K]) {
  if constexpr (O >= 1) {
    const bool up = (threadIdx.x & O) != 0;
    if constexpr (C % 2 == 0) {
#pragma unroll
      for (int i = 0; i < C / 2; ++i) {
        const float send = up ? v[i] : v[C / 2 + i];
        const float keep = up ? v[C / 2 + i] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      halve<K, C / 2, O / 2>(v);
    } else {
#pragma unroll
      for (int i = 0; i < C; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], O);
      halve<K, C, O / 2>(v);
    }
  }
}

// the values a lane keeps after halve<K, K, O>
__host__ __device__ constexpr int kept_count(int c, int o) { return o >= 1 && c % 2 == 0 ? kept_count(c / 2, o / 2) : c; }

// the first output lane l of a group of L holds after halving K values, and
// whether it writes them (lanes that differ only in the bits summed after
// the halving hold the same sums)
__device__ inline void kept_place(int K, int L, int l, int* first, bool* writer) {
  int f = 0, c = K, o = L / 2;
  for (; o >= 1 && c % 2 == 0; o /= 2, c /= 2)
    if (l & o) f += c / 2;
  *first = f;
  *writer = (l & (o >= 1 ? 2 * o - 1 : 0)) == 0;
}

// the off-diagonal tile (a, b), a < b, with index u in row-major order over nb blocks
__device__ inline void off_diagonal_rows(int u, int nb, int* a, int* b) {
  int r = 0;
  while (u >= nb - 1 - r) {
    u -= nb - 1 - r;
    ++r;
  }
  *a = r;
  *b = r + 1 + u;
}

// acc[p R + q] += the four columns of a[p] . b[q]
template <int R, int K>
__device__ __forceinline__ void tile_fma(float (&acc)[K], const float4 (&a)[R], const float4 (&b)[R]) {
#pragma unroll
  for (int p = 0; p < R; ++p)
#pragma unroll
    for (int q = 0; q < R; ++q) {
      float x = acc[p * R + q];
      x = fmaf(a[p].x, b[q].x, x);
      x = fmaf(a[p].y, b[q].y, x);
      x = fmaf(a[p].z, b[q].z, x);
      x = fmaf(a[p].w, b[q].w, x);
      acc[p * R + q] = x;
    }
}

// the upper triangles (p <= q) of the two diagonal R x R blocks of 2R rows v:
// acc[blk R (R + 1) / 2 + tri(p, q)] += the four columns of v[blk R + p] . v[blk R + q]
template <int R, int K>
__device__ __forceinline__ void pair_fma(float (&acc)[K], const float4 (&v)[2 * R]) {
#pragma unroll
  for (int blk = 0; blk < 2; ++blk)
#pragma unroll
    for (int p = 0; p < R; ++p)
#pragma unroll
      for (int q = p; q < R; ++q) {
        const int i = blk * R * (R + 1) / 2 + p * R - p * (p - 1) / 2 + (q - p);
        const float4 a = v[blk * R + p], b = v[blk * R + q];
        float x = acc[i];
        x = fmaf(a.x, b.x, x);
        x = fmaf(a.y, b.y, x);
        x = fmaf(a.z, b.z, x);
        x = fmaf(a.w, b.w, x);
        acc[i] = x;
      }
}

// One work unit, L lanes: an R x R tile (a, b) of the upper
// triangle (off the diagonal where NB is even), or (PAIR) the upper triangles
// of the diagonal blocks 2k and 2k + 1, whose 2R rows it loads once.
template <class P, bool PAIR>
__device__ void fma_unit(const float* ring, uint64_t* full, uint64_t* empty, float* __restrict__ partial, int B,
                         long long Ds, long long Dt, int ns, int nchunks, int lane, int unit, int l) {
  constexpr int R = P::kR, L = P::kL, kKT = P::kKT, kStride = P::kStride, kStages = P::kStages;
  constexpr int K = PAIR ? R * (R + 1) : R * R;
  constexpr int kKeep = kept_count(K, L / 2);
  bool active;
  int ta = 0, tb = 0;
  if constexpr (PAIR) {
    active = unit < P::kPairs;
  } else {
    active = unit < P::kOff;
    if (active) {
      if constexpr (P::kPairs > 0)
        off_diagonal_rows(unit, P::kNB, &ta, &tb);
      else
        tile_rows(unit, P::kNB, &ta, &tb);
    }
  }
  int first;
  bool writer;
  kept_place(K, L, l, &first, &writer);
  const int P2 = B * (B + 1) / 2;

  float acc[K];
#pragma unroll
  for (int i = 0; i < K; ++i) acc[i] = 0.0f;
  int fill = 0;
  for (int c = blockIdx.x; c < nchunks; c += gridDim.x) {
    const bool is_s = c < ns;
    const long long D = is_s ? Ds : Dt;
    const long long col0 = (long long)(is_s ? c : c - ns) * kChunk;
    for (long long c0 = col0; c0 < col0 + kChunk && c0 < D; c0 += kKT, ++fill) {
      const int slot = fill % kStages;
      mbar_wait(&full[slot], (fill / kStages) & 1);
      if (active) {
        const float* stage = ring + slot * P::kBp * kStride;
        const int groups = (int)((D - c0 < kKT ? D - c0 : kKT) + 3) / 4;
        for (int gi = l; gi < groups; gi += L) {
          if constexpr (PAIR) {
            float4 v[2 * R];
#pragma unroll
            for (int p = 0; p < 2 * R; ++p)
              v[p] = staged4(stage + (2 * R * unit + p) * kStride + 4 * gi);
            pair_fma<R, K>(acc, v);
          } else {
            float4 av[R], bv[R];
#pragma unroll
            for (int p = 0; p < R; ++p) {
              av[p] = staged4(stage + (R * ta + p) * kStride + 4 * gi);
              bv[p] = staged4(stage + (R * tb + p) * kStride + 4 * gi);
            }
            tile_fma<R, K>(acc, av, bv);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    }
    // the chunk's partial: the unit's lanes added in a fixed tree (each warp
    // holds whole units: L divides 32)
    halve<K, K, L / 2>(acc);
    if (active && writer) {
      float* __restrict__ out = partial + (long long)c * P2;
#pragma unroll
      for (int j = 0; j < kKeep; ++j) {
        int i, jj;
        if constexpr (PAIR) {
          const int blk = (first + j) / (R * (R + 1) / 2);
          int t = (first + j) % (R * (R + 1) / 2), p = 0;
          while (t >= R - p) {
            t -= R - p;
            ++p;
          }
          i = 2 * R * unit + R * blk + p;
          jj = i + t;
        } else {
          i = R * ta + (first + j) / R;
          jj = R * tb + (first + j) % R;
        }
        if (i <= jj && jj < B) out[packed(i, jj, B)] = acc[j];
      }
    }
#pragma unroll
    for (int i = 0; i < K; ++i) acc[i] = 0.0f;
  }
}

template <class P>
__device__ void consume(const float* ring, uint64_t* full, uint64_t* empty, float* __restrict__ partial,
                            int B, long long Ds, long long Dt, int ns, int nchunks, int warp, int lane) {
  // the tile units first, then the pairs, each rounded up to whole warps
  const int unit = (warp * 32 + lane) / P::kL, l = lane % P::kL;
  if (unit < P::kTileSlots)
    fma_unit<P, false>(ring, full, empty, partial, B, Ds, Dt, ns, nchunks, lane, unit, l);
  else
    fma_unit<P, true>(ring, full, empty, partial, B, Ds, Dt, ns, nchunks, lane, unit - P::kTileSlots, l);
}

template <class P>
__global__ void __launch_bounds__(Layout<P>::kThreads, 1)
gram_partial_kernel(const float* __restrict__ s, const float* __restrict__ t, float* __restrict__ partial,
                    int B, long long Ds, long long Dt, int ns, int nchunks) {
  constexpr int kBp = P::kBp, kStride = P::kStride, kStages = P::kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Layout<P>::kRingBytes);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int idx = tid; idx < kStages * (kBp - B) * kStride; idx += Layout<P>::kThreads) {
    const int st = idx / ((kBp - B) * kStride), rest = idx % ((kBp - B) * kStride);
    ring[(st * kBp + B) * kStride + rest] = 0.0f;  // rows past B stay zero
  }
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 32);
      mbar_init(&empty[i], P::kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == P::kWarps)
    produce<P>(ring, full, empty, s, t, B, Ds, Dt, ns, nchunks, lane);
  else
    consume<P>(ring, full, empty, partial, B, Ds, Dt, ns, nchunks, warp, lane);
  // this block's partials are written: pass 2 may be scheduled (it still
  // waits for the whole grid)
  asm volatile("griddepcontrol.launch_dependents;\n");
}

__global__ void __launch_bounds__(kSumWarps * 32)
gram_sum_kernel(const float* __restrict__ partial, float* __restrict__ gs, float* __restrict__ gt, int B,
                int ns, int nt) {
  __shared__ float staged[kSumSpan][32];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // pass 1 has finished
  const int P2 = B * (B + 1) / 2;
  const bool is_s = blockIdx.y == 0;
  const int n = is_s ? ns : nt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int e = blockIdx.x * 32 + lane;
  const float* __restrict__ p = partial + (long long)(is_s ? 0 : ns) * P2 + e;
  float v = 0.0f;
  for (int c0 = 0; c0 < n; c0 += kSumSpan) {
    const int span = n - c0 < kSumSpan ? n - c0 : kSumSpan;
    if (e < P2) {
      float r[kSumSpan / kSumWarps];  // every load issued before the first store
#pragma unroll
      for (int k = 0; k < kSumSpan / kSumWarps; ++k) {
        const int c = warp + k * kSumWarps;
        r[k] = c < span ? p[(long long)(c0 + c) * P2] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kSumSpan / kSumWarps; ++k) staged[warp + k * kSumWarps][lane] = r[k];
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll 32
      for (int c = 0; c < span; ++c) v += staged[c][lane];
    }
    __syncthreads();
  }
  if (warp != 0 || e >= P2) return;
  int i, j;
  unpack(e, B, &i, &j);
  float* __restrict__ out = is_s ? gs : gt;
  out[i * B + j] = v;
  out[j * B + i] = v;
}

int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// per device: the SM count, and which plans have their shared-memory attribute set
int sm_count[kMaxDevices];
unsigned attr_set[kMaxDevices];

template <class P>
cudaError_t launch_partial(int plan, const float* s, const float* t, float* partial, int B, long long Ds, long long Dt, int ns, int nchunks, int dev, cudaStream_t st) {
  if (!(attr_set[dev] & (1u << plan))) {
    cudaError_t err = cudaFuncSetAttribute(gram_partial_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Layout<P>::kSmemBytes);
    if (err != cudaSuccess) return err;
    attr_set[dev] |= 1u << plan;
  }
  const int grid = nchunks < sm_count[dev] ? nchunks : sm_count[dev];
  gram_partial_kernel<P><<<grid, Layout<P>::kThreads, Layout<P>::kSmemBytes, st>>>(s, t, partial, B, Ds, Dt, ns,
                                                                                  nchunks);
  return cudaGetLastError();
}

// the plans by B
cudaError_t launch_partial_for(int B, const float* s, const float* t, float* partial, long long Ds,
                               long long Dt, int ns, int nchunks, int dev, cudaStream_t st) {
  if (B <= 4) return launch_partial<Plan<4, 1, 32, 512>>(0, s, t, partial, B, Ds, Dt, ns, nchunks, dev, st);
  if (B <= 8) return launch_partial<Plan<4, 2, 32, 512>>(1, s, t, partial, B, Ds, Dt, ns, nchunks, dev, st);
  if (B <= 16) return launch_partial<Plan<4, 4, 32, 512>>(2, s, t, partial, B, Ds, Dt, ns, nchunks, dev, st);
  if (B <= 32) return launch_partial<Plan<8, 4, 32, 512>>(3, s, t, partial, B, Ds, Dt, ns, nchunks, dev, st);
  if (B <= 48) return launch_partial<Plan<8, 6, 8, 256>>(4, s, t, partial, B, Ds, Dt, ns, nchunks, dev, st);
  return launch_partial<Plan<8, 8, 8, 256>>(5, s, t, partial, B, Ds, Dt, ns, nchunks, dev, st);
}

}  // namespace

extern "C" int gram_pair_chunk_cols() { return kChunk; }

extern "C" int gram_pair_max_batch() { return kMaxBatch; }

extern "C" int gram_pair_fwd(const void* s, const void* t, void* out, int B, long long Ds, long long Dt,
                             void* stream) {
  if (B < 1 || B > kMaxBatch || Ds < 1 || Dt < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    err = cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  float* gs = static_cast<float*>(out);
  float* gt = gs + B * B;
  float* partial = gt + B * B;
  const int ns = cdiv(Ds, kChunk), nt = cdiv(Dt, kChunk);
  err = launch_partial_for(B, static_cast<const float*>(s), static_cast<const float*>(t), partial, Ds, Dt, ns,
                           ns + nt, dev, st);
  if (err != cudaSuccess) return (int)err;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cdiv(B * (B + 1) / 2, 32), 2);
  cfg.blockDim = dim3(kSumWarps * 32);
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gram_sum_kernel, static_cast<const float*>(partial), gs, gt, B, ns, nt);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
