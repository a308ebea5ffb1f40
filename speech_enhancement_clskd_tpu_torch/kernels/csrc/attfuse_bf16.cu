// ABF attention fuse on bf16 maps, forward (K4f) and backward (K4b), for
// Hopper (sm_90a): the second design of the bf16 entries.
//
// Replaces speech_enhancement_clskd_tpu/ops/pallas/attfuse.py::_fwd_kernel
// (reached through _fwd_raw) and ::_bwd_kernel (through _bwd_raw) on bf16
// maps, as distill.taps_dtype = bfloat16 with abf_attfuse_pallas runs them.
// For x [B, D, T, C], the residual res [B, Dp, T, C] (k = D / Dp), Wx and Wy
// [C, 2] and the bias [2], with y[b, d, t] = res[b, d / k, t]:
//     z   = sigmoid(x . Wx + y . Wy + bias)      [B, D, T, 2]
//     out = x * z0 + y * z1                      [B, D, T, C]
// and, for the incoming g [B, D, T, C], per row
//     dp  = z (1 - z) (g . x, g . y)
//     dx  = z0 g + dp0 Wx[:, 0] + dp1 Wx[:, 1]
//     dy  = z1 g + dp0 Wy[:, 0] + dp1 Wy[:, 1]
// dres[b, r, t] = the sum of dy over the k rows r k .. r k + k - 1, and dWx
// = sum x^T dp, dWy = sum y^T dp, dbias = sum dp over all rows.
//
// Roundings, where the Pallas bodies round (attfuse.py:104-111, 128-151):
// the logits are float32 sums of the exact bf16 products; z = sigmoid(p +
// bias) is taken in float32 and rounded to bf16; the blend multiplies and
// adds in bf16x2, each product and the sum rounded once (a float32 product
// of two bf16 values is exact, and a float32 sum of two rounded again to
// bf16 gives the same bits, 24 >= 2 x 8 + 2).  The backward works in
// float32 from the widened inputs, rounds dx and dres once to bf16, and
// returns dWx, dWy and dbias as float32 sums added in an order fixed by the
// shape.  The float32 kernels stay in attfuse_fwd.cu and attfuse_bwd.cu.
//
// What bounds it on this card.  K4f does about 8C operations a row against
// about 5C bytes (x, out, a share of res), K4b about 14C against 7C: under
// two operations a byte, far below the FMA rate, so bytes at 3.35 TB/s.  N
// = 2 leaves nothing for the tensor cores.  The first design (a warp a row,
// 2-byte loads, one row's chain of loads, butterflies and stores at a time)
// ran at 27 % and 40 % of this bound.
//
// Design.
//   Work items.  An item is one residual strip: (b, r, S time steps from
//   t0), i.e. res[b, r, t0 : t0 + S] and the k strips x[b, r k + j, t0 :
//   t0 + S] (and g's, in K4b) that read it.  A strip of a channels-last map
//   is contiguous (S C 2 bytes).  Blocks are persistent, a fixed count
//   (kBlocks, or fewer where there are fewer items: the shape alone decides),
//   and block i walks items i, i + blocks, ... in order.
//   Copies in flight.  One producer thread (the last warp) copies each item's
//   strips with one cp.async.bulk each into a ring of stages in shared
//   memory, in the order the consumers read them (res, then x_j, or x_j and
//   g_j together, for j = 0 .. k - 1), and completes them on the stage's
//   mbarrier; it runs up to the ring's depth ahead.  The consumer warps hand a
//   stage back on its empty barrier once each warp has read it.
//   16-byte lanes.  A consumer thread holds 8 consecutive channels of a row
//   (16 bytes), so a row takes G = pow2ceil(C / 8) lanes (8 at C = 64, and a
//   warp works on 32 / G rows at once).  Rows leave the stages as 16-byte
//   shared loads, and out, dx and dres leave as 16-byte stores, a warp's on
//   consecutive rows.  The two dot products reduce over the G lanes in
//   log2 G xor steps, in a fixed order, which leaves the same bits in every
//   lane of the group (each step adds the same two numbers in either order).
//   z's rows are 4 bytes: a group's first lane stores its row's bf16 pair
//   (K4f), every lane of the group loads it (K4b; issued before the stage
//   wait).  A thread's 8 channels of Wx and Wy sit in its registers for the
//   whole block (float32 in K4f, bf16 pairs in K4b, whose sums need the
//   registers).  A consumer thread keeps its rows of the residual strip in
//   registers for the whole item, so the residual strip leaves device memory
//   once, as _expand does in VMEM; in K4b its rows' dy are summed there over
//   the k rows and dres is written once by the block that owns the item, with
//   nothing atomic.
//   K4b's small gradients.  Each thread sums x dp and y dp for its 8
//   channels, and dp for its rows, over all its rows.  At the end the warp
//   adds its row groups' sums by xor steps, the block adds its warps' in
//   warp order into one [4C + 2] partial (shared memory sized by C, over the
//   ring), and attfuse_bf16_bwd_reduce_kernel adds the blocks' partials in
//   block order.  Two runs give the same bits.
//   Strips and stages.  S = 32 W / G x rows a thread for W consumer warps:
//   K4f 8 warps, 2 rows a thread (S = 64 at C = 64, a strip at most 8 KB),
//   K4b 7 warps, 1 row (S = 28 at C = 64, at most 3.5 KB).  Six stages of
//   one x strip (K4f) or of an x and a g strip (K4b), under 50 KB a block;
//   two blocks an SM.  K4b's sums need 128 registers a thread: at 8 consumer
//   warps (288 threads) ptxas allowed 96 for two blocks an SM and spilled
//   140 bytes, and the kernel took 0.46 ms at x [32, 128, 483, 64] against
//   0.37 at 7 warps (NVIDIA H100 80GB HBM3, 700 W; scripts/kernel_pair_timing.py).
//   Eight stages, or three blocks an SM at one row a thread, moved K4f by
//   less than 1 %.
//   Other widths.  Where C is not a multiple of 8 (a row is not whole 16-byte
//   units), the same kernel (template parameter kVec = false) loads and
//   stores element by element from device memory, and the producer copies
//   nothing.  Every map must start on 16 bytes: the wrapper copies one that
//   does not (kernels/attfuse.py), and the entries refuse it.
//
// Interface: plain C, bound with ctypes.  Pointers and the stream are passed
// as void*; the return value is cudaGetLastError() after the launches (or
// cudaErrorInvalidValue for a shape or pointer refused).  The caller
// allocates out and z (K4f); dx, dres, grads [4C + 2] and a scratch of
// attfuse_bwd_bf16_blocks(B, Dp, T, C) x (4C + 2) floats (K4b).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kFwdWarps = 8, kBwdWarps = 7;   // consumer warps; and the producer warp:
constexpr int kFwdThreads = 32 * (kFwdWarps + 1), kBwdThreads = 32 * (kBwdWarps + 1);
constexpr int kBlocks = 264;                   // persistent blocks (at most)
constexpr int kMaxC = 256;
constexpr int kFwdRows = 2, kBwdRows = 1;      // rows a consumer thread holds per strip
constexpr int kFwdStages = 6, kBwdStages = 6;
constexpr int kReduceThreads = 256;

// the time steps of a strip: W consumer warps, a row per G lanes, kRows a thread
template <int W, int G, int kRows>
__host__ __device__ constexpr int strip_steps() { return 32 * W / G * kRows; }

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

// bytes (a multiple of 16) from global src to shared dst, both on 16 bytes,
// completing as tx bytes on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the bf16 in the low / high half of a 32-bit word, widened
__device__ __forceinline__ float lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // a in the low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t u) {
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float ld1(const bf16* p) {
  return lo(__ldg(reinterpret_cast<const unsigned short*>(p)));
}

// v summed over the G lanes of a row group, the same bits in each
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The thread's 8 channels c0 .. c0 + 7 of a row as 4 bf16 pairs: from the
// row staged in shared memory (kVec), or element by element from the row
// in device memory, zeros past C or where !valid.
template <bool kVec>
__device__ __forceinline__ uint4 load8(const bf16* staged, const bf16* __restrict__ row, int c0,
                                       int C, bool valid) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (!valid || c0 >= C) return v;
  if constexpr (kVec) {
    v = *reinterpret_cast<const uint4*>(staged + c0);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + 2 * e;
      const uint32_t a = c < C ? __ldg(reinterpret_cast<const unsigned short*>(row + c)) : 0u;
      const uint32_t b =
          c + 1 < C ? __ldg(reinterpret_cast<const unsigned short*>(row + c + 1)) : 0u;
      w[e] = a | (b << 16);
    }
    v = make_uint4(w[0], w[1], w[2], w[3]);
  }
  return v;
}

// ... and stored: one 16-byte store (kVec), or element by element up to C
template <bool kVec>
__device__ __forceinline__ void store8(bf16* __restrict__ row, int c0, int C, uint4 v) {
  if constexpr (kVec) {
    *reinterpret_cast<uint4*>(row + c0) = v;
  } else {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    unsigned short* p = reinterpret_cast<unsigned short*>(row);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + 2 * e;
      if (c < C) p[c] = (unsigned short)(w[e] & 0xffffu);
      if (c + 1 < C) p[c + 1] = (unsigned short)(w[e] >> 16);
    }
  }
}

__device__ __forceinline__ void widen8(float (&f)[8], uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    f[2 * e] = lo(w[e]);
    f[2 * e + 1] = hi(w[e]);
  }
}

// An item: its first residual row, the first x row of its j = 0 strip (the
// strip of j starts j T rows on), and its time steps.
struct Item {
  long rrow;
  long xrow;
  int rows;
};

__device__ __forceinline__ Item item_at(long it, int strips, int S, int k, int T) {
  const long bdp = it / strips;  // b * Dp + r
  const int t0 = (int)(it - bdp * strips) * S;
  return {bdp * T + t0, bdp * k * T + t0, T - t0 < S ? T - t0 : S};
}

// The producer: each item's strips into the ring, `per` strips a stage
// (1: res, then x_j; 2: res, then x_j and g_j), in the consumers' order.
template <int S, int kStages>
__device__ void produce(unsigned char* ring, uint32_t stage_bytes, uint64_t* full,
                        uint64_t* empty, const bf16* __restrict__ res,
                        const bf16* __restrict__ x, const bf16* __restrict__ g, long items,
                        int strips, int k, int T, int C) {
  int q = 0;
  for (long it = blockIdx.x; it < items; it += gridDim.x) {
    const Item m = item_at(it, strips, S, k, T);
    const uint32_t bytes = (uint32_t)m.rows * C * 2;
    for (int j = -1; j < k; ++j, ++q) {
      const int slot = q % kStages;
      if (q >= kStages) mbar_wait(&empty[slot], ((q / kStages) - 1) & 1);
      unsigned char* dst = ring + (size_t)slot * stage_bytes;
      if (j < 0) {
        mbar_expect_tx(&full[slot], bytes);
        bulk_copy(dst, res + m.rrow * C, bytes, &full[slot]);
      } else {
        const long row = m.xrow + (long)j * T;
        mbar_expect_tx(&full[slot], g ? 2 * bytes : bytes);
        bulk_copy(dst, x + row * C, bytes, &full[slot]);
        if (g) bulk_copy(dst + (size_t)S * C * 2, g + row * C, bytes, &full[slot]);
      }
    }
  }
}

template <int G, bool kVec>
__global__ void __launch_bounds__(kFwdThreads, 2)
attfuse_bf16_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ res,
                        const bf16* __restrict__ wx, const bf16* __restrict__ wy,
                        const bf16* __restrict__ bias, bf16* __restrict__ out,
                        bf16* __restrict__ z, long items, int strips, int k, int T, int C) {
  constexpr int S = strip_steps<kFwdWarps, G, kFwdRows>();
  constexpr int R = 32 * kFwdWarps / G;  // rows at once
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t stage_bytes = (uint32_t)S * C * 2;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)kFwdStages * stage_bytes);
  uint64_t* empty = full + kFwdStages;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if constexpr (kVec) {
    if (tid == 0) {
      for (int s = 0; s < kFwdStages; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], kFwdWarps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  if (warp == kFwdWarps) {
    if (kVec && lane == 0)
      produce<S, kFwdStages>(smem, stage_bytes, full, empty, res, x, nullptr, items, strips, k,
                             T, C);
    return;
  }

  const int slot_row = tid / G, c0 = (tid % G) * 8;
  const bool lead = tid % G == 0;
  float wx0[8], wx1[8], wy0[8], wy1[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int c = c0 + e;
    const bool in = c < C;
    wx0[e] = in ? ld1(wx + 2 * c) : 0.0f;
    wx1[e] = in ? ld1(wx + 2 * c + 1) : 0.0f;
    wy0[e] = in ? ld1(wy + 2 * c) : 0.0f;
    wy1[e] = in ? ld1(wy + 2 * c + 1) : 0.0f;
  }
  const float b0 = ld1(bias), b1 = ld1(bias + 1);

  int q = 0;
  for (long it = blockIdx.x; it < items; it += gridDim.x) {
    const Item m = item_at(it, strips, S, k, T);
    uint4 yv[kFwdRows];
    {
      const int slot = q % kFwdStages;
      if constexpr (kVec) mbar_wait(&full[slot], (q / kFwdStages) & 1);
      const bf16* st = reinterpret_cast<const bf16*>(smem + (size_t)slot * stage_bytes);
#pragma unroll
      for (int i = 0; i < kFwdRows; ++i) {
        const int row = slot_row + i * R;
        yv[i] = load8<kVec>(st + row * C, res + (m.rrow + row) * C, c0, C, row < m.rows);
      }
      if constexpr (kVec) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[slot]);
      }
      ++q;
    }
    for (int j = 0; j < k; ++j, ++q) {
      const int slot = q % kFwdStages;
      if constexpr (kVec) mbar_wait(&full[slot], (q / kFwdStages) & 1);
      const bf16* st = reinterpret_cast<const bf16*>(smem + (size_t)slot * stage_bytes);
      const long xrow = m.xrow + (long)j * T;
#pragma unroll
      for (int i = 0; i < kFwdRows; ++i) {
        const int row = slot_row + i * R;
        const bool valid = row < m.rows;
        const uint4 xv = load8<kVec>(st + row * C, x + (xrow + row) * C, c0, C, valid);
        float xf[8], yf[8];
        widen8(xf, xv);
        widen8(yf, yv[i]);
        float p0 = 0.0f, p1 = 0.0f;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          p0 = fmaf(xf[e], wx0[e], p0);
          p1 = fmaf(xf[e], wx1[e], p1);
          p0 = fmaf(yf[e], wy0[e], p0);
          p1 = fmaf(yf[e], wy1[e], p1);
        }
        p0 = group_sum<G>(p0);
        p1 = group_sum<G>(p1);
        const float z0 = round_bf16(1.0f / (1.0f + expf(-(p0 + b0))));
        const float z1 = round_bf16(1.0f / (1.0f + expf(-(p1 + b1))));
        const __nv_bfloat162 z0v = __float2bfloat162_rn(z0), z1v = __float2bfloat162_rn(z1);
        const uint4 o = make_uint4(
            as_u32(__hadd2(__hmul2(as_bf162(xv.x), z0v), __hmul2(as_bf162(yv[i].x), z1v))),
            as_u32(__hadd2(__hmul2(as_bf162(xv.y), z0v), __hmul2(as_bf162(yv[i].y), z1v))),
            as_u32(__hadd2(__hmul2(as_bf162(xv.z), z0v), __hmul2(as_bf162(yv[i].z), z1v))),
            as_u32(__hadd2(__hmul2(as_bf162(xv.w), z0v), __hmul2(as_bf162(yv[i].w), z1v))));
        if (valid) {
          if (c0 < C) store8<kVec>(out + (xrow + row) * C, c0, C, o);
          if (lead) *reinterpret_cast<uint32_t*>(z + 2 * (xrow + row)) = pack2(z0, z1);
        }
      }
      if constexpr (kVec) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[slot]);
      }
    }
  }
}

template <int G, bool kVec>
__global__ void __launch_bounds__(kBwdThreads, 2)
attfuse_bf16_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ res,
                        const bf16* __restrict__ z, const bf16* __restrict__ g,
                        const bf16* __restrict__ wx, const bf16* __restrict__ wy,
                        bf16* __restrict__ dx, bf16* __restrict__ dres,
                        float* __restrict__ partial, long items, int strips, int k, int T,
                        int C) {
  constexpr int S = strip_steps<kBwdWarps, G, kBwdRows>();
  static_assert(kBwdRows == 1, "the backward holds one row a thread");
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t stage_bytes = 2u * S * C * 2;  // x_j, then g_j
  const int n = 4 * C + 2;
  size_t bar_offset = (size_t)kBwdWarps * n * 4;  // red's bytes
  if constexpr (kVec) {
    const size_t ring_bytes = (size_t)kBwdStages * stage_bytes;
    if (ring_bytes > bar_offset) bar_offset = ring_bytes;
  }
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + bar_offset);
  uint64_t* empty = full + kBwdStages;
  float* red = reinterpret_cast<float*>(smem);  // over the ring, once it is drained
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if constexpr (kVec) {
    if (tid == 0) {
      for (int s = 0; s < kBwdStages; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], kBwdWarps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  const int row = tid / G, c0 = (tid % G) * 8;
  float awx0[8], awx1[8], awy0[8], awy1[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) awx0[e] = awx1[e] = awy0[e] = awy1[e] = 0.0f;
  float adb0 = 0.0f, adb1 = 0.0f;

  if (warp == kBwdWarps) {
    if (kVec && lane == 0)
      produce<S, kBwdStages>(smem, stage_bytes, full, empty, res, x, g, items, strips, k, T, C);
    __syncwarp();
  } else {
    // the thread's channels of Wx and Wy: (w[c, 0], w[c, 1]) as a bf16 pair
    uint32_t wxp[8], wyp[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = c0 + e;
      wxp[e] = c < C ? __ldg(reinterpret_cast<const uint32_t*>(wx) + c) : 0u;
      wyp[e] = c < C ? __ldg(reinterpret_cast<const uint32_t*>(wy) + c) : 0u;
    }
    int q = 0;
    for (long it = blockIdx.x; it < items; it += gridDim.x) {
      const Item m = item_at(it, strips, S, k, T);
      const bool valid = row < m.rows;
      // the rows stay as bf16 pairs and widen where they are used (the
      // sums below hold 32 registers a thread)
      uint32_t yw[4];
      float dy[8];
      {
        const int slot = q % kBwdStages;
        if constexpr (kVec) mbar_wait(&full[slot], (q / kBwdStages) & 1);
        const bf16* st = reinterpret_cast<const bf16*>(smem + (size_t)slot * stage_bytes);
        const uint4 v = load8<kVec>(st + row * C, res + (m.rrow + row) * C, c0, C, valid);
        yw[0] = v.x, yw[1] = v.y, yw[2] = v.z, yw[3] = v.w;
        if constexpr (kVec) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[slot]);
        }
        ++q;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) dy[e] = 0.0f;
      for (int j = 0; j < k; ++j, ++q) {
        const long xrow = m.xrow + (long)j * T + row;
        const uint32_t zw = valid ? __ldg(reinterpret_cast<const uint32_t*>(z) + xrow) : 0u;
        const int slot = q % kBwdStages;
        if constexpr (kVec) mbar_wait(&full[slot], (q / kBwdStages) & 1);
        const bf16* st = reinterpret_cast<const bf16*>(smem + (size_t)slot * stage_bytes);
        const uint4 xv = load8<kVec>(st + row * C, x + xrow * C, c0, C, valid);
        const uint4 gv = load8<kVec>(st + (S + row) * C, g + xrow * C, c0, C, valid);
        if constexpr (kVec) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[slot]);
        }
        const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w}, gw[4] = {gv.x, gv.y, gv.z, gv.w};
        float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s0 = fmaf(lo(gw[e]), lo(xw[e]), s0);
          s1 = fmaf(lo(gw[e]), lo(yw[e]), s1);
          s0 = fmaf(hi(gw[e]), hi(xw[e]), s0);
          s1 = fmaf(hi(gw[e]), hi(yw[e]), s1);
        }
        s0 = group_sum<G>(s0);
        s1 = group_sum<G>(s1);
        const float z0 = lo(zw), z1 = hi(zw);
        const float dp0 = z0 * (1.0f - z0) * s0;
        const float dp1 = z1 * (1.0f - z1) * s1;
        uint32_t dxw[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float d[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 2 * e + h;
            const float gf = h ? hi(gw[e]) : lo(gw[e]);
            const float xf = h ? hi(xw[e]) : lo(xw[e]);
            const float yf = h ? hi(yw[e]) : lo(yw[e]);
            d[h] = fmaf(dp1, hi(wxp[i]), fmaf(dp0, lo(wxp[i]), z0 * gf));
            dy[i] += fmaf(dp1, hi(wyp[i]), fmaf(dp0, lo(wyp[i]), z1 * gf));
            awx0[i] = fmaf(xf, dp0, awx0[i]);
            awx1[i] = fmaf(xf, dp1, awx1[i]);
            awy0[i] = fmaf(yf, dp0, awy0[i]);
            awy1[i] = fmaf(yf, dp1, awy1[i]);
          }
          dxw[e] = pack2(d[0], d[1]);
        }
        adb0 += dp0;
        adb1 += dp1;
        if (valid && c0 < C)
          store8<kVec>(dx + xrow * C, c0, C, make_uint4(dxw[0], dxw[1], dxw[2], dxw[3]));
      }
      if (valid && c0 < C)
        store8<kVec>(dres + (m.rrow + row) * C, c0, C,
                     make_uint4(pack2(dy[0], dy[1]), pack2(dy[2], dy[3]), pack2(dy[4], dy[5]),
                                pack2(dy[6], dy[7])));
    }
    // the warp's row groups, added by xor steps: every lane of a channel
    // chunk then holds the same bits
#pragma unroll
    for (int off = G; off < 32; off <<= 1) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        awx0[e] += __shfl_xor_sync(0xffffffffu, awx0[e], off);
        awx1[e] += __shfl_xor_sync(0xffffffffu, awx1[e], off);
        awy0[e] += __shfl_xor_sync(0xffffffffu, awy0[e], off);
        awy1[e] += __shfl_xor_sync(0xffffffffu, awy1[e], off);
      }
    }
    // dp counted once a row: the sum over the row groups of one lane a group
    for (int off = G; off < 32; off <<= 1) {
      adb0 += __shfl_xor_sync(0xffffffffu, adb0, off);
      adb1 += __shfl_xor_sync(0xffffffffu, adb1, off);
    }
  }
  __syncthreads();  // every stage has been read: red may take the ring's place
  if (warp < kBwdWarps && lane < G) {
    float* r = red + warp * n;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = c0 + e;
      if (c < C) {
        r[2 * c] = awx0[e];
        r[2 * c + 1] = awx1[e];
        r[2 * C + 2 * c] = awy0[e];
        r[2 * C + 2 * c + 1] = awy1[e];
      }
    }
    if (lane == 0) {
      r[4 * C] = adb0;
      r[4 * C + 1] = adb1;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < n; idx += kBwdThreads) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kBwdWarps; ++w) s += red[w * n + idx];
    partial[(size_t)blockIdx.x * n + idx] = s;
  }
}

// grads[idx] = the sum over blocks of partial[block][idx], in block order
__global__ void __launch_bounds__(kReduceThreads)
attfuse_bf16_bwd_reduce_kernel(const float* __restrict__ partial, float* __restrict__ grads,
                               int blocks, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float s = 0.0f;
  for (int p = 0; p < blocks; ++p) s += partial[(size_t)p * n + idx];
  grads[idx] = s;
}

// the lanes of a row: 8 channels a lane, rounded up to a power of two
int group_lanes(int C) {
  int g = 1;
  while (g * 8 < C) g *= 2;
  return g;
}

int strip_rows(int warps, int C, int rows) { return 32 * warps / group_lanes(C) * rows; }

long items_of(int B, int Dp, int T, int S) { return (long)B * Dp * ((T + S - 1) / S); }

int blocks_of(long items) { return (int)(items < kBlocks ? items : kBlocks); }

bool on16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

bool shape_ok(int B, int D, int Dp, int T, int C) {
  return B >= 1 && D >= 1 && Dp >= 1 && D % Dp == 0 && T >= 1 && C >= 1 && C <= kMaxC;
}

struct FwdArgs {
  const bf16 *x, *res, *wx, *wy, *bias;
  bf16 *out, *z;
  long items;
  int strips, k, T, C, blocks;
  size_t smem;
  cudaStream_t stream;
};

template <int G, bool kVec>
cudaError_t fwd_launch(const FwdArgs& a) {
  auto kernel = attfuse_bf16_fwd_kernel<G, kVec>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.blocks, kFwdThreads, a.smem, a.stream>>>(a.x, a.res, a.wx, a.wy, a.bias, a.out, a.z,
                                                   a.items, a.strips, a.k, a.T, a.C);
  return cudaGetLastError();
}

template <int G>
cudaError_t run(const FwdArgs& a, bool vec) {
  return vec ? fwd_launch<G, true>(a) : fwd_launch<G, false>(a);
}

struct BwdArgs {
  const bf16 *x, *res, *z, *g, *wx, *wy;
  bf16 *dx, *dres;
  float* partial;
  long items;
  int strips, k, T, C, blocks;
  size_t smem;
  cudaStream_t stream;
};

template <int G, bool kVec>
cudaError_t bwd_launch(const BwdArgs& a) {
  auto kernel = attfuse_bf16_bwd_kernel<G, kVec>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.blocks, kBwdThreads, a.smem, a.stream>>>(a.x, a.res, a.z, a.g, a.wx, a.wy, a.dx,
                                                   a.dres, a.partial, a.items, a.strips, a.k,
                                                   a.T, a.C);
  return cudaGetLastError();
}

template <int G>
cudaError_t run(const BwdArgs& a, bool vec) {
  return vec ? bwd_launch<G, true>(a) : bwd_launch<G, false>(a);
}

// the kernel for G lanes a row (group_lanes(C))
template <class A>
cudaError_t by_lanes(int G, const A& a, bool vec) {
  switch (G) {
    case 1: return run<1>(a, vec);
    case 2: return run<2>(a, vec);
    case 4: return run<4>(a, vec);
    case 8: return run<8>(a, vec);
    case 16: return run<16>(a, vec);
    default: return run<32>(a, vec);
  }
}

}  // namespace

// The bf16 K4b's block count (and so its partials') for the shape.
extern "C" int attfuse_bwd_bf16_blocks(int B, int Dp, int T, int C) {
  if (B < 1 || Dp < 1 || T < 1 || C < 1 || C > kMaxC) return 0;
  return blocks_of(items_of(B, Dp, T, strip_rows(kBwdWarps, C, kBwdRows)));
}

extern "C" int attfuse_fwd_bf16(const void* x, const void* res, const void* wx, const void* wy,
                                const void* bias, void* out, void* z, int B, int D, int Dp,
                                int T, int C, void* stream) {
  if (!shape_ok(B, D, Dp, T, C) || !on16(x) || !on16(res) || !on16(out) || !on16(z))
    return (int)cudaErrorInvalidValue;
  const int G = group_lanes(C), S = strip_rows(kFwdWarps, C, kFwdRows);
  const bool vec = C % 8 == 0;
  FwdArgs a;
  a.x = static_cast<const bf16*>(x);
  a.res = static_cast<const bf16*>(res);
  a.wx = static_cast<const bf16*>(wx);
  a.wy = static_cast<const bf16*>(wy);
  a.bias = static_cast<const bf16*>(bias);
  a.out = static_cast<bf16*>(out);
  a.z = static_cast<bf16*>(z);
  a.strips = (T + S - 1) / S;
  a.items = items_of(B, Dp, T, S);
  a.k = D / Dp;
  a.T = T;
  a.C = C;
  a.blocks = blocks_of(a.items);
  a.smem = vec ? (size_t)kFwdStages * S * C * 2 + 2 * kFwdStages * sizeof(uint64_t) : 0;
  a.stream = static_cast<cudaStream_t>(stream);
  return (int)by_lanes(G, a, vec);
}

// blocks: attfuse_bwd_bf16_blocks(B, Dp, T, C), the scratch's rows
extern "C" int attfuse_bwd_bf16(const void* x, const void* res, const void* z, const void* g,
                                const void* wx, const void* wy, void* dx, void* dres,
                                void* grads, void* scratch, int B, int D, int Dp, int T, int C,
                                int blocks, void* stream) {
  if (!shape_ok(B, D, Dp, T, C) || blocks != attfuse_bwd_bf16_blocks(B, Dp, T, C) ||
      !on16(x) || !on16(res) || !on16(z) || !on16(g) || !on16(dx) || !on16(dres) ||
      (reinterpret_cast<uintptr_t>(wx) & 3) || (reinterpret_cast<uintptr_t>(wy) & 3))
    return (int)cudaErrorInvalidValue;
  const int G = group_lanes(C), S = strip_rows(kBwdWarps, C, kBwdRows);
  const bool vec = C % 8 == 0;
  const int n = 4 * C + 2;
  BwdArgs a;
  a.x = static_cast<const bf16*>(x);
  a.res = static_cast<const bf16*>(res);
  a.z = static_cast<const bf16*>(z);
  a.g = static_cast<const bf16*>(g);
  a.wx = static_cast<const bf16*>(wx);
  a.wy = static_cast<const bf16*>(wy);
  a.dx = static_cast<bf16*>(dx);
  a.dres = static_cast<bf16*>(dres);
  a.partial = static_cast<float*>(scratch);
  a.strips = (T + S - 1) / S;
  a.items = items_of(B, Dp, T, S);
  a.k = D / Dp;
  a.T = T;
  a.C = C;
  a.blocks = blocks;
  const size_t ring = vec ? (size_t)kBwdStages * 2 * S * C * 2 : 0;
  const size_t red = (size_t)kBwdWarps * n * 4;
  a.smem = (ring > red ? ring : red) + 2 * kBwdStages * sizeof(uint64_t);
  a.stream = static_cast<cudaStream_t>(stream);
  cudaError_t err = by_lanes(G, a, vec);
  if (err != cudaSuccess) return (int)err;
  attfuse_bf16_bwd_reduce_kernel<<<(n + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0,
                                   a.stream>>>(a.partial, static_cast<float*>(grads), blocks, n);
  return (int)cudaGetLastError();
}
