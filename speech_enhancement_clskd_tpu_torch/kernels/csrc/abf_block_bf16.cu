// The whole ABF block on bf16 operands for Hopper (sm_90a), route "fused":
// the bf16 K5b as one persistent warp-specialised kernel that forms the conv
// adjoint dxf tile by tile on the tensor cores and consumes it in the same
// block, so dxf never reaches device memory; the bf16 K5f with xf formed on
// the tensor cores in shared memory and convolved there where every output
// channel's weights fit (O <= 64), else an xf pass followed by the conv over
// xf.
//
// Replaces speech_enhancement_clskd_tpu/ops/pallas/abf_block.py::_bwd_kernel
// (reached through _bwd_raw) and ::_fwd_kernel (with _recompute_xf; reached
// through _fwd_raw) on bf16 operands, for the shapes of the block-config
// step; abf_block_bwd.cu and abf_block_fwd.cu state the function and keep the
// other shapes.  It rounds where the Pallas bodies round.  Backward: dxf = the
// float32 adjoint + g_xf; xhat recomputed and not rounded; z, dp, g_xhat and
// g_y float32; g_tap's product and dw1a take g_xhat rounded to bf16, dwxt and
// dwy dp rounded to bf16; dbvec and dzoff sum them unrounded; g_tap and g_res
// rounded once; the parameter gradients float32.  Forward: xhat = bf16(tap
// w1a summed from zero, then + bvec); the logits and z in float32, z rounded
// to bf16 for the blend; each blend product and their sum rounded to bf16;
// out rounded once from float32 sums.  A product of two bf16 values is exact
// in float32, so the tensor cores' products with float32 sums are the MXU's
// arithmetic; only the order of the sums differs.
//
// What bounds it on this card.  The bytes.  Backward: tap, res, g_xf, g_out
// read once and g_tap, g_res written once, plus dw2's xf and g_out (0.170 ms
// at the reference block, B = 32, D = 64, T = 483, Cs = 16, M = 64, O = 64),
// against 2 * 9 * M * O operations a pixel for the adjoint and as many for
// dw2 at the bf16 peak (0.15 ms).  The Pallas kernel forms dxf in VMEM; the
// design before this one wrote it to a float32 scratch and read it back (253
// MB each way at the reference block), with the 1x1 products in float32 FMA
// on widened loads.  Forward: tap and res read, xf and out written (0.104
// ms at the reference block); the design before this one wrote xf and read
// it back in the conv (127 MB more there).
//
// K5b's design.  Two consumer warpgroups and a producer warp (one thread
// issues TMA copies), one block an SM, walking a fixed contiguous range of
// work groups.  A group is one residual row (b, r) of a 64-step time strip
// (its k freq rows, k even) or, without the k-fold (k = 1), two freq rows; it
// is taken as pairs of neighbouring freq rows d0, d0 + 1, consumer warpgroup
// w on row d0 + w, so the two share one staged halo.  288 threads: ptxas
// gives each 168 registers (Hopper counts a block's registers by
// warpgroups), which the pass fits with its sums kept short-lived.
//   - The producer keeps ahead of the consumers: per pair and 64-channel
//     chunk of g_out, the halo rows d0 - 1 .. d0 + 2, steps t0 - 1 .. t0 + 64
//     (TMA boxes, 128-byte swizzle, zeros outside the map) into a ring (one
//     stage where the weights are resident: the next pair's halo lands during
//     this pair's pass); w2f [3, 3, O, M] in 16-channel groups (all nine
//     shifts, 18 KB), resident for O <= 64 and streamed through two slots
//     above; and per consumer the row's tap, res (its residual row) and g_xf
//     tiles.
//   - Route "fused" wide (Cs, O and M multiples of 8, M <= 64): the adjoint is
//     wgmma m64n64k16, A the halo (a time shift is a descriptor offset into
//     the swizzled rows, as in conv3x3_bf16.cuh), B the w2f group (N-major),
//     a fresh accumulator per group of nine shifts folded into the running
//     sum with round-to-nearest adds; the two warpgroups' groups interleave.
//   - Route "fused" narrow (the decoder's mask block: Cs <= 4, O = 2, whose
//     4-byte map rows TMA cannot take as a 4-D box): tap and g_out arrive as
//     flat runs (boxes of 16-byte rows over the map viewed flat); the
//     adjoint is mma.sync m16n8k16 with K packed as (shift s, channel o), k =
//     2 s + o (two k16 steps for the nine shifts, zeros past), its A staged a
//     row at a time; dw2 (9 x M x O sums over every pixel) is folded in, per
//     xf row with the nine shifts of g_out as N (n = 2 s + o): the stage also
//     holds the pair's xf rows, read by ldmatrix.trans as dw2's A.
//   - The pass, in registers: the accumulator's m64n64 layout is eight
//     m16n8 C fragments a warp, so each warp holds its 16 pixels x 64 mid
//     channels and runs the 1x1 products on mma.sync m16n8k16 (bf16 operands,
//     float32 sums): xhat = tap w1a + bvec an n8 tile at a time, the logits
//     tap wxt + y wy (the y fragments are also the y values in the C layout),
//     the two per-pixel dots summed over the four lanes of a row by shuffles,
//     z, dp; g_xhat's bf16 fragments become g_tap's A operand directly (g_tap
//     = bf16(g_xhat) w1a^T + dp wxt^T); g_y into the item's sum (at the
//     item's end consumer 1's sum is handed to consumer 0 through a buffer on
//     barriers of their own, then g_res written once, rounded once);
//     bf16(g_xhat) and bf16(dp) into shared memory for dw1a = tap^T
//     bf16(g_xhat), dwxt = tap^T bf16(dp) and dwy = y^T bf16(dp)
//     (ldmatrix.trans operands, a fresh accumulator per row folded into the
//     running sums).  g_tap and g_res go out through shared memory as whole
//     rows, 16 bytes a lane.  Rows past T are zeroed in dxf, so they add
//     nothing.
//   - At the end each block adds its warps' sums in a fixed order into one
//     partial [dw1a | dbvec | dwxt | dwy | dzoff (| dw2)], and
//     conv3x3_tiles::reduce_partials adds the blocks' partials in block
//     order.  On the wide route dw2 is conv3x3_bf16::wgrad_run (route
//     "wgmma") over xf and g_out: folding it in at O = 64 would need 9 x 64 x
//     64 running sums a warpgroup, more than its registers or shared memory.
// K5f's design, by shape: for O <= 64 one kernel (abf_block_bf16_fwd_fused_
// kernel) forms xf into a ring of rows in shared memory, writes it once (the
// backward's dw2 reads it) and convolves it there on wgmma; above, the xf
// pass (abf_block_bf16_xf_mma_kernel) and the conv over xf on the bf16
// K3f's wgmma tile (each block of 64 output channels would form xf again:
// the two passes measured faster); at the mask block the xf pass and the
// narrow conv (abf_block_bf16_conv_n8_mma_kernel) that walks the freq rows
// with a ring of xf rows.  Every split depends only on the shape: two runs
// give the same bits.
//
// Interface: plain C, bound with ctypes.  abf_block_bf16_route(Cs, M, O, k,
// fuse, D), for both kernels, gives 1 (wide), 2 (narrow: Cs <= 4, O = 2, k
// <= 2 and D a multiple of 8, so that the flat views of tap and g_out are
// whole 16-byte rows) or 0 (not this source's route); abf_block_bf16_bwd_blocks(B, D, k,
// T, fuse) the backward's grid (one partial each);
// abf_block_bf16_bwd_floats(Cs, M, O, narrow) a partial's floats.  The
// caller allocates g_tap, g_res, grads (a partial's length: on the narrow
// route dw2 follows dzoff), the partials, dw2 [3, 3, M, O] and the wide
// route's dw2 scratch (abf_block_bwd_wgrad_chunks of abf_block_bwd.cu), and
// for the forward xf, out and the conv's packed weights
// (abf_block_bf16_fwd_scratch_elems(M, O) bf16); every map 16-byte aligned.
// The return value is cudaGetLastError() after each launch.

#include <cuda_runtime.h>

#include <cstdint>

#include "bf16_io.cuh"
#include "conv3x3_bf16.cuh"

namespace {

namespace cb = conv3x3_bf16;
using cb::bf16;

constexpr int kPx = 64;                       // time steps of a row tile: wgmma's m64
constexpr int kConsumers = 2;                 // warpgroups, one per freq row of a pair
// and one producer warp: 288 threads (ptxas caps them at 168 registers, as
// for three warpgroups; setmaxnreg did not lift its allocation)
constexpr int kThreads = kConsumers * 128 + 32;
constexpr int kRowB = 128;                    // a swizzled row: 64 bf16 channels
constexpr int kPitch = 9 * 1024;              // one halo row's box, 1024-aligned
constexpr int kHaloBoxB = (kPx + 2) * kRowB;  // 66 steps x 128 bytes
constexpr int kFlatB = 512;                   // a flat g_out halo row (narrow), <= 256 bf16
constexpr int kWSlotB = 9 * 16 * kRowB;       // one 16-channel group of w2f, nine shifts
constexpr int kTileB = kPx * kRowB;           // a [64 steps][64 channels] bf16 tile
constexpr int kPixB = 3 * kTileB;             // a consumer's tap, y and g_xf tiles
constexpr int kLdw = 72;                      // bf16 stride of a 1x1 weight row (banks)
constexpr int kLdwB = kLdw * 2;

// The narrow route's per-row operands, staged by each consumer in its own
// area: the adjoint's A [64 steps][k = 2 s + o] (80-byte rows: ldmatrix
// without bank conflicts), dw2's B [64 steps][n = 2 s + o] (48-byte rows) and
// the tap [64 steps][8 channels] (16-byte rows), zeros past the 18 k and n
// and past Cs.
constexpr int kNaLd = 80, kNgLd = 48, kNtLd = 16;
constexpr int kNaB = kPx * kNaLd, kNgB = kPx * kNgLd, kNtB = kPx * kNtLd;
constexpr int kNstageB = 9216;  // kNaB + kNgB + kNtB, rounded to 1024

// Shared memory, in bytes from the 1024-aligned base, by route: the weight
// slots (resident: up to four groups; streamed: two; narrow: dw2's running
// sums and the staged operands instead), the ring of halo stages (one where
// the weights are resident: the next pair's halo lands during this pair's
// pass), each consumer's pixel tiles, the item's g_y handed from consumer 1
// to consumer 0, the 1x1 weights, bf16(dp)^T, the narrow adjoint's w2f
// pairs, the barriers.
template <bool NARROW, bool STREAM>
struct Lay {
  static constexpr int kWSlots = NARROW ? 0 : (STREAM ? 2 : 4);
  static constexpr int kWBytes = NARROW ? 9216 + kConsumers * kNstageB : kWSlots * kWSlotB;
  static constexpr int kStages = (NARROW || STREAM) ? 2 : 1;
  static constexpr int kStageB = NARROW ? 2 * kTileB + 4 * kFlatB : 4 * kPitch;
  static constexpr int kOffRing = kWBytes;
  static constexpr int kOffPix = kOffRing + kStages * kStageB;
  static constexpr int kOffCarry = kOffPix + kConsumers * kPixB;  // g_y [4][8][32] float4
  static constexpr int kOffW1 = kOffCarry + 128 * 8 * 16;          // w1a [c][m] (bf16, kLdw)
  static constexpr int kOffWxT = kOffW1 + 64 * kLdwB;              // wxt^T [8][c], rows 2.. zero
  static constexpr int kOffWyT = kOffWxT + 8 * kLdwB;              // wy^T [8][m]
  static constexpr int kOffDpT = kOffWyT + 8 * kLdwB;              // per consumer bf16(dp)^T [8][px]
  static constexpr int kOffWxF = kOffDpT + kConsumers * 8 * kLdwB; // wxt [64][2] float
  static constexpr int kOffWyF = kOffWxF + 64 * 2 * 4;             // wy [64][2] float
  static constexpr int kOffBvF = kOffWyF + 64 * 2 * 4;             // bvec [64] float
  static constexpr int kOffWn = kOffBvF + 64 * 4;                  // narrow w2f pairs [9][64]
  static constexpr int kOffBar = kOffWn + 9 * 64 * 4;
  static constexpr int kSmemB = kOffBar + 18 * 8 + 1024;           // with the base's alignment
  static_assert(9216 + kConsumers * kNstageB <= 32 * 1024 && kNaB + kNgB + kNtB <= kNstageB,
                "narrow staging");
  static_assert(kSmemB <= cb::kSmemLimit, "shared memory");
};

struct Args {
  const bf16* w1a;
  const float* bvec;
  const bf16* wxt;
  const bf16* wy;
  const float* zoff;
  const bf16* w2f;
  bf16* gtap;
  bf16* gres;
  float* partial;
  int B, D, Dp, k, T, Cs, M, O;
  int t_tiles, gp, ppg, kch, ngroups, stream_w, fuse;
  long groups, per_block;
  int n_part;  // a partial's floats
};

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(cb::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(cb::smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// A flat run of a map from element `e` (narrow route): the map viewed as
// 16-byte rows of 8 elements, so a box starts on a row; the run's first
// element lands `flat_skew(e)` elements into the box (e may be negative:
// rows before the map come as zeros)
__device__ __forceinline__ int flat_row(long e) { return (int)(e >= 0 ? e / 8 : -((7 - e) / 8)); }
__device__ __forceinline__ int flat_skew(long e) { return (int)(e - 8L * flat_row(e)); }

// wgmma m64n64k16, f32 += bf16 x bf16, A K-major and B N-major (the
// transpose bit) through their descriptors; scale_d = 0 starts from zero.
__device__ __forceinline__ void wgmma_n64_bt(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// mma.sync m16n8k16, f32 += bf16 x bf16, into d[0 .. 3]
__device__ __forceinline__ void mma4(float* d, const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t ld16(const uint8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}
__device__ __forceinline__ float lo_f(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_f(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// The lane's row address for ldmatrix/stmatrix .x4 of rows r0 .. r0 + 15 and
// channels 16 ks .. 16 ks + 15 of a swizzled tile, in the m16n8k16 A order:
// a0 (g, 2q..), a1 (g + 8, 2q..), a2 (g, 2q + 8..), a3 (g + 8, 2q + 8..) --
// which is also the m16n8 C layout of the n8 tiles 2 ks, 2 ks + 1 (rows g and
// g + 8), packed to bf16 pairs.
__device__ __forceinline__ uint32_t frag_addr(const uint8_t* tile, int r0, int ks, int lane) {
  const int row = r0 + (lane & 7) + (((lane >> 3) & 1) << 3);
  const int unit = 2 * ks + (lane >> 4);
  return cb::smem_u32(tile) + row * kRowB + ((unit ^ (row & 7)) << 4);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void stsm_x4(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// The m16n8k16 A fragment of rows r0 .. r0 + 15, k columns 16 ks .. of a
// swizzled tile.
__device__ __forceinline__ void a_frag_sw(uint32_t (&a)[4], const uint8_t* tile, int r0, int ks,
                                          int lane) {
  ldsm_x4(a, frag_addr(tile, r0, ks, lane));
}

// ldmatrix.x4.trans of a swizzled tile: the A fragment (rows = channels
// 16 cu .. + 15, k = tile rows r0 .. r0 + 15) of the tile transposed.
__device__ __forceinline__ void a_frag_trans(uint32_t (&a)[4], const uint8_t* tile, int r0,
                                             int cu, int lane) {
  const int row = r0 + (lane & 7) + ((lane >> 4) << 3);
  const int unit = 2 * cu + ((lane >> 3) & 1);
  cb::ldsm_x4_trans(a, cb::smem_u32(tile) + row * kRowB + ((unit ^ (row & 7)) << 4));
}

// ldmatrix.x4.trans of a swizzled [k rows][n] tile: the B fragments of the
// two n8 tiles 2 nu, 2 nu + 1 (n = channels 16 nu ..) for k rows r0 .. r0 + 15.
__device__ __forceinline__ void b_frags_trans(uint32_t (&b)[2][2], const uint8_t* tile, int r0,
                                              int nu, int lane) {
  const int i = lane >> 3;
  const int row = r0 + ((i & 1) << 3) + (lane & 7);
  const int unit = 2 * nu + (i >> 1);
  uint32_t r[4];
  cb::ldsm_x4_trans(r, cb::smem_u32(tile) + row * kRowB + ((unit ^ (row & 7)) << 4));
  b[0][0] = r[0], b[0][1] = r[1], b[1][0] = r[2], b[1][1] = r[3];
}

// the logistic through the SFU's exp2 and reciprocal (a few ulp, as the
// earlier bf16 pixel pass)
__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}

// The block's work: group gi -> (b, time strip, index within the strip's row
// of groups); a pair pi of the group covers freq rows d0, d0 + 1.
struct Pair {
  int b, t0, d0, gr;
};
__device__ __forceinline__ Pair pair_of(const Args& a, long gi, int pi) {
  Pair p;
  const int g32 = (int)gi;  // groups < 2^31 (the host checks): 32-bit division
  const int bs = g32 / a.gp;
  p.gr = g32 - bs * a.gp;
  const int b = bs / a.t_tiles;
  p.t0 = (bs - b * a.t_tiles) * kPx;
  p.b = b;
  p.d0 = 2 * (p.gr * a.ppg + pi);
  return p;
}

template <bool NARROW, bool STREAM, bool KSUM, int NCT>
__global__ void __launch_bounds__(kThreads, 1)
abf_block_bf16_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap gmap,  // g_out halo (4-D) or flat
                          const __grid_constant__ CUtensorMap wmap,  // w2f [9][O][M] (wide)
                          const __grid_constant__ CUtensorMap tmap,  // tap (4-D) or flat
                          const __grid_constant__ CUtensorMap ymap,  // res
                          const __grid_constant__ CUtensorMap xmap,  // g_xf
                          const __grid_constant__ CUtensorMap fmap,  // xf halo (narrow)
                          Args a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (cb::smem_u32(smem_raw) & 1023)) & 1023);
  using L = Lay<NARROW, STREAM>;
  constexpr int kStages = L::kStages, kWSlots = L::kWSlots, kStageB = L::kStageB;
  uint8_t* wsl = smem;
  uint8_t* ring = smem + L::kOffRing;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kOffBar);
  uint64_t* wfull = bars;        // [4]
  uint64_t* wempty = bars + 4;   // [4]
  uint64_t* hfull = bars + 8;    // [2]
  uint64_t* hempty = bars + 10;  // [2]
  uint64_t* pfull = bars + 12;   // [consumer]
  uint64_t* pempty = bars + 14;  // [consumer]
  uint64_t* cfull = bars + 16;   // the carry written (consumer 1's warps)
  uint64_t* cempty = bars + 17;  // the carry read (consumer 0's warps)
  const int tid = threadIdx.x;
  const int Cs = a.Cs, M = a.M, O = a.O, D = a.D, T = a.T;
  const bool fuse = a.fuse != 0;

  // the 1x1 weights, once, by every thread (bf16 bits as they are)
  {
    const uint16_t* w1 = reinterpret_cast<const uint16_t*>(a.w1a);
    uint16_t* w1s = reinterpret_cast<uint16_t*>(smem + L::kOffW1);
    for (int e = tid; e < 64 * 64; e += kThreads) {
      const int c = e / 64, m = e % 64;
      w1s[c * kLdw + m] = (c < Cs && m < M) ? w1[c * M + m] : 0;
    }
    uint16_t* wxt = reinterpret_cast<uint16_t*>(smem + L::kOffWxT);
    uint16_t* wyt = reinterpret_cast<uint16_t*>(smem + L::kOffWyT);
    const uint16_t* wx = reinterpret_cast<const uint16_t*>(a.wxt);
    const uint16_t* wy = reinterpret_cast<const uint16_t*>(a.wy);
    for (int e = tid; e < 8 * 64; e += kThreads) {
      const int j = e / 64, c = e % 64;
      wxt[j * kLdw + c] = (fuse && j < 2 && c < Cs) ? wx[c * 2 + j] : 0;
      wyt[j * kLdw + c] = (fuse && j < 2 && c < M) ? wy[c * 2 + j] : 0;
    }
    uint16_t* dpt = reinterpret_cast<uint16_t*>(smem + L::kOffDpT);
    for (int e = tid; e < kConsumers * 8 * kLdw; e += kThreads) dpt[e] = 0;
    float* wxf = reinterpret_cast<float*>(smem + L::kOffWxF);
    float* wyf = reinterpret_cast<float*>(smem + L::kOffWyF);
    float* bvf = reinterpret_cast<float*>(smem + L::kOffBvF);
    for (int e = tid; e < 128; e += kThreads) {
      wxf[e] = (fuse && e < 2 * Cs) ? bf16_io::ld1(a.wxt + e) : 0.0f;
      wyf[e] = (fuse && e < 2 * M) ? bf16_io::ld1(a.wy + e) : 0.0f;
    }
    for (int e = tid; e < 64; e += kThreads) bvf[e] = e < M ? __ldg(a.bvec + e) : 0.0f;
    if constexpr (NARROW) {
      uint32_t* stage = reinterpret_cast<uint32_t*>(smem + 9216);
      for (int e = tid; e < kConsumers * kNstageB / 4; e += kThreads) stage[e] = 0u;
      // wn[s][m] = (w2f[s, 0, m], w2f[s, 1, m]) packed: the B fragment of the
      // adjoint's k pair 0, 1 (O <= 2)
      const uint16_t* w2 = reinterpret_cast<const uint16_t*>(a.w2f);
      uint32_t* wn = reinterpret_cast<uint32_t*>(smem + L::kOffWn);
      for (int e = tid; e < 9 * 64; e += kThreads) {
        const int s = e / 64, m = e % 64;
        const uint32_t v0 = m < M ? w2[((long)s * O) * M + m] : 0;
        const uint32_t v1 = (m < M && O > 1) ? w2[((long)s * O + 1) * M + m] : 0;
        wn[e] = v0 | (v1 << 16);
      }
    }
  }
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) {
      cb::mbar_init(&wfull[i], 1);
      cb::mbar_init(&wempty[i], 4 * kConsumers);
    }
    for (int i = 0; i < kStages; ++i) {
      cb::mbar_init(&hfull[i], 1);
      cb::mbar_init(&hempty[i], 4 * kConsumers);
    }
    for (int i = 0; i < kConsumers; ++i) {
      cb::mbar_init(&pfull[i], 1);
      cb::mbar_init(&pempty[i], 4);
    }
    cb::mbar_init(cfull, 4);
    cb::mbar_init(cempty, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const long g_begin = (long)blockIdx.x * a.per_block;
  const long g_end = g_begin + a.per_block < a.groups ? g_begin + a.per_block : a.groups;
  const int wg = tid / 128;
  const int tap_box_b = NARROW ? ((kPx * Cs + 7) / 8 + 1) * 16 : kTileB;
  const int flat_box_b = ((66 * O + 7) / 8 + 1) * 16;

  if (wg == kConsumers) {  // the producer warp: its first thread issues
    if (tid != kConsumers * 128) return;
    if (!NARROW && !STREAM) {  // resident: every group of w2f once
      for (int gq = 0; gq < a.ngroups; ++gq) {
        cb::mbar_expect_tx(&wfull[gq], kWSlotB);
        cb::tma_load_3d(wsl + gq * kWSlotB, &wmap, &wfull[gq], 0, 16 * gq, 0);
      }
    }
    long hs = 0, wsc = 0;
    int pn[kConsumers] = {0, 0};
    for (long gi = g_begin; gi < g_end; ++gi) {
      for (int pi = 0; pi < a.ppg; ++pi) {
        const Pair p = pair_of(a, gi, pi);
        const int b = p.b, t0 = p.t0, d0 = p.d0;
        for (int kc = 0; kc < a.kch; ++kc) {
          const int slot = (int)(hs % kStages);
          cb::mbar_wait(&hempty[slot], (uint32_t)(((hs / kStages) & 1) ^ 1));
          uint8_t* st = ring + slot * kStageB;
          if constexpr (NARROW) {
            int rows = 0;
            for (int r = 0; r < 4; ++r) rows += (d0 - 1 + r >= 0 && d0 - 1 + r < D);
            cb::mbar_expect_tx(&hfull[slot], (uint32_t)(2 * kTileB + rows * flat_box_b));
            for (int r = 0; r < 2; ++r)
              cb::tma_load_4d(st + r * kTileB, &fmap, &hfull[slot], 0, t0, d0 + r, b);
            for (int r = 0; r < 4; ++r) {
              const int dr = d0 - 1 + r;
              if (dr >= 0 && dr < D)
                tma_load_2d(st + 2 * kTileB + r * kFlatB, &gmap, &hfull[slot], 0,
                            flat_row((((long)b * D + dr) * T + t0 - 1) * O));
            }
          } else {
            cb::mbar_expect_tx(&hfull[slot], 4 * kHaloBoxB);
            for (int r = 0; r < 4; ++r)
              cb::tma_load_4d(st + r * kPitch, &gmap, &hfull[slot], 64 * kc, t0 - 1, d0 - 1 + r,
                              b);
            if (STREAM) {
              const int ng = min(4, (O - 64 * kc + 15) / 16);
              for (int kk = 0; kk < ng; ++kk, ++wsc) {
                const int ws = (int)(wsc % kWSlots);
                cb::mbar_wait(&wempty[ws], (uint32_t)(((wsc / kWSlots) & 1) ^ 1));
                cb::mbar_expect_tx(&wfull[ws], kWSlotB);
                cb::tma_load_3d(wsl + ws * kWSlotB, &wmap, &wfull[ws], 0, 16 * (4 * kc + kk), 0);
              }
            }
          }
          ++hs;
        }
        for (int w = 0; w < kConsumers; ++w) {
          const int d = d0 + w;
          if (d >= D) continue;
          cb::mbar_wait(&pempty[w], (uint32_t)((pn[w] & 1) ^ 1));
          ++pn[w];
          uint8_t* pix = smem + L::kOffPix + w * kPixB;
          cb::mbar_expect_tx(&pfull[w], (uint32_t)(tap_box_b + (fuse ? 2 : 1) * kTileB));
          if constexpr (NARROW)
            tma_load_2d(pix, &tmap, &pfull[w], 0, flat_row((((long)b * D + d) * T + t0) * Cs));
          else
            cb::tma_load_4d(pix, &tmap, &pfull[w], 0, t0, d, b);
          if (fuse) cb::tma_load_4d(pix + kTileB, &ymap, &pfull[w], 0, t0, d / a.k, b);
          cb::tma_load_4d(pix + 2 * kTileB, &xmap, &pfull[w], 0, t0, d, b);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int w = wg;
  const int wi = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int R0 = 16 * wi + g;  // the thread's tile rows R0 and R0 + 8
  uint8_t* dpt = smem + L::kOffDpT + w * 8 * kLdwB;
  const uint8_t* w1s = smem + L::kOffW1;
  const uint8_t* wxt = smem + L::kOffWxT;
  const uint8_t* wyt = smem + L::kOffWyT;
  const float* wxf = reinterpret_cast<const float*>(smem + L::kOffWxF);
  const float* wyf = reinterpret_cast<const float*>(smem + L::kOffWyF);
  const float* bvf = reinterpret_cast<const float*>(smem + L::kOffBvF);
  const float zo0 = fuse ? __ldg(a.zoff) : 0.0f, zo1 = fuse ? __ldg(a.zoff + 1) : 0.0f;
  const int nct = NARROW ? 1 : (Cs + 15) / 16;  // 16-row tiles of tap channels
  const int nmk = (M + 15) / 16;                // k16 steps over the mid channels
  // narrow: dw2's running sums [s][m][o < 2] of this warpgroup in the idle
  // weight slots, each entry owned by one thread (lanes q = 0)
  float* dw2s = reinterpret_cast<float*>(wsl) + w * 9 * 64 * 2;
  if (NARROW) {
    for (int e = tid % 128; e < 9 * 64 * 2; e += 128) dw2s[e] = 0.0f;
    named_sync(1 + w, 128);
  }

  // running sums: dbvec[8 jn + 2 q + e]; dw1a (c tiles x this warp's two n8
  // tiles of mid channels); dwxt (c tile wi); dwy (m tile wi); dzoff (lanes
  // q = 0); KSUM (k > 2): g_y over the item's rows so far
  float dbv[16], dwa[NCT][2][4], dwx[4], dwyv[4], dz[2];
  float S[KSUM ? 32 : 1];
#pragma unroll
  for (int i = 0; i < (KSUM ? 32 : 1); ++i) S[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) dbv[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) dwx[i] = dwyv[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < NCT; ++i)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dwa[i][n][e] = 0.0f;
  dz[0] = dz[1] = 0.0f;

  if (!NARROW && !STREAM)  // resident weights: arrived once, for the block's life
    for (int gq = 0; gq < a.ngroups; ++gq) cb::mbar_wait(&wfull[gq], 0);
  long hs = 0, wsc = 0;
  int pn = 0, nc = 0;

  for (long gi = g_begin; gi < g_end; ++gi) {
    for (int pi = 0; pi < a.ppg; ++pi) {
      const Pair p = pair_of(a, gi, pi);
      const int b = p.b, t0 = p.t0;
      const int d = p.d0 + w;
      const bool active = d < D;
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.0f;

      // ---- the adjoint: acc = conv3x3(g_out, w2f) for the 64 x 64 tile
      if constexpr (!NARROW) {
        // a group of nine shifts into a fresh accumulator, folded in once
        // complete; the two warpgroups' groups interleave on the tensor cores
        float part[32];
        for (int kc = 0; kc < a.kch; ++kc) {
          const int slot = (int)(hs % kStages);
          cb::mbar_wait(&hfull[slot], (uint32_t)((hs / kStages) & 1));
          ++hs;
          const uint32_t xs = cb::smem_u32(ring + slot * kStageB);
          const int ng = min(4, (O - 64 * kc + 15) / 16);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            if (kk >= ng) break;
            int ws = 4 * kc + kk;
            if (STREAM) {
              ws = (int)(wsc % kWSlots);
              cb::mbar_wait(&wfull[ws], (uint32_t)((wsc / kWSlots) & 1));
              ++wsc;
            }
            // an idle warpgroup (a pair's row past D) runs the products too,
            // on the staged zeros, and drops them: no branch around wgmma
            const uint32_t wb = cb::smem_u32(wsl + ws * kWSlotB);
            cb::wg_fence();
#pragma unroll
            for (int s = 0; s < 9; ++s)  // shift (dd, tt) = (s / 3, s % 3)
              wgmma_n64_bt(part,
                           cb::sw128_desc(xs + (w + s / 3) * kPitch + (s % 3) * kRowB + 32 * kk,
                                          16, 1024),
                           cb::sw128_desc(wb + s * 2048, 1024, 1024), s);
            cb::wg_commit();
            cb::wg_wait<0>();
            cb::fold(acc, part);
            __syncwarp();
            if (lane == 0) {
              if (STREAM) cb::mbar_arrive(&wempty[ws]);
              if (kk == ng - 1) cb::mbar_arrive(&hempty[slot]);
            }
          }
        }
      } else {
        const int slot = (int)(hs % kStages);
        cb::mbar_wait(&hfull[slot], (uint32_t)((hs / kStages) & 1));
        ++hs;
        const uint8_t* st = ring + slot * kStageB;
        if (active) {
          const uint32_t* wn = reinterpret_cast<const uint32_t*>(smem + L::kOffWn);
          // the flat g_out rows d - 1, d, d + 1 (rr = 0, 1, 2: halo rows w + rr)
          const uint8_t* grow[3];
          bool gok[3];
#pragma unroll
          for (int rr = 0; rr < 3; ++rr) {
            const int dr = d - 1 + rr;
            gok[rr] = dr >= 0 && dr < D;
            grow[rr] = st + 2 * kTileB + (w + rr) * kFlatB +
                       2 * flat_skew((((long)b * D + dr) * T + t0 - 1) * O);
          }
          // g_out of row d - 1 + rr, step index j (t = t0 - 1 + j), channel o
          auto gv = [&](int rr, int j, int o) -> uint32_t {
            const int t = t0 - 1 + j;
            return (o < O && gok[rr] && t >= 0 && t < T) ? ld16(grow[rr] + (j * O + o) * 2) : 0u;
          };
          // the row's operands staged once: the adjoint's A (step, k = 2 s + o)
          // = g_out of shift s at the step, dw2's B (step, n = 2 s + o) = g_out
          // of the opposite shift (zeros past k, n = 18 stay from the start)
          uint8_t* na = smem + 9216 + w * kNstageB;
          uint8_t* ngb = na + kNaB;
          for (int e = tid - 128 * w; e < kPx * 18; e += 128) {
            const int px = e / 18, k = e - 18 * px, sh = k >> 1, o = k & 1;
            *reinterpret_cast<uint16_t*>(na + px * kNaLd + 2 * k) =
                (uint16_t)gv(sh / 3, px + sh % 3, o);
            *reinterpret_cast<uint16_t*>(ngb + px * kNgLd + 2 * k) =
                (uint16_t)gv(2 - sh / 3, px - sh % 3 + 2, o);
          }
          named_sync(1 + w, 128);
          // the adjoint with K = (shift s, channel o) pairs, k = 2 s + o: two
          // k16 steps (s < 8, then s = 8); B (k, m) = w2f[s, o, m] (wn[s]
          // holds o = 0, 1)
          const int arow = 16 * wi + (lane & 7) + (((lane >> 3) & 1) << 3);
          uint32_t af0[4], af1[4];
          ldsm_x4(af0, cb::smem_u32(na) + arow * kNaLd + (lane >> 4) * 16);
          ldsm_x4(af1, cb::smem_u32(na) + arow * kNaLd + (2 + (lane >> 4)) * 16);
#pragma unroll
          for (int jn = 0; jn < 8; ++jn) {
            const int m = 8 * jn + g;
            const uint32_t b0[2] = {wn[q * 64 + m], wn[(4 + q) * 64 + m]};
            const uint32_t b1[2] = {q == 0 ? wn[8 * 64 + m] : 0u, 0u};
            mma4(&acc[4 * jn], af0, b0);
            mma4(&acc[4 * jn], af1, b1);
          }
          // dw2 folded in, per xf row: dw2[s][m][o] += sum over this row's
          // pixels t of xf[d, t, m] g_out[d - dd + 1, t - tt + 1, o]; A = xf^T
          // (m tile wi, k = the row's pixels), B (pixel, n = 2 s + o) the
          // staged shifted g_out: three n8 tiles for the nine shifts; a fresh
          // sum a row, added into the running sums
          float pd[3][4];
#pragma unroll
          for (int nt = 0; nt < 3; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) pd[nt][e] = 0.0f;
          const uint8_t* xr = st + w * kTileB;  // xf[d, t0 .., :]
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            uint32_t af[4];
            a_frag_trans(af, xr, 16 * ks, wi, lane);
            const int brow = 16 * ks + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
            for (int nt = 0; nt < 3; ++nt) {
              uint32_t bf[2];
              ldsm_x2_trans(bf, cb::smem_u32(ngb) + brow * kNgLd + nt * 16);
              cb::mma_bf16(pd[nt], af, bf);
            }
          }
#pragma unroll
          for (int nt = 0; nt < 3; ++nt) {
            const int sh = 4 * nt + q;
            if (sh > 8) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float2* e2 = reinterpret_cast<float2*>(dw2s + (sh * 64 + R0 + 8 * h) * 2);
              const float2 v = *e2;
              *e2 = make_float2(v.x + pd[nt][2 * h], v.y + pd[nt][2 * h + 1]);
            }
          }
        }
        __syncwarp();
        if (lane == 0) cb::mbar_arrive(&hempty[slot]);
      }
      if (!active) continue;

      // ---- the pass: the row's tap, y and g_xf tiles
      cb::mbar_wait(&pfull[w], (uint32_t)(pn & 1));
      ++pn;
      uint8_t* pix = smem + L::kOffPix + w * kPixB;
      uint8_t* tap_t = pix;
      uint8_t* y_t = pix + kTileB;
      uint8_t* gx_t = pix + 2 * kTileB;
      const int tA = t0 + R0, tB = tA + 8;
      // dxf = adjoint + g_xf, zero past T
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t gx4[4];
        ldsm_x4(gx4, frag_addr(gx_t, 16 * wi, ks, lane));
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 4 * (2 * ks + (r >> 1)) + 2 * (r & 1);
          const bool in = ((r & 1) ? tB : tA) < T;
          acc[i] = in ? acc[i] + lo_f(gx4[r]) : 0.0f;
          acc[i + 1] = in ? acc[i + 1] + hi_f(gx4[r]) : 0.0f;
        }
      }
      // the flat tap run's skew (narrow)
      const int tskew = NARROW ? flat_skew((((long)b * D + d) * T + t0) * Cs) : 0;
      auto tv = [&](int r, int c) -> uint32_t {  // narrow: tap[r][c], zero past Cs
        return c < Cs ? ld16(tap_t + (tskew + r * Cs + c) * 2) : 0u;
      };
      // narrow: the tap as [64 steps][8 channels] for dw1a's ldmatrix (read
      // after this pass's barriers below)
      uint8_t* ntap = smem + 9216 + w * kNstageB + kNaB + kNgB;
      if constexpr (NARROW)
        for (int e = tid - 128 * w; e < kPx * 8; e += 128)
          *reinterpret_cast<uint16_t*>(ntap + 2 * e) = (uint16_t)tv(e >> 3, e & 7);
      float z0[2] = {1.0f, 1.0f}, z1[2] = {0.0f, 0.0f}, dp0[2] = {0.0f, 0.0f},
            dp1[2] = {0.0f, 0.0f};
      if (fuse) {
        // tap's and y's A fragments; the logits tap wxt + y wy (in lanes q = 0)
        uint32_t ta[4][4], ya[4][4];
        float lg[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          if (ks >= nct) break;
          if constexpr (NARROW) {
            ta[ks][0] = tv(R0, 2 * q) | (tv(R0, 2 * q + 1) << 16);
            ta[ks][1] = tv(R0 + 8, 2 * q) | (tv(R0 + 8, 2 * q + 1) << 16);
            ta[ks][2] = ta[ks][3] = 0u;
          } else {
            a_frag_sw(ta[ks], tap_t, 16 * wi, ks, lane);
          }
          const uint8_t* xr = wxt + g * kLdwB + (16 * ks + 2 * q) * 2;
          const uint32_t bx[2] = {ld32(xr), ld32(xr + 16)};
          cb::mma_bf16(lg, ta[ks], bx);
        }
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          a_frag_sw(ya[ks], y_t, 16 * wi, ks, lane);
          if (ks >= nmk) continue;
          const uint8_t* yr = wyt + g * kLdwB + (16 * ks + 2 * q) * 2;
          const uint32_t by[2] = {ld32(yr), ld32(yr + 16)};
          cb::mma_bf16(lg, ya[ks], by);
        }
        const int src = lane & ~3;
        const float l0a = __shfl_sync(0xffffffffu, lg[0], src);
        const float l1a = __shfl_sync(0xffffffffu, lg[1], src);
        const float l0b = __shfl_sync(0xffffffffu, lg[2], src);
        const float l1b = __shfl_sync(0xffffffffu, lg[3], src);
        // xhat = tap w1a + bvec (float32, not rounded), an n8 tile at a time,
        // into the dots dxf . xhat and dxf . y
        float s0[2] = {0.0f, 0.0f}, s1[2] = {0.0f, 0.0f};
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {  // n8 tiles 2 jp, 2 jp + 1
          float xh[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            if (ks >= nct) break;
            // B (k = tap channel, n = mid channel) = w1a by ldmatrix.trans
            const int i = lane >> 3;
            const int row = 16 * ks + ((i & 1) << 3) + (lane & 7);
            uint32_t r[4];
            cb::ldsm_x4_trans(r, cb::smem_u32(w1s + row * kLdwB + (2 * jp + (i >> 1)) * 16));
            const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
            cb::mma_bf16(xh[0], ta[ks], b0);
            cb::mma_bf16(xh[1], ta[ks], b1);
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int jn = 2 * jp + u;
            const float2 bv = *reinterpret_cast<const float2*>(bvf + 8 * jn + 2 * q);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t y2 = ya[jn >> 1][(jn & 1) * 2 + h];
              const int i = 4 * jn + 2 * h;
              s0[h] = fmaf(acc[i], xh[u][2 * h] + bv.x, s0[h]);
              s0[h] = fmaf(acc[i + 1], xh[u][2 * h + 1] + bv.y, s0[h]);
              s1[h] = fmaf(acc[i], lo_f(y2), s1[h]);
              s1[h] = fmaf(acc[i + 1], hi_f(y2), s1[h]);
            }
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            s0[h] += __shfl_xor_sync(0xffffffffu, s0[h], off);
            s1[h] += __shfl_xor_sync(0xffffffffu, s1[h], off);
          }
          z0[h] = sigmoid_fast((h ? l0b : l0a) + zo0);
          z1[h] = sigmoid_fast((h ? l1b : l1a) + zo1);
          dp0[h] = z0[h] * (1.0f - z0[h]) * s0[h];
          dp1[h] = z1[h] * (1.0f - z1[h]) * s1[h];
        }
      }
      // g_y = dxf z1 + dp wy^T (the row's; KSUM: added into the item's sum)
      float gy[32];
      if (fuse) {
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
          const float4 wy4 = *reinterpret_cast<const float4*>(wyf + 2 * (8 * jn + 2 * q));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * jn + 2 * h;
            const float v0 = fmaf(dp1[h], wy4.y, fmaf(dp0[h], wy4.x, acc[i] * z1[h]));
            const float v1 = fmaf(dp1[h], wy4.w, fmaf(dp0[h], wy4.z, acc[i + 1] * z1[h]));
            gy[i] = v0;
            gy[i + 1] = v1;
            if constexpr (KSUM) {
              S[i] += v0;
              S[i + 1] += v1;
            }
          }
        }
      }
      // g_xhat = dxf z0, dbvec; its bf16 fragments (g_tap's A operand)
      uint32_t ga[4][4];
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * jn + 2 * h;
          const float v0 = acc[i] * z0[h], v1 = acc[i + 1] * z0[h];
          dbv[2 * jn] += v0;
          dbv[2 * jn + 1] += v1;
          ga[jn >> 1][(jn & 1) * 2 + h] = bf16_io::pack2(v0, v1);
        }
      // g_tap = bf16(g_xhat) w1a^T + dp wxt^T; wide: through the warp's own
      // rows of the g_xf tile (read above, rewritten below), out as whole
      // rows of Cs channels, 16 bytes a lane
      const long row_base = ((long)b * D + d) * T;
      const int nnt = (Cs + 7) / 8;
      for (int ntp = 0; ntp < (nnt + 1) / 2; ++ntp) {
        uint32_t o4[4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int nt = 2 * ntp + u;
          float gt[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if (nt < nnt) {
#pragma unroll
            for (int ks = 0; ks < 4; ++ks) {
              if (ks >= nmk) break;
              const uint8_t* wr = w1s + (8 * nt + g) * kLdwB + (16 * ks + 2 * q) * 2;
              const uint32_t bf[2] = {ld32(wr), ld32(wr + 16)};
              cb::mma_bf16(gt, ga[ks], bf);
            }
          }
          const int c = 8 * nt + 2 * q;
          const float4 wx4 = *reinterpret_cast<const float4*>(wxf + 2 * (c & 63));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v0 = gt[2 * h], v1 = gt[2 * h + 1];
            if (fuse) {
              v0 += fmaf(dp1[h], wx4.y, dp0[h] * wx4.x);
              v1 += fmaf(dp1[h], wx4.w, dp0[h] * wx4.z);
            }
            o4[2 * u + h] = bf16_io::pack2(v0, v1);
            if constexpr (NARROW) {  // rows of Cs <= 4 channels: stored as they are
              const int t = h ? tB : tA;
              bf16* dst = a.gtap + (row_base + t) * Cs + c;
              if (t < T && c < Cs) bf16_io::st1(dst, v0);
              if (t < T && c + 1 < Cs) bf16_io::st1(dst + 1, v1);
            }
          }
        }
        if constexpr (!NARROW) stsm_x4(frag_addr(gx_t, 16 * wi, ntp, lane), o4);
      }
      if constexpr (!NARROW) {
        __syncwarp();
        const int units = Cs / 8;  // 16-byte units of a g_tap row
        for (int ci = lane; ci < 16 * units; ci += 32) {
          const int row = 16 * wi + ci / units, unit = ci % units, t = t0 + row;
          if (t < T)
            *reinterpret_cast<uint4*>(a.gtap + (row_base + t) * Cs + 8 * unit) =
                *reinterpret_cast<const uint4*>(gx_t + row * kRowB + ((unit ^ (row & 7)) << 4));
        }
        __syncwarp();
      }
      // bf16(g_xhat) over this warp's rows of the g_xf tile, bf16(dp)^T (once
      // every warp has read the previous row's)
      named_sync(1 + w, 128);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) stsm_x4(frag_addr(gx_t, 16 * wi, ks, lane), ga[ks]);
      if (fuse && q == 0) {
        bf16* dp16 = reinterpret_cast<bf16*>(dpt);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          dp16[R0 + 8 * h] = __float2bfloat16_rn(dp0[h]);
          dp16[kLdw + R0 + 8 * h] = __float2bfloat16_rn(dp1[h]);
          dz[0] += dp0[h];
          dz[1] += dp1[h];
        }
      }
      named_sync(1 + w, 128);
      // dw1a (c tiles x mid channels 16 wi ..), dwxt (c tile wi), dwy (m tile
      // wi): fresh sums over the row's 64 pixels, added into the running ones
      uint32_t bdp[4][2];
      if (fuse) {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const uint8_t* dr = dpt + g * kLdwB + (16 * ks + 2 * q) * 2;
          bdp[ks][0] = ld32(dr);
          bdp[ks][1] = ld32(dr + 16);
        }
      }
#pragma unroll
      for (int ct = 0; ct < NCT; ++ct) {
        if (ct >= nct) break;
        float pa[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
        float px4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t af[4];
          if constexpr (NARROW) {
            uint32_t r2[2];
            const int row = 16 * ks + (lane & 7) + (((lane >> 3) & 1) << 3);
            ldsm_x2_trans(r2, cb::smem_u32(ntap) + row * kNtLd);
            af[0] = r2[0];
            af[1] = 0u;
            af[2] = r2[1];
            af[3] = 0u;
          } else {
            a_frag_trans(af, tap_t, 16 * ks, ct, lane);
          }
          uint32_t bg[2][2];
          b_frags_trans(bg, gx_t, 16 * ks, wi, lane);
          cb::mma_bf16(pa[0], af, bg[0]);
          cb::mma_bf16(pa[1], af, bg[1]);
          if (fuse && ct == wi) cb::mma_bf16(px4, af, bdp[ks]);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dwa[ct][n][e] += pa[n][e];
        if (fuse && ct == wi)
#pragma unroll
          for (int e = 0; e < 4; ++e) dwx[e] += px4[e];
      }
      if (fuse) {
        float py[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t af[4];
          a_frag_trans(af, y_t, 16 * ks, wi, lane);
          cb::mma_bf16(py, af, bdp[ks]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) dwyv[e] += py[e];
      }
      // g_res: the item's g_y (k = 1: this row's), rounded once
      if (fuse && (a.k == 1 || pi == a.ppg - 1)) {
        const int r = d / a.k;
        if constexpr (KSUM) {
#pragma unroll
          for (int i = 0; i < 32; ++i) gy[i] = S[i], S[i] = 0.0f;
        }
        if (a.k != 1) {
          // consumer 1's sum handed to consumer 0 through the carry buffer,
          // on barriers of their own: neither waits for the other's pass
          // [warp][8][lane] float4s: a warp's slice is its own 4 KB
          float4* carry = reinterpret_cast<float4*>(smem + L::kOffCarry) + wi * 8 * 32 + lane;
          const uint32_t par = (uint32_t)(nc & 1);
          ++nc;
          if (w == 1) {
            cb::mbar_wait(cempty, par ^ 1);
#pragma unroll
            for (int i = 0; i < 8; ++i)
              carry[32 * i] = make_float4(gy[4 * i], gy[4 * i + 1], gy[4 * i + 2], gy[4 * i + 3]);
            __syncwarp();
            if (lane == 0) cb::mbar_arrive(cfull);
          } else {
            cb::mbar_wait(cfull, par);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float4 v = carry[32 * i];
              gy[4 * i] += v.x, gy[4 * i + 1] += v.y, gy[4 * i + 2] += v.z, gy[4 * i + 3] += v.w;
            }
            __syncwarp();
          }
        }
        if (a.k == 1 || w == 0) {
          // through the warp's 2 KB of the carry buffer (k > 1: its slice,
          // read just above), out as whole rows, 16 bytes a lane
          uint8_t* go = smem + L::kOffCarry + (a.k == 1 ? (4 * w + wi) * 2048 : wi * 4096);
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            const uint32_t o4[4] = {bf16_io::pack2(gy[8 * ks], gy[8 * ks + 1]),
                                    bf16_io::pack2(gy[8 * ks + 2], gy[8 * ks + 3]),
                                    bf16_io::pack2(gy[8 * ks + 4], gy[8 * ks + 5]),
                                    bf16_io::pack2(gy[8 * ks + 6], gy[8 * ks + 7])};
            stsm_x4(frag_addr(go, 0, ks, lane), o4);
          }
          __syncwarp();
          const long rbase = ((long)b * a.Dp + r) * T;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int ci = lane + 32 * i, row = ci >> 3, unit = ci & 7, t = t0 + 16 * wi + row;
            if (t < T && 8 * unit < M)
              *reinterpret_cast<uint4*>(a.gres + (rbase + t) * M + 8 * unit) =
                  *reinterpret_cast<const uint4*>(go + row * kRowB + ((unit ^ (row & 7)) << 4));
          }
          __syncwarp();
          if (a.k != 1 && lane == 0) cb::mbar_arrive(cempty);
        }
      }
      // the tiles go back to the producer (the next TMA overwrites what the
      // threads wrote: order the generic writes before the async proxy)
      fence_async_smem();
      __syncwarp();
      if (lane == 0) cb::mbar_arrive(&pempty[w]);
    }
  }

  // ---- the block's partial, every sum added in a fixed order
  named_sync(3, 256);  // the ring is free: every staged copy was consumed
  float* red = reinterpret_cast<float*>(ring);
  const int nA = Cs * M + 2 * Cs + 2 * M + (NARROW ? 9 * M * O : 0);
  float* A0 = red + w * nA;               // per warpgroup: entries each thread owns
  float* Bv = red + 2 * nA;               // dbvec [2][4][8][64]
  float* Bz = Bv + kConsumers * 4 * 8 * 64;  // dzoff [2][4][8][2]
  const int ctid = tid;                   // 0 .. 255
#pragma unroll
  for (int ct = 0; ct < NCT; ++ct) {
    if (ct >= nct) break;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 16 * ct + g + 8 * h, m = 16 * wi + 8 * n + 2 * q + e;
          if (c < Cs && m < M) A0[c * M + m] = dwa[ct][n][2 * h + e];
        }
  }
  if (fuse && q == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 16 * wi + g + 8 * h, m = c;
        if (wi < nct && c < Cs) A0[Cs * M + 2 * c + e] = dwx[2 * h + e];
        if (m < M) A0[Cs * M + 2 * Cs + 2 * m + e] = dwyv[2 * h + e];
      }
  }
  if constexpr (NARROW) {
    for (int e = tid % 128; e < 9 * M * O; e += 128) {
      const int o = e % O, m = (e / O) % M, sh = e / (O * M);
      A0[Cs * M + 2 * Cs + 2 * M + e] = dw2s[(sh * 64 + m) * 2 + o];
    }
  }
  {
    float* bv = Bv + ((w * 4 + wi) * 8 + g) * 64;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int e = 0; e < 2; ++e) bv[8 * jn + 2 * q + e] = dbv[2 * jn + e];
    if (q == 0) {
      Bz[((w * 4 + wi) * 8 + g) * 2] = dz[0];
      Bz[((w * 4 + wi) * 8 + g) * 2 + 1] = dz[1];
    }
  }
  named_sync(3, 256);
  float* dst = a.partial + (size_t)blockIdx.x * a.n_part;
  const int n_small = 3 * M + 2 * Cs + 2;
  for (int e = ctid; e < a.n_part; e += 256) {
    float v = 0.0f;
    if (e < Cs * M) {
      v = red[e] + red[nA + e];
    } else if (e < Cs * M + M) {
      const int m = e - Cs * M;
      for (int s = 0; s < kConsumers * 4 * 8; ++s) v += Bv[s * 64 + m];
    } else if (e < Cs * M + M + 2 * Cs + 2 * M) {
      const int o = e - M;  // dwxt, dwy at their place in A0
      v = fuse ? red[o] + red[nA + o] : 0.0f;
    } else if (e < Cs * M + n_small) {
      const int j = e - (Cs * M + n_small - 2);
      if (fuse)
        for (int s = 0; s < kConsumers * 4 * 8; ++s) v += Bz[s * 2 + j];
    } else {
      const int o = e - (Cs * M + n_small) + Cs * M + 2 * Cs + 2 * M;
      v = red[o] + red[nA + o];
    }
    dst[e] = v;
  }
}

// The 1x1 weights of xf's forming, as the kernels stage them in shared
// memory: w1a [c][m] and wxt^T, wy^T [8][.] (bf16, kLdw), bvec (float).
struct FormW {
  const uint8_t* w1s;
  const uint8_t* wxt;
  const uint8_t* wyt;
  const float* bvf;
  float zo0, zo1;
};

__device__ __forceinline__ FormW form_weights(const uint8_t* w1s, const uint8_t* wxt,
                                              const uint8_t* wyt, const uint8_t* bvf,
                                              const float* zoff) {
  return FormW{w1s, wxt, wyt, reinterpret_cast<const float*>(bvf),
               zoff ? __ldg(zoff) : 0.0f, zoff ? __ldg(zoff + 1) : 0.0f};
}

// xf (the blend of xhat and y) for the warp's 16 rows 16 wq .. 16 wq + 15 of
// a 64-step tile, from the staged tap (a swizzled tile, or NARROW a flat run
// `tskew` elements into its box) and y (a swizzled tile), into the swizzled
// tile `xo` by stmatrix (xo may be y's own tile: the warp's y is read into
// registers first).  The 1x1 products on mma.sync m16n8k16: xhat = bf16(tap
// w1a summed from zero, then + bvec), the logits tap wxt + y wy + zoff in
// float32, z rounded to bf16 for the blend, each blend product and their sum
// rounded to bf16 (bf16x2 products and sums: a product of two bf16 values is
// exact before it rounds).  Row 16 wq + g (keep0) and row 16 wq + g + 8
// (keep1) of the lane's fragments are written as zeros where not kept.
template <bool NARROW>
__device__ __forceinline__ void form_xf(const uint8_t* tap_t, int tskew, const uint8_t* y_t,
                                        uint8_t* xo, int wq, int lane, const FormW& w, bool fuse,
                                        int Cs, int M, bool keep0, bool keep1) {
  const int g = lane / 4, q = lane % 4, R0 = 16 * wq + g;
  const int nct = NARROW ? 1 : (Cs + 15) / 16, nmk = (M + 15) / 16;
  auto tv = [&](int r, int c) -> uint32_t {
    return c < Cs ? ld16(tap_t + (tskew + r * Cs + c) * 2) : 0u;
  };
  uint32_t ta[4][4], ya[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if (ks >= nct) break;
    if constexpr (NARROW) {
      ta[ks][0] = tv(R0, 2 * q) | (tv(R0, 2 * q + 1) << 16);
      ta[ks][1] = tv(R0 + 8, 2 * q) | (tv(R0 + 8, 2 * q + 1) << 16);
      ta[ks][2] = ta[ks][3] = 0u;
    } else {
      a_frag_sw(ta[ks], tap_t, 16 * wq, ks, lane);
    }
  }
  float z0[2] = {1.0f, 1.0f}, z1[2] = {0.0f, 0.0f};
  if (fuse) {
    float lg[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (ks >= nct) break;
      const uint8_t* xr = w.wxt + g * kLdwB + (16 * ks + 2 * q) * 2;
      const uint32_t bx[2] = {ld32(xr), ld32(xr + 16)};
      cb::mma_bf16(lg, ta[ks], bx);
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      a_frag_sw(ya[ks], y_t, 16 * wq, ks, lane);
      if (ks >= nmk) continue;
      const uint8_t* yr = w.wyt + g * kLdwB + (16 * ks + 2 * q) * 2;
      const uint32_t by[2] = {ld32(yr), ld32(yr + 16)};
      cb::mma_bf16(lg, ya[ks], by);
    }
    const int src = lane & ~3;
    const float la[4] = {__shfl_sync(0xffffffffu, lg[0], src), __shfl_sync(0xffffffffu, lg[1], src),
                         __shfl_sync(0xffffffffu, lg[2], src), __shfl_sync(0xffffffffu, lg[3], src)};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      z0[h] = sigmoid_fast(la[2 * h] + w.zo0);
      z1[h] = sigmoid_fast(la[2 * h + 1] + w.zo1);
    }
  }
  // z rounded to bf16, paired for the blend's bf16x2 products
  __nv_bfloat162 z02[2], z12[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    z02[h] = __float2bfloat162_rn(z0[h]);
    z12[h] = __float2bfloat162_rn(z1[h]);
  }
  const uint32_t keep[2] = {keep0 ? 0xffffffffu : 0u, keep1 ? 0xffffffffu : 0u};
#pragma unroll
  for (int jp = 0; jp < 4; ++jp) {
    uint32_t o4[4];
    float xh[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (ks >= nct) break;
      const int i = lane >> 3;
      const int row = 16 * ks + ((i & 1) << 3) + (lane & 7);
      uint32_t r[4];
      cb::ldsm_x4_trans(r, cb::smem_u32(w.w1s + row * kLdwB + (2 * jp + (i >> 1)) * 16));
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      cb::mma_bf16(xh[0], ta[ks], b0);
      cb::mma_bf16(xh[1], ta[ks], b1);
    }
#pragma unroll
    for (int uu = 0; uu < 2; ++uu) {
      const int jn = 2 * jp + uu, c = 8 * jn + 2 * q;
      const float2 bv = *reinterpret_cast<const float2*>(w.bvf + c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // xhat rounded; the blend's products and their sum each rounded
        // once (a product of two bf16 values is exact before it rounds)
        __nv_bfloat162 v = __floats2bfloat162_rn(xh[uu][2 * h] + bv.x, xh[uu][2 * h + 1] + bv.y);
        if (fuse) {
          const uint32_t y2 = ya[jn >> 1][(jn & 1) * 2 + h];
          v = __hadd2(__hmul2(v, z02[h]),
                      __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&y2), z12[h]));
        }
        o4[2 * uu + h] = *reinterpret_cast<const uint32_t*>(&v) & keep[h];
      }
    }
    stsm_x4(frag_addr(xo, 16 * wq, jp, lane), o4);
  }
}

// ------------------------------------------------------- K5f's xf pass
//
// xf = the blend of xhat and y (abf_block_fwd.cu's function) for 64-step
// tiles of one freq row: a persistent grid of two blocks an SM, each walking
// pairs of tiles (four warps a tile, 16 steps a warp) through a ring of three
// stages that thread 0 fills by TMA (the tap tile, 4-D or a flat run, and the
// residual row's tile) two pairs ahead.  Each warp forms its 16 rows
// (form_xf), staged in shared memory, and writes them as whole rows, 16 bytes
// a lane: 4-byte stores of the fragments ran the pass at twice the time.
constexpr int kXfThreads = 256;
constexpr int kXfStages = 3;
constexpr int kXfStageB = 4 * kTileB;  // two tiles' tap and y
constexpr int kXfOffW1 = kXfStages * kXfStageB;
constexpr int kXfOffWxT = kXfOffW1 + 64 * kLdwB;
constexpr int kXfOffWyT = kXfOffWxT + 8 * kLdwB;
constexpr int kXfOffBvF = kXfOffWyT + 8 * kLdwB;
constexpr int kXfOffBar = kXfOffBvF + 64 * 4;
constexpr int kXfSmemB = kXfOffBar + 2 * kXfStages * 8 + 1024;

struct XfArgs {
  const bf16* w1a;
  const float* bvec;
  const bf16* wxt;
  const bf16* wy;
  const float* zoff;
  bf16* xf;
  int D, k, T, Cs, M, fuse, t_tiles;
  long tiles, pairs;
};

template <bool NARROW>
__global__ void __launch_bounds__(kXfThreads, 2)
abf_block_bf16_xf_mma_kernel(const __grid_constant__ CUtensorMap tmap,  // tap (4-D) or flat
                         const __grid_constant__ CUtensorMap ymap,  // res
                         XfArgs a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (cb::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kXfOffBar);
  uint64_t* empty = full + kXfStages;
  const int tid = threadIdx.x;
  const int Cs = a.Cs, M = a.M, T = a.T, D = a.D;
  const bool fuse = a.fuse != 0;
  {
    const uint16_t* w1 = reinterpret_cast<const uint16_t*>(a.w1a);
    uint16_t* w1s = reinterpret_cast<uint16_t*>(smem + kXfOffW1);
    for (int e = tid; e < 64 * 64; e += kXfThreads) {
      const int c = e / 64, m = e % 64;
      w1s[c * kLdw + m] = (c < Cs && m < M) ? w1[c * M + m] : 0;
    }
    uint16_t* wxt = reinterpret_cast<uint16_t*>(smem + kXfOffWxT);
    uint16_t* wyt = reinterpret_cast<uint16_t*>(smem + kXfOffWyT);
    const uint16_t* wx = reinterpret_cast<const uint16_t*>(a.wxt);
    const uint16_t* wy = reinterpret_cast<const uint16_t*>(a.wy);
    for (int e = tid; e < 8 * 64; e += kXfThreads) {
      const int j = e / 64, c = e % 64;
      wxt[j * kLdw + c] = (fuse && j < 2 && c < Cs) ? wx[c * 2 + j] : 0;
      wyt[j * kLdw + c] = (fuse && j < 2 && c < M) ? wy[c * 2 + j] : 0;
    }
    float* bvf = reinterpret_cast<float*>(smem + kXfOffBvF);
    for (int e = tid; e < 64; e += kXfThreads) bvf[e] = e < M ? __ldg(a.bvec + e) : 0.0f;
  }
  if (tid == 0) {
    for (int i = 0; i < kXfStages; ++i) {
      cb::mbar_init(&full[i], 1);
      cb::mbar_init(&empty[i], kXfThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int tap_box_b = NARROW ? ((kPx * Cs + 7) / 8 + 1) * 16 : kTileB;
  const long my_pairs = blockIdx.x < a.pairs ? (a.pairs - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  // tile tl of the map: (b, d, t0)
  auto tile_of = [&](long tl, int* b, int* d, int* t0) {
    const int bd = (int)(tl / a.t_tiles);
    *t0 = (int)(tl - (long)bd * a.t_tiles) * kPx;
    *b = bd / D;
    *d = bd - *b * D;
  };
  auto issue = [&](long li) {  // the pair li of this block into its stage
    const int slot = (int)(li % kXfStages);
    cb::mbar_wait(&empty[slot], (uint32_t)(((li / kXfStages) & 1) ^ 1));
    const long j = blockIdx.x + li * gridDim.x;
    int n = 0;
    for (int u = 0; u < 2; ++u) n += 2 * j + u < a.tiles;
    cb::mbar_expect_tx(&full[slot], (uint32_t)(n * (tap_box_b + (fuse ? kTileB : 0))));
    for (int u = 0; u < 2; ++u) {
      const long tl = 2 * j + u;
      if (tl >= a.tiles) continue;
      int b, d, t0;
      tile_of(tl, &b, &d, &t0);
      uint8_t* st = smem + slot * kXfStageB + u * 2 * kTileB;
      if constexpr (NARROW)
        tma_load_2d(st, &tmap, &full[slot], 0, flat_row((((long)b * D + d) * T + t0) * Cs));
      else
        cb::tma_load_4d(st, &tmap, &full[slot], 0, t0, d, b);
      if (fuse) cb::tma_load_4d(st + kTileB, &ymap, &full[slot], 0, t0, d / a.k, (int)b);
    }
  };
  if (tid == 0)
    for (long li = 0; li < 2 && li < my_pairs; ++li) issue(li);
  const int wi = tid / 32, lane = tid % 32;
  const int u = wi / 4, wq = wi % 4;  // the warp's tile of the pair and its 16 steps
  const FormW fw = form_weights(smem + kXfOffW1, smem + kXfOffWxT, smem + kXfOffWyT,
                                smem + kXfOffBvF, fuse ? a.zoff : nullptr);
  for (long li = 0; li < my_pairs; ++li) {
    if (tid == 0 && li + 2 < my_pairs) issue(li + 2);
    const int slot = (int)(li % kXfStages);
    cb::mbar_wait(&full[slot], (uint32_t)((li / kXfStages) & 1));
    const long tl = 2 * (blockIdx.x + li * gridDim.x) + u;
    if (tl < a.tiles) {
      int b, d, t0;
      tile_of(tl, &b, &d, &t0);
      const uint8_t* tap_t = smem + slot * kXfStageB + u * 2 * kTileB;
      const uint8_t* y_t = tap_t + kTileB;
      const int tskew = NARROW ? flat_skew((((long)b * D + d) * T + t0) * Cs) : 0;
      bf16* xrow = a.xf + (((long)b * D + d) * T) * M;
      // xf goes through the warp's own 16 rows of the y tile (its y is in
      // registers already), then out as whole rows, 16 bytes a lane
      uint8_t* xo = smem + slot * kXfStageB + u * 2 * kTileB + kTileB;
      form_xf<NARROW>(tap_t, tskew, y_t, xo, wq, lane, fw, fuse, Cs, M, true, true);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ci = lane + 32 * i, row = 16 * wq + (ci >> 3), unit = ci & 7, t = t0 + row;
        if (t < T && 8 * unit < M)
          *reinterpret_cast<uint4*>(xrow + (long)t * M + 8 * unit) =
              *reinterpret_cast<const uint4*>(xo + row * kRowB + ((unit ^ (row & 7)) << 4));
      }
    }
    __syncwarp();
    if (lane == 0) cb::mbar_arrive(&empty[slot]);
  }
}

// ------------------------------------------ K5f formed and convolved in one
//
// out = conv3x3_same(xf, w2) with xf formed in shared memory and convolved
// there, as _fwd_kernel does in VMEM (route "fused" wide, O <= 64: the
// weights of every output channel resident).  A work item is one batch row
// b, one strip of kFfStride = 62 output steps t0 .. t0 + 61 and a chunk of
// up to kFfRows freq rows d0 .. d1 - 1; the strip's xf rows span the 64
// steps t0 - 1 .. t0 + 62, one m64 extent, so a row is formed by whole m16
// tiles with nothing past it.  Two consumer warpgroups, each on its own
// items (the block's items w, w + 2, ...), and a producer warpgroup whose
// warps 0 and 1 each keep one consumer's ring of tap and res tiles full by
// TMA (zeros outside the map).  A consumer walks its chunk's rows d0 - 1 ..
// d1 in order: it forms each row into a ring of four xf rows (form_xf, each
// warp 16 steps, zeros outside the map: the SAME padding) and writes the
// rows it owns (steps t0 .. t0 + 61 of rows d0 .. d1 - 1; the chunk's edge
// rows are formed again by its neighbours) to xf once, 16 bytes a lane; it
// convolves row d from rows d - 1, d, d + 1 with wgmma m64nBNk16 as the bf16
// K3f's tile (A the xf row through a descriptor shifted by the time shift,
// B the resident weights, a fresh accumulator per 16-channel group added
// into the running sum), stages out in row d - 1's slot by stmatrix and
// writes it as whole rows, then forms row d + 2.  The other warpgroup's
// products fill the tensor cores while one forms.  BN = 64 or 32 output
// channels; out's bits are the wgmma tile's and xf's the xf pass's.
// Measured (NVIDIA H100 80GB HBM3, 700 W; scripts/kernel_pair_timing.py
// against the xf pass followed by the tile): 0.239 against 0.269 ms at the
// reference block (O = 64), 0.38 against 0.46 at O = 32; at O = 128 and 256
// each block of output channels forms xf again and the two passes are
// faster (0.233 against 0.244, 0.218 against 0.266 ms), so they stay there.
constexpr int kFfStride = kPx - 2;             // output steps of a strip
constexpr int kFfMaxO = 64;                    // every output channel's weights resident
constexpr int kFfRows = 32;                    // freq rows of an item
constexpr int kFfSlots = 4;                    // xf rows of a consumer's ring
constexpr int kFfStages = 2;                   // tap and res tiles of a consumer's ring
constexpr int kFfThreads = 3 * 128;            // two consumer warpgroups and the producer's
constexpr int kFfSlotB = 9 * 1024;             // an xf row (64 steps and 2 past), 1024-aligned
constexpr int kFfOffX = 9 * 64 * kRowB;        // after the weights (BN <= 64)
constexpr int kFfOffSt = kFfOffX + kConsumers * kFfSlots * kFfSlotB;
constexpr int kFfOffW1 = kFfOffSt + kConsumers * kFfStages * 2 * kTileB;
constexpr int kFfOffWxT = kFfOffW1 + 64 * kLdwB;
constexpr int kFfOffWyT = kFfOffWxT + 8 * kLdwB;
constexpr int kFfOffBvF = kFfOffWyT + 8 * kLdwB;
constexpr int kFfOffBar = kFfOffBvF + 64 * 4;
constexpr int kFfSmemB = kFfOffBar + (1 + 2 * kConsumers * kFfStages) * 8 + 1024;
static_assert(kFfSmemB <= cb::kSmemLimit, "fused forward's shared memory");

struct FfArgs {
  const bf16* w1a;
  const float* bvec;
  const bf16* wxt;
  const bf16* wy;
  const float* zoff;
  bf16* xf;
  bf16* out;
  int B, D, k, T, Cs, M, O, fuse, strips, chunks;
  long items;
};

template <int BN>
__global__ void __launch_bounds__(kFfThreads, 1)
abf_block_bf16_fwd_fused_kernel(const __grid_constant__ CUtensorMap tmap,  // tap, 64-step boxes
                                const __grid_constant__ CUtensorMap ymap,  // res
                                const __grid_constant__ CUtensorMap wmap,  // packed w2
                                FfArgs a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (cb::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* wbar = reinterpret_cast<uint64_t*>(smem + kFfOffBar);
  uint64_t* full = wbar + 1;                      // [consumer][stage]
  uint64_t* empty = full + kConsumers * kFfStages;
  const int tid = threadIdx.x;
  const int Cs = a.Cs, M = a.M, O = a.O, D = a.D, T = a.T;
  const bool fuse = a.fuse != 0;
  {
    const uint16_t* w1 = reinterpret_cast<const uint16_t*>(a.w1a);
    uint16_t* w1s = reinterpret_cast<uint16_t*>(smem + kFfOffW1);
    for (int e = tid; e < 64 * 64; e += kFfThreads) {
      const int c = e / 64, m = e % 64;
      w1s[c * kLdw + m] = (c < Cs && m < M) ? w1[c * M + m] : 0;
    }
    uint16_t* wxt = reinterpret_cast<uint16_t*>(smem + kFfOffWxT);
    uint16_t* wyt = reinterpret_cast<uint16_t*>(smem + kFfOffWyT);
    const uint16_t* wx = reinterpret_cast<const uint16_t*>(a.wxt);
    const uint16_t* wy = reinterpret_cast<const uint16_t*>(a.wy);
    for (int e = tid; e < 8 * 64; e += kFfThreads) {
      const int j = e / 64, c = e % 64;
      wxt[j * kLdw + c] = (fuse && j < 2 && c < Cs) ? wx[c * 2 + j] : 0;
      wyt[j * kLdw + c] = (fuse && j < 2 && c < M) ? wy[c * 2 + j] : 0;
    }
    float* bvf = reinterpret_cast<float*>(smem + kFfOffBvF);
    for (int e = tid; e < 64; e += kFfThreads) bvf[e] = e < M ? __ldg(a.bvec + e) : 0.0f;
    // the rows past 64 of each xf slot, which the products of the last two
    // output rows read (those rows are not written): zeros
    for (int e = tid; e < kConsumers * kFfSlots * 64; e += kFfThreads)
      reinterpret_cast<uint4*>(smem + kFfOffX + (e / 64) * kFfSlotB + 64 * kRowB)[e % 64] =
          make_uint4(0u, 0u, 0u, 0u);
  }
  if (tid == 0) {
    cb::mbar_init(wbar, 1);
    for (int i = 0; i < kConsumers * kFfStages; ++i) {
      cb::mbar_init(&full[i], 1);
      cb::mbar_init(&empty[i], 4);  // the consumer's warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const long my_items =
      blockIdx.x < a.items ? (a.items - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  // item j -> (b, strip, chunk); its rows d0 .. d1 - 1 and first xf step
  auto item_of = [&](long li, int* b, int* w0, int* d0, int* d1) {
    const long j = blockIdx.x + li * gridDim.x;
    const int c = (int)(j % a.chunks);
    const long bs = j / a.chunks;
    *w0 = (int)(bs % a.strips) * kFfStride - 1;
    *b = (int)(bs / a.strips);
    *d0 = c * kFfRows;
    *d1 = min(*d0 + kFfRows, D);
  };
  const int wg = tid / 128;
  if (wg == kConsumers) {  // the producer warpgroup: lane 0 of warps 0 and 1
    cb::setmaxnreg_dec<cb::kFwdProducerRegs>();
    const int p = (tid / 32) % 4;
    if (tid % 32 == 0 && p < kConsumers) {
      if (p == 0) {
        cb::mbar_expect_tx(wbar, (uint32_t)(9 * BN * kRowB));
        for (int k = 0; k < 9; ++k)
          cb::tma_load_3d(smem + k * BN * kRowB, &wmap, wbar, 0, 0, k);
      }
      long s = 0;
      for (long li = p; li < my_items; li += kConsumers) {
        int b, w0, d0, d1;
        item_of(li, &b, &w0, &d0, &d1);
        for (int x = max(d0 - 1, 0); x <= min(d1, D - 1); ++x, ++s) {
          const int slot = p * kFfStages + (int)(s % kFfStages);
          cb::mbar_wait(&empty[slot], (uint32_t)(((s / kFfStages) & 1) ^ 1));
          cb::mbar_expect_tx(&full[slot], (uint32_t)(fuse ? 2 * kTileB : kTileB));
          uint8_t* st = smem + kFfOffSt + slot * 2 * kTileB;
          cb::tma_load_4d(st, &tmap, &full[slot], 0, w0, x, b);
          if (fuse) cb::tma_load_4d(st + kTileB, &ymap, &full[slot], 0, w0, x / a.k, b);
        }
      }
    }
    return;
  }
  cb::setmaxnreg_inc<cb::kFwdConsumerRegs>();
  const int wq = (tid / 32) % 4, lane = tid % 32, g = lane / 4;
  const FormW fw = form_weights(smem + kFfOffW1, smem + kFfOffWxT, smem + kFfOffWyT,
                                smem + kFfOffBvF, fuse ? a.zoff : nullptr);
  uint8_t* ring = smem + kFfOffX + wg * kFfSlots * kFfSlotB;
  const uint64_t wdesc = cb::sw128_desc(cb::smem_u32(smem), 16, 1024);
  const int groups16 = (M + 15) / 16;
  cb::mbar_wait(wbar, 0);
  long s = 0;
  // row x of the item (b, w0, d0, d1) into its slot of the ring: formed from
  // the next staged tiles, or zeros outside the map; the rows it owns to xf
  auto form_row = [&](int x, int b, int w0, int d0, int d1) {
    uint8_t* xs = ring + ((x - d0 + 1) & 3) * kFfSlotB;
    if (x < 0 || x >= D) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        reinterpret_cast<uint4*>(xs + 16 * wq * kRowB)[lane + 32 * i] = make_uint4(0u, 0u, 0u, 0u);
      return;
    }
    const int slot = wg * kFfStages + (int)(s % kFfStages);
    cb::mbar_wait(&full[slot], (uint32_t)((s / kFfStages) & 1));
    const uint8_t* st = smem + kFfOffSt + slot * 2 * kTileB;
    const int r0 = w0 + 16 * wq + g;
    form_xf<false>(st, 0, st + kTileB, xs, wq, lane, fw, fuse, Cs, M, r0 >= 0 && r0 < T,
                   r0 + 8 < T);
    __syncwarp();
    if (lane == 0) cb::mbar_arrive(&empty[slot]);
    ++s;
    if (x < d0 || x >= d1) return;
    bf16* xrow = a.xf + ((long)b * D + x) * T * M;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ci = lane + 32 * i, row = 16 * wq + (ci >> 3), unit = ci & 7, t = w0 + row;
      if (row >= 1 && row <= kFfStride && t < T && 8 * unit < M)
        *reinterpret_cast<uint4*>(xrow + (long)t * M + 8 * unit) =
            *reinterpret_cast<const uint4*>(xs + row * kRowB + ((unit ^ (row & 7)) << 4));
    }
  };
  for (long li = wg; li < my_items; li += kConsumers) {
    int b, w0, d0, d1;
    item_of(li, &b, &w0, &d0, &d1);
    for (int x = d0 - 1; x <= d0 + 1; ++x) form_row(x, b, w0, d0, d1);
    for (int d = d0; d < d1; ++d) {
      // rows d - 1 .. d + 1 formed
      fence_async_smem();  // the rows written by this proxy, seen by wgmma's
      named_sync(1 + wg, 128);
      const uint32_t xb0 = cb::smem_u32(ring + ((d - d0) & 3) * kFfSlotB);
      const uint32_t xb1 = cb::smem_u32(ring + ((d - d0 + 1) & 3) * kFfSlotB);
      const uint32_t xb2 = cb::smem_u32(ring + ((d - d0 + 2) & 3) * kFfSlotB);
      // one 16-channel group's nine shifts in flight, then its sum added into
      // the running one (a read of a group's sums while the next group's
      // products are in flight made ptxas serialize the wgmma, C7514)
      float acc[BN / 2], part[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk >= groups16) break;
        cb::wg_fence();
#pragma unroll
        for (int k = 0; k < 9; ++k) {  // shift (dd, tt) = (k / 3, k % 3)
          const uint32_t xb = k < 3 ? xb0 : k < 6 ? xb1 : xb2;
          cb::wgmma_ss_bn<BN>(part, cb::sw128_desc(xb + (k % 3) * kRowB + 32 * kk, 16, 1024),
                              wdesc + (uint64_t)(((k * BN * kRowB) + 32 * kk) >> 4), k);
        }
        cb::wg_commit();
        cb::wg_wait<0>();
        cb::fold(acc, part);
      }
      // every warp's products read row d - 1's slot: out goes there after
      named_sync(1 + wg, 128);
      uint8_t* os = ring + ((d - d0) & 3) * kFfSlotB;
#pragma unroll
      for (int jp = 0; jp < BN / 16; ++jp) {
        uint32_t o4[4];
#pragma unroll
        for (int uu = 0; uu < 2; ++uu)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            o4[2 * uu + h] = bf16_io::pack2(acc[4 * (2 * jp + uu) + 2 * h],
                                            acc[4 * (2 * jp + uu) + 2 * h + 1]);
        stsm_x4(frag_addr(os, 16 * wq, jp, lane), o4);
      }
      __syncwarp();
      bf16* orow = a.out + ((long)b * D + d) * T * O;
#pragma unroll
      for (int i = 0; i < BN / 16; ++i) {
        const int ci = lane + 32 * i, row = 16 * wq + ci / (BN / 8), unit = ci % (BN / 8);
        const int t = w0 + 1 + row;
        if (row < kFfStride && t < T && 8 * unit < O)
          *reinterpret_cast<uint4*>(orow + (long)t * O + 8 * unit) =
              *reinterpret_cast<const uint4*>(os + row * kRowB + ((unit ^ (row & 7)) << 4));
      }
      __syncwarp();
      // row d + 2 into row d - 2's slot (out went to row d - 1's)
      if (d + 2 <= d1) form_row(d + 2, b, w0, d0, d1);
    }
  }
}

// ------------------------------------------ K5f's conv at the mask block
//
// out = conv3x3_same(xf, w2) for O = 2 output channels (the narrow route):
// a block takes one batch row's 64-step strip over kNcRows freq rows and
// walks them in order with a ring of four xf rows (66 steps each, by TMA,
// 128-byte swizzle, zeros outside the map), loading row d + 2 while row d is
// convolved, so each xf row is read about once (the wgmma tile's boxes read
// it three times).  Four warps, 16 steps each: mma.sync m16n8k16 with A the
// shifted xf rows by ldmatrix and B the nine w2 slices (k = mid channels,
// n = the two outputs padded to 8), a fresh sum per 16 mid channels (the
// nine shifts) added into the running one; out rounded once.
constexpr int kNcRows = 32;
constexpr int kNcThreads = 128;
constexpr int kNcSlot = 9 * 1024;                 // a halo row's box, 1024-aligned
constexpr int kNcOffW = 4 * kNcSlot;              // w2 pairs [9][4 k16][4 q][2] u32 a lane
constexpr int kNcOffBar = kNcOffW + 9 * 64 * 4;   // packed (m pair, o < 2): [9][32][2] u32
constexpr int kNcSmemB = kNcOffBar + 4 * 8 + 1024;

__global__ void __launch_bounds__(kNcThreads)
abf_block_bf16_conv_n8_mma_kernel(const __grid_constant__ CUtensorMap xmap, const bf16* w2,
                                  bf16* out, int D, int T, int M, int O, int t_tiles,
                                  int chunks) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (cb::smem_u32(smem_raw) & 1023)) & 1023);
  uint32_t* wp = reinterpret_cast<uint32_t*>(smem + kNcOffW);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kNcOffBar);
  const int tid = threadIdx.x, wi = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
  const int chunk = blockIdx.x % chunks;
  const int strip = (blockIdx.x / chunks) % t_tiles;
  const int b = blockIdx.x / (chunks * t_tiles);
  const int d0 = chunk * kNcRows, d1 = min(d0 + kNcRows, D), t0 = strip * kPx;
  // wp[(s * 32 + mp) * 2 + o] = (w2[s, 2 mp, o], w2[s, 2 mp + 1, o]), zeros past M and O
  const uint16_t* w = reinterpret_cast<const uint16_t*>(w2);
  for (int e = tid; e < 9 * 32 * 2; e += kNcThreads) {
    const int o = e & 1, mp = (e >> 1) % 32, sh = e / 64, m = 2 * mp;
    const uint32_t lo = (m < M && o < O) ? w[((long)sh * M + m) * O + o] : 0;
    const uint32_t hi = (m + 1 < M && o < O) ? w[((long)sh * M + m + 1) * O + o] : 0;
    wp[e] = lo | (hi << 16);
  }
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) cb::mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // row x (d0 - 1 .. d1) lives in slot (x - d0 + 1) % 4; its n-th load is phase n
  auto issue = [&](int x) {
    const int slot = (x - d0 + 1) & 3;
    cb::mbar_expect_tx(&full[slot], kHaloBoxB);
    cb::tma_load_4d(smem + slot * kNcSlot, &xmap, &full[slot], 0, t0 - 1, x, b);
  };
  if (tid == 0)
    for (int x = d0 - 1; x <= d0 + 2 && x <= d1; ++x) issue(x);
  const int nk = (M + 15) / 16;
  for (int d = d0; d < d1; ++d) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int x = d + r - 1, slot = (x - d0 + 1) & 3;
      cb::mbar_wait(&full[slot], (uint32_t)(((x - d0 + 1) >> 2) & 1));
    }
    for (int ks = 0; ks < nk; ++ks) {
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int sh = 0; sh < 9; ++sh) {
        const int x = d + sh / 3 - 1, tt = sh % 3;
        uint32_t af[4];
        ldsm_x4(af, frag_addr(smem + ((x - d0 + 1) & 3) * kNcSlot, 16 * wi + tt, ks, lane));
        // B (k = mid channel, n = output g): lanes g < 2 hold the real outputs
        const uint32_t* wr = wp + (sh * 32 + 8 * ks + q) * 2;
        const uint32_t bf[2] = {g < 2 ? wr[g] : 0u, g < 2 ? wr[8 + g] : 0u};
        cb::mma_bf16(part, af, bf);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] += part[e];
    }
    // out[b, d, t0 + 16 wi + g (+ 8), 0 .. 1] from lanes q = 0
    if (q == 0) {
      const long base = (((long)b * D + d) * T + t0 + 16 * wi + g) * O;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + 16 * wi + g + 8 * h;
        if (t < T)
          *reinterpret_cast<uint32_t*>(out + base + 8L * h * O) =
              bf16_io::pack2(acc[2 * h], acc[2 * h + 1]);
      }
    }
    __syncthreads();  // row d - 1's slot is read: row d + 3 may land there
    if (tid == 0 && d + 3 <= d1) issue(d + 3);
  }
}

// The route of a shape on bf16: 1 wide, 2 narrow, 0 neither.
int route_of(int Cs, int M, int O, int k, int fuse, int D) {
  if (Cs < 1 || M < 8 || M > 64 || M % 8 || O < 1 || D < 1) return 0;
  if (fuse && !(k == 1 || k % 2 == 0)) return 0;
  if (Cs % 8 == 0 && Cs <= 64 && O % 8 == 0) return 1;
  if (Cs <= 4 && O == 2 && D % 8 == 0 && (!fuse || k <= 2)) return 2;
  return 0;
}

long groups_of(int B, int D, int k, int T, int fuse, int* gp, int* ppg) {
  const int kk = fuse ? k : 1;
  *ppg = kk == 1 ? 1 : kk / 2;
  *gp = kk == 1 ? (D + 1) / 2 : D / kk;
  return (long)B * ((T + kPx - 1) / kPx) * *gp;
}

int part_floats(int Cs, int M, int O, bool narrow) {
  return Cs * M + 3 * M + 2 * Cs + 2 + (narrow ? 9 * M * O : 0);
}

// A map over n bf16 elements (n a multiple of 8) as [n / 8][8] in boxes of
// `rows` rows, no swizzle (flat runs from any element, flat_row/flat_skew).
cudaError_t encode_flat(CUtensorMap* map, const void* base, long n, int rows) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                     cudaEnableDefault, &found);
#else
  cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                            &found);
#endif
  if (err != cudaSuccess) return err;
  if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {8, (cuuint64_t)(n / 8)};
  const cuuint64_t strides[1] = {16};
  const cuuint32_t boxd[2] = {8, (cuuint32_t)rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn)(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, boxd, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The fused forward (abf_block_bf16_fwd_fused_kernel): w2 packed into
// wp [9][opad][cpad] (the bf16 K3f's packing), then one launch.
cudaError_t fwd_fused_run(const bf16* tap, const bf16* res, const XfArgs& x, const bf16* w2,
                          bf16* wp, bf16* out, int B, int Dp, int O, cudaStream_t s) {
  const int D = x.D, T = x.T, M = x.M;
  int cpad, opad;
  cb::fwd_pad(M, O, &cpad, &opad);
  const long n = 9L * opad * cpad;
  cb::conv3x3_bf16_pack_weights_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(w2, wp, M, O,
                                                                                  cpad, opad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int bn = O > 32 ? 64 : 32;
  CUtensorMap tmap, ymap, wmap;
  err = cb::encode_map_bdtw(&tmap, tap, B, D, T, x.Cs, kPx);
  if (err == cudaSuccess && res) err = cb::encode_map_bdtw(&ymap, res, B, Dp, T, M, kPx);
  if (!res) ymap = tmap;
  if (err == cudaSuccess) {
    // the packed weights in boxes of 64 channels x bn outputs (zeros past opad)
    const cuuint64_t dims[3] = {(cuuint64_t)cpad, (cuuint64_t)opad, 9};
    const cuuint64_t strides[2] = {(cuuint64_t)cpad * 2, (cuuint64_t)opad * cpad * 2};
    const cuuint32_t box[3] = {64, (cuuint32_t)bn, 1};
    err = cb::encode_map(&wmap, wp, 3, dims, strides, box);
  }
  if (err != cudaSuccess) return err;
  FfArgs a{};
  a.w1a = x.w1a, a.bvec = x.bvec, a.wxt = x.wxt, a.wy = x.wy, a.zoff = x.zoff;
  a.xf = x.xf, a.out = out;
  a.B = B, a.D = D, a.k = x.k, a.T = T, a.Cs = x.Cs, a.M = M, a.O = O, a.fuse = x.fuse;
  a.strips = (T + kFfStride - 1) / kFfStride;
  a.chunks = (D + kFfRows - 1) / kFfRows;
  a.items = (long)B * a.strips * a.chunks;
  auto kernel = bn == 64 ? abf_block_bf16_fwd_fused_kernel<64> : abf_block_bf16_fwd_fused_kernel<32>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFfSmemB);
  int sms;
  if (err == cudaSuccess) err = cb::sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long grid = a.items < sms ? a.items : sms;
  kernel<<<(unsigned)grid, kFfThreads, kFfSmemB, s>>>(tmap, ymap, wmap, a);
  return cudaGetLastError();
}

}  // namespace

// The bf16 K5f on route "fused": for O <= 64 the fused forward above, else
// the xf pass, then the conv over xf on the bf16 K3f's wgmma tile
// (conv3x3_bf16.cuh), both through the packed weights' scratch of
// abf_block_bf16_fwd_scratch_elems(M, O) bf16; for the mask block's O = 2
// the xf pass and the narrow conv.  The shapes of abf_block_bf16_route,
// every map 16-byte aligned.
extern "C" long abf_block_bf16_fwd_scratch_elems(int M, int O) {
  return O < 8 ? 8 : cb::fwd_scratch_elems(M, O);  // the narrow conv packs its own
}

extern "C" int abf_block_bf16_fwd(const void* tap, const void* res, const void* w1a,
                                  const void* bvec, const void* wxt, const void* wy,
                                  const void* zoff, const void* w2, void* wscratch, void* xf,
                                  void* out, int B, int D, int Dp, int T, int Cs, int M, int O,
                                  void* stream) {
  const int fuse = res != nullptr;
  const int k = fuse ? D / (Dp > 0 ? Dp : 1) : 1;
  const int route = route_of(Cs, M, O, k, fuse, D);
  if (route == 0 || B < 1 || D < 1 || T < 1 || (fuse && (Dp < 1 || D % Dp)) ||
      (fuse && (!wxt || !wy || !zoff)) || wscratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const bool narrow = route == 2;
  const void* maps[] = {tap, res, xf, out, wscratch};
  for (const void* p : maps)
    if (p != nullptr && !cb::aligned16(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  XfArgs a{};
  a.w1a = static_cast<const bf16*>(w1a);
  a.bvec = static_cast<const float*>(bvec);
  a.wxt = static_cast<const bf16*>(wxt);
  a.wy = static_cast<const bf16*>(wy);
  a.zoff = static_cast<const float*>(zoff);
  a.xf = static_cast<bf16*>(xf);
  a.D = D, a.k = k, a.T = T, a.Cs = Cs, a.M = M, a.fuse = fuse;
  a.t_tiles = (T + kPx - 1) / kPx;
  a.tiles = (long)B * D * a.t_tiles;
  a.pairs = (a.tiles + 1) / 2;
  const long elems = (long)B * D * T;
  const bf16* tp = static_cast<const bf16*>(tap);
  if (!narrow && O <= kFfMaxO)
    return (int)fwd_fused_run(tp, static_cast<const bf16*>(res), a, static_cast<const bf16*>(w2),
                              static_cast<bf16*>(wscratch), static_cast<bf16*>(out), B, Dp, O, s);
  CUtensorMap tmap, ymap;
  cudaError_t err = narrow ? encode_flat(&tmap, tp, elems * Cs, (kPx * Cs + 7) / 8 + 1)
                           : cb::encode_map_bdtw(&tmap, tp, B, D, T, Cs, kPx);
  if (err == cudaSuccess && fuse)
    err = cb::encode_map_bdtw(&ymap, static_cast<const bf16*>(res), B, Dp, T, M, kPx);
  if (!fuse) ymap = tmap;
  if (err != cudaSuccess) return (int)err;
  auto kernel = narrow ? abf_block_bf16_xf_mma_kernel<true> : abf_block_bf16_xf_mma_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kXfSmemB);
  int sms;
  if (err == cudaSuccess) err = cb::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const long grid = a.pairs < 2L * sms ? a.pairs : 2L * sms;
  kernel<<<(unsigned)grid, kXfThreads, kXfSmemB, s>>>(tmap, ymap, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bf16* x = static_cast<const bf16*>(xf);
  if (narrow) {
    CUtensorMap xmap;
    err = cb::encode_map_bdtw(&xmap, x, B, D, T, M, kPx + 2);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(abf_block_bf16_conv_n8_mma_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kNcSmemB);
    if (err != cudaSuccess) return (int)err;
    const int chunks = (D + kNcRows - 1) / kNcRows;
    abf_block_bf16_conv_n8_mma_kernel<<<(unsigned)((long)B * a.t_tiles * chunks), kNcThreads,
                                        kNcSmemB, s>>>(xmap, static_cast<const bf16*>(w2),
                                                       static_cast<bf16*>(out), D, T, M, O,
                                                       a.t_tiles, chunks);
    return (int)cudaGetLastError();
  }
  return (int)cb::fwd_run<false>(x, static_cast<const bf16*>(w2), static_cast<bf16*>(wscratch),
                                 nullptr, out, B, D, T, M, O, s);
}

extern "C" int abf_block_bf16_route(int Cs, int M, int O, int k, int fuse, int D) {
  return route_of(Cs, M, O, k, fuse, D);
}

extern "C" int abf_block_bf16_bwd_blocks(int B, int D, int k, int T, int fuse) {
  int gp, ppg, sms;
  const long groups = groups_of(B, D, k, T, fuse, &gp, &ppg);
  if (groups < 1 || cb::sm_count(&sms) != cudaSuccess) return 1;
  return (int)(groups < sms ? groups : sms);
}

extern "C" int abf_block_bf16_bwd_floats(int Cs, int M, int O, int narrow) {
  return part_floats(Cs, M, O, narrow != 0);
}

extern "C" int abf_block_bf16_bwd(const void* tap, const void* res, const void* w1a,
                                  const void* bvec, const void* wxt, const void* wy,
                                  const void* zoff, const void* w2f, const void* xf,
                                  const void* gxf, const void* gout, void* gtap, void* gres,
                                  void* grads, void* partial, void* dw2, void* wscratch, int B,
                                  int D, int Dp, int T, int Cs, int M, int O, int blocks,
                                  int chunks, void* stream) {
  const int fuse = res != nullptr;
  const int k = fuse ? D / (Dp > 0 ? Dp : 1) : 1;
  const int route = route_of(Cs, M, O, k, fuse, D);
  if (route == 0 || B < 1 || D < 1 || T < 1 || (fuse && (Dp < 1 || D % Dp)) ||
      (fuse && (!wxt || !wy || !zoff || !gres)))
    return (int)cudaErrorInvalidValue;
  const bool narrow = route == 2;
  const void* maps[] = {tap, res, w2f, xf, gxf, gout, gtap, gres};
  for (const void* p : maps)
    if (p != nullptr && !cb::aligned16(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a{};
  a.w1a = static_cast<const bf16*>(w1a);
  a.bvec = static_cast<const float*>(bvec);
  a.wxt = static_cast<const bf16*>(wxt);
  a.wy = static_cast<const bf16*>(wy);
  a.zoff = static_cast<const float*>(zoff);
  a.w2f = static_cast<const bf16*>(w2f);
  a.gtap = static_cast<bf16*>(gtap);
  a.gres = static_cast<bf16*>(gres);
  a.partial = static_cast<float*>(partial);
  a.B = B, a.D = D, a.Dp = fuse ? Dp : D, a.k = k, a.T = T, a.Cs = Cs, a.M = M, a.O = O;
  a.t_tiles = (T + kPx - 1) / kPx;
  a.groups = groups_of(B, D, k, T, fuse, &a.gp, &a.ppg);
  if (blocks < 1 || blocks > a.groups || a.groups >= (1L << 31)) return (int)cudaErrorInvalidValue;
  a.per_block = (a.groups + blocks - 1) / blocks;
  a.kch = narrow ? 1 : (O + 63) / 64;
  a.ngroups = (O + 15) / 16;
  a.stream_w = narrow ? 0 : a.ngroups > 4;
  a.fuse = fuse;
  a.n_part = part_floats(Cs, M, O, narrow);
  const long elems = (long)B * D * T;
  if (narrow && elems * (Cs > O ? Cs : O) >= (1L << 31)) return (int)cudaErrorInvalidValue;
  const bf16* tp = static_cast<const bf16*>(tap);
  const bf16* go = static_cast<const bf16*>(gout);
  CUtensorMap gmap, wmap, tmap, ymap, xmap, fmap;
  cudaError_t err;
  if (narrow) {
    err = encode_flat(&gmap, go, elems * O, (66 * O + 7) / 8 + 1);
    if (err == cudaSuccess) err = encode_flat(&tmap, tp, elems * Cs, (kPx * Cs + 7) / 8 + 1);
    if (err == cudaSuccess)
      err = cb::encode_map_bdtw(&fmap, static_cast<const bf16*>(xf), B, D, T, M, kPx);
    wmap = fmap;
  } else {
    err = cb::encode_map_bdtw(&gmap, go, B, D, T, O, kPx + 2);
    if (err == cudaSuccess) err = cb::encode_map_bdtw(&tmap, tp, B, D, T, Cs, kPx);
    if (err == cudaSuccess) {
      // w2f [9][O][M] in boxes of 64 mid channels x 16 g_out channels x 9 shifts
      const cuuint64_t dims[3] = {(cuuint64_t)M, (cuuint64_t)O, 9};
      const cuuint64_t strides[2] = {(cuuint64_t)M * 2, (cuuint64_t)O * M * 2};
      const cuuint32_t box[3] = {64, 16, 9};
      err = cb::encode_map(&wmap, w2f, 3, dims, strides, box);
    }
    fmap = gmap;
  }
  if (err == cudaSuccess)
    err = cb::encode_map_bdtw(&xmap, static_cast<const bf16*>(gxf), B, D, T, M, kPx);
  if (err == cudaSuccess)
    err = fuse ? cb::encode_map_bdtw(&ymap, static_cast<const bf16*>(res), B, Dp, T, M, kPx)
               : cudaSuccess;
  if (!fuse) ymap = xmap;
  if (err != cudaSuccess) return (int)err;
  // KSUM: an item of more than one pair keeps its g_y sum across pairs;
  // NCT: the most 16-channel tiles of tap a thread sums dw1a for
  const bool ksum = fuse && k > 2, one = Cs <= 16;
  auto kernel = narrow       ? abf_block_bf16_bwd_wgmma_kernel<true, false, false, 1>
                : a.stream_w ? (ksum ? abf_block_bf16_bwd_wgmma_kernel<false, true, true, 4>
                                     : abf_block_bf16_bwd_wgmma_kernel<false, true, false, 4>)
                : ksum       ? (one ? abf_block_bf16_bwd_wgmma_kernel<false, false, true, 1>
                                    : abf_block_bf16_bwd_wgmma_kernel<false, false, true, 4>)
                             : (one ? abf_block_bf16_bwd_wgmma_kernel<false, false, false, 1>
                                    : abf_block_bf16_bwd_wgmma_kernel<false, false, false, 4>);
  const int smem = narrow ? Lay<true, false>::kSmemB
                   : a.stream_w ? Lay<false, true>::kSmemB : Lay<false, false>::kSmemB;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kThreads, smem, s>>>(gmap, wmap, tmap, ymap, xmap, fmap, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = conv3x3_tiles::reduce_partials(a.partial, static_cast<float*>(grads), blocks, a.n_part, s);
  if (err != cudaSuccess || narrow) return (int)err;
  return (int)cb::wgrad_run(static_cast<const bf16*>(xf), go, static_cast<float*>(dw2),
                            static_cast<float*>(wscratch), B, D, T, M, O, chunks, s);
}
