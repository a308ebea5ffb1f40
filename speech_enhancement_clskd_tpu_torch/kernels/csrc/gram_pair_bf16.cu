// The SPKD Gram pair on bf16 operands, S S^T and T T^T with float32 sums, for
// Hopper (sm_90a): the second design of the bf16 K2.  A pipelined split
// reduction over D with the products on the tensor cores, then a parallel
// fixed-order sum of the partials.
//
// Replaces speech_enhancement_clskd_tpu/ops/pallas/gram.py::_gram_pair_kernel
// (reached through _gram_pair_raw) on bf16 operands, whose dots multiply bf16
// by bf16 into float32 sums (preferred_element_type=jnp.float32).  Same
// function: for s [B, Ds] and t [B, Dt] in bf16 (Ds and Dt may differ),
// gs = s s^T and gt = t t^T, [B, B] float32 each.  The float32 kernel stays
// in gram_pair_fwd.cu.
//
// What bounds it on this card.  Reading s and t once, 2 B (Ds + Dt) bytes at
// 3.35 TB/s, against B (B + 1) (Ds + Dt) operations for the upper triangles.
// On f32 FMA (67 TFLOP/s; the first design, the float32 kernel's tiles on
// widened bf16) those took longer than the bytes from B ~ 48 and contended
// with the copies below it (0.0566 ms at B = 32, 0.1596 at B = 64 for a
// bytes bound of 0.0202 and 0.0403, D = 528,000).  One bf16 product a
// multiply-add is exact in float32, so mma.sync m16n8k16 at the 989 TFLOP/s
// bf16 rate does them in a tenth of the bytes' time at B = 64: the bytes
// bound it at every B up to kMaxBatch.
//
// Design.  As the float32 kernel:
//   1. gram_partial_mma_kernel splits each matrix into chunks of kChunk
//      columns (chunks [0, ns) of s, then [ns, ns + nt) of t: the count
//      depends only on the shape).  One persistent block an SM walks the
//      chunks with a fixed stride and writes each chunk's partial Gram (its
//      upper triangle, packed) to the chunk's own slot, so no sum depends on
//      the grid size.  The block's last warp is the producer: it keeps a ring
//      of stages of [Bp, KT] bf16 (Bp = B rounded up to 16) full, each stage
//      KT / 64 boxes of [Bp rows, 64 columns] copied by TMA from a 2-D tensor
//      map over Z [B, D] with a 128-byte swizzle, completing on the stage's
//      mbarrier ("full"); the consumers free a stage on another ("empty").
//      The map's zero fill gives the rows past B and the columns past D.  A
//      box is one request for Bp 128-byte rows: the first build's 1-D bulk
//      copy a staged row (512 bytes a copy at B = 64) ran pass 1 at 1.7 TB/s
//      (NVIDIA H100 80GB HBM3, 700 W).  The swizzle puts the eight 16-byte
//      rows one ldmatrix reads in distinct bank groups.  The wrapper hands
//      the kernel rows of whole 16-byte units on a 16-byte base (it copies
//      other views into a zero-padded buffer first), as the map requires.
//   2. The W consumer warps split each stage's columns into W k-slices of
//      KT / (16 W) k16 steps.  In Z Z^T both operands are rows of the same
//      staged Z, contiguous along k, so one ldmatrix.x4 of 16 rows is the A
//      fragment of those rows and, as its halves, the B fragments of the two
//      8-row column blocks they make: a k16 step is one ldmatrix.x4 a 16-row
//      block and one mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 a 16 x 8 tile
//      that meets the upper triangle (tiles (mb, nb) with 2 mb <= nb: 2 at
//      B <= 16, 6 at B <= 32, 12 at B <= 48, 20 at B <= 64).  The
//      accumulators are float32 registers, fresh each chunk.  At the chunk's
//      end every consumer warp writes its tiles to shared memory, and warp w
//      adds the W values of elements w, w + W, .. of every tile's four in a
//      fixed tree ((w0 + w2) + (w1 + w3) at W = 4), all its loads first, and
//      writes the packed triangle.
//   3. gram_sum_kernel (a copy of the float32 kernel's) adds each matrix's
//      partials in chunk order, one thread a packed element, and writes each
//      sum to (i, j) and (j, i).  It is launched as a programmatic dependent
//      of pass 1 and waits on it (griddepcontrol).
// No atomics; the order of every sum (the k16 steps, the k-slices, the
// warps' tree, then the chunks) depends only on the shape, so repeated runs
// give the same bits, and the output is exactly symmetric.
//
// Interface: plain C, bound with ctypes.  gram_pair_chunk_cols() and
// gram_pair_max_batch() give kChunk and kMaxBatch.  The caller allocates one
// buffer of 2 B^2 + (cdiv(Ds, kChunk) + cdiv(Dt, kChunk)) * B (B + 1) / 2
// floats: gs, then gt, then the partials.  gram_pair_fwd_bf16 takes s and t
// with Ds and Dt multiples of 8 on 16-byte bases (cudaErrorInvalidValue
// otherwise) and returns cudaGetLastError() after each launch.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 2048;  // columns of one partial
constexpr int kMaxBatch = 64;
constexpr int kSumWarps = 16;  // pass 2: warps a block
constexpr int kSumSpan = 320;  // pass 2: chunks a block stages at a time (655,360 columns)
constexpr int kMaxDevices = 64;
constexpr int kBoxCols = 64;               // a box's columns: one 128-byte swizzled row
// bytes of shared memory for the ring and the tree.  Pass 1's block leaves
// room on its SM for a block of pass 2 (40 KB), and asks for the largest
// carveout, so that pass 2's blocks take their SMs while pass 1 runs and add
// the partials as soon as it ends (with the carveout the runtime picks for
// pass 1 alone, or a 220 KB ring, pass 2 took 6-7 us after pass 1 against
// 3.0-4.6; a 110 KB ring did as well, and pass 1 moved under 1 % with the
// ring's depth: NVIDIA H100 80GB HBM3, 700 W, scripts/gram_variants.py)
constexpr int kSmemBudget = 184 * 1024;
constexpr int kSmemSlack = 1024;           // the ring's base rounded up to 1024 bytes (the swizzle)
constexpr int kMaxStages = 12;

using bf16 = __nv_bfloat16;

// NB row blocks of 16 (Bp = 16 NB rows), KT columns a stage, W consumer warps
template <int NB, int KT, int W>
struct Plan {
  static constexpr int kNB = NB, kKT = KT, kW = W;
  static constexpr int kBp = 16 * NB;
  static constexpr int kBoxBytes = kBp * 128;  // [Bp rows, 64 columns], a multiple of 1024
  static constexpr int kTiles = NB * (NB + 1);  // 16 x 8 tiles (mb, nb), 2 mb <= nb < 2 NB
  static constexpr int kAcc = 4 * kTiles;       // a lane's accumulators
  static constexpr int kSlice = KT / 16 / W;    // a warp's k16 steps of a full stage
  static constexpr int kStageBytes = (KT / kBoxCols) * kBoxBytes;
  static constexpr int kScratchBytes = W * kAcc * 32 * 4;  // every warp's tiles, for the tree
  static constexpr int kFit = (kSmemBudget - kScratchBytes) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kThreads = 32 * (W + 1);
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kSmemBytes = kSmemSlack + kRingBytes + kScratchBytes + 2 * kStages * 8;
  static_assert(KT % kBoxCols == 0 && KT % (16 * W) == 0 && kChunk % KT == 0 && kStages >= 2,
                "a plan's stage");
  static_assert(4 % W == 0, "warp w reduces elements w, w + W, .. of each tile's four");
};

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

// the index of tile (mb, nb), 2 mb <= nb < 2 NB, in row-major order
__host__ __device__ constexpr int tile_index(int NB, int mb, int nb) {
  return 2 * NB * mb - mb * (mb - 1) + (nb - 2 * mb);
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

// the box of `map` at (column c0, row 0) into shared dst, completing as tx
// bytes on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(0)
      : "memory");
}

// the consumer warps alone (named barrier 1; the producer warp is not in it)
template <int W>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * W) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a b: mma.sync m16n8k16, f32 += bf16 x bf16
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The producer (lane 0 of the last warp): fills the ring in the order the
// consumers read it, the boxes of a stage that hold columns below D (the map
// fills the rest of the last one with zeros).
template <class P>
__device__ void produce(uint8_t* ring, uint64_t* full, uint64_t* empty, const CUtensorMap* smap,
                        const CUtensorMap* tmap, long long Ds, long long Dt, int ns, int nchunks) {
  constexpr int kKT = P::kKT, kStages = P::kStages;
  int fill = 0;
  for (int c = blockIdx.x; c < nchunks; c += gridDim.x) {
    const bool is_s = c < ns;
    const CUtensorMap* map = is_s ? smap : tmap;
    const long long D = is_s ? Ds : Dt;
    const long long col0 = (long long)(is_s ? c : c - ns) * kChunk;
    for (long long c0 = col0; c0 < col0 + kChunk && c0 < D; c0 += kKT, ++fill) {
      const int slot = fill % kStages;
      if (fill >= kStages) mbar_wait(&empty[slot], (fill / kStages - 1) & 1);
      uint8_t* dst = ring + slot * P::kStageBytes;
      const int n = (int)(D - c0 < kKT ? D - c0 : kKT);
      const int boxes = (n + kBoxCols - 1) / kBoxCols;
      mbar_arrive_expect_tx(&full[slot], (uint32_t)(boxes * P::kBoxBytes));
      for (int b = 0; b < boxes; ++b)
        tma_load_2d(dst + b * P::kBoxBytes, map, &full[slot], (int)(c0 + b * kBoxCols));
    }
  }
}

// The consumer warps: warp w sums k16 steps [w kSlice, (w + 1) kSlice) of
// every stage of a chunk into its tiles; at the chunk's end the warps' tiles
// are added in a fixed tree and the packed triangle goes to the chunk's slot.
template <class P>
__device__ void consume(const uint8_t* ring, float* scratch, uint64_t* full, uint64_t* empty,
                        float* __restrict__ partial, int B, long long Ds, long long Dt, int ns, int nchunks,
                        int warp, int lane) {
  constexpr int NB = P::kNB, W = P::kW, kKT = P::kKT, kStages = P::kStages, kAcc = P::kAcc;
  constexpr int kE = 4 / W;  // elements of each tile's four a warp reduces
  const int P2 = B * (B + 1) / 2;
  // ldmatrix.x4 of rows 16 mb .. + 15, columns k0 .. k0 + 15: lanes 0-7 give
  // rows 0-7 at k0 (a0), 8-15 rows 8-15 (a1), 16-23 rows 0-7 at k0 + 8 (a2),
  // 24-31 rows 8-15 (a3); the B fragment (b0, b1) of rows 16 mb .. + 7 is
  // (a0, a2), of rows 16 mb + 8 .. + 15 (a1, a3).  In a box, row r's 16-byte
  // unit u lies at r 128 + (u ^ (r % 8)) 16 (the 128-byte swizzle; r % 8 is
  // the lane's).
  const uint32_t lane_row = (lane & 15) * 128, lane_hi = lane >> 4, lane_x = lane & 7;
  float acc[P::kTiles][4];
  int fill = 0;
  for (int c = blockIdx.x; c < nchunks; c += gridDim.x) {
    const bool is_s = c < ns;
    const long long D = is_s ? Ds : Dt;
    const long long col0 = (long long)(is_s ? c : c - ns) * kChunk;
#pragma unroll
    for (int i = 0; i < P::kTiles; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
    for (long long c0 = col0; c0 < col0 + kChunk && c0 < D; c0 += kKT, ++fill) {
      const int slot = fill % kStages;
      mbar_wait(&full[slot], (fill / kStages) & 1);
      const int n = (int)(D - c0 < kKT ? D - c0 : kKT);
      const int steps = (n + 15) / 16;  // columns past D are the map's zeros
      const int end = (warp + 1) * P::kSlice < steps ? (warp + 1) * P::kSlice : steps;
      const uint32_t stage = smem_addr(ring + slot * P::kStageBytes) + lane_row;
      for (int k = warp * P::kSlice; k < end; ++k) {
        const uint32_t at = stage + (k >> 2) * P::kBoxBytes + (((2 * (k & 3) + lane_hi) ^ lane_x) << 4);
        uint32_t a[NB][4];
#pragma unroll
        for (int mb = 0; mb < NB; ++mb) ldsm_x4(a[mb], at + mb * 16 * 128);
#pragma unroll
        for (int mb = 0; mb < NB; ++mb)
#pragma unroll
          for (int nb = 2 * mb; nb < 2 * NB; ++nb)
            mma(acc[tile_index(NB, mb, nb)], a[mb], a[nb / 2][nb % 2], a[nb / 2][2 + nb % 2]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    }
    // the chunk's partial: every warp's tiles to shared memory, element e of
    // tile t of lane l of warp w at scratch[(w kAcc + 4 t + e) 32 + l]
    float* mine = scratch + warp * kAcc * 32 + lane;
#pragma unroll
    for (int t = 0; t < P::kTiles; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[(4 * t + e) * 32] = acc[t][e];
    consumers_sync<W>();
    // warp w: elements e = w + q W of every tile, the W warps' values loaded
    // first, then added in a fixed tree
    float v[P::kTiles][kE][W];
#pragma unroll
    for (int t = 0; t < P::kTiles; ++t)
#pragma unroll
      for (int q = 0; q < kE; ++q)
#pragma unroll
        for (int w = 0; w < W; ++w) v[t][q][w] = scratch[(w * kAcc + 4 * t + warp + q * W) * 32 + lane];
    float* __restrict__ out = partial + (long long)c * P2;
#pragma unroll
    for (int mb = 0; mb < NB; ++mb)
#pragma unroll
      for (int nb = 2 * mb; nb < 2 * NB; ++nb)
#pragma unroll
        for (int q = 0; q < kE; ++q) {
          float(&x)[W] = v[tile_index(NB, mb, nb)][q];
#pragma unroll
          for (int h = W / 2; h >= 1; h /= 2)
#pragma unroll
            for (int w = 0; w < h; ++w) x[w] += x[w + h];
          // element e of a tile: row g (+ 8 for e >= 2), column 2 q' + (e & 1)
          const int e = warp + q * W;
          const int i = 16 * mb + lane / 4 + (e >= 2 ? 8 : 0);
          const int j = 8 * nb + 2 * (lane % 4) + (e & 1);
          if (i <= j && j < B) out[packed(i, j, B)] = x[0];
        }
    consumers_sync<W>();  // the tree has read scratch before the next chunk writes it
  }
}

template <class P>
__global__ void __launch_bounds__(P::kThreads, 1)
gram_partial_mma_kernel(const __grid_constant__ CUtensorMap smap, const __grid_constant__ CUtensorMap tmap,
                        float* __restrict__ partial, int B, long long Ds, long long Dt, int ns, int nchunks) {
  constexpr int kStages = P::kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float* scratch = reinterpret_cast<float*>(ring + P::kRingBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + P::kRingBytes + P::kScratchBytes);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], P::kW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == P::kW) {
    if (lane == 0) produce<P>(ring, full, empty, &smap, &tmap, Ds, Dt, ns, nchunks);
  } else {
    consume<P>(ring, scratch, full, empty, partial, B, Ds, Dt, ns, nchunks, warp, lane);
  }
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
// libcuda's cuTensorMapEncodeTiled, looked up once through the runtime (the
// library is not linked against libcuda)
void* encode_fn = nullptr;

// A 2-D map over z [B, D] bf16 in boxes of [rows, 64 columns]: 128-byte
// swizzle, zeros outside the matrix.
cudaError_t encode_map(CUtensorMap* map, const bf16* z, int B, long long D, int rows) {
  if (encode_fn == nullptr) {
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &encode_fn, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &encode_fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || encode_fn == nullptr) {
      encode_fn = nullptr;
      return cudaErrorNotSupported;
    }
  }
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)B};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBoxCols, (cuuint32_t)rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(encode_fn)(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(z), dims, strides, box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <class P>
cudaError_t launch_partial(int plan, const bf16* s, const bf16* t, float* partial, int B, long long Ds,
                           long long Dt, int ns, int nchunks, int dev, cudaStream_t st) {
  if (!(attr_set[dev] & (1u << plan))) {
    cudaError_t err = cudaFuncSetAttribute(gram_partial_mma_kernel<P>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmemBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(gram_partial_mma_kernel<P>, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    attr_set[dev] |= 1u << plan;
  }
  CUtensorMap smap, tmap;
  cudaError_t err = encode_map(&smap, s, B, Ds, P::kBp);
  if (err == cudaSuccess) err = encode_map(&tmap, t, B, Dt, P::kBp);
  if (err != cudaSuccess) return err;
  const int grid = nchunks < sm_count[dev] ? nchunks : sm_count[dev];
  gram_partial_mma_kernel<P><<<grid, P::kThreads, P::kSmemBytes, st>>>(smap, tmap, partial, B, Ds, Dt, ns,
                                                                       nchunks);
  return cudaGetLastError();
}

// the plans by B: stages of 32 KB (24 KB at B <= 48), four consumer warps
cudaError_t launch_partial_for(int B, const bf16* s, const bf16* t, float* partial, long long Ds, long long Dt,
                               int ns, int nchunks, int dev, cudaStream_t st) {
  if (B <= 16) return launch_partial<Plan<1, 1024, 4>>(0, s, t, partial, B, Ds, Dt, ns, nchunks, dev, st);
  if (B <= 32) return launch_partial<Plan<2, 512, 4>>(1, s, t, partial, B, Ds, Dt, ns, nchunks, dev, st);
  if (B <= 48) return launch_partial<Plan<3, 256, 4>>(2, s, t, partial, B, Ds, Dt, ns, nchunks, dev, st);
  return launch_partial<Plan<4, 256, 4>>(3, s, t, partial, B, Ds, Dt, ns, nchunks, dev, st);
}

}  // namespace

extern "C" int gram_pair_chunk_cols() { return kChunk; }

extern "C" int gram_pair_max_batch() { return kMaxBatch; }

extern "C" int gram_pair_fwd_bf16(const void* s, const void* t, void* out, int B, long long Ds, long long Dt,
                                  void* stream) {
  if (B < 1 || B > kMaxBatch || Ds < 1 || Dt < 1 || Ds % 8 != 0 || Dt % 8 != 0 ||
      (reinterpret_cast<uintptr_t>(s) & 15) != 0 || (reinterpret_cast<uintptr_t>(t) & 15) != 0)
    return (int)cudaErrorInvalidValue;
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
  err = launch_partial_for(B, static_cast<const bf16*>(s), static_cast<const bf16*>(t), partial, Ds, Dt, ns,
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
