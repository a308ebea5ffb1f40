// LSTM sequence forward for Hopper (sm_90a): the whole recurrence in one launch.
//
// Replaces speech_enhancement_clskd_tpu/ops/pallas/lstm.py::_fwd_kernel
// (reached through _fwd_call from lstm_seq / _lstm_fwd).  Same function: given
// the pre-projected inputs xw [T, N, 4H] (N = 2B: the real and imaginary parts
// of the complex LSTM stacked on the batch axis) and W_hh [H, 4H], with gate
// order (i, f, g, o), for t = 0 .. T-1
//     gates = xw[t] + h @ W_hh
//     c = sigmoid(f) * c + sigmoid(i) * tanh(g);   h = sigmoid(o) * tanh(c)
// and writes y[t] = h and c_out[t] = c, both [T, N, H] float32.  h0 and c0
// ([N, H]) are optional; a null pointer means zeros.  All arithmetic is f32.
//
// What bounds it on this card.  Step t needs h from step t-1, so the T steps
// form one serial chain, and each step is small: N x H x 4H multiply-adds
// (student H=32: 4K per row; teacher H=128: 64K per row).  Neither the memory
// rate nor the FLOP rate binds (T=5283, N=32, H=128 is bound at 0.335 ms by
// its operations); the latency of one step times T does.  The first design
// of this kernel (one thread per gate column, a chain of H dependent FMAs
// over shared memory, two block barriers a step, the teacher's W_hh partly
// read through L2 because 256 KB exceed a block's 227 KB) took 3.1 us a step
// at H=128, cuDNN 2.4 us.
//
// Design: the recurrence held on chip across a thread-block cluster.
//   - A cluster of P CTAs (P <= 8, portable) owns a tile of ROWS batch rows;
//     CTA k owns the hidden units [k U, (k+1) U), U = ceil(H / P), and all four
//     gate columns of each, so the c/h update of a unit stays in the CTA.
//   - W_hh stays in registers for all T: the thread of gate column j and
//     K-slice kk holds W_hh[k, j] for the WPT inputs k of its slice
//     (k = 4 (kk + KS i) + e, i < WPT / 4, e < 4, so a slice reads h as
//     float4s).  A CTA holds [H, 4U] of W_hh; nothing is read through L2.
//   - The 4 KS lanes of one unit (its four gate columns) share a warp, so the
//     gates meet by __shfl_sync and the lane (gate i, kk = r mod KS) updates
//     c (a register for all T) and h of row r with no block barrier between.
//   - The h exchange: h of step t is written into every CTA of the cluster
//     (st through cooperative_groups::cluster_group::map_shared_rank, DSMEM),
//     into one of two buffers chosen by the parity of t, so one cluster
//     barrier a step (barrier.cluster.arrive.release / wait.acquire) orders
//     both the writes and the next step's reads.  P = 1 needs no cluster: one
//     __syncthreads a step.
//   - xw[t+1] is loaded into registers while step t computes, so its global
//     latency is off the chain.
// Plans (P, KS, WPT), by shape alone (plan_of): H <= 32: (1, 1, 32), 128
// threads; H <= 64: (1, 1, 64); H <= 128: (2, 1, 128), 256 threads a CTA and
// 128 weights a thread; H <= 256: (8, 4, 64) (4H = 1024, the widest, where
// 256 weights would not fit a thread).  Chosen by
// scripts/lstm_cluster_sweep.py on the H100, which builds this source with
// other plans beside these (PERF.md):
//   - one cluster barrier costs ~0.7 us a step whatever P, a __syncthreads
//     a few hundredths of that, so P = 1 wherever W_hh fits one CTA's
//     registers (P = 2 at H = 32 takes twice as long);
//   - P = 2 at H = 128, the fewest CTAs that hold W_hh in registers: the
//     fastest plan at N = 64 and within 2 % of the fastest (P = 8) at
//     N = 32, T = 5283.  At N = 2 (one offline utterance) P = 4 runs 19 %
//     faster; a plan that grows P as N shrinks is open (ROADMAP);
//   - KS = 1 (each gate column one fmaf chain over k = 0 .. H-1) at the main
//     widths.  At H = 128 it is the fastest plan.  At H = 32 splitting K over
//     two lanes runs within a few per cent of it, but moves the clskd step's
//     card-vs-CPU gradients (the sweep's step phase, chip_smoke.py phase 7's
//     check) past the 1e-4 that phase holds them to.
// Each of the main paths' shapes that fits one row a cluster ran fastest
// that way.  ROWS is the smallest of 1, 2, 4 that needs no more CTAs than
// the card has SMs: the real-LSTM bottleneck that pretraining trains at
// H = 256, N = 32 takes 2 (32 clusters of 8 CTAs would need 256 SMs), 2.42
// ms at T = 483 on the H100 against cuDNN's 8.91 (PERF.md).  If
// the card cannot co-schedule the cluster (cudaOccupancyMaxActiveClusters
// gives 0), the launch returns that error: there is no other plan to retry.
//
// Tolerance.  The nonlinearities are CUDA's expf and tanhf and the sums run
// in another order than the plain version's matmul, so y and c differ from
// it by float32 rounding carried through the recurrence; chip_smoke.py holds
// them to KERNEL_ATOL = 1e-4 at T up to 5283.
//
// Interface: plain C, bound with ctypes.  Pointers and the stream are passed as
// void*; the return value is cudaGetLastError() after the launch (or the
// occupancy query's error).  lstm_seq_fwd_plan_of() names the plan a shape
// takes.

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
using lstm_common::kMaxDevices;
using lstm_common::kMaxThreads;
using lstm_common::sigmoid_f32;

__device__ __forceinline__ void cluster_barrier() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

template <int P, int KS, int WPT>
struct Plan {
  static constexpr int kGL = 4 * KS;           // lanes of one unit
  static constexpr int kHP = KS * WPT;         // H padded to whole slices
  static constexpr int kUMax = (kHP + P - 1) / P;
  static constexpr int kUpw = 32 / kGL;        // units a warp
  static constexpr int kThreads = ((kUMax + kUpw - 1) / kUpw) * 32;
  static_assert(kGL <= 32 && 32 % kGL == 0, "a unit's lanes share a warp");
  static_assert(WPT % 4 == 0, "slices read h as float4s");
  static_assert(kThreads <= kMaxThreads, "at most 1024 threads a CTA");
};

template <int P, int KS, int WPT, int ROWS>
__global__ void __launch_bounds__(Plan<P, KS, WPT>::kThreads, 1)
lstm_seq_fwd_cluster_kernel(const float* __restrict__ xw, const float* __restrict__ w_hh,
                            const float* __restrict__ h0, const float* __restrict__ c0,
                            float* __restrict__ y, float* __restrict__ c_out, int T, int N,
                            int H, int U) {
  using PL = Plan<P, KS, WPT>;
  constexpr int kHP4 = PL::kHP / 4;
  extern __shared__ float4 hbuf4[];  // [2][ROWS][kHP]: h by parity of t
  float* hbuf = reinterpret_cast<float*>(hbuf4);

  const int rank = P > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int row0 = (blockIdx.x / P) * ROWS;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int ul = tid / PL::kGL;          // this CTA's unit
  const int q = (tid % PL::kGL) / KS;    // gate: i, f, g, o
  const int kk = tid % KS;               // K slice
  const int base = lane - lane % PL::kGL;  // lane of (gate i, slice 0) of the unit
  const int u = rank * U + ul;
  const bool unit_ok = ul < U && u < H;
  const int G = 4 * H;
  const int col = q * H + u;

  float w[WPT];
#pragma unroll
  for (int i = 0; i < WPT / 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * (kk + KS * i) + e;
      w[4 * i + e] = (unit_ok && k < H) ? __ldg(w_hh + (size_t)k * G + col) : 0.0f;
    }
  for (int idx = tid; idx < ROWS * PL::kHP; idx += blockDim.x) {
    const int r = idx / PL::kHP, k = idx % PL::kHP, row = row0 + r;
    hbuf[idx] = (h0 != nullptr && k < H && row < N) ? h0[(size_t)row * H + k] : 0.0f;
    hbuf[ROWS * PL::kHP + idx] = 0.0f;
  }
  bool owner[ROWS];
  float c[ROWS], xn[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = row0 + r;
    owner[r] = q == 0 && kk == r % KS && unit_ok && row < N;
    c[r] = (owner[r] && c0 != nullptr) ? c0[(size_t)row * H + u] : 0.0f;
    xn[r] = (unit_ok && row < N) ? __ldg(xw + (size_t)row * G + col) : 0.0f;
  }
  float* peer[P];  // hbuf of every CTA of the cluster
#pragma unroll
  for (int p = 0; p < P; ++p)
    peer[p] = P > 1 ? cg::this_cluster().map_shared_rank(hbuf, (unsigned)p) : hbuf;
  if (P > 1)
    cluster_barrier();  // every CTA has started and set its buffers
  else
    __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    float xc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      xc[r] = xn[r];
      if (t + 1 < T)
        xn[r] = (unit_ok && row0 + r < N)
                    ? __ldg(xw + ((size_t)(t + 1) * N + row0 + r) * G + col)
                    : 0.0f;
    }
    // h @ W_hh for this column: with KS = 1 one fmaf chain over k = 0 .. H-1
    // in order; with KS > 1 four chains a lane over the lane's slice, then a
    // shuffle tree
    float sum[ROWS];
    const float4* hc = hbuf4 + cur * ROWS * kHP4;
    if constexpr (KS == 1) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) sum[r] = 0.0f;
#pragma unroll
      for (int i = 0; i < WPT / 4; ++i) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float4 hv = hc[r * kHP4 + i];
          sum[r] = fmaf(hv.x, w[4 * i + 0], sum[r]);
          sum[r] = fmaf(hv.y, w[4 * i + 1], sum[r]);
          sum[r] = fmaf(hv.z, w[4 * i + 2], sum[r]);
          sum[r] = fmaf(hv.w, w[4 * i + 3], sum[r]);
        }
      }
    } else {
      float4 acc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int i = 0; i < WPT / 4; ++i) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float4 hv = hc[r * kHP4 + kk + KS * i];
          acc[r].x = fmaf(hv.x, w[4 * i + 0], acc[r].x);
          acc[r].y = fmaf(hv.y, w[4 * i + 1], acc[r].y);
          acc[r].z = fmaf(hv.z, w[4 * i + 2], acc[r].z);
          acc[r].w = fmaf(hv.w, w[4 * i + 3], acc[r].w);
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        sum[r] = (acc[r].x + acc[r].y) + (acc[r].z + acc[r].w);
#pragma unroll
        for (int off = KS / 2; off > 0; off /= 2)
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], off);
      }
    }
    float* hn = hbuf + (cur ^ 1) * ROWS * PL::kHP;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float s = sum[r];
      const float v = s + xc[r];
      const float a = q == 2 ? tanhf(v) : sigmoid_f32(v);
      const float gf = __shfl_sync(0xffffffffu, a, base + KS + kk);
      const float gg = __shfl_sync(0xffffffffu, a, base + 2 * KS + kk);
      const float go = __shfl_sync(0xffffffffu, a, base + 3 * KS + kk);
      if (owner[r]) {
        c[r] = gf * c[r] + a * gg;
        const float h = go * tanhf(c[r]);
        const size_t o = ((size_t)t * N + row0 + r) * H + u;
        y[o] = h;
        c_out[o] = c[r];
#pragma unroll
        for (int p = 0; p < P; ++p) peer[p][(hn - hbuf) + r * PL::kHP + u] = h;
      }
    }
    if (P > 1)
      cluster_barrier();
    else
      __syncthreads();
  }
}

// One plan (P, KS, WPT) at ROWS = 1, 2 or 4 batch rows a cluster.
template <int P, int KS, int WPT, int ROWS>
cudaError_t launch_rows(const float* xw, const float* w_hh, const float* h0, const float* c0,
                        float* y, float* c, int T, int N, int H, int dev, cudaStream_t stream) {
  using PL = Plan<P, KS, WPT>;
  if (H > PL::kHP || H < 1) return cudaErrorInvalidValue;
  const int U = (H + P - 1) / P;
  const int threads = ((U + PL::kUpw - 1) / PL::kUpw) * 32;
  const int smem = 2 * ROWS * PL::kHP * (int)sizeof(float);
  const int clusters = (N + ROWS - 1) / ROWS;
  auto kernel = lstm_seq_fwd_cluster_kernel<P, KS, WPT, ROWS>;
  if (P == 1) {
    kernel<<<clusters, threads, smem, stream>>>(xw, w_hh, h0, c0, y, c, T, N, H, U);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * P));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // can the card co-schedule one cluster of this shape?  Asked once per
  // device and block size (the shared memory follows from the instance).
  static std::atomic<int> schedulable[kMaxDevices][kMaxThreads / 32 + 1];
  if (schedulable[dev][threads / 32].load() == 0) {
    int n = 0;
    cudaError_t err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorLaunchOutOfResources;
    schedulable[dev][threads / 32].store(n);
  }
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, xw, w_hh, h0, c0, y, c, T, N, H, U);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int P, int KS, int WPT>
cudaError_t launch_plan(int rows, const float* xw, const float* w_hh, const float* h0,
                        const float* c0, float* y, float* c, int T, int N, int H, int dev,
                        cudaStream_t stream) {
  switch (rows) {
    case 1: return launch_rows<P, KS, WPT, 1>(xw, w_hh, h0, c0, y, c, T, N, H, dev, stream);
    case 2: return launch_rows<P, KS, WPT, 2>(xw, w_hh, h0, c0, y, c, T, N, H, dev, stream);
    case 4: return launch_rows<P, KS, WPT, 4>(xw, w_hh, h0, c0, y, c, T, N, H, dev, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The plans: (P, KS, WPT) by shape (plan_of); each takes H <= KS * WPT.
struct PlanInfo {
  int p, ks, wpt;
};
constexpr PlanInfo kPlans[] = {
    {1, 1, 32},   // 0: H <= 32
    {1, 1, 64},   // 1: H <= 64
    {2, 1, 128},  // 2: H <= 128
    {8, 4, 64},   // 3: H <= 256
};

int plan_of(int H) { return H <= 32 ? 0 : H <= 64 ? 1 : H <= 128 ? 2 : 3; }

// Batch rows a cluster of p CTAs: the smallest of 1, 2, 4 that needs no more
// CTAs than the card has SMs.
int rows_of(int p, int N, int sms) {
  int rows = 1;
  while (rows < 4 && (long)((N + rows - 1) / rows) * p > sms) rows *= 2;
  return rows;
}

}  // namespace

extern "C" int lstm_seq_fwd_plan_of(int N, int H, int* plan, int* p, int* ks, int* rows) {
  if (H < 1 || 4 * H > kMaxThreads || N < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, max_smem = 0;
  cudaError_t err = lstm_common::device_limits(&dev, &sms, &max_smem);
  if (err != cudaSuccess) return (int)err;
  *plan = plan_of(H);
  *p = kPlans[*plan].p;
  *ks = kPlans[*plan].ks;
  *rows = rows_of(*p, N, sms);
  return 0;
}

extern "C" int lstm_seq_fwd(const void* xw, const void* w_hh, const void* h0,
                            const void* c0, void* y, void* c, int T, int N, int H,
                            void* stream) {
  if (H < 1 || 4 * H > kMaxThreads || N < 1 || T < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, max_smem = 0;
  cudaError_t err = lstm_common::device_limits(&dev, &sms, &max_smem);
  if (err != cudaSuccess) return (int)err;
  const float* a = static_cast<const float*>(xw);
  const float* w = static_cast<const float*>(w_hh);
  const float* hi = static_cast<const float*>(h0);
  const float* ci = static_cast<const float*>(c0);
  float* yo = static_cast<float*>(y);
  float* co = static_cast<float*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int plan = plan_of(H);
  const int rows = rows_of(kPlans[plan].p, N, sms);
  switch (plan) {
    case 0: return (int)launch_plan<1, 1, 32>(rows, a, w, hi, ci, yo, co, T, N, H, dev, s);
    case 1: return (int)launch_plan<1, 1, 64>(rows, a, w, hi, ci, yo, co, T, N, H, dev, s);
    case 2: return (int)launch_plan<2, 1, 128>(rows, a, w, hi, ci, yo, co, T, N, H, dev, s);
    default: return (int)launch_plan<8, 4, 64>(rows, a, w, hi, ci, yo, co, T, N, H, dev, s);
  }
}
