// LSTM sequence backward for Hopper (sm_90a): the gates in a parallel pass,
// the time-reversed recurrence of dh and dc in one launch, then dW_hh in a
// deterministic two-pass reduction.
//
// Replaces speech_enhancement_clskd_tpu/ops/pallas/lstm.py::_bwd_kernel
// (reached through _lstm_bwd, the custom VJP of lstm_seq).  Same function:
// given the forward's inputs xw [T, N, 4H] and W_hh [H, 4H], its outputs
// y (= h) and c [T, N, H], the optional initial states h0, c0 [N, H] (null
// means zeros) and the incoming gradient dy [T, N, H], for t = T-1 .. 0
//     gates = xw[t] + h_{t-1} @ W_hh          (recomputed; i, f, g, o)
//     dh    = dy[t] + dgates_{t+1} @ W_hh^T
//     dc    = dh * o * (1 - tanh^2 c_t) + dc_{t+1} * f_{t+1}
//     dgates_t = [dc*g*i(1-i), dc*c_{t-1}*f(1-f), dc*i*(1-g^2), dh*tanh(c_t)*o(1-o)]
// and writes dxw[t] = dgates_t and dW_hh = sum_t h_{t-1}^T dgates_t, where
// h_{-1}, c_{-1} are h0, c0.  All arithmetic is f32.
//
// What bounds it on this card.  Step t needs dgates from step t+1, so the T
// steps are one serial chain: per row and step an H x 4H matrix-vector
// product for dh.  At the spkd step's shape (T=5283, N=32, H=32) the bytes
// (~240 MB) take 0.07 ms at 3.35 TB/s and the operations less; the chain of
// 5283 dependent steps sets the time.  The first design of this kernel (one
// thread a gate column, the gate recompute h_{t-1} @ W_hh inside every step,
// W_hh read from shared memory twice a step, two block barriers a step) took
// 1.34 us a step there (7.10 ms on an H100, cuDNN's LSTM backward 5.17 ms).
//
// Design.
//   1. lstm_bwd_gates_kernel: the gates do not depend on the chain (only on
//      xw, y and h0), so a parallel pass over all T*N rows computes them
//      first, into a scratch act [T, N, 4H] (i, f, g, o after sigmoid or
//      tanh): a block of 4H threads takes 32 rows, thread j sums
//      h_{t-1} . W_hh[:, j] in one fmaf chain over k from 0 and adds xw, the
//      order the recurrence used to take.
//   2. lstm_seq_bwd_rec_kernel: the chain alone.  As in K1f (lstm_seq_fwd.cu)
//      the four lanes of a unit share a warp: lane (u, q) holds W_hh[u, qH ..
//      qH + H - 1] in registers for all T (plans with H <= 64) and sums its
//      quarter of dgates_{t+1} @ W_hh^T[:, u] in one fmaf chain; the four
//      parts meet by __shfl_sync and are added to dy[t] in quarter order, as
//      the first design added them, so dh and everything after it are the
//      same bits as before.  Every lane of the unit then forms dc (the carry
//      dc * f stays in a register) and lane q its gate gradient, which goes
//      to dxw and to shared memory for step t-1.  dgates live in two buffers
//      chosen by the parity of t, so one __syncthreads a step orders the
//      writes of step t before the reads of step t-1.  The gates, dy, c_t
//      and c_{t-1} of step t-1 are loaded during step t, off the chain.
//      Shared memory carries only dgates: a quarter row padded to KS*WPT +
//      4 KS floats, so the float4 reads of a warp's four quarters fall on
//      distinct banks.
//   3. dW_hh.  The TPU kernel accumulated it into one block over a grid that
//      ran in order; CUDA blocks run at the same time, so the sum is a second
//      pass over the dxw already in device memory: lstm_dw_partial_kernel
//      gives each block a 32 x 32 tile of dW_hh and one chunk of the T*N rows
//      (h_{t-1} is y shifted by N rows, or h0), and writes its partial sum to
//      scratch; lstm_dw_reduce_kernel adds the chunks in a fixed order.  No
//      atomics: the result is the same bit for bit on every run.
// Plans (KS, WPT), by shape alone (plan_of): H <= 32: (1, 32), 128 threads;
// H <= 64: (1, 64); H <= 256: (1, 0), where W_hh (256 KB at H = 128) fits
// neither one block's registers nor its shared memory: the lanes read it
// through L2 from a transposed copy (lstm_transpose_kernel), so a warp's
// loads are four 32-byte sectors.  Pretraining (train/pretrain.py,
// chip_smoke.py phase 25) trains the teacher on this plan: its complex LSTM
// at H = 128, N = 64, and with use_clstm=False its real-LSTM bottleneck at
// H = 256, N = 32.  KS > 1 splits each quarter's sum over KS lanes and a
// shuffle tree; scripts/lstm_cluster_sweep.py builds KS = 2 at H = 32 beside
// the kernel's plan and measures both its time and chip_smoke.py phase 7's
// card-vs-CPU check with it (PERF.md).
//
// Tolerance.  The nonlinearities are CUDA's expf and tanhf and the sums run
// in another order than the plain version's matmuls, so dxw and dW_hh differ
// from it by f32 rounding carried through the chain; chip_smoke.py holds them
// to KERNEL_ATOL = 1e-4 at T up to 5283.
//
// Interface: plain C, bound with ctypes.  Pointers and the stream are passed as
// void*; the return value is the first cudaGetLastError() after a launch.  The
// caller allocates dxw [T, N, 4H], dW_hh [H, 4H] and the scratch of
// lstm_seq_bwd_scratch_floats(T, N, H, chunk_rows) floats: act [T*N, 4H], the
// dW_hh partials [ceil(T*N / chunk_rows), H, 4H] and W_hh^T [4H, H].
// lstm_seq_bwd_plan_of(H, ...) names the plan a width takes.

#include "common.cuh"

namespace {

using lstm_common::kMaxThreads;
using lstm_common::sigmoid_f32;

constexpr int kTile = 32;         // dW_hh tile (units x gate columns) and rows per stage
constexpr int kDwThreads = 256;   // 32 columns x 8 groups of 4 units
constexpr int kReduceThreads = 256;
constexpr int kGateRows = 32;     // rows of the T*N axis a block of the gate pass

// act[m][j] = sigmoid or tanh of xw[m][j] + h_prev[m] . W_hh[:, j] for the
// rows m = t*N + n, with h_prev[m] = y[m - N] for m >= N and h0[m] (or zeros)
// below.  4H threads, kGateRows rows a block.
__global__ void __launch_bounds__(kMaxThreads)
lstm_bwd_gates_kernel(const float* __restrict__ xw, const float* __restrict__ w_hh,
                      const float* __restrict__ y, const float* __restrict__ h0,
                      float* __restrict__ act, long M, int N, int H) {
  extern __shared__ float hs[];  // [kGateRows, H]: h_prev of the block's rows
  const int G = 4 * H;
  const int j = threadIdx.x;
  const long m0 = (long)blockIdx.x * kGateRows;
  for (int idx = j; idx < kGateRows * H; idx += blockDim.x) {
    const int r = idx / H, k = idx - r * H;
    const long m = m0 + r;
    float v = 0.0f;
    if (m < M)
      v = m >= N ? __ldg(y + (m - N) * H + k) : (h0 != nullptr ? __ldg(h0 + m * H + k) : 0.0f);
    hs[idx] = v;
  }
  __syncthreads();
  float acc[kGateRows];
#pragma unroll
  for (int r = 0; r < kGateRows; ++r) acc[r] = 0.0f;
  for (int k = 0; k < H; ++k) {
    const float w = __ldg(w_hh + (size_t)k * G + j);
#pragma unroll
    for (int r = 0; r < kGateRows; ++r) acc[r] = fmaf(hs[r * H + k], w, acc[r]);
  }
  const bool tanh_col = j >= 2 * H && j < 3 * H;
#pragma unroll
  for (int r = 0; r < kGateRows; ++r) {
    const long m = m0 + r;
    if (m >= M) break;
    const float v = __ldg(xw + m * G + j) + acc[r];
    act[m * G + j] = tanh_col ? tanhf(v) : sigmoid_f32(v);
  }
}

// wt[j][u] = W_hh[u][j], for the plan that reads W_hh through L2.
__global__ void __launch_bounds__(256)
lstm_transpose_kernel(const float* __restrict__ w_hh, float* __restrict__ wt, int H) {
  const int G = 4 * H;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= H * G) return;
  const int j = idx / H, u = idx - j * H;
  wt[idx] = w_hh[(size_t)u * G + j];
}

// A plan: KS lanes a quarter (gate), WPT weights a lane in registers (0: read
// W_hh^T through L2).
template <int KS, int WPT>
struct BwdPlan {
  static constexpr int kGL = 4 * KS;     // lanes of one unit
  static constexpr int kUpw = 32 / kGL;  // units a warp
  static_assert(kGL <= 32 && 32 % kGL == 0, "a unit's lanes share a warp");
  static_assert(WPT % 4 == 0, "slices read dgates as float4s");
  static_assert(WPT > 0 || KS == 1, "the L2 plan takes one lane a quarter");
  // padded stride of one quarter row of dgates in shared memory (runtime H
  // for the L2 plan)
  static int qs(int H) { return WPT > 0 ? KS * WPT + 4 * KS : H + 4; }
  static int threads(int H) { return ((H + kUpw - 1) / kUpw) * 32; }
};

// c_{s-1} of step s for one (row, unit): the forward's c at s-1, or c0 (zeros
// when absent) at s = 0.
__device__ __forceinline__ float c_prev(const float* __restrict__ c,
                                        const float* __restrict__ c0, int s, int N, int H,
                                        int row, int u) {
  if (s >= 1) return __ldg(c + ((size_t)(s - 1) * N + row) * H + u);
  return c0 != nullptr ? __ldg(c0 + (size_t)row * H + u) : 0.0f;
}

// Register plans have at most 4 KS^2 WPT threads (H <= KS WPT units of 4 KS
// lanes), so their bound leaves room for the WPT weights a lane.
template <int KS, int WPT, int ROWS>
__global__ void __launch_bounds__(WPT > 0 ? 4 * KS * KS * WPT : kMaxThreads)
lstm_seq_bwd_rec_kernel(const float* __restrict__ act, const float* __restrict__ w_hh,
                        const float* __restrict__ wt, const float* __restrict__ c,
                        const float* __restrict__ dy, const float* __restrict__ c0,
                        float* __restrict__ dxw, int T, int N, int H, int QS) {
  using PL = BwdPlan<KS, WPT>;
  extern __shared__ float4 dg4[];  // [2][ROWS][4][QS]: dgates by parity of t
  float* dgs = reinterpret_cast<float*>(dg4);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int u = tid / PL::kGL;           // unit
  const int q = (tid % PL::kGL) / KS;    // gate: i, f, g, o
  const int kk = tid % KS;               // slice of the quarter
  const int base = lane - lane % PL::kGL;  // lane of (gate i, slice 0) of the unit
  const bool unit_ok = u < H;
  const int G = 4 * H;
  const int row0 = blockIdx.x * ROWS;
  const int buf = ROWS * 4 * QS;

  // W_hh[u, qH + jj] for this lane's jj = 4 (kk + KS i) + e
  float w[WPT > 0 ? WPT : 1];
#pragma unroll
  for (int i = 0; i < WPT / 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int jj = 4 * (kk + KS * i) + e;
      w[4 * i + e] = (unit_ok && jj < H) ? __ldg(w_hh + (size_t)u * G + q * H + jj) : 0.0f;
    }
  for (int idx = tid; idx < 2 * buf; idx += blockDim.x) dgs[idx] = 0.0f;

  bool ok[ROWS];
  float a_n[ROWS], dy_n[ROWS], c_t[ROWS], cp_n[ROWS], carry[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = row0 + r;
    ok[r] = unit_ok && row < N;
    const size_t o = ((size_t)(T - 1) * N + row) * H + u;
    a_n[r] = ok[r] ? __ldg(act + ((size_t)(T - 1) * N + row) * G + q * H + u) : 0.0f;
    dy_n[r] = ok[r] ? __ldg(dy + o) : 0.0f;
    c_t[r] = ok[r] ? __ldg(c + o) : 0.0f;
    cp_n[r] = ok[r] ? c_prev(c, c0, T - 1, N, H, row, u) : 0.0f;
    carry[r] = 0.0f;
  }
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    const float* dgp = dgs + ((t + 1) & 1) * buf;  // dgates of step t+1
    float* dgc = dgs + (t & 1) * buf;              // dgates of step t
    float a_c[ROWS], dy_c[ROWS], cp_c[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      a_c[r] = a_n[r];
      dy_c[r] = dy_n[r];
      cp_c[r] = cp_n[r];
      if (t >= 1 && ok[r]) {  // step t-1's inputs, off the chain
        const int row = row0 + r;
        a_n[r] = __ldg(act + ((size_t)(t - 1) * N + row) * G + q * H + u);
        dy_n[r] = __ldg(dy + ((size_t)(t - 1) * N + row) * H + u);
        cp_n[r] = c_prev(c, c0, t - 1, N, H, row, u);
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      // quarter q's part of dgates_{t+1} . W_hh[u, :]
      const float* dq = dgp + (r * 4 + q) * QS;
      float part = 0.0f;
      if constexpr (WPT > 0) {
        const float4* d4 = reinterpret_cast<const float4*>(dq);
#pragma unroll
        for (int i = 0; i < WPT / 4; ++i) {
          const float4 dv = d4[kk + KS * i];
          part = fmaf(dv.x, w[4 * i + 0], part);
          part = fmaf(dv.y, w[4 * i + 1], part);
          part = fmaf(dv.z, w[4 * i + 2], part);
          part = fmaf(dv.w, w[4 * i + 3], part);
        }
#pragma unroll
        for (int off = KS / 2; off > 0; off /= 2) part += __shfl_xor_sync(0xffffffffu, part, off);
      } else {
        const float* wq = wt + (size_t)q * H * H + (unit_ok ? u : 0);
#pragma unroll 4
        for (int jj = 0; jj < H; ++jj) part = fmaf(dq[jj], __ldg(wq + (size_t)jj * H), part);
      }
      // dh = dy + the four parts in quarter order, then the gate gradients
      float dh = dy_c[r];
      dh += __shfl_sync(0xffffffffu, part, base);
      dh += __shfl_sync(0xffffffffu, part, base + KS);
      dh += __shfl_sync(0xffffffffu, part, base + 2 * KS);
      dh += __shfl_sync(0xffffffffu, part, base + 3 * KS);
      const float gi = __shfl_sync(0xffffffffu, a_c[r], base);
      const float gf = __shfl_sync(0xffffffffu, a_c[r], base + KS);
      const float gg = __shfl_sync(0xffffffffu, a_c[r], base + 2 * KS);
      const float go = __shfl_sync(0xffffffffu, a_c[r], base + 3 * KS);
      const float tc = tanhf(c_t[r]);
      const float do_lin = dh * tc * go * (1.0f - go);
      const float dc = dh * go * (1.0f - tc * tc) + carry[r];
      const float di_lin = dc * gg * gi * (1.0f - gi);
      const float dg_lin = dc * gi * (1.0f - gg * gg);
      const float df_lin = dc * cp_c[r] * gf * (1.0f - gf);
      carry[r] = dc * gf;
      c_t[r] = cp_c[r];
      if (kk == 0 && unit_ok) {
        const float v = q == 0 ? di_lin : q == 1 ? df_lin : q == 2 ? dg_lin : do_lin;
        dgc[(r * 4 + q) * QS + u] = v;
        if (ok[r]) dxw[((size_t)t * N + row0 + r) * G + q * H + u] = v;
      }
    }
    __syncthreads();
  }
}

// One 32 x 32 tile of dW_hh summed over one chunk of the M = T*N rows:
// partial[chunk][k][j] = sum_m h_prev[m][k] * dxw[m][j], with h_prev[m] =
// y[m - N] for m >= N and h0[m] (or zeros) below.
__global__ void __launch_bounds__(kDwThreads)
lstm_dw_partial_kernel(const float* __restrict__ y, const float* __restrict__ h0,
                       const float* __restrict__ dxw, float* __restrict__ partial, int T,
                       int N, int H, int chunk_rows) {
  __shared__ float hs[kTile][kTile + 1];
  __shared__ float ds[kTile][kTile + 1];
  const int G = 4 * H;
  const int tiles_j = (G + kTile - 1) / kTile;
  const int k0 = (blockIdx.x / tiles_j) * kTile;
  const int j0 = (blockIdx.x % tiles_j) * kTile;
  const long M = (long)T * N;
  const long m_begin = (long)blockIdx.y * chunk_rows;
  const long m_end = m_begin + chunk_rows < M ? m_begin + chunk_rows : M;
  const int tx = threadIdx.x % kTile;   // gate column in the tile
  const int ty = threadIdx.x / kTile;   // group of 4 units in the tile
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  for (long m0 = m_begin; m0 < m_end; m0 += kTile) {
    for (int e = threadIdx.x; e < kTile * kTile; e += kDwThreads) {
      const int mm = e / kTile, cc = e % kTile;
      const long m = m0 + mm;
      const int k = k0 + cc, jcol = j0 + cc;
      float hv = 0.0f, dv = 0.0f;
      if (m < m_end) {
        if (k < H)
          hv = m >= N ? __ldg(y + (size_t)(m - N) * H + k)
                      : (h0 != nullptr ? __ldg(h0 + (size_t)m * H + k) : 0.0f);
        if (jcol < G) dv = __ldg(dxw + (size_t)m * G + jcol);
      }
      hs[mm][cc] = hv;
      ds[mm][cc] = dv;
    }
    __syncthreads();
#pragma unroll 8
    for (int mm = 0; mm < kTile; ++mm) {
      const float d = ds[mm][tx];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = fmaf(hs[mm][ty * 4 + i], d, acc[i]);
    }
    __syncthreads();
  }
  float* out = partial + (size_t)blockIdx.y * H * G;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i, jcol = j0 + tx;
    if (k < H && jcol < G) out[(size_t)k * G + jcol] = acc[i];
  }
}

// dW_hh[idx] = sum over chunks of partial[chunk][idx], in chunk order.
__global__ void __launch_bounds__(kReduceThreads)
lstm_dw_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw, int chunks,
                      int HG) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= HG) return;
  float s = 0.0f;
  for (int p = 0; p < chunks; ++p) s += partial[(size_t)p * HG + idx];
  dw[idx] = s;
}

template <int KS, int WPT, int ROWS>
cudaError_t launch_rec(const float* act, const float* w_hh, const float* wt, const float* c,
                       const float* dy, const float* c0, float* dxw, int T, int N, int H,
                       cudaStream_t stream) {
  using PL = BwdPlan<KS, WPT>;
  if (H < 1 || (WPT > 0 && H > KS * WPT) || 4 * H > kMaxThreads) return cudaErrorInvalidValue;
  const int qs = PL::qs(H);
  const int smem = 2 * ROWS * 4 * qs * (int)sizeof(float);
  lstm_seq_bwd_rec_kernel<KS, WPT, ROWS><<<(N + ROWS - 1) / ROWS, PL::threads(H), smem, stream>>>(
      act, w_hh, wt, c, dy, c0, dxw, T, N, H, qs);
  return cudaGetLastError();
}

// The scratch's parts: act [M, 4H], the dW_hh partials [chunks, H, 4H] and
// W_hh^T [4H, H].
long scratch_floats(long M, int H, int chunks) {
  const long HG = 4L * H * H;
  return M * 4 * H + (long)chunks * HG + HG;
}

// The whole backward with plan (KS, WPT) at `rows` batch rows a block.
template <int KS, int WPT>
cudaError_t run_plan(int rows, const float* xw, const float* w_hh, const float* y,
                     const float* c, const float* dy, const float* h0, const float* c0,
                     float* dxw, float* dw, float* scratch, int T, int N, int H,
                     int chunk_rows, cudaStream_t s) {
  const long M = (long)T * N;
  const int G = 4 * H;
  const int chunks = (int)((M + chunk_rows - 1) / chunk_rows);
  float* act = scratch;
  float* part = act + M * G;
  float* wt = part + (long)chunks * H * G;
  lstm_bwd_gates_kernel<<<(unsigned)((M + kGateRows - 1) / kGateRows), G,
                          kGateRows * H * (int)sizeof(float), s>>>(xw, w_hh, y, h0, act, M, N,
                                                                   H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (WPT == 0) {
    lstm_transpose_kernel<<<(H * G + 255) / 256, 256, 0, s>>>(w_hh, wt, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  switch (rows) {
    case 1: err = launch_rec<KS, WPT, 1>(act, w_hh, wt, c, dy, c0, dxw, T, N, H, s); break;
    case 2: err = launch_rec<KS, WPT, 2>(act, w_hh, wt, c, dy, c0, dxw, T, N, H, s); break;
    case 4: err = launch_rec<KS, WPT, 4>(act, w_hh, wt, c, dy, c0, dxw, T, N, H, s); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const int tiles = ((H + kTile - 1) / kTile) * ((G + kTile - 1) / kTile);
  lstm_dw_partial_kernel<<<dim3(tiles, chunks), kDwThreads, 0, s>>>(y, h0, dxw, part, T, N, H,
                                                                    chunk_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int HG = H * G;
  lstm_dw_reduce_kernel<<<(HG + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0, s>>>(
      part, dw, chunks, HG);
  return cudaGetLastError();
}

// The plans: (KS, WPT) by width (plan_of).
struct PlanInfo {
  int ks, wpt;
};
constexpr PlanInfo kPlans[] = {
    {1, 32},  // 0: H <= 32
    {1, 64},  // 1: H <= 64
    {1, 0},   // 2: H <= 256, W_hh^T through L2
};

int plan_of(int H) { return H <= 32 ? 0 : H <= 64 ? 1 : 2; }

}  // namespace

extern "C" int lstm_seq_bwd_plan_of(int H, int* plan, int* ks, int* wpt) {
  if (H < 1 || 4 * H > kMaxThreads) return (int)cudaErrorInvalidValue;
  *plan = plan_of(H);
  *ks = kPlans[*plan].ks;
  *wpt = kPlans[*plan].wpt;
  return 0;
}

extern "C" long lstm_seq_bwd_scratch_floats(int T, int N, int H, int chunk_rows) {
  if (T < 1 || N < 1 || H < 1 || chunk_rows < 1) return 0;
  const long M = (long)T * N;
  return scratch_floats(M, H, (int)((M + chunk_rows - 1) / chunk_rows));
}

extern "C" int lstm_seq_bwd(const void* xw, const void* w_hh, const void* y, const void* c,
                            const void* dy, const void* h0, const void* c0, void* dxw,
                            void* dw_hh, void* scratch, int T, int N, int H, int chunk_rows,
                            void* stream) {
  if (H < 1 || 4 * H > kMaxThreads || N < 1 || T < 1 || chunk_rows < 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, max_smem = 0;
  cudaError_t err = lstm_common::device_limits(&dev, &sms, &max_smem);
  if (err != cudaSuccess) return (int)err;
  const float* a = static_cast<const float*>(xw);
  const float* w = static_cast<const float*>(w_hh);
  const float* yo = static_cast<const float*>(y);
  const float* co = static_cast<const float*>(c);
  const float* d = static_cast<const float*>(dy);
  const float* hi = static_cast<const float*>(h0);
  const float* ci = static_cast<const float*>(c0);
  float* dx = static_cast<float*>(dxw);
  float* dw = static_cast<float*>(dw_hh);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = lstm_common::rows_per_block(N, sms);
  switch (plan_of(H)) {
    case 0:
      return (int)run_plan<1, 32>(rows, a, w, yo, co, d, hi, ci, dx, dw, sc, T, N, H, chunk_rows,
                                  s);
    case 1:
      return (int)run_plan<1, 64>(rows, a, w, yo, co, d, hi, ci, dx, dw, sc, T, N, H, chunk_rows,
                                  s);
    default:
      return (int)run_plan<1, 0>(rows, a, w, yo, co, d, hi, ci, dx, dw, sc, T, N, H, chunk_rows,
                                 s);
  }
}
