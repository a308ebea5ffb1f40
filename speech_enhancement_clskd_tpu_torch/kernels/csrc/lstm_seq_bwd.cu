// LSTM sequence backward for Hopper (sm_90a): the time-reversed recurrence in
// one launch, then dW_hh in a deterministic two-pass reduction.
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
// What bounds it on this card.  As in the forward, step t needs dgates from
// step t+1, so the T steps are one serial chain of small matrix-vector
// products: per row and step H x 4H multiply-adds to recompute the gates and
// as many for dh.  At the training step's shape (T=483, N=64, H=32) the bytes
// (~44 MB) take ~13 us at 3.35 TB/s and the ~0.8 GFLOP (the dW_hh product
// included) ~12 us at 67 TFLOP/s; the chain of 483 dependent steps, each two
// block barriers long, sets the time (0.71 ms measured on an H100).  dW_hh is
// a [H, T*N] x [T*N, 4H] product with no serial dependency.
//
// Design.
//   1. lstm_seq_bwd_rec_kernel: K1f's grid.  Tiles of ROWS batch rows, each
//      block walking all of T in reverse; rows are independent, so no sum
//      crosses blocks.  4H threads.  Per step:
//        phase A (all threads): thread j recomputes gate column j from
//          h_{t-1} (shared memory) and W_hh[:, j], and, as thread (q, k) with
//          j = q*H + k, the part of (dgates_{t+1} @ W_hh^T)[:, k] over the
//          gate columns of quarter q.  The two products are independent, so
//          they run in the same phase.  __syncthreads.
//        phase B (threads 0 .. ROWS*H-1, one per (row, unit)): sums the four
//          quarter parts into dh, forms dc and the four gate gradients, keeps
//          dc*f in a register for step t-1, writes dgates to shared memory and
//          to dxw, and puts h_{t-2} into shared memory.  __syncthreads.
//      The global loads of step t-1 (xw, dy, c_{t-2}, h_{t-3}) are issued at
//      the start of step t, so their latency is off the chain.
//   2. W_hh sits in shared memory with a row stride of 4H+1 floats.  Phase A
//      reads it by column (thread j, row k: W[k][j]) and by row (thread k,
//      column j: W[k][j]); with the odd stride both patterns are free of bank
//      conflicts, so one copy serves both.  The student's W_hh (16 KB) fits
//      whole.  The teacher's (256 KB) does not fit the 227 KB a block may
//      hold: as in the forward, the rows that fit go to shared memory (110 of
//      128 at one row per block) and the rest are read through L2 with __ldg.
//   3. dW_hh.  The TPU kernel accumulated it into one block over a grid that
//      ran in order; CUDA blocks run at the same time, so the sum is a second
//      pass over the dxw already in device memory: lstm_dw_partial_kernel
//      gives each block a 32 x 32 tile of dW_hh and one chunk of the T*N rows
//      (h_{t-1} is y shifted by N rows, or h0), and writes its partial sum to
//      scratch; lstm_dw_reduce_kernel adds the chunks in a fixed order.  No
//      atomics: the result is the same bit for bit on every run.
//
// Interface: plain C, bound with ctypes.  Pointers and the stream are passed as
// void*; the return value is the first cudaGetLastError() after a launch.  The
// caller allocates dxw [T, N, 4H], dW_hh [H, 4H] and the scratch of
// ceil(T*N / chunk_rows) x H x 4H floats.

#include "common.cuh"

namespace {

using lstm_common::kMaxDevices;
using lstm_common::kMaxThreads;
using lstm_common::sigmoid_f32;

constexpr int kTile = 32;         // dW_hh tile (units x gate columns) and rows per stage
constexpr int kDwThreads = 256;   // 32 columns x 8 groups of 4 units
constexpr int kReduceThreads = 256;

// h_{s-1} and c_{s-1} of step s for one (row, unit): the forward's outputs at
// s-1, or the initial state (zeros when absent) at s = 0.
__device__ __forceinline__ float prev_of(const float* __restrict__ seq,
                                         const float* __restrict__ init, int s, int N,
                                         int H, int row, int u) {
  if (s >= 1) return __ldg(seq + ((size_t)(s - 1) * N + row) * H + u);
  return init != nullptr ? __ldg(init + (size_t)row * H + u) : 0.0f;
}

template <int ROWS>
__global__ void __launch_bounds__(kMaxThreads)
lstm_seq_bwd_rec_kernel(const float* __restrict__ xw, const float* __restrict__ w_hh,
                        const float* __restrict__ y, const float* __restrict__ c,
                        const float* __restrict__ dy, const float* __restrict__ h0,
                        const float* __restrict__ c0, float* __restrict__ dxw, int T,
                        int N, int H, int w_rows_smem) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  const int ws = G + 1;                             // padded row stride of W_hh
  float* w_s = smem;                                // [w_rows_smem, G + 1]
  float* hp_s = w_s + (size_t)w_rows_smem * ws;     // [ROWS, H]  h_{t-1}
  float* g_s = hp_s + ROWS * H;                     // [ROWS, G]  gates of step t
  float* dg_s = g_s + ROWS * G;                     // [ROWS, G]  dgates of step t+1
  float* p_s = dg_s + ROWS * G;                     // [4, ROWS, H] parts of dh
  const int j = threadIdx.x;
  const int row0 = blockIdx.x * ROWS;

  for (int idx = j; idx < w_rows_smem * G; idx += blockDim.x) {
    const int k = idx / G;
    w_s[k * ws + (idx - k * G)] = w_hh[idx];
  }
  for (int idx = j; idx < ROWS * G; idx += blockDim.x) dg_s[idx] = 0.0f;

  // phase A's second product: quarter q of the gate columns, unit kq
  const int q = j / H;
  const int kq = j - q * H;
  const bool tanh_col = (j >= 2 * H) && (j < 3 * H);
  // phase B: the (row, unit) pair this thread owns
  const bool owner = j < ROWS * H;
  const int ur = j / H;
  const int uu = j - ur * H;
  const int urow = row0 + ur;
  const bool valid = owner && urow < N;

  // owner registers: c_t, dc carried from step t+1, this step's dy and
  // c_{t-1}, and h_{t-2} (written to shared memory at the end of step t)
  float c_t = 0.0f, dc_carry = 0.0f, dy_cur = 0.0f, cp_cur = 0.0f, hp_cur = 0.0f;
  if (valid) {
    hp_s[j] = prev_of(y, h0, T - 1, N, H, urow, uu);
    c_t = __ldg(c + ((size_t)(T - 1) * N + urow) * H + uu);
    dy_cur = __ldg(dy + ((size_t)(T - 1) * N + urow) * H + uu);
    cp_cur = prev_of(c, c0, T - 1, N, H, urow, uu);
    if (T >= 2) hp_cur = prev_of(y, h0, T - 2, N, H, urow, uu);
  } else if (owner) {
    hp_s[j] = 0.0f;
  }
  float xn[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    xn[r] = (row0 + r < N) ? __ldg(xw + ((size_t)(T - 1) * N + row0 + r) * G + j) : 0.0f;
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    // ---- phase A
    float xcur[ROWS], acc[ROWS], part[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      xcur[r] = xn[r];
      acc[r] = 0.0f;
      part[r] = 0.0f;
    }
    float dy_nx = 0.0f, cp_nx = 0.0f, hp_nx = 0.0f;
    if (t >= 1) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        xn[r] = (row0 + r < N) ? __ldg(xw + ((size_t)(t - 1) * N + row0 + r) * G + j) : 0.0f;
      if (valid) {
        dy_nx = __ldg(dy + ((size_t)(t - 1) * N + urow) * H + uu);
        cp_nx = prev_of(c, c0, t - 1, N, H, urow, uu);
        if (t >= 2) hp_nx = prev_of(y, h0, t - 2, N, H, urow, uu);
      }
    }
    // gate column j of step t: h_{t-1} . W_hh[:, j]
#pragma unroll 4
    for (int k = 0; k < w_rows_smem; ++k) {
      const float w = w_s[k * ws + j];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(hp_s[r * H + k], w, acc[r]);
    }
#pragma unroll 4
    for (int k = w_rows_smem; k < H; ++k) {
      const float w = __ldg(w_hh + (size_t)k * G + j);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(hp_s[r * H + k], w, acc[r]);
    }
    // quarter q's part of dgates_{t+1} . W_hh[kq, :]
    const int j0 = q * H;
    if (kq < w_rows_smem) {
      const float* wrow = w_s + kq * ws;
#pragma unroll 4
      for (int jj = j0; jj < j0 + H; ++jj) {
        const float w = wrow[jj];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) part[r] = fmaf(dg_s[r * G + jj], w, part[r]);
      }
    } else {
      const float* wrow = w_hh + (size_t)kq * G;
#pragma unroll 4
      for (int jj = j0; jj < j0 + H; ++jj) {
        const float w = __ldg(wrow + jj);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) part[r] = fmaf(dg_s[r * G + jj], w, part[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float v = xcur[r] + acc[r];
      g_s[r * G + j] = tanh_col ? tanhf(v) : sigmoid_f32(v);
      p_s[(q * ROWS + r) * H + kq] = part[r];
    }
    __syncthreads();

    // ---- phase B
    if (owner) {
      const float* g = g_s + ur * G;
      const float gi = g[uu], gf = g[H + uu], gg = g[2 * H + uu], go = g[3 * H + uu];
      float dh = dy_cur;
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) dh += p_s[(qq * ROWS + ur) * H + uu];
      const float tc = tanhf(c_t);
      const float do_lin = dh * tc * go * (1.0f - go);
      const float dc = dh * go * (1.0f - tc * tc) + dc_carry;
      const float di_lin = dc * gg * gi * (1.0f - gi);
      const float dg_lin = dc * gi * (1.0f - gg * gg);
      const float df_lin = dc * cp_cur * gf * (1.0f - gf);
      dc_carry = dc * gf;
      float* d = dg_s + ur * G;
      d[uu] = di_lin;
      d[H + uu] = df_lin;
      d[2 * H + uu] = dg_lin;
      d[3 * H + uu] = do_lin;
      if (valid) {
        float* o = dxw + ((size_t)t * N + urow) * G;
        o[uu] = di_lin;
        o[H + uu] = df_lin;
        o[2 * H + uu] = dg_lin;
        o[3 * H + uu] = do_lin;
      }
      if (t >= 1) hp_s[j] = hp_cur;
      c_t = cp_cur;
      dy_cur = dy_nx;
      cp_cur = cp_nx;
      hp_cur = hp_nx;
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

template <int ROWS>
cudaError_t launch_rec(const float* xw, const float* w_hh, const float* y, const float* c,
                       const float* dy, const float* h0, const float* c0, float* dxw, int T,
                       int N, int H, int dev, int max_smem, cudaStream_t stream) {
  static std::atomic<bool> smem_allowed[kMaxDevices];
  if (!smem_allowed[dev]) {
    cudaError_t err = cudaFuncSetAttribute(lstm_seq_bwd_rec_kernel<ROWS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           max_smem);
    if (err != cudaSuccess) return err;
    smem_allowed[dev] = true;
  }
  // W_hh rows that fit beside h, the gates, dgates and the dh parts go to
  // shared memory at the padded stride; the rest are read through L2.
  const long G = 4L * H;
  const long fixed = (long)ROWS * (H + 3 * G) * (long)sizeof(float);
  long w_rows = (max_smem - fixed) / ((G + 1) * (long)sizeof(float));
  if (w_rows < 0) w_rows = 0;
  if (w_rows > H) w_rows = H;
  const int smem_bytes = (int)(fixed + w_rows * (G + 1) * (long)sizeof(float));
  const int blocks = (N + ROWS - 1) / ROWS;
  lstm_seq_bwd_rec_kernel<ROWS><<<blocks, 4 * H, smem_bytes, stream>>>(
      xw, w_hh, y, c, dy, h0, c0, dxw, T, N, H, (int)w_rows);
  return cudaGetLastError();
}

}  // namespace

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
  float* part = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lstm_common::rows_per_block(N, sms)) {
    case 1: err = launch_rec<1>(a, w, yo, co, d, hi, ci, dx, T, N, H, dev, max_smem, s); break;
    case 2: err = launch_rec<2>(a, w, yo, co, d, hi, ci, dx, T, N, H, dev, max_smem, s); break;
    default: err = launch_rec<4>(a, w, yo, co, d, hi, ci, dx, T, N, H, dev, max_smem, s);
  }
  if (err != cudaSuccess) return (int)err;

  const long M = (long)T * N;
  const int chunks = (int)((M + chunk_rows - 1) / chunk_rows);
  const int G = 4 * H;
  const int tiles = ((H + kTile - 1) / kTile) * ((G + kTile - 1) / kTile);
  lstm_dw_partial_kernel<<<dim3(tiles, chunks), kDwThreads, 0, s>>>(yo, hi, dx, part, T, N, H,
                                                                    chunk_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int HG = H * G;
  lstm_dw_reduce_kernel<<<(HG + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0, s>>>(
      part, dw, chunks, HG);
  return (int)cudaGetLastError();
}
