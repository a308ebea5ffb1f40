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
// (student H=32: 4K per row; teacher H=128: 64K per row).  At serving batch 1
// (N = 2) the bytes are tiny too (xw, y and c are 4H + 2H floats per row and
// step; W_hh, 16 KB or 256 KB, is read once), so neither the memory rate nor
// the FLOP rate binds: the latency of one step times T does.  The floor is the
// per-step latency of a dependent h @ W_hh plus two block barriers.
//
// Design.  The TPU kernel's grid walked time in order on one core.  Here rows
// are independent, so the grid runs over tiles of ROWS batch rows and each
// block walks the whole time loop itself; no sum crosses blocks.
//   - One thread per gate column j (blockDim = 4H; H <= 256).  It accumulates
//     h[r] . W_hh[:, j] for the ROWS rows of its block in f32 registers, adds
//     xw[t], applies the column's nonlinearity (tanh for g, sigmoid else) and
//     stores the gate to shared memory.  __syncthreads.
//   - Threads 0 .. ROWS*H-1 then own one (row, unit) pair each: c stays in that
//     thread's register for all T; h goes to shared memory and both go out to
//     y and c_out.  __syncthreads.
//   - xw[t+1] is loaded into registers while step t computes, so its global
//     latency is off the chain.
//   - W_hh: the rows that fit go to dynamic shared memory, the rest are read
//     through L2 with __ldg.  The student's W_hh (32 x 128 x 4 B = 16 KB) fits
//     whole.  The teacher's (128 x 512 x 4 B = 256 KB) exceeds the 227 KB a
//     block may hold (232448 B opt-in), so 112 of its 128 rows sit in shared
//     memory at one row per block (111 at two, 108 at four) and the rest are
//     read through L2 (256 KB sits easily in the 50 MB L2).
//     A cluster splitting the columns over DSMEM, or bf16 W_hh, is later work.
//   - ROWS is the smallest of 1, 2, 4 that gives no more blocks than the card
//     has SMs (common.cuh, rows_per_block).
//
// Interface: plain C, bound with ctypes.  Pointers and the stream are passed as
// void*; the return value is cudaGetLastError() after the launch.

#include "common.cuh"

namespace {

using lstm_common::kMaxDevices;
using lstm_common::kMaxThreads;
using lstm_common::sigmoid_f32;

template <int ROWS>
__global__ void __launch_bounds__(kMaxThreads)
lstm_seq_fwd_kernel(const float* __restrict__ xw, const float* __restrict__ w_hh,
                    const float* __restrict__ h0, const float* __restrict__ c0,
                    float* __restrict__ y, float* __restrict__ c_out,
                    int T, int N, int H, int w_rows_smem) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  float* w_s = smem;                            // [w_rows_smem, G]
  float* h_s = w_s + (size_t)w_rows_smem * G;   // [ROWS, H]
  float* g_s = h_s + ROWS * H;                  // [ROWS, G] gates after nonlinearity
  const int j = threadIdx.x;                    // this thread's gate column
  const int row0 = blockIdx.x * ROWS;

  for (int idx = j; idx < w_rows_smem * G; idx += blockDim.x) w_s[idx] = w_hh[idx];
  for (int idx = j; idx < ROWS * H; idx += blockDim.x) {
    const int row = row0 + idx / H;
    h_s[idx] = (h0 != nullptr && row < N) ? h0[(size_t)row * H + idx % H] : 0.0f;
  }
  // the (row, unit) pair this thread updates; its c lives in a register
  const bool owner = j < ROWS * H;
  const int ur = j / H;
  const int uu = j - ur * H;
  const int urow = row0 + ur;
  const bool writes = owner && urow < N;
  float c = (writes && c0 != nullptr) ? c0[(size_t)urow * H + uu] : 0.0f;
  const bool tanh_col = (j >= 2 * H) && (j < 3 * H);

  float xn[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    xn[r] = (row0 + r < N) ? __ldg(xw + (size_t)(row0 + r) * G + j) : 0.0f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    float xcur[ROWS], acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      xcur[r] = xn[r];
      acc[r] = 0.0f;
    }
    if (t + 1 < T) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        xn[r] = (row0 + r < N)
                    ? __ldg(xw + ((size_t)(t + 1) * N + row0 + r) * G + j)
                    : 0.0f;
    }
#pragma unroll 4
    for (int k = 0; k < w_rows_smem; ++k) {
      const float w = w_s[(size_t)k * G + j];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(h_s[r * H + k], w, acc[r]);
    }
#pragma unroll 4
    for (int k = w_rows_smem; k < H; ++k) {
      const float w = __ldg(w_hh + (size_t)k * G + j);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(h_s[r * H + k], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float v = xcur[r] + acc[r];
      g_s[r * G + j] = tanh_col ? tanhf(v) : sigmoid_f32(v);
    }
    __syncthreads();
    if (owner) {
      const float* g = g_s + ur * G;
      c = g[H + uu] * c + g[uu] * g[2 * H + uu];
      const float h = g[3 * H + uu] * tanhf(c);
      h_s[ur * H + uu] = h;
      if (writes) {
        const size_t o = ((size_t)t * N + urow) * H + uu;
        y[o] = h;
        c_out[o] = c;
      }
    }
    __syncthreads();
  }
}

template <int ROWS>
cudaError_t launch(const float* xw, const float* w_hh, const float* h0, const float* c0,
                   float* y, float* c, int T, int N, int H, int dev, int max_smem,
                   cudaStream_t stream) {
  // Let every launch of this instance use up to the device's opt-in limit;
  // set once per device.
  static std::atomic<bool> smem_allowed[kMaxDevices];
  if (!smem_allowed[dev]) {
    cudaError_t err = cudaFuncSetAttribute(lstm_seq_fwd_kernel<ROWS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           max_smem);
    if (err != cudaSuccess) return err;
    smem_allowed[dev] = true;
  }
  // W_hh rows that fit beside h and the gates go to shared memory; the rest
  // are read through L2.
  const long G = 4L * H;
  const long fixed = (long)ROWS * (H + G) * (long)sizeof(float);
  long w_rows = (max_smem - fixed) / (G * (long)sizeof(float));
  if (w_rows < 0) w_rows = 0;
  if (w_rows > H) w_rows = H;
  const int smem_bytes = (int)(fixed + w_rows * G * (long)sizeof(float));
  const int blocks = (N + ROWS - 1) / ROWS;
  lstm_seq_fwd_kernel<ROWS><<<blocks, 4 * H, smem_bytes, stream>>>(
      xw, w_hh, h0, c0, y, c, T, N, H, (int)w_rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lstm_seq_fwd(const void* xw, const void* w_hh, const void* h0,
                            const void* c0, void* y, void* c, int T, int N, int H,
                            void* stream) {
  if (H < 1 || 4 * H > kMaxThreads || N < 1 || T < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, max_smem = 0;
  cudaError_t err = lstm_common::device_limits(&dev, &sms, &max_smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = lstm_common::rows_per_block(N, sms);
  const float* a = static_cast<const float*>(xw);
  const float* w = static_cast<const float*>(w_hh);
  const float* hi = static_cast<const float*>(h0);
  const float* ci = static_cast<const float*>(c0);
  float* yo = static_cast<float*>(y);
  float* co = static_cast<float*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 1: return (int)launch<1>(a, w, hi, ci, yo, co, T, N, H, dev, max_smem, s);
    case 2: return (int)launch<2>(a, w, hi, ci, yo, co, T, N, H, dev, max_smem, s);
    default: return (int)launch<4>(a, w, hi, ci, yo, co, T, N, H, dev, max_smem, s);
  }
}
