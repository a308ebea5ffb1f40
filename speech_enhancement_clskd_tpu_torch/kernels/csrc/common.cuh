// Helpers shared by the LSTM kernels (lstm_seq_fwd.cu, lstm_seq_bwd.cu).
// Each source includes this header and is built into its own library;
// kernels/_build.py hashes the headers with the source, so an edit here
// rebuilds both.

#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace lstm_common {

constexpr int kMaxThreads = 1024;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float sigmoid_f32(float x) { return 1.0f / (1.0f + expf(-x)); }

// SM count and opt-in shared memory per block of the current device, read
// once per device; the launch path then asks the runtime only which device is
// current.
inline cudaError_t device_limits(int* dev, int* sms, int* max_smem) {
  static std::atomic<int> sms_cache[kMaxDevices], smem_cache[kMaxDevices];
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev < 0 || *dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms_cache[*dev] == 0) {
    int s = 0, m = 0;
    err = cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, *dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&m, cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev);
    if (err != cudaSuccess) return err;
    smem_cache[*dev] = m;
    sms_cache[*dev] = s;
  }
  *max_smem = smem_cache[*dev];
  *sms = sms_cache[*dev];
  return cudaSuccess;
}

// The fewest batch rows per block (1, 2 or 4) that need no more blocks than
// the card has SMs: small batches spread one row per SM, large ones amortise
// each W_hh read over more rows.
inline int rows_per_block(int N, int sms) {
  int rows = 1;
  while (rows < 4 && (N + rows - 1) / rows > sms) rows *= 2;
  return rows;
}

}  // namespace lstm_common
