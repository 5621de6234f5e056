// The card's limits that the launch plans read (metrics_tpu_torch/ops/*.py):
// every kernel library exports them as `<name>_device`.
#pragma once
#include <cuda_runtime.h>

// The current device's SM count and the shared memory a block may use (the
// opt-in limit); returns a CUDA error code.
inline int device_limits(int* sms, int* shared_optin) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(shared_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return static_cast<int>(err);
}
