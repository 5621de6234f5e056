// The earlier design of csrc/confusion.cu, kept only as the timing baseline
// that chip_smoke.py holds the current kernel against; nothing in
// metrics_tpu_torch launches it.
//
// Unnormalised (C, C) confusion matrix from class indices, added into an int32
// array that the caller has zeroed (a memset before the kernel). While the
// C*C matrix fits a block's shared memory (C <= 240) each of up to 264 blocks
// counts into a private copy and flushes the non-zero cells with global
// atomics; above that the rows go straight to global atomics.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 264;            // two blocks on each of the 132 SMs
constexpr size_t kMaxSmem = 232448;        // 227 KB: a block's shared memory limit on sm_90
constexpr size_t kDefaultSmem = 48 * 1024; // above this a kernel must opt in

__global__ void confmat_shared(const int32_t* __restrict__ target, const int32_t* __restrict__ pred, int n,
                               int num_classes, int32_t* __restrict__ out) {
  extern __shared__ int32_t hist[];
  const int cells = num_classes * num_classes;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const int32_t t = target[i];
    const int32_t p = pred[i];
    if (t >= 0 && t < num_classes && p >= 0 && p < num_classes) atomicAdd(&hist[t * num_classes + p], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int32_t v = hist[i];
    if (v != 0) atomicAdd(&out[i], v);
  }
}

__global__ void confmat_global(const int32_t* __restrict__ target, const int32_t* __restrict__ pred, int n,
                               int num_classes, int32_t* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const int32_t t = target[i];
    const int32_t p = pred[i];
    if (t >= 0 && t < num_classes && p >= 0 && p < num_classes) {
      atomicAdd(&out[static_cast<int64_t>(t) * num_classes + p], 1);
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int confusion_atomic_launch(const void* target, const void* pred, int n, int num_classes, void* out,
                                void* stream) {
  if (n <= 0) return 0;
  int blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const auto* t = static_cast<const int32_t*>(target);
  const auto* p = static_cast<const int32_t*>(pred);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(num_classes) * num_classes * sizeof(int32_t);
  if (smem <= kMaxSmem) {
    if (smem > kDefaultSmem) {
      const cudaError_t err =
          cudaFuncSetAttribute(confmat_shared, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    confmat_shared<<<blocks, kThreads, smem, s>>>(t, p, n, num_classes, o);
  } else {
    confmat_global<<<blocks, kThreads, 0, s>>>(t, p, n, num_classes, o);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* confusion_atomic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
