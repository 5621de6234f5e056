// Unnormalised (C, C) confusion matrix from class indices.
//
// Replaces the TPU kernel `_confmat_kernel` (metrics_tpu/ops/confusion.py:37,
// launched by `_confmat_pallas`). For rows i < n with 0 <= target[i], pred[i] < C
// it adds one to out[target[i] * C + pred[i]] in an int32 array that the caller
// has zeroed. A label outside [0, C) (the padding label -1) adds nothing.
//
// Bound on the H100: the kernel reads 8 bytes a row and writes the C*C int32
// matrix once. At the ImageNet-1k validation batch (n = 1024, C = 1000) the
// 4 MB write dominates: 1.2 us at 3.35 TB/s, plus the launch (a few us).
//
// Why atomics and not the one-hot product: the TPU kernel expands (rows, C)
// one-hot tiles and contracts them on the matrix unit, because a scatter
// serialises there. That is 2*n*C*C operations for n additions. On Hopper an
// integer atomic per row does the n additions exactly and in any order, so the
// result is bit-identical to the plain version. While the C*C matrix fits in a
// block's shared memory (C <= 238) each block counts into a private copy and
// flushes the non-zero cells; above that (C = 1000 needs 4 MB) the rows go
// straight to global atomics, which at n = 1024 spread over a million cells
// almost never collide.
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
extern "C" int confusion_launch(const void* target, const void* pred, int n, int num_classes, void* out,
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

extern "C" const char* confusion_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
