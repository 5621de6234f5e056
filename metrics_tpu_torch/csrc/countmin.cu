// Count-min sketch update: hash every key once per table row and add its
// weight at (row, hash % width).
//
// Replaces the TPU kernel `_countmin_kernel` (metrics_tpu/ops/sketch_ops.py:48,
// launched by `_countmin_pallas`). For uint32 key bits (n,), float32 weights
// (n,) and uint32 seeds (depth,) it adds, into a float32 table (depth, width)
// that already holds the old counts,
//   table[d, hash_u32(bits[i] ^ seeds[d]) % width] += w[i]   for every i, d
// with the JAX package's hash (`hash_u32`, sketch_ops.py:39-45) in uint32
// registers, so the cells are those of the lax path exactly. Float atomics
// add in no fixed order; for integral weights every partial sum is an
// integer below 2^24 and exact, so the table equals the plain version (and
// JAX's scatter) bit for bit. Other weights agree to float32 rounding.
//
// Bound on the H100 at the click-stream batch, n = 65,536 keys into 4 x 1024:
// the bytes are 8 a key plus the table read and written, 0.56 MB, 0.17 us at
// 3.35 TB/s; the work is about 11 integer operations a key and row for the
// hash and the modulo plus one add, 2.9e6 operations, 0.04 us at 67 Tops/s.
// What holds it in practice is atomics on the few hot cells of a skewed
// stream, not bytes.
//
// Design. The TPU kernel turns the scatter into (128, width) one-hot tiles
// reduced on the matrix unit, carried across a sequential grid. Here, when
// the table fits a block's shared memory (the default 4 x 1024 is 16 KB), a
// block adds its share of the keys into a private copy of the table with
// shared-memory float atomics, then flushes it with one global atomicAdd per
// non-zero cell; the blocks are few enough that each adds about four times
// as many weights as it flushes cells. A larger table takes global atomics
// directly. There is no width limit.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 264;  // two a streaming multiprocessor on the H100

__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x45D9F3Bu;
  x = (x ^ (x >> 16)) * 0x45D9F3Bu;
  return x ^ (x >> 16);
}

__global__ void __launch_bounds__(kThreads) countmin_shared(const uint32_t* __restrict__ bits,
                                                            const float* __restrict__ w,
                                                            const uint32_t* __restrict__ seeds, int n, int depth,
                                                            int width, float* __restrict__ table) {
  extern __shared__ float s_table[];
  const int cells = depth * width;
  for (int c = threadIdx.x; c < cells; c += kThreads) s_table[c] = 0.0f;
  __syncthreads();
  const uint32_t uw = static_cast<uint32_t>(width);
  for (size_t i = blockIdx.x * static_cast<size_t>(kThreads) + threadIdx.x; i < static_cast<size_t>(n);
       i += static_cast<size_t>(gridDim.x) * kThreads) {
    const uint32_t b = bits[i];
    const float wi = w[i];
    for (int d = 0; d < depth; ++d) {
      atomicAdd(&s_table[d * width + hash_u32(b ^ seeds[d]) % uw], wi);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cells; c += kThreads) {
    const float v = s_table[c];
    if (v != 0.0f) atomicAdd(&table[c], v);
  }
}

__global__ void __launch_bounds__(kThreads) countmin_global(const uint32_t* __restrict__ bits,
                                                            const float* __restrict__ w,
                                                            const uint32_t* __restrict__ seeds, int n, int depth,
                                                            int width, float* __restrict__ table) {
  const uint32_t uw = static_cast<uint32_t>(width);
  for (size_t i = blockIdx.x * static_cast<size_t>(kThreads) + threadIdx.x; i < static_cast<size_t>(n);
       i += static_cast<size_t>(gridDim.x) * kThreads) {
    const uint32_t b = bits[i];
    const float wi = w[i];
    for (int d = 0; d < depth; ++d) {
      atomicAdd(&table[static_cast<size_t>(d) * width + hash_u32(b ^ seeds[d]) % uw], wi);
    }
  }
}

// Shared memory a block may use on the current device (the opt-in limit), or 0.
int shared_limit() {
  int device = 0, bytes = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess) return 0;
  return bytes;
}

}  // namespace

// 1 when a (depth, width) table takes the shared-memory branch, else 0.
extern "C" int countmin_uses_shared(int depth, int width) {
  const long long bytes = 4LL * depth * width;
  return bytes <= shared_limit() ? 1 : 0;
}

// Adds the batch into `table` on `stream` and returns cudaGetLastError()
// (0 on success). `bits` (n,) uint32, `w` (n,) float32, `seeds` (depth,)
// uint32 and `table` (depth, width) float32, all contiguous.
extern "C" int countmin_launch(const void* bits, const void* w, const void* seeds, int n, int depth, int width,
                               void* table, void* stream) {
  if (n <= 0 || depth <= 0 || width <= 0) return 0;
  const auto* b = static_cast<const uint32_t*>(bits);
  const auto* wt = static_cast<const float*>(w);
  const auto* sd = static_cast<const uint32_t*>(seeds);
  auto* out = static_cast<float*>(table);
  auto s = static_cast<cudaStream_t>(stream);
  const long long cells = static_cast<long long>(depth) * width;
  if (countmin_uses_shared(depth, width)) {
    const int bytes = static_cast<int>(4 * cells);
    // each block adds about four times as many weights as it has cells to flush
    long long blocks = (static_cast<long long>(n) * depth + 4 * cells - 1) / (4 * cells);
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    if (blocks < 1) blocks = 1;
    cudaError_t err = cudaFuncSetAttribute(countmin_shared, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    countmin_shared<<<static_cast<unsigned>(blocks), kThreads, bytes, s>>>(b, wt, sd, n, depth, width, out);
  } else {
    long long blocks = (static_cast<long long>(n) + kThreads - 1) / kThreads;
    if (blocks > 4 * kMaxBlocks) blocks = 4 * kMaxBlocks;
    countmin_global<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(b, wt, sd, n, depth, width, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* countmin_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
