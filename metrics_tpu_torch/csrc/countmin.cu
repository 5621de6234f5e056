// Count-min sketch update: hash every key once per table row and add its
// weight at (row, hash % width).
//
// Replaces the TPU kernel `_countmin_kernel` (metrics_tpu/ops/sketch_ops.py:48,
// launched by `_countmin_pallas`). For uint32 key bits (n,), float32 weights
// (n,) and uint32 seeds (depth,) it writes the float32 table (depth, width)
//   out[d, c] = value[d, c] + sum of w[i] over the keys i with hash_u32(bits[i] ^ seeds[d]) % width == c
// with the JAX package's hash (`hash_u32`, sketch_ops.py:39-45) in uint32
// registers, so the cells are those of the lax path exactly.
//
// Bound on the H100 at the click-stream batch, n = 65,536 keys into 4 x 1024:
// the bytes are 8 a key plus the table read and written, 0.56 MB, 0.17 us at
// 3.35 TB/s; the work is about 11 integer operations a key and row for the
// hash and the modulo plus one add, 2.9e6 operations, 0.04 us at 67 Tops/s.
// At that size what takes the time is latency (launches, the zeroing and
// reduction of the per-block tables) and, on a skewed stream, many lanes
// adding into the same few hot cells.
//
// Every warp aggregates first: per key and row, __match_any_sync groups the
// lanes of a warp whose keys hit the same cell, and the group's lowest lane
// adds the group's weights, summed in lane order, with one add. The branch
// is chosen by the caller (metrics_tpu_torch/ops/sketch_ops.py) from the
// table's size and the device's shared-memory limit:
//
// * Shared, when one table fits the opt-in shared-memory limit (the default
//   4 x 1024 is 16 KB): `countmin_partials` runs on a grid sized from the
//   SM count (one block an SM, fewer when a block would get fewer than 512
//   keys). Each warp of a block owns a private table in shared memory (8
//   tables, 128 KB, at 4 x 1024), so a warp's adds need no atomics and come
//   in program order. The block zeroes its tables and sums them in warp order
//   four cells at a time (float4), and stores the sum to its row of a
//   workspace (blocks, depth * width) with plain stores. `countmin_sum_partials` then
//   writes out = value + the blocks' partials, summed in a fixed order. No
//   atomics anywhere: two launches on the same input give the same bits on
//   the same device, for fractional weights too; integral weights give
//   integer partial sums below 2^24, exact, equal to the plain version.
// * Global, for wider tables (4 x 65536): `countmin_global` adds each group's
//   sum into `out` (a copy of `value`) with one global float atomic. The order
//   of the atomics varies, so fractional weights agree to float32 rounding;
//   integral weights are exact.
#include <cuda_runtime.h>
#include <cstdint>

#include "device.cuh"

namespace {

constexpr int kThreads = 256;  // countmin_global and countmin_sum_partials
constexpr int kSumWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr uint32_t kNoCell = 0xffffffffu;  // a lane past the last key; no cell is this large

__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x45D9F3Bu;
  x = (x ^ (x >> 16)) * 0x45D9F3Bu;
  return x ^ (x >> 16);
}

// The weights of the lanes in `group`, summed in lane order from the warp's staged weights.
__device__ __forceinline__ float group_sum(unsigned group, const float* s_w) {
  float sum = 0.0f;
  for (unsigned m = group; m; m &= m - 1) sum += s_w[__ffs(m) - 1];
  return sum;
}

// Every lane of a block runs every round (the loop bound is the block's), so
// the warp-wide __match_any_sync sees all 32 lanes.
__global__ void __launch_bounds__(kThreads) countmin_partials(const uint32_t* __restrict__ bits,
                                                              const float* __restrict__ w,
                                                              const uint32_t* __restrict__ seeds, int n, int depth,
                                                              int width, float* __restrict__ partial) {
  extern __shared__ float4 s_tables4[];  // one table of `quads` float4s a warp, then 32 staged weights a warp
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cells = depth * width;
  const int quads = (cells + 3) / 4;  // a table's stride, in float4s
  float* mine = reinterpret_cast<float*>(s_tables4 + warp * quads);
  float* s_w = reinterpret_cast<float*>(s_tables4 + warps * quads) + warp * 32;
  for (int c = threadIdx.x; c < warps * quads; c += blockDim.x) s_tables4[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();
  const uint32_t uw = static_cast<uint32_t>(width);
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t first = static_cast<size_t>(blockIdx.x) * blockDim.x; first < static_cast<size_t>(n);
       first += stride) {
    const size_t i = first + threadIdx.x;
    const bool valid = i < static_cast<size_t>(n);
    const uint32_t b = valid ? bits[i] : 0u;
    s_w[lane] = valid ? w[i] : 0.0f;
    __syncwarp();
    for (int d = 0; d < depth; ++d) {
      const uint32_t cell = valid ? hash_u32(b ^ __ldg(seeds + d)) % uw : kNoCell;
      const unsigned group = __match_any_sync(kAll, cell);
      // one lane a cell: the warp's table takes plain adds
      if (valid && lane == __ffs(group) - 1) mine[d * width + cell] += group_sum(group, s_w);
    }
    __syncwarp();  // the next round restages s_w and may add to the same cells
  }
  __syncthreads();
  // the block's sum, four cells a thread, warps in order; plain stores of the block's row
  for (int c4 = threadIdx.x; c4 < quads; c4 += blockDim.x) {
    float4 sum = s_tables4[c4];
    for (int k = 1; k < warps; ++k) {
      const float4 x = s_tables4[k * quads + c4];
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    float* row = partial + static_cast<size_t>(blockIdx.x) * cells;
    const int c = 4 * c4;
    if (c < cells) row[c] = sum.x;
    if (c + 1 < cells) row[c + 1] = sum.y;
    if (c + 2 < cells) row[c + 2] = sum.z;
    if (c + 3 < cells) row[c + 3] = sum.w;
  }
}

// out[c] = value[c] + the blocks' partials: warp k of a block sums blocks
// k, k + 8, ... for 32 cells, then the 8 sums are added in warp order.
__global__ void __launch_bounds__(kThreads) countmin_sum_partials(const float* __restrict__ partial, int blocks,
                                                                  int cells, const float* __restrict__ value,
                                                                  float* __restrict__ out) {
  __shared__ float s_sum[kSumWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * 32 + lane;
  float sum = 0.0f;
  if (c < cells) {
    for (int b = warp; b < blocks; b += kSumWarps) sum += partial[static_cast<size_t>(b) * cells + c];
  }
  s_sum[warp][lane] = sum;
  __syncthreads();
  if (warp == 0 && c < cells) {
    float total = s_sum[0][lane];
#pragma unroll
    for (int k = 1; k < kSumWarps; ++k) total += s_sum[k][lane];
    out[c] = value[c] + total;
  }
}

__global__ void __launch_bounds__(kThreads) countmin_global(const uint32_t* __restrict__ bits,
                                                            const float* __restrict__ w,
                                                            const uint32_t* __restrict__ seeds, int n, int depth,
                                                            int width, float* __restrict__ table) {
  __shared__ float s_w_all[kThreads];
  float* s_w = s_w_all + (threadIdx.x / 32) * 32;
  const int lane = threadIdx.x % 32;
  const uint32_t uw = static_cast<uint32_t>(width);
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  for (size_t first = static_cast<size_t>(blockIdx.x) * kThreads; first < static_cast<size_t>(n);
       first += stride) {
    const size_t i = first + threadIdx.x;
    const bool valid = i < static_cast<size_t>(n);
    const uint32_t b = valid ? bits[i] : 0u;
    s_w[lane] = valid ? w[i] : 0.0f;
    __syncwarp();
    for (int d = 0; d < depth; ++d) {
      const uint32_t cell = valid ? hash_u32(b ^ __ldg(seeds + d)) % uw : kNoCell;
      const unsigned group = __match_any_sync(kAll, cell);
      if (valid && lane == __ffs(group) - 1) {
        atomicAdd(&table[static_cast<size_t>(d) * width + cell], group_sum(group, s_w));
      }
    }
    __syncwarp();
  }
}

}  // namespace

// The card's limits, from which the caller sizes the launch (device.cuh).
extern "C" int countmin_device(int* sms, int* shared_optin) { return device_limits(sms, shared_optin); }

// Writes the updated table to `out` on `stream` and returns cudaGetLastError()
// (0 on success). `bits` (n,) uint32, `w` (n,) float32, `seeds` (depth,)
// uint32, `value` and `out` (depth, width) float32, all contiguous. With a
// `workspace` of blocks * depth * width float32 the shared branch runs on
// `blocks` blocks of 32 * `warps` threads; with none, the global branch on
// `blocks` blocks of 256.
extern "C" int countmin_launch(const void* bits, const void* w, const void* seeds, int n, int depth, int width,
                               const void* value, void* out, void* workspace, int blocks, int warps, void* stream) {
  if (depth <= 0 || width <= 0) return 0;
  const auto* b = static_cast<const uint32_t*>(bits);
  const auto* wt = static_cast<const float*>(w);
  const auto* sd = static_cast<const uint32_t*>(seeds);
  const auto* v = static_cast<const float*>(value);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int cells = depth * width;
  if (n <= 0 || blocks <= 0) {
    return static_cast<int>(cudaMemcpyAsync(o, v, 4LL * cells, cudaMemcpyDeviceToDevice, s));
  }
  if (workspace) {
    auto* partial = static_cast<float*>(workspace);
    const size_t bytes = static_cast<size_t>(warps) * (16 * ((cells + 3) / 4) + 4 * 32);
    cudaError_t err = cudaFuncSetAttribute(countmin_partials, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    countmin_partials<<<blocks, 32 * warps, bytes, s>>>(b, wt, sd, n, depth, width, partial);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    countmin_sum_partials<<<(cells + 31) / 32, kThreads, 0, s>>>(partial, blocks, cells, v, o);
  } else {
    cudaError_t err = cudaMemcpyAsync(o, v, 4LL * cells, cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    countmin_global<<<blocks, kThreads, 0, s>>>(b, wt, sd, n, depth, width, o);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* countmin_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
