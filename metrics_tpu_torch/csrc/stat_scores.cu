// Per-class [target count, prediction count, true positives] for one batch.
//
// Replaces the TPU kernel `_stat_counts_kernel` (metrics_tpu/ops/stat_scores.py:39,
// launched by `_stat_counts_pallas`). It computes, for rows i < n,
//   out[0*C + target[i]] += w[i]
//   out[1*C + pred[i]]   += w[i]
//   out[2*C + target[i]] += correct[i]
// into an int32 (3, C) array.
//
// Bound on the H100: the kernel reads 13 bytes a row (int32 target, int32
// prediction, bool correct, int32 weight) and writes 12 bytes a class. At the
// ImageNet-1k validation batch (n = 1024, C = 1000) that is 25 KB, 7.6 ns at
// 3.35 TB/s; the launches themselves (a few microseconds each) are the real
// cost, so the design counts launches first.
//
// Why atomics and not the one-hot product: on the TPU a scatter serialises, so
// the JAX package builds (rows, C) one-hot tiles and reduces them on the
// matrix unit. Hopper has fast integer atomics in shared memory, so a block
// keeps a 3*C histogram there (12 KB at C = 1000) and adds its rows with
// shared-memory atomics. Integer addition is exact and order-independent, so
// the result is bit-identical to the plain version whatever the scheduling.
// The branch is chosen by the caller (metrics_tpu_torch/ops/stat_scores.py,
// `stat_scores_plan`) from n, C and the opt-in shared memory:
//
// * `stat_counts_block`, n up to the plan's limit (6,144 rows, where it
//   still beats the branch below on the card; B = 1024 on the main paths) and 3*C ints within shared memory: one block of 1,024
//   threads does the whole batch. It issues its first rows' loads, zeroes
//   its histogram meanwhile, adds the rows, and stores every one of the 3*C
//   cells with a plain store, so the caller's output needs no zeroing: one
//   launch where there were two, and no global atomics.
// * `stat_counts_shared`, longer batches: up to 264 blocks, each with its own
//   shared histogram, flush the non-zero cells into a zeroed output with
//   one global atomic each (the earlier design, also forced by the caller's
//   private switch in tests and timings).
// * `stat_counts_global`, 3*C ints beyond the 227 KB a block may have: the
//   rows go straight to global atomics in a zeroed output.
//
// The session axis (`stat_counts_sessions_*`, launched by
// `stat_scores_sessions_launch`) is what `jax.vmap` of the same function
// computes for the multi-tenant service (metrics_tpu/serve.py:1493 maps the
// template's update over the sessions of one flush): S independent batches
// of B rows, out (S, 3, C). Bound on the H100 at the service's ImageNet
// flush (S = 1024 sessions, B = 64 rows, C = 1000): 851,968 bytes read and
// 12,288,000 written, 3.92 us at 3.35 TB/s, set by the writes, so a block
// writes its session's 3*C cells with plain stores and no zeroed output:
//
// * `stat_counts_sessions_block`, 3*C ints within shared memory: one block
//   a session, its histogram in shared memory as in `stat_counts_block`.
// * `stat_counts_sessions_global`, beyond: the rows of all sessions go
//   straight to global atomics at their session's offset in a zeroed output.
//
// Out-of-range classes follow the JAX package's production scatter
// (`_stat_counts_lax`, JAX's `.at[idx].add` on the flat 3*C vector): the
// contribution of block k (0 target, 1 prediction, 2 true positives) goes to
// the flat index f = k*C + class; f in [-3C, 0) wraps to f + 3C, and f
// outside [-3C, 3C) is dropped. So a NaN score row, whose predicted class
// is C, adds its weight to tp[0], as it does in the JAX package.
#include <cuda_runtime.h>
#include <cstdint>

#include "device.cuh"

namespace {

constexpr size_t kDefaultSmem = 48 * 1024; // above this a kernel must opt in

// Adds `v` at flat index k*C + cls under the wrap-or-drop rule above
// (64-bit arithmetic, so no class value can overflow the index).
__device__ __forceinline__ void add_flat(int32_t* counts, int k, int32_t cls, int32_t v, int num_classes) {
  const int64_t cells = 3 * static_cast<int64_t>(num_classes);
  int64_t f = static_cast<int64_t>(k) * num_classes + cls;
  if (f < 0) f += cells;
  if (f >= 0 && f < cells) atomicAdd(&counts[f], v);
}

__device__ __forceinline__ void add_row(int32_t* counts, int32_t target, int32_t pred, bool correct,
                                        int32_t w, int num_classes) {
  if (w != 0) {
    add_flat(counts, 0, target, w, num_classes);
    add_flat(counts, 1, pred, w, num_classes);
  }
  if (correct) add_flat(counts, 2, target, 1, num_classes);
}

__global__ void stat_counts_block(const int32_t* __restrict__ target, const int32_t* __restrict__ pred,
                                  const bool* __restrict__ correct, const int32_t* __restrict__ w, int n,
                                  int num_classes, int32_t* __restrict__ out) {
  extern __shared__ int32_t hist[];
  const int cells = 3 * num_classes;
  int i = threadIdx.x;
  int32_t tc = 0, pc = 0, wt = 0;
  bool ok = false;
  if (i < n) {  // in flight while the histogram is zeroed
    tc = target[i];
    pc = pred[i];
    ok = correct[i];
    wt = w[i];
  }
  for (int k = threadIdx.x; k < cells; k += blockDim.x) hist[k] = 0;
  __syncthreads();
  while (i < n) {
    const int32_t t0 = tc, p0 = pc, w0 = wt;
    const bool ok0 = ok;
    i += blockDim.x;
    if (i < n) {  // the next row's loads go out before this row's adds
      tc = target[i];
      pc = pred[i];
      ok = correct[i];
      wt = w[i];
    }
    add_row(hist, t0, p0, ok0, w0, num_classes);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < cells; k += blockDim.x) out[k] = hist[k];  // every cell: no zeroed output
}

__global__ void stat_counts_shared(const int32_t* __restrict__ target, const int32_t* __restrict__ pred,
                                   const bool* __restrict__ correct, const int32_t* __restrict__ w, int n,
                                   int num_classes, int32_t* __restrict__ out) {
  extern __shared__ int32_t hist[];
  const int cells = 3 * num_classes;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    add_row(hist, target[i], pred[i], correct[i], w[i], num_classes);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int32_t v = hist[i];
    if (v != 0) atomicAdd(&out[i], v);
  }
}

__global__ void stat_counts_global(const int32_t* __restrict__ target, const int32_t* __restrict__ pred,
                                   const bool* __restrict__ correct, const int32_t* __restrict__ w, int n,
                                   int num_classes, int32_t* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    add_row(out, target[i], pred[i], correct[i], w[i], num_classes);
  }
}

// One block a session: session blockIdx.x's B rows into its 3*C cells.
__global__ void stat_counts_sessions_block(const int32_t* __restrict__ target, const int32_t* __restrict__ pred,
                                           const bool* __restrict__ correct, const int32_t* __restrict__ w, int n,
                                           int num_classes, int32_t* __restrict__ out) {
  extern __shared__ int32_t hist[];
  const int cells = 3 * num_classes;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * n;
  for (int k = threadIdx.x; k < cells; k += blockDim.x) hist[k] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    add_row(hist, target[row0 + i], pred[row0 + i], correct[row0 + i], w[row0 + i], num_classes);
  }
  __syncthreads();
  int32_t* dst = out + static_cast<size_t>(blockIdx.x) * cells;
  for (int k = threadIdx.x; k < cells; k += blockDim.x) dst[k] = hist[k];  // every cell: no zeroed output
}

// Every row of every session into its session's cells of a zeroed output.
__global__ void stat_counts_sessions_global(const int32_t* __restrict__ target, const int32_t* __restrict__ pred,
                                            const bool* __restrict__ correct, const int32_t* __restrict__ w,
                                            int sessions, int n, int num_classes, int32_t* __restrict__ out) {
  const size_t rows = static_cast<size_t>(sessions) * n;
  const size_t cells = 3 * static_cast<size_t>(num_classes);
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < rows;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    add_row(out + (i / n) * cells, target[i], pred[i], correct[i], w[i], num_classes);
  }
}

}  // namespace

extern "C" int stat_scores_device(int* sms, int* shared_optin) { return device_limits(sms, shared_optin); }

// Launches `branch` (0 block: writes every cell of `out`; 1 shared and
// 2 global: add into a zeroed `out`) on `blocks` blocks of `threads` on
// `stream` and returns a CUDA error code (0 on success).
extern "C" int stat_scores_launch(const void* target, const void* pred, const void* correct, const void* w,
                                  int n, int num_classes, int branch, int blocks, int threads, void* out,
                                  void* stream) {
  if (n <= 0) return 0;
  const auto* t = static_cast<const int32_t*>(target);
  const auto* p = static_cast<const int32_t*>(pred);
  const auto* c = static_cast<const bool*>(correct);
  const auto* wt = static_cast<const int32_t*>(w);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const size_t smem = 3 * static_cast<size_t>(num_classes) * sizeof(int32_t);
  if (branch == 0 || branch == 1) {
    const auto kernel = branch == 0 ? stat_counts_block : stat_counts_shared;
    if (smem > kDefaultSmem) {
      const cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<blocks, threads, smem, s>>>(t, p, c, wt, n, num_classes, o);
  } else if (branch == 2) {
    stat_counts_global<<<blocks, threads, 0, s>>>(t, p, c, wt, n, num_classes, o);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* stat_scores_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the session axis on `stream`: `branch` 0 (one block a session:
// `blocks` must be `sessions`, writes every cell of `out`) or 1 (global
// atomics into a zeroed `out`), for `sessions` x `n` rows of `num_classes`
// classes, out (sessions, 3, num_classes). Returns a CUDA error code.
extern "C" int stat_scores_sessions_launch(const void* target, const void* pred, const void* correct, const void* w,
                                           int sessions, int n, int num_classes, int branch, int blocks,
                                           int threads, void* out, void* stream) {
  if (sessions <= 0) return 0;
  const auto* t = static_cast<const int32_t*>(target);
  const auto* p = static_cast<const int32_t*>(pred);
  const auto* c = static_cast<const bool*>(correct);
  const auto* wt = static_cast<const int32_t*>(w);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (branch == 0) {
    const size_t smem = 3 * static_cast<size_t>(num_classes) * sizeof(int32_t);
    if (smem > kDefaultSmem) {
      const cudaError_t err = cudaFuncSetAttribute(stat_counts_sessions_block,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    stat_counts_sessions_block<<<blocks, threads, smem, s>>>(t, p, c, wt, n, num_classes, o);
  } else if (branch == 1) {
    if (n <= 0) return 0;
    stat_counts_sessions_global<<<blocks, threads, 0, s>>>(t, p, c, wt, sessions, n, num_classes, o);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
