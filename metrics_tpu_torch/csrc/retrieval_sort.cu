// Relevance labels reordered by descending score, for the retrieval metrics.
//
// Replaces the TPU kernel `_rank_sort_kernel` (metrics_tpu/ops/retrieval.py:43,
// launched by `_sorted_by_preds_pallas`). For float32 scores p (Q, L) and
// labels t (Q, L) of 4 or 8 bytes a cell it writes, row by row,
//   out[q, :] = t[q, argsort(-p[q], stable=True)]
// which is the JAX package's production formulation
// `target[jnp.argsort(-preds, stable=True)]`. Each score maps to a 32-bit key
// that grows as the score falls (NaN the largest key, -0.0 the key of +0.0),
// and element i of a row to the 64-bit composite (key << 32) | i. The
// composites of a row are distinct, so sorting them ascending is stable by
// construction: +0.0 and -0.0 tie and keep their index order, NaNs go last in
// index order, and any correct sort gives the one answer. The reorder is a
// plain copy of the label's bits: exact for every dtype and value, which the
// TPU kernel's float32 one-hot contraction is not.
//
// Bound on the H100 at MS MARCO's shape, Q = 6980 queries of L = 1024: the
// bytes are 7.1e6 cells of 4 + 4 in and 4 out, about 86 MB, 26 us at
// 3.35 TB/s; a comparison sort needs Q*L*log2 L = 7.1e7 compares, far below
// the card's integer rate. What this design spends is Q*(P/2)*55 = 2.0e8
// compare-exchanges of 64-bit words (P = 1024: log2 P * (log2 P + 1) / 2 = 55
// stages), each a few integer operations, plus the synchronisation of 55
// dependent stages.
//
// Branches, chosen by the caller from L alone (metrics_tpu_torch/ops/retrieval.py):
//
// * `bitonic_rows`, L <= 16,384: one block a row. The row's composites are
//   padded with UINT64_MAX (which never precedes a real element) to
//   P = max(256, next power of two of L) and bitonic-sorted with K = 8
//   composites a thread in registers (K = 16 at P = 16,384, so that a block
//   has at most 1,024 threads). A stage of stride j < K exchanges within a
//   thread's registers, K <= j < 32K across the lanes of a warp with
//   __shfl_xor_sync, and only j >= 32K goes through shared memory between
//   __syncthreads(): at P = 1024, 3 of the 55 stages. Shared memory holds P
//   composites with one pad word every K, so that a warp reading each lane's
//   run of K hits distinct banks: 9 KB at P = 1024 (several blocks an SM),
//   136 KB at P = 16,384 (the opt-in limit is 227 KB; P = 32,768 would not
//   fit). Then out[row + r] = t[row + (composite_r & 0xffffffff)], a gather
//   within the row, coalesced on the write.
// * `rank_scatter`, any L (the branch for L > 16,384, and forced by the
//   caller's private switch in tests): the all-pairs stable rank
//     rank(i) = #{j : key_j < key_i} + #{j < i : key_j == key_i}
//   from 256-key tiles of the row staged through shared memory, then a
//   collision-free scatter out[row + rank(i)] = t[row + i]. Q*L^2 pair tests.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // rank_scatter: elements i of a block, and keys j of a shared tile
constexpr uint32_t kLast = 0xffffffffu;  // NaN's key, and rank_scatter's padding
constexpr unsigned long long kPad = ~0ull;  // bitonic_rows' padding, above every composite
constexpr int kMinPow2 = 256;  // one full warp of 8 composites a lane
constexpr int kMaxSorted = 16384;

// Ascending in this key is descending in the score, NaN last.
__device__ __forceinline__ uint32_t descending_key(float x) {
  if (x != x) return kLast;
  uint32_t b = __float_as_uint(x);
  if (x == 0.0f) b = 0u;  // -0.0 ties +0.0
  return (b & 0x80000000u) ? b : (~b & 0x7fffffffu);
}

__host__ __device__ constexpr int log2_of(int x) { return x <= 1 ? 0 : 1 + log2_of(x / 2); }

// Composites a thread holds: K = 8, and 16 where 8 would need more than 1,024 threads.
__host__ __device__ constexpr int per_thread(int pow2) { return pow2 > 8192 ? 16 : 8; }

// The shared-memory slot of composite i: one pad word after every K.
template <int K>
__device__ __forceinline__ int slot(int i) {
  return i + (i >> log2_of(K));
}

// Puts a and b in order: ascending when `up`, else descending.
__device__ __forceinline__ void exchange(unsigned long long& a, unsigned long long& b, bool up) {
  const bool swap = (a > b) == up;
  const unsigned long long x = swap ? b : a, y = swap ? a : b;
  a = x;
  b = y;
}

template <int P, typename Word>
__global__ void __launch_bounds__(P / per_thread(P)) bitonic_rows(const float* __restrict__ preds,
                                                                  const Word* __restrict__ target, int l,
                                                                  Word* __restrict__ out) {
  constexpr int K = per_thread(P);
  constexpr int T = P / K;
  extern __shared__ unsigned long long s_sort[];  // P + P / K words
  const size_t row = static_cast<size_t>(blockIdx.x) * l;
  const int t = threadIdx.x;
  const int base = t * K;  // this thread holds composites base .. base + K - 1

  for (int i = t; i < P; i += T) {
    s_sort[slot<K>(i)] =
        i < l ? (static_cast<unsigned long long>(descending_key(preds[row + i])) << 32) | static_cast<uint32_t>(i)
              : kPad;
  }
  __syncthreads();
  unsigned long long v[K];
#pragma unroll
  for (int r = 0; r < K; ++r) v[r] = s_sort[slot<K>(base + r)];

#pragma unroll 1
  for (int size = 2; size <= P; size <<= 1) {
    int j = size >> 1;
    if (j >= 32 * K) {
      // strides across warps: through shared memory, K / 2 pairs a thread
#pragma unroll
      for (int r = 0; r < K; ++r) s_sort[slot<K>(base + r)] = v[r];
      __syncthreads();
#pragma unroll 1
      for (; j >= 32 * K; j >>= 1) {
#pragma unroll
        for (int m = 0; m < K / 2; ++m) {
          const int p = t + m * T;
          const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
          unsigned long long a = s_sort[slot<K>(i)], b = s_sort[slot<K>(i + j)];
          if ((a > b) == ((i & size) == 0)) {
            s_sort[slot<K>(i)] = b;
            s_sort[slot<K>(i + j)] = a;
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < K; ++r) v[r] = s_sort[slot<K>(base + r)];
    }
    // strides across the lanes of a warp; size > j >= K, so both bits lie in base
    const bool up = (base & size) == 0;
#pragma unroll 1
    for (; j >= K; j >>= 1) {
      const bool keep_min = ((base & j) == 0) == up;
#pragma unroll
      for (int r = 0; r < K; ++r) {
        const unsigned long long o = __shfl_xor_sync(0xffffffffu, v[r], j / K);
        v[r] = ((o < v[r]) == keep_min) ? o : v[r];
      }
    }
    // strides within a thread's registers
#pragma unroll
    for (int jj = K / 2; jj > 0; jj >>= 1) {
      if (jj < size) {
#pragma unroll
        for (int r = 0; r < K; ++r) {
          if (r & jj) continue;
          exchange(v[r], v[r | jj], ((base | r) & size) == 0);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < K; ++r) s_sort[slot<K>(base + r)] = v[r];
  __syncthreads();
  for (int i = t; i < l; i += T) out[row + i] = target[row + static_cast<uint32_t>(s_sort[slot<K>(i)])];
}

template <typename Word>
__global__ void __launch_bounds__(kThreads) rank_scatter(const float* __restrict__ preds,
                                                         const Word* __restrict__ target, int l,
                                                         Word* __restrict__ out) {
  __shared__ __align__(16) uint32_t s_key[kThreads];
  const size_t row = static_cast<size_t>(blockIdx.x) * l;
  const int tile = blockIdx.y;
  const int i = tile * kThreads + threadIdx.x;
  const uint32_t ki = i < l ? descending_key(preds[row + i]) : kLast;
  const int tiles = (l + kThreads - 1) / kThreads;
  const uint4* s4 = reinterpret_cast<const uint4*>(s_key);
  int rank = 0;
  for (int jt = 0; jt < tiles; ++jt) {
    const int j = jt * kThreads + threadIdx.x;
    s_key[threadIdx.x] = j < l ? descending_key(preds[row + j]) : kLast;
    __syncthreads();
    if (jt < tile) {  // every j < i: a tie precedes
#pragma unroll 8
      for (int k = 0; k < kThreads / 4; ++k) {
        const uint4 v = s4[k];
        rank += (v.x <= ki) + (v.y <= ki) + (v.z <= ki) + (v.w <= ki);
      }
    } else if (jt > tile) {  // every j > i: a tie follows
#pragma unroll 8
      for (int k = 0; k < kThreads / 4; ++k) {
        const uint4 v = s4[k];
        rank += (v.x < ki) + (v.y < ki) + (v.z < ki) + (v.w < ki);
      }
    } else {
      for (int k = 0; k < kThreads; ++k) {
        const uint32_t kj = s_key[k];
        rank += (kj < ki) | ((kj == ki) & (k < static_cast<int>(threadIdx.x)));
      }
    }
    __syncthreads();  // the tile is overwritten next
  }
  if (i < l) out[row + rank] = target[row + i];
}

template <int P, typename Word>
cudaError_t launch_sorted(const float* preds, const void* target, int q, int l, void* out, cudaStream_t stream) {
  constexpr int K = per_thread(P);
  constexpr int bytes = (P + P / K) * 8;
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(bitonic_rows<P, Word>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  bitonic_rows<P, Word><<<q, P / K, bytes, stream>>>(preds, static_cast<const Word*>(target), l,
                                                      static_cast<Word*>(out));
  return cudaGetLastError();
}

template <typename Word>
cudaError_t launch(const float* preds, const void* target, int q, int l, int all_pairs, void* out,
                   cudaStream_t stream) {
  if (all_pairs) {
    const dim3 grid(q, (l + kThreads - 1) / kThreads);
    rank_scatter<Word><<<grid, kThreads, 0, stream>>>(preds, static_cast<const Word*>(target), l,
                                                      static_cast<Word*>(out));
    return cudaGetLastError();
  }
  if (l <= kMinPow2) return launch_sorted<256, Word>(preds, target, q, l, out, stream);
  if (l <= 512) return launch_sorted<512, Word>(preds, target, q, l, out, stream);
  if (l <= 1024) return launch_sorted<1024, Word>(preds, target, q, l, out, stream);
  if (l <= 2048) return launch_sorted<2048, Word>(preds, target, q, l, out, stream);
  if (l <= 4096) return launch_sorted<4096, Word>(preds, target, q, l, out, stream);
  if (l <= 8192) return launch_sorted<8192, Word>(preds, target, q, l, out, stream);
  if (l <= kMaxSorted) return launch_sorted<kMaxSorted, Word>(preds, target, q, l, out, stream);
  return cudaErrorInvalidValue;  // longer rows take the all-pairs branch
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `preds` is (q, l) float32, `target` and `out` (q, l) cells of
// `word_bytes` = 4 or 8 bytes, all contiguous; q < 2^31, l < 2^24.
// `all_pairs` = 0 takes the bitonic sort (l <= 16,384), 1 the all-pairs rank.
extern "C" int retrieval_sort_launch(const void* preds, const void* target, int q, int l, int word_bytes,
                                     int all_pairs, void* out, void* stream) {
  if (q <= 0 || l <= 0) return 0;
  const auto* p = static_cast<const float*>(preds);
  auto s = static_cast<cudaStream_t>(stream);
  if (word_bytes == 4) return static_cast<int>(launch<uint32_t>(p, target, q, l, all_pairs, out, s));
  if (word_bytes == 8) return static_cast<int>(launch<unsigned long long>(p, target, q, l, all_pairs, out, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* retrieval_sort_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
