// Relevance labels reordered by descending score, for the retrieval metrics.
//
// Replaces the TPU kernel `_rank_sort_kernel` (metrics_tpu/ops/retrieval.py:43,
// launched by `_sorted_by_preds_pallas`). For float32 scores p (Q, L) and
// labels t (Q, L) of 4 or 8 bytes a cell it writes, row by row,
//   out[q, rank_q(i)] = t[q, i],   rank_q = the inverse of argsort(-p[q], stable=True)
// which is the JAX package's production formulation
// `target[jnp.argsort(-preds, stable=True)]`. The rank of element i is
//   non-NaN p_i: #{j : p_j > p_i} + #{j < i : p_j == p_i}
//   NaN p_i:     #{j : p_j not NaN} + #{j < i : p_j NaN}
// so +0.0 and -0.0 tie and keep their index order, and NaNs go last in
// index order. Both rules become one: each score maps to a 32-bit key that
// grows as the score falls (NaN the largest key, -0.0 the key of +0.0), and
//   rank(i) = #{j : key_j < key_i} + #{j < i : key_j == key_i}.
// The ranks are a permutation of 0..L-1, so the writes never collide, and
// the reorder is a plain copy of the label's bits: exact for every dtype and
// value, which the TPU kernel's float32 one-hot contraction is not.
//
// Bound on the H100 at MS MARCO's shape, Q = 6980 queries of L = 1024: a
// sort needs Q*L*log2 L = 7.1e7 compares and is bound by bytes, 7.1e6 cells
// of 4 + 4 in and 4 out, about 86 MB, 26 us at 3.35 TB/s. This kernel does
// Q*L^2 = 7.3e9 pair tests instead (a compare and an add each), so it sits
// far above that bound; a merge or radix design is a later change.
//
// Design. A block of 256 threads takes one row and a tile of 256 elements
// i, one a thread, with its key in a register. The row's keys pass through
// shared memory in tiles of 256; every thread tests its key against each of
// them, reading four keys with one 16-byte broadcast load. A tile wholly
// before the block's own counts ties (all its j < i), a tile wholly after
// does not, and only the diagonal tile tests indices. Any L works: the last
// tile is padded with the largest key, which never precedes a real element.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // elements i of a block, and keys j of a shared tile
constexpr uint32_t kLast = 0xffffffffu;  // NaN's key, and the padding's

// Ascending in this key is descending in the score, NaN last.
__device__ __forceinline__ uint32_t descending_key(float x) {
  if (x != x) return kLast;
  uint32_t b = __float_as_uint(x);
  if (x == 0.0f) b = 0u;  // -0.0 ties +0.0
  return (b & 0x80000000u) ? b : (~b & 0x7fffffffu);
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

template <typename Word>
cudaError_t launch(const float* preds, const void* target, int q, int l, void* out, cudaStream_t stream) {
  const dim3 grid(q, (l + kThreads - 1) / kThreads);
  rank_scatter<Word><<<grid, kThreads, 0, stream>>>(preds, static_cast<const Word*>(target), l,
                                                    static_cast<Word*>(out));
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `preds` is (q, l) float32, `target` and `out` (q, l) cells of
// `word_bytes` = 4 or 8 bytes, all contiguous; q < 2^31, l < 2^24.
extern "C" int retrieval_sort_launch(const void* preds, const void* target, int q, int l, int word_bytes, void* out,
                                     void* stream) {
  if (q <= 0 || l <= 0) return 0;
  const auto* p = static_cast<const float*>(preds);
  auto s = static_cast<cudaStream_t>(stream);
  if (word_bytes == 4) return static_cast<int>(launch<uint32_t>(p, target, q, l, out, s));
  if (word_bytes == 8) return static_cast<int>(launch<unsigned long long>(p, target, q, l, out, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* retrieval_sort_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
