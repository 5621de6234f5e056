// Binned threshold-sweep counts for the binned precision-recall metrics.
//
// Replaces the TPU kernel `_binned_kernel` (metrics_tpu/ops/binned_stats.py:43,
// launched by `_binned_stat_scores_pallas`). For float32 scores preds (N, C),
// bool targets tgt (N, C) and float32 thresholds thr (T,) it writes the
// float32 (3, C, T) result tp, fp = p - tp, fn = pos - tp of
//   tp[c, t] = sum_n tgt[n, c] * (preds[n, c] >= thr[t])
//   p[c, t]  = sum_n (preds[n, c] >= thr[t])
//   pos[c]   = sum_n tgt[n, c]
// The compare is IEEE float32 `>=`, as in XLA: a NaN score hits no
// threshold, a NaN threshold is hit by nothing, +inf hits every threshold
// but NaN, -inf only -inf, and -0.0 equals +0.0. The thresholds may be in
// any order and may repeat. Every count is an exact integer.
//
// Bound on the H100 at ImageNet's B = 1024, C = 1000, T = 100: the bytes are
// 1024*1000*(4+1) in and 3*1000*100*4 out, about 6.3 MB, 1.9 us at
// 3.35 TB/s. The TPU kernel's broadcast compare does N*C*T = 1.02e8
// compare-and-adds, which made the earlier design (the `compare` branch
// below) bound by instruction issue at 19.5x that bound. Binning each score
// needs only ceil(log2(T+1)) = 7 compares, 7.2e6 in all. What bounds the
// histogram branch instead is the chain of steps within a block, one block
// an SM: the launch; the first rows' loads arriving while the block ranks
// the thresholds (a row of a tile is a full 32-byte sector of scores but
// only 8 bytes of a sector of targets, so the targets cost as many sectors
// as the scores); 7 shared loads and one shared atomic a score; then the
// suffix sums and the stores.
//
// The branch is chosen by the caller (metrics_tpu_torch/ops/binned_stats.py,
// `binned_plan`) from N, C, T, the SM count and the opt-in shared memory:
//
// * `binned_hist`, T <= 1,024 and the histogram fits shared memory: one
//   launch, no memset, no global atomics. A block of 1,024 threads owns 8
//   consecutive classes, so that one row of its tile is one 32-byte sector
//   of preds. It loads the thresholds, then issues its first rows' loads,
//   and ranks the thresholds meanwhile by their 64-bit composites
//   (ascending_key << 32) | index (NaN last, -0.0 as +0.0; all distinct, so
//   the ranks are a permutation): one thread a threshold counts the
//   composites below its own, two barriers in all (spreading the count over
//   ten threads a threshold was no faster on the card). The sorted
//   thresholds go into an implicit search tree (breadth-first order, NaN
//   padding), and each score takes its bin k = #{sorted thresholds <= x} in
//   log2 of the tree's leaves steps; every compare is false for a NaN score,
//   so it gets k = 0, and equal thresholds share one boundary. A lane adds
//   1 + (y << 16) (the prediction count in the low half, the true positives
//   in the high half) into a shared-memory histogram of 8 classes x (T + 1)
//   bins. Four copies, one for each group of 8 lanes of a warp, keep the four
//   rows a warp reads apart, and an odd bin stride puts the 32 lanes of a
//   warp on 32 banks when they hit the same bin. All 32 warps then
//   suffix-sum the bins, each a chunk of 32 with shuffles, adding the four
//   copies as they load them; sorted position j counts the rows with k > j,
//   its chunk's sum plus the totals of the chunks above, and goes straight
//   to the threshold's original column as tp, fp and fn.
//   A block of 1,024 threads has an SM to itself. Where the tiles leave SMs
//   idle and a block would walk more than one pass of 1,024 rows, a
//   thread-block cluster of up to 8 blocks on neighbouring SMs splits the
//   tile's rows, and the leader adds the others' histograms through
//   distributed shared memory in rank order; at 1,024 rows a cluster's
//   barriers cost more than they spread (chip_smoke.py times COCO's
//   (1024, 80, 100) both ways). Packed 16-bit halves hold
//   at most 65,535 rows a launch; past that, the `wide` form keeps two
//   32-bit planes.
// * `binned_counts` + `binned_finish`, any T (the branch above 1,024
//   thresholds or past shared memory, and forced by the caller's private
//   switch in tests and timings): the earlier design. 32-class tiles, the
//   warps split the thresholds with packed counters in registers, row
//   chunks meet through int32 atomics in a zeroed scratch, and a second
//   kernel writes the float32 result.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "device.cuh"

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// ------------------------------------------------------------ histogram branch
constexpr int kHistThreads = 1024;
constexpr int kWarps = kHistThreads / 32;
constexpr int kClassTile = 8;                         // classes a block: one 32-byte sector of a row
constexpr int kRowSlots = kHistThreads / kClassTile;  // rows a block reads at once
constexpr int kCopies = 4;                            // histogram copies: the four row groups of a warp
constexpr int kUnroll = 8;                            // rows whose loads a thread issues together
constexpr int kMaxLevels = 11;                        // a tree of 2,047 nodes holds T <= 1,024
constexpr int kChunk = 32;                            // bins a warp suffix-sums with shuffles

// Ascending in this key is ascending in the score: NaN last, -0.0 as +0.0.
__device__ __forceinline__ uint32_t ascending_key(float x) {
  if (x != x) return 0xffffffffu;
  uint32_t b = __float_as_uint(x);
  if (x == 0.0f) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The histogram branch's shared memory; `hist_shared_bytes` in
// ops/binned_stats.py sizes it the same way.
struct HistLayout {
  int pow2;    // the search tree's leaves: the least power of two above T
  int levels;  // log2(pow2): the compares a score takes
  int stride;  // bins a class: T + 1, rounded up to an odd count
  int chunks;  // chunks of 32 bins a class
  size_t bytes;
};

__host__ __device__ inline HistLayout hist_layout(int t, bool wide) {
  HistLayout h{1, 0, (t + 1) | 1, (t + kChunk) / kChunk, 0};
  while (h.pow2 <= t) {
    h.pow2 <<= 1;
    ++h.levels;
  }
  const size_t planes = wide ? 2 : 1;
  // t composites, t sorted indices, pow2 - 1 tree nodes, the histogram planes, the chunks' totals
  h.bytes = 12 * static_cast<size_t>(t) + 4 * static_cast<size_t>(h.pow2 - 1) +
            4 * planes * kCopies * kClassTile * h.stride + 4 * planes * kClassTile * h.chunks;
  return h;
}

// The breadth-first slot of in-order position m in a complete tree of `levels` levels.
__device__ __forceinline__ int tree_node(int m, int levels) {
  const int v = m + 1;
  const int tz = __ffs(v) - 1;
  return ((1 << (levels - 1 - tz)) - 1) + (v >> (tz + 1));
}

__device__ __forceinline__ void load_rows(const float* __restrict__ preds, const bool* __restrict__ tgt, int c,
                                          int col, bool valid, int first, int row1, float (&x)[kUnroll],
                                          uint32_t (&y)[kUnroll]) {
#pragma unroll
  for (int r = 0; r < kUnroll; ++r) {
    const int row = first + r * kRowSlots;
    const bool ok = valid && row < row1;
    const size_t at = static_cast<size_t>(row) * c + col;
    x[r] = ok ? preds[at] : nan_f();  // NaN reaches no threshold, and y = 0: the row adds nothing
    y[r] = ok ? static_cast<uint32_t>(tgt[at]) : 0u;
  }
}

// The inclusive suffix sum of v over the lanes of a warp: lane l gets the sum over lanes >= l.
__device__ __forceinline__ uint32_t warp_suffix(uint32_t v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t u = __shfl_down_sync(0xffffffffu, v, off);
    if (lane + off < 32) v += u;
  }
  return v;
}

template <bool kWide>
__global__ void __launch_bounds__(kHistThreads) binned_hist(const float* __restrict__ preds,
                                                            const bool* __restrict__ tgt,
                                                            const float* __restrict__ thr, int n, int c, int t,
                                                            int rows_per_block, float* __restrict__ out) {
  constexpr int kPlanes = kWide ? 2 : 1;  // packed: one plane; wide: p, then tp
  const HistLayout h = hist_layout(t, kWide);
  extern __shared__ unsigned long long s_comp[];                        // t composites
  int* s_order = reinterpret_cast<int*>(s_comp + t);                    // original index at sorted position j
  float* s_tree = reinterpret_cast<float*>(s_order + t);                // pow2 - 1 nodes, breadth-first
  uint32_t* s_hist = reinterpret_cast<uint32_t*>(s_tree + h.pow2 - 1);  // [plane][copy][class][bin]
  const int copy_words = kClassTile * h.stride;
  const int plane_words = kCopies * copy_words;
  uint32_t* s_total = s_hist + kPlanes * plane_words;  // [plane][class][chunk]: each chunk's sum

  const int tid = threadIdx.x;
  const int cl = tid % kClassTile;
  const int slot = tid / kClassTile;
  uint32_t* mine = s_hist + (slot % kCopies) * copy_words + cl * h.stride;
  const int c0 = blockIdx.x * kClassTile;
  const bool valid = c0 + cl < c;
  const int row1 = min(n, static_cast<int>(blockIdx.y + 1) * rows_per_block);
  int row = blockIdx.y * rows_per_block + slot;

  // the thresholds' loads first, so that the ranking waits for them alone; then the first rows',
  // whose latency the ranking overlaps
  const float my_thr = tid < t ? thr[tid] : 0.0f;  // t <= kHistThreads: one threshold a thread
  float x[kUnroll];
  uint32_t y[kUnroll];
  load_rows(preds, tgt, c, c0 + cl, valid, row, row1, x, y);

  if (tid < t) s_comp[tid] = (static_cast<unsigned long long>(ascending_key(my_thr)) << 32) | static_cast<uint32_t>(tid);
  for (int i = tid; i < kPlanes * plane_words; i += kHistThreads) s_hist[i] = 0u;
  __syncthreads();
  if (tid < t) {
    const unsigned long long me = s_comp[tid];
    int rank = 0;
#pragma unroll 8
    for (int j = 0; j < t; ++j) rank += s_comp[j] < me;
    s_order[rank] = tid;
    s_tree[tree_node(rank, h.levels)] = my_thr;
  }
  for (int m = t + tid; m < h.pow2 - 1; m += kHistThreads) s_tree[tree_node(m, h.levels)] = nan_f();
  __syncthreads();

  for (;;) {
    int node[kUnroll];
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) node[r] = 0;
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      if (l < h.levels) {
#pragma unroll
        for (int r = 0; r < kUnroll; ++r) node[r] = 2 * node[r] + 1 + (s_tree[node[r]] <= x[r]);
      }
    }
    uint32_t yr[kUnroll];
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) yr[r] = y[r];
    row += kUnroll * kRowSlots;
    if (row < row1) load_rows(preds, tgt, c, c0 + cl, valid, row, row1, x, y);  // out before this round's adds
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
      const int k = node[r] - (h.pow2 - 1);  // the sorted thresholds x reaches; 0 for NaN
      if (kWide) {
        if (k) atomicAdd(mine + k, 1u);
        if (yr[r]) atomicAdd(mine + plane_words + k, 1u);
      } else {
        // bin 0's prediction count is never read: a row there reaches no threshold
        const uint32_t add = static_cast<uint32_t>(k != 0) + (yr[r] << 16);
        if (add) atomicAdd(mine + k, add);
      }
    }
    if (row >= row1) break;
  }
  __syncthreads();

  int copies = kCopies;
  if (gridDim.y > 1) {  // a cluster of gridDim.y blocks shares the tile's rows
    for (int i = tid; i < kPlanes * copy_words; i += kHistThreads) {
      uint32_t* at = s_hist + (i / copy_words) * plane_words + i % copy_words;
      at[0] = at[0] + at[copy_words] + at[2 * copy_words] + at[3 * copy_words];
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (cluster.block_rank() == 0) {  // the others' copy 0, added in rank order
      for (int i = tid; i < kPlanes * copy_words; i += kHistThreads) {
        uint32_t* at = s_hist + (i / copy_words) * plane_words + i % copy_words;
        uint32_t sum = *at;
        for (unsigned r = 1; r < cluster.num_blocks(); ++r) sum += *cluster.map_shared_rank(at, r);
        *at = sum;
      }
    }
    cluster.sync();  // the leader has read every histogram: the others may exit
    if (cluster.block_rank() != 0) return;
    __syncthreads();
    copies = 1;
  }

  // Suffix sums: warp w takes class w % 8 and its chunks of 32 bins w / 8, w / 8 + 4, ...; each chunk's
  // sum from its first bin up replaces copy 0's bins, and its total goes to s_total.
  const int warp = tid / 32, lane = tid % 32;
  const int wcl = warp % kClassTile;
  const bool wvalid = c0 + wcl < c;
  for (int q = warp / kClassTile; wvalid && q < h.chunks; q += kWarps / kClassTile) {
    const int b = q * kChunk + lane;
#pragma unroll
    for (int pl = 0; pl < kPlanes; ++pl) {
      uint32_t* bins = s_hist + pl * plane_words + wcl * h.stride;
      uint32_t v = 0u;
      if (b <= t) {
        for (int k = 0; k < copies; ++k) v += bins[k * copy_words + b];
      }
      v = warp_suffix(v, lane);
      if (b <= t) bins[b] = v;
      if (lane == 0) s_total[(pl * kClassTile + wcl) * h.chunks + q] = v;
    }
  }
  __syncthreads();
  // Sorted position j holds the rows with k > j: bin j + 1's suffix sum plus the chunks above its own.
  const size_t cells = static_cast<size_t>(c) * t;
  float* o = out + static_cast<size_t>(c0 + wcl) * t;
  for (int q = warp / kClassTile; wvalid && q < h.chunks; q += kWarps / kClassTile) {
    uint32_t above[kPlanes], all_tp = 0u;
#pragma unroll
    for (int pl = 0; pl < kPlanes; ++pl) {
      above[pl] = 0u;
      const uint32_t* tot = s_total + (pl * kClassTile + wcl) * h.chunks;
      for (int qq = 0; qq < h.chunks; ++qq) {
        if (qq > q) above[pl] += tot[qq];
        if (pl == kPlanes - 1) all_tp += tot[qq];
      }
    }
    const uint32_t pos = kWide ? all_tp : all_tp >> 16;  // the positives: every row's tp, bin 0 included
    const int b = q * kChunk + lane;
    if (b >= 1 && b <= t) {
      const uint32_t s = s_hist[wcl * h.stride + b] + above[0];
      const uint32_t p = kWide ? s : (s & 0xffffu);
      const uint32_t tp = kWide ? s_hist[plane_words + wcl * h.stride + b] + above[kPlanes - 1] : (s >> 16);
      const int col = s_order[b - 1];
      o[col] = static_cast<float>(tp);
      o[cells + col] = static_cast<float>(p - tp);
      o[2 * cells + col] = static_cast<float>(pos - tp);
    }
  }
}

template <bool kWide>
cudaError_t launch_hist(const float* preds, const bool* tgt, const float* thr, int n, int c, int t, int cluster,
                        float* out, cudaStream_t stream) {
  const HistLayout h = hist_layout(t, kWide);
  if (h.bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(binned_hist<kWide>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(h.bytes));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((c + kClassTile - 1) / kClassTile, cluster, 1);
  const int rows = (n + cluster - 1) / cluster;
  if (cluster == 1) {
    binned_hist<kWide><<<grid, kHistThreads, h.bytes, stream>>>(preds, tgt, thr, n, c, t, rows, out);
    return cudaGetLastError();
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kHistThreads, 1, 1);
  cfg.dynamicSmemBytes = h.bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, binned_hist<kWide>, preds, tgt, thr, n, c, t, rows, out);
}

// ------------------------------------------------------------- compare branch
constexpr int kThreads = 256;
constexpr int kPassWarps = kThreads / 32;
constexpr int kTile = 32;          // classes per block: one per lane
constexpr int kTargetBlocks = 528; // four blocks on each of the 132 SMs
constexpr int kMinRows = 16;       // fewest rows a chunk is cut to
constexpr int kMaxRows = 65535;    // most rows of a chunk: the packed 16-bit counters

constexpr int kRows = 8;           // rows whose loads a thread issues together

__device__ __forceinline__ void load(const float* __restrict__ preds, const bool* __restrict__ tgt, int row, int c,
                                     int cls, bool valid, float& x, int32_t& y) {
  const size_t at = static_cast<size_t>(row) * c + cls;
  x = valid ? preds[at] : nan_f();  // a lane past C: NaN, which hits nothing
  y = valid ? static_cast<int32_t>(tgt[at]) : 0;
}

// One row: a hit adds 1 to the low half (p) and y to the high half (tp) of
// the packed counter, one predicated add per compare.
template <int kPer>
__device__ __forceinline__ void count(float x, int32_t y, const float (&th)[kPer], uint32_t (&acc)[kPer],
                                      int32_t& pos) {
  pos += y;
  const uint32_t w = 1u + (static_cast<uint32_t>(y) << 16);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (x >= th[j]) acc[j] += w;
  }
}

template <int kPer>
__global__ void __launch_bounds__(kThreads) binned_counts(const float* __restrict__ preds,
                                                          const bool* __restrict__ tgt,
                                                          const float* __restrict__ thr, int n, int c, int t,
                                                          int rows_per_chunk, int32_t* __restrict__ tp_out,
                                                          int32_t* __restrict__ p_out,
                                                          int32_t* __restrict__ pos_out) {
  constexpr int kPass = kPassWarps * kPer;  // thresholds per pass
  __shared__ float s_thr[kPass];
  __shared__ int32_t s_tp[kPass][kTile + 1];  // +1: conflict-free transposed reads
  __shared__ int32_t s_p[kPass][kTile + 1];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cls = blockIdx.x * kTile + lane;
  const bool valid = cls < c;
  const int row0 = blockIdx.y * rows_per_chunk;
  const int row1 = min(n, row0 + rows_per_chunk);

  for (int base = 0; base < t; base += kPass) {
    for (int i = threadIdx.x; i < kPass; i += kThreads) {
      s_thr[i] = base + i < t ? thr[base + i] : nan_f();  // past the end: NaN, which no score reaches
    }
    __syncthreads();
    float th[kPer];
    uint32_t acc[kPer];  // tp << 16 | p: a chunk has fewer than 2^16 rows
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      th[j] = s_thr[warp * kPer + j];
      acc[j] = 0;
    }
    int32_t pos = 0;
    int row = row0;
    // kRows rows at a time: their loads are all in flight before the compares
    for (; row + kRows <= row1; row += kRows) {
      float x[kRows];
      int32_t y[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) load(preds, tgt, row + r, c, cls, valid, x[r], y[r]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) count<kPer>(x[r], y[r], th, acc, pos);
    }
    for (; row < row1; ++row) {
      float x;
      int32_t y;
      load(preds, tgt, row, c, cls, valid, x, y);
      count<kPer>(x, y, th, acc, pos);
    }
    if (base == 0 && warp == 0 && valid && pos != 0) atomicAdd(&pos_out[cls], pos);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      s_tp[warp * kPer + j][lane] = static_cast<int32_t>(acc[j] >> 16);
      s_p[warp * kPer + j][lane] = static_cast<int32_t>(acc[j] & 0xffffu);
    }
    __syncthreads();
    // consecutive threads take consecutive thresholds of one class
    for (int i = threadIdx.x; i < kTile * kPass; i += kThreads) {
      const int k = i % kPass;
      const int l = i / kPass;
      const int cc = blockIdx.x * kTile + l;
      const int tt = base + k;
      if (cc < c && tt < t) {
        const size_t at = static_cast<size_t>(cc) * t + tt;
        const int32_t vtp = s_tp[k][l];
        const int32_t vp = s_p[k][l];
        if (vtp != 0) atomicAdd(&tp_out[at], vtp);
        if (vp != 0) atomicAdd(&p_out[at], vp);
      }
    }
    __syncthreads();  // s_thr and the staging tiles are rewritten by the next pass
  }
}

template <int kPer>
cudaError_t launch_compare(const float* preds, const bool* tgt, const float* thr, int n, int c, int t, int32_t* tp,
                           int32_t* p, int32_t* pos, cudaStream_t stream) {
  const int tiles = (c + kTile - 1) / kTile;
  int chunks = (kTargetBlocks + tiles - 1) / tiles;
  const int most = (n + kMinRows - 1) / kMinRows;
  if (chunks > most) chunks = most;
  if (chunks < (n + kMaxRows - 1) / kMaxRows) chunks = (n + kMaxRows - 1) / kMaxRows;
  if (chunks < 1) chunks = 1;
  const int rows = (n + chunks - 1) / chunks;
  chunks = (n + rows - 1) / rows;
  binned_counts<kPer><<<dim3(tiles, chunks), kThreads, 0, stream>>>(preds, tgt, thr, n, c, t, rows, tp, p, pos);
  return cudaGetLastError();
}

// The (3, C, T) float32 result: tp, fp = p - tp, fn = pos - tp.
__global__ void binned_finish(const int32_t* __restrict__ tp, const int32_t* __restrict__ p,
                              const int32_t* __restrict__ pos, int c, int t, float* __restrict__ out) {
  const size_t cells = static_cast<size_t>(c) * t;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < cells;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int32_t v = tp[i];
    out[i] = static_cast<float>(v);
    out[cells + i] = static_cast<float>(p[i] - v);
    out[2 * cells + i] = static_cast<float>(pos[i / t] - v);
  }
}

cudaError_t run_compare(const float* x, const bool* y, const float* th, int n, int c, int t, int32_t* counts,
                        float* out, cudaStream_t s) {
  const size_t cells = static_cast<size_t>(c) * t;
  int32_t* o_tp = counts;
  int32_t* o_p = o_tp + cells;
  int32_t* o_pos = o_p + cells;
  // kPer thresholds a warp: T in one pass up to T = 128, passes of 128 above
  cudaError_t err;
  switch (t >= kPassWarps * 16 ? 16 : (t + kPassWarps - 1) / kPassWarps) {
#define BINNED_CASE(k) \
  case k:              \
    err = launch_compare<k>(x, y, th, n, c, t, o_tp, o_p, o_pos, s); \
    break;
    BINNED_CASE(1) BINNED_CASE(2) BINNED_CASE(3) BINNED_CASE(4) BINNED_CASE(5) BINNED_CASE(6) BINNED_CASE(7)
    BINNED_CASE(8) BINNED_CASE(9) BINNED_CASE(10) BINNED_CASE(11) BINNED_CASE(12) BINNED_CASE(13)
    BINNED_CASE(14) BINNED_CASE(15)
    default: err = launch_compare<16>(x, y, th, n, c, t, o_tp, o_p, o_pos, s);
#undef BINNED_CASE
  }
  if (err != cudaSuccess) return err;
  size_t blocks = (cells + kThreads - 1) / kThreads;
  if (blocks > 1024) blocks = 1024;
  binned_finish<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(o_tp, o_p, o_pos, c, t, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int binned_stats_device(int* sms, int* shared_optin) { return device_limits(sms, shared_optin); }

// The shared memory of a histogram-branch block for `t` thresholds, so that
// the caller's plan (`hist_shared_bytes`) can be held against the layout.
extern "C" long long binned_stats_hist_bytes(int t, int wide) {
  return static_cast<long long>(hist_layout(t, wide != 0).bytes);
}

// Writes the (3, C, T) float32 tp, fp, fn of `preds` (N, C) float32, `target`
// (N, C) bool and `thresholds` (T,) float32, all contiguous, to `out` on
// `stream`; returns a CUDA error code (0 on success). `branch` 0 is the
// histogram branch on clusters of `cluster` (1 to 8) blocks, with two 32-bit
// planes when `wide` (required past 65,535 rows); `counts` is unused. `branch`
// 1 is the compare branch; `counts` is a zeroed int32 scratch of 2*C*T + C
// cells (tp, p, pos).
extern "C" int binned_stats_launch(const void* preds, const void* target, const void* thresholds, int n, int c,
                                   int t, int branch, int cluster, int wide, void* counts, void* out, void* stream) {
  if (n <= 0 || c <= 0 || t <= 0) return 0;
  const auto* x = static_cast<const float*>(preds);
  const auto* y = static_cast<const bool*>(target);
  const auto* th = static_cast<const float*>(thresholds);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (branch == 1) return static_cast<int>(run_compare(x, y, th, n, c, t, static_cast<int32_t*>(counts), o, s));
  if (branch != 0 || t > kHistThreads || cluster < 1 || cluster > 8 || (!wide && n > 65535)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = wide ? launch_hist<true>(x, y, th, n, c, t, cluster, o, s)
                               : launch_hist<false>(x, y, th, n, c, t, cluster, o, s);
  return static_cast<int>(err);
}

extern "C" const char* binned_stats_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
