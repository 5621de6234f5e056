// Binned threshold-sweep counts for the binned precision-recall metrics.
//
// Replaces the TPU kernel `_binned_kernel` (metrics_tpu/ops/binned_stats.py:43,
// launched by `_binned_stat_scores_pallas`). For float32 scores preds (N, C),
// bool targets tgt (N, C) and float32 thresholds thr (T,) it computes, into
// int32 outputs that the caller has zeroed,
//   tp[c, t] = sum_n tgt[n, c] * (preds[n, c] >= thr[t])
//   p[c, t]  = sum_n (preds[n, c] >= thr[t])
//   pos[c]   = sum_n tgt[n, c]
// The compare is IEEE float32 `>=`, as in XLA: a NaN score hits no
// threshold, +inf hits every threshold but NaN, -inf only -inf. The
// thresholds may be in any order and may repeat.
//
// Bound on the H100 at B = 1024, C = 1000, T = 100: the bytes are
// 1024*1000*(4+1) in and 3*1000*100*4 out, about 6.3 MB, 1.9 us at 3.35 TB/s;
// the work is 1.02e8 compares, each with up to two adds (P and TP), 3.1e8
// operations: 4.6 us at the 67 TFLOP/s float32 peak, some 9 us at one
// instruction a lane and clock (132 SMs * 128 lanes * 1.98 GHz). The kernel
// is bound by instruction issue, not by bytes, so it packs the two adds into
// one (below).
//
// Design. A block takes a tile of 32 consecutive classes and a chunk of rows:
// lane l of every warp owns class tile*32 + l, so a warp reads one row's 32
// scores as one coalesced load. The thresholds of a pass sit in shared memory
// and in registers; the 8 warps of the block split them, kPer = ceil(T/8)
// each (at most 16, and a loop of passes covers any T), with their counters
// in registers. A counter packs the chunk's prediction-positive count in its
// low 16 bits and its true positives in its high 16 bits, so a compare costs
// one predicated add; a chunk therefore has fewer than 2^16 rows. At the end
// of a pass the block stages its counters in shared memory, transposed, so
// that consecutive threads add consecutive thresholds of one class into the
// global outputs with int32 atomicAdd. Integer addition is exact and
// order-free, so the result equals the plain version bit for bit.
//
// Why atomics across row chunks and not the Pallas design: the TPU grid runs
// in order on one core, so the Pallas kernel carries (C, T) accumulators in
// VMEM from one batch tile to the next and builds a (128, C, T) compare tile
// there. Hopper's blocks run in parallel with no carried state and a block
// has at most 227 KB of shared memory, so each block keeps only its own
// (32 classes x 8*kPer thresholds) counters in registers and the row chunks
// meet in global memory through atomics, one per non-zero counter.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;          // classes per block: one per lane
constexpr int kTargetBlocks = 528; // four blocks on each of the 132 SMs
constexpr int kMinRows = 16;       // fewest rows a chunk is cut to
constexpr int kMaxRows = 65535;    // most rows of a chunk: the packed 16-bit counters

constexpr int kRows = 8;           // rows whose loads a thread issues together

__device__ __forceinline__ void load(const float* __restrict__ preds, const bool* __restrict__ tgt, int row, int c,
                                     int cls, bool valid, float& x, int32_t& y) {
  const size_t at = static_cast<size_t>(row) * c + cls;
  x = valid ? preds[at] : __int_as_float(0x7fc00000);  // a lane past C: NaN, which hits nothing
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
  constexpr int kPass = kWarps * kPer;  // thresholds per pass
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
      // past the end: NaN, which no score reaches
      s_thr[i] = base + i < t ? thr[base + i] : __int_as_float(0x7fc00000);
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
cudaError_t launch(const float* preds, const bool* tgt, const float* thr, int n, int c, int t, int32_t* tp,
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

}  // namespace

// Launches both kernels on `stream` and returns cudaGetLastError() (0 on
// success). `counts` is a zeroed int32 scratch of 2*C*T + C cells (tp, p,
// pos); `out` receives the (3, C, T) float32 tp, fp, fn.
extern "C" int binned_stats_launch(const void* preds, const void* target, const void* thresholds, int n, int c,
                                   int t, void* counts, void* out, void* stream) {
  if (n <= 0 || c <= 0 || t <= 0) return 0;
  const auto* x = static_cast<const float*>(preds);
  const auto* y = static_cast<const bool*>(target);
  const auto* th = static_cast<const float*>(thresholds);
  const size_t cells = static_cast<size_t>(c) * t;
  auto* o_tp = static_cast<int32_t*>(counts);
  auto* o_p = o_tp + cells;
  auto* o_pos = o_p + cells;
  auto s = static_cast<cudaStream_t>(stream);
  // kPer thresholds a warp: T in one pass up to T = 128, passes of 128 above
  cudaError_t err;
  switch (t >= kWarps * 16 ? 16 : (t + kWarps - 1) / kWarps) {
#define BINNED_CASE(k) \
  case k:              \
    err = launch<k>(x, y, th, n, c, t, o_tp, o_p, o_pos, s); \
    break;
    BINNED_CASE(1) BINNED_CASE(2) BINNED_CASE(3) BINNED_CASE(4) BINNED_CASE(5) BINNED_CASE(6) BINNED_CASE(7)
    BINNED_CASE(8) BINNED_CASE(9) BINNED_CASE(10) BINNED_CASE(11) BINNED_CASE(12) BINNED_CASE(13)
    BINNED_CASE(14) BINNED_CASE(15)
    default: err = launch<16>(x, y, th, n, c, t, o_tp, o_p, o_pos, s);
#undef BINNED_CASE
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t blocks = (cells + kThreads - 1) / kThreads;
  if (blocks > 1024) blocks = 1024;
  binned_finish<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(o_tp, o_p, o_pos, c, t, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* binned_stats_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
