// Unnormalised (C, C) confusion matrix from class indices, in one launch.
//
// Replaces the TPU kernel `_confmat_kernel` (metrics_tpu/ops/confusion.py:37,
// launched by `_confmat_pallas`). For rows i < n with 0 <= target[i], pred[i] < C
// it counts one at out[target[i] * C + pred[i]] of an int32 (C, C) matrix. A
// label outside [0, C) (the padding label -1, a NaN score row's class C) adds
// nothing. The kernel stores every cell itself, so the caller's output is
// `torch.empty`: no memset, no second kernel, no global atomics.
//
// Bound on the H100: 8 bytes a row read once and the C*C matrix written once.
// At the ImageNet-1k validation batch (n = 1,024, C = 1,000) that is the 4 MB
// write, 1.2 us at 3.35 TB/s; at a semantic-segmentation image (n = 2,097,152
// pixels, C = 20) the 16.8 MB read, 5.0 us.
//
// Why counts and not the one-hot product: the TPU kernel expands (rows, C)
// one-hot tiles and contracts them on the matrix unit, because a scatter
// serialises there. On Hopper an integer add in shared memory per row does the
// n additions exactly and in any order, so the result is bit-identical to the
// plain version whatever the scheduling. Each thread takes 8 consecutive rows
// at a time (two 16-byte loads of each array, the next 8 in flight while these
// are counted) and adds a run of rows on one cell with one shared atomic: a
// segmentation map's pixels come in runs of one class, mostly predicted right,
// so a thread's 8 pixels are mostly one add.
// (Grouping a warp's lanes by cell with __match_any_sync, tried first, cost
// more than it saved: its time grows with the distinct cells in the warp.)
//
// The branch is chosen by the caller (metrics_tpu_torch/ops/confusion.py,
// `confusion_plan`) from n, C and the card's limits:
//
// * `confmat_band`, many classes: each block owns a tile of the matrix (a band
//   of R target rows, all C columns; a band of one row split into column
//   tiles where even that does not fit shared memory), reads all n rows
//   (8 KB at ImageNet's batch, from L2 after the first block), counts the rows
//   that fall in its tile in shared memory and stores the whole tile with
//   16-byte stores. At C = 1,000, R = 8: 125 blocks of 32 KB, one wave.
// * `confmat_split`, few classes and long batches: the whole C*C table (C <=
//   240) sits in each block's shared memory and the rows are split over the
//   blocks. One block stores its table directly. Several write their tables
//   to their rows of a workspace; the last block to finish (a ticket counter
//   that it resets to 0 for the next launch) sums the rows in block order,
//   with all its threads, and stores the output. (Thread-block clusters that
//   first summed eight tables over distributed shared memory, tried first,
//   spent some 4 us more in cluster launch and barriers at a segmentation
//   image than they saved.)
#include <cuda_runtime.h>
#include <cstdint>

#include "device.cuh"

namespace {

constexpr int kBandThreads = 512;
constexpr int kSplitThreads = 1024;
constexpr int kChunk = 8;  // rows a thread takes at a time: two int4 loads of each array

// The shared-memory cell of a (target, pred) pair in a tile of `rows` x `cols`
// cells whose first cell is (r0, c0), stored from word `off`; -1 outside the
// tile (any label outside [0, C) is outside every tile).
struct Tile {
  int r0, rows, c0, cols, off;
  __device__ __forceinline__ int cell(int32_t t, int32_t p) const {
    const unsigned tr = static_cast<unsigned>(t) - static_cast<unsigned>(r0);
    const unsigned pc = static_cast<unsigned>(p) - static_cast<unsigned>(c0);
    return (tr < static_cast<unsigned>(rows) && pc < static_cast<unsigned>(cols))
               ? off + static_cast<int>(tr) * cols + static_cast<int>(pc)
               : -1;
  }
};

// A thread's current run of rows on one cell (-1: rows outside the tile, never added).
struct Run {
  int cell = -1, count = 0;
  __device__ __forceinline__ void add(int32_t* table, int c) {
    if (c == cell) {
      ++count;
      return;
    }
    flush(table);
    cell = c;
    count = 1;
  }
  __device__ __forceinline__ void flush(int32_t* table) const {
    if (cell >= 0) atomicAdd(table + cell, count);
  }
};

__device__ __forceinline__ int4 add4(int4 a, int4 b) { return make_int4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w); }

// A chunk of 8 rows: in registers when `whole` (the arrays are 16-byte aligned and the chunk lies before
// n), else read row by row when counted.
struct Chunk {
  int4 t[2], p[2];
  bool whole;
  __device__ __forceinline__ void load(const int32_t* __restrict__ target, const int32_t* __restrict__ pred,
                                       int64_t n, int64_t chunk, bool aligned) {
    whole = aligned && (chunk + 1) * kChunk <= n;
    if (!whole) return;
    const int4* t4 = reinterpret_cast<const int4*>(target + chunk * kChunk);
    const int4* p4 = reinterpret_cast<const int4*>(pred + chunk * kChunk);
    t[0] = __ldg(t4);
    t[1] = __ldg(t4 + 1);
    p[0] = __ldg(p4);
    p[1] = __ldg(p4 + 1);
  }
};

// Zeroes the block's table (`vecs` int4s of shared memory) and counts into it the chunks of 8 rows that
// thread `worker` of `workers` takes, every `workers`-th from `worker`. A chunk's loads go out before the
// previous chunk is counted (the first before the zeroing), so that their latency overlaps that work.
__device__ void zero_and_count(int4* smem, int vecs, const int32_t* __restrict__ target,
                               const int32_t* __restrict__ pred, int64_t n, const Tile& m, int64_t worker,
                               int64_t workers) {
  int32_t* table = reinterpret_cast<int32_t*>(smem);
  const bool aligned = ((reinterpret_cast<uintptr_t>(target) | reinterpret_cast<uintptr_t>(pred)) & 15) == 0;
  const int64_t chunks = (n + kChunk - 1) / kChunk;
  Chunk cur;
  cur.load(target, pred, n, worker, aligned);
  for (int v = threadIdx.x; v < vecs; v += blockDim.x) smem[v] = make_int4(0, 0, 0, 0);
  __syncthreads();
  Run run;
  for (int64_t chunk = worker; chunk < chunks; chunk += workers) {
    Chunk next;
    next.load(target, pred, n, chunk + workers, aligned);
    if (cur.whole) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        run.add(table, m.cell(cur.t[j].x, cur.p[j].x));
        run.add(table, m.cell(cur.t[j].y, cur.p[j].y));
        run.add(table, m.cell(cur.t[j].z, cur.p[j].z));
        run.add(table, m.cell(cur.t[j].w, cur.p[j].w));
      }
    } else {
      const int64_t end = (chunk + 1) * kChunk < n ? (chunk + 1) * kChunk : n;
      for (int64_t i = chunk * kChunk; i < end; ++i) run.add(table, m.cell(__ldg(target + i), __ldg(pred + i)));
    }
    cur = next;
  }
  run.flush(table);
}

// Stores words [w0, w1) of the shared table `s` to `dst` (dst word w <-> s word w, both 16-byte
// aligned at word 0): whole int4s where [w0, w1) covers them, single words at the ragged ends.
__device__ __forceinline__ void store_words(int32_t* dst, const int32_t* s, int w0, int w1, int tid, int threads) {
  const int v0 = w0 / 4, v1 = (w1 + 3) / 4;
  for (int v = v0 + tid; v < v1; v += threads) {
    const int lo = 4 * v;
    if (lo >= w0 && lo + 4 <= w1) {
      reinterpret_cast<int4*>(dst)[v] = reinterpret_cast<const int4*>(s)[v];
    } else {
      for (int w = max(lo, w0); w < min(lo + 4, w1); ++w) dst[w] = s[w];
    }
  }
}

__global__ void __launch_bounds__(kBandThreads)
    confmat_band(const int32_t* __restrict__ target, const int32_t* __restrict__ pred, int n, int num_classes,
                 int band_rows, int band_cols, int32_t* __restrict__ out) {
  extern __shared__ int4 smem[];
  int32_t* s = reinterpret_cast<int32_t*>(smem);
  const int col_tiles = (num_classes + band_cols - 1) / band_cols;
  const int r0 = (blockIdx.x / col_tiles) * band_rows, c0 = (blockIdx.x % col_tiles) * band_cols;
  const int rows = min(band_rows, num_classes - r0), cols = min(band_cols, num_classes - c0);
  const bool whole_rows = cols == num_classes;  // the tile is one contiguous span of the output
  const int64_t start = static_cast<int64_t>(r0) * num_classes + c0;
  // the span starts in shared memory at the output's offset within 16 bytes, so that the two agree mod 4
  const int off = whole_rows ? static_cast<int>(start & 3) : 0;
  const int words = off + rows * cols;
  zero_and_count(smem, (words + 3) / 4, target, pred, n, Tile{r0, rows, c0, cols, off}, threadIdx.x, blockDim.x);
  __syncthreads();
  if (whole_rows) {
    store_words(out + (start - off), s, off, words, threadIdx.x, blockDim.x);
  } else {  // column tiles: only past 58,000 classes
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
      out[static_cast<int64_t>(r0 + i / cols) * num_classes + c0 + i % cols] = s[i];
    }
  }
}

__global__ void __launch_bounds__(kSplitThreads)
    confmat_split(const int32_t* __restrict__ target, const int32_t* __restrict__ pred, int n, int num_classes,
                  int32_t* __restrict__ out, int4* __restrict__ workspace, unsigned* __restrict__ ticket) {
  extern __shared__ int4 smem[];
  __shared__ bool s_last;
  int32_t* s = reinterpret_cast<int32_t*>(smem);
  const int cells = num_classes * num_classes;
  const int vecs = (cells + 3) / 4;
  const int tid = threadIdx.x;
  zero_and_count(smem, vecs, target, pred, n, Tile{0, num_classes, 0, num_classes, 0},
                 static_cast<int64_t>(blockIdx.x) * blockDim.x + tid, static_cast<int64_t>(gridDim.x) * blockDim.x);
  __syncthreads();
  if (gridDim.x == 1) {
    store_words(out, s, 0, cells, tid, blockDim.x);
    return;
  }
  for (int v = tid; v < vecs; v += blockDim.x) workspace[static_cast<int64_t>(blockIdx.x) * vecs + v] = smem[v];
  __threadfence();  // this block's row is visible before its ticket is
  __syncthreads();
  if (tid == 0) {
    s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    if (s_last) *ticket = 0u;  // every block has taken its ticket: ready for the next launch
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // The last block sums the rows: `parts` threads a cell group, each over every parts-th row, then the
  // parts in order through shared memory (its table is in the workspace now).
  const int parts = max(1, min(static_cast<int>(gridDim.x), static_cast<int>(blockDim.x) / vecs));
  for (int i = tid; i < vecs * parts; i += blockDim.x) {
    const int v = i % vecs;
    int4 sum = make_int4(0, 0, 0, 0);
#pragma unroll 4
    for (int b = i / vecs; b < static_cast<int>(gridDim.x); b += parts) {
      sum = add4(sum, __ldcg(workspace + static_cast<int64_t>(b) * vecs + v));
    }
    smem[i] = sum;
  }
  __syncthreads();
  for (int v = tid; v < vecs; v += blockDim.x) {
    int4 sum = smem[v];
    for (int k = 1; k < parts; ++k) sum = add4(sum, smem[k * vecs + v]);
    smem[v] = sum;
  }
  __syncthreads();
  store_words(out, s, 0, cells, tid, blockDim.x);
}

// Shared memory of a launch: the band branch's tile of `a` x `b` cells (up to 3 words of offset), or the
// split branch's C*C table on `a` blocks (at least one int4 a thread for the last block's sums).
size_t shared_bytes(int num_classes, int branch, int a, int b) {
  if (branch == 0) return (static_cast<size_t>(a) * b + 6) / 4 * 16;
  const size_t vecs = (static_cast<size_t>(num_classes) * num_classes + 3) / 4;
  return 16 * (a > 1 && vecs < kSplitThreads ? kSplitThreads : vecs);
}

template <class Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

}  // namespace

extern "C" int confusion_device(int* sms, int* shared_optin) { return device_limits(sms, shared_optin); }

// Writes the (C, C) int32 matrix of `target` and `pred` ((n,) int32, contiguous) to `out` (16-byte
// aligned) on `stream`; returns a CUDA error code (0 on success). `branch` 0 is the band branch on
// tiles of `a` target rows by `b` columns; `branch` 1 the split branch on `a` blocks, with `workspace`
// of a * ceil(C*C / 4) int4s and `ticket` a uint32 that is 0 between launches when a > 1.
extern "C" int confusion_launch(const void* target, const void* pred, int n, int num_classes, int branch, int a,
                                int b, void* out, void* workspace, void* ticket, void* stream) {
  if (n <= 0 || num_classes <= 0 || a <= 0 || b <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(out) & 15) != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  const auto* t = static_cast<const int32_t*>(target);
  const auto* p = static_cast<const int32_t*>(pred);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const size_t bytes = shared_bytes(num_classes, branch, a, b);
  if (branch == 0) {
    if (b > num_classes || a > num_classes) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t tiles = static_cast<int64_t>((num_classes + a - 1) / a) * ((num_classes + b - 1) / b);
    if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = allow_smem(confmat_band, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    confmat_band<<<static_cast<unsigned>(tiles), kBandThreads, bytes, s>>>(t, p, n, num_classes, a, b, o);
    return static_cast<int>(cudaGetLastError());
  }
  if (branch != 1 || (a > 1 && (workspace == nullptr || ticket == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = allow_smem(confmat_split, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  confmat_split<<<a, kSplitThreads, bytes, s>>>(t, p, n, num_classes, o, static_cast<int4*>(workspace),
                                                 static_cast<unsigned*>(ticket));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* confusion_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
