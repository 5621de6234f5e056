// Named no-op kernels that mark the phase boundaries of a captured engine program
// (metrics_tpu_torch/ops/marks.py). Each does nothing; what it gives is its name in a device trace:
// a captured graph replays its nodes in capture order on one stream, so the time from the end of
// one mark to the start of the next is the device time of the phase the first one opens. The
// symbol alone names the phase (`phase_mark_<phase>`), in the order of ops/marks.py's PHASES.
#include <cuda_runtime.h>

namespace {

__global__ void phase_mark_format() {}
__global__ void phase_mark_count() {}
__global__ void phase_mark_writeback() {}
__global__ void phase_mark_end() {}
__global__ void phase_mark_extract() {}

}  // namespace

// Resolve the five kernels now (a lazily loaded module is otherwise loaded at a kernel's first
// launch, which would then fall inside a stream capture); returns a CUDA error code.
extern "C" int phase_mark_prime() {
  cudaFuncAttributes attrs;
  cudaError_t err = cudaFuncGetAttributes(&attrs, phase_mark_format);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attrs, phase_mark_count);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attrs, phase_mark_writeback);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attrs, phase_mark_end);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attrs, phase_mark_extract);
  return static_cast<int>(err);
}

// One mark of phase `phase` (0 format, 1 count, 2 writeback, 3 end, 4 extract) on `stream`: one block of one thread.
extern "C" int phase_mark_launch(int phase, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (phase) {
    case 0: phase_mark_format<<<1, 1, 0, s>>>(); break;
    case 1: phase_mark_count<<<1, 1, 0, s>>>(); break;
    case 2: phase_mark_writeback<<<1, 1, 0, s>>>(); break;
    case 3: phase_mark_end<<<1, 1, 0, s>>>(); break;
    case 4: phase_mark_extract<<<1, 1, 0, s>>>(); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* phase_mark_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
