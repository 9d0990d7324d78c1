// An empty kernel: one block of one warp that does nothing.  Timed the
// way the other kernels are timed, it is the floor that a launch cannot
// go under on the card (launch and completion latency alone).

#include <cuda_runtime.h>

namespace {
__global__ void empty_kernel() {}
}  // namespace

extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
