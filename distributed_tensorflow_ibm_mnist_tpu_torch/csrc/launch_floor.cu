// An empty kernel: the card's launch floor, timed beside K1 and K2.
//
// K1 and K2 (xent.cu) move a few kilobytes at the training path's shapes,
// so their bound from bytes and operations is nanoseconds and no launch
// can reach it.  What such a kernel can reach is the time of launching a
// kernel that does nothing: one block of one thread, no arguments read.
// chip_smoke.py times it with the same CUDA-event timer as the others and
// prints it as `launch_floor_ms`.

#include <cuda_runtime.h>

namespace {
__global__ void empty_kernel() {}
}  // namespace

extern "C" int launch_floor(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
