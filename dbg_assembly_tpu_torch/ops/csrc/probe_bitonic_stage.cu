// Triage probe: one compare-exchange stage of a bitonic network on uint32
// rows.  For x of shape (2h, w), rows 0..h-1 get min(a, b) and rows
// h..2h-1 get max(a, b), where a is the top half and b the bottom half;
// the probe's shape is (16, 128).
//
// Replaces the TPU compiler probe probe_bitonic_stage
// (tools/mosaic_triage.py:146, pallas_call :163).  Bits pass through int32
// tensors and are compared as unsigned.  Bound: launch overhead (8 KB in,
// 8 KB out).  One thread a pair.

#include <cuda_runtime.h>

namespace {

__global__ void bitonic_stage_kernel(const unsigned* __restrict__ x,
                                     unsigned* __restrict__ out, int half) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < half) {
    const unsigned a = x[i];
    const unsigned b = x[half + i];
    out[i] = min(a, b);
    out[half + i] = max(a, b);
  }
}

}  // namespace

// half = h * w, the elements in each half.  Launches on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int probe_bitonic_stage_launch(const void* x, void* out,
                                          int half, void* stream) {
  if (half <= 0) return 0;
  bitonic_stage_kernel<<<(half + 255) / 256, 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(x), static_cast<unsigned*>(out), half);
  return static_cast<int>(cudaGetLastError());
}
