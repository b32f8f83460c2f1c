// Triage probe: a float32 copy that doubles, x * 2.0 over an (8, 128) tile.
//
// Replaces the TPU compiler probe probe_copy_f32
// (tools/mosaic_triage.py:34, pallas_call :45).  Like it, it checks that
// the smallest kernel of its kind builds for the card, launches and is
// exact.  Bound: launch overhead; the tile is 4 KB in and 4 KB out.  One
// thread an element.

#include <cuda_runtime.h>

namespace {

__global__ void copy_f32_kernel(const float* __restrict__ x,
                                float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i] * 2.0f;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int probe_copy_f32_launch(const void* x, void* out, int n,
                                     void* stream) {
  if (n <= 0) return 0;
  copy_f32_kernel<<<(n + 255) / 256, 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
