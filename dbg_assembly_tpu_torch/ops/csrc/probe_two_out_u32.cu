// Triage probe: one kernel with two outputs, x + 1 and x * 3 (uint32,
// wrapping) over an (8, 128) tile.
//
// Replaces the TPU compiler probe probe_two_out_u32
// (tools/mosaic_triage.py:98, pallas_call :110), the shape of the chop's
// edge mode (one input, several outputs).  Bound: launch overhead (4 KB
// in, 8 KB out).  One thread an element.

#include <cuda_runtime.h>

namespace {

__global__ void two_out_u32_kernel(const unsigned* __restrict__ x,
                                   unsigned* __restrict__ a,
                                   unsigned* __restrict__ b, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const unsigned v = x[i];
    a[i] = v + 1u;
    b[i] = v * 3u;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int probe_two_out_u32_launch(const void* x, void* a, void* b,
                                        int n, void* stream) {
  if (n <= 0) return 0;
  two_out_u32_kernel<<<(n + 255) / 256, 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(x), static_cast<unsigned*>(a),
      static_cast<unsigned*>(b), n);
  return static_cast<int>(cudaGetLastError());
}
