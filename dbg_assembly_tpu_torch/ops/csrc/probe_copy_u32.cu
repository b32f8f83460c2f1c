// Triage probe: a uint32 copy that adds 7 (wrapping) over an (8, 128) tile.
//
// Replaces the TPU compiler probe probe_copy_u32
// (tools/mosaic_triage.py:54, pallas_call :65).  The wrapper passes the
// bits through int32 tensors; the kernel reads them as unsigned.  Bound:
// launch overhead (4 KB in, 4 KB out).  One thread an element.

#include <cuda_runtime.h>

namespace {

__global__ void copy_u32_kernel(const unsigned* __restrict__ x,
                                unsigned* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i] + 7u;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int probe_copy_u32_launch(const void* x, void* out, int n,
                                     void* stream) {
  if (n <= 0) return 0;
  copy_u32_kernel<<<(n + 255) / 256, 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(x), static_cast<unsigned*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
