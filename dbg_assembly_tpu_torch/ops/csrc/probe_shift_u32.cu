// Triage probe: uint32 shifts, or and xor, ((v << 2) | (v >> 30)) ^ v over
// an (8, 128) tile -- the integer operations the chop is built from.
//
// Replaces the TPU compiler probe probe_shift_u32
// (tools/mosaic_triage.py:74, pallas_call :87).  Bits pass through int32
// tensors and are read as unsigned, so >> is a logical shift.  Bound:
// launch overhead (4 KB in, 4 KB out).  One thread an element.

#include <cuda_runtime.h>

namespace {

__global__ void shift_u32_kernel(const unsigned* __restrict__ x,
                                 unsigned* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const unsigned v = x[i];
    out[i] = ((v << 2) | (v >> 30)) ^ v;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int probe_shift_u32_launch(const void* x, void* out, int n,
                                      void* stream) {
  if (n <= 0) return 0;
  shift_u32_kernel<<<(n + 255) / 256, 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(x), static_cast<unsigned*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
