// Triage probe: uint32 shifts, or and xor, ((v << 2) | (v >> 30)) ^ v (an
// (8, 128) tile in the probe; any length here) -- the integer operations
// the chop is built from.
//
// Replaces the TPU compiler probe probe_shift_u32
// (tools/mosaic_triage.py:74, pallas_call :87).  The wrapper passes the
// bits through int32 tensors; the kernel reads them as unsigned, so >> is
// a logical shift.
//
// Bound: at the probe's 4 KB in and 4 KB out, the launch (the bytes take
// 2.4e-6 ms at 3.35 TB/s; the card waits on the host's launch path,
// ops/probes.py); at large inputs, bytes: 8 B and 4 ALU operations an
// element, and at 67 T operations a second the operations take about a
// fortieth of the bytes' time.  Design: probe_copy_u32.cu's with the
// shift's arithmetic on each lane: each thread moves 16 bytes with one
// load and one store (uint4), so a warp moves 512 contiguous bytes a
// request, and the grid has one thread per uint4 in 256-thread blocks.
// The n % 4 tail goes one element a thread in the same launch; a pointer
// that is not 16-byte aligned sends every element that way.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned shift(unsigned v) {
  return ((v << 2) | (v >> 30)) ^ v;
}

// Thread i shifts uint4 i (i < n4), then element 4 * n4 + i (< n): the
// tail, or with n4 = 0 every element.
__global__ void shift_u32_kernel(const unsigned* __restrict__ x,
                                 unsigned* __restrict__ out, int n, int n4) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n4) {
    const uint4 v = reinterpret_cast<const uint4*>(x)[i];
    reinterpret_cast<uint4*>(out)[i] =
        make_uint4(shift(v.x), shift(v.y), shift(v.z), shift(v.w));
  }
  if (i < n - 4 * n4) out[4 * n4 + i] = shift(x[4 * n4 + i]);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int probe_shift_u32_launch(const void* x, void* out, int n,
                                      void* stream) {
  if (n <= 0) return 0;
  const bool aligned =
      ((reinterpret_cast<std::uintptr_t>(x) |
        reinterpret_cast<std::uintptr_t>(out)) & 15) == 0;
  const int n4 = aligned ? n / 4 : 0;
  const int threads = n4 > 0 ? n4 : n;
  shift_u32_kernel<<<(threads + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(x), static_cast<unsigned*>(out), n, n4);
  return static_cast<int>(cudaGetLastError());
}
