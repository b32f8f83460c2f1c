// Triage probe: a uint32 copy that adds 7, wrapping at 2^32 (an (8, 128)
// tile in the probe; any length here).
//
// Replaces the TPU compiler probe probe_copy_u32
// (tools/mosaic_triage.py:54, pallas_call :65).  The wrapper passes the
// bits through int32 tensors; the kernel reads them as unsigned, so the
// add wraps as the probe's uint32 add does.
//
// Bound: at the probe's 4 KB in and 4 KB out, the launch (the bytes take
// 2.4e-6 ms at 3.35 TB/s, well under any launch; the card waits on the
// host's launch path, ops/probes.py, which allocates the output and
// launches in one ctypes call); at large inputs, bytes.  Design: each
// thread moves 16 bytes with one load and one store (uint4), so a warp
// moves 512 contiguous bytes a request, and the grid has one thread per
// uint4: at the probe's shape one block of 256 threads; at large inputs
// enough blocks that the scheduler keeps every SM full until the end (as
// probe_copy_f32.cu, measured there against a grid that strides).  The
// n % 4 tail goes one element a thread in the same launch; a pointer that
// is not 16-byte aligned sends every element that way.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Thread i adds 7 to uint4 i (i < n4), then to element 4 * n4 + i (< n):
// the tail, or with n4 = 0 every element.
__global__ void copy_u32_kernel(const unsigned* __restrict__ x,
                                unsigned* __restrict__ out, int n, int n4) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n4) {
    const uint4 v = reinterpret_cast<const uint4*>(x)[i];
    reinterpret_cast<uint4*>(out)[i] =
        make_uint4(v.x + 7u, v.y + 7u, v.z + 7u, v.w + 7u);
  }
  const int t = 4 * n4 + i;
  if (t < n) out[t] = x[t] + 7u;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int probe_copy_u32_launch(const void* x, void* out, int n,
                                     void* stream) {
  if (n <= 0) return 0;
  const bool aligned =
      ((reinterpret_cast<std::uintptr_t>(x) |
        reinterpret_cast<std::uintptr_t>(out)) & 15) == 0;
  const int n4 = aligned ? n / 4 : 0;
  const int threads = n4 > 0 ? n4 : n;
  copy_u32_kernel<<<(threads + kThreads - 1) / kThreads, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(x), static_cast<unsigned*>(out), n, n4);
  return static_cast<int>(cudaGetLastError());
}
