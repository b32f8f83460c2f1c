// Triage probe: one kernel with two outputs, x + 1 and x * 3 (uint32,
// wrapping at 2^32) over an (8, 128) tile in the probe; any length here.
//
// Replaces the TPU compiler probe probe_two_out_u32
// (tools/mosaic_triage.py:98, pallas_call :110), the shape of the chop's
// edge mode: one input, several outputs, one launch that reads the input
// once.  The wrapper passes the bits through int32 tensors; the kernel
// reads them as unsigned.
//
// Bound: at the probe's 4 KB in and 8 KB out, the launch (the bytes take
// 3.7e-6 ms at 3.35 TB/s; the card waits on the host's launch path,
// ops/probes.py, which allocates both outputs and launches in one ctypes
// call); at large inputs, bytes (one read, two writes).  Design: each
// thread loads 16 bytes (uint4) and stores 16 bytes to each output, so a
// warp moves 512 contiguous bytes a request on all three arrays, and the
// grid has one thread per uint4, as probe_copy_f32.cu.  The n % 4 tail
// goes one element a thread in the same launch; a pointer of the three
// that is not 16-byte aligned sends every element that way.  Plain
// stores: streaming stores (__stcs) measured 0.4 % slower at the large
// shape (PERF.md section 6).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Thread i writes uint4 i of both outputs (i < n4), then element
// 4 * n4 + i (< n): the tail, or with n4 = 0 every element.
__global__ void two_out_u32_kernel(const unsigned* __restrict__ x,
                                   unsigned* __restrict__ a,
                                   unsigned* __restrict__ b, int n, int n4) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n4) {
    const uint4 v = reinterpret_cast<const uint4*>(x)[i];
    reinterpret_cast<uint4*>(a)[i] =
        make_uint4(v.x + 1u, v.y + 1u, v.z + 1u, v.w + 1u);
    reinterpret_cast<uint4*>(b)[i] =
        make_uint4(v.x * 3u, v.y * 3u, v.z * 3u, v.w * 3u);
  }
  const int t = 4 * n4 + i;
  if (t < n) {
    const unsigned v = x[t];
    a[t] = v + 1u;
    b[t] = v * 3u;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int probe_two_out_u32_launch(const void* x, void* a, void* b,
                                        int n, void* stream) {
  if (n <= 0) return 0;
  const bool aligned =
      ((reinterpret_cast<std::uintptr_t>(x) |
        reinterpret_cast<std::uintptr_t>(a) |
        reinterpret_cast<std::uintptr_t>(b)) & 15) == 0;
  const int n4 = aligned ? n / 4 : 0;
  const int threads = n4 > 0 ? n4 : n;
  two_out_u32_kernel<<<(threads + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(x), static_cast<unsigned*>(a),
      static_cast<unsigned*>(b), n, n4);
  return static_cast<int>(cudaGetLastError());
}
