// Triage probe: a float32 copy that doubles, x * 2.0 (an (8, 128) tile in
// the probe; any length here).
//
// Replaces the TPU compiler probe probe_copy_f32
// (tools/mosaic_triage.py:34, pallas_call :45).  Like it, it checks that
// the smallest kernel of its kind builds for the card, launches and is
// exact.
//
// Bound: at the probe's 4 KB in and 4 KB out, the launch (the bytes take
// 2.4e-6 ms at 3.35 TB/s, well under any launch; the card waits on the
// host's launch path, ops/probes.py); at large inputs, bytes.  Design:
// each thread moves 16 bytes with one load and one store (float4), so a
// warp moves 512 contiguous bytes a request, and the grid has one thread
// per float4: at the probe's shape one block of 256 threads; at large
// inputs enough blocks that the scheduler keeps every SM full until the
// end.  A grid sized to the SMs that strides over the input was slower
// at 2^26 floats on the H100 (PERF.md section 6).  The n % 4 tail goes
// one float a thread in the same launch; a pointer that is not 16-byte
// aligned sends every element that way.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Thread i doubles float4 i (i < n4), then element 4 * n4 + i (< n): the
// tail, or with n4 = 0 every element.
__global__ void copy_f32_kernel(const float* __restrict__ x,
                                float* __restrict__ out, int n, int n4) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n4) {
    const float4 v = reinterpret_cast<const float4*>(x)[i];
    reinterpret_cast<float4*>(out)[i] =
        make_float4(v.x * 2.0f, v.y * 2.0f, v.z * 2.0f, v.w * 2.0f);
  }
  const int t = 4 * n4 + i;
  if (t < n) out[t] = x[t] * 2.0f;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int probe_copy_f32_launch(const void* x, void* out, int n,
                                     void* stream) {
  if (n <= 0) return 0;
  const bool aligned =
      ((reinterpret_cast<std::uintptr_t>(x) |
        reinterpret_cast<std::uintptr_t>(out)) & 15) == 0;
  const int n4 = aligned ? n / 4 : 0;
  const int threads = n4 > 0 ? n4 : n;
  copy_f32_kernel<<<(threads + kThreads - 1) / kThreads, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n, n4);
  return static_cast<int>(cudaGetLastError());
}
