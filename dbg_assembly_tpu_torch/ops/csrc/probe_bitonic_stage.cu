// Triage probe: one compare-exchange stage of a bitonic network on uint32
// rows.  For x of shape (2h, w), rows 0..h-1 get min(a, b) and rows
// h..2h-1 get max(a, b), where a is the top half and b the bottom half;
// the probe's shape is (16, 128).
//
// Replaces the TPU compiler probe probe_bitonic_stage
// (tools/mosaic_triage.py:146, pallas_call :163).  Bits pass through int32
// tensors and are compared as unsigned.
//
// Bound: at the probe's 8 KB in and 8 KB out, the launch (the bytes take
// 4.9e-6 ms at 3.35 TB/s; the card waits on the host's launch path,
// ops/probes.py); at large inputs, bytes: 2 x 4 B in and 2 x 4 B out a
// pair.  Design: thread i loads uint4 i of the top half and of the bottom
// half (16 bytes each) and stores the lane-wise min to the top and the max
// to the bottom, so a warp moves 512 contiguous bytes a request on each of
// the four streams; one thread per uint4 pair in 256-thread blocks.  The
// bottom half starts h * w elements past x and out, so the vector path
// needs h * w % 4 == 0 as well as 16-byte aligned pointers; otherwise
// every pair goes one a thread.  Either way each pair takes one path: the
// vector path has no tail.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint4 min4(uint4 a, uint4 b) {
  return make_uint4(min(a.x, b.x), min(a.y, b.y), min(a.z, b.z),
                    min(a.w, b.w));
}

__device__ __forceinline__ uint4 max4(uint4 a, uint4 b) {
  return make_uint4(max(a.x, b.x), max(a.y, b.y), max(a.z, b.z),
                    max(a.w, b.w));
}

// With half4 > 0, thread i takes uint4 i of each half (i < half4); with
// half4 = 0, pair i (i < half).
__global__ void bitonic_stage_kernel(const unsigned* __restrict__ x,
                                     unsigned* __restrict__ out, int half,
                                     int half4) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (half4 > 0) {
    if (i < half4) {
      const uint4* x4 = reinterpret_cast<const uint4*>(x);
      uint4* out4 = reinterpret_cast<uint4*>(out);
      const uint4 a = x4[i];
      const uint4 b = x4[half4 + i];
      out4[i] = min4(a, b);
      out4[half4 + i] = max4(a, b);
    }
  } else if (i < half) {
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
  const bool aligned =
      ((reinterpret_cast<std::uintptr_t>(x) |
        reinterpret_cast<std::uintptr_t>(out)) & 15) == 0;
  const int half4 = aligned && half % 4 == 0 ? half / 4 : 0;
  const int threads = half4 > 0 ? half4 : half;
  bitonic_stage_kernel<<<(threads + kThreads - 1) / kThreads, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(x), static_cast<unsigned*>(out), half,
      half4);
  return static_cast<int>(cudaGetLastError());
}
