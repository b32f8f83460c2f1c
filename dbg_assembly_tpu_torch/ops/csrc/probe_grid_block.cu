// Triage probe: a gridded kernel, x + 1.0 over a (64, 256) float32 array,
// one block per (8, 256) row tile -- a grid of 8 blocks.
//
// Replaces the TPU compiler probe probe_grid_block
// (tools/mosaic_triage.py:122, pallas_call :134), whose BlockSpec cuts the
// array into 8 row blocks on a sequential grid.  Here the blocks run in
// parallel and each computes its own offset from blockIdx.  Bound: launch
// overhead (64 KB in, 64 KB out).  Each thread walks one column of its
// tile, so neighbouring threads touch neighbouring addresses.

#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 8;

__global__ void grid_block_kernel(const float* __restrict__ x,
                                  float* __restrict__ out, int cols) {
  const long long base =
      static_cast<long long>(blockIdx.x) * kTileRows * cols + threadIdx.x;
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) {
    const long long i = base + static_cast<long long>(r) * cols;
    out[i] = x[i] + 1.0f;
  }
}

}  // namespace

// rows must be a multiple of 8 and cols at most 1024 (the wrapper checks).
// Launches rows / 8 blocks of cols threads on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int probe_grid_block_launch(const void* x, void* out, int rows,
                                       int cols, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  if (rows % kTileRows != 0 || cols > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  grid_block_kernel<<<rows / kTileRows, cols, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), cols);
  return static_cast<int>(cudaGetLastError());
}
