// Triage probe: a gridded kernel, x + 1.0 over a (64, 256) float32 array,
// one block per (8, 256) row tile -- a grid of 8 blocks.
//
// Replaces the TPU compiler probe probe_grid_block
// (tools/mosaic_triage.py:122, pallas_call :134), whose BlockSpec cuts the
// array into 8 row blocks on a sequential grid.  Here the blocks run in
// parallel and each computes its own offset from blockIdx, as the probe
// means to check.
//
// Bound: at the probe's 64 KB in and 64 KB out, the launch (the bytes take
// 3.9e-5 ms at 3.35 TB/s; the card waits on the host's launch path,
// ops/probes.py); at many tiles, bytes.  Design: the block reads its tile
// across the columns as float4, 16 bytes a thread, neighbouring threads on
// neighbouring addresses, and every row of the tile at once: 8 / R row
// groups of cols / 4 threads, each thread loading its R rows (R = 1 up to
// 512 columns, 2 up to 1024) before it stores them.  One thread holding
// all 8 rows made 64-thread blocks at 256 columns, and the last, partial
// round of blocks on the SMs then cost more than at 512 threads (on the
// H100, PERF.md section 6).  Columns not a multiple of 4, or a pointer
// that is not 16-byte aligned, take one float a thread, a thread a column
// walking the tile's 8 rows.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 8;

__device__ __forceinline__ float4 plus_one(float4 v) {
  return make_float4(v.x + 1.0f, v.y + 1.0f, v.z + 1.0f, v.w + 1.0f);
}

// (cols4 * 8 / R) threads: thread (g, c) holds float4 column c of rows
// g, g + 8 / R, ... of the block's tile.
template <int R>
__global__ void grid_block_kernel(const float4* __restrict__ x,
                                  float4* __restrict__ out, int cols4) {
  constexpr int kGroups = kTileRows / R;
  const int c = threadIdx.x % cols4;
  const int g = threadIdx.x / cols4;
  const long long base =
      static_cast<long long>(blockIdx.x) * kTileRows * cols4 + c;
  float4 v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    v[r] = x[base + static_cast<long long>(g + r * kGroups) * cols4];
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    out[base + static_cast<long long>(g + r * kGroups) * cols4] =
        plus_one(v[r]);
  }
}

// The scalar path: cols threads, thread c walks column c of the tile.
__global__ void grid_block_scalar_kernel(const float* __restrict__ x,
                                         float* __restrict__ out, int cols) {
  const long long base =
      static_cast<long long>(blockIdx.x) * kTileRows * cols + threadIdx.x;
  float v[kTileRows];
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) v[r] = x[base + r * cols];
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) out[base + r * cols] = v[r] + 1.0f;
}

}  // namespace

// rows must be a multiple of 8 and cols at most 1024 (the wrapper checks).
// Launches rows / 8 blocks on `stream`; returns cudaGetLastError() (0 on
// success).
extern "C" int probe_grid_block_launch(const void* x, void* out, int rows,
                                       int cols, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  if (rows % kTileRows != 0 || cols > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = rows / kTileRows;
  const bool vec = cols % 4 == 0 &&
                   ((reinterpret_cast<std::uintptr_t>(x) |
                     reinterpret_cast<std::uintptr_t>(out)) & 15) == 0;
  const float4* x4 = static_cast<const float4*>(x);
  float4* o4 = static_cast<float4*>(out);
  if (vec && cols <= 512) {
    grid_block_kernel<1><<<blocks, 2 * cols, 0, s>>>(x4, o4, cols / 4);
  } else if (vec) {
    grid_block_kernel<2><<<blocks, cols, 0, s>>>(x4, o4, cols / 4);
  } else {
    grid_block_scalar_kernel<<<blocks, cols, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), cols);
  }
  return static_cast<int>(cudaGetLastError());
}
