// Triage probe: a full bitonic sorting network along each row of a uint32
// array (rows, w), w a power of two; the probe's shape is (8, 128), so it
// sorts each row's 128 values.
//
// Replaces the TPU compiler probe probe_fori_sort_net
// (tools/mosaic_triage.py:175, pallas_call :215), which builds the same
// network from lane rolls and selects on the TPU's 128-lane vector.  Here
// one block sorts one row: the row sits in shared memory, thread t owns
// slot t, and each of the log2(w) * (log2(w) + 1) / 2 stages reads the
// partner slot t ^ j, syncs, and keeps the min or the max.  Values compare
// as unsigned.  Bound: launch overhead and the stages' barriers (4 KB in,
// 4 KB out).

#include <cuda_runtime.h>

namespace {

__global__ void fori_sort_net_kernel(const unsigned* __restrict__ x,
                                     unsigned* __restrict__ out, int w) {
  extern __shared__ unsigned s[];
  const int t = threadIdx.x;
  const long long row = static_cast<long long>(blockIdx.x) * w;
  s[t] = x[row + t];
  __syncthreads();
  for (int k = 2; k <= w; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int partner = t ^ j;
      const unsigned a = s[t];
      const unsigned b = s[partner];
      const bool up = (t & k) == 0;           // this run sorts ascending
      const bool lower = t < partner;
      __syncthreads();                        // every read before any write
      s[t] = (lower == up) ? min(a, b) : max(a, b);
      __syncthreads();
    }
  }
  out[row + t] = s[t];
}

}  // namespace

// w must be a power of two in 2..1024 (the wrapper checks).  Launches one
// block of w threads a row on `stream`; returns cudaGetLastError() (0 on
// success).
extern "C" int probe_fori_sort_net_launch(const void* x, void* out, int rows,
                                          int w, void* stream) {
  if (rows <= 0) return 0;
  if (w < 2 || w > 1024 || (w & (w - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fori_sort_net_kernel<<<rows, w, w * sizeof(unsigned),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(x), static_cast<unsigned*>(out), w);
  return static_cast<int>(cudaGetLastError());
}
