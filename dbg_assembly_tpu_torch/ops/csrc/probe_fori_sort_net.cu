// Triage probe: each row of a uint32 array (rows, w), w a power of two in
// 2..1024, sorted ascending as unsigned by a bitonic network; the probe's
// shape is (8, 128).
//
// Replaces the TPU compiler probe probe_fori_sort_net
// (tools/mosaic_triage.py:175, pallas_call :215), which builds the network
// from lane rolls and selects on the TPU's 128-lane vector.  Bits pass
// through int32 tensors and are compared as unsigned.
//
// Bound at (524 288, 128), 2^26 elements: bytes, 256 MiB in and 256 MiB
// out, 0.1603 ms at 3.35 TB/s; operations, 28 stages of 64
// compare-exchanges a row at two each, 1.88e9, 0.028 ms at 67 T/s.  Bytes
// decide, so long as the network's own instructions (shuffles, min / max)
// stay under them.
//
// Design: a row lives in registers.  Lane t of a warp holds kValues (V =
// 16) consecutive elements, e = V t + q, so at w = 128 eight lanes hold a
// row and a warp 4 rows; a 256-thread block takes 256 V elements, whole
// rows (w divides them), and a ragged last block masks whole rows.  The
// network is bitonic with the mirrored first stage of each merge: for k =
// 2, 4, .., w element e meets e ^ (k - 1), then e ^ k/4, .., e ^ 1, and the
// lower index always keeps the min, so no stage selects a direction.  A
// stage whose partner is in the lane (mask < V) is a min and a max of two
// registers; one in another lane of the warp (mask < 32 V) is V
// __shfl_xor_sync a lane, each lane keeping the min or the max by its side
// (two predicated min / max instructions an element); one in another warp
// (w = 1024) goes through shared memory, double buffered, one barrier a
// stage.  At w = 128, 22 of the 28 stages stay in the lane and 6 shuffle:
// 24 shuffles a row (4 values a lane: 15 stages, 60 a row).  The warp's
// 64 V bytes move as coalesced uint4s (lane t takes uint4 32 i + t) through
// a padded staging area in shared memory, which turns them into the lane's
// V consecutive elements and back.  On the card (NVIDIA H100 80GB HBM3,
// 700.00 W; tools/launch_path.py --probes, one process a layout) this
// layout took 0.1847-0.1858 ms at (524 288, 128), 4 values a lane
// 0.2176-0.2197, 8 0.1960 (unstaged 0.1988-0.1996), 32 0.1833-0.1858
// (PERF.md section 6).  A pointer that is not 16-byte aligned, or w = 2 (a
// row is half a uint4), loads and stores one element at a time, the same
// network between; every row of a launch takes one path.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kValues = 16;        // elements a lane (V)
constexpr unsigned kFull = 0xFFFFFFFFu;

__host__ __device__ constexpr int top_bit(int m) {
  return (m & (m - 1)) == 0 ? m : top_bit(m & (m - 1));
}

// Stage of distance mask M within a lane: registers q and q ^ M.
template <int V, int M>
__device__ __forceinline__ void in_lane(unsigned (&v)[V]) {
#pragma unroll
  for (int q = 0; q < V; ++q) {
    if (q < (q ^ M)) {
      const unsigned a = v[q], b = v[q ^ M];
      v[q] = min(a, b);
      v[q ^ M] = max(a, b);
    }
  }
}

// Stage of mask M across the warp's lanes: register q of this lane meets
// register q ^ (M % V) of lane ^ (M / V); the lane below keeps the min.
template <int V, int M>
__device__ __forceinline__ void across_lanes(unsigned (&v)[V], int lane) {
  constexpr int kLane = M / V, kReg = M % V;
  const bool lower = (lane & top_bit(kLane)) == 0;
  unsigned b[V];
#pragma unroll
  for (int q = 0; q < V; ++q) {
    b[q] = __shfl_xor_sync(kFull, v[q ^ kReg], kLane);
  }
#pragma unroll
  for (int q = 0; q < V; ++q) {
    v[q] = lower ? min(v[q], b[q]) : max(v[q], b[q]);
  }
}

// Stage of mask M across warps: the block's elements go to s (this stage's
// buffer, 256 V words), then each lane reads its partners; e0 is the lane's
// first element in the block.
template <int V, int M>
__device__ __forceinline__ void across_warps(unsigned (&v)[V], unsigned* s,
                                             int e0) {
#pragma unroll
  for (int q = 0; q < V; q += 4) {
    *reinterpret_cast<uint4*>(s + e0 + q) =
        make_uint4(v[q], v[q + 1], v[q + 2], v[q + 3]);
  }
  __syncthreads();
  const bool lower = (e0 & top_bit(M)) == 0;
#pragma unroll
  for (int q = 0; q < V; ++q) {
    const unsigned b = s[(e0 + q) ^ M];
    v[q] = lower ? min(v[q], b) : max(v[q], b);
  }
}

template <int V, int M>
__device__ __forceinline__ void stage(unsigned (&v)[V], int lane,
                                      unsigned* s, int& buf, int e0) {
  if constexpr (M < V) {
    in_lane<V, M>(v);
  } else if constexpr (M < 32 * V) {
    across_lanes<V, M>(v, lane);
  } else {
    // two buffers in turn: a lane writes one only after the barrier of the
    // stage between, which every lane reaches after its reads of it
    across_warps<V, M>(v, s + buf * kThreads * V, e0);
    buf ^= 1;
  }
}

template <int V, int J>
__device__ __forceinline__ void half_cleaners(unsigned (&v)[V], int lane,
                                              unsigned* s, int& buf,
                                              int e0) {
  if constexpr (J >= 1) {
    stage<V, J>(v, lane, s, buf, e0);
    half_cleaners<V, J / 2>(v, lane, s, buf, e0);
  }
}

template <int V, int W, int K>
__device__ __forceinline__ void merges(unsigned (&v)[V], int lane,
                                       unsigned* s, int& buf, int e0) {
  if constexpr (K <= W) {
    stage<V, K - 1>(v, lane, s, buf, e0);
    half_cleaners<V, K / 4>(v, lane, s, buf, e0);
    merges<V, W, 2 * K>(v, lane, s, buf, e0);
  }
}

// A word's place in a warp's staging area: 4 words of padding after every
// 32, so that lanes storing 16 consecutive bytes each, and lanes reading V
// consecutive words each, fall on distinct banks.
__device__ __forceinline__ int padded(int w) { return w + ((w >> 5) << 2); }

// n = rows * W elements; with kVec, x and out are 16-byte aligned and
// n % 4 == 0, so each uint4 lies wholly inside or past the last row.  The
// staging area and the buffers across warps share s: with both, a barrier
// parts them.
template <int V, int W, bool kVec>
__global__ void __launch_bounds__(kThreads)
    fori_sort_net_kernel(const unsigned* __restrict__ x,
                         unsigned* __restrict__ out, long long n) {
  constexpr bool kCross = W > 32 * V;
  constexpr int kCrossWords = kCross ? 2 * kThreads * V : 4;
  constexpr int kStageWords = kVec ? kThreads / 32 * 36 * V : 4;
  __shared__ __align__(16) unsigned s[kCrossWords > kStageWords
                                          ? kCrossWords : kStageWords];
  const int lane = threadIdx.x & 31;
  const int e0 = threadIdx.x * V;
  const long long g = static_cast<long long>(blockIdx.x) * kThreads * V + e0;
  const long long seg = g - lane * V;     // the warp's first element
  unsigned* st = s + (threadIdx.x >> 5) * 36 * V;   // its staging area
  unsigned v[V];
  if constexpr (kVec) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const long long e = seg + 128 * i + 4 * lane;
      uint4 u = make_uint4(kFull, kFull, kFull, kFull);
      if (e < n) u = *reinterpret_cast<const uint4*>(x + e);
      *reinterpret_cast<uint4*>(st + padded(128 * i + 4 * lane)) = u;
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < V; q += 4) {
      const uint4 u =
          *reinterpret_cast<const uint4*>(st + padded(V * lane + q));
      v[q] = u.x;
      v[q + 1] = u.y;
      v[q + 2] = u.z;
      v[q + 3] = u.w;
    }
    if constexpr (kCross) __syncthreads();
  } else {
#pragma unroll
    for (int q = 0; q < V; ++q) v[q] = g + q < n ? x[g + q] : kFull;
  }
  int buf = 0;
  merges<V, W, 2>(v, lane, s, buf, e0);
  if constexpr (kVec) {
    if constexpr (kCross) __syncthreads();
#pragma unroll
    for (int q = 0; q < V; q += 4) {
      *reinterpret_cast<uint4*>(st + padded(V * lane + q)) =
          make_uint4(v[q], v[q + 1], v[q + 2], v[q + 3]);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const long long e = seg + 128 * i + 4 * lane;
      if (e < n) {
        *reinterpret_cast<uint4*>(out + e) =
            *reinterpret_cast<const uint4*>(st + padded(128 * i + 4 * lane));
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < V; ++q) {
      if (g + q < n) out[g + q] = v[q];
    }
  }
}

template <int W>
int launch(const void* x, void* out, long long n, bool vec,
           cudaStream_t stream) {
  constexpr long long kPerBlock = static_cast<long long>(kThreads) * kValues;
  const unsigned blocks =
      static_cast<unsigned>((n + kPerBlock - 1) / kPerBlock);
  const unsigned* xi = static_cast<const unsigned*>(x);
  unsigned* o = static_cast<unsigned*>(out);
  if (vec) {
    fori_sort_net_kernel<kValues, W, true>
        <<<blocks, kThreads, 0, stream>>>(xi, o, n);
  } else {
    fori_sort_net_kernel<kValues, W, false>
        <<<blocks, kThreads, 0, stream>>>(xi, o, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// w must be a power of two in 2..1024 (the wrapper checks; another w
// returns cudaErrorInvalidValue).  Launches on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int probe_fori_sort_net_launch(const void* x, void* out, int rows,
                                          int w, void* stream) {
  if (rows <= 0) return 0;
  const long long n = static_cast<long long>(rows) * w;
  const bool vec = w >= 4 && ((reinterpret_cast<std::uintptr_t>(x) |
                               reinterpret_cast<std::uintptr_t>(out)) &
                              15) == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (w) {
    case 2: return launch<2>(x, out, n, false, st);
    case 4: return launch<4>(x, out, n, vec, st);
    case 8: return launch<8>(x, out, n, vec, st);
    case 16: return launch<16>(x, out, n, vec, st);
    case 32: return launch<32>(x, out, n, vec, st);
    case 64: return launch<64>(x, out, n, vec, st);
    case 128: return launch<128>(x, out, n, vec, st);
    case 256: return launch<256>(x, out, n, vec, st);
    case 512: return launch<512>(x, out, n, vec, st);
    case 1024: return launch<1024>(x, out, n, vec, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
