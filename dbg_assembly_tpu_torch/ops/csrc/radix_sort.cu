// Stable LSD radix sort of int64 keys, with an optional int64 index, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel sort_pairs / sort_u64_via_pallas
// (dbg_assembly_tpu/ops/pallas_sort.py:194 / :236; tile kernels
// _tile_sort_kernel :100 and _intra_merge_kernel :130, launched by
// _run_tile_kernel :150).  That kernel is a bitonic network over
// sign-biased (hi, lo) u32 planes padded to 2^p, shaped by the TPU's 32-bit
// lanes and VMEM tiles; none of that is carried over.  What it computes is
// kept: the keys in ascending order.  This sort is also stable, and can
// return the permutation (what torch.sort(stable=True).indices gives),
// which graph ingest needs for each node's first occurrence.
//
// Keys: n int64 values, each in [0, 2^key_bits) or INT64_MAX (the
// sentinel).  The sort orders by the low key_bits bits, read as unsigned;
// callers whose keys can hold the sentinel pass key_bits = 2k + 1, so the
// sentinel's low bits (all ones) order it after every k-mer (< 2^2k).
//
// Per pass (8-bit digits, ceil(key_bits / 8) passes; 5 at k = 17, 8 at
// k = 31):
//   1. hist_kernel: each block counts the digits of its tile of kTile keys
//      in shared memory and writes counts[digit * n_blocks + block];
//   2. scan_kernel: one block per digit turns its row of counts into an
//      exclusive prefix and writes the digit's total;
//   3. scatter_kernel: each block scans the 256 digit totals, then walks its
//      tile in order, 256 keys at a time.  A key's destination is its
//      digit's offset + the keys of that digit in earlier 256-key chunks of
//      the tile + those in earlier warps of this chunk + its rank among the
//      lanes of its warp with the same digit (__match_any_sync).  No
//      atomic decides a rank, so equal keys keep their input order, the
//      same on every run.
// Passes ping-pong between two buffers the wrapper allocates; the result is
// in buffer (passes - 1) & 1.
//
// Bound: device-memory traffic.  A pass reads the keys twice (histogram,
// scatter) and writes them once, plus a read and a write of the index: 24 B
// a key without the index, 40 B with it.  This first version scatters
// straight to device memory (a warp's 32 writes land in up to 32 places);
// staging the tile in shared memory for coalesced writes, and a one-sweep
// decoupled look-back scan, are the next steps.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;        // = number of digit values
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;           // 256-key chunks per block tile
constexpr int kTile = kThreads * kItems;
constexpr int kScanThreads = 1024;
constexpr int kDigitBits = 8;
constexpr int kDigits = 1 << kDigitBits;

static_assert(kThreads == kDigits, "one thread per digit value");

using u64 = unsigned long long;

__device__ __forceinline__ unsigned digit_of(u64 key, int shift,
                                             unsigned mask) {
  return static_cast<unsigned>(key >> shift) & mask;
}

// Inclusive scan of v over a block of NT threads (a multiple of 32, at most
// 1024); warp_sums holds NT / 32 values.  `total` receives the block's sum.
// Every thread must call it; it leaves warp_sums free for the next call.
template <int NT>
__device__ __forceinline__ unsigned block_scan(unsigned v, unsigned* warp_sums,
                                               unsigned& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    unsigned w = lane < NT / 32 ? warp_sums[lane] : 0u;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned u = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += u;
    }
    if (lane < NT / 32) warp_sums[lane] = w;      // inclusive over warps
  }
  __syncthreads();
  if (warp > 0) v += warp_sums[warp - 1];
  total = warp_sums[NT / 32 - 1];
  __syncthreads();
  return v;
}

__global__ void hist_kernel(const u64* __restrict__ keys, long long n,
                            int shift, unsigned mask,
                            unsigned* __restrict__ counts, int n_blocks) {
  __shared__ unsigned h[kDigits];
  h[threadIdx.x] = 0;
  __syncthreads();
  const long long start = static_cast<long long>(blockIdx.x) * kTile;
#pragma unroll 4
  for (int c = 0; c < kItems; ++c) {
    const long long i = start + c * kThreads + threadIdx.x;
    if (i < n) atomicAdd(&h[digit_of(keys[i], shift, mask)], 1u);
  }
  __syncthreads();
  counts[static_cast<long long>(threadIdx.x) * n_blocks + blockIdx.x] =
      h[threadIdx.x];
}

// Block d: exclusive prefix of counts[d * n_blocks, (d + 1) * n_blocks) in
// place; totals[d] = the number of keys with digit d.
__global__ void scan_kernel(unsigned* __restrict__ counts, int n_blocks,
                            unsigned* __restrict__ totals) {
  __shared__ unsigned warp_sums[kScanThreads / 32];
  unsigned* row = counts + static_cast<long long>(blockIdx.x) * n_blocks;
  unsigned carry = 0;
  for (int base = 0; base < n_blocks; base += kScanThreads) {
    const int j = base + threadIdx.x;
    const unsigned v = j < n_blocks ? row[j] : 0u;
    unsigned chunk_total;
    const unsigned incl =
        block_scan<kScanThreads>(v, warp_sums, chunk_total);
    if (j < n_blocks) row[j] = carry + incl - v;
    carry += chunk_total;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// kIndex: also move the index; kIota: the index source is the position
// itself (first pass), so idx_in is not read.
template <bool kIndex, bool kIota>
__global__ void scatter_kernel(const u64* __restrict__ keys_in,
                               const long long* __restrict__ idx_in,
                               u64* __restrict__ keys_out,
                               long long* __restrict__ idx_out, long long n,
                               int shift, unsigned mask,
                               const unsigned* __restrict__ counts,
                               const unsigned* __restrict__ totals,
                               int n_blocks) {
  __shared__ unsigned warp_sums[kWarps];
  __shared__ unsigned base[kDigits];            // next slot of each digit
  __shared__ unsigned whist[kWarps][kDigits];   // per-warp digit counts
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;

  unsigned all_keys;
  const unsigned tot = totals[t];
  const unsigned incl = block_scan<kThreads>(tot, warp_sums, all_keys);
  base[t] = incl - tot +
            counts[static_cast<long long>(t) * n_blocks + blockIdx.x];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) whist[w][t] = 0;
  __syncthreads();

  const long long start = static_cast<long long>(blockIdx.x) * kTile;
  for (int c = 0; c < kItems; ++c) {
    const long long chunk = start + static_cast<long long>(c) * kThreads;
    if (chunk >= n) break;                      // the same for every thread
    const long long i = chunk + t;
    const bool valid = i < n;
    u64 key = 0;
    unsigned d = kDigits;     // lanes past the end share a digit no key has
    if (valid) {
      key = keys_in[i];
      d = digit_of(key, shift, mask);
    }
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const unsigned rank = __popc(peers & lanes_below);
    if (valid && rank == 0) whist[warp][d] = __popc(peers);
    __syncthreads();
    if (valid) {
      unsigned pos = base[d] + rank;
      for (int w = 0; w < warp; ++w) pos += whist[w][d];
      keys_out[pos] = key;
      if (kIndex) idx_out[pos] = kIota ? i : idx_in[i];
    }
    __syncthreads();
    unsigned s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      s += whist[w][t];
      whist[w][t] = 0;
    }
    base[t] += s;
    __syncthreads();
  }
}

}  // namespace

// Keys per block tile: the wrapper sizes `counts` as 256 * ceil(n / tile).
extern "C" int radix_sort_tile() { return kTile; }

// Sorts keys_in[0, n) by their low key_bits bits (1..63) on `stream`.
// keys_a/keys_b: two n-key buffers; idx_a/idx_b: two n-entry int64 buffers,
// or both null for keys only; counts: 256 * ceil(n / tile) uint32; totals:
// 256 uint32.  keys_in is only read.  The result is in buffer
// (ceil(key_bits / 8) - 1) & 1 (a for an odd pass count).  Returns
// cudaGetLastError() after the first failing launch, 0 on success.
extern "C" int radix_sort_launch(const void* keys_in, long long n,
                                 int key_bits, void* keys_a, void* keys_b,
                                 void* idx_a, void* idx_b, void* counts,
                                 void* totals, void* stream) {
  if (n <= 0) return 0;
  if (key_bits < 1 || key_bits > 63) return static_cast<int>(
      cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_blocks = static_cast<int>((n + kTile - 1) / kTile);
  const int passes = (key_bits + kDigitBits - 1) / kDigitBits;
  auto* cnt = static_cast<unsigned*>(counts);
  auto* tot = static_cast<unsigned*>(totals);
  u64* kbuf[2] = {static_cast<u64*>(keys_a), static_cast<u64*>(keys_b)};
  long long* ibuf[2] = {static_cast<long long*>(idx_a),
                        static_cast<long long*>(idx_b)};
  const bool with_index = idx_a != nullptr;
  for (int p = 0; p < passes; ++p) {
    const int shift = p * kDigitBits;
    const int bits = key_bits - shift < kDigitBits ? key_bits - shift
                                                   : kDigitBits;
    const unsigned mask = (1u << bits) - 1u;
    const u64* src = p == 0 ? static_cast<const u64*>(keys_in)
                            : kbuf[(p - 1) & 1];
    u64* dst = kbuf[p & 1];
    hist_kernel<<<n_blocks, kThreads, 0, st>>>(src, n, shift, mask, cnt,
                                               n_blocks);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    scan_kernel<<<kDigits, kScanThreads, 0, st>>>(cnt, n_blocks, tot);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!with_index) {
      scatter_kernel<false, false><<<n_blocks, kThreads, 0, st>>>(
          src, nullptr, dst, nullptr, n, shift, mask, cnt, tot, n_blocks);
    } else if (p == 0) {
      scatter_kernel<true, true><<<n_blocks, kThreads, 0, st>>>(
          src, nullptr, dst, ibuf[0], n, shift, mask, cnt, tot, n_blocks);
    } else {
      scatter_kernel<true, false><<<n_blocks, kThreads, 0, st>>>(
          src, ibuf[(p - 1) & 1], dst, ibuf[p & 1], n, shift, mask, cnt,
          tot, n_blocks);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
