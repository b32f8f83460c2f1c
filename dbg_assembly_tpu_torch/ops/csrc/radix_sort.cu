// Stable one-sweep LSD radix sort of int64 keys, with an optional int64
// index, for Hopper (sm_90a).
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
// Design: a one-sweep LSD sort after Adinets and Merrill, "Onesweep: A
// Faster Least Significant Digit Radix Sort for GPUs" (2022), with 8-bit
// digits, passes = ceil(key_bits / 8) (5 at k = 17, 8 at k = 31):
//   0. one cudaMemsetAsync zeroes the scratch (histograms, tile counters,
//      look-back status);
//   1. hist_kernel (one launch): every key is read once, and each block
//      counts the digits of all passes in shared memory and adds them to
//      the passes x 256 global counters (counts do not depend on order, so
//      atomics are fine here);
//   2. scan_kernel (one launch, a block a pass): each histogram becomes
//      the exclusive start of each digit;
//   3. onesweep_kernel (one launch a pass), per tile of kTile keys:
//      - the block takes its tile number from the pass's atomic counter, so
//        a tile only ever waits on tiles whose blocks already run: the
//        look-back cannot deadlock;
//      - each warp loads its run of 32 x kItems keys warp-striped (lane l
//        reads item j at j * 32 + l: coalesced, kItems loads in flight a
//        thread);
//      - early counts: the tile's digit histogram (shared-memory atomics,
//        order-free), and thread d publishes the tile's count of digit d
//        (flag "aggregate") before the ranking, so later tiles' look-backs
//        find it sooner;
//      - each warp ranks its keys in input order: for item j, the lanes
//        with the same digit (__match_any_sync) and __popc of those below,
//        on top of the warp's running count of that digit.  Per-warp counts
//        are then prefixed across warps and digits.  No atomic decides a
//        position, so equal keys keep their input order on every run;
//      - decoupled look-back: thread d walks back over earlier tiles' status
//        words (a few at a time for keys only) until one holds an inclusive
//        prefix, and publishes its own (flag "inclusive").  Words are 64
//        bits: the value (< 2^31) in the low 32, the flag in bit 32, the
//        pass number + 1 above, so one zeroing serves every pass and a word
//        left by the previous pass reads as not ready.  Each tile's prefix
//        is exactly the sum of earlier tiles' counts: positions are
//        deterministic;
//      - each key goes to its tile-local sorted slot in shared memory, then
//        thread t copies slots t, t + kThreads, ... to digit_start[d] +
//        prefix[d] + slot - tile_start[d]: consecutive threads write
//        consecutive addresses within a digit run.  The index follows in a
//        second round through the same buffer (the first pass writes the
//        position itself, as no index exists yet).
// Launches per sort: passes + 2.  Passes ping-pong between two buffers the
// wrapper allocates; the result is in buffer (passes - 1) & 1.
//
// Bound: device-memory traffic.  The least an 8-bit LSD sort moves is one
// read of the keys for the histograms plus, per pass, one read and one
// write of each key (16 B a key) and of the index (16 B more); this design
// moves just that, plus the look-back words (8 B a digit a tile) and the
// partial sectors at the ends of each digit run.  What holds it back on the
// card is the look-back: a tile waits on a chain of dependent L2 reads of
// its predecessors' words.  Three blocks an SM (80 registers a thread)
// keep other tiles' loads and stores going meanwhile.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;        // = number of digit values
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;           // keys a thread ranks
constexpr int kTile = kThreads * kItems;
constexpr int kDigitBits = 8;
constexpr int kDigits = 1 << kDigitBits;
constexpr int kMaxPasses = 8;        // 63 bits / 8
constexpr int kBlocksPerSM = 3;      // onesweep blocks resident on an SM
constexpr int kHistItems = 128;      // keys a thread counts
constexpr long long kHistBlockKeys =
    static_cast<long long>(kThreads) * kHistItems;

static_assert(kThreads == kDigits, "one thread per digit value");

using u64 = unsigned long long;

// Scratch layout, zeroed once per sort: hist[kMaxPasses][kDigits] u32,
// tile_counter[kMaxPasses] u32, status[n_tiles][kDigits] u64.
constexpr long long kHistWords = static_cast<long long>(kMaxPasses) * kDigits;
constexpr long long kStatusOffset = (kHistWords + kMaxPasses) * 4;
static_assert(kStatusOffset % 8 == 0, "status words are 8-byte aligned");

constexpr u64 kInclusive = 1ull << 32;

__device__ __forceinline__ unsigned digit_of(u64 key, int shift,
                                             unsigned mask) {
  return static_cast<unsigned>(key >> shift) & mask;
}

__device__ __forceinline__ unsigned digit_mask(int key_bits, int shift) {
  const int bits = key_bits - shift < kDigitBits ? key_bits - shift
                                                 : kDigitBits;
  return (1u << bits) - 1u;
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

// Block b counts keys [b * kHistBlockKeys, (b + 1) * kHistBlockKeys) into
// hist[p][digit] for every pass p.
__global__ void __launch_bounds__(kThreads)
    hist_kernel(const u64* __restrict__ keys, long long n, int key_bits,
                int passes, unsigned* __restrict__ hist) {
  __shared__ unsigned h[kMaxPasses * kDigits];
  for (int j = threadIdx.x; j < kMaxPasses * kDigits; j += kThreads) h[j] = 0;
  __syncthreads();
  const long long start = static_cast<long long>(blockIdx.x) * kHistBlockKeys;
  const long long end = start + kHistBlockKeys < n ? start + kHistBlockKeys
                                                   : n;
  constexpr int kUnroll = 4;
  for (long long i0 = start + threadIdx.x; i0 < end;
       i0 += kUnroll * kThreads) {
    u64 k[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * kThreads;
      k[u] = i < end ? keys[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i0 + u * kThreads >= end) break;
      for (int p = 0; p < passes; ++p) {
        const int shift = p * kDigitBits;
        atomicAdd(&h[p * kDigits +
                     digit_of(k[u], shift, digit_mask(key_bits, shift))],
                  1u);
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < passes * kDigits; j += kThreads) {
    if (h[j] != 0) atomicAdd(&hist[j], h[j]);
  }
}

// Block p: hist[p][*] becomes the exclusive start of each digit, in place.
__global__ void scan_kernel(unsigned* __restrict__ hist) {
  __shared__ unsigned warp_sums[kWarps];
  unsigned* row = hist + static_cast<long long>(blockIdx.x) * kDigits;
  const unsigned v = row[threadIdx.x];
  unsigned total;
  const unsigned incl = block_scan<kThreads>(v, warp_sums, total);
  row[threadIdx.x] = incl - v;
}

__device__ __forceinline__ void publish(u64* word, u64 value) {
  *reinterpret_cast<volatile u64*>(word) = value;
}

__device__ __forceinline__ u64 peek(const u64* word) {
  return *reinterpret_cast<const volatile u64*>(word);
}

// One pass over the digit at `shift` (mask `mask`).  kIndex: also move the
// index; kIota: the index source is the position itself (first pass), so
// idx_in is not read.  `tag` is the pass number + 1.
template <bool kIndex, bool kIota>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    onesweep_kernel(const u64* __restrict__ keys_in,
                    const long long* __restrict__ idx_in,
                    u64* __restrict__ keys_out,
                    long long* __restrict__ idx_out, long long n, int shift,
                    unsigned mask, unsigned tag,
                    const unsigned* __restrict__ digit_start,
                    unsigned* __restrict__ tile_counter,
                    u64* __restrict__ status) {
  __shared__ u64 stage[kTile];                 // keys, then the index
  __shared__ unsigned warp_count[kWarps][kDigits];
  __shared__ unsigned tile_count[kDigits];     // keys of each digit
  __shared__ unsigned tile_start[kDigits];     // first tile slot of a digit
  __shared__ long long out_delta[kDigits];     // global slot - tile slot
  __shared__ unsigned warp_sums[kWarps];
  __shared__ unsigned tile_shared;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;

  if (t == 0) tile_shared = atomicAdd(tile_counter, 1u);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) warp_count[w][t] = 0;
  tile_count[t] = 0;
  __syncthreads();
  const unsigned tile = tile_shared;
  const long long tile_base = static_cast<long long>(tile) * kTile;
  const long long warp_base = tile_base + warp * (32 * kItems) + lane;

  // 1. load warp-striped
  u64 key[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = warp_base + j * 32;
    key[j] = i < n ? keys_in[i] : 0;
  }

  // 2. early counts: the tile's digit histogram, so that its aggregate is
  //    out before the ranking and later tiles' look-backs wait less
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (warp_base + j * 32 < n) {
      atomicAdd(&tile_count[digit_of(key[j], shift, mask)], 1u);
    }
  }
  __syncthreads();
  const unsigned count = tile_count[t];
  const u64 ready = static_cast<u64>(tag) << 33;
  u64* mine = status + static_cast<long long>(tile) * kDigits + t;
  publish(mine, ready | (tile == 0 ? kInclusive : 0) | count);

  // 3. rank each key within its warp in input order
  unsigned slot[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    // lanes past the end share a digit no key has
    const unsigned d =
        warp_base + j * 32 < n ? digit_of(key[j], shift, mask) : kDigits;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const unsigned before = d < kDigits ? warp_count[warp][d] : 0u;
    __syncwarp();
    if (d < kDigits && (peers & lanes_below) == 0) {
      warp_count[warp][d] = before + __popc(peers);
    }
    __syncwarp();
    slot[j] = before + __popc(peers & lanes_below);
  }
  __syncthreads();

  // 4. thread t = digit t: earlier warps' counts and the digit's first slot
  //    in the tile
  unsigned below = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned c = warp_count[w][t];
    warp_count[w][t] = below;
    below += c;
  }
  unsigned tile_keys;
  const unsigned incl = block_scan<kThreads>(count, warp_sums, tile_keys);
  tile_start[t] = incl - count;

  // 5. decoupled look-back: keys of digit t in earlier tiles
  u64 prefix = 0;
  if (tile != 0) {
    // read a window of kLookback predecessors at once; sum from the nearest
    // until an inclusive prefix, and go on past the ready ones.  Four words
    // cut the keys-only sort's time on the card; with the index, the
    // registers they take cost more than the round trips they save
    constexpr int kLookback = kIndex ? 1 : 4;
    long long j = static_cast<long long>(tile) - 1;
    for (bool done = false; !done;) {
      u64 s[kLookback];
#pragma unroll
      for (int k = 0; k < kLookback; ++k) {
        s[k] = j - k >= 0 ? peek(status + (j - k) * kDigits + t) : 0;
      }
      bool stop = false;
#pragma unroll
      for (int k = 0; k < kLookback; ++k) {
        // a word not ready (or before tile 0) ends this step
        stop = stop || (s[k] >> 33) != tag;
        if (!stop) {
          prefix += s[k] & 0xffffffffull;
          --j;
          done = (s[k] & kInclusive) != 0;
          stop = done;
        }
      }
    }
    publish(mine, ready | kInclusive | (prefix + count));
  }
  out_delta[t] = static_cast<long long>(digit_start[t]) +
                 static_cast<long long>(prefix) - tile_start[t];
  __syncthreads();

  // 6. keys to their tile slots, then out in slot order
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (warp_base + j * 32 < n) {
      const unsigned d = digit_of(key[j], shift, mask);
      slot[j] += tile_start[d] + warp_count[warp][d];
      stage[slot[j]] = key[j];
    }
  }
  __syncthreads();
  const int tile_n = n - tile_base < kTile ? static_cast<int>(n - tile_base)
                                           : kTile;
  int dst[kItems];                              // n < 2^31
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int s = j * kThreads + t;
    if (s < tile_n) {
      const u64 k = stage[s];
      dst[j] = static_cast<int>(out_delta[digit_of(k, shift, mask)] + s);
      keys_out[dst[j]] = k;
    }
  }
  if (!kIndex) return;

  // 7. the index, the same way through the same buffer
  __syncthreads();                              // every key read out
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = warp_base + j * 32;
    if (i < n) stage[slot[j]] = static_cast<u64>(kIota ? i : idx_in[i]);
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int s = j * kThreads + t;
    if (s < tile_n) idx_out[dst[j]] = static_cast<long long>(stage[s]);
  }
}

}  // namespace

// Keys per onesweep tile.
extern "C" int radix_sort_tile() { return kTile; }

// Bytes of scratch radix_sort_launch needs for n keys.
extern "C" long long radix_sort_scratch_bytes(long long n) {
  const long long n_tiles = (n + kTile - 1) / kTile;
  return kStatusOffset + n_tiles * kDigits * 8;
}

// Sorts keys_in[0, n) (n < 2^31) by their low key_bits bits (1..63) on
// `stream`.  keys_a/keys_b: two n-key buffers; idx_a/idx_b: two n-entry
// int64 buffers, or both null for keys only; scratch:
// radix_sort_scratch_bytes(n) bytes, 8-byte aligned.  keys_in is only read.
// The result is in buffer (ceil(key_bits / 8) - 1) & 1 (a for an odd pass
// count).  Returns the CUDA error of the first failing call, 0 on success.
extern "C" int radix_sort_launch(const void* keys_in, long long n,
                                 int key_bits, void* keys_a, void* keys_b,
                                 void* idx_a, void* idx_b, void* scratch,
                                 void* stream) {
  if (n <= 0) return 0;
  if (key_bits < 1 || key_bits > 63 || n >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = static_cast<int>((n + kTile - 1) / kTile);
  const int passes = (key_bits + kDigitBits - 1) / kDigitBits;
  auto* hist = static_cast<unsigned*>(scratch);
  unsigned* tile_counter = hist + kHistWords;
  auto* status = reinterpret_cast<u64*>(static_cast<char*>(scratch) +
                                        kStatusOffset);
  const auto* src0 = static_cast<const u64*>(keys_in);
  u64* kbuf[2] = {static_cast<u64*>(keys_a), static_cast<u64*>(keys_b)};
  long long* ibuf[2] = {static_cast<long long*>(idx_a),
                        static_cast<long long*>(idx_b)};
  const bool with_index = idx_a != nullptr;

  cudaError_t err = cudaMemsetAsync(scratch, 0,
                                    radix_sort_scratch_bytes(n), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hist_blocks =
      static_cast<int>((n + kHistBlockKeys - 1) / kHistBlockKeys);
  hist_kernel<<<hist_blocks, kThreads, 0, st>>>(src0, n, key_bits, passes,
                                                hist);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_kernel<<<passes, kThreads, 0, st>>>(hist);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  for (int p = 0; p < passes; ++p) {
    const int shift = p * kDigitBits;
    const int bits = key_bits - shift < kDigitBits ? key_bits - shift
                                                   : kDigitBits;
    const unsigned mask = (1u << bits) - 1u;
    const unsigned tag = static_cast<unsigned>(p + 1);
    const u64* src = p == 0 ? src0 : kbuf[(p - 1) & 1];
    u64* dst = kbuf[p & 1];
    const unsigned* start = hist + p * kDigits;
    if (!with_index) {
      onesweep_kernel<false, false><<<n_tiles, kThreads, 0, st>>>(
          src, nullptr, dst, nullptr, n, shift, mask, tag, start,
          tile_counter + p, status);
    } else if (p == 0) {
      onesweep_kernel<true, true><<<n_tiles, kThreads, 0, st>>>(
          src, nullptr, dst, ibuf[0], n, shift, mask, tag, start,
          tile_counter + p, status);
    } else {
      onesweep_kernel<true, false><<<n_tiles, kThreads, 0, st>>>(
          src, ibuf[(p - 1) & 1], dst, ibuf[p & 1], n, shift, mask, tag,
          start, tile_counter + p, status);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
