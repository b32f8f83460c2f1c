// Reverse-complement expand of the 1-bit k-mer table, in place, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package ORs the reverse-complement bits
// into the table in host numpy (dbg_assembly_tpu/kmer/count.py
// expand_bitmap_rc), before the table goes to the device.  The port runs
// that step here, on the words already uploaded
// (dbg_assembly_tpu_torch/correct/pipeline.py), so that the host does not
// scan and copy 4^k/8 bytes (2 GiB at k = 17) before correction starts.
//
// Input:  words [n] 32-bit, the packed table as little-endian words
//         (correct/device.py bitmap_device), n = 4^k / 32, k in 3..31.
//         Bit p of word w is table bit 32w + (p ^ 7): byte p >> 3 of the
//         word, bits MSB-first within the byte (correct/device.py
//         _word_bit, the layout get_freq reads).
// Output: the same words, with the bit of revcomp(i) set for every bit i
//         that was set (main_parallel_senior.cpp:310-329).
//
// In place, with no second buffer.  Bits are only ever added, so every
// thread reads at least the bits that were set at launch, and each of them
// is expanded by the thread that owns its word.  A thread may also read a
// bit another thread has just added: that bit is revcomp(j) of a bit j set
// at launch, and its own reverse complement is revcomp(revcomp(j)) = j,
// which is already set, so the OR it makes changes nothing.  The result is
// therefore the same whatever the order the threads run in.
//
// Bound: device-memory bytes.  The table is read once (4^k/8 bytes, 0.64 ms
// at 3.35 TB/s for k = 17) and each set bit costs one atomic OR to a word
// that is, for a sparse table, anywhere in it (a few million at k = 17).
// On the H100 the atomics, not the scan, set the time: at k = 17 with 6 M
// bits set the scan alone took 0.69-0.70 ms, the whole kernel 1.42-1.62
// (PERF.md section 6).  Design: a grid of four times the card's resident
// blocks (1.42-1.45 ms; once 1.62, twice 1.46-1.51; four loads in flight a
// thread gained nothing) strides over the table 16 bytes (a uint4) a
// thread a step, neighbouring threads on neighbouring addresses, with
// streaming loads that do not keep the scanned lines in L2 (the atomics'
// targets stay there).  A thread skips an all-zero uint4 at once -- most
// of a k = 17 table -- and for each set bit of a nonzero word rebuilds its
// index, takes the 2k-bit reverse complement with the 64-bit bit-parallel
// cascade (dna.py revcomp_kbit) and atomicOr's the target bit into its
// word.  Indices are 64-bit throughout, so that k = 18
// and 19 (4^k/8 = 8 and 32 GiB) stay exact.  A table whose address is not
// 16-byte aligned, and the n % 4 tail, go one word a step.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 32;  // four times the 2048 resident threads

// The 2k-bit reverse complement of x: complement, reverse the 32 two-bit
// groups of the 64-bit word, drop the 64 - 2k low bits (the high bits'
// complement, moved down).
__device__ __forceinline__ unsigned long long revcomp(unsigned long long x,
                                                      int k) {
  x = ~x;
  x = ((x & 0x3333333333333333ULL) << 2) | ((x >> 2) & 0x3333333333333333ULL);
  x = ((x & 0x0F0F0F0F0F0F0F0FULL) << 4) | ((x >> 4) & 0x0F0F0F0F0F0F0F0FULL);
  x = ((x & 0x00FF00FF00FF00FFULL) << 8) | ((x >> 8) & 0x00FF00FF00FF00FFULL);
  x = ((x & 0x0000FFFF0000FFFFULL) << 16) |
      ((x >> 16) & 0x0000FFFF0000FFFFULL);
  x = (x << 32) | (x >> 32);
  return x >> (64 - 2 * k);
}

// ORs into the table the reverse complement of each set bit of v, the
// value read from word w.
__device__ __forceinline__ void expand_word(unsigned* words,
                                            unsigned long long w, unsigned v,
                                            int k) {
  while (v != 0) {
    const unsigned p = __ffs(v) - 1;
    v &= v - 1;
    const unsigned long long rc = revcomp((w << 5) | (p ^ 7u), k);
    atomicOr(words + (rc >> 5), 1u << ((rc & 31) ^ 7u));
  }
}

// uint4 i < n4 a step, then word 4 * n4 + t < n (the tail, or with n4 = 0
// every word), each strided over the grid.
__global__ void __launch_bounds__(kThreads)
    rc_expand_kernel(unsigned* words, long long n, long long n4, int k) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t0 =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const uint4* vec = reinterpret_cast<const uint4*>(words);
  for (long long i = t0; i < n4; i += stride) {
    const uint4 v = __ldcs(vec + i);
    if ((v.x | v.y | v.z | v.w) == 0) continue;
    const unsigned long long w = 4ULL * i;
    expand_word(words, w, v.x, k);
    expand_word(words, w + 1, v.y, k);
    expand_word(words, w + 2, v.z, k);
    expand_word(words, w + 3, v.w, k);
  }
  for (long long t = 4 * n4 + t0; t < n; t += stride) {
    const unsigned v = words[t];
    if (v != 0) expand_word(words, t, v, k);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).  n must
// be 4^k / 32 (the wrapper checks it).
extern "C" int rc_expand_launch(void* words, long long n, int k,
                                void* stream) {
  if (n <= 0) return 0;
  if (k < 3 || k > 31) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = (reinterpret_cast<std::uintptr_t>(words) & 15) == 0;
  const long long n4 = aligned ? n / 4 : 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items = n4 > 0 ? n4 : n;
  const long long blocks = std::min<long long>(
      (items + kThreads - 1) / kThreads,
      static_cast<long long>(sms) * kBlocksPerSm);
  rc_expand_kernel<<<static_cast<int>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned*>(words), n, n4, k);
  return static_cast<int>(cudaGetLastError());
}
