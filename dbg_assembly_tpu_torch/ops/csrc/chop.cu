// Canonical k-mer chop for Hopper (sm_90a), with optional neighbour codes.
//
// Replaces the TPU kernel chop_canonical_pallas / _chop_kernel
// (dbg_assembly_tpu/ops/pallas_chop.py:81 / :44) and the XLA chop around it
// in dbg_assembly_tpu/contig/graph.py:48 (_chop_with_edges).  One kernel
// serves counting (edges off) and graph ingest (edges on).
//
// Input:  codes [N, L] uint8 (0..3 inside a read, pad 4 past its length),
//         lengths [N] int32, k in 1..31.
// Output: kmers [N, P] int64, P = L - k + 1, row-major: the canonical k-mer
//         (forward strand when fwd <= rc, DBGgraph.cpp:80) at windows
//         j < len - k + 1, INT64_MAX elsewhere (sorts last, as the JAX
//         all-ones sentinel).  With edges: left/right [N, P] uint8, the
//         strand-adjusted neighbour codes 0..3, 4 at a read edge and at
//         invalid windows.  A neighbour base past the row (a read longer
//         than L) reads as code 0.  A code >= 4 inside a read is read as its
//         low two bits.
//
// Bound: device-memory bytes.  Each window writes 8 bytes of k-mer (+2 of
// edge codes) against about 1 byte of codes read.  Design:
//   * Tiles.  A tile is R whole rows (one span of R*L code bytes in, one
//     span of R*P windows out) or, for rows too long for 48 KB of shared
//     memory, a segment of PW windows of one row.  The host picks R and PW
//     (ops/chop.py tile_plan).  A grid of the card's resident blocks walks
//     the tiles.
//   * Loads in flight.  Each tile's codes and lengths arrive in shared
//     memory by cp.async (16 bytes a copy, bytes at an unaligned head or
//     tail), double-buffered: the next tile's copies are issued before this
//     tile's work starts.
//   * O(1) work a window.  The tile's codes are packed to 2 bits a base,
//     32 bases a 64-bit word, first base highest.  A window's forward
//     k-mer is a funnel shift of two words; its reverse complement is
//     ~fwd with the 2-bit groups reversed (__brevll, then a swap of the
//     bits in each pair), shifted down by 64 - 2k -- the Pallas kernel's
//     bit-parallel idea (pallas_chop.py:34-41, :63-74), not k steps.
//   * Stores.  Neighbouring threads take neighbouring windows of the
//     tile's contiguous output span and store each result as it is
//     computed: a warp writes 256 contiguous bytes of k-mers and 32 of each
//     edge array, whole sectors, sentinels and 4/4 codes included.  On the
//     H100 this beat staging the tile's outputs in shared memory for 16-byte
//     stores (the staging pass and its barrier left the stores in bursts),
//     two windows a thread with 16-byte stores, and streaming stores in
//     edge mode (PERF.md, section 6).

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned long long kSentinel = 0x7FFFFFFFFFFFFFFFULL;

__host__ __device__ constexpr long long round16(long long x) {
  return (x + 15) & ~15LL;
}

// Shared-memory layout of a block, in bytes; every part starts 16-aligned.
struct Layout {
  int raw;    // one code buffer: a span's bytes at their address mod 16
  int lens;   // one lengths buffer
  int pk;     // packed codes, 64-bit words
  int total;  // two code buffers, two lengths buffers, the packed codes

  __host__ __device__ Layout(int rows, int pw, int L, int k) {
    const long long span = pw == L - k + 1 ? 1LL * rows * L : pw + k + 1;
    raw = static_cast<int>(round16(span + 15) + 16);
    lens = static_cast<int>(round16(4LL * rows));
    pk = static_cast<int>(round16(raw / 4 + 16));  // raw / 32 words, + 2
    total = 2 * raw + 2 * lens + pk;
  }
};

// What one tile covers: rows [row0, row0 + nr), windows [j0, j0 + nwin) of
// each; its codes are the bytes [g0, g0 + span) of the codes array, and
// base j of row row0 + r lies at span offset r * L + j - js.
struct Tile {
  long long row0, g0;
  int nr, j0, nwin, js, span;
};

__device__ __forceinline__ Tile tile_at(long long t, long long n_rows, int L,
                                        int k, int rows, int pw) {
  const int P = L - k + 1;
  Tile tl;
  if (pw == P) {
    tl.row0 = t * rows;
    tl.nr = static_cast<int>(min(static_cast<long long>(rows),
                                 n_rows - tl.row0));
    tl.j0 = 0;
    tl.nwin = P;
    tl.js = 0;
    tl.span = tl.nr * L;
  } else {
    const long long segs = (P + pw - 1) / pw;
    tl.row0 = t / segs;
    tl.nr = 1;
    tl.j0 = static_cast<int>(t - tl.row0 * segs) * pw;
    tl.nwin = min(pw, P - tl.j0);
    tl.js = max(tl.j0 - 1, 0);
    tl.span = min(L, tl.j0 + tl.nwin + k) - tl.js;
  }
  tl.g0 = tl.row0 * L + tl.js;
  return tl;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Issues the copies of a tile's codes and lengths.  raw keeps each code
// byte at its address mod 16 (the span starts at raw[g0's address & 15]),
// so a 16-aligned block of the array lands on a 16-aligned block of raw.
__device__ __forceinline__ void load_tile(const Tile& tl,
                                          const uint8_t* __restrict__ codes,
                                          const int32_t* __restrict__ lengths,
                                          uint8_t* raw, int32_t* lens) {
  const uint8_t* src = codes + tl.g0;
  const int sh = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  const uint8_t* base = src - sh;                 // 16-aligned
  const int end = sh + tl.span;                   // raw offsets [sh, end)
  const int a0 = (sh + 15) & ~15, a1 = end & ~15;
  for (int b = a0 + 16 * threadIdx.x; b < a1; b += 16 * kThreads)
    cp_async16(raw + b, base + b);
  if (a0 >= a1) {                                 // no whole 16 bytes
    for (int b = sh + threadIdx.x; b < end; b += kThreads) raw[b] = base[b];
  } else {
    const int t = threadIdx.x;
    if (t < a0 - sh) raw[sh + t] = base[sh + t];
    if (t < end - a1) raw[a1 + t] = base[a1 + t];
  }
  for (int r = threadIdx.x; r < tl.nr; r += kThreads)
    cp_async4(lens + r, lengths + tl.row0 + r);
}

// 4 code bytes (first base in the low byte) -> 8 bits, first base highest.
__device__ __forceinline__ unsigned pack4(unsigned v) {
  return ((v & 0x03030303u) * 0x40100401u) >> 24;
}

// Window j of a row of length len whose base j lies at offset q of the
// tile's code buffer rw and packed words pk: its canonical k-mer (kSentinel
// past the read) and, with edges, its neighbour codes (4 where none).
template <bool kEdges>
__device__ __forceinline__ unsigned long long window(
    const uint8_t* rw, const unsigned long long* pk, int q, int j, int len,
    int L, int k, uint8_t& lo, uint8_t& ro) {
  lo = ro = 4;
  if (j >= len - k + 1) return kSentinel;
  const int down = 64 - 2 * k;
  const int o2 = 2 * (q & 31);
  const unsigned long long hi = pk[q >> 5], nx = pk[(q >> 5) + 1];
  // bases q .. q + k - 1 at the top of a funnel shift of two words
  const unsigned long long fwd =
      ((hi << o2) | ((nx >> 1) >> (63 - o2))) >> down;
  // reverse complement: ~fwd, 2-bit groups reversed, the k groups shifted
  // down (the ones of ~fwd above 2k bits fall off)
  unsigned long long rc = __brevll(~fwd);
  rc = ((rc >> 1) & 0x5555555555555555ULL) |
       ((rc & 0x5555555555555555ULL) << 1);
  rc >>= down;
  const bool use_fwd = fwd <= rc;
  if (kEdges) {
    const bool has_left = j > 0;
    const bool has_right = j < len - k;
    const int lc = has_left ? rw[q - 1] & 3 : 0;
    const int rcd = has_right && j + k < L ? rw[q + k] & 3 : 0;
    if (use_fwd) {
      lo = has_left ? lc : 4;
      ro = has_right ? rcd : 4;
    } else {
      lo = has_right ? 3 - rcd : 4;
      ro = has_left ? 3 - lc : 4;
    }
  }
  return use_fwd ? fwd : rc;
}

template <bool kEdges>
__global__ void __launch_bounds__(kThreads)
    chop_kernel(const uint8_t* __restrict__ codes,
                const int32_t* __restrict__ lengths, long long n_rows, int L,
                int k, int rows, int pw, long long n_tiles,
                long long* __restrict__ kmers, uint8_t* __restrict__ left,
                uint8_t* __restrict__ right) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout lay(rows, pw, L, k);
  // buffer b: codes at smem + b * lay.raw, lengths at lens0 + b * lay.lens
  uint8_t* lens0 = smem + 2 * lay.raw;
  auto* pk = reinterpret_cast<unsigned long long*>(lens0 + 2 * lay.lens);
  auto* pk32 = reinterpret_cast<unsigned*>(pk);
  const int P = L - k + 1;

  long long t = blockIdx.x;
  if (t < n_tiles)
    load_tile(tile_at(t, n_rows, L, k, rows, pw), codes, lengths, smem,
              reinterpret_cast<int32_t*>(lens0));
  cp_async_commit();
  for (int buf = 0; t < n_tiles; t += gridDim.x, buf ^= 1) {
    const Tile tl = tile_at(t, n_rows, L, k, rows, pw);
    cp_async_wait_all();                       // this tile's copies are in
    __syncthreads();      // and the other buffers' last readers are done
    if (t + gridDim.x < n_tiles)
      load_tile(tile_at(t + gridDim.x, n_rows, L, k, rows, pw), codes,
                lengths, smem + (buf ^ 1) * lay.raw,
                reinterpret_cast<int32_t*>(lens0 + (buf ^ 1) * lay.lens));
    cp_async_commit();

    // pack: 16 code bytes -> one 32-bit half of a word, first base highest
    const uint8_t* rw = smem + buf * lay.raw;
    const int sh = static_cast<int>(
        reinterpret_cast<uintptr_t>(codes + tl.g0) & 15);
    for (int h = threadIdx.x; 16 * h < sh + tl.span; h += kThreads) {
      const uint4 v = *reinterpret_cast<const uint4*>(rw + 16 * h);
      pk32[h ^ 1] = pack4(v.x) << 24 | pack4(v.y) << 16 | pack4(v.z) << 8 |
                    pack4(v.w);
    }
    __syncthreads();

    // windows in output order, stored as computed: window f of the tile is
    // (r, j0 + jj), output element o + f
    const auto* ln =
        reinterpret_cast<const int32_t*>(lens0 + buf * lay.lens);
    const int nw = tl.nr * tl.nwin;
    const long long o = tl.row0 * P + tl.j0;
    const int dr = kThreads / tl.nwin, djj = kThreads - dr * tl.nwin;
    int r = threadIdx.x / tl.nwin, jj = threadIdx.x - r * tl.nwin;
    for (int f = threadIdx.x; f < nw; f += kThreads) {
      const int j = tl.j0 + jj;
      uint8_t lo, ro;
      kmers[o + f] = static_cast<long long>(window<kEdges>(
          rw, pk, sh + r * L + j - tl.js, j, ln[r], L, k, lo, ro));
      if (kEdges) {
        left[o + f] = lo;
        right[o + f] = ro;
      }
      r += dr;
      jj += djj;
      if (jj >= tl.nwin) {
        jj -= tl.nwin;
        ++r;
      }
    }
  }
}

template <bool kEdges>
int launch(const uint8_t* codes, const int32_t* lengths, long long n_rows,
           int L, int k, int rows, int pw, long long* kmers, uint8_t* left,
           uint8_t* right, cudaStream_t st) {
  const int P = L - k + 1;
  const long long n_tiles =
      pw == P ? (n_rows + rows - 1) / rows : n_rows * ((P + pw - 1) / pw);
  const int smem = Layout(rows, pw, L, k).total;   // <= 48 KB: no opt-in
  // the blocks resident on the whole card, once per shared-memory size
  static int last_smem = -1, resident = 0;
  if (smem != last_smem) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, chop_kernel<kEdges>, kThreads, smem);
    resident = sms * std::max(per_sm, 1);
    last_smem = smem;
  }
  const long long grid = std::min(n_tiles, static_cast<long long>(resident));
  chop_kernel<kEdges><<<static_cast<unsigned>(grid), kThreads, smem, st>>>(
      codes, lengths, n_rows, L, k, rows, pw, n_tiles, kmers, left, right);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of dynamic shared memory a block takes for this tiling.
extern "C" int chop_smem_bytes(int L, int k, int rows, int pw) {
  return Layout(rows, pw, L, k).total;
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).  Tiles
// are `rows` whole rows when pw == L - k + 1, else segments of pw windows of
// one row.  left/right are read only when edges != 0.
extern "C" int chop_launch(const void* codes, const void* lengths,
                           long long n_rows, int L, int k, int rows, int pw,
                           void* kmers, void* left, void* right, int edges,
                           void* stream) {
  if (n_rows <= 0 || L - k + 1 <= 0) return 0;
  if (rows < 1 || pw < 1 || pw > L - k + 1 || (pw < L - k + 1 && rows != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* ln = static_cast<const int32_t*>(lengths);
  auto* km = static_cast<long long*>(kmers);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return edges ? launch<true>(c, ln, n_rows, L, k, rows, pw, km,
                              static_cast<uint8_t*>(left),
                              static_cast<uint8_t*>(right), st)
               : launch<false>(c, ln, n_rows, L, k, rows, pw, km, nullptr,
                               nullptr, st);
}
