// Window sketch kernel: 2-bit packed base stream -> the kept windows'
// (position, sketch code) pairs in ascending position.
//
// Replaces public_kssd_tpu/ops/pallas_sketch.py:_sketch_kernel, in both of
// its launches: sketch_windows_pallas (drtuples <= 31 bits, entry
// kssd_sketch, int32 codes) and sketch_windows_pallas_wide (32..64-bit
// drtuples, k - l >= 8, entry kssd_sketch_wide, int64 codes), together with
// the survivor compaction that follows them (sketch_windows_rows' per-row
// top_k and its capacity retry). The window and the code are native 64-bit
// values, so the two entries differ only in the type they store, and the
// wide one also covers k = 16 (W = 32), which the TPU kernel left to its
// jnp path.
//
// For each window start p over W = 2k bases:
//   fwd   = b[p] b[p+1] ... b[p+W-1]            (2 bits per base, MSB first)
//   rc    = sum_j (3 - b[p+j]) << 2j            (reverse complement)
//   uni   = min(fwd, rc)                        (canonical k-mer)
//   inner = (uni >> 2(k-s)) & (16^s - 1)
//   rank  = Feistel(inner) or table[inner]      (shuffled inner space)
//   keep  = dim_start <= rank < dim_end and p + W <= n_valid
//   code  = ((uni & undomask) + ((uni & rightmask) << 4s)) >> 4l
//           + rank - dim_start
//
// What bounds it on an H100: integer ALU work per window, not memory. The
// input is 4 bytes per 16 windows and only ~1 window in 16^l survives, so
// the bytes bound is ~1 us at 2^24 windows while the ALU needs tens of us:
// ~45 integer operations a window in the Feistel mode, which the int32
// lanes (64 an SM) retire in ~50 us at 2^24 windows. A table .shuf (not
// Feistel) replaces the rank's arithmetic by a gather of table[inner]: from
// L2 at s <= 5 (a 4 MB table), from HBM at s = 6 (64 MB), where the
// gathers, not the ALU, set the time. Writing one code per window (a 64 MB
// array at 2^24 windows) and compacting it afterwards would cost more than
// the window work itself.
//
// The design:
//  * Rolling windows. A thread owns kRun = 32 consecutive window starts.
//    It takes its first window's fwd/rc from its packed words with a few
//    word operations (rc is the complement of the low 2W bits; fwd is their
//    2-bit-group reversal) and rolls one base in per further window
//    (fwd = fwd << 2 | b, rc = rc >> 2 | (3 - b) << 2W-2), so a window costs
//    a handful of 64-bit operations plus the rank. kRun = 32 makes one
//    thread's keep flags exactly one 32-bit mask word and amortises the
//    first window's set-up over 32 windows; a block of 256 threads covers
//    8,192 windows, whose 512 packed words (+ 2 halo words for W - 1 <= 31)
//    are staged in shared memory with 16-byte loads.
//  * Early Feistel exit. After three of the four rounds the rank's high
//    half is known (round four moves the right half up unchanged); a window
//    whose high half lies outside the kept range, nearly all of them, skips
//    round four.
//  * Fused, ordered compaction in two launches of one kernel, with an exact
//    allocation between them and no capacity or retry:
//      pass 0 (keep): the window work above; writes the 32-bit keep mask of
//        every thread and the survivor count of every block;
//      the caller takes an inclusive cumsum of the block counts and
//        allocates exactly the total;
//      pass 1 (fill): a block without survivors returns at once; otherwise
//        a block-wide scan of the threads' mask popcounts lets each thread
//        list its kept positions, in order, in shared memory; the block's
//        threads then take that list in strides, build each listed window
//        straight from the three packed words that hold it (no rolling, so
//        no warp divergence where survivors are dense) and write (pos,
//        code) at cum[block - 1] + its index: ascending position, the order
//        of the plain version's torch.nonzero, with neighbouring threads on
//        neighbouring outputs. An input where every window is kept (a
//        homopolymer run of a kept k-mer) fills every slot.
//    The keep mask costs 1 bit per window (2 MB at 2^24 windows) instead of
//    a 4- or 8-byte code.
//
// The stream carries no BREAK symbols (2-bit packing has no room for
// them): windows reaching past n_valid are dropped here, and windows that
// cross a break are dropped after the fill pass, on the card, by a gather
// of the breaks' prefix sum at their positions (ops/sketch.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 32;                        // window starts per thread
constexpr int kTileWindows = kThreads * kRun;   // 8192 windows per block
constexpr int kTileWords = kTileWindows / 16;   // 512 packed words
constexpr int kStageWords = kTileWords + 4;     // + halo, a whole uint4

struct Geometry {
  int W;                 // window length in bases (2k), <= 32
  uint64_t wmask;        // low 2W bits
  int outshift;          // 2(k-s): inner substring offset
  uint32_t inner_mask;   // 16^s - 1
  uint64_t undomask;     // left outer half
  uint64_t rightmask;    // right outer half
  int right_shift;       // 4s
  int dr_shift;          // 4l
  int32_t dim_start;
  int32_t dim_end;
  int half_bits;         // 2s: Feistel half width
  uint32_t hi_lo, hi_hi; // kept range of the rank's high half
  uint32_t keys[4];      // Feistel round keys
};

__device__ __forceinline__ uint32_t round_f(uint32_t right, uint32_t key,
                                            uint32_t mask) {
  uint32_t f = right * 0x9E3779B1u + key;
  f ^= f >> 15;
  f *= 0x85EBCA6Bu;
  return (f ^ (f >> 13)) & mask;
}

// Feistel rank of `inner`, and whether it is kept. The network is
// left, right -> right, left ^ F(right) four times; the rank is
// left << half_bits | right. Its high half is the right half after three
// rounds, so round four runs only where that half is in the kept range.
__device__ __forceinline__ bool feistel_keep(uint32_t inner, const Geometry& g,
                                             int32_t& rank) {
  const uint32_t mask = (1u << g.half_bits) - 1u;
  uint32_t left = (inner >> g.half_bits) & mask;
  uint32_t right = inner & mask;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const uint32_t next = left ^ round_f(right, g.keys[r], mask);
    left = right;
    right = next;
  }
  if (right < g.hi_lo || right > g.hi_hi) return false;
  rank = static_cast<int32_t>((right << g.half_bits) |
                              (left ^ round_f(right, g.keys[3], mask)));
  return rank >= g.dim_start && rank < g.dim_end;
}

// Canonical k-mer and rank of one window; true where the window is kept.
__device__ __forceinline__ bool window_keep(uint64_t fwd, uint64_t rc,
                                            const Geometry& g,
                                            const int32_t* __restrict__ table,
                                            uint64_t& uni, int32_t& rank) {
  uni = fwd < rc ? fwd : rc;
  const uint32_t inner = static_cast<uint32_t>(uni >> g.outshift) & g.inner_mask;
  if (table != nullptr) {
    rank = __ldg(table + inner);
    return rank >= g.dim_start && rank < g.dim_end;
  }
  return feistel_keep(inner, g, rank);
}

__device__ __forceinline__ uint64_t drtuple(uint64_t uni, int32_t rank,
                                            const Geometry& g) {
  const uint64_t left = uni & g.undomask;
  const uint64_t right = (uni & g.rightmask) << g.right_shift;
  return ((left + right) >> g.dr_shift) +
         static_cast<uint64_t>(rank - g.dim_start);
}

// The rolling state of a thread's run: its first window and the bases
// that follow it. lo/hi hold bases 0..31 / 32..63 of the run, base j at
// bits 2j..2j+1 (pack2's layout).
struct Run {
  uint64_t fwd, rc, next;

  __device__ __forceinline__ Run(uint64_t lo, uint64_t hi, const Geometry& g) {
    rc = ~lo & g.wmask;
    // reverse the order of the 32 2-bit groups: bit reversal, then swap
    // the two bits of each group back
    uint64_t r = __brevll(lo);
    r = ((r >> 1) & 0x5555555555555555ull) | ((r & 0x5555555555555555ull) << 1);
    fwd = r >> (64 - 2 * g.W);
    next = g.W == 32 ? hi : (lo >> (2 * g.W)) | (hi << (64 - 2 * g.W));
  }

  __device__ __forceinline__ void roll(const Geometry& g) {
    const uint64_t b = next & 3u;
    next >>= 2;
    fwd = ((fwd << 2) | b) & g.wmask;
    rc = (rc >> 2) | ((b ^ 3u) << (2 * g.W - 2));
  }
};

// Windows of the run starting at p0 that end inside n_valid, as a mask.
__device__ __forceinline__ uint32_t valid_mask(int64_t p0, int64_t n_valid,
                                               int W) {
  const int64_t v = n_valid - W + 1 - p0;
  if (v >= kRun) return 0xFFFFFFFFu;
  return v <= 0 ? 0u : (1u << v) - 1u;
}

__device__ __forceinline__ uint32_t word_at(const uint32_t* __restrict__ words,
                                            int64_t n_words, int64_t i) {
  return i < n_words ? words[i] : 0u;
}

// pass 0: keep mask of every thread's run, survivor count of every block
__global__ void __launch_bounds__(kThreads)
sketch_keep_kernel(const uint32_t* __restrict__ words, int64_t n_words,
                   int64_t n_valid, Geometry g,
                   const int32_t* __restrict__ table,
                   uint32_t* __restrict__ mask, int32_t* __restrict__ counts) {
  __shared__ __align__(16) uint32_t tile[kStageWords];
  __shared__ int warp_counts[kThreads / 32];
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kTileWords;
  const bool vec = (reinterpret_cast<uintptr_t>(words) & 15u) == 0 &&
                   w0 + kStageWords <= n_words;
  if (vec) {
    const uint4* src = reinterpret_cast<const uint4*>(words + w0);
    for (int i = threadIdx.x; i < kStageWords / 4; i += kThreads) {
      reinterpret_cast<uint4*>(tile)[i] = src[i];
    }
  } else {
    for (int i = threadIdx.x; i < kStageWords; i += kThreads) {
      tile[i] = word_at(words, n_words, w0 + i);
    }
  }
  __syncthreads();

  const int t = threadIdx.x;
  const uint2 a = reinterpret_cast<const uint2*>(tile)[t];
  const uint2 b = reinterpret_cast<const uint2*>(tile)[t + 1];
  Run run(a.x | static_cast<uint64_t>(a.y) << 32,
          b.x | static_cast<uint64_t>(b.y) << 32, g);
  uint32_t keep = 0;
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    if (i > 0) run.roll(g);
    uint64_t uni;
    int32_t rank;
    if (window_keep(run.fwd, run.rc, g, table, uni, rank)) keep |= 1u << i;
  }
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kTileWindows +
                     static_cast<int64_t>(t) * kRun;
  keep &= valid_mask(p0, n_valid, g.W);
  mask[static_cast<int64_t>(blockIdx.x) * kThreads + t] = keep;

  const int n = __reduce_add_sync(0xFFFFFFFFu, __popc(keep));
  if ((t & 31) == 0) warp_counts[t >> 5] = n;
  __syncthreads();
  if (t == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_counts[w];
    counts[blockIdx.x] = total;
  }
}

// pass 1: (pos, code) of every kept window at its block's offset
template <typename Code>
__global__ void __launch_bounds__(kThreads)
sketch_fill_kernel(const uint32_t* __restrict__ words, int64_t n_words,
                   Geometry g, const int32_t* __restrict__ table,
                   const uint32_t* __restrict__ mask,
                   const int64_t* __restrict__ cum,
                   int64_t* __restrict__ pos, Code* __restrict__ codes) {
  __shared__ int warp_totals[kThreads / 32];
  __shared__ uint16_t kept[kTileWindows];  // block-local positions, ascending
  const int64_t end = cum[blockIdx.x];
  const int64_t start = blockIdx.x > 0 ? cum[blockIdx.x - 1] : 0;
  if (end == start) return;  // block-uniform: no survivors here

  // each thread lists its kept windows at its offset in the block's list
  const int t = threadIdx.x;
  const int lane = t & 31;
  uint32_t keep = mask[static_cast<int64_t>(blockIdx.x) * kThreads + t];
  const int n = __popc(keep);
  int incl = n;  // inclusive scan of the popcounts within the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_totals[t >> 5] = incl;
  __syncthreads();
  int o = incl - n;
  for (int w = 0; w < (t >> 5); ++w) o += warp_totals[w];
  while (keep != 0) {
    kept[o++] = static_cast<uint16_t>(t * kRun + __ffs(keep) - 1);
    keep &= keep - 1;
  }
  __syncthreads();

  // the block's threads take the list in strides: each window is built
  // from the three packed words that hold it, and neighbouring threads
  // write neighbouring outputs
  const int64_t n_kept = end - start;
  const int64_t p_tile = static_cast<int64_t>(blockIdx.x) * kTileWindows;
  for (int j = t; j < n_kept; j += kThreads) {
    const int p = kept[j];
    const int64_t wi = (p_tile + p) >> 4;
    const int sh = 2 * (p & 15);
    const uint64_t w01 = word_at(words, n_words, wi) |
                         static_cast<uint64_t>(word_at(words, n_words, wi + 1)) << 32;
    const uint64_t w2 = word_at(words, n_words, wi + 2);
    const uint64_t lo = sh == 0 ? w01 : (w01 >> sh) | (w2 << (64 - sh));
    const Run run(lo, 0, g);
    uint64_t uni;
    int32_t rank;
    window_keep(run.fwd, run.rc, g, table, uni, rank);
    pos[start + j] = p_tile + p;
    codes[start + j] = static_cast<Code>(drtuple(uni, rank, g));
  }
}

int64_t tiles_for(int64_t n_words) {
  return (n_words + kTileWords - 1) / kTileWords;
}

template <typename Code>
int launch(int fill, const void* words, int64_t n_words, const Geometry& g,
           int64_t n_valid, const void* table, void* mask, void* counts_or_cum,
           void* pos, void* codes, void* stream) {
  const unsigned blocks = static_cast<unsigned>(tiles_for(n_words));
  const auto s = static_cast<cudaStream_t>(stream);
  if (fill) {
    sketch_fill_kernel<Code><<<blocks, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(words), n_words, g,
        static_cast<const int32_t*>(table), static_cast<const uint32_t*>(mask),
        static_cast<const int64_t*>(counts_or_cum), static_cast<int64_t*>(pos),
        static_cast<Code*>(codes));
  } else {
    sketch_keep_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(words), n_words, n_valid, g,
        static_cast<const int32_t*>(table), static_cast<uint32_t*>(mask),
        static_cast<int32_t*>(counts_or_cum));
  }
  return static_cast<int>(cudaGetLastError());
}

bool geometry(int W, int outshift, uint32_t inner_mask, uint64_t undomask,
              uint64_t rightmask, int right_shift, int dr_shift, int dim_start,
              int dim_end, int half_bits, uint32_t k0, uint32_t k1, uint32_t k2,
              uint32_t k3, Geometry* g) {
  if (W < 1 || W > 32 || half_bits < 0 || half_bits > 15 || dim_end <= dim_start)
    return false;
  *g = Geometry{W, W == 32 ? ~0ull : (1ull << (2 * W)) - 1, outshift,
                inner_mask, undomask, rightmask, right_shift, dr_shift,
                dim_start, dim_end, half_bits,
                static_cast<uint32_t>(dim_start) >> half_bits,
                static_cast<uint32_t>(dim_end - 1) >> half_bits,
                {k0, k1, k2, k3}};
  return true;
}

}  // namespace

// Both entries take the same arguments; the drtuple has 2W - dr_shift bits.
// fill = 0: mask receives uint32 [n_tiles * 256] keep masks and
//   counts_or_cum int32 [n_tiles] survivor counts (pos, codes unused).
// fill = 1: counts_or_cum holds the int64 inclusive cumsum of those counts;
//   pos (int64) and codes (int32 | int64) receive cum[n_tiles - 1] entries.
// n_tiles must be ceil(n_words / 512): 8,192 windows per tile.
#define KSSD_SKETCH_ARGS                                                     \
  int fill, const void *words, int64_t n_words, int64_t n_valid, int W,      \
      int outshift, uint32_t inner_mask, uint64_t undomask,                  \
      uint64_t rightmask, int right_shift, int dr_shift, int dim_start,      \
      int dim_end, int half_bits, uint32_t k0, uint32_t k1, uint32_t k2,     \
      uint32_t k3, const void *table, int64_t n_tiles, void *mask,           \
      void *counts_or_cum, void *pos, void *codes, void *stream
#define KSSD_CHECKED_GEOMETRY(max_bits)                                      \
  Geometry g;                                                                \
  if (!geometry(W, outshift, inner_mask, undomask, rightmask, right_shift,   \
                dr_shift, dim_start, dim_end, half_bits, k0, k1, k2, k3,     \
                &g) ||                                                       \
      2 * W - dr_shift > (max_bits) || n_tiles != tiles_for(n_words) ||      \
      n_valid > n_words * 16)                                                \
    return static_cast<int>(cudaErrorInvalidValue);                          \
  if (n_words <= 0) return 0;

extern "C" int kssd_sketch(KSSD_SKETCH_ARGS) {
  KSSD_CHECKED_GEOMETRY(31);
  return launch<int32_t>(fill, words, n_words, g, n_valid, table, mask,
                         counts_or_cum, pos, codes, stream);
}

extern "C" int kssd_sketch_wide(KSSD_SKETCH_ARGS) {
  KSSD_CHECKED_GEOMETRY(64);
  return launch<int64_t>(fill, words, n_words, g, n_valid, table, mask,
                         counts_or_cum, pos, codes, stream);
}
