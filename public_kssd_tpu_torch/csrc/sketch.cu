// Window sketch kernel: 2-bit packed base stream -> one sketch code per
// window start (the drtuple, or -1 where the window is dropped).
//
// Replaces public_kssd_tpu/ops/pallas_sketch.py:_sketch_kernel, in both of
// its launches: sketch_windows_pallas (drtuples <= 31 bits, entry
// kssd_sketch_dense, int32 codes) and sketch_windows_pallas_wide (32..64-bit
// drtuples, k - l >= 8, entry kssd_sketch_dense_wide, int64 codes). The TPU
// wide kernel split each code into two uint32 planes with explicit carries;
// here the window and the code are native 64-bit values, so the two entries
// differ only in the type they store, and the wide one also covers k = 16
// (W = 32), which the TPU kernel left to its jnp path.
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
// What bounds it on an H100: integer ALU work per window (about W shift/or
// steps per strand on a 64-bit value, plus four Feistel rounds), not
// memory: it reads 4 bytes per 16 windows and writes 4 (narrow) or 8
// (wide) bytes per window.
// The design keeps the window value in registers as one native uint64
// (no hi/lo split), stages the block's packed words (256 windows plus the
// W-1 halo) in shared memory once, and unpacks bases from there.
//
// The stream carries no BREAK symbols (2-bit packing has no room for
// them): windows reaching past n_valid are dropped here, and windows that
// cross a break are dropped by the host from their positions.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// symbols a block needs: kThreads windows + up to 31 halo symbols (W <= 32)
constexpr int kWords = kThreads / 16 + 2;

struct Geometry {
  int W;                 // window length in bases (2k), <= 32
  int outshift;          // 2(k-s): inner substring offset
  uint32_t inner_mask;   // 16^s - 1
  uint64_t undomask;     // left outer half
  uint64_t rightmask;    // right outer half
  int right_shift;       // 4s
  int dr_shift;          // 4l
  int32_t dim_start;
  int32_t dim_end;
  int half_bits;         // 2s: Feistel half width
  uint32_t keys[4];      // Feistel round keys
};

__device__ __forceinline__ uint32_t feistel(uint32_t inner, const Geometry& g) {
  const uint32_t mask = (1u << g.half_bits) - 1u;
  uint32_t left = (inner >> g.half_bits) & mask;
  uint32_t right = inner & mask;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    uint32_t f = right * 0x9E3779B1u + g.keys[r];
    f ^= f >> 15;
    f *= 0x85EBCA6Bu;
    f = (f ^ (f >> 13)) & mask;
    const uint32_t next_right = left ^ f;
    left = right;
    right = next_right;
  }
  return (left << g.half_bits) | right;
}

// Code: int32_t for drtuples below 2^31, int64_t (uint64 bits) for wider
template <typename Code>
__global__ void __launch_bounds__(kThreads)
sketch_dense_kernel(const uint32_t* __restrict__ words, int64_t n_words,
                    int64_t n_valid, Geometry g,
                    const int32_t* __restrict__ table,
                    Code* __restrict__ out) {
  __shared__ uint32_t tile[kWords];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t w0 = base / 16;
  for (int i = threadIdx.x; i < kWords; i += kThreads) {
    const int64_t wi = w0 + i;
    tile[i] = wi < n_words ? words[wi] : 0u;
  }
  __syncthreads();

  const int64_t p = base + threadIdx.x;
  if (p >= n_words * 16) return;
  Code code = -1;
  if (p + g.W <= n_valid) {
    uint64_t fwd = 0, rc = 0;
    for (int j = 0; j < g.W; ++j) {
      const int q = threadIdx.x + j;
      const uint32_t b = (tile[q >> 4] >> ((q & 15) * 2)) & 3u;
      fwd = (fwd << 2) | b;
      rc |= static_cast<uint64_t>(3u ^ b) << (2 * j);
    }
    const uint64_t uni = fwd < rc ? fwd : rc;
    const uint32_t inner = static_cast<uint32_t>(uni >> g.outshift) & g.inner_mask;
    const int32_t rank = table != nullptr ? table[inner]
                                          : static_cast<int32_t>(feistel(inner, g));
    if (rank >= g.dim_start && rank < g.dim_end) {
      const uint64_t left = uni & g.undomask;
      const uint64_t right = (uni & g.rightmask) << g.right_shift;
      const uint64_t dr = ((left + right) >> g.dr_shift) +
                          static_cast<uint64_t>(rank - g.dim_start);
      code = static_cast<Code>(dr);
    }
  }
  out[p] = code;
}

template <typename Code>
int launch(const void* words, int64_t n_words, int64_t n_valid, const Geometry& g,
           const void* table, void* out, void* stream) {
  if (n_words <= 0) return 0;
  const int64_t n = n_words * 16;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  sketch_dense_kernel<Code><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_words, n_valid, g,
      static_cast<const int32_t*>(table), static_cast<Code*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entries take the same arguments; the drtuple has 2W - dr_shift bits.
#define KSSD_SKETCH_ARGS                                                     \
  const void *words, int64_t n_words, int64_t n_valid, int W, int outshift,  \
      uint32_t inner_mask, uint64_t undomask, uint64_t rightmask,            \
      int right_shift, int dr_shift, int dim_start, int dim_end,             \
      int half_bits, uint32_t k0, uint32_t k1, uint32_t k2, uint32_t k3,     \
      const void *table, void *out, void *stream
#define KSSD_GEOMETRY                                                        \
  Geometry g{W, outshift, inner_mask, undomask, rightmask, right_shift,      \
             dr_shift, dim_start, dim_end, half_bits, {k0, k1, k2, k3}}

extern "C" int kssd_sketch_dense(KSSD_SKETCH_ARGS) {
  if (W < 1 || W > 32 || 2 * W - dr_shift > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  KSSD_GEOMETRY;
  return launch<int32_t>(words, n_words, n_valid, g, table, out, stream);
}

extern "C" int kssd_sketch_dense_wide(KSSD_SKETCH_ARGS) {
  if (W < 1 || W > 32) return static_cast<int>(cudaErrorInvalidValue);
  KSSD_GEOMETRY;
  return launch<int64_t>(words, n_words, n_valid, g, table, out, stream);
}
