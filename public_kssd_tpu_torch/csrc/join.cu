// Composite join: reference DB rows x the combined sorted query table ->
// packed int64 hit keys  qid << qid_shift | rid << 16 | abundance.
//
// Replaces public_kssd_tpu/composite.py:_csr_join_impl (the inverted
// index route) and _batched_join_impl (raw DB codes). Those expand every
// hit into a fixed-capacity buffer with an int32 cumsum and retry with a
// larger capacity on overflow; here two passes size the output exactly.
// A CSR row (kCsr) has postings gids[offs[i] .. offs[i+1]); a raw DB code
// is a row with the single posting gids[i] (its genome id), so one
// template serves both routes with no offsets array for the raw one.
//
// The 64-bit-key instance (entry kssd_join64, raw route) replaces
// public_kssd_tpu/parallel/sharded_composite.py:_make_join_fn, the
// per-shard join of composite --mesh: there every component's DB codes
// and the query table are folded into uint64 keys comp << 32 | code, so
// the row codes and the sorted query table are uint64 and compare
// unsigned. Same template, same passes.
//
// Output order: DB row-major; within a row, query entry outer, posting
// inner. That is the order of the plain version (composite.join_torch),
// so the two agree element for element.
//
// What bounds it on an H100: lookups, not bytes. The bytes a call must
// move (every row's code, the query table, the hit rows' postings, the
// keys written once) take ~0.03 ms at the GTDB species-group shape (19.7M
// DB codes x 1.4M table entries), but every row looks its code up in the
// table. On the raw route and in join64 neighbouring rows hold unrelated
// codes, so each lookup reads its own 32-byte sectors of the directory
// and the table (~22 MB), at the rate L2 serves random sectors. On the
// CSR route the rows ascend, so neighbouring lanes read neighbouring
// directory entries. Only ~2-5% of the rows hit; the fill's work is
// small and its time is the latency of a few dependent loads a tile.
//
// The design:
//  * A bucket directory over the query table (composite.query_directory,
//    built once per table with ops.count.bucket_directory): dir[b] is the
//    lower bound in sq of b << shift, so the entries whose top bits are b
//    lie in sq[dir[b], dir[b+1]), and a run of equal codes lies in one
//    bucket. It has 2^(bit_length(n_q) + 1) buckets (at most the largest
//    key's bit length): 0.25-0.5 table entries a bucket, so a row that
//    misses reads one directory sector and, for a third of the rows, one
//    table sector, instead of ~21 dependent probes of a binary search
//    over the table. Its entries are int32 (the caller keeps n_q below
//    2^31): 4 * (2^bits + 1) bytes, 16 MB at 1.4M entries (bits 22).
//    One bit fewer leaves more rows to read the table; one or two bits
//    more (33 and 67 MB) hold more than L2 keeps beside the streamed row
//    codes, as int64 entries do. On an H100 at that shape each of these
//    ran the raw route's count pass slower.
//  * Pass 0 (count): a block of 256 threads takes a tile of 4,096 rows in
//    four steps of 1,024, 4 consecutive rows a thread a step, whose codes,
//    directory entries and first bucket entries are loaded before any of
//    them is searched (four lookups in flight a thread). It writes one hit
//    bit a row (words of 32 consecutive rows) and, per tile, its hit-key
//    count and its number of fill pieces. No per-row lengths array.
//  * The caller takes torch.cumsum over the tiles' counts and pieces,
//    syncs once for both totals and allocates exactly the keys.
//  * Pass 1 (fill): one block per piece, a piece being up to 4,096 keys of
//    one tile. A tile is split by output range, so a tile that holds a hot
//    row (a code every sample holds x a postings list of every reference:
//    525,616 keys at 8 x 65,702) is spread over many blocks; every other
//    tile is one block (a tile without hits returns at once). The block
//    finds its tile in the pieces' cumsum (every tile has at least one
//    piece, so the search covers only the extra pieces) and lists the
//    tile's hit rows in order in shared memory from its hit bits (a scan
//    of their popcounts). It then takes the list 256 rows at a time, one
//    row a thread, so a tile's few hit rows are looked up in parallel
//    rather than by the few threads that own them: each thread looks its
//    row up again, a block scan of their key counts with warp shuffles
//    gives each row its key offset (with its table position and postings,
//    in shared memory), and the block's threads stride over the batch's
//    output slots together: each slot finds its row by a binary search of
//    those offsets, and neighbouring threads write neighbouring keys
//    (coalesced 8-byte stores).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 4;                        // a count step
constexpr int kSteps = 4;
constexpr int kStepRows = kThreads * kRowsPerThread;     // 1,024
constexpr int kTileRows = kStepRows * kSteps;            // 4,096 rows a tile
constexpr int kTileWords = kTileRows / 32;               // 128 hit-bit words
constexpr int64_t kPieceKeys = 4096;                     // keys a fill block writes

template <typename Key>
struct Join {
  const Key* u;          // [n_rows] DB row codes
  int64_t n_rows;
  const int64_t* offs;   // [n_rows + 1] absolute postings offsets (CSR)
  const int32_t* gids;   // postings (CSR) or one genome id a row (raw)
  const Key* sq;         // [n_q] ascending query codes
  const int32_t* sqid;   // [n_q] query id of each entry
  const uint32_t* sab;   // [n_q] abundance of each entry
  const int32_t* dir;    // [n_buckets + 1] bucket directory of sq
  int64_t n_buckets;
  int shift;
};

// The bucket of `code`: [lo, end) in sq; empty past the directory.
template <typename Key>
__device__ __forceinline__ void bucket(const Join<Key>& j, Key code,
                                       int64_t& lo, int64_t& end) {
  const uint64_t b = j.shift >= 64 ? 0 : static_cast<uint64_t>(code) >> j.shift;
  if (b >= static_cast<uint64_t>(j.n_buckets)) {
    lo = end = 0;
    return;
  }
  lo = j.dir[b];
  end = j.dir[b + 1];
}

// Number of entries equal to `code` in the bucket sq[lo, end), whose first
// entry is `head`, and the position of the first one in `pos`.
template <typename Key>
__device__ __forceinline__ int64_t run_in_bucket(const Key* __restrict__ sq,
                                                 int64_t lo, int64_t end,
                                                 Key head, Key code,
                                                 int64_t& pos) {
  if (lo >= end || head > code) return 0;
  if (head < code) {  // lower bound in the rest of the bucket
    int64_t hi = end;
    ++lo;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (sq[mid] < code) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    if (lo == end || sq[lo] != code) return 0;
  }
  pos = lo;
  int64_t l = lo + 1, hi = end;  // upper bound: the run ends in the bucket
  while (l < hi) {
    const int64_t mid = (l + hi) >> 1;
    if (sq[mid] <= code) {
      l = mid + 1;
    } else {
      hi = mid;
    }
  }
  return l - lo;
}

// The rows i0 + k (k < N) whose bit k is set in `rows`: the keys each
// emits (its run's length x its postings; 0 for the others), its run's
// first table position, its first posting and its postings. Each step's
// loads (codes, directory entries, first bucket entries, offsets) are
// issued for all N rows before any is used, so the lookups of a thread
// overlap instead of running one after another. kHits: the rows are known
// to hit (the fill pass), so their offsets are loaded with their codes.
template <typename Key, bool kCsr, bool kHits, int N>
__device__ __forceinline__ void lookup_rows(const Join<Key>& j, int64_t i0,
                                            unsigned rows, int64_t (&n_keys)[N],
                                            int64_t (&pos)[N],
                                            int64_t (&start)[N],
                                            int64_t (&plen)[N]) {
  Key code[N], head[N];
  int64_t lo[N], end[N], stop[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const bool row = (rows >> k) & 1u;
    code[k] = row ? j.u[i0 + k] : Key(0);
    if (kCsr && kHits && row) {
      start[k] = j.offs[i0 + k];
      stop[k] = j.offs[i0 + k + 1];
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    lo[k] = end[k] = 0;
    if ((rows >> k) & 1u) bucket(j, code[k], lo[k], end[k]);
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    head[k] = lo[k] < end[k] ? j.sq[lo[k]] : Key(0);
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    n_keys[k] = run_in_bucket(j.sq, lo[k], end[k], head[k], code[k], pos[k]);
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (!kCsr) {
      start[k] = i0 + k;
      plen[k] = 1;
    } else if (n_keys[k] > 0) {
      if (!kHits) {
        start[k] = j.offs[i0 + k];
        stop[k] = j.offs[i0 + k + 1];
      }
      plen[k] = stop[k] - start[k];
      n_keys[k] *= plen[k];
    }
  }
}

// Exclusive scan of one value a thread over the block, in thread order,
// with warp shuffles and one shared word a warp; `total` receives the
// block's sum. Every thread of the block must call it.
__device__ __forceinline__ int64_t block_exclusive_scan(int64_t v,
                                                        int64_t* warp_sums,
                                                        int64_t& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t up =
        __shfl_up_sync(0xFFFFFFFFu, static_cast<long long>(incl), d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int64_t before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += warp_sums[w];
    total += warp_sums[w];
  }
  __syncthreads();  // warp_sums may be written again by the next scan
  return before + incl - v;
}

// pass 0: a hit bit per row, the hit keys and fill pieces of every tile
template <typename Key, bool kCsr>
__global__ void __launch_bounds__(kThreads)
join_count_kernel(Join<Key> j, uint32_t* __restrict__ hit_bits,
                  int64_t* __restrict__ tile_counts, int64_t n_tiles) {
  __shared__ int64_t warp_keys[kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int64_t keys = 0;
#pragma unroll 1
  for (int step = 0; step < kSteps; ++step) {
    const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kTileRows +
                       step * kStepRows + t * kRowsPerThread;
    unsigned rows = 0;
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      if (i0 + k < j.n_rows) rows |= 1u << k;
    }
    int64_t n_keys[kRowsPerThread], pos[kRowsPerThread],
        start[kRowsPerThread], plen[kRowsPerThread];
    lookup_rows<Key, kCsr, false>(j, i0, rows, n_keys, pos, start, plen);
    unsigned nibble = 0;
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      nibble |= static_cast<unsigned>(n_keys[k] > 0) << k;
      keys += n_keys[k];
    }
    // the warp's 128 rows as 4 words of 32 consecutive rows: word m holds
    // the nibbles of lanes 8m .. 8m + 7
    uint32_t word[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      word[m] = __reduce_or_sync(
          0xFFFFFFFFu, (lane >> 3) == m ? nibble << (4 * (lane & 7)) : 0u);
    }
    if (lane < 4) {
      hit_bits[static_cast<int64_t>(blockIdx.x) * kTileWords +
               step * (kStepRows / 32) + warp * 4 + lane] =
          lane == 0 ? word[0] : lane == 1 ? word[1] : lane == 2 ? word[2] : word[3];
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    keys += __shfl_down_sync(0xFFFFFFFFu, static_cast<long long>(keys), d);
  }
  if (lane == 0) warp_keys[warp] = keys;
  __syncthreads();
  if (t == 0) {
    int64_t total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_keys[w];
    tile_counts[blockIdx.x] = total;
    tile_counts[n_tiles + blockIdx.x] =
        total > kPieceKeys ? (total + kPieceKeys - 1) / kPieceKeys : 1;
  }
}

// pass 1: the keys of one piece of one tile, at their place in the output
template <typename Key, bool kCsr>
__global__ void __launch_bounds__(kThreads)
join_fill_kernel(Join<Key> j, const uint32_t* __restrict__ hit_bits,
                 const int64_t* __restrict__ cum, int64_t n_tiles,
                 int64_t n_pieces, int qid_shift, int64_t* __restrict__ keys) {
  __shared__ uint16_t s_rows[kTileRows];  // the tile's hit rows, in order
  // a batch of hit rows, 32-bit where the caller's limits allow (keys a
  // call < 2^32, table entries < 2^32)
  __shared__ uint32_t s_end[kThreads];    // inclusive key offset in the tile
  __shared__ uint32_t s_pos[kThreads];    // its run's first table position
  __shared__ int64_t s_start[kThreads];   // its first posting (raw: the row)
  __shared__ uint32_t s_plen[kCsr ? kThreads : 1];  // its postings (CSR)
  __shared__ int64_t warp_sums[kWarps];

  // the tile whose pieces cover this block: the first t with
  // pcum[t] > b. Every tile has at least one piece, so t <= b, and at
  // most n_pieces - n_tiles of them have more, so t >= b - that.
  const int64_t* pcum = cum + n_tiles;
  const int64_t b = blockIdx.x;
  int64_t lo = b - (n_pieces - n_tiles);
  int64_t hi = b < n_tiles - 1 ? b : n_tiles - 1;
  if (lo < 0) lo = 0;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (pcum[mid] > b) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  const int64_t tile = lo;
  const int t = threadIdx.x;
  // this thread's word of hit bits, loaded with the offsets
  const uint32_t word = t < kTileWords ? hit_bits[tile * kTileWords + t] : 0u;
  const int64_t base = tile > 0 ? cum[tile - 1] : 0;
  const int64_t s0 = (b - (tile > 0 ? pcum[tile - 1] : 0)) * kPieceKeys;
  const int64_t n_tile_keys = cum[tile] - base;
  const int64_t s1 = s0 + kPieceKeys < n_tile_keys ? s0 + kPieceKeys : n_tile_keys;
  if (s0 >= s1) return;  // block-uniform: a tile without hits

  // the tile's hit rows in order: word t holds rows 32t .. 32t + 31
  int64_t n_hit;
  int r = static_cast<int>(block_exclusive_scan(__popc(word), warp_sums, n_hit));
  for (uint32_t w = word; w != 0; w &= w - 1) {
    s_rows[r++] = static_cast<uint16_t>(32 * t + __ffs(w) - 1);
  }
  __syncthreads();

  // batches of 256 hit rows, one a thread, until the piece is written
  const uint64_t shift = static_cast<uint64_t>(qid_shift);
  int64_t carry = 0;  // keys of the tile before this batch
  for (int64_t b0 = 0; b0 < n_hit && carry < s1; b0 += kThreads) {
    int64_t n_keys[1] = {0}, pos[1], start[1], plen[1];
    if (b0 + t < n_hit) {
      lookup_rows<Key, kCsr, true>(j, tile * kTileRows + s_rows[b0 + t], 1u,
                                   n_keys, pos, start, plen);
    }
    int64_t batch;
    const int64_t before = block_exclusive_scan(n_keys[0], warp_sums, batch);
    if (b0 + t < n_hit) {
      s_end[t] = static_cast<uint32_t>(carry + before + n_keys[0]);
      s_pos[t] = static_cast<uint32_t>(pos[0]);
      s_start[t] = start[0];
      if (kCsr) s_plen[t] = static_cast<uint32_t>(plen[0]);
    }
    __syncthreads();
    // the batch's slots within the piece, the block's threads together
    const int last = static_cast<int>(n_hit - b0 < kThreads ? n_hit - b0 : kThreads) - 1;
    const int64_t from = carry > s0 ? carry : s0;
    const int64_t to = carry + batch < s1 ? carry + batch : s1;
    for (uint32_t s = static_cast<uint32_t>(from) + t; s < to; s += kThreads) {
      int l = 0, h = last;  // the first row of the batch whose end exceeds s
      while (l < h) {
        const int m = (l + h) >> 1;
        if (s_end[m] > s) {
          h = m;
        } else {
          l = m + 1;
        }
      }
      const uint32_t within =
          s - (l > 0 ? s_end[l - 1] : static_cast<uint32_t>(carry));
      int64_t qp, g;
      if (kCsr) {
        const uint32_t pl = s_plen[l];
        const uint32_t qi = within / pl;
        qp = s_pos[l] + qi;
        g = s_start[l] + (within - qi * pl);
      } else {
        qp = s_pos[l] + within;
        g = s_start[l];
      }
      const uint64_t qid = static_cast<uint32_t>(j.sqid[qp]);
      const uint64_t rid = static_cast<uint32_t>(j.gids[g]);
      keys[base + s] = static_cast<int64_t>((qid << shift) | (rid << 16) |
                                            static_cast<uint64_t>(j.sab[qp]));
    }
    carry += batch;
    __syncthreads();  // the batch's rows are read before the next is written
  }
}

template <typename Key, bool kCsr>
int launch(int pass, const Join<Key>& j, int64_t n_tiles, int64_t n_pieces,
           int qid_shift, void* hit_bits, void* tile_counts, void* keys,
           void* stream) {
  if (n_tiles != (j.n_rows + kTileRows - 1) / kTileRows || j.n_buckets < 1 ||
      j.shift < 0 || j.shift > 64 || qid_shift < 16 || qid_shift > 62 ||
      (pass != 0 && n_pieces < n_tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (pass == 0) {
    join_count_kernel<Key, kCsr><<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(
        j, static_cast<uint32_t*>(hit_bits), static_cast<int64_t*>(tile_counts),
        n_tiles);
  } else {
    join_fill_kernel<Key, kCsr><<<static_cast<unsigned>(n_pieces), kThreads, 0, s>>>(
        j, static_cast<const uint32_t*>(hit_bits),
        static_cast<const int64_t*>(tile_counts), n_tiles, n_pieces, qid_shift,
        static_cast<int64_t*>(keys));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename Key>
Join<Key> join_args(const void* u, int64_t n_rows, const void* offs,
                    const void* gids, const void* sq, const void* sqid,
                    const void* sab, const void* dir, int64_t n_buckets,
                    int dir_shift) {
  return Join<Key>{static_cast<const Key*>(u), n_rows,
                   static_cast<const int64_t*>(offs),
                   static_cast<const int32_t*>(gids),
                   static_cast<const Key*>(sq),
                   static_cast<const int32_t*>(sqid),
                   static_cast<const uint32_t*>(sab),
                   static_cast<const int32_t*>(dir), n_buckets, dir_shift};
}

}  // namespace

// The rows of a tile, which the caller reads to size hit_bits and
// tile_counts and to compute n_tiles.
extern "C" int kssd_join_tile_rows() { return kTileRows; }

// pass 0: hit_bits receives uint32 [n_tiles * 128] (bit b of word w of a
//   tile: its row 32w + b) and tile_counts int64 [2, n_tiles]: the hit
//   keys of every tile of kssd_join_tile_rows() rows, and its fill pieces
//   (ceil(keys / 4,096), at least 1).
// pass 1: tile_counts holds the inclusive cumsum of each of its two rows;
//   n_pieces is the last entry of the second; keys receives the last entry
//   of the first (int64 keys, DB row-major, query entry outer, posting
//   inner), which must be below 2^32, as n_q must.
// n_tiles must be ceil(n_rows / kssd_join_tile_rows()). offs = NULL
// selects the raw-code route (row i is the single posting gids[i]);
// otherwise offs is int64 [n_rows + 1] absolute offsets into gids. u and
// sq are uint32 codes, sq ascending, with its bucket directory dir int32
// [n_buckets + 1] (dir[b] = lower bound of b << dir_shift in sq,
// dir[n_buckets] = n_q).
extern "C" int kssd_join(int pass, const void* u, int64_t n_rows,
                         const void* offs, const void* gids, const void* sq,
                         const void* sqid, const void* sab, const void* dir,
                         int64_t n_buckets, int dir_shift, int qid_shift,
                         int64_t n_tiles, int64_t n_pieces, void* hit_bits,
                         void* tile_counts, void* keys, void* stream) {
  const auto j = join_args<uint32_t>(u, n_rows, offs, gids, sq, sqid, sab,
                                     dir, n_buckets, dir_shift);
  if (offs != nullptr) {
    return launch<uint32_t, true>(pass, j, n_tiles, n_pieces, qid_shift,
                                  hit_bits, tile_counts, keys, stream);
  }
  return launch<uint32_t, false>(pass, j, n_tiles, n_pieces, qid_shift,
                                 hit_bits, tile_counts, keys, stream);
}

// The raw-code route on uint64 keys: u [n_rows] folded DB keys, gids
// [n_rows] their genome ids, sq [n_q] the ascending folded query keys and
// its directory; the rest as kssd_join.
extern "C" int kssd_join64(int pass, const void* u, int64_t n_rows,
                           const void* gids, const void* sq, const void* sqid,
                           const void* sab, const void* dir, int64_t n_buckets,
                           int dir_shift, int qid_shift, int64_t n_tiles,
                           int64_t n_pieces, void* hit_bits, void* tile_counts,
                           void* keys, void* stream) {
  const auto j = join_args<uint64_t>(u, n_rows, nullptr, gids, sq, sqid, sab,
                                     dir, n_buckets, dir_shift);
  return launch<uint64_t, false>(pass, j, n_tiles, n_pieces, qid_shift,
                                 hit_bits, tile_counts, keys, stream);
}
