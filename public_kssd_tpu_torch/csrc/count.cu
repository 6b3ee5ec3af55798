// Shared-k-mer counting: query sketch codes x CSR inverted index ->
// count matrix [n_qry, n_ref] (the search hot loop), and its
// abundance-weighted twin for --koc-out.
//
// Replaces public_kssd_tpu/ops/count.py:_count_rowgather together with
// its pair-capacity retry loop (_run_counting): that design expands every
// (query code x posting) pair into a fixed-capacity buffer and
// scatter-adds; here each thread walks its own postings and adds with
// integer atomics, so there is no capacity, no retry, and the counts are
// exact and independent of order.
//
// The weighted instance (entry kssd_count_koc) replaces
// public_kssd_tpu/ops/count.py:_count_weighted_rowgather and
// count_shared_weighted_device: in the same single walk each posting also
// adds the query code's abundance (uint32) into a uint64 sum, so a koc
// search walks the index once for both tables.
//
// The 64-bit-key instances (entries kssd_count_shared64 and
// kssd_count_koc64) replace public_kssd_tpu/parallel/sharded_search.py:
// _count_partial and _count_partial_pair, the per-shard counting of a
// mesh search: there the DB codes of all components are folded into one
// uint64 key space (code << comp_code_bits | component), so the search and
// the compare run on uint64 keys. Query ids, offsets and gids keep their
// types. Keys use all 64 bits at (k, s, l) = (16, s, 0); the compares here
// are unsigned.
//
// What bounds it on an H100: memory, in random sectors. The bytes a call
// must move (the query codes, one index key per code, the offsets and
// postings of the codes found, the count matrix written once) take ~0.02 ms
// at 1,000 queries x 10,000 refs x 1,300 codes; but every lookup reads a
// few 32-byte sectors at random places of a 200 MB index (its directory
// entry, its bucket's keys, its offsets, its postings), and HBM serves
// such reads at a small fraction of its streaming rate. So the design
// keeps the sectors a lookup touches few, and adds no pass over the count
// matrix beyond writing it once.
//
// The design:
//  * A bucket directory beside the index (DeviceIndex.dir, int64
//    [n_buckets + 1]): dir[b] is the lower bound in uniq of b << shift, so
//    the keys whose top bits are b lie in [dir[b], dir[b+1]). The wrapper
//    sizes it to ~8-16 keys a bucket (2^20 buckets, 8 MB, at 13M keys), so
//    a lookup is one directory read and a binary search over a few
//    adjacent sectors. A skewed bucket stays exact, only slower.
//  * Per-query rows in shared memory (variant 0). One block takes one
//    query's codes (the wrapper passes each query's segment [seg[q],
//    seg[q+1]) of codes grouped by ascending query id), accumulates its
//    row with shared-memory atomics (uint32 counts, and for koc uint64
//    sums) and writes the whole row back coalesced, zeros included, so the
//    output needs no zeroing pass. A row fits when n_ref * (4 | 12) bytes
//    is at most the block's opt-in shared memory (232,448 bytes on an
//    H100: ~58K references for counts, ~19K for koc).
//  * Global atomics (variant 1), for rows that do not fit: one thread per
//    query code (grid-stride), the same directory lookup, atomics into a
//    matrix the caller zeroed.
//  * A one-entry run buffer per thread (Pending): a 64-bit add to shared
//    memory compiles to a compare-and-swap loop, so a code repeated
//    thousands of times within one query (one hot cell) would serialise
//    the block; consecutive postings into one cell become one atomic.
// The wrapper chooses the variant by the row's size.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // global variant
constexpr int kRowThreads = 1024;  // shared-row variant: 2,048 threads an
                                   // SM at a 40 KB row, 1,024 at a koc row

struct Index {
  const void* uniq;
  int64_t nnz;
  const int64_t* dir;
  int64_t n_buckets;
  int shift;
  const int64_t* offsets;
  const uint32_t* gids;
};

// Row of `code` in the sorted unique keys, or -1 where it is absent.
template <typename Key>
__device__ __forceinline__ int64_t find(const Index& ix, Key code) {
  const uint64_t b =
      ix.shift >= 64 ? 0 : static_cast<uint64_t>(code) >> ix.shift;
  if (b >= static_cast<uint64_t>(ix.n_buckets)) return -1;
  const Key* __restrict__ uniq = static_cast<const Key*>(ix.uniq);
  int64_t lo = ix.dir[b];
  const int64_t end = ix.dir[b + 1];
  int64_t hi = end;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (uniq[mid] < code) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < end && uniq[lo] == code ? lo : -1;
}

// A thread's additions go through a one-entry buffer, so that a run of
// postings into one cell (a code repeated within a query, as a koc sample
// may hold it) costs one atomic per run instead of one per posting. With
// distinct cells it flushes at every posting: the same atomics as without.
template <bool kWeighted>
struct Pending {
  uint32_t* counts;
  unsigned long long* weighted;
  int64_t cell = -1;
  uint32_t n = 0;
  unsigned long long w = 0;

  __device__ __forceinline__ Pending(uint32_t* c, unsigned long long* s)
      : counts(c), weighted(s) {}

  __device__ __forceinline__ void add(int64_t at, unsigned long long weight) {
    if (at != cell) {
      flush();
      cell = at;
      n = 0;
      w = 0;
    }
    ++n;
    if (kWeighted) w += weight;
  }

  __device__ __forceinline__ void flush() {
    if (n == 0) return;
    atomicAdd(counts + cell, n);
    if (kWeighted) atomicAdd(weighted + cell, w);
  }
};

template <typename Key, bool kWeighted>
__global__ void __launch_bounds__(kRowThreads)
count_row_kernel(const Key* __restrict__ qry_codes,
                 const uint32_t* __restrict__ qry_weights,
                 const int64_t* __restrict__ seg, Index ix, int64_t n_ref,
                 uint32_t* __restrict__ counts,
                 unsigned long long* __restrict__ weighted) {
  extern __shared__ __align__(16) unsigned char smem[];
  // koc: the uint64 sums first, so both rows stay aligned
  unsigned long long* wrow = reinterpret_cast<unsigned long long*>(smem);
  uint32_t* crow = reinterpret_cast<uint32_t*>(smem + (kWeighted ? 8 * n_ref : 0));
  for (int64_t j = threadIdx.x; j < n_ref; j += kRowThreads) {
    crow[j] = 0u;
    if (kWeighted) wrow[j] = 0ull;
  }
  __syncthreads();

  const int64_t q = blockIdx.x;
  const int64_t end = seg[q + 1];
  Pending<kWeighted> acc(crow, wrow);
  for (int64_t i = seg[q] + threadIdx.x; i < end; i += kRowThreads) {
    const int64_t r = find<Key>(ix, qry_codes[i]);
    if (r < 0) continue;
    const unsigned long long w = kWeighted ? qry_weights[i] : 0ull;
    const int64_t stop = ix.offsets[r + 1];
    for (int64_t j = ix.offsets[r]; j < stop; ++j) acc.add(ix.gids[j], w);
  }
  acc.flush();
  __syncthreads();

  const int64_t row = q * n_ref;
  for (int64_t j = threadIdx.x; j < n_ref; j += kRowThreads) {
    counts[row + j] = crow[j];
    if (kWeighted) weighted[row + j] = wrow[j];
  }
}

template <typename Key, bool kWeighted>
__global__ void __launch_bounds__(kThreads)
count_global_kernel(const Key* __restrict__ qry_codes,
                    const int32_t* __restrict__ qry_qid,
                    const uint32_t* __restrict__ qry_weights, int64_t n_codes,
                    int64_t n_qry, Index ix, int64_t n_ref,
                    uint32_t* __restrict__ counts,
                    unsigned long long* __restrict__ weighted) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  Pending<kWeighted> acc(counts, weighted);
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n_codes; i += stride) {
    const int32_t q = qry_qid[i];
    if (q < 0 || q >= n_qry) continue;
    const int64_t r = find<Key>(ix, qry_codes[i]);
    if (r < 0) continue;
    const unsigned long long w = kWeighted ? qry_weights[i] : 0ull;
    const int64_t row = static_cast<int64_t>(q) * n_ref;
    const int64_t stop = ix.offsets[r + 1];
    for (int64_t j = ix.offsets[r]; j < stop; ++j) acc.add(row + ix.gids[j], w);
  }
  acc.flush();
}

template <typename Key, bool kWeighted>
int launch(int variant, const void* qry_codes, const void* qry_qid,
           const void* qry_weights, int64_t n_codes, const void* seg,
           int64_t n_qry, const Index& ix, int64_t n_ref, void* counts,
           void* weighted, void* stream) {
  if (n_qry <= 0 || n_ref <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (variant == 0) {
    const int64_t bytes = n_ref * (kWeighted ? 12 : 4);
    int device = 0, limit = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           device);
    if (bytes > limit || n_qry > 0x7FFFFFFF)
      return static_cast<int>(cudaErrorInvalidValue);
    const auto kernel = count_row_kernel<Key, kWeighted>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<static_cast<unsigned>(n_qry), kRowThreads,
             static_cast<size_t>(bytes), s>>>(
        static_cast<const Key*>(qry_codes),
        static_cast<const uint32_t*>(qry_weights),
        static_cast<const int64_t*>(seg), ix, n_ref,
        static_cast<uint32_t*>(counts),
        static_cast<unsigned long long*>(weighted));
  } else {
    if (n_codes <= 0 || ix.nnz <= 0) return 0;
    int64_t blocks = (n_codes + kThreads - 1) / kThreads;
    if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond one wave
    count_global_kernel<Key, kWeighted>
        <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
            static_cast<const Key*>(qry_codes),
            static_cast<const int32_t*>(qry_qid),
            static_cast<const uint32_t*>(qry_weights), n_codes, n_qry, ix,
            n_ref, static_cast<uint32_t*>(counts),
            static_cast<unsigned long long*>(weighted));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// variant 0: shared-memory rows. seg int64 [n_qry + 1]: query q's codes
//   are qry_codes[seg[q] .. seg[q+1]); every row is written, zeros
//   included (qry_qid is not read).
// variant 1: global atomics. qry_qid int32 per code (negative or >= n_qry:
//   skipped); counts (and weighted) must be zeroed by the caller (seg is
//   not read).
// qry_codes and uniq: uint32 codes (kssd_count_shared, kssd_count_koc) or
// uint64 folded keys (the *64 entries), uniq ascending; dir int64
// [n_buckets + 1] with dir[b] = lower bound of b << shift in uniq and
// dir[n_buckets] = nnz; offsets int64 [nnz + 1]; gids uint32 column ids.
// counts: uint32 [n_qry, n_ref]; weighted: uint64 [n_qry, n_ref], int64
// on the torch side (the weights are the .a files' uint16 abundances, so
// the sums stay far below 2^63).
#define KSSD_COUNT_ARGS                                                      \
  int variant, const void *qry_codes, const void *qry_qid, int64_t n_codes, \
      const void *seg, int64_t n_qry, const void *uniq, int64_t nnz,         \
      const void *dir, int64_t n_buckets, int shift, const void *offsets,    \
      const void *gids, int64_t n_ref, void *counts
#define KSSD_KOC_ARGS                                                        \
  int variant, const void *qry_codes, const void *qry_qid,                   \
      const void *qry_weights, int64_t n_codes, const void *seg,             \
      int64_t n_qry, const void *uniq, int64_t nnz, const void *dir,         \
      int64_t n_buckets, int shift, const void *offsets, const void *gids,   \
      int64_t n_ref, void *counts, void *weighted
#define KSSD_INDEX                                                           \
  const Index ix{uniq, nnz, static_cast<const int64_t*>(dir), n_buckets,     \
                 shift, static_cast<const int64_t*>(offsets),                \
                 static_cast<const uint32_t*>(gids)}

extern "C" int kssd_count_shared(KSSD_COUNT_ARGS, void* stream) {
  KSSD_INDEX;
  return launch<uint32_t, false>(variant, qry_codes, qry_qid, nullptr, n_codes,
                                 seg, n_qry, ix, n_ref, counts, nullptr, stream);
}

extern "C" int kssd_count_koc(KSSD_KOC_ARGS, void* stream) {
  KSSD_INDEX;
  return launch<uint32_t, true>(variant, qry_codes, qry_qid, qry_weights,
                                n_codes, seg, n_qry, ix, n_ref, counts,
                                weighted, stream);
}

extern "C" int kssd_count_shared64(KSSD_COUNT_ARGS, void* stream) {
  KSSD_INDEX;
  return launch<uint64_t, false>(variant, qry_codes, qry_qid, nullptr, n_codes,
                                 seg, n_qry, ix, n_ref, counts, nullptr, stream);
}

extern "C" int kssd_count_koc64(KSSD_KOC_ARGS, void* stream) {
  KSSD_INDEX;
  return launch<uint64_t, true>(variant, qry_codes, qry_qid, qry_weights,
                                n_codes, seg, n_qry, ix, n_ref, counts,
                                weighted, stream);
}
