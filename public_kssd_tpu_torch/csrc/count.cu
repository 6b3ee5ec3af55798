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
// One thread per query code (grid-stride): a lower-bound binary search of
// the code in the sorted unique DB codes, then, on a hit, one atomicAdd
// per posting into counts[qid * n_ref + gid]. Indexing is 64-bit, so the
// matrix size is bounded only by device memory.
//
// The weighted instance (entry kssd_count_koc) replaces
// public_kssd_tpu/ops/count.py:_count_weighted_rowgather and
// count_shared_weighted_device: in the same single walk each posting also
// adds the query code's abundance (uint32) into a uint64 matrix with a
// 64-bit atomicAdd, so a koc search walks the index once for both tables.
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
// What bounds it on an H100: dependent global loads (log2(nnz) probes per
// code, mostly L2 hits for the upper levels of the search) and the
// atomics. A skew in postings-list length makes threads uneven (a later
// design: warp-per-code for long rows, shared-memory staging).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename Key, bool kWeighted>
__global__ void __launch_bounds__(kThreads)
count_shared_kernel(const Key* __restrict__ qry_codes,
                    const int32_t* __restrict__ qry_qid,
                    const uint32_t* __restrict__ qry_weights, int64_t n_codes,
                    const Key* __restrict__ uniq, int64_t nnz,
                    const int64_t* __restrict__ offsets,
                    const uint32_t* __restrict__ gids, int64_t n_ref,
                    uint32_t* __restrict__ counts,
                    unsigned long long* __restrict__ weighted) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n_codes; i += stride) {
    const int32_t q = qry_qid[i];
    if (q < 0) continue;
    const Key code = qry_codes[i];
    int64_t lo = 0, hi = nnz;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (uniq[mid] < code) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    if (lo >= nnz || uniq[lo] != code) continue;
    const int64_t row = static_cast<int64_t>(q) * n_ref;
    const int64_t end = offsets[lo + 1];
    if (kWeighted) {
      const unsigned long long w = qry_weights[i];
      for (int64_t j = offsets[lo]; j < end; ++j) {
        atomicAdd(counts + row + gids[j], 1u);
        atomicAdd(weighted + row + gids[j], w);
      }
    } else {
      for (int64_t j = offsets[lo]; j < end; ++j) {
        atomicAdd(counts + row + gids[j], 1u);
      }
    }
  }
}

unsigned grid_for(int64_t n_codes) {
  int64_t blocks = (n_codes + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond one wave
  return static_cast<unsigned>(blocks);
}

template <typename Key, bool kWeighted>
int launch(const void* qry_codes, const void* qry_qid, const void* qry_weights,
           int64_t n_codes, const void* uniq, int64_t nnz, const void* offsets,
           const void* gids, int64_t n_ref, void* counts, void* weighted,
           void* stream) {
  if (n_codes <= 0 || nnz <= 0) return 0;
  count_shared_kernel<Key, kWeighted><<<grid_for(n_codes), kThreads, 0,
                                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Key*>(qry_codes),
      static_cast<const int32_t*>(qry_qid),
      static_cast<const uint32_t*>(qry_weights), n_codes,
      static_cast<const Key*>(uniq), nnz,
      static_cast<const int64_t*>(offsets),
      static_cast<const uint32_t*>(gids), n_ref,
      static_cast<uint32_t*>(counts),
      static_cast<unsigned long long*>(weighted));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qry_codes and uniq: uint32 codes (kssd_count_shared, kssd_count_koc) or
// uint64 folded keys (the *64 entries), uniq ascending; qry_qid int32
// (negative: skipped); offsets int64 [nnz + 1]; gids uint32 column ids.
// counts: uint32 [n_qry, n_ref]; weighted: uint64 [n_qry, n_ref], int64
// on the torch side (the weights are the .a files' uint16 abundances, so
// the sums stay far below 2^63). Both must be zeroed by the caller.
extern "C" int kssd_count_shared(const void* qry_codes, const void* qry_qid,
                                 int64_t n_codes, const void* uniq,
                                 int64_t nnz, const void* offsets,
                                 const void* gids, int64_t n_ref,
                                 void* counts, void* stream) {
  return launch<uint32_t, false>(qry_codes, qry_qid, nullptr, n_codes, uniq,
                                 nnz, offsets, gids, n_ref, counts, nullptr,
                                 stream);
}

extern "C" int kssd_count_koc(const void* qry_codes, const void* qry_qid,
                              const void* qry_weights, int64_t n_codes,
                              const void* uniq, int64_t nnz,
                              const void* offsets, const void* gids,
                              int64_t n_ref, void* counts, void* weighted,
                              void* stream) {
  return launch<uint32_t, true>(qry_codes, qry_qid, qry_weights, n_codes,
                                uniq, nnz, offsets, gids, n_ref, counts,
                                weighted, stream);
}

extern "C" int kssd_count_shared64(const void* qry_codes, const void* qry_qid,
                                   int64_t n_codes, const void* uniq,
                                   int64_t nnz, const void* offsets,
                                   const void* gids, int64_t n_ref,
                                   void* counts, void* stream) {
  return launch<uint64_t, false>(qry_codes, qry_qid, nullptr, n_codes, uniq,
                                 nnz, offsets, gids, n_ref, counts, nullptr,
                                 stream);
}

extern "C" int kssd_count_koc64(const void* qry_codes, const void* qry_qid,
                                const void* qry_weights, int64_t n_codes,
                                const void* uniq, int64_t nnz,
                                const void* offsets, const void* gids,
                                int64_t n_ref, void* counts, void* weighted,
                                void* stream) {
  return launch<uint64_t, true>(qry_codes, qry_qid, qry_weights, n_codes,
                                uniq, nnz, offsets, gids, n_ref, counts,
                                weighted, stream);
}
