// Composite join: reference DB rows x the combined sorted query table ->
// packed int64 hit keys  qid << qid_shift | rid << 16 | abundance.
//
// Replaces public_kssd_tpu/composite.py:_csr_join_impl (the inverted
// index route) and _batched_join_impl (raw DB codes). Those expand every
// hit into a fixed-capacity buffer with an int32 cumsum and retry with a
// larger capacity on overflow; here two launches size the output exactly:
//
//   pass 0 (lengths): one thread per DB row i (grid-stride) finds the run
//     [pos_l, pos_r) of its code u[i] in the sorted query codes (a lower
//     bound, then an upper bound only when the code is there) and writes
//     len[i] = (pos_r - pos_l) * plen[i] as int64 (no int32 wrap under
//     skew). The caller takes an inclusive cumsum of len and allocates
//     exactly cum[C-1] keys.
//   pass 1 (fill): the same thread reads len[i] = cum[i] - cum[i-1] back,
//     so a row without hits (most rows) does no search; a row with hits
//     finds pos_l again and writes its keys at cum[i] - len[i], query
//     entry outer, posting inner: the order of the plain PyTorch
//     version, so the two agree element for element.
//
// A CSR row (kCsr) has postings gids[offs[i] .. offs[i+1]); a raw DB code
// is a row with the single posting gids[i] (its genome id), so one kernel
// serves both routes with no offsets array for the raw one.
//
// The 64-bit-key instance (entry kssd_join64, raw route) replaces
// public_kssd_tpu/parallel/sharded_composite.py:_make_join_fn, the
// per-shard join of composite --mesh: there every component's DB codes
// and the query table are folded into uint64 keys comp << 32 | code, so
// the row codes and the sorted query table are uint64 and compare
// unsigned. The key layout, the lengths launch and the fill launch are the
// 32-bit kernel's.
//
// What bounds it on an H100: the dependent loads of the binary searches
// (log2 Q probes per row, the upper levels in L2) and, in pass 1, the
// key writes (8 B per hit). A row whose code many queries share, times a
// long postings list, is one thread's serial work (a later design:
// warp-per-row for heavy rows, and the hit sort + segment statistics on
// the card).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename Key>
__device__ __forceinline__ int64_t lower_bound(const Key* __restrict__ a,
                                               int64_t n, Key v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <typename Key>
__device__ __forceinline__ int64_t upper_bound(const Key* __restrict__ a,
                                               int64_t lo, int64_t n, Key v) {
  int64_t hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a[mid] <= v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <typename Key, bool kCsr, bool kFill>
__global__ void __launch_bounds__(kThreads)
join_kernel(const Key* __restrict__ u, int64_t n_rows,
            const int64_t* __restrict__ offs, const int32_t* __restrict__ gids,
            const Key* __restrict__ sq, const int32_t* __restrict__ sqid,
            const uint32_t* __restrict__ sab, int64_t n_q, int qid_shift,
            int64_t* __restrict__ len_or_cum, int64_t* __restrict__ keys) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n_rows; i += stride) {
    const int64_t start = kCsr ? offs[i] : i;
    const int64_t plen = kCsr ? offs[i + 1] - start : 1;
    if (!kFill) {
      const Key code = u[i];
      const int64_t pos_l = lower_bound(sq, n_q, code);
      const bool hit = pos_l < n_q && sq[pos_l] == code;
      len_or_cum[i] =
          hit ? (upper_bound(sq, pos_l, n_q, code) - pos_l) * plen : 0;
      continue;
    }
    const int64_t len = len_or_cum[i] - (i > 0 ? len_or_cum[i - 1] : 0);
    if (len == 0) continue;
    const int64_t pos_l = lower_bound(sq, n_q, u[i]);
    const int64_t pos_r = pos_l + len / plen;
    int64_t* out = keys + (len_or_cum[i] - len);
    for (int64_t qp = pos_l; qp < pos_r; ++qp) {
      const uint64_t head =
          (static_cast<uint64_t>(static_cast<uint32_t>(sqid[qp])) << qid_shift) |
          static_cast<uint64_t>(sab[qp]);
      for (int64_t p = 0; p < plen; ++p) {
        const uint64_t rid = static_cast<uint32_t>(gids[start + p]);
        *out++ = static_cast<int64_t>(head | (rid << 16));
      }
    }
  }
}

template <typename Key, bool kCsr>
int launch(int fill, int64_t n_rows, void* stream, const void* u,
           const void* offs, const void* gids, const void* sq,
           const void* sqid, const void* sab, int64_t n_q, int qid_shift,
           void* len_or_cum, void* keys) {
  if (n_rows <= 0) return 0;
  int64_t blocks = (n_rows + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond one wave
  const auto kernel = fill ? join_kernel<Key, kCsr, true>
                            : join_kernel<Key, kCsr, false>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Key*>(u), n_rows, static_cast<const int64_t*>(offs),
      static_cast<const int32_t*>(gids), static_cast<const Key*>(sq),
      static_cast<const int32_t*>(sqid), static_cast<const uint32_t*>(sab),
      n_q, qid_shift, static_cast<int64_t*>(len_or_cum),
      static_cast<int64_t*>(keys));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fill = 0: len_or_cum receives int64 [n_rows] hit counts per row.
// fill = 1: len_or_cum holds their inclusive cumsum; keys receives
// cum[n_rows - 1] int64 keys. offs = NULL selects the raw-code route
// (row i is the single posting gids[i]); otherwise offs is int64
// [n_rows + 1] absolute offsets into gids. u and sq are uint32 codes.
extern "C" int kssd_join(int fill, const void* u, int64_t n_rows,
                         const void* offs, const void* gids, const void* sq,
                         const void* sqid, const void* sab, int64_t n_q,
                         int qid_shift, void* len_or_cum, void* keys,
                         void* stream) {
  if (offs != nullptr) {
    return launch<uint32_t, true>(fill, n_rows, stream, u, offs, gids, sq,
                                  sqid, sab, n_q, qid_shift, len_or_cum, keys);
  }
  return launch<uint32_t, false>(fill, n_rows, stream, u, offs, gids, sq, sqid,
                                 sab, n_q, qid_shift, len_or_cum, keys);
}

// The raw-code route on uint64 keys: u [n_rows] folded DB keys, gids
// [n_rows] their genome ids, sq [n_q] the ascending folded query keys;
// the rest as kssd_join.
extern "C" int kssd_join64(int fill, const void* u, int64_t n_rows,
                           const void* gids, const void* sq, const void* sqid,
                           const void* sab, int64_t n_q, int qid_shift,
                           void* len_or_cum, void* keys, void* stream) {
  return launch<uint64_t, false>(fill, n_rows, stream, u, nullptr, gids, sq,
                                 sqid, sab, n_q, qid_shift, len_or_cum, keys);
}
