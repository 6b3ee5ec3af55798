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

__device__ __forceinline__ int64_t lower_bound(const uint32_t* __restrict__ a,
                                               int64_t n, uint32_t v) {
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

__device__ __forceinline__ int64_t upper_bound(const uint32_t* __restrict__ a,
                                               int64_t lo, int64_t n,
                                               uint32_t v) {
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

template <bool kCsr, bool kFill>
__global__ void __launch_bounds__(kThreads)
join_kernel(const uint32_t* __restrict__ u, int64_t n_rows,
            const int64_t* __restrict__ offs, const int32_t* __restrict__ gids,
            const uint32_t* __restrict__ sq, const int32_t* __restrict__ sqid,
            const uint32_t* __restrict__ sab, int64_t n_q, int qid_shift,
            int64_t* __restrict__ len_or_cum, int64_t* __restrict__ keys) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n_rows; i += stride) {
    const int64_t start = kCsr ? offs[i] : i;
    const int64_t plen = kCsr ? offs[i + 1] - start : 1;
    if (!kFill) {
      const uint32_t code = u[i];
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

template <bool kCsr>
void launch(int fill, unsigned blocks, cudaStream_t stream,
            const uint32_t* u, int64_t n_rows, const int64_t* offs,
            const int32_t* gids, const uint32_t* sq, const int32_t* sqid,
            const uint32_t* sab, int64_t n_q, int qid_shift,
            int64_t* len_or_cum, int64_t* keys) {
  if (fill) {
    join_kernel<kCsr, true><<<blocks, kThreads, 0, stream>>>(
        u, n_rows, offs, gids, sq, sqid, sab, n_q, qid_shift, len_or_cum,
        keys);
  } else {
    join_kernel<kCsr, false><<<blocks, kThreads, 0, stream>>>(
        u, n_rows, offs, gids, sq, sqid, sab, n_q, qid_shift, len_or_cum,
        keys);
  }
}

}  // namespace

// fill = 0: len_or_cum receives int64 [n_rows] hit counts per row.
// fill = 1: len_or_cum holds their inclusive cumsum; keys receives
// cum[n_rows - 1] int64 keys. offs = NULL selects the raw-code route
// (row i is the single posting gids[i]); otherwise offs is int64
// [n_rows + 1] absolute offsets into gids.
extern "C" int kssd_join(int fill, const void* u, int64_t n_rows,
                         const void* offs, const void* gids, const void* sq,
                         const void* sqid, const void* sab, int64_t n_q,
                         int qid_shift, void* len_or_cum, void* keys,
                         void* stream) {
  if (n_rows <= 0) return 0;
  int64_t blocks = (n_rows + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond one wave
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* u32 = static_cast<const uint32_t*>(u);
  const auto* o64 = static_cast<const int64_t*>(offs);
  const auto* g32 = static_cast<const int32_t*>(gids);
  const auto* sq32 = static_cast<const uint32_t*>(sq);
  const auto* sqid32 = static_cast<const int32_t*>(sqid);
  const auto* sab32 = static_cast<const uint32_t*>(sab);
  auto* lc = static_cast<int64_t*>(len_or_cum);
  auto* k = static_cast<int64_t*>(keys);
  if (o64 != nullptr) {
    launch<true>(fill, static_cast<unsigned>(blocks), s, u32, n_rows, o64,
                 g32, sq32, sqid32, sab32, n_q, qid_shift, lc, k);
  } else {
    launch<false>(fill, static_cast<unsigned>(blocks), s, u32, n_rows, o64,
                  g32, sq32, sqid32, sab32, n_q, qid_shift, lc, k);
  }
  return static_cast<int>(cudaGetLastError());
}
