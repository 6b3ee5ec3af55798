"""Metagenomic composition analysis (abundance estimation + .abv search).

Reference: command_composite.c.

  get_species_abundance (-r ref -q qry): per query sample, intersect the
  query's abundance-annotated sketch (koc) with every reference genome's
  sketch, then report per-reference matched-k-mer count, mean, 98-99
  percentile mean, median and max (:389-547) — or write a normalised
  binary abundance vector (.abv) with -b.

  index_abv (-i): fold all .abv under <ref>/abundance_Vec into an
  inverted abundance matrix + L2 norms (:317-387).

  abv_search (-s 0|1|2): cosine / L1 / L2 sample-vs-sample search over
  that matrix (:206-316).

On a torch device the -q join runs in the hand-written kernel
``csrc/join.cu`` (``join_kernel``; ``join_torch`` is its plain PyTorch
version, run for CPU tensors): every reference DB row — a code of the
stage II inverted index with its postings, or a raw DB code, read
straight onto the device, with its genome id made there — is joined
against ALL queries' sorted codes at once and
emits packed int64 hit keys ``qid << qid_shift | rid << 16 | abundance``.
The query table is built where the join runs (``_query_table_device``:
one stable ``torch.sort`` of ``code << 31 | qid``), and the keys stay
there: one ``torch.sort`` groups them by (query, reference), prefix sums
and gathers give each group's integer aggregates
(``_hits_to_stats_torch``; one key range after another when the keys
pass the device's free memory), and only those rows come back to the
host, so the report is the same bytes whichever backend computed them.
``device=None`` is the host numpy oracle; ``_query_table`` and
``_hits_to_stats``, the JAX package's host versions, stay as its
oracles. The host functions shared with public_kssd_tpu.composite are
copies kept identical by tests/test_torch_package.py.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from public_kssd_tpu_torch import formats, kernels, resolve_device, stattab, utils
from public_kssd_tpu_torch.ops import count as count_ops

BINVEC_DIRNAME = "abundance_Vec"  # command_composite.c:34
MIN_KM_S = 6  # command_composite.c:489-491
ST_PCTL = 0.98
ED_PCTL = 0.99
# samples x species cells above which -s auto-uses the dense search
ABV_DENSE_THRESHOLD = 1 << 22

# hits one join call may emit: the int64 key buffer of a chunk stays
# below 16 GiB of device memory
MAX_CHUNK_HITS = 1 << 31


def _segment_stats_np(rids, abunds, n_ref: int):
    """Per-ref integer aggregates of the (ref, abundance) hit pairs:
    (kmer_num, total, median, max, lastsum, lastn) — each int64 [n_ref].

    ``median`` is the reference's 1-indexed arr1[k//2] (0 when k < 2,
    arr1[0] = 0); the percentile window is arr1[st..min(floor(ed), k)]
    with st = int(k*0.98), ed = k*0.99 (command_composite.c:505-530).
    All aggregates are exact integers, so the float32 report math on top
    is bit-identical regardless of which backend produced them.
    """
    counts = np.bincount(rids, minlength=n_ref).astype(np.int64)
    if rids.size == 0:
        z = np.zeros(n_ref, np.int64)
        return counts, z, z.copy(), z.copy(), z.copy(), np.ones(n_ref, np.int64)
    o = np.lexsort((abunds, rids))
    vals = abunds[o].astype(np.int64)
    sums = np.bincount(
        rids, weights=abunds.astype(np.float64), minlength=n_ref
    ).astype(np.int64)
    seg_end = np.cumsum(counts)
    seg_start = seg_end - counts
    ex = np.concatenate([[0], np.cumsum(vals)])
    med_idx = np.clip(seg_start + np.maximum(counts // 2 - 1, 0), 0, vals.size - 1)
    median = np.where(counts >= 2, vals[med_idx], 0)
    maxv = np.where(counts >= 1, vals[np.clip(seg_end - 1, 0, vals.size - 1)], 0)
    kf = counts.astype(np.float64)
    st = (kf * ST_PCTL).astype(np.int64)  # C truncation (positive)
    hi = np.minimum((kf * ED_PCTL).astype(np.int64), counts)
    lastn = hi - st + 1
    # arr1[0] = 0 contributes nothing, so the st = 0 window folds into
    # the same prefix-difference as st >= 1
    lastsum = ex[seg_start + hi] - ex[seg_start + np.maximum(st, 1) - 1]
    return counts, sums, median, maxv, lastsum, lastn


def _check_hits(total: int) -> None:
    if total > MAX_CHUNK_HITS:
        raise MemoryError(
            f"composite hits per chunk ({total}) exceed the "
            "expansion limit; split the query sketch dir into "
            "smaller batches"
        )


def join_torch(
    u: torch.Tensor,  # int32 [C] bit view of uint32 DB row codes, or int64
    #                   bit view of uint64 folded keys (raw route only)
    offs: torch.Tensor | None,  # int64 [C+1] absolute postings offsets
    gids: torch.Tensor,  # int32 postings (CSR) or [C] genome ids (raw)
    sq: torch.Tensor,  # [Q] ascending query codes, ``u``'s dtype
    sqid: torch.Tensor,  # int32 [Q] query id per entry
    sab: torch.Tensor,  # int32 [Q] abundance per entry (< 2^16)
    qid_shift: int,
) -> torch.Tensor:
    """Plain version of the join (both instances): int64 hit keys of
    every (DB row x matching query entry x posting), row-major, query
    entry outer and posting inner. ``offs=None`` is the raw-code route:
    row i has the single posting ``gids[i]``. 64-bit keys compare in
    unsigned order (``count_ops._ordered``)."""
    dev = u.device
    codes, table = count_ops._ordered(u), count_ops._ordered(sq)
    n_rows = codes.numel()
    pos_l = torch.searchsorted(table, codes, side="left")
    pos_r = torch.searchsorted(table, codes, side="right")
    if offs is None:
        start = torch.arange(n_rows, dtype=torch.int64, device=dev)
        plen = torch.ones(n_rows, dtype=torch.int64, device=dev)
    else:
        start = offs[:-1]
        plen = offs[1:] - start
    lens = (pos_r - pos_l) * plen
    total = int(lens.sum()) if n_rows else 0
    _check_hits(total)
    if total == 0:
        return torch.zeros(0, dtype=torch.int64, device=dev)
    row = torch.repeat_interleave(
        torch.arange(n_rows, dtype=torch.int64, device=dev), lens
    )
    within = torch.arange(total, dtype=torch.int64, device=dev) - (
        torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens)
    )
    pl = plen[row]
    qpos = pos_l[row] + within // pl
    rid = gids[start[row] + within % pl].to(torch.int64)
    return (
        (sqid[qpos].to(torch.int64) << qid_shift)
        | (rid << 16)
        | count_ops._widen(sab[qpos])
    )


def query_directory(sq: torch.Tensor, max_key: int,
                    host_sq: torch.Tensor | None = None,
                    ) -> tuple[torch.Tensor, int]:
    """The join's bucket directory of the ascending query table ``sq``
    (int32 / int64 bit views, fewer than 2^31 entries) whose largest
    key, as an unsigned integer, is ``max_key`` (the caller has it on the
    host): ``(dir, shift)`` on ``sq``'s device, from
    ``count_ops.bucket_directory`` with 2^(bit_length(n_q) + 1) buckets,
    at most the max key's bit length, so 0.25-0.5 table entries a bucket
    for uniform codes; int32 entries, 16 MB at 1.4M entries (csrc/join.cu
    says why). ``host_sq``, the same table on the host, lets a small
    table (up to ``count_ops.HOST_DIRECTORY_KEYS`` entries) build its
    directory there and upload it, as ``count_ops.DeviceIndex`` does."""
    bits = min(sq.numel().bit_length() + 1, max_key.bit_length())
    small = host_sq is not None and sq.numel() <= count_ops.HOST_DIRECTORY_KEYS
    directory, shift = count_ops.bucket_directory(
        host_sq if small else sq, max_key, bits)
    return directory.to(device=sq.device, dtype=torch.int32), shift


def join_kernel(
    u: torch.Tensor,
    offs: torch.Tensor | None,
    gids: torch.Tensor,
    sq: torch.Tensor,
    sqid: torch.Tensor,
    sab: torch.Tensor,
    qid_shift: int,
    directory: tuple[torch.Tensor, int] | None = None,
) -> torch.Tensor:
    """int64 hit keys of one join chunk: ``csrc/join.cu`` for CUDA tensors
    (a count pass writing a hit bit a row and the keys of every tile of
    rows, ``torch.cumsum`` over the tiles, an exact allocation, a fill
    pass; ``kssd_join64`` when ``u`` and ``sq`` are int64 bit views of
    uint64 folded keys, the raw route of ``composite --mesh``),
    ``join_torch`` for CPU tensors. Same keys in the same order.

    ``directory`` is the query table's ``query_directory``; callers that
    join many chunks against one table build it once. Without it the
    wrapper builds it, reading back the table's last key."""
    if u.device.type != "cuda":
        return join_torch(u, offs, gids, sq, sqid, sab, qid_shift)
    dev = u.device
    wide = u.dtype == torch.int64
    if wide and offs is not None:
        raise ValueError("64-bit keys: only the raw-code route (offs=None)")
    for name, t in (("u", u), ("gids", gids), ("sq", sq), ("sqid", sqid),
                    ("sab", sab)):
        dtype = u.dtype if name in ("u", "sq") else torch.int32
        if t.dtype != dtype or t.dim() != 1 or t.device != dev:
            raise TypeError(f"{name} must be a 1-D {dtype} tensor on {dev}")
    if not sq.numel() == sqid.numel() == sab.numel():
        raise ValueError("sq, sqid and sab differ in length")
    if sq.numel() >= 1 << 31:
        raise ValueError("the query table must hold fewer than 2^31 entries")
    n_rows = u.numel()
    if offs is not None:
        if (offs.dtype != torch.int64 or offs.device != dev
                or offs.shape != (n_rows + 1,)):
            raise TypeError(f"offs must be int64 [{n_rows + 1}] on {dev}")
        offs = offs.contiguous()
    elif gids.numel() != n_rows:
        raise ValueError("raw route: gids must hold one genome id per row")
    if n_rows == 0:
        return torch.zeros(0, dtype=torch.int64, device=dev)
    u, gids = u.contiguous(), gids.contiguous()
    sq, sqid, sab = sq.contiguous(), sqid.contiguous(), sab.contiguous()
    if directory is None:
        max_key = int(sq[-1]) % (1 << (8 * sq.element_size())) if sq.numel() else 0
        directory = query_directory(sq, max_key)
    qdir, qdir_shift = directory
    if qdir.dtype != torch.int32 or qdir.dim() != 1 or qdir.device != dev:
        raise TypeError(f"the directory must be a 1-D int32 tensor on {dev}")
    qdir = qdir.contiguous()
    kernel = kernels.join64_kernel if wide else kernels.join_kernel
    tile_rows = kernel.constant("kssd_join_tile_rows")  # DB rows a tile
    n_tiles = -(-n_rows // tile_rows)
    hit_bits = torch.empty(n_tiles * tile_rows // 32, dtype=torch.int32,
                           device=dev)
    tiles = torch.empty((2, n_tiles), dtype=torch.int64, device=dev)
    args = (
        u.data_ptr(), n_rows,
        *(() if wide else (None if offs is None else offs.data_ptr(),)),
        gids.data_ptr(), sq.data_ptr(), sqid.data_ptr(), sab.data_ptr(),
        qdir.data_ptr(), qdir.numel() - 1, qdir_shift, qid_shift, n_tiles,
    )
    with torch.cuda.device(dev):
        stream = kernels.stream_handle(dev)
        kernel.launch(0, *args, 0, hit_bits.data_ptr(), tiles.data_ptr(),
                      None, stream)
        # [hit keys, fill pieces] per tile: two 1-D scans (a scan along
        # the rows of a [2, n] tensor runs ~10x longer on the card)
        cum = torch.empty_like(tiles)
        for row in range(2):
            torch.cumsum(tiles[row], 0, out=cum[row])
        total, n_pieces = cum[:, -1].tolist()
        _check_hits(total)
        keys = torch.empty(total, dtype=torch.int64, device=dev)
        if total:
            kernel.launch(1, *args, n_pieces, hit_bits.data_ptr(),
                          cum.data_ptr(), keys.data_ptr(), stream, count=False)
    return keys


def _hits_to_stats(
    hit_parts: list[np.ndarray], n_qry: int, n_ref: int, qid_shift: int
) -> list[tuple]:
    """Packed hit keys -> per-query stats6 (shared tail of every device
    join backend)."""
    hits = (
        np.concatenate(hit_parts) if hit_parts else np.zeros(0, np.int64)
    )
    # qid occupies the top bits: ONE sort groups hits by query, then
    # searchsorted yields every query's slice (instead of n_qry full
    # boolean scans of the hit array)
    hits.sort()
    qids = hits >> qid_shift
    rids = (hits >> 16) & ((np.int64(1) << (qid_shift - 16)) - 1)
    abs_ = hits & np.int64(0xFFFF)
    bounds = np.searchsorted(qids, np.arange(n_qry + 1, dtype=np.int64))
    return [
        _segment_stats_np(
            rids[bounds[qn]: bounds[qn + 1]],
            abs_[bounds[qn]: bounds[qn + 1]],
            n_ref,
        )
        for qn in range(n_qry)
    ]


def _query_table_device(qc, qi, qa, n_qry: int, device: torch.device):
    """One component's combined query table (``_query_table``'s entries,
    in its order, without its padding) built on ``device``, and its
    ``query_directory``: (sq, sqid, sab, directory), int32 tensors.

    The combco arrays are uploaded as read (codes as an int32 bit view,
    the abundances as int16, the index); each entry's query id comes from
    the index there. One stable sort of the int64 key ``code << 31 |
    qid`` (the uint32 code and ``qid < 2^31``: the key stays below 2^63,
    so signed order is unsigned (code, qid) order) keeps entries of one
    (code, query) in file order, and the first of each run is kept, as
    ``_query_table`` keeps the first occurrence. The table's last code is
    the one value read back."""
    n = int(qc.size)
    with torch.profiler.record_function("table.upload"):
        codes = torch.from_numpy(
            np.ascontiguousarray(qc, "<u4").view(np.int32)).to(device)
        abund = torch.from_numpy(
            np.ascontiguousarray(qa, "<u2").view(np.int16)).to(device)
        ends = torch.from_numpy(
            np.ascontiguousarray(qi[1:], "<u8").view(np.int64)).to(device)
    with torch.profiler.record_function("table.sort"):
        qid = torch.searchsorted(
            ends, torch.arange(n, dtype=torch.int64, device=device), right=True)
        key = ((codes.to(torch.int64) & 0xFFFFFFFF) << 31) | qid
        key, order = torch.sort(key, stable=True)
        first = torch.ones(n, dtype=torch.bool, device=device)
        torch.ne(key[1:], key[:-1], out=first[1:])
        order = order[first]
        sq = codes[order]
        sqid = qid[order].to(torch.int32)
        sab = abund[order].to(torch.int32) & 0xFFFF
    max_key = int(sq[-1]) & 0xFFFFFFFF if sq.numel() else 0
    return sq, sqid, sab, query_directory(sq, max_key)


# device bytes the statistics need per hit key beyond the key itself:
# the concatenation (8), the sort's values, indices and scratch (~32), a
# key's group, boundary flag and prefix sum (~17); rounded up
STATS_BYTES_PER_KEY = 64
# keys a part is read in when the statistics are split by key range: a
# slice's mask, comparison and selected keys (STATS_SLICE_BYTES a key)
# are the split's only scratch beyond its keys
STATS_SLICE = 1 << 22
STATS_SLICE_BYTES = 10


def _free_bytes(device: torch.device) -> int | None:
    """Bytes still free for the statistics on ``device``: the card's free
    memory and what torch's allocator holds unused; None on the host."""
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return (free + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))


def _slice_bytes(parts: list[torch.Tensor]) -> int:
    """The scratch bytes of reading ``parts`` a slice at a time."""
    return STATS_SLICE_BYTES * min(STATS_SLICE, max(int(p.numel()) for p in parts))


def _in_range(keys: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """The keys in [lo, hi), by a value mask."""
    m = keys >= lo
    m &= keys < hi
    return keys[m]


def _count_keys(parts: list[torch.Tensor], lo: int, hi: int | None, shift: int,
                length: int) -> np.ndarray:
    """int64 [length]: the keys of ``parts`` in [lo, hi) (all keys when
    ``hi`` is None) counted by ``(key - lo) >> shift``, on each part's
    device, a slice at a time."""
    out = np.zeros(length, np.int64)
    for p in parts:
        for sl in p.split(STATS_SLICE):
            sl = sl if hi is None else _in_range(sl, lo, hi)
            out += torch.bincount((sl - lo) >> shift, minlength=length).cpu().numpy()
    return out


def _cuts(counts: np.ndarray, cap: int) -> list[tuple[int, int]]:
    """Consecutive ranges [a, b) of ``counts``' units, each as long as its
    sum stays at most ``cap``; a unit above ``cap`` is a range alone."""
    cum = np.zeros(counts.size + 1, np.int64)
    np.cumsum(counts, out=cum[1:])
    out, a = [], 0
    while a < counts.size:
        b = max(int(np.searchsorted(cum, cum[a] + cap, "right")) - 1, a + 1)
        out.append((a, b))
        a = b
    return out


def _stats_ranges(parts: list[torch.Tensor], n: int, n_qry: int, n_ref: int,
                  qid_shift: int, device: torch.device,
                  ) -> list[tuple[int | None, int | None, int]]:
    """The key ranges (lo, hi, keys) the statistics of ``parts`` (``n``
    keys) are computed in, ascending: one range of every key, (None,
    None, n), when they fit the device's free bytes at
    ``STATS_BYTES_PER_KEY`` a key, or on the host. Else the query ids are
    cut greedily into ranges whose keys fit beside a slice's scratch
    (``_slice_bytes``), and a query whose keys alone do not fit is cut by
    reference ids the same way. A (query, reference) run is the unit of
    the reduction, so any such cut keeps the output exact; MemoryError
    when one run does not fit."""
    free = _free_bytes(device)
    if free is None or n * STATS_BYTES_PER_KEY <= free:
        return [(None, None, n)]
    cap = (free - _slice_bytes(parts)) // STATS_BYTES_PER_KEY
    per_q = _count_keys(parts, 0, None, qid_shift, n_qry)
    out = []
    for a, b in _cuts(per_q, cap):
        if per_q[a:b].sum() <= cap:
            out.append((a << qid_shift, b << qid_shift, int(per_q[a:b].sum())))
            continue
        lo = a << qid_shift
        per_r = _count_keys(parts, lo, lo + (1 << qid_shift), 16, n_ref)
        for r0, r1 in _cuts(per_r, cap):
            k = int(per_r[r0:r1].sum())
            if k > cap:
                raise MemoryError(
                    f"composite hits of query {a} on reference {r0} ({k}) "
                    f"need {k * STATS_BYTES_PER_KEY} bytes of {device} memory "
                    f"for their statistics, {free} are free; free memory on "
                    f"{device}, or run composite with --device cpu"
                )
            out.append((lo + (r0 << 16), lo + (r1 << 16), k))
    return [r for r in out if r[2]]


def _range_keys(parts: list[torch.Tensor], lo: int | None, hi: int | None,
                n: int, device: torch.device) -> torch.Tensor:
    """The ``n`` keys of ``parts`` in [lo, hi) joined on ``device``, in
    part order; every key when ``lo`` is None. A range's keys are
    selected from each part a slice at a time by a value mask."""
    if lo is None:
        keys = [p.to(device) for p in parts]
        return keys[0] if len(keys) == 1 else torch.cat(keys)
    keys = torch.empty(n, dtype=torch.int64, device=device)
    at = 0
    for p in parts:
        for sl in p.split(STATS_SLICE):
            got = _in_range(sl, lo, hi)
            keys[at:at + got.numel()] = got
            at += got.numel()
    if at != n:
        raise RuntimeError(f"the key range [{lo}, {hi}) held {at} keys, "
                           f"{n} were counted")
    return keys


def _segments_torch(keys: torch.Tensor, qid_shift: int) -> torch.Tensor:
    """int64 [8, n_segments]: (qid, rid, kmer_num, total, median, max,
    lastsum, lastn) of each run of equal ``key >> 16`` in the ascending
    hit keys, the aggregates exactly as ``_segment_stats_np`` defines
    them for one reference (the run's abundances are ascending)."""
    dev, n = keys.device, keys.numel()
    group = keys >> 16
    new = torch.ones(n, dtype=torch.bool, device=dev)
    torch.ne(group[1:], group[:-1], out=new[1:])
    start = torch.nonzero(new).squeeze(1)
    group = group[start]
    vals = keys & 0xFFFF
    # int64 prefix sums: exact, where numpy's float64 bincount is exact
    # while a sum stays below 2^53 (n < 2^37 keys of < 2^16 each)
    ex = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(vals, 0, out=ex[1:])
    end = torch.empty_like(start)
    end[:-1] = start[1:]
    end[-1:] = n
    k = end - start
    median = torch.where(k >= 2, vals[start + (k // 2 - 1).clamp(min=0)], 0)
    # the same IEEE float64 products as numpy, truncated as astype does
    kf = k.to(torch.float64)
    st = (kf * ST_PCTL).to(torch.int64)
    hi = torch.minimum((kf * ED_PCTL).to(torch.int64), k)
    lastsum = ex[start + hi] - ex[start + st.clamp(min=1) - 1]
    rid_mask = (1 << (qid_shift - 16)) - 1
    return torch.stack([
        group >> (qid_shift - 16), group & rid_mask, k, ex[end] - ex[start],
        median, vals[end - 1], lastsum, hi - st + 1,
    ])


def _stats_by_query(seg: np.ndarray, n_qry: int, n_ref: int) -> list[tuple]:
    """``_segments_torch``'s rows (on the host, ascending by query, then
    reference) -> per-query stats6 over all ``n_ref`` references; a
    reference without hits gets (0, 0, 0, 0, 0, 1), as
    ``_segment_stats_np`` gives it."""
    bounds = np.searchsorted(seg[0], np.arange(n_qry + 1, dtype=np.int64))
    out = []
    for qn in range(n_qry):
        a, b = bounds[qn], bounds[qn + 1]
        rid = seg[1, a:b]
        stats = [np.zeros(n_ref, np.int64) for _ in range(5)]
        stats.append(np.ones(n_ref, np.int64))
        for s, row in zip(stats, seg[2:]):
            s[rid] = row[a:b]
        out.append(tuple(stats))
    return out


def _hits_to_stats_torch(parts: list[torch.Tensor], n_qry: int, n_ref: int,
                         qid_shift: int, device: torch.device | None = None,
                         ) -> list[tuple]:
    """``_hits_to_stats`` where the keys are: the join's int64 key
    tensors are joined on ``device`` (default: the first part's), sorted
    once there (keys are non-negative, so they sort as (qid, rid,
    abundance)), reduced to one row of aggregates per (query, reference)
    pair with hits (``_segments_torch``), and only those rows come back
    to the host. CPU tensors run the same torch calls (the plain
    version). Keys past the device's free memory are sorted and reduced
    one key range after another (``_stats_ranges``); the rows stay
    ascending by (query, reference)."""
    if device is None:
        device = parts[0].device if parts else torch.device("cpu")
    parts = [p for p in parts if p.numel()]
    n = sum(int(p.numel()) for p in parts)
    segs = [np.zeros((8, 0), np.int64)]
    if n:
        for lo, hi, k in _stats_ranges(parts, n, n_qry, n_ref, qid_shift, device):
            with torch.profiler.record_function("stats.sort"):
                keys = torch.sort(_range_keys(parts, lo, hi, k, device)).values
            with torch.profiler.record_function("stats.reduce"):
                seg = _segments_torch(keys, qid_shift)
                del keys
            with torch.profiler.record_function("stats.fetch"):
                segs.append(seg.cpu().numpy())
    with torch.profiler.record_function("stats.host"):
        seg = segs[-1] if len(segs) <= 2 else np.concatenate(segs, axis=1)
        return _stats_by_query(seg, n_qry, n_ref)


def _csr_stats_device(components, qtables, n_qry: int, n_ref: int,
                      device: torch.device) -> list[tuple]:
    """Per-query stats6 via the INVERTED-index join: ``components`` are
    the DeviceIndex objects of ``index.load_device_index``, or SparseIndex
    objects whose device residency is shared with search
    (``ops.count.DeviceIndex.from_sparse`` caches it on the index: one
    upload per process); ``qtables`` the per-component query tables of
    ``_query_table_device`` on ``device``. The hit keys stay there."""
    qid_shift = 16 + max(int(n_ref).bit_length(), 1)
    _check_key_width(qid_shift, n_qry)
    hit_parts: list[torch.Tensor] = []
    for sp, (sq, sqid, sab, qdir) in zip(components, qtables):
        index = count_ops.DeviceIndex.from_sparse(sp, device)
        nnz = index.uniq.numel()
        for c0 in range(0, nnz, JOIN_CHUNK):
            c1 = min(c0 + JOIN_CHUNK, nnz)
            hit_parts.append(join_kernel(
                index.uniq[c0:c1], index.offsets[c0 : c1 + 1], index.gids,
                sq, sqid, sab, qid_shift, qdir,
            ))
    return _hits_to_stats_torch(hit_parts, n_qry, n_ref, qid_shift, device)


def _genome_ids(ends: torch.Tensor, c0: int, c1: int) -> torch.Tensor:
    """int32 genome id of each DB position in [c0, c1) on ``ends``'
    device, where ``ends`` is a component's combco index less its first
    entry (int64): the genome whose codes hold the position, as
    ``np.searchsorted(index[1:], positions, "right")`` gives it (a genome
    without codes owns no position)."""
    pos = torch.arange(c0, c1, dtype=torch.int64, device=ends.device)
    return torch.searchsorted(ends, pos, right=True, out_int32=True)


def _batched_stats_device(comps, n_qry: int, n_ref: int,
                          device: torch.device) -> list[tuple]:
    """Per-query stats6 via the raw-code join: ``comps`` rows are the
    (ref codes, genome ends, query codes, query index, query abundances)
    of ``_raw_device_components``, the DB's on ``device``; each DB code
    is a row with one posting, its genome id, made there a join chunk at
    a time (``_genome_ids``). One chunked DB pass serves all queries; the
    query tables are built and the hit keys kept on ``device``."""
    qid_shift = 16 + max(int(n_ref).bit_length(), 1)
    _check_key_width(qid_shift, n_qry)
    hit_parts: list[torch.Tensor] = []
    for codes, ends, qc, qi, qa in comps:
        sq, sqid, sab, qdir = _query_table_device(qc, qi, qa, n_qry, device)
        for c0 in range(0, codes.numel(), JOIN_CHUNK):
            c1 = min(c0 + JOIN_CHUNK, codes.numel())
            with torch.profiler.record_function("raw.ids"):
                rid = _genome_ids(ends, c0, c1)
            hit_parts.append(join_kernel(codes[c0:c1], None, rid, sq, sqid, sab,
                                         qid_shift, qdir))
    return _hits_to_stats_torch(hit_parts, n_qry, n_ref, qid_shift, device)


def _check_key_width(qid_shift: int, n_qry: int) -> None:
    """The packed hit key ``qid << qid_shift | rid << 16 | abundance``
    must fit a non-negative int64. Input-dependent (n_ref * n_qry), so
    this must survive ``python -O``: an overflow would silently corrupt
    the qid/rid bits and produce a WRONG abundance report."""
    if qid_shift + max(int(n_qry).bit_length(), 1) >= 63:
        raise ValueError(
            f"composite hit-key overflow: {n_qry} queries x "
            f"{1 << (qid_shift - 16)} ref-id space does not fit the "
            "int64 packed key; split the query sketch dir into smaller "
            "batches"
        )


# DB rows per join call: bounds the genome ids a raw-code chunk makes on
# the device (positions and ids, 768 MiB at 2^26 rows)
JOIN_CHUNK = 1 << 26


def _query_stats_host(comps, qn: int, n_ref: int):
    """Host per-query join + stats (the parity oracle)."""
    rid_hits: list[np.ndarray] = []
    ab_hits: list[np.ndarray] = []
    for ref_codes, rid_of, qry_codes, qry_index, qry_abund in comps:
        q_lo, q_hi = int(qry_index[qn]), int(qry_index[qn + 1])
        qc = qry_codes[q_lo:q_hi]
        qa = qry_abund[q_lo:q_hi]
        if qc.size == 0:
            continue
        order = np.argsort(qc, kind="stable")
        sq, sa = qc[order], qa[order]
        pos = np.searchsorted(sq, ref_codes)
        pos_c = np.clip(pos, 0, max(sq.size - 1, 0))
        hit = (pos < sq.size) & (sq.size > 0)
        hit &= np.where(hit, sq[pos_c] == ref_codes, False)
        rid_hits.append(rid_of[hit])
        ab_hits.append(sa[pos_c[hit]].astype(np.int64))
    rids = np.concatenate(rid_hits) if rid_hits else np.zeros(0, np.int64)
    abunds = np.concatenate(ab_hits) if ab_hits else np.zeros(0, np.int64)
    return _segment_stats_np(rids, abunds, n_ref)


def _query_table(qc, qi, qa, n_qry: int):
    """Combined query table over ALL queries of one component: codes
    sorted ascending with aligned query ids + abundances, padded to a
    power of two. A query's sketch is a SET of codes (the reference
    hash-dedups before probing, command_composite.c:453-463); inputs
    carrying duplicates keep the FIRST occurrence, exactly like the
    host oracle's searchsorted-left probe."""
    qid_of = np.searchsorted(
        qi[1:], np.arange(qc.size, dtype=np.uint64), "right"
    ).astype(np.int32)
    order = np.lexsort(
        (np.arange(qc.size), qid_of, qc)
    )  # code-major, then query, then original position
    sq, sqid = qc[order], qid_of[order]
    sab = qa[order].astype(np.uint32)
    if sq.size:
        keep_first = np.ones(sq.size, bool)
        keep_first[1:] = (sq[1:] != sq[:-1]) | (sqid[1:] != sqid[:-1])
        sq, sqid, sab = sq[keep_first], sqid[keep_first], sab[keep_first]
    L = 1 << max(int(max(sq.size - 1, 1)).bit_length(), 6)
    sq_pad = np.full(L, np.uint32(0xFFFFFFFF))
    sq_pad[: sq.size] = sq
    sqid_pad = np.full(L, n_qry, np.int32)
    sqid_pad[: sqid.size] = sqid
    sab_pad = np.zeros(L, np.uint32)
    sab_pad[: sab.size] = sab
    return sq_pad, sqid_pad, sab_pad, sq.size


def _raw_components(ref_dir: str, qry_dir: str, comp_num: int) -> list:
    """Per component: (ref codes, genome id of each code, query codes,
    query index, query abundances) read from the sketch dirs."""
    comps = []
    for c in range(comp_num):
        ref_codes, ref_index = formats.read_combco(ref_dir, c)
        rid_of = np.searchsorted(
            ref_index[1:], np.arange(ref_codes.size, dtype=np.uint64), "right"
        ).astype(np.int64)
        qry_codes, qry_index, qry_abund = formats.read_combco(
            qry_dir, c, with_abund=True
        )
        comps.append((ref_codes, rid_of, qry_codes, qry_index, qry_abund))
    return comps


def _raw_device_components(ref_dir: str, qry_dir: str, comp_num: int,
                           n_ref: int, device: torch.device) -> list:
    """``_raw_components`` with the DB on ``device``: per component (ref
    codes, genome ends, query codes, query index, query abundances). Each
    component's combco.<c> (``<u4``) and combco.index.<c> (``<u8``) go
    unconverted onto the device (``index.combco_on_device``: checked on
    the host first, up to ``index._OPEN_COMPONENTS`` components a
    buffer, pinned staging, read ahead on threads, uploaded on a side
    stream), whose views are the codes, as the join's int32 bit view, and
    the index less its first entry (int64), whose genome ids
    ``_genome_ids`` makes there. On the host only each index's size and last entry are read,
    and the query's arrays. Spans: ``raw.upload`` around ``raw.read`` and
    ``raw.wait``."""
    from public_kssd_tpu_torch import index as index_mod

    comps = []
    parts = [(c, 0, None) for c in range(comp_num)]
    for g in index_mod.combco_on_device(ref_dir, parts, n_ref, device, "raw"):
        at = 0
        for i, (c, n) in enumerate(zip(g.comps, g.sizes)):
            comps.append((g.codes[at:at + n], g.index[i, 1:],
                          *formats.read_combco(qry_dir, c, with_abund=True)))
            at += n
    return comps


def species_abundance(
    ref_dir: str,
    qry_dir: str,
    out_dir: str | None = None,
    binvec: bool = False,
    device: torch.device | str | None = "cuda",
    ref_components=None,
) -> str:
    """-r/-q composition analysis; returns the text report. With
    ``binvec`` also writes .abv files (get_species_abundance,
    command_composite.c:389-547).

    ``device=None`` runs the host oracle (a per-query vectorised join
    over the raw DB codes). A torch device, a card by default (raising
    when none is visible, before any work; ``"cpu"`` for the plain
    PyTorch path), builds the query table
    (``_query_table_device``), runs ``join_kernel`` and reduces the hit
    keys (``_hits_to_stats_torch``) there, for all queries at once:
    over the stage II inverted index when
    ``ref_components`` (SparseIndex or DeviceIndex per component) are
    given — the index search uses, so a composite after a search in one
    process uploads it once — or the ref dir carries the CSR sidecar
    (mco.uniq.<c>), which ``index.load_device_index`` reads straight onto
    the device; else over the raw DB codes, which
    ``_raw_device_components`` reads straight onto the device. Every
    backend yields the same integer aggregates, so the report text is the
    same bytes."""
    if device is not None:
        device = resolve_device(device)
    # names in bulk: the report decodes only those it writes
    ref_stat = stattab.read_co_stat_table(ref_dir)
    qry_stat = stattab.read_co_stat_table(qry_dir)
    if not qry_stat.koc:
        raise ValueError("get_species_abundance(): query has not abundance")
    n_ref = ref_stat.infile_num
    n_qry = qry_stat.infile_num
    timer = utils.TracedStageTimer()
    route = "host"
    if device is None:
        with timer.stage("load"):
            comps = _raw_components(ref_dir, qry_dir, ref_stat.comp_num)
        with timer.stage("join"):
            stats_all = [
                _query_stats_host(comps, qn, n_ref) for qn in range(n_qry)
            ]
    else:
        if (
            ref_components is None
            and os.path.isfile(os.path.join(ref_dir, "mco.uniq.0"))
            and os.path.isfile(os.path.join(ref_dir, formats.MCO_DSTAT))
        ):
            from public_kssd_tpu_torch import index as index_mod

            with timer.stage("load"):
                _, ref_components = index_mod.load_device_index(
                    ref_dir, device, stattab.read_mco_stat_table(ref_dir))
        if ref_components is not None:
            route = "csr"
            if ref_components[0].n_genomes != n_ref:
                raise ValueError(
                    f"ref index covers {ref_components[0].n_genomes} genomes "
                    f"but {ref_dir} lists {n_ref}"
                )
            with timer.stage("query_table"):
                qtables = []
                for c in range(ref_stat.comp_num):
                    qc, qi, qa = formats.read_combco(qry_dir, c, with_abund=True)
                    qtables.append(_query_table_device(qc, qi, qa, n_qry, device))
            with timer.stage("join"):
                stats_all = _csr_stats_device(
                    ref_components, qtables, n_qry, n_ref, device
                )
        else:
            route = "raw"
            with timer.stage("load"):
                comps = _raw_device_components(ref_dir, qry_dir,
                                               ref_stat.comp_num, n_ref, device)
            with timer.stage("join"):
                stats_all = _batched_stats_device(comps, n_qry, n_ref, device)
    lines: list[str] = []
    with timer.stage("report"):
        for qn in range(n_qry):
            append_query_report(
                lines, stats_all[qn], qn, ref_stat, qry_stat, binvec,
                out_dir or os.path.join(ref_dir, BINVEC_DIRNAME),
            )
    utils.log.info(
        "composite: %d queries x %d refs, %s route [%s]",
        n_qry, n_ref, route, timer.report(),
    )
    return "".join(lines)


def append_query_report(
    lines: list[str],
    stats6: tuple,
    qn: int,
    ref_stat,
    qry_stat,
    binvec: bool,
    binvec_out: str,
    write_files: bool = True,
) -> None:
    """Turn one query's per-ref integer aggregates into report lines (or
    a .abv file with ``binvec``) — the shared tail of every backend
    (host / single-device / mesh-sharded), so the text is identical by
    construction (report math of command_composite.c:494-537).

    ``write_files=False`` computes the binvec branch without the .abv
    side effect (multi-process callers gate writes to process 0)."""
    counts, sums, median, maxv, lastsum, lastn = stats6
    # descending by matched count; ties keep smaller ref id first
    # (the reference's qsort is unstable on ties — avoid ties in tests)
    order = np.argsort(-counts, kind="stable")
    binvec_rows: list[tuple[int, np.float32]] = []
    binvec_sum = np.float32(0)
    for rn in order:
        kmer_num = int(counts[rn])
        if kmer_num < MIN_KM_S:
            break
        pctl_mean = np.float32(lastsum[rn]) / np.float32(lastn[rn])
        if binvec:
            if int(median[rn]) > 1 and kmer_num > MIN_KM_S + 1:
                binvec_rows.append((int(rn), pctl_mean))
                binvec_sum += pctl_mean
        else:
            mean = np.float32(sums[rn]) / np.float32(kmer_num)
            lines.append(
                f"{qry_stat.names[qn]}\t{ref_stat.names[rn]}\t{kmer_num}\t"
                f"{float(mean):.6f}\t{float(pctl_mean):.6f}\t"
                f"{int(median[rn])}\t{int(maxv[rn])}\n"
            )
    if binvec:
        if not write_files:
            return
        os.makedirs(binvec_out, exist_ok=True)
        num_pass = len(binvec_rows)
        denom = binvec_sum - np.float32(num_pass)
        idxs = np.array([r for r, _ in binvec_rows], dtype=np.int32)
        pcts = np.array(
            [
                (p - np.float32(1)) * np.float32(100) / denom
                for _, p in binvec_rows
            ],
            dtype=np.float32,
        )
        fname = os.path.basename(qry_stat.names[qn]) + ".abv"
        formats.write_abv(os.path.join(binvec_out, fname), idxs, pcts)


def index_abv(ref_dir: str) -> None:
    """-i: build the inverted abundance matrix over <ref>/abundance_Vec
    (index_abv, command_composite.c:317-387). Files are folded in sorted
    name order (the reference uses readdir order — document accordingly)."""
    abv_dir = os.path.join(ref_dir, BINVEC_DIRNAME)
    ref_stat = formats.read_co_stat(ref_dir)
    names = sorted(n for n in os.listdir(abv_dir) if n.endswith(".abv"))
    arrs = [formats.read_abv(os.path.join(abv_dir, n)) for n in names]
    y_l2n = [
        math.sqrt(float(np.sum(a["pct"].astype(np.float64) ** 2)))
        for a in arrs
    ]
    # the inverted fold is ONE stable argsort by species: file order is
    # preserved within a species, exactly like the per-row append fold
    sizes = np.array([len(a) for a in arrs], dtype=np.int64)
    fids = np.repeat(np.arange(len(arrs), dtype=np.int32), sizes)
    ridx = (
        np.concatenate([a["ref_idx"] for a in arrs])
        if arrs else np.zeros(0, np.int32)
    )
    pcts = (
        np.concatenate([a["pct"] for a in arrs])
        if arrs else np.zeros(0, np.float32)
    )
    order = np.argsort(ridx, kind="stable")
    base = os.path.join(ref_dir, BINVEC_DIRNAME)
    with open(base + ".name", "w") as f:
        for n in names:
            f.write(n + "\n")
    np.array(y_l2n, dtype="<f8").tofile(base + ".yl2n")
    formats.write_abv(
        base + ".abm",
        fids[order].astype(np.int32),
        pcts[order].astype(np.float32),
    )
    counts = np.bincount(ridx, minlength=ref_stat.infile_num).astype(np.int64)
    np.cumsum(counts).astype("<i4").tofile(base + ".abmi")


def abv_search(ref_dir: str, queries: list[str], mode: int) -> str:
    """-s 0|1|2: cosine / L1 / L2 search of query .abv against the indexed
    matrix (abv_search, command_composite.c:206-316); returns the report."""
    base = os.path.join(ref_dir, BINVEC_DIRNAME)
    with open(base + ".name") as f:
        names = [ln.rstrip("\n") for ln in f if ln.strip()]
    y_l2n = np.fromfile(base + ".yl2n", dtype="<f8", count=len(names))
    abm_idx = np.fromfile(base + ".abmi", dtype="<i4")
    abm = formats.read_abv(base + ".abm")
    out = []
    for qpath in queries:
        if not qpath.endswith(".abv"):
            out.append(f"argument {qpath} is not a .abv file, skipped\n")
            continue
        if "/" not in qpath:
            qpath = os.path.join(base, qpath)
        q = formats.read_abv(qpath)
        measure = {}
        xny = {}
        xl2n = np.float32(0)
        order_first_seen: list[int] = []
        for d in range(len(q)):
            ridx = int(q["ref_idx"][d])
            xpct = np.float32(q["pct"][d])
            xl2n += xpct * xpct
            lo = int(abm_idx[ridx - 1]) if ridx > 0 else 0
            hi = int(abm_idx[ridx])
            for j in range(lo, hi):
                fid = int(abm["ref_idx"][j])
                ypct = np.float32(abm["pct"][j])
                if fid not in measure:
                    measure[fid] = np.float32(0)
                    xny[fid] = [np.float32(0), np.float32(0)]
                    order_first_seen.append(fid)
                if mode == 1:
                    measure[fid] += np.float32(abs(float(ypct) - float(xpct)))
                    xny[fid][0] += xpct
                    xny[fid][1] += ypct
                elif mode == 2:
                    measure[fid] += (ypct - xpct) * (ypct - xpct)
                else:
                    measure[fid] += ypct * xpct
        if mode == 0:
            for fid in order_first_seen:
                measure[fid] = np.float32(
                    float(measure[fid]) / (math.sqrt(float(xl2n)) * y_l2n[fid])
                )
        out.append("#Sample\t")
        if mode == 1:
            for fid in order_first_seen:
                measure[fid] += np.float32(
                    2 * 100 - float(xny[fid][0]) - float(xny[fid][1])
                )
            ranked = sorted(order_first_seen, key=lambda f: float(measure[f]))
            out.append("L1norm\n")
            for fid in ranked:
                out.append(f"{names[fid]}\t{float(measure[fid]):.6f}\n")
        elif mode == 2:
            ranked = sorted(order_first_seen, key=lambda f: float(measure[f]))
            out.append("L2norm\n")
            for fid in ranked:
                out.append(f"{names[fid]}\t{math.sqrt(float(measure[fid])):.6f}\n")
        else:
            ranked = sorted(order_first_seen, key=lambda f: float(measure[f]))
            out.append("CosineXY\n")
            for fid in reversed(ranked):
                out.append(f"{names[fid]}\t{float(measure[fid]):.6f}\n")
    return "".join(out)


def abv_search_device(ref_dir: str, queries: list[str], mode: int,
                      device: torch.device | str = "cuda") -> str:
    """Dense formulation of the .abv sample search on a torch device, a
    card by default (raising when none is visible; any torch device,
    ``"cpu"`` included, may be given):
    abundance vectors densify to a float32 [n_samples, n_species]
    matrix; cosine similarity is one matrix-vector product
    (``torch.matmul``, full float32: TF32 is off by default for
    matmuls), L1/L2 are row reductions.

    Semantics notes vs the reference walk (command_composite.c:206-316):
    float32 accumulation ORDER differs (last-digit formatting may differ),
    and L2 here is the true distance over full vectors — the reference
    sums squared differences only over dimensions present in BOTH vectors.
    Like the reference, only samples sharing >= 1 dimension are reported.
    """
    device = resolve_device(device)
    base = os.path.join(ref_dir, BINVEC_DIRNAME)
    with open(base + ".name") as f:
        names = [ln.rstrip("\n") for ln in f if ln.strip()]
    abm_idx = np.fromfile(base + ".abmi", dtype="<i4")
    abm = formats.read_abv(base + ".abm")
    n_species = abm_idx.size
    n_samples = len(names)
    dense = np.zeros((n_samples, n_species), dtype=np.float32)
    starts = np.concatenate([[0], abm_idx[:-1]]).astype(np.int64)
    for r in range(n_species):
        seg = abm[int(starts[r]): int(abm_idx[r])]
        dense[seg["ref_idx"], r] = seg["pct"]
    y = torch.from_numpy(dense).to(device)
    y_norm = y.square().sum(dim=1).sqrt()
    out = []
    for qpath in queries:
        if not qpath.endswith(".abv"):
            out.append(f"argument {qpath} is not a .abv file, skipped\n")
            continue
        if "/" not in qpath:
            qpath = os.path.join(base, qpath)
        q = formats.read_abv(qpath)
        xv = np.zeros(n_species, dtype=np.float32)
        xv[q["ref_idx"]] = q["pct"]
        x = torch.from_numpy(xv).to(device)
        shared = ((y > 0) & (x > 0)).any(dim=1).cpu().numpy()
        if mode == 1:
            m = (y - x[None, :]).abs().sum(dim=1)
            label, ascending = "L1norm", True
        elif mode == 2:
            m = (y - x[None, :]).square().sum(dim=1).sqrt()
            label, ascending = "L2norm", True
        else:
            m = torch.matmul(y, x) / (torch.linalg.norm(x) * y_norm)
            label, ascending = "CosineXY", False
        m = m.cpu().numpy()
        fids = np.flatnonzero(shared)
        order = fids[np.argsort(m[fids] if ascending else -m[fids],
                                kind="stable")]
        out.append(f"#Sample\t{label}\n")
        for fid in order:
            out.append(f"{names[int(fid)]}\t{float(m[fid]):.6f}\n")
    return "".join(out)


def read_abv_text(paths: list[str]) -> str:
    """-d: dump .abv files (read_abv, command_composite.c:184-203)."""
    out = []
    for p in paths:
        if not p.endswith(".abv"):
            out.append(f"argument {p} is not a .abv file, skipped\n")
            continue
        arr = formats.read_abv(p)
        for row in arr:
            out.append(f"{int(row['ref_idx'])}\t{float(row['pct']):f}\n")
    return "".join(out)


def cmd_composite(args) -> int:
    """kssd_torch composite: -q (with -b) on ``args.device``, or over a
    mesh of its devices with --mesh; -i, -d and the -s host walk on the
    host; -s's dense search on ``args.device`` when forced
    (--device-search) or when the matrix is large."""
    if args.refdir:
        if args.qrydir:
            out_dir = args.outdir if len(args.outdir) >= 3 else None
            if getattr(args, "mesh", ""):
                import sys

                from public_kssd_tpu_torch import cli
                from public_kssd_tpu_torch.parallel import sharded_composite

                # accept "N" or dist-style "DPxREF" (queries run
                # sequentially here, so only the ref factor matters)
                try:
                    n = math.prod(int(x) for x in args.mesh.lower().split("x"))
                except ValueError:
                    sys.exit(
                        f"composite --mesh: expected a device count "
                        f"(or DPxREF), got {args.mesh!r}"
                    )
                mesh = cli._make_mesh("composite", args.mesh, 1, n,
                                      resolve_device(args.device))
                report = sharded_composite.species_abundance_sharded(
                    args.refdir, args.qrydir, mesh,
                    out_dir=out_dir, binvec=args.binvec,
                )
            else:
                report = species_abundance(
                    args.refdir,
                    args.qrydir,
                    out_dir=out_dir,
                    binvec=args.binvec,
                    device=resolve_device(args.device),
                )
            print(report, end="")
            return 0
        if args.idxbv:
            index_abv(args.refdir)
            return 0
        if args.searchbv != -1:
            if 0 <= args.searchbv < 3 and args.remaining:
                use_dev = args.device_search
                if not use_dev and not args.host_search:
                    # auto-select the dense search once the matrix is big
                    # enough that the sparse host walk would crawl
                    base = os.path.join(args.refdir, BINVEC_DIRNAME)
                    try:
                        n_species = os.path.getsize(base + ".abmi") // 4
                        with open(base + ".name") as f:
                            n_samples = sum(1 for ln in f if ln.strip())
                        use_dev = (
                            n_samples * n_species >= ABV_DENSE_THRESHOLD
                        )
                    except OSError:
                        pass
                if use_dev:
                    report = abv_search_device(
                        args.refdir, args.remaining, args.searchbv,
                        resolve_device(args.device),
                    )
                else:
                    report = abv_search(
                        args.refdir, args.remaining, args.searchbv
                    )
                print(report, end="")
                return 0
            print("Usage: kssd_torch composite -r <ref> -s <0|1|2> <query.abv>")
            return 1
        print("Usage: kssd_torch composite -r <ref> < mode: -q | -i | -s >")
        return 1
    if args.readabv:
        print(read_abv_text(args.remaining), end="")
        return 0
    print("Usage: kssd_torch composite -r <ref> < mode: -q | -i | -s >")
    return -1
