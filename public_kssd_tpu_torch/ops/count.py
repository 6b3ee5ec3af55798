"""Shared-k-mer counting: the search hot loop.

The reference walks, per query code, the inverted-index postings list and
increments a query x ref counter matrix with OpenMP threads
(mco_cbdco_nobin_dist, command_dist.c:763-790). Here the walk runs on the
device:

  * ``count_shared_kernel`` — the wrapper of the hand-written kernel
    ``csrc/count.cu``: each query code is looked up through the index's
    bucket directory (``DeviceIndex.dir``) and every posting of a hit adds
    one. Two variants, chosen by the size of a count row
    (``count_variant``): ``shared``, one block per query accumulating its
    row in shared memory and writing it whole, and ``global``, one thread
    per code adding into a zeroed matrix with global atomics. It launches
    the kernel for CUDA tensors and runs the plain version for CPU
    tensors.
  * ``count_shared_torch`` — the plain PyTorch version (``searchsorted``
    on int64, ``repeat_interleave`` expansion, ``bincount``).
  * ``count_shared_np`` — the host numpy oracle (reference semantics).

The koc (abundance-weighted) twins — ``count_shared_koc_kernel``
(``csrc/count.cu``, entry ``kssd_count_koc``), ``count_shared_koc_torch``
and ``count_shared_weighted_np`` — add each matched pair's query-code
abundance into a uint64 matrix; the kernel and the plain version return
the plain counts from the same single pass.

Codes are unsigned 32-bit values. Tensors carry them as int32 bit views
(the kernel reads them as uint32) and the plain version widens them to
int64 with ``& 0xFFFFFFFF``, so codes >= 2^31 keep their order. Weighted
sums are int64 tensors (torch has no uint64 arithmetic) and uint64 on the
host.

A mesh search folds the components into one key space of unsigned 64-bit
keys ``code << comp_code_bits | component`` (parallel/sharded_search.py).
A ``DeviceIndex`` over such keys holds them as int64 bit views, and the
same wrappers launch the 64-bit-key instances (``kssd_count_shared64``,
``kssd_count_koc64``); the plain version flips the sign bit before its
``searchsorted``, so keys >= 2^63 keep their unsigned order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from public_kssd_tpu_torch import kernels, resolve_device
from public_kssd_tpu_torch.utils import log

_M32 = 0xFFFFFFFF
_SIGN64 = -(1 << 63)  # int64 with only the sign bit set


def _int_view(a: np.ndarray, width: int) -> torch.Tensor:
    """``a``'s integers as a CPU int32 (``width`` 4) or int64 (8) tensor:
    a zero-copy view of its memory where it already holds native integers
    of that width (unsigned ones as their signed bit patterns), else a
    converted copy."""
    a = np.asarray(a)
    signed = np.dtype(f"i{width}")
    if a.dtype.kind in "iu" and a.dtype.itemsize == width and a.dtype.isnative:
        return torch.from_numpy(np.ascontiguousarray(a).view(signed))
    return torch.from_numpy(a.astype(signed))


def _u32_view(a: np.ndarray) -> torch.Tensor:
    """uint32 numpy array -> int32 tensor with the same bits (CPU)."""
    return _int_view(a, 4)


def _widen(t: torch.Tensor) -> torch.Tensor:
    """int32 bit view of uint32 values -> their int64 values."""
    return t.to(torch.int64) & _M32


def _ordered(t: torch.Tensor) -> torch.Tensor:
    """int64 tensor whose signed order is the unsigned order of the keys
    ``t`` holds: int32 bit views of uint32 codes are widened, int64 bit
    views of uint64 keys get their sign bit flipped. Equality is kept."""
    if t.dtype == torch.int32:
        return _widen(t)
    if t.dtype == torch.int64:
        return t ^ _SIGN64
    raise TypeError(f"keys must be int32 or int64 bit views, not {t.dtype}")


def _key_view(a: np.ndarray) -> torch.Tensor:
    """uint32 codes or uint64 keys -> an int32 / int64 tensor with the
    same bits (CPU)."""
    return _int_view(a, 8 if a.dtype.itemsize == 8 else 4)


def bucket_directory(uniq: torch.Tensor, max_key: int,
                     bits: int | None = None) -> tuple[torch.Tensor, int]:
    """The bucket directory of an ascending index of int32 / int64 bit
    views whose largest key, as an unsigned integer, is ``max_key`` (the
    caller has it on the host, so no read-back is needed): (dir int64
    [2^bits + 1], shift) on ``uniq``'s device, where ``dir[b]`` is the
    lower bound in ``uniq`` of the key ``b << shift`` (unsigned) and
    ``dir[2^bits]`` is nnz, so the keys whose top bits are ``b`` lie in
    ``uniq[dir[b]:dir[b+1]]``.

    ``shift = max(bit_length(max_key) - bits, 0)`` takes the buckets over
    the keys' real width. ``bits`` defaults to bit_length(nnz) - 4, at
    most the max key's bit length: 8-16 keys a bucket for uniform keys
    (2^20 buckets, 8 MB, at 13M keys)."""
    nnz = uniq.numel()
    top = max_key.bit_length() if nnz else 0
    if bits is None:
        bits = min(max(nnz.bit_length() - 4, 0), top)
    shift = max(top - bits, 0)
    bounds = torch.arange(1 << bits, dtype=torch.int64, device=uniq.device)
    bounds = bounds << shift  # int64 shifts wrap: the uint64 bit pattern
    if uniq.dtype == torch.int64:
        bounds = bounds ^ _SIGN64
    d = torch.empty((1 << bits) + 1, dtype=torch.int64, device=uniq.device)
    d[:-1] = torch.searchsorted(_ordered(uniq), bounds)
    d[-1] = nnz
    return d, shift


# indexes up to this many keys build their bucket directory on the host
HOST_DIRECTORY_KEYS = 1 << 16


@dataclasses.dataclass
class DeviceIndex:
    """A CSR inverted index, resident on ``device``: one component's, or
    one mesh shard's over folded keys.

    ``uniq`` int32 [nnz] (bit view of the ascending uint32 codes) or int64
    [nnz] (bit view of ascending uint64 folded keys), ``offsets`` int64
    [nnz+1], ``gids`` int32 [total] column ids below ``n_ref``; ``dir`` and
    ``dir_shift`` its bucket directory (``bucket_directory``), which the
    count kernel searches through."""

    uniq: torch.Tensor
    offsets: torch.Tensor
    gids: torch.Tensor
    n_ref: int
    device: torch.device
    dir: torch.Tensor
    dir_shift: int

    @property
    def n_genomes(self) -> int:
        """``n_ref`` under ``index.SparseIndex``'s name, so that callers
        that take either kind of component read it alike."""
        return self.n_ref

    @classmethod
    def from_sparse(cls, sparse_index, device: torch.device) -> "DeviceIndex":
        """The device-resident form of an ``index.SparseIndex`` (numpy
        ``uniq_codes`` <u4, ``offsets`` <u8, ``gids`` <u4), cached on the
        index object: -m batched search runs many counting calls against
        one DB and uploads it once. A ``DeviceIndex`` on ``device`` (what
        ``index.load_device_index`` loads) is returned as it is."""
        device = resolve_device(device)
        if isinstance(sparse_index, cls):
            if sparse_index.device != device:
                raise ValueError(f"index is on {sparse_index.device}, not {device}")
            return sparse_index
        cached = getattr(sparse_index, "_device_index", None)
        if cached is not None and cached.device == device:
            return cached
        dev = cls.from_arrays(
            np.asarray(sparse_index.uniq_codes, dtype=np.uint32),
            sparse_index.offsets, sparse_index.gids,
            int(sparse_index.n_genomes), device,
        )
        sparse_index._device_index = dev
        return dev

    @classmethod
    def from_arrays(cls, uniq: np.ndarray, offsets: np.ndarray,
                    gids: np.ndarray, n_ref: int,
                    device: torch.device) -> "DeviceIndex":
        """Upload a host CSR: ``uniq`` ascending uint32 codes or uint64
        keys (its dtype picks the kernel instance), ``offsets`` [nnz+1],
        ``gids`` column ids; and build its bucket directory there.

        8-byte ``offsets`` and 4-byte ``gids`` (the index files' ``<u8``
        and ``<u4``) go up through zero-copy signed views of their memory,
        so the host copies nothing; other dtypes are converted first."""
        device = resolve_device(device)
        offs = np.asarray(offsets)
        gids = np.asarray(gids)
        # a wider dtype is checked before it is narrowed to 4 bytes
        if gids.dtype.itemsize > 4 and gids.size and int(gids.max()) >= 1 << 31:
            raise ValueError("genome ids must be < 2^31")
        uniq = np.asarray(uniq)
        host_keys = _key_view(uniq)
        return cls.checked(
            host_keys.to(device), _int_view(offs, 8).to(device),
            _int_view(gids, 4).to(device), n_ref, device,
            total=int(offs[-1]) if offs.size else 0,
            max_key=int(uniq[-1]) if uniq.size else 0,
            host_keys=host_keys if uniq.size <= HOST_DIRECTORY_KEYS else None,
        )

    @classmethod
    def checked(cls, keys: torch.Tensor, offsets: torch.Tensor,
                gids: torch.Tensor, n_ref: int, device: torch.device, *,
                total: int, max_key: int,
                host_keys: torch.Tensor | None = None) -> "DeviceIndex":
        """The index over a CSR already on ``device`` (``keys`` int32 /
        int64 bit views, ``offsets`` int64, ``gids`` int32), once it is
        checked, with its bucket directory: ``total`` (the postings
        total, the last offset, read on the host) must be below 2^63 and
        every genome id below 2^31 (4-byte ids >= 2^31 read as negative
        int32; checked on the device); ``max_key`` is the largest key as
        an unsigned integer. ``host_keys``, the keys on the host, is given
        for an index of at most ``HOST_DIRECTORY_KEYS`` keys, whose
        directory is built there: its few tensor operations cost less
        than as device launches (an L3K12 search loads 256 small
        component indexes); a large one builds it on the device, where a
        host search over millions of keys is slow."""
        if total >= 1 << 63:
            raise ValueError("postings total does not fit int64")
        if gids.numel() and bool(gids.min() < 0):
            raise ValueError("genome ids must be < 2^31")
        directory, shift = bucket_directory(
            keys if host_keys is None else host_keys, max_key
        )
        return cls(
            uniq=keys,
            offsets=offsets,
            gids=gids,
            n_ref=int(n_ref),
            device=device,
            dir=directory.to(device),
            dir_shift=shift,
        )


def _match_pairs(
    qry_codes: torch.Tensor, qry_qid: torch.Tensor, index: DeviceIndex
) -> tuple[torch.Tensor, torch.Tensor] | None:
    """Every matched (query code x posting) pair as (its count-matrix cell
    qid * n_ref + gid, the position of its query code), both int64; None
    when nothing matches."""
    dev = qry_codes.device
    uniq = _ordered(index.uniq)
    codes = _ordered(qry_codes)
    nnz = uniq.numel()
    if nnz == 0 or codes.numel() == 0:
        return None
    row = torch.searchsorted(uniq, codes)
    row_c = row.clamp(max=nnz - 1)
    found = (row < nnz) & (uniq[row_c] == codes)
    src = torch.nonzero(found).flatten()
    row_f = row_c[src]
    starts = index.offsets[row_f]
    lens = index.offsets[row_f + 1] - starts
    total = int(lens.sum())
    if total == 0:
        return None
    # ragged expansion: posting j of found code i sits at starts[i] + j
    seg_start = torch.cumsum(lens, 0) - lens
    within = torch.arange(total, dtype=torch.int64, device=dev) - (
        torch.repeat_interleave(seg_start, lens)
    )
    pos = torch.repeat_interleave(starts, lens) + within
    rid = index.gids[pos].to(torch.int64)
    src = torch.repeat_interleave(src, lens)
    return qry_qid[src].to(torch.int64) * index.n_ref + rid, src


def count_shared_torch(
    qry_codes: torch.Tensor,  # int32/int64 [L] bit view, index.uniq's dtype
    qry_qid: torch.Tensor,  # int32 [L] query id per code
    index: DeviceIndex,
    n_qry: int,
) -> torch.Tensor:
    """Plain version: int32 [n_qry, n_ref] shared-code counts on the
    device of the inputs."""
    pairs = _match_pairs(qry_codes, qry_qid, index)
    if pairs is None:
        return torch.zeros(
            (n_qry, index.n_ref), dtype=torch.int32, device=qry_codes.device
        )
    counts = torch.bincount(pairs[0], minlength=n_qry * index.n_ref)
    return counts.to(torch.int32).reshape(n_qry, index.n_ref)


def count_shared_koc_torch(
    qry_codes: torch.Tensor,  # int32/int64 [L] bit view, index.uniq's dtype
    qry_qid: torch.Tensor,  # int32 [L] query id per code
    qry_weights: torch.Tensor,  # int32 [L] bit view of uint32 abundances
    index: DeviceIndex,
    n_qry: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the koc pass: (int32 shared-code counts, int64
    abundance-weighted sums), both [n_qry, n_ref], from one expansion."""
    shape = (n_qry, index.n_ref)
    dev = qry_codes.device
    pairs = _match_pairs(qry_codes, qry_qid, index)
    if pairs is None:
        return (torch.zeros(shape, dtype=torch.int32, device=dev),
                torch.zeros(shape, dtype=torch.int64, device=dev))
    flat, src = pairs
    counts = torch.bincount(flat, minlength=n_qry * index.n_ref)
    weighted = torch.zeros(n_qry * index.n_ref, dtype=torch.int64, device=dev)
    weighted.index_add_(0, flat, _widen(qry_weights)[src])
    return counts.to(torch.int32).reshape(shape), weighted.reshape(shape)


def _check_query(index: DeviceIndex, **tensors: torch.Tensor) -> None:
    """The kernels' argument contract: 1-D tensors of one length on the
    index's device; the query codes of ``index.uniq``'s dtype, the rest
    int32."""
    lengths = set()
    for name, t in tensors.items():
        dtype = index.uniq.dtype if name == "qry_codes" else torch.int32
        if t.dtype != dtype or t.dim() != 1 or t.device != index.device:
            raise TypeError(f"{name} must be a 1-D {dtype} tensor on "
                            f"{index.device}")
        lengths.add(t.numel())
    if len(lengths) > 1:
        raise ValueError(f"{', '.join(tensors)} differ in length")


def _wide(index: DeviceIndex) -> bool:
    """True for an index over uint64 folded keys (the 64-bit-key kernel
    instances), False over uint32 codes."""
    return index.uniq.dtype == torch.int64


# shared memory a block of csrc/count.cu's row variant may opt into on an
# H100 (227 KB); the kernel checks the card's own limit and refuses more
ROW_SMEM_BYTES = 232_448


def count_variant(n_ref: int, koc: bool) -> str:
    """The count kernel's variant for rows of ``n_ref`` columns: "shared"
    where a row (uint32 counts, and uint64 sums for koc) fits a block's
    shared memory, else "global"."""
    return "shared" if n_ref * (12 if koc else 4) <= ROW_SMEM_BYTES else "global"


def query_segments(qry_qid: torch.Tensor, n_qry: int) -> torch.Tensor:
    """int64 [n_qry + 1]: query q's codes are positions seg[q]..seg[q+1]
    of codes grouped by ascending query id (``query_ids`` order; negative
    ids sort first and belong to no query)."""
    ids = torch.arange(n_qry + 1, dtype=qry_qid.dtype, device=qry_qid.device)
    return torch.searchsorted(qry_qid, ids)


def _grouped(qry_qid: torch.Tensor, qry_codes: torch.Tensor,
             qry_weights: torch.Tensor | None):
    """(qry_qid, qry_codes, qry_weights) with the codes grouped by
    ascending query id: as given where they already are (``query_ids``
    order), else reordered by a stable sort of the ids on their device.
    Counts and sums do not depend on the order of the codes."""
    if qry_qid.numel() < 2 or not bool((qry_qid[1:] < qry_qid[:-1]).any()):
        return qry_qid, qry_codes, qry_weights
    qid, order = torch.sort(qry_qid, stable=True)
    return qid, qry_codes[order], None if qry_weights is None else qry_weights[order]


def _launch_count(kernel, koc: bool, qry_codes, qry_qid, qry_weights,
                  index: DeviceIndex, n_qry: int, qry_seg):
    """Allocate the outputs, pick the variant, launch; returns (counts,
    weighted or None)."""
    dev = qry_codes.device
    shape = (n_qry, index.n_ref)
    variant = count_variant(index.n_ref, koc)
    log.debug("count kernel %s: %s variant, %d codes x %d refs", kernel.name,
              variant, qry_codes.numel(), index.n_ref)
    if variant == "shared":
        if qry_seg is None:
            qry_qid, qry_codes, qry_weights = _grouped(qry_qid, qry_codes,
                                                       qry_weights)
            qry_seg = query_segments(qry_qid, n_qry)
        elif (qry_seg.dtype != torch.int64 or qry_seg.shape != (n_qry + 1,)
              or qry_seg.device != dev):
            raise TypeError(f"qry_seg must be int64 [{n_qry + 1}] on {dev}")
        alloc = torch.empty
    else:
        alloc = torch.zeros
    counts = alloc(shape, dtype=torch.int32, device=dev)
    weighted = alloc(shape, dtype=torch.int64, device=dev) if koc else None
    if counts.numel() == 0:
        return counts, weighted
    qry_codes, qry_qid = qry_codes.contiguous(), qry_qid.contiguous()
    if koc:
        qry_weights = qry_weights.contiguous()
    if qry_seg is not None:
        qry_seg = qry_seg.contiguous()
    with torch.cuda.device(dev):
        kernel.launch(
            0 if variant == "shared" else 1, qry_codes.data_ptr(),
            qry_qid.data_ptr(), *((qry_weights.data_ptr(),) if koc else ()),
            qry_codes.numel(),
            None if qry_seg is None else qry_seg.data_ptr(),
            n_qry, index.uniq.data_ptr(), index.uniq.numel(),
            index.dir.data_ptr(), index.dir.numel() - 1, index.dir_shift,
            index.offsets.data_ptr(), index.gids.data_ptr(), index.n_ref,
            counts.data_ptr(),
            *((weighted.data_ptr(),) if koc else ()),
            kernels.stream_handle(dev),
        )
    return counts, weighted


def count_shared_kernel(
    qry_codes: torch.Tensor,
    qry_qid: torch.Tensor,
    index: DeviceIndex,
    n_qry: int,
    qry_seg: torch.Tensor | None = None,
) -> torch.Tensor:
    """int32 [n_qry, n_ref] shared-code counts: ``csrc/count.cu`` for
    CUDA tensors (``kssd_count_shared``, or ``kssd_count_shared64`` over
    an index of 64-bit keys), ``count_shared_torch`` for CPU tensors.

    The codes may come in any order. ``qry_seg`` (int64 [n_qry + 1] on
    the device, the cumulative index of the query sketches) may be given
    where the codes are grouped by ascending query id, as ``query_ids``
    gives them; the shared-row variant then needs no check of the order.
    The count matrix is indexed with 64-bit offsets inside the kernel, so
    n_qry * n_ref is bounded only by device memory."""
    if qry_codes.device.type != "cuda":
        return count_shared_torch(qry_codes, qry_qid, index, n_qry)
    _check_query(index, qry_codes=qry_codes, qry_qid=qry_qid)
    kernel = kernels.count64_kernel if _wide(index) else kernels.count_kernel
    return _launch_count(kernel, False, qry_codes, qry_qid, None, index,
                         n_qry, qry_seg)[0]


def count_shared_koc_kernel(
    qry_codes: torch.Tensor,
    qry_qid: torch.Tensor,
    qry_weights: torch.Tensor,
    index: DeviceIndex,
    n_qry: int,
    qry_seg: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(int32 counts, int64 abundance-weighted sums) [n_qry, n_ref] in one
    walk of the index: ``csrc/count.cu`` (``kssd_count_koc``, or
    ``kssd_count_koc64`` over an index of 64-bit keys) for CUDA tensors,
    ``count_shared_koc_torch`` for CPU tensors. ``qry_seg`` as for
    ``count_shared_kernel``."""
    if qry_codes.device.type != "cuda":
        return count_shared_koc_torch(
            qry_codes, qry_qid, qry_weights, index, n_qry
        )
    _check_query(index, qry_codes=qry_codes, qry_qid=qry_qid,
                 qry_weights=qry_weights)
    kernel = (kernels.count_koc64_kernel if _wide(index)
              else kernels.count_koc_kernel)
    return _launch_count(kernel, True, qry_codes, qry_qid, qry_weights, index,
                         n_qry, qry_seg)


def query_ids(qry_index: np.ndarray, n_codes: int) -> np.ndarray:
    """Query id of every code position from the cumulative index."""
    return np.searchsorted(
        qry_index[1:], np.arange(n_codes, dtype=np.uint64), "right"
    ).astype(np.int32)


def _segments(qry_index: np.ndarray, n_codes: int,
              index: DeviceIndex) -> torch.Tensor:
    """A sketch directory's cumulative index as the count kernel's query
    segments (int64 on the index's device), with the positions that
    ``query_ids`` gives each query."""
    seg = np.minimum(np.asarray(qry_index).astype(np.int64), n_codes)
    seg[0] = 0
    return torch.from_numpy(seg).to(index.device)


def count_shared_tensors(
    qry_codes: np.ndarray,
    qry_index: np.ndarray,
    sparse_index,
    n_qry: int,
    device: torch.device | str | None = "cuda",
    qry_weights: np.ndarray | None = None,
) -> tuple[torch.Tensor, ...]:
    """One component's counts of all queries, left where they were made:
    (int32 [n_qry, n_ref] bit view of the uint32 shared-code counts,) and,
    with ``qry_weights`` (uint32, one a query code), the int64 bit view of
    the uint64 abundance-weighted sums beside it. A device, a card by
    default (raising when none is visible), runs ``count_shared_kernel``
    / ``count_shared_koc_kernel`` on it, one walk of the index for both
    matrices (on the CPU their plain versions); ``device=None`` runs the
    host oracle (CPU tensors over its arrays). Sums of these bit views over
    components wrap as the unsigned sums do."""
    shape = (n_qry, sparse_index.n_genomes)
    if device is not None:
        device = resolve_device(device)
    if device is None:
        args = (qry_codes, qry_index, sparse_index.uniq_codes,
                sparse_index.offsets, sparse_index.gids, n_qry, shape[1])
        out = (count_shared_np(*args),)
        if qry_weights is not None:
            out += (count_shared_weighted_np(*args[:2], qry_weights, *args[2:]),)
        return tuple(torch.from_numpy(a.view(f"i{a.itemsize}")) for a in out)
    if qry_codes.size == 0:
        out = (torch.zeros(shape, dtype=torch.int32, device=device),)
        if qry_weights is not None:
            out += (torch.zeros(shape, dtype=torch.int64, device=device),)
        return out
    span = torch.profiler.record_function
    with span("count.index"):
        index = DeviceIndex.from_sparse(sparse_index, device)
    with span("count.queries"):
        qc = _u32_view(qry_codes).to(index.device)
        qq = torch.from_numpy(query_ids(qry_index, qry_codes.size)).to(index.device)
        seg = _segments(qry_index, qry_codes.size, index)
        if qry_weights is not None:
            qw = _u32_view(qry_weights).to(index.device)
    with span("count.kernel"):
        if qry_weights is None:
            return (count_shared_kernel(qc, qq, index, n_qry, seg),)
        return count_shared_koc_kernel(qc, qq, qw, index, n_qry, seg)


def count_shared(
    qry_codes: np.ndarray,
    qry_index: np.ndarray,
    sparse_index,
    n_qry: int,
    device: torch.device | str | None = "cuda",
) -> np.ndarray:
    """Count shared k-mers of all queries against one component's index
    -> uint32 [n_qry, n_ref]. A device, a card by default, runs
    ``count_shared_kernel`` on it; ``device=None`` runs the host oracle."""
    (counts,) = count_shared_tensors(qry_codes, qry_index, sparse_index,
                                     n_qry, device)
    return counts.cpu().numpy().view(np.uint32)


def count_shared_koc(
    qry_codes: np.ndarray,
    qry_index: np.ndarray,
    qry_weights: np.ndarray,
    sparse_index,
    n_qry: int,
    device: torch.device | str | None = "cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Shared-code counts and abundance-weighted counts (each matched
    pair adds its query code's ``qry_weights`` entry, uint32) of all
    queries against one component -> (uint32, uint64) [n_qry, n_ref].
    A device, a card by default, runs ``count_shared_koc_kernel`` on it:
    one walk for both matrices; ``device=None`` runs the host oracle."""
    counts, weighted = count_shared_tensors(qry_codes, qry_index, sparse_index,
                                            n_qry, device, qry_weights)
    return (counts.cpu().numpy().view(np.uint32),
            weighted.cpu().numpy().view(np.uint64))


def count_shared_weighted(
    qry_codes: np.ndarray,
    qry_index: np.ndarray,
    qry_weights: np.ndarray,
    sparse_index,
    n_qry: int,
    device: torch.device | str | None = "cuda",
) -> np.ndarray:
    """Abundance-weighted shared counts of all queries vs one component
    -> uint64 [n_qry, n_ref] (``count_shared_koc``'s second matrix)."""
    return count_shared_koc(
        qry_codes, qry_index, qry_weights, sparse_index, n_qry, device
    )[1]


def count_shared_np(
    qry_codes: np.ndarray,
    qry_index: np.ndarray,
    uniq_codes: np.ndarray,
    offsets: np.ndarray,
    gids: np.ndarray,
    n_qry: int,
    n_ref: int,
) -> np.ndarray:
    """Host (numpy) counting — reference semantics, used for small inputs
    and as the oracle in tests. An empty index (a component no reference
    code falls in) shares nothing."""
    counts = np.zeros((n_qry, n_ref), dtype=np.uint32)
    if uniq_codes.size == 0:
        return counts
    qid_of = np.searchsorted(
        qry_index[1:], np.arange(qry_codes.size, dtype=np.uint64), "right"
    )
    row = np.searchsorted(uniq_codes, qry_codes)
    row_c = np.clip(row, 0, max(uniq_codes.size - 1, 0))
    found = (row < uniq_codes.size) & (uniq_codes[row_c] == qry_codes)
    starts = offsets[row_c][found].astype(np.int64)
    lens = (offsets[row_c + 1] - offsets[row_c])[found].astype(np.int64)
    qids = qid_of[found]
    if lens.sum() == 0:
        return counts
    expanded_gids = gids[_ragged_indices_np(starts, lens)]
    expanded_qids = np.repeat(qids, lens)
    np.add.at(counts, (expanded_qids, expanded_gids.astype(np.int64)), 1)
    return counts


def count_shared_weighted_np(
    qry_codes: np.ndarray,
    qry_index: np.ndarray,
    qry_weights: np.ndarray,
    uniq_codes: np.ndarray,
    offsets: np.ndarray,
    gids: np.ndarray,
    n_qry: int,
    n_ref: int,
) -> np.ndarray:
    """Host (numpy) abundance-weighted counting -> uint64 [n_qry, n_ref]:
    the oracle (public_kssd_tpu's count_shared_weighted, use_device=False)."""
    counts = np.zeros((n_qry, n_ref), dtype=np.uint64)
    if uniq_codes.size == 0:
        return counts
    qid_of = np.searchsorted(
        qry_index[1:], np.arange(qry_codes.size, dtype=np.uint64), "right"
    )
    row = np.searchsorted(uniq_codes, qry_codes)
    row_c = np.clip(row, 0, max(uniq_codes.size - 1, 0))
    found = (row < uniq_codes.size) & (uniq_codes[row_c] == qry_codes)
    starts = offsets[row_c][found].astype(np.int64)
    lens = (offsets[row_c + 1] - offsets[row_c])[found].astype(np.int64)
    if lens.sum() == 0:
        return counts
    exp_gids = gids[_ragged_indices_np(starts, lens)].astype(np.int64)
    exp_qids = np.repeat(qid_of[found], lens)
    exp_w = np.repeat(qry_weights[found].astype(np.uint64), lens)
    np.add.at(counts, (exp_qids, exp_gids), exp_w)
    return counts


def _ragged_indices_np(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """[s0..s0+l0) ++ [s1..s1+l1) ++ ... as one flat index array."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    rep_starts = np.repeat(starts.astype(np.int64), lens)
    cum = np.cumsum(lens)
    ar = np.arange(total, dtype=np.int64)
    within = ar - np.repeat(cum - lens, lens)
    return rep_starts + within
