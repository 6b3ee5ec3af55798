"""Stage II: invert a sketch directory into the searchable index.

Reference: run_stageII (command_dist.c:381-417) + combco2mco
(co2mco.c:25-77) build, per component, a DENSE 16^COMPONENT_SZ-row
cumulative index (2 GiB at CSZ=7 regardless of data!) plus concatenated
genome-id postings.

Redesign: the index is built by a single stable argsort of the
component's codes (postings order = code ascending, genome ascending —
bit-identical to the reference's insertion order), and the in-memory /
on-device representation is CSR over the *occupied* rows only
(unique codes + offsets + postings). The dense on-disk format is kept as
an export for byte-compatibility; the sparse form is what search loads:
on one device straight onto it (``load_device_index``), elsewhere into
host arrays (``load_sparse_index``).
"""

from __future__ import annotations

import collections
import dataclasses
import os
import threading
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np
import torch

from public_kssd_tpu_torch import formats, resolve_device
from public_kssd_tpu_torch.ops import staging
from public_kssd_tpu_torch.ops.count import HOST_DIRECTORY_KEYS, DeviceIndex

_SIGN = np.uint64(1 << 63)


@dataclasses.dataclass
class SparseIndex:
    """CSR inverted index of one component over occupied code rows."""

    uniq_codes: np.ndarray  # uint32 [nnz] ascending
    offsets: np.ndarray  # uint32/uint64 [nnz+1] cumulative postings counts
    gids: np.ndarray  # uint32 [total] genome ids, grouped by code
    n_genomes: int


def build_component_index(
    codes: np.ndarray, index: np.ndarray, n_genomes: int,
    device: torch.device | None = None,
) -> SparseIndex:
    """Invert one component's concatenated codes (combco layout).

    One direct sort of packed (code << 32 | gid) keys: gid_of is
    nondecreasing in combco position, so this yields code-ascending,
    gid-ascending postings — identical to a stable argsort by code (the
    reference's insertion order) at a fraction of the cost (~5x on the
    412M-posting GTDB build: np.sort moves 8-byte keys, argsort moves
    8-byte indices AND pays two gather passes).

    ``device`` runs the sort — the stage II hot op (combco2mco's row
    fill, co2mco.c:42-55; SURVEY C9) — there with ``torch.sort``. torch
    sorts int64 only, so the unsigned keys (codes reach 2^32 - 1 at
    CSZ=8) are sorted as ``key ^ 2^63`` viewed as int64, which orders
    exactly as the unsigned keys do, and flipped back after. The host
    sort stays the default; boundary extraction is host-side either
    way."""
    gid_of = (
        np.searchsorted(index[1:], np.arange(codes.size, dtype=np.uint64), "right")
        .astype(np.uint32)
    )
    key = (codes.astype(np.uint64) << np.uint64(32)) | gid_of
    if device is not None and key.size:
        key = sort_u64(key, device)
    else:
        key.sort()
    sorted_codes = (key >> np.uint64(32)).astype(np.uint32)
    sorted_gids = key.astype(np.uint32)  # low 32 bits
    if sorted_codes.size:
        # unique over ALREADY-SORTED codes (np.unique would re-sort)
        change = np.empty(sorted_codes.size, bool)
        change[0] = True
        np.not_equal(sorted_codes[1:], sorted_codes[:-1], out=change[1:])
        first = np.flatnonzero(change)
        uniq = sorted_codes[first]
        counts = np.diff(np.append(first, sorted_codes.size))
    else:
        uniq = sorted_codes
        counts = np.zeros(0, np.int64)
    offsets = np.zeros(uniq.size + 1, dtype=np.uint64)
    np.cumsum(counts, out=offsets[1:])
    return SparseIndex(
        uniq_codes=uniq.astype(np.uint32),
        offsets=offsets,
        gids=sorted_gids,
        n_genomes=n_genomes,
    )


def sort_u64(key: np.ndarray, device: torch.device) -> np.ndarray:
    """Ascending sort of uint64 keys on ``device`` (sign-flipped int64)."""
    flipped = torch.from_numpy((key ^ _SIGN).view(np.int64)).to(device)
    out = torch.sort(flipped).values.cpu().numpy()
    return out.view(np.uint64) ^ _SIGN


def sparse_to_dense_offsets(idx: SparseIndex, comp_sz: int) -> np.ndarray:
    """Expand CSR offsets to the reference's dense inclusive-cumsum rows
    (combco2mco's row_offset after prefix sum, co2mco.c:57)."""
    counts = np.zeros(comp_sz, dtype=np.uint64)
    counts[idx.uniq_codes.astype(np.int64)] = np.diff(idx.offsets)
    return np.cumsum(counts)


def dense_to_sparse(row_offset: np.ndarray, gids: np.ndarray, n_genomes: int) -> SparseIndex:
    """Load a reference-format dense component into CSR."""
    counts = np.diff(row_offset, prepend=np.uint64(0))
    occupied = np.flatnonzero(counts)
    offsets = np.zeros(occupied.size + 1, dtype=np.uint64)
    np.cumsum(counts[occupied], out=offsets[1:])
    return SparseIndex(
        uniq_codes=occupied.astype(np.uint32),
        offsets=offsets,
        gids=gids,
        n_genomes=n_genomes,
    )


def _csr_paths(mco_dir: str, c: int) -> tuple[str, str]:
    return (
        os.path.join(mco_dir, f"mco.uniq.{c}"),
        os.path.join(mco_dir, f"mco.csroff.{c}"),
    )


def run_stage2(
    co_dir: str, mco_dir: str, comp_sz: int, dense: bool = True,
    device: torch.device | None = None,
) -> formats.McoStat:
    """Build the reference-compatible index directory from a sketch dir.

    Writes mcofiles.stat + mco.<c> + mco.index.<c> (dense format, for
    reference-binary interop) into ``mco_dir`` (usually the same
    directory, as the reference tutorial does), PLUS a CSR sidecar
    (mco.uniq.<c> uint32 + mco.csroff.<c> uint64) so our own search
    loads in milliseconds instead of re-deriving CSR from the 2 GiB
    dense rows (16^7 x 8 B at CSZ=7, co2mco.c:58-62 — ~2 min on a
    2-vCPU host). ``dense=False`` skips the dense export entirely for
    very large DBs."""
    co = formats.read_co_stat(co_dir)
    os.makedirs(mco_dir, exist_ok=True)
    comp_space = 1 << (4 * comp_sz)
    for c in range(co.comp_num):
        codes, index = formats.read_combco(co_dir, c)
        sp = build_component_index(codes, index, co.infile_num, device)
        up, op = _csr_paths(mco_dir, c)
        sp.uniq_codes.astype("<u4").tofile(up)
        sp.offsets.astype("<u8").tofile(op)
        if dense:
            dense_rows = sparse_to_dense_offsets(sp, comp_space)
            formats.write_mco_component(mco_dir, c, dense_rows, sp.gids)
        else:
            sp.gids.astype("<u4").tofile(formats.mco_path(mco_dir, c))
    stat = formats.McoStat(
        params_id=co.params_id,
        kmerlen=co.kmerlen,
        dim_rd_len=co.dim_rd_len,
        comp_num=co.comp_num,
        infile_num=co.infile_num,
        ctx_ct=co.ctx_ct,
        names=co.names,
    )
    formats.write_mco_stat(mco_dir, stat)
    return stat


def load_sparse_index(mco_dir: str) -> tuple[formats.McoStat, list[SparseIndex]]:
    """Load an index directory as CSR components.

    Prefers the CSR sidecar written by run_stage2; falls back to
    deriving CSR from the reference's dense mco.index.<c> rows (so
    databases built by the reference binary load unchanged)."""
    stat = formats.read_mco_stat(mco_dir)
    comps = []
    for c in range(stat.comp_num):
        up, op = _csr_paths(mco_dir, c)
        if os.path.isfile(up) and os.path.isfile(op):
            comps.append(
                SparseIndex(
                    uniq_codes=np.fromfile(up, dtype="<u4"),
                    offsets=np.fromfile(op, dtype="<u8"),
                    gids=np.fromfile(formats.mco_path(mco_dir, c), dtype="<u4"),
                    n_genomes=stat.infile_num,
                )
            )
            continue
        row_offset, gids = formats.read_mco_component(mco_dir, c)
        comps.append(dense_to_sparse(row_offset, gids, stat.infile_num))
    return stat, comps


# bytes a staging buffer of the index loader holds, and the threads that
# read the index files into the buffers
INDEX_BLOCK = 1 << 24
INDEX_READ_THREADS = 4

_READERS: dict[tuple[int, int], ThreadPoolExecutor] = {}
_READERS_LOCK = threading.Lock()


def _readers(n: int) -> ThreadPoolExecutor:
    """A pool of ``n`` threads that read index files: started by the
    first load that uses it and kept for the process, as the staging
    buffers are, so that a later load starts no thread. Keyed by process
    id too: a forked child has none of its parent's threads."""
    key = (os.getpid(), n)
    with _READERS_LOCK:
        if key not in _READERS:
            _READERS[key] = ThreadPoolExecutor(n, thread_name_prefix="kssd-index-read")
        return _READERS[key]


# each file's bytes start at a multiple of this in the device buffer that
# holds the index (cudaMalloc's own alignment), so every view is aligned
_ALIGN = 256


def _pread_full(fd: int, buf: np.ndarray, offset: int) -> None:
    """Fill ``buf`` (uint8) from ``fd`` at ``offset``; ``os.preadv``
    releases the GIL while it reads."""
    view = memoryview(buf)
    done = 0
    while done < view.nbytes:
        got = os.preadv(fd, [view[done:]], offset + done)
        if got == 0:
            raise ValueError(f"index file ended {view.nbytes - done} bytes early")
        done += got


def _read_pieces(buf: np.ndarray, pieces: list[tuple[int, int, int, int]]) -> None:
    """Read each piece (file descriptor, file offset, bytes, offset in
    ``buf``)."""
    for fd, at, n, to in pieces:
        _pread_full(fd, buf[to:to + n], at)


def _upload_files(files: list[tuple[int, int, int]], out: torch.Tensor,
                  st: staging.Staging, pool: ThreadPoolExecutor, depth: int,
                  spans: str = "index") -> None:
    """The bytes of ``files`` (descriptor, size, offset in ``out``,
    ascending) into ``out`` (uint8 on the device): ``out`` is cut into
    pieces of a staging buffer's size, each read by ``pool`` from the
    files it covers into the next staging buffer, up to ``depth`` pieces
    at a time, and uploaded into its place once read, in order. On return
    every upload is queued and torch's current stream waits for them; a
    buffer is read into again only once its last upload has ended. The
    waits are the spans ``<spans>.read`` and ``<spans>.wait``."""
    span = torch.profiler.record_function
    block = st.host[0].size
    pending: collections.deque = collections.deque()

    def upload_oldest() -> None:
        read, slot, dest = pending.popleft()
        with span(f"{spans}.read"):
            read.result()
        st.upload(slot, dest.numel(), out=dest)

    fi = slot = 0
    try:
        for c0 in range(0, out.numel(), block):
            c1 = min(c0 + block, out.numel())
            pieces = []
            while fi < len(files) and files[fi][2] < c1:
                fd, size, at = files[fi]
                lo, hi = max(at, c0), min(at + size, c1)
                if hi > lo:
                    pieces.append((fd, lo - at, hi - lo, lo - c0))
                if at + size > c1:
                    break
                fi += 1
            if len(pending) >= depth:
                upload_oldest()
            with span(f"{spans}.wait"):
                buf = st.writable(slot)
            pending.append((pool.submit(_read_pieces, buf, pieces), slot, out[c0:c1]))
            slot = (slot + 1) % st.count
        while pending:
            upload_oldest()
    finally:
        # no read may still use a buffer or a descriptor once they are given
        # back
        wait([read for read, *_ in pending])


def files_on_device(paths: list[str], device: torch.device,
                    spans: str) -> list[torch.Tensor]:
    """The bytes of each file of ``paths`` on ``device``: uint8 views of
    one device buffer, each file at a multiple of ``_ALIGN``, read as
    ``load_device_index`` reads an index (``_upload_files`` on
    ``INDEX_READ_THREADS`` threads through the same staging set), so a
    file larger than the staging buffers streams through them and no
    host copy of it is made. On a card a failed pin, stream or copy
    raises. Spans: ``<spans>.read`` and ``<spans>.wait``."""
    threads = INDEX_READ_THREADS
    fds: list[int] = []
    try:
        files, end = [], 0
        for path in paths:
            fds.append(os.open(path, os.O_RDONLY))
            size = os.fstat(fds[-1]).st_size
            files.append((fds[-1], size, end))
            end += -(-size // _ALIGN) * _ALIGN
        buf = torch.empty(end, dtype=torch.uint8, device=device)
        with staging.borrow(device, INDEX_BLOCK, threads + 2) as st:
            _upload_files(files, buf, st, _readers(threads), threads, spans)
    finally:
        for fd in fds:
            os.close(fd)
    return [buf[at:at + size] for _, size, at in files]


# components whose files a load holds open at once (three files each)
_OPEN_COMPONENTS = 64


@dataclasses.dataclass
class _Sidecar:
    """One component's open CSR files: (descriptor, size, offset in the
    device buffer) for uniq, offsets and gids, and the buffer offset past
    them; the postings total and the largest key, and a small index's
    keys, read on the host."""

    files: list[tuple[int, int, int]]
    end: int
    total: int
    max_key: int
    host_keys: torch.Tensor | None


def _tail(fd: int, size: int, width: int) -> int:
    """The last ``width``-byte little-endian value of a file (0 if empty)."""
    return int.from_bytes(os.pread(fd, width, size - width), "little") if size else 0


def _open_sidecar(mco_dir: str, c: int, at: int, fds: list[int]) -> _Sidecar | None:
    """Component ``c``'s sidecar, opened once (each descriptor appended to
    ``fds``), its files placed in the device buffer from ``at`` on, each
    at a multiple of ``_ALIGN``; None when it has no sidecar (the
    reference binary's dense-only database)."""
    paths = (*_csr_paths(mco_dir, c), formats.mco_path(mco_dir, c))
    files = []
    for i, (path, width) in enumerate(zip(paths, (4, 8, 4))):
        try:
            fd = os.open(path, os.O_RDONLY)
        except FileNotFoundError:
            if i == 2:  # a sidecar without its postings
                raise
            return None
        fds.append(fd)
        size = os.fstat(fd).st_size
        if size % width:
            raise ValueError(f"{path}: {size} bytes is not a whole number "
                             f"of {width}-byte values")
        files.append((fd, size, at))
        at += -(-size // _ALIGN) * _ALIGN
    (fu, su, _), (fo, so, _), _ = files
    host_keys = None
    if su <= 4 * HOST_DIRECTORY_KEYS:
        host_keys = torch.from_numpy(np.empty(su // 4, np.int32))
        _pread_full(fu, host_keys.numpy().view(np.uint8), 0)
    return _Sidecar(files, at, _tail(fo, so, 8), _tail(fu, su, 4), host_keys)


def _load_components(mco_dir: str, cs: range, n_ref: int, device: torch.device,
                     st: staging.Staging, threads: int) -> list[DeviceIndex]:
    """Components ``cs`` of an index directory as DeviceIndex objects:
    their sidecars' files in one device buffer, whose views they are,
    read on ``threads`` threads."""
    fds: list[int] = []
    try:
        sidecars, end = [], 0
        for c in cs:
            sidecars.append(_open_sidecar(mco_dir, c, end, fds))
            end = sidecars[-1].end if sidecars[-1] else end
        buf = torch.empty(end, dtype=torch.uint8, device=device)
        _upload_files([f for sc in sidecars if sc for f in sc.files], buf, st,
                      _readers(threads), threads)
    finally:
        for fd in fds:
            os.close(fd)
    comps = []
    for c, sc in zip(cs, sidecars):
        if sc is None:
            row_offset, gids = formats.read_mco_component(mco_dir, c)
            comps.append(DeviceIndex.from_sparse(
                dense_to_sparse(row_offset, gids, n_ref), device))
            continue
        (_, su, ou), (_, so, oo), (_, sg, og) = sc.files
        with torch.profiler.record_function("index.directory"):
            comps.append(DeviceIndex.checked(
                buf[ou:ou + su].view(torch.int32), buf[oo:oo + so].view(torch.int64),
                buf[og:og + sg].view(torch.int32), n_ref, device,
                total=sc.total, max_key=sc.max_key, host_keys=sc.host_keys,
            ))
    return comps


def load_device_index(mco_dir: str, device: torch.device
                      ) -> tuple[formats.McoStat, list[DeviceIndex]]:
    """Load an index directory straight onto ``device``: its stat and one
    ``DeviceIndex`` a component, equal to ``DeviceIndex.from_sparse`` of
    ``load_sparse_index``'s components, without a host copy of the index.

    The CSR sidecar's files (mco.uniq.<c> ``<u4``, mco.csroff.<c> ``<u8``,
    mco.<c> ``<u4``) hold the bit views a DeviceIndex keeps, so they go
    unconverted into a device buffer, each file at an aligned offset,
    whose views the DeviceIndex tensors are (one buffer for up to
    ``_OPEN_COMPONENTS`` components, whose files are open at once, each
    opened once). The buffer is filled ``INDEX_BLOCK`` bytes at a time:
    each piece is read by one of ``INDEX_READ_THREADS`` threads from the
    files it covers into a staging buffer (``ops/staging.py``: pinned on
    a card; threads and buffers are kept for the process) and uploaded
    into its place on a side stream as soon as it is read, while the next
    pieces are read; a staging buffer is read into again once its upload
    has ended. Many small components (256 at L3K12) so share a few reads
    and uploads. On the host only the last offset and the last key of
    each component are read, and the keys of an index of at most
    ``HOST_DIRECTORY_KEYS`` keys, whose directory is built there. A
    component with only the reference's dense mco.index.<c> (a database
    built by the reference binary) is read on the host and uploaded by
    ``from_sparse``. On a card a failed pin, stream or copy raises: there
    is no fallback to the host route. Spans: ``index.read`` (waiting for a
    read), ``index.wait`` (a staging buffer waiting for its upload) and
    ``index.directory`` (the checks and the bucket directory)."""
    device = resolve_device(device)
    stat = formats.read_mco_stat(mco_dir)
    threads = INDEX_READ_THREADS
    comps: list[DeviceIndex] = []
    with staging.borrow(device, INDEX_BLOCK, threads + 2) as st:
        for c0 in range(0, stat.comp_num, _OPEN_COMPONENTS):
            cs = range(c0, min(c0 + _OPEN_COMPONENTS, stat.comp_num))
            comps += _load_components(mco_dir, cs, stat.infile_num, device, st,
                                      threads)
    return stat, comps


def sparse_index_from_co(co_dir: str) -> tuple[formats.CoStat, list[SparseIndex]]:
    """Build CSR components directly from a sketch dir (no dense files) —
    the fast path used when reference-format export is not needed."""
    co = formats.read_co_stat(co_dir)
    comps = []
    for c in range(co.comp_num):
        codes, index = formats.read_combco(co_dir, c)
        comps.append(build_component_index(codes, index, co.infile_num))
    return co, comps
