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
on one device straight onto it (``load_device_index``), onto each slot
of a mesh a bounded group of row ranges at a time (``CsrSlices``),
elsewhere into
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


def _upload_files(files: list[tuple[int, int, int, int]], out: torch.Tensor,
                  st: staging.Staging, pool: ThreadPoolExecutor, depth: int,
                  spans: str = "index") -> None:
    """The bytes of ``files`` (descriptor, first byte in the file, size,
    offset in ``out``, ascending) into ``out`` (uint8 on the device):
    ``out`` is cut into pieces of a staging buffer's size, each read by
    ``pool`` from the files it covers into the next staging buffer, up to
    ``depth`` pieces at a time, and uploaded into its place once read, in
    order. On return
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
            while fi < len(files) and files[fi][3] < c1:
                fd, start, size, at = files[fi]
                lo, hi = max(at, c0), min(at + size, c1)
                if hi > lo:
                    pieces.append((fd, start + lo - at, hi - lo, lo - c0))
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


def _runs_on_device(runs: list[list], device: torch.device,
                    spans: str) -> tuple[list[torch.Tensor], list[list[int]]]:
    """The bytes of each run of file pieces on ``device``: one uint8 view
    a run of one device buffer, each run at a multiple of ``_ALIGN`` and
    its pieces back to back, and the size of each piece. A piece is a path (the whole file) or
    ``(path, start, size)``: ``size`` bytes of the file from byte
    ``start`` on (a file that ends before raises as it is read); an open
    descriptor in place of the path is read and left open. Read as
    ``load_device_index`` reads an index
    (``_upload_files`` on ``INDEX_READ_THREADS`` threads through the same
    staging set), so a file larger than the staging buffers streams
    through them and no host copy of it is made. On a card a failed pin,
    stream or copy raises. Spans: ``<spans>.read`` and ``<spans>.wait``."""
    threads = INDEX_READ_THREADS
    fds: list[int] = []
    try:
        files, bounds, sizes, end = [], [], [], 0
        for run in runs:
            end = first = -(-end // _ALIGN) * _ALIGN
            sizes.append([])
            for entry in run:
                path, start, size = (entry, 0, None) if isinstance(entry, str) else entry
                if isinstance(path, int):
                    fd = path
                else:
                    fd = os.open(path, os.O_RDONLY)
                    fds.append(fd)
                if size is None:
                    size = os.fstat(fd).st_size
                sizes[-1].append(size)
                files.append((fd, start, size, end))
                end += size
            bounds.append((first, end))
        buf = torch.empty(end, dtype=torch.uint8, device=device)
        with staging.borrow(device, INDEX_BLOCK, threads + 2) as st:
            _upload_files(files, buf, st, _readers(threads), threads, spans)
    finally:
        for fd in fds:
            os.close(fd)
    return [buf[a:b] for a, b in bounds], sizes


# components whose files a load holds open at once (three files each)
_OPEN_COMPONENTS = 64


def _check_combco(sketch_dir: str, c: int, n_sketches: int, size: int,
                  isize: int, asize: int | None) -> int:
    """Component ``c`` of a sketch directory by its files' sizes (its
    codes', index's and, unless None, abundances'): whole codes, one
    offset a sketch and one more, one abundance a code. Returns its
    number of codes."""
    codes_path = formats.combco_path(sketch_dir, c)
    index_path = formats.combco_index_path(sketch_dir, c)
    if size % 4 or isize != 8 * (n_sketches + 1):
        raise ValueError(f"{codes_path} ({size} B) and {index_path} ({isize} B) "
                         f"are not the codes and offsets of {n_sketches} "
                         f"sketches (component {c})")
    if asize is not None and asize != size // 2:
        raise ValueError(f"{formats.abund_path(sketch_dir, c)} holds {asize} B, "
                         f"not the abundances of {size // 4} codes (component {c})")
    return size // 4


def check_combco(sketch_dir: str, c: int, n_sketches: int) -> int:
    """``_check_combco`` of component ``c``'s codes and index, their sizes
    read on the host: its number of codes. That the index's last offset
    is that number is checked where the index is read
    (``combco_on_device``)."""
    return _check_combco(sketch_dir, c, n_sketches,
                         os.path.getsize(formats.combco_path(sketch_dir, c)),
                         os.path.getsize(formats.combco_index_path(sketch_dir, c)),
                         None)


class CombcoGroup(collections.namedtuple(
        "CombcoGroup", "comps sizes codes index abund n_sketches")):
    """A group of ``combco_on_device``: its parts' components and numbers
    of codes (host lists), their codes back to back (int32 bit views),
    their whole indexes [parts, n_sketches + 1] (int64) and, when read,
    their abundances back to back (int16 bit views; else None)."""

    def part_of(self) -> torch.Tensor:
        """int64 [codes]: the part (0, 1, ...) of each code."""
        dev = self.codes.device
        return torch.repeat_interleave(
            torch.arange(len(self.sizes), device=dev),
            torch.tensor(self.sizes, dtype=torch.int64).to(dev),
            output_size=sum(self.sizes))

    def sketch_ids(self, part: torch.Tensor) -> torch.Tensor:
        """int32 [codes]: the sketch each code belongs to, of a group of
        whole components whose code's part is ``part`` (``part_of``): one
        search of every code's position among every part's sketch ends,
        each part's moved to where its codes start in the group (so that
        they ascend from part to part), less n_sketches a part before
        it."""
        dev = self.codes.device
        starts = torch.from_numpy(np.cumsum([0] + self.sizes[:-1])).to(dev)
        ends = (self.index[:, 1:] + starts[:, None]).flatten()
        pos = torch.arange(self.codes.numel(), dtype=torch.int64, device=dev)
        return (torch.searchsorted(ends, pos, right=True)
                - part * self.n_sketches).to(torch.int32)


def combco_on_device(sketch_dir: str, parts: list, n_sketches: int,
                     device: torch.device, spans: str, abund: bool = False):
    """Components of a sketch directory read straight onto ``device``
    (``_runs_on_device``: the index loader's pinned staging and threads,
    no host copy), a ``CombcoGroup`` of up to ``_OPEN_COMPONENTS``
    components at a time. ``parts``: (component, first code, end code or
    None for all) each; a part's codes [first, end), its whole index and,
    with ``abund``, its abundances [first, end) are read, each file
    opened once. A whole component is checked by its files' sizes once
    read (``_check_combco``), a slice's before, and each by its index's
    last offset. Spans: ``<spans>.upload`` around
    ``<spans>.read`` and ``<spans>.wait``."""
    for g0 in range(0, len(parts), _OPEN_COMPONENTS):
        group = parts[g0:g0 + _OPEN_COMPONENTS]
        runs: list[list] = [[], [], []]
        totals = {}
        for c, a, b in group:
            paths = [formats.combco_path(sketch_dir, c),
                     formats.combco_index_path(sketch_dir, c),
                     formats.abund_path(sketch_dir, c)]
            if b is not None:  # a slice: its sizes checked first
                totals[c] = check_combco(sketch_dir, c, n_sketches)
                paths[0] = (paths[0], 4 * a, 4 * (b - a))
                paths[2] = (paths[2], 2 * a, 2 * (b - a))
            for run, path in zip(runs, paths):
                run.append(path)
        with torch.profiler.record_function(f"{spans}.upload"):
            views, got = _runs_on_device(runs[:3 if abund else 2], device, spans)
        sizes = []
        for i, (c, a, b) in enumerate(group):
            if b is None:
                totals[c] = b = _check_combco(sketch_dir, c, n_sketches, got[0][i],
                                              got[1][i], got[2][i] if abund else None)
            sizes.append(b - a)
        index = views[1].view(torch.int64).view(len(group), n_sketches + 1)
        for (c, *_), last in zip(group, index[:, -1].tolist()):
            total = totals[c]
            if last != total:
                raise ValueError(f"{formats.combco_index_path(sketch_dir, c)} ends "
                                 f"at {last} codes, "
                                 f"{formats.combco_path(sketch_dir, c)} holds "
                                 f"{total} (component {c})")
        yield CombcoGroup([c for c, *_ in group], sizes, views[0].view(torch.int32),
                          index, views[2].view(torch.int16) if abund else None,
                          n_sketches)
        # the group's buffer goes before the next group is read
        views = None


@dataclasses.dataclass
class _Sidecar:
    """One component's open CSR files: (descriptor, 0, size, offset in the
    device buffer) for uniq, offsets and gids, and the buffer offset past
    them; the postings total and the largest key, and a small index's
    keys, read on the host."""

    files: list[tuple[int, int, int, int]]
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
        files.append((fd, 0, size, at))
        at += -(-size // _ALIGN) * _ALIGN
    (fu, _, su, _), (fo, _, so, _), _ = files
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
        (_, _, su, ou), (_, _, so, oo), (_, _, sg, og) = sc.files
        with torch.profiler.record_function("index.directory"):
            comps.append(DeviceIndex.checked(
                buf[ou:ou + su].view(torch.int32), buf[oo:oo + so].view(torch.int64),
                buf[og:og + sg].view(torch.int32), n_ref, device,
                total=sc.total, max_key=sc.max_key, host_keys=sc.host_keys,
            ))
    return comps


# the most bytes of index files that one group of a mesh build
# (``CsrSlices.groups``) reads onto a device; its scratch there is a few
# times this
MESH_GROUP_BYTES = 1 << 29

# a group of ``CsrSlices.groups``: per row its component (int64), code
# (int32 bit view of the uint32) and postings count (int64), and the
# postings' genome ids (int32 bit views; None when not read)
CsrGroup = collections.namedtuple("CsrGroup", "comp uniq counts gids")


def _map(path: str, dtype: str) -> np.ndarray:
    """A file's values mapped read-only (none for an empty file)."""
    return np.memmap(path, dtype, "r") if os.path.getsize(path) else np.zeros(0, dtype)


class CsrSlices:
    """Row ranges of an index directory's components, read onto a device
    a bounded group at a time: the mesh's shard build
    (``parallel/sharded_search.device_shards``).

    Each file is opened once a pass (``groups``: a path lookup is the
    host's largest cost per file, 256 components at L3K12) and its size
    taken from the open descriptor; on the host only what places a range
    is read besides: an offset where a range starts or ends inside a
    component (``os.pread`` of 8 bytes) and, for ``code_rows``, its
    codes mapped (``np.memmap``), so a search reads a few pages. A
    component with only the reference's dense mco.index.<c> (a database
    built by the reference binary) is read and converted on the host,
    one such component at a time, and its rows uploaded from there."""

    def __init__(self, mco_dir: str, stat: formats.McoStat):
        self.dir, self.stat = mco_dir, stat
        self._sizes: dict = {}  # component -> (rows, postings), None if dense
        self._fds: dict = {}  # component -> its sidecar's open descriptors
        self._codes: dict = {}
        self._dense: tuple = (None, None)

    def _open(self, c: int) -> bool:
        """Open component ``c``'s sidecar (uniq, offsets, postings; kept
        until ``_close``) and note its sizes; False for a dense-only
        component."""
        if c in self._fds:
            return True
        if c in self._sizes and self._sizes[c] is None:
            return False
        paths = (*_csr_paths(self.dir, c), formats.mco_path(self.dir, c))
        fds: list[int] = []
        try:
            for i, path in enumerate(paths):
                try:
                    fds.append(os.open(path, os.O_RDONLY))
                except FileNotFoundError:
                    if i == 2:  # a sidecar without its postings
                        raise
                    self._sizes[c] = None
                    return False
            su, so, sg = (os.fstat(fd).st_size for fd in fds)
            if su % 4 or so != 2 * su + 8 or sg % 4:
                raise ValueError(f"{self.dir}: component {c}'s sidecar holds {su} "
                                 f"B of codes, {so} B of offsets and {sg} B of "
                                 f"postings")
        except BaseException:
            for fd in fds:
                os.close(fd)
            raise
        if self._sizes.get(c) is None:
            self._sizes[c] = (su // 4, sg // 4)
        self._fds[c] = fds
        return True

    def _close(self, keep: int | None = None) -> None:
        """Close every open sidecar but component ``keep``'s."""
        for c in [c for c in self._fds if c != keep]:
            for fd in self._fds.pop(c):
                os.close(fd)

    def _sidecar(self, c: int) -> tuple[int, int] | None:
        """Component ``c``'s (rows, postings), or None for a dense-only
        component."""
        if c not in self._sizes and self._open(c):
            for fd in self._fds.pop(c):
                os.close(fd)
        return self._sizes[c]

    def _dense_arrays(self, c: int) -> tuple:
        """A dense-only component's (codes uint32, offsets, postings) on the
        host: the last one asked for is kept."""
        if self._dense[0] != c:
            self._dense = (None, None)  # the last one goes before the next is read
            sp = dense_to_sparse(*formats.read_mco_component(self.dir, c),
                                 self.stat.infile_num)
            self._dense = (c, (sp.uniq_codes, sp.offsets, sp.gids))
        return self._dense[1]

    def rows(self, c: int) -> int:
        side = self._sidecar(c)
        return side[0] if side else self._dense_arrays(c)[0].size

    def offset(self, c: int, r: int) -> int:
        """Component ``c``'s offset of row ``r``: the postings before it."""
        side = self._sidecar(c)
        if not side:
            return int(self._dense_arrays(c)[1][r])
        if r in (0, side[0]):
            return 0 if r == 0 else side[1]
        path = _csr_paths(self.dir, c)[1]
        fd = self._fds[c][1] if c in self._fds else os.open(path, os.O_RDONLY)
        try:
            got = os.pread(fd, 8, 8 * r)
        finally:
            if c not in self._fds:
                os.close(fd)
        if len(got) != 8:
            raise ValueError(f"{path} ends before the offset of row {r}")
        return int.from_bytes(got, "little")

    def code_rows(self, c: int, codes: list[int]) -> list[int]:
        """The rows of component ``c`` whose code is below each of
        ``codes`` (uint32 values)."""
        if c not in self._codes:
            self._codes[c] = (_map(_csr_paths(self.dir, c)[0], "<u4")
                              if self._sidecar(c) else None)
        mine = self._codes[c] if self._codes[c] is not None else (
            self._dense_arrays(c)[0])
        return np.searchsorted(mine, np.asarray(codes, np.uint32)).tolist()

    def rows_below(self, c: int, key: int, bits: int) -> int:
        """The rows of component ``c`` whose folded key ``code << bits | c``
        is below the unsigned ``key``."""
        code = key >> bits
        if c < key & ((1 << bits) - 1):  # code's own row is below too
            return self.code_rows(c, [code + 1])[0] if code < 0xFFFFFFFF else self.rows(c)
        return self.code_rows(c, [code])[0]

    def groups(self, device: torch.device, ranges: list | None = None,
               postings: bool = True):
        """Row ranges (component, first row, end row or None for the last)
        of the components (every row of each by default) on ``device``, a
        ``CsrGroup`` a group, the ranges' rows one after another. A group
        holds at most ``MESH_GROUP_BYTES`` of files (a range larger than
        that is cut by rows; a row is never cut) from at most
        ``_OPEN_COMPONENTS`` ranges, or rows of one dense-only component.
        Its pieces are read by ``_runs_on_device``: the ranges' codes back
        to back, then their offsets, then (``postings``) their postings,
        each one tensor. A group is read once the one before is consumed,
        so a caller that drops each group holds one at a time. Spans:
        ``mesh.upload`` around ``mesh.read`` and ``mesh.wait``."""
        device = resolve_device(device)
        if ranges is None:
            ranges = [(c, 0, None) for c in range(self.stat.comp_num)]
        plan = self._plan(ranges, postings)
        try:
            for group, current in plan:
                with torch.profiler.record_function("mesh.upload"):
                    got = self._read(group, device, postings)
                # the group's files but the one the plan is cutting
                self._close(keep=current)
                yield got
                del got
        finally:
            plan.close()
            self._close()

    def _plan(self, ranges: list, postings: bool):
        """``groups``' groups of pieces (component, first row, end row,
        first posting, end posting), each with the component whose range
        the plan is in when it is given."""
        def cost(c, r0, p0, r1):
            return 12 * (r1 - r0) + (4 * (self.offset(c, r1) - p0) if postings else 0)

        group, size = [], 0
        for c, r0, r1 in ranges:
            dense = not self._open(c)
            r1 = self.rows(c) if r1 is None else r1
            while r0 < r1:
                p0 = self.offset(c, r0)
                # the most rows from r0 that fit, one at least
                lo, hi = (r1, r1) if cost(c, r0, p0, r1) <= MESH_GROUP_BYTES else (
                    r0 + 1, r1)
                while lo < hi:
                    mid = (lo + hi + 1) // 2
                    if cost(c, r0, p0, mid) <= MESH_GROUP_BYTES:
                        lo = mid
                    else:
                        hi = mid - 1
                n = cost(c, r0, p0, lo)
                piece = (c, r0, lo, p0, self.offset(c, lo))
                if group and (dense or size + n > MESH_GROUP_BYTES
                              or len(group) == _OPEN_COMPONENTS):
                    yield group, c
                    group, size = [], 0
                if dense:
                    yield [piece], c
                else:
                    group.append(piece)
                    size += n
                r0 = lo
        if group:
            yield group, None

    def _read(self, group: list, device: torch.device, postings: bool) -> CsrGroup:
        if self._sizes[group[0][0]] is None:  # one dense-only component's rows
            (c, r0, r1, p0, p1), = group
            uniq_h, offsets_h, gids_h = self._dense_arrays(c)
            uniq = torch.from_numpy(uniq_h[r0:r1].view(np.int32)).to(device)
            ends = torch.from_numpy(offsets_h[r0 + 1:r1 + 1].astype(np.int64)).to(device)
            gids = (torch.from_numpy(gids_h[p0:p1].astype(np.uint32).view(np.int32))
                    .to(device) if postings else None)
        else:
            fds = [self._fds[c] for c, *_ in group]
            runs = [[(f[0], 4 * r0, 4 * (r1 - r0)) for f, (_, r0, r1, _, _)
                     in zip(fds, group)],
                    [(f[1], 8 * (r0 + 1), 8 * (r1 - r0)) for f, (_, r0, r1, _, _)
                     in zip(fds, group)]]
            if postings:
                runs.append([(f[2], 4 * p0, 4 * (p1 - p0))
                             for f, (*_, p0, p1) in zip(fds, group)])
            views, _ = _runs_on_device(runs, device, "mesh")
            uniq, ends = views[0].view(torch.int32), views[1].view(torch.int64)
            gids = views[2].view(torch.int32) if postings else None
        # each row's postings: the step of its offsets, from the range's
        # first offset at a range's first row; and its component. A
        # range's last offset must be the end of its postings (a
        # sidecar's last offset, its postings file's size)
        lens = np.array([r1 - r0 for _, r0, r1, _, _ in group], np.int64)
        firsts = np.cumsum(lens) - lens
        meta = torch.from_numpy(np.stack(
            [firsts, [p[3] for p in group], [p[0] for p in group], lens,
             firsts + lens - 1, [p[4] for p in group]]).astype(np.int64)).to(device)
        if not torch.equal(ends[meta[4]], meta[5]):
            raise ValueError(f"{self.dir}: the offsets of components "
                             f"{sorted({p[0] for p in group})} do not end where "
                             f"their postings do")
        counts = torch.diff(ends, prepend=ends.new_zeros(1))
        counts[meta[0]] = ends[meta[0]] - meta[1]
        comp = torch.repeat_interleave(meta[2], meta[3], output_size=int(lens.sum()))
        return CsrGroup(comp, uniq, counts, gids)


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
