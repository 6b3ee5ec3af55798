"""Host-side sequence input: fasta/fastq -> base-code streams.

The device sketch kernel consumes a flat ``uint8`` array of symbols::

    0..3  = A,C,G,T (2-bit code, Basemap: global_basic.c:64-72)
    4     = BREAK: k-mer continuity reset (headers, N/other letters,
            low-quality bases, read boundaries, junk characters)

This precisely mirrors the reference scanner state machine
(fasta2co, iseq2comem.c:205-270):

  * ACGT/acgt       -> roll the 2-bit registers, base++
  * '\\n' / '\\r'   -> skipped entirely (no reset)
  * other alpha     -> reset (base=1)
  * '>'             -> skip to end of line, reset
  * anything else   -> reset

so a window of 2k consecutive code symbols with no BREAK in between is
exactly the set of k-mers the reference emits.

Parsing is vectorised numpy (no per-byte Python); gz/bz2 handled like the
reference's ``zcat -fc`` pipe (iseq2comem.c:187-200).

Stage I parses small files on ``pipeline.parsed_streams``' threads
through ``read_codes``: each file is inflated (the port's own inflater,
``native/kssd_inflate.c``; without the helper libdeflate, else the
system zlib; all called through ctypes with the GIL dropped) or read
into one array that the C scanner overwrites in place. Measured with
``tools/stage1_spans.py --parse-split`` on an NVIDIA H100 80GB HBM3
host (8 CPUs, no libdeflate; 128 gzip genomes of 5.3 Mb): one thread
reads a genome in about 1 ms, inflates it in 9-9.4 ms (the system
zlib: 21 ms) and scans it in 5 ms; the pool takes 2.1-2.9 s on one
worker and 0.33-0.43 s on eight, against 3.9-4.3 s and 0.59-0.70 s on
zlib's route.
"""

from __future__ import annotations

import bz2
import gzip
import subprocess

import numpy as np

BREAK = np.uint8(4)

# Basemap (global_basic.c:64-72): ACGTacgt -> 0..3, everything else invalid.
_BASEMAP = np.full(256, 255, dtype=np.uint8)
for _i, _chars in enumerate((b"Aa", b"Cc", b"Gg", b"Tt")):
    for _c in _chars:
        _BASEMAP[_c] = _i

_IS_ALPHA = np.zeros(256, dtype=bool)
_IS_ALPHA[ord("A") : ord("Z") + 1] = True
_IS_ALPHA[ord("a") : ord("z") + 1] = True

MAPBASE = "ACGT"  # global_basic.c:72


def _load_libdeflate():
    """ctypes binding to the system libdeflate (when present): its
    inflate runs ~2-3x faster than zlib, and gz inflate is the measured
    stage I host bottleneck (bench.py::bench_host_io — zlib ~170
    Mbases/s/core vs the native fasta scan's ~700). Returns None when
    the library is missing; callers fall back to the gzip module. The
    buffers are passed as addresses, so a member is read and written in
    place inside larger buffers."""
    import ctypes
    import ctypes.util

    name = ctypes.util.find_library("deflate") or "libdeflate.so.0"
    try:
        lib = ctypes.CDLL(name)
    except OSError:
        return None
    try:
        lib.libdeflate_alloc_decompressor.restype = ctypes.c_void_p
        lib.libdeflate_alloc_decompressor.argtypes = []
        lib.libdeflate_free_decompressor.restype = None
        lib.libdeflate_free_decompressor.argtypes = [ctypes.c_void_p]
        lib.libdeflate_gzip_decompress_ex.restype = ctypes.c_int
        lib.libdeflate_gzip_decompress_ex.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_size_t),
        ]
    except AttributeError:
        return None
    return lib


_LIBDEFLATE = _load_libdeflate()


def _load_libz():
    """ctypes binding to the system zlib, the library behind Python's
    ``zlib`` module, for hosts without libdeflate: its inflate, called
    directly, writes into a caller's array and drops the GIL for the
    whole member (the module's returns bytes, joined and copied while
    the GIL is held). Returns None when the library is missing."""
    import ctypes
    import ctypes.util

    class ZStream(ctypes.Structure):  # zlib.h's z_stream
        _fields_ = [
            ("next_in", ctypes.c_void_p), ("avail_in", ctypes.c_uint),
            ("total_in", ctypes.c_ulong),
            ("next_out", ctypes.c_void_p), ("avail_out", ctypes.c_uint),
            ("total_out", ctypes.c_ulong),
            ("msg", ctypes.c_char_p), ("state", ctypes.c_void_p),
            ("zalloc", ctypes.c_void_p), ("zfree", ctypes.c_void_p),
            ("opaque", ctypes.c_void_p), ("data_type", ctypes.c_int),
            ("adler", ctypes.c_ulong), ("reserved", ctypes.c_ulong),
        ]

    name = ctypes.util.find_library("z") or "libz.so.1"
    try:
        lib = ctypes.CDLL(name)
        zsp = ctypes.POINTER(ZStream)
        lib.inflateInit2_.restype = ctypes.c_int
        lib.inflateInit2_.argtypes = [zsp, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.inflate.restype = ctypes.c_int
        lib.inflate.argtypes = [zsp, ctypes.c_int]
        lib.inflateReset.restype = ctypes.c_int
        lib.inflateReset.argtypes = [zsp]
        lib.inflateEnd.restype = ctypes.c_int
        lib.inflateEnd.argtypes = [zsp]
    except (OSError, AttributeError):
        return None
    lib.ZStream = ZStream  # the struct its functions take
    return lib


_LIBZ = _load_libz()

# deflate's largest ratio: 258 output bytes from 2 bits of input
_DEFLATE_MAX_RATIO = 1032
_GZIP_MAGIC = b"\x1f\x8b"


# False sends ``inflate`` past the port's inflater to the library
# routes, as ``_LIBDEFLATE = None`` sends it past libdeflate (tests, tools)
_KSSD = True


def inflate_route() -> str:
    """The route ``inflate`` takes on this host: "kssd", the port's own
    inflater (``native/kssd_inflate.c``, in the helper library) where
    the helper builds; else "libdeflate" where it is loaded, else "zlib"
    (the system library through ctypes), else "gzip module". The port's
    inflater goes first because it is the fastest: on one thread, a
    5.3 Mb genome at level 6 (``tools/stage1_spans.py --parse-split``),
    0.96x libdeflate's time and 0.41x zlib's on an 8-CPU Xeon host with
    both, 0.42-0.43x zlib's on an H100 host without libdeflate."""
    from public_kssd_tpu_torch import native

    if _KSSD and native.get_lib() is not None:
        return "kssd"
    if _LIBDEFLATE is not None:
        return "libdeflate"
    return "zlib" if _LIBZ is not None else "gzip module"


def inflate(data: bytes) -> np.ndarray | None:
    """The gzip ``data`` inflated into one writable ``uint8`` array,
    member after member, on ``inflate_route()``'s route. None where
    ``gzip_decompress`` falls back to the gzip module (input under 18
    bytes, no route but the module, a decode error): the caller then
    calls ``gzip.decompress(data)``, which raises what it raises.

    Each member is written straight into the array at the end of the
    previous one and read from the input at an address offset, so a
    file of m members costs O(n), not O(m n), and nothing is copied or
    zero-filled while the GIL is held (every route drops it). The array
    starts at the trailer's ISIZE when one member of this length could
    inflate to it (a single-member file then fits exactly), else at four
    times the input, and doubles when it is full. Where the members end,
    every route stops by ``_next_member``'s rule."""
    if len(data) < 18:
        return None
    route = inflate_route()
    if route == "gzip module":
        return None
    src = np.frombuffer(data, dtype=np.uint8)
    isize = int.from_bytes(data[-4:], "little")
    if len(data) // 2 <= isize <= _DEFLATE_MAX_RATIO * len(data):
        out = np.empty(max(isize, 1), dtype=np.uint8)
    else:
        out = np.empty(max(4 * len(data), 1 << 16), dtype=np.uint8)
    if route == "kssd":
        got = _inflate_kssd(data, src, out)
    elif route == "libdeflate":
        got = _inflate_libdeflate(_LIBDEFLATE, data, src, out)
    else:
        got = _inflate_libz(_LIBZ, data, src, out)
    if got is None:
        return None
    out, o = got
    if out.size - o > o // 4:  # grown past the output: keep <= 1.25x
        return out[:o].copy()
    return out[:o]


_END, _BAD = -1, -2


def _next_member(data: bytes, src: np.ndarray, i: int) -> int:
    """Where the member after one that ends at ``i`` starts; ``_END``
    where the members end, ``_BAD`` where ``gzip.decompress`` raises.
    The JAX package's rule on this host: where libdeflate is loaded,
    libdeflate's (stop where what remains cannot be a gzip member, as
    ``zcat`` stops at trailing padding), else ``gzip.decompress``'s (NUL
    padding skipped, anything else but a member an error)."""
    if _LIBDEFLATE is not None:
        return _END if src.size - i < 18 or data[i : i + 2] != _GZIP_MAGIC else i
    while i < src.size and src[i] == 0:  # gzip.decompress's lstrip
        nz = np.flatnonzero(src[i : i + (1 << 16)])
        i += int(nz[0]) if nz.size else min(1 << 16, src.size - i)
    if i == src.size:
        return _END
    return i if data[i : i + 2] == _GZIP_MAGIC else _BAD


def _grown(out: np.ndarray, o: int) -> np.ndarray:
    """``out`` at twice its size, its first ``o`` bytes kept."""
    grown = np.empty(2 * out.size, dtype=np.uint8)
    grown[:o] = out[:o]
    return grown


def _inflate_kssd(data: bytes, src: np.ndarray, out: np.ndarray):
    """(array, bytes written) or None on a decode, check or truncation
    error, or where ``_next_member`` finds no member."""
    from public_kssd_tpu_torch import native

    base = src.ctypes.data
    i = o = 0
    while True:
        rc, n_in, n_out = native.gzip_member(base + i, src.size - i,
                                             out.ctypes.data + o, out.size - o)
        if rc == native.INFLATE_NO_SPACE:  # grow, retry the member
            out = _grown(out, o)
            continue
        if rc != native.INFLATE_OK:
            return None
        i, o = _next_member(data, src, i + n_in), o + n_out
        if i == _END:
            return out, o
        if i == _BAD:
            return None


def _inflate_libdeflate(lib, data: bytes, src: np.ndarray, out: np.ndarray):
    """(array, bytes written) or None on a decode error."""
    import ctypes

    d = lib.libdeflate_alloc_decompressor()
    if not d:
        return None
    try:
        in_used = ctypes.c_size_t(0)
        out_used = ctypes.c_size_t(0)
        i = o = 0
        while True:
            rc = lib.libdeflate_gzip_decompress_ex(
                d, src.ctypes.data + i, src.size - i,
                out.ctypes.data + o, out.size - o,
                ctypes.byref(in_used), ctypes.byref(out_used),
            )
            if rc == 3:  # LIBDEFLATE_INSUFFICIENT_SPACE: grow, retry the member
                out = _grown(out, o)
                continue
            if rc != 0 or in_used.value == 0:
                return None
            i, o = _next_member(data, src, i + in_used.value), o + out_used.value
            if i == _END:
                return out, o
    finally:
        lib.libdeflate_free_decompressor(d)


def _inflate_libz(lib, data: bytes, src: np.ndarray, out: np.ndarray):
    """(array, bytes written) or None where ``gzip.decompress`` would
    not return: a decode or check error, a truncated member, bytes after
    a member that ``_next_member`` refuses."""
    import ctypes
    import zlib

    z = lib.ZStream()
    zp = ctypes.byref(z)
    # windowBits 31: one gzip member, its CRC-32 and ISIZE checked
    if lib.inflateInit2_(zp, 31, zlib.ZLIB_RUNTIME_VERSION.encode(),
                         ctypes.sizeof(z)) != 0:
        return None
    try:
        i = o = 0
        while True:
            z.next_in = src.ctypes.data + i
            z.avail_in = min(src.size - i, 1 << 30)
            z.next_out = out.ctypes.data + o
            z.avail_out = min(out.size - o, 1 << 30)
            rc = lib.inflate(zp, 0)  # Z_NO_FLUSH
            di = z.next_in - (src.ctypes.data + i)
            do = z.next_out - (out.ctypes.data + o)
            i, o = i + di, o + do
            if rc == 1:  # Z_STREAM_END: the member and its trailer read
                i = _next_member(data, src, i)
                if i == _END:
                    return out, o
                if i == _BAD or lib.inflateReset(zp) != 0:
                    return None
            elif rc not in (0, -5) or not (di or do or o == out.size):
                return None  # an error, or the input ended inside a member
            elif o == out.size:  # Z_OK or Z_BUF_ERROR with the array full
                out = _grown(out, o)
    finally:
        lib.inflateEnd(zp)


def gzip_decompress(data: bytes) -> bytes:
    """Whole-buffer gz inflate (multi-member aware, ``inflate``), the
    gzip module's where ``inflate`` cannot. Byte-identical output either
    way — only the inflate speed differs."""
    out = inflate(data)
    return gzip.decompress(data) if out is None else out.tobytes()


def read_bytes(path: str, pipecmd: str | None = None) -> bytes:
    """Read a (possibly compressed) file like ``zcat -fc`` does."""
    if pipecmd:
        return subprocess.run(
            f"{pipecmd} {path}", shell=True, check=True, stdout=subprocess.PIPE
        ).stdout
    if path.endswith(".gz"):
        with open(path, "rb") as f:
            return gzip_decompress(f.read())
    if path.endswith(".bz2"):
        with bz2.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def read_codes(
    path: str, fastq: bool = False, min_qual: int = 0, pipecmd: str | None = None
) -> np.ndarray:
    """The symbols of one whole file: ``fastq_to_codes`` (``fastq``) or
    ``fasta_to_codes`` of ``read_bytes(path, pipecmd)``, with no copy of
    the file's bytes. A plain file is read, and a gzip file inflated
    (``inflate``: the port's inflater, else libdeflate or the system
    zlib), into one writable array that the C scanner overwrites in
    place, and the symbols are a view of it. What arrives as bytes (the
    gzip module's inflate, bz2, a pipe) is scanned into one new array."""
    from public_kssd_tpu_torch import native

    buf = None
    if pipecmd:
        raw = read_bytes(path, pipecmd)
    elif path.endswith(".gz"):
        with open(path, "rb") as f:
            raw = f.read()
        buf = inflate(raw)
        if buf is None:
            raw = gzip.decompress(raw)
    elif path.endswith(".bz2"):
        raw = read_bytes(path)
    else:
        buf = np.fromfile(path, dtype=np.uint8)
    if buf is not None:
        if fastq:
            out = native.fastq_codes_in_place(buf, min_qual)
        else:
            out = native.fasta_codes_in_place(buf)
        if out is not None:
            return out
        raw = buf.tobytes()  # no C scanner on this host: numpy's
    if fastq:
        return fastq_to_codes(raw, min_qual)
    return fasta_to_codes(raw)


class _PipeStream:
    """File-like over a subprocess stdout that reaps the child on close
    (a bare proc.stdout would leave a zombie per streamed file)."""

    def __init__(self, proc):
        self._proc = proc

    def read(self, n: int = -1) -> bytes:
        return self._proc.stdout.read(n)

    def close(self) -> None:
        self._proc.stdout.close()
        self._proc.wait()


def _open_stream(path: str, pipecmd: str | None = None):
    """Open a (possibly compressed) file as a binary stream."""
    if pipecmd:
        proc = subprocess.Popen(
            f"{pipecmd} {path}", shell=True, stdout=subprocess.PIPE
        )
        return _PipeStream(proc)
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    if path.endswith(".bz2"):
        return bz2.open(path, "rb")
    return open(path, "rb")


def stream_fasta_codes(path, pipecmd=None, chunk_bytes: int = 1 << 26):
    """Lazily yield symbol-array pieces of a fasta file: bounded host RAM
    for arbitrarily large inputs (the streaming counterpart of the
    reference's 64 KB rolling buffer, iseq2comem.c:207-212).

    Pieces concatenate to the same BASE RUNS as the whole-file parse
    (sketch codes identical); break runs at piece boundaries may stay
    uncollapsed, which shifts positions but never windows. Each raw
    chunk is cut at its final newline so header state ('>' .. '\\n')
    never spans chunks; a sentinel base at each edge stops the scanner's
    boundary-BREAK trimming from merging runs across chunks.
    """
    f = _open_stream(path, pipecmd)
    try:
        rem = b""
        while True:
            buf = f.read(chunk_bytes)
            if not buf:
                break
            buf = rem + buf
            cut = buf.rfind(b"\n")
            if cut < 0:
                rem = buf
                continue
            block, rem = buf[: cut + 1], buf[cut + 1 :]
            piece = fasta_to_codes(b"A" + block + b"\nA")[1:-1]
            if piece.size:
                yield piece
        if rem:
            piece = fasta_to_codes(b"A" + rem + b"\nA")[1:-1]
            if piece.size:
                yield piece
    finally:
        f.close()


def stream_fastq_codes(
    path, min_qual: int = 0, pipecmd=None, chunk_bytes: int = 1 << 26
):
    """Lazily yield symbol-array pieces of a fastq file (bounded RAM).

    Chunks are cut at complete 4-line records, so the stateless record
    parser applies per chunk; an explicit BREAK joins chunks (a record
    boundary is a break by definition)."""
    f = _open_stream(path, pipecmd)
    brk = np.array([BREAK], dtype=np.uint8)
    try:
        rem = b""
        first = True
        while True:
            buf = f.read(chunk_bytes)
            if not buf:
                break
            buf = rem + buf
            arr = np.frombuffer(buf, dtype=np.uint8)
            nl = np.flatnonzero(arr == ord("\n"))
            keep = nl.size - (nl.size % 4)
            if keep == 0:
                rem = buf
                continue
            cut = int(nl[keep - 1]) + 1
            block, rem = buf[:cut], buf[cut:]
            piece = fastq_to_codes(block, min_qual)
            if piece.size:
                if not first:
                    yield brk
                first = False
                yield piece
        if rem:
            piece = fastq_to_codes(rem, min_qual)
            if piece.size:
                if not first:
                    yield brk
                yield piece
    finally:
        f.close()


def fasta_to_codes(raw: bytes) -> np.ndarray:
    """Parse a fasta byte stream into a code/BREAK symbol array.

    Consecutive BREAKs are collapsed; leading/trailing BREAKs trimmed —
    neither affects which windows are valid. Uses the native C scanner
    when available (public_kssd_tpu_torch.native), numpy otherwise.
    """
    from public_kssd_tpu_torch import native

    out = native.fasta_to_codes(raw)
    if out is not None:
        return out
    return fasta_to_codes_py(raw)


def fasta_to_codes_py(raw: bytes) -> np.ndarray:
    """Vectorised numpy implementation (fallback + test oracle)."""
    buf = np.frombuffer(raw, dtype=np.uint8)
    if buf.size == 0:
        return np.zeros(0, dtype=np.uint8)

    newline = (buf == ord("\n")) | (buf == ord("\r"))

    # Header masking: from each '>' to the next '\n' inclusive. The scanner
    # enters header mode on any '>' seen outside a header; a '>' inside a
    # header is consumed by the skip loop, so interval union is equivalent.
    gt = np.flatnonzero(buf == ord(">"))
    in_header = np.zeros(buf.size + 1, dtype=np.int32)
    if gt.size:
        nl = np.flatnonzero(buf == ord("\n"))
        # closing newline index for each '>' (or EOF, also when the
        # input has no newline at all)
        ends = np.append(nl, buf.size - 1)[np.searchsorted(nl, gt)]
        np.add.at(in_header, gt, 1)
        np.add.at(in_header, ends + 1, -1)
        in_header = np.cumsum(in_header[:-1]) > 0
    else:
        in_header = in_header[:-1].astype(bool)

    codes = _BASEMAP[buf]
    is_base = codes != 255
    # symbol classes: base outside header -> code; newline -> drop;
    # header chars and junk -> BREAK (runs collapse, so the whole header
    # region becomes the single reset the reference performs on '>')
    sym = np.where(is_base & ~in_header, codes, BREAK)[~newline]
    return _collapse_breaks(sym)


def fastq_to_codes(raw: bytes, min_qual: int = 0) -> np.ndarray:
    """Parse fastq: seq = line 4i+1, qual = line 4i+3 (fastq2co,
    iseq2comem.c:277-356). A base is valid iff Basemap-valid AND raw
    quality byte >= min_qual (the reference compares the raw ASCII byte,
    not phred-33). Read boundaries and invalid bases are BREAKs.
    """
    from public_kssd_tpu_torch import native

    out = native.fastq_to_codes(raw, min_qual)
    if out is not None:
        return out
    return fastq_to_codes_py(raw, min_qual)


def fastq_to_codes_py(raw: bytes, min_qual: int = 0) -> np.ndarray:
    """Pure-python implementation (fallback + test oracle)."""
    lines = raw.split(b"\n")
    pieces: list[np.ndarray] = []
    brk = np.array([BREAK], dtype=np.uint8)
    nrec = len(lines) // 4  # trailing partial record is dropped like fgets EOF
    for i in range(nrec):
        seq = np.frombuffer(lines[4 * i + 1], dtype=np.uint8)
        qual = np.frombuffer(lines[4 * i + 3], dtype=np.uint8)
        codes = _BASEMAP[seq]
        n = min(seq.size, qual.size) if min_qual > 0 else seq.size
        ok = codes[:n] != 255
        if min_qual > 0:
            ok &= qual[:n] >= min_qual
        sym = np.where(ok, codes[:n], BREAK)
        pieces.append(sym)
        pieces.append(brk)
    if not pieces:
        return np.zeros(0, dtype=np.uint8)
    return _collapse_breaks(np.concatenate(pieces))


def fastq_to_reads(raw: bytes, min_qual: int = 0) -> list[np.ndarray]:
    """Per-read symbol arrays (for --byread and koc-by-read modes)."""
    lines = raw.split(b"\n")
    reads = []
    for i in range(len(lines) // 4):
        seq = np.frombuffer(lines[4 * i + 1], dtype=np.uint8)
        qual = np.frombuffer(lines[4 * i + 3], dtype=np.uint8)
        codes = _BASEMAP[seq]
        n = min(seq.size, qual.size) if min_qual > 0 else seq.size
        ok = codes[:n] != 255
        if min_qual > 0:
            ok &= qual[:n] >= min_qual
        reads.append(np.where(ok, codes[:n], BREAK).astype(np.uint8))
    return reads


def fasta_to_reads(raw: bytes) -> list[np.ndarray]:
    """Per-record symbol arrays for --byread (reads2mco,
    iseq2comem.c:78-186).

    The reference's byread scanner is fasta-shaped regardless of the
    input format: every '>' that reaches the state machine (i.e. not
    consumed by a previous header's skip-to-newline loop) starts a new
    record, and the stream before the first '>' is record 0. We
    replicate that exactly, including the pseudo-records a fastq input
    produces when '>' bytes appear in quality strings.
    """
    buf = np.frombuffer(raw, dtype=np.uint8)
    gt = np.flatnonzero(buf == ord(">"))
    nl = np.flatnonzero(buf == ord("\n"))
    # greedy active-header intervals [start, end_of_line]
    spans = []  # (header_start, header_end_incl)
    pos = -1
    for g in gt.tolist():
        if g <= pos:
            continue  # consumed by the previous header's skip loop
        j = np.searchsorted(nl, g)
        end = int(nl[j]) if j < nl.size else buf.size - 1
        spans.append((g, end))
        pos = end
    starts = [0] + [e + 1 for _, e in spans]
    ends = [s for s, _ in spans] + [buf.size]
    reads = []
    for s, e in zip(starts, ends):
        reads.append(_plain_to_codes(buf[s:e]))
    return reads


def _plain_to_codes(buf: np.ndarray) -> np.ndarray:
    """Header-free fasta char rules: base -> code, newline -> skip,
    anything else -> BREAK."""
    if buf.size == 0:
        return np.zeros(0, dtype=np.uint8)
    newline = (buf == ord("\n")) | (buf == ord("\r"))
    codes = _BASEMAP[buf]
    sym = np.where(codes != 255, codes, BREAK)[~newline]
    return _collapse_breaks(sym)


def _collapse_breaks(sym: np.ndarray) -> np.ndarray:
    """Collapse runs of BREAK and strip boundary BREAKs (no-op on windows)."""
    if sym.size == 0:
        return sym
    is_brk = sym == BREAK
    dup = np.zeros(sym.size, dtype=bool)
    dup[1:] = is_brk[1:] & is_brk[:-1]
    sym = sym[~dup]
    # strip leading/trailing break
    start = 1 if sym.size and sym[0] == BREAK else 0
    end = sym.size - 1 if sym.size > start and sym[-1] == BREAK else sym.size
    return np.ascontiguousarray(sym[start:end])
