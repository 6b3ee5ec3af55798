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
    the library is missing; callers fall back to the gzip module."""
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
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_size_t),
        ]
    except AttributeError:
        return None
    return lib


_LIBDEFLATE = _load_libdeflate()


def gzip_decompress(data: bytes) -> bytes:
    """Whole-buffer gz inflate via libdeflate when available (multi-
    member aware), zlib's gzip module otherwise. Byte-identical output
    either way — only the inflate speed differs (the GIL is released
    inside libdeflate, so parse-ahead threads scale with cores exactly
    as with zlib)."""
    import ctypes

    lib = _LIBDEFLATE
    if lib is None or len(data) < 18:
        return gzip.decompress(data)
    # ISIZE (last member's uncompressed size mod 2^32) seeds the output
    # buffer; grow-and-retry covers multi-member files and >4 GB
    # members, any decode error falls back to zlib
    guess = max(int.from_bytes(data[-4:], "little"), 4 * len(data), 1 << 16)
    d = lib.libdeflate_alloc_decompressor()
    if not d:
        return gzip.decompress(data)
    try:
        parts = []
        in_off = 0
        out_buf = ctypes.create_string_buffer(guess)
        while in_off < len(data):
            in_used = ctypes.c_size_t(0)
            out_used = ctypes.c_size_t(0)
            rc = lib.libdeflate_gzip_decompress_ex(
                d, data[in_off:], len(data) - in_off,
                out_buf, len(out_buf),
                ctypes.byref(in_used), ctypes.byref(out_used),
            )
            if rc == 3:  # LIBDEFLATE_INSUFFICIENT_SPACE
                out_buf = ctypes.create_string_buffer(2 * len(out_buf))
                continue
            if rc != 0 or in_used.value == 0:
                return gzip.decompress(data)
            parts.append(out_buf.raw[: out_used.value])
            in_off += in_used.value
            # trailing garbage/padding after the last member: stop like
            # zcat does when what remains cannot be a gzip header
            if len(data) - in_off < 18 or data[in_off : in_off + 2] != b"\x1f\x8b":
                break
        return b"".join(parts)
    finally:
        lib.libdeflate_free_decompressor(d)


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
        # closing newline index for each '>' (or EOF)
        close = np.searchsorted(nl, gt)
        ends = np.where(close < nl.size, nl[np.minimum(close, nl.size - 1)], buf.size - 1)
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
