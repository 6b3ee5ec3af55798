"""ctypes bindings for the native host helpers (kssd_host.c, kssd_print.c,
kssd_dedup.c, kssd_inflate.c, kssd_scan.c).

The C sources are this package's own: ``native/kssd_host.c``, a
byte-equal copy of the JAX package's (tests/test_torch_package.py holds
the two equal), ``native/kssd_print.c``, the distance.out block
formatter, ``native/kssd_dedup.c``, the slot-order dedups that visit
only the slots they fill, ``native/kssd_inflate.c``, the gzip inflater
of stage I's parse, and ``native/kssd_scan.c``, its FASTA scanner (the
symbols of kssd_host.c's ``kssd_fasta_to_codes``, 16-32 bytes a step).
All five are compiled on demand with the
system compiler into one library in ``build/public_kssd_tpu_torch/``
under the checkout, under a name keyed by the sources' hash and flags,
so a library built from other sources is never loaded. Plain ``-O3`` (no
``-march=native``): the library runs on any x86-64 host. If the build
fails (no toolchain), callers fall back to the pure-python/numpy implementations in
seqio.py / hashdedup.py — same results, slower host path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "kssd_host.c")
_PRINT_SRC = os.path.join(_HERE, "kssd_print.c")
_DEDUP_SRC = os.path.join(_HERE, "kssd_dedup.c")
_INFLATE_SRC = os.path.join(_HERE, "kssd_inflate.c")
_SCAN_SRC = os.path.join(_HERE, "kssd_scan.c")
_SOURCES = (_SRC, _PRINT_SRC, _DEDUP_SRC, _INFLATE_SRC, _SCAN_SRC)
BUILD_DIR = os.path.join(_ROOT, "build", "public_kssd_tpu_torch")
_CFLAGS = ["-O3", "-shared", "-fPIC"]

_lib = None
_tried = False
# held while get_lib builds and loads: a caller that arrives meanwhile
# waits for that attempt and gets its result
_LOCK = threading.Lock()


def _so_path() -> str:
    h = hashlib.sha256(" ".join(_CFLAGS).encode())
    for src in _SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"kssd_host-{h.hexdigest()[:16]}.so")


def _build(so: str) -> bool:
    """Compile into a temporary name, then rename: concurrent processes
    (test workers) never load a half-written library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["cc", *_CFLAGS, *_SOURCES, "-o", tmp, "-lm"]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError):
        return False
    os.replace(tmp, so)
    return True


def get_lib():
    """The loaded library, or None if unavailable. Thread-safe: the
    first caller builds and loads it under ``_LOCK``, and a caller that
    arrives during that attempt waits for it; ``_tried`` is set only once
    the attempt has finished."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _LOCK:
        if not _tried:
            _lib = _load()
            _tried = True
    return _lib


def _load():
    """Build (when its file is missing) and bind the library; None when
    it cannot be had."""
    if not all(os.path.isfile(src) for src in _SOURCES):
        return None
    so = _so_path()
    if not os.path.exists(so) and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    lib.kssd_fasta_to_codes.restype = ctypes.c_size_t
    lib.kssd_fasta_to_codes.argtypes = [u8p, ctypes.c_size_t, u8p]
    lib.kssd_fasta_scan.restype = ctypes.c_size_t
    lib.kssd_fasta_scan.argtypes = [u8p, ctypes.c_size_t, u8p]
    lib.kssd_fasta_scan_at.restype = ctypes.c_size_t
    lib.kssd_fasta_scan_at.argtypes = [u8p, ctypes.c_size_t, u8p, ctypes.c_int]
    lib.kssd_fastq_to_codes.restype = ctypes.c_size_t
    lib.kssd_fastq_to_codes.argtypes = [u8p, ctypes.c_size_t, ctypes.c_int, u8p]
    lib.kssd_dedup_slot_order_sparse.restype = ctypes.c_size_t
    lib.kssd_dedup_slot_order_sparse.argtypes = [
        u64p, ctypes.c_size_t, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int,
        u32p, u64p, ctypes.c_uint32, u32p, u64p,
    ]
    lib.kssd_dedup_counts_sparse.restype = ctypes.c_size_t
    lib.kssd_dedup_counts_sparse.argtypes = [
        u64p, ctypes.c_size_t, ctypes.c_uint32, ctypes.c_int, ctypes.c_int,
        u32p, u64p, ctypes.c_uint32, u32p, u64p, u32p,
    ]
    lib.kssd_dedup_u32_slot_order.restype = ctypes.c_size_t
    lib.kssd_dedup_u32_slot_order.argtypes = [
        u32p, ctypes.c_size_t, u32p, ctypes.c_uint32, u32p,
    ]
    lib.kssd_gzip_inflate.restype = ctypes.c_int
    lib.kssd_gzip_inflate.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.kssd_crc32.restype = ctypes.c_uint32
    lib.kssd_crc32.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.kssd_pack2.restype = None
    lib.kssd_pack2.argtypes = [u8p, ctypes.c_size_t, u32p, ctypes.c_size_t]
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.kssd_dist_rows_buf.restype = ctypes.c_int64
    lib.kssd_dist_rows_buf.argtypes = [
        u8p, i64p, u32p, u8p, i64p, u32p, u32p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        u8p, ctypes.c_int64,
    ]
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.kssd_fmt_field.restype = ctypes.c_int
    lib.kssd_fmt_field.argtypes = [ctypes.c_double, ctypes.c_int, ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_int)]
    lib.kssd_fmt_check.restype = ctypes.c_int64
    lib.kssd_fmt_check.argtypes = [f64p, ctypes.c_int64, ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_int64)]
    lib.kssd_pow10_dd.restype = ctypes.c_int
    lib.kssd_pow10_dd.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_double),
                                  ctypes.POINTER(ctypes.c_double)]
    return lib


def fasta_to_codes(raw: bytes) -> np.ndarray | None:
    """kssd_fasta_to_codes' symbols of ``raw`` (kssd_scan.c's
    kssd_fasta_scan) into one new array; the symbols are a view of it."""
    lib = get_lib()
    if lib is None:
        return None
    data = np.frombuffer(raw, dtype=np.uint8)
    out = np.empty(max(data.size, 1), dtype=np.uint8)
    return out[: lib.kssd_fasta_scan(data, data.size, out)]


def fastq_to_codes(raw: bytes, min_qual: int = 0) -> np.ndarray | None:
    """kssd_fastq_to_codes of ``raw`` into one new array; the symbols
    are a view of it."""
    lib = get_lib()
    if lib is None:
        return None
    data = np.frombuffer(raw, dtype=np.uint8)
    out = np.empty(max(data.size, 1), dtype=np.uint8)
    return out[: lib.kssd_fastq_to_codes(data, data.size, min_qual, out)]


# kssd_gzip_inflate's results
INFLATE_OK, INFLATE_BAD_DATA, INFLATE_BAD_CHECK, INFLATE_NO_SPACE, INFLATE_TRUNCATED = range(5)


def gzip_member(src: int, n_src: int, dst: int, n_dst: int) -> tuple[int, int, int] | None:
    """kssd_gzip_inflate: the gzip member at address ``src`` (``n_src``
    bytes readable, the member first) inflated into address ``dst``
    (``n_dst`` bytes writable, nothing written past them), as (one of
    the INFLATE_* codes, bytes read, bytes written); None when the
    helper did not build. Drops the GIL while it runs."""
    lib = get_lib()
    if lib is None:
        return None
    n_in, n_out = ctypes.c_size_t(), ctypes.c_size_t()
    rc = lib.kssd_gzip_inflate(src, n_src, dst, n_dst, ctypes.byref(n_in),
                               ctypes.byref(n_out))
    return rc, n_in.value, n_out.value


def crc32(data) -> int | None:
    """kssd_inflate.c's CRC-32 of ``data`` (bytes or a contiguous
    array), as ``zlib.crc32`` gives it; None when the helper did not
    build."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    return lib.kssd_crc32(buf.ctypes.data, buf.size)


# In place: each scanner writes at most one symbol for each byte it has
# read, so its write position never passes its read position, and the
# byte at the write position has been read before it is written. The
# fastq scanner finds a record's four lines before it writes any symbol
# of it: its writes stay below the record's sequence line, its quality
# reads above it. The FASTA scanner's block stores write only below its
# next read (kssd_scan.c). Neither source's pointers are restrict, so
# the aliasing is legal C.


def _writable(buf: np.ndarray) -> np.ndarray:
    if not (buf.dtype == np.uint8 and buf.ndim == 1
            and buf.flags.c_contiguous and buf.flags.writeable):
        raise ValueError("a writable contiguous 1-d uint8 array expected")
    return buf


def fasta_codes_in_place(buf: np.ndarray) -> np.ndarray | None:
    """``fasta_to_codes`` of ``buf``'s bytes, written over them: the
    symbols are ``buf[:n]``. None if the lib is absent."""
    lib = get_lib()
    if lib is None:
        return None
    buf = _writable(buf)
    return buf[: lib.kssd_fasta_scan(buf, buf.size, buf)]


def fastq_codes_in_place(buf: np.ndarray, min_qual: int = 0) -> np.ndarray | None:
    """``fastq_to_codes`` of ``buf``'s bytes, written over them: the
    symbols are ``buf[:n]``. None if the lib is absent."""
    lib = get_lib()
    if lib is None:
        return None
    buf = _writable(buf)
    return buf[: lib.kssd_fastq_to_codes(buf, buf.size, min_qual, buf)]


def _slot_map(n_fill: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Work arrays of kssd_dedup.c's virtual table for up to ``n_fill``
    filled slots: zeroed keys and values of a power-of-two capacity at
    least twice ``n_fill`` (at least 4), and the filled slots' list with
    the radix sort's space."""
    cap = max(4, 1 << (2 * max(n_fill, 1) - 1).bit_length())
    if cap > 1 << 31:
        raise ValueError(f"a dedup of {n_fill} distinct codes does not fit")
    return (np.zeros(cap, dtype=np.uint32), np.empty(cap, dtype=np.uint64),
            np.empty(2 * max(n_fill, 1), dtype=np.uint32))


def dedup_slot_order(
    codes: np.ndarray, hashsize: int, hashlimit: int, uniq: bool
) -> np.ndarray | None:
    """kssd_dedup_slot_order's codes (kssd_host.c) through its sparse twin
    in kssd_dedup.c: memory and work follow the stream, not hashsize."""
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint64)
    n_fill = min(codes.size, hashlimit + 1)  # the crowded error stops it there
    key, val, slots = _slot_map(n_fill)
    out = np.empty(max(n_fill, 1), dtype=np.uint64)
    n = lib.kssd_dedup_slot_order_sparse(
        codes, codes.size, hashsize, hashlimit, int(uniq), key, val, key.size,
        slots, out,
    )
    if n == ctypes.c_size_t(-1).value:
        from public_kssd_tpu_torch.hashdedup import HashCrowdedError

        raise HashCrowdedError("the context space is too crowded")
    return out[:n].copy()


def dedup_counts(
    codes: np.ndarray, hashsize: int, count_bits: int, min_occurrence: int
) -> tuple[np.ndarray, np.ndarray] | None:
    """kssd_dedup_counts's codes and counts (kssd_host.c) through its
    sparse twin in kssd_dedup.c."""
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint64)
    n_fill = min(codes.size, hashsize)
    key, val, slots = _slot_map(n_fill)
    out_c = np.empty(max(n_fill, 1), dtype=np.uint64)
    out_n = np.empty(max(n_fill, 1), dtype=np.uint32)
    n = lib.kssd_dedup_counts_sparse(
        codes, codes.size, hashsize, count_bits, min_occurrence, key, val,
        key.size, slots, out_c, out_n,
    )
    return out_c[:n].copy(), out_n[:n].copy()


def dedup_u32_slot_order(codes: np.ndarray, hashsize: int) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint32)
    table = np.zeros(hashsize, dtype=np.uint32)
    out = np.empty(hashsize, dtype=np.uint32)
    n = lib.kssd_dedup_u32_slot_order(codes, codes.size, table, hashsize, out)
    return out[:n].copy()


class Names:
    """Names as one blob of NUL-terminated UTF-8 strings and each one's
    byte offset: the form the native formatter reads them in. Of a
    ``stattab.NameTable`` the blob is its rows themselves, each name at a
    multiple of the rows' width (the formatter stops at a name's first
    NUL); where a name fills its row, a copy of the rows with a NUL
    column appended."""

    def __init__(self, names):
        from public_kssd_tpu_torch.stattab import NameTable

        if isinstance(names, NameTable):
            n, width = names.rows.shape
            self.longest = int(names.lengths.max(initial=0))
            if not n:
                self.blob = np.zeros(1, np.uint8)
            elif self.longest < width:
                self.blob = names.rows.reshape(-1)
            else:
                width += 1
                self.blob = np.zeros((n, width), np.uint8)
                self.blob[:, :-1] = names.rows
                self.blob = self.blob.reshape(-1)
            self.offsets = np.arange(n, dtype=np.int64) * width
            return
        enc = [n.encode() + b"\0" for n in names]
        self.blob = np.frombuffer(b"".join(enc) or b"\0", np.uint8)
        self.offsets = np.zeros(len(enc), np.int64)
        np.cumsum([len(e) for e in enc[:-1]], out=self.offsets[1:])
        self.longest = max((len(e) - 1 for e in enc), default=0)


def dist_rows_buf(
    qnames: Names,
    qry_sizes: np.ndarray,
    rnames: Names,
    ref_sizes: np.ndarray,
    rows: np.ndarray,
    q0: int,
    r0: int,
    r1: int,
    rid_sel: np.ndarray | None,
    sel_off: np.ndarray | None,
    kmerlen: int,
    dim_rd_len: int,
    cmprsn_num: float,
    metric: int,
    pfield: int,
    correction: int,
    dthreshold: float,
    buf: np.ndarray,
) -> tuple[np.ndarray, int] | None:
    """Formats the distance.out lines (reference-exact output_ctrl
    semantics, glibc printf) of query rows ``q0 .. q0 + len(rows)`` into
    ``buf``: ref ids ``[r0, r1)`` of each row, or, with ``rid_sel``, each
    query's selection ``rid_sel[sel_off[i]:sel_off[i + 1]]`` in order.
    ``rows`` holds those queries' shared counts, uint32 [rows, n_ref].
    Returns the buffer holding the text (``buf``, or a larger one when
    ``buf`` was too small) and the bytes used; None if the lib is absent.
    Safe to call from many threads at once: it holds no Python state."""
    lib = get_lib()
    if lib is None:
        return None
    n_ref = ref_sizes.size
    q1 = q0 + rows.shape[0]
    if rows.dtype != np.uint32 or rows.ndim != 2 or rows.shape[1] != n_ref:
        raise ValueError(f"rows: uint32 [n, {n_ref}] expected, got "
                         f"{rows.dtype} {rows.shape}")
    if not (0 <= q0 <= q1 <= min(qry_sizes.size, qnames.offsets.size)
            and rnames.offsets.size == n_ref and 0 <= r0 <= r1 <= n_ref):
        raise ValueError(f"rows [{q0}, {q1}) x refs [{r0}, {r1}) out of range")
    sel_ptr = off_ptr = None
    if rid_sel is not None:
        if (sel_off.size != q1 - q0 + 1 or sel_off[0] != 0
                or sel_off[-1] != rid_sel.size or np.any(np.diff(sel_off) < 0)
                or (rid_sel.size and not 0 <= rid_sel.min() <= rid_sel.max() < n_ref)):
            raise ValueError("rid_sel / sel_off do not describe the rows")
        rid_sel = np.ascontiguousarray(rid_sel, np.int64)
        sel_off = np.ascontiguousarray(sel_off, np.int64)
        sel_ptr, off_ptr = rid_sel.ctypes.data, sel_off.ctypes.data
    rows = np.ascontiguousarray(rows)
    while True:
        n = lib.kssd_dist_rows_buf(
            qnames.blob, qnames.offsets, qry_sizes, rnames.blob,
            rnames.offsets, ref_sizes, rows, n_ref, q0, q1, r0, r1,
            sel_ptr, off_ptr, kmerlen, dim_rd_len, cmprsn_num,
            metric, pfield, correction, dthreshold, buf, buf.size,
        )
        if n <= buf.size:
            return buf, n
        buf = np.empty(n, np.uint8)


# the field writers of kssd_print.c, by the printf conversion they give
FIELD_KINDS = {"%.6f": 0, "%E": 1}


def format_field(x: float, fmt: str) -> tuple[str, bool]:
    """One distance.out float field as the native formatter writes it
    (``fmt`` ``"%.6f"`` or ``"%E"``), and whether it went through
    snprintf."""
    out = ctypes.create_string_buffer(512)
    slow = ctypes.c_int()
    n = get_lib().kssd_fmt_field(float(x), FIELD_KINDS[fmt], out, ctypes.byref(slow))
    return out.raw[:n].decode(), bool(slow.value)


def check_fields(values: np.ndarray, fmt: str) -> tuple[int, int]:
    """The native field writer for ``fmt`` against this process's libc
    snprintf on every value: the index of the first value whose text
    differs (-1: none) and how many values went through snprintf. Drops
    the GIL: callers may split the values over threads."""
    values = np.ascontiguousarray(values, np.float64)
    slow = ctypes.c_int64()
    bad = get_lib().kssd_fmt_check(values, values.size, FIELD_KINDS[fmt],
                                   ctypes.byref(slow))
    return int(bad), slow.value


# doubles on the float fields' edges: signed zeros and tiny negatives
# ("-0.000000"), exact ties at the sixth decimal (odd/128) and at the
# seventh digit, carries into the next digit or exponent, the ends of
# the exact paths (|x| * 1e6 = 2^53; %E's exact powers 10^0..10^22 and
# 1e-300), subnormals and the non-finite values
FIELD_CORNERS = (
    0.0, -0.0, -1e-7, -4e-7, -5e-7, -1e-300, -5e-324, 5e-7, 1.5e-6, 2.5e-6,
    0.9999995, float(np.nextafter(0.9999995, 2)), float(np.nextafter(0.9999995, 0)),
    9.9999995e-05, float(np.nextafter(9.9999995e-05, 1)), 9.99999949e-05,
    1 / 128, 3 / 128, 5 / 128, 127 / 128, 129 / 128, 0.5, 1.0, 1.96, -0.0234375,
    2**53 / 1e6, float(np.nextafter(2**53 / 1e6, 0)), float(np.nextafter(2**53 / 1e6, 1e300)),
    2**52 / 1e6 + 0.5e-6, 12345675.0, 12345665.0, 9999999.5, 99999995.0, 1e7, 1e-16,
    float(np.nextafter(1e-16, 0)), 1e-5, 9.9999995e-6, 1e22, 1e23, 1e28, 1e29,
    1.2345675e-20, 1e-300, float(np.nextafter(1e-300, 0)), 1e-310, 5e-324,
    2.2250738585072014e-308, 1.7976931348623157e308, -1.7976931348623157e308,
    -4503599524020271.0, float("inf"), float("-inf"), float("nan"), -float("nan"),
)


def field_values(n: int, seed: int) -> np.ndarray:
    """FIELD_CORNERS, then ``n`` doubles made from ``seed``, about a sixth
    each: uniform in [0, 1) (m, dist, the CIs), log-uniform over
    [1e-300, 1e10) (p-values and their products), exact ties k/128,
    the midpoints between six-decimal values and their neighbours,
    integers below 10^8 (ties at the seventh digit) and random bit
    patterns (every class of double); half of them negated."""
    rng = np.random.default_rng(seed)
    part = -(-n // 6)
    mid = (rng.integers(0, 10**7, part) + 0.5) / 1e6
    parts = [
        rng.random(part),
        10.0 ** rng.uniform(-300, 10, part),
        rng.integers(0, 2**17, part) / 128,
        np.nextafter(mid, rng.choice([-np.inf, np.inf], part)),
        rng.integers(0, 10**8, part).astype(np.float64),
        rng.integers(0, 2**64, part, dtype=np.uint64, endpoint=False).view(np.float64),
    ]
    x = np.concatenate(parts)[:n]
    x.view(np.uint64)[rng.random(n) < 0.5] ^= np.uint64(1 << 63)  # the sign bit
    return np.concatenate([np.array(FIELD_CORNERS), x])


def pow10_dd(k: int) -> tuple[float, float]:
    """The formatter's double-double 10^k (hi, lo), k in [0, 308]."""
    hi, lo = ctypes.c_double(), ctypes.c_double()
    if not get_lib().kssd_pow10_dd(k, ctypes.byref(hi), ctypes.byref(lo)):
        raise ValueError(f"10^{k}: k in [0, 308] expected")
    return hi.value, lo.value


def pack2(symbols: np.ndarray, total: int) -> np.ndarray | None:
    """2-bit pack (16 bases/uint32 word, BREAK->0), C-speed.

    ~25x faster than the numpy fallback in ops/sketch.pack2 (memory
    bound vs 4 strided passes)."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(total // 16, dtype=np.uint32)
    sym = np.ascontiguousarray(symbols, dtype=np.uint8)
    lib.kssd_pack2(sym, sym.size, out, out.size)
    return out
