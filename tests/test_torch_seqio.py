"""The port's small-file parse (seqio.read_codes under pipeline.parse_one:
one buffer inflated and scanned in place) against the JAX package's
(seqio.read_bytes, then fasta_to_codes / fastq_to_codes), on the CPU.
Every symbol must be equal, on each inflate route: the port's own
inflater (native/kssd_inflate.c), with libdeflate loaded as on this
host (its stop rule where the members end) and without it
(``seqio._LIBDEFLATE = None`` in both packages: the JAX package then
takes the gzip module's route); and, with the port's inflater off
(``seqio._KSSD = False``), libdeflate; the system zlib into the
array (``_LIBDEFLATE = None``); and the gzip module (``seqio._LIBZ =
None`` too). Where the JAX package raises, the port raises the same
error."""

import bz2
import gzip
from types import SimpleNamespace

import numpy as np
import pytest
from hypothesis import example, given, settings, strategies as st

from public_kssd_tpu import pipeline as jax_pipeline, seqio as jax_seqio
from public_kssd_tpu_torch import native, pipeline, seqio



def _fasta(seed: int, n_bp: int, n_records: int = 3) -> bytes:
    """Records of 80-column lines with N runs, lower case and a CRLF
    line."""
    rng = np.random.default_rng(seed)
    out = []
    for r in range(n_records):
        seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n_bp // n_records)]
        seq[rng.integers(0, seq.size, 20)] = ord("N")
        seq[: seq.size // 10] += 32  # lower case
        lines = [seq[i : i + 80].tobytes() for i in range(0, seq.size, 80)]
        lines[1] += b"\r"
        out.append(b">rec%d some description\n" % r + b"\n".join(lines) + b"\n")
    return b"".join(out)


def _fastq(seed: int, n_reads: int) -> bytes:
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n_reads):
        n = int(rng.integers(30, 150))
        seq = np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, n)].tobytes()
        qual = rng.integers(33, 75, n).astype(np.uint8).tobytes()
        recs.append(b"@r%d\n%s\n+\n%s\n" % (i, seq, qual))
    return b"".join(recs)


def _members(body: bytes, size: int, level: int = 1) -> bytes:
    """One gzip member for each ``size`` bytes of ``body``."""
    return b"".join(gzip.compress(body[i : i + size], level)
                    for i in range(0, len(body), size))


def _bgzip_like(body: bytes) -> bytes:
    """bgzip's layout: a member for each 64 KB, then an empty member
    (its end-of-file marker)."""
    return _members(body, 65280, 6) + gzip.compress(b"")


FASTA = _fasta(1, 400_000)
FASTQ = _fastq(2, 3000)

# name -> (file name, file bytes, pipecmd, -Q)
CASES = {
    "single_member": ("g.fna.gz", gzip.compress(FASTA, 6), None, 0),
    "bgzip_members": ("g.fna.gz", _bgzip_like(FASTA), None, 0),
    "200_tiny_members": ("g.fa.gz", _members(FASTA[:40_000], 200), None, 0),
    "zero_padding": ("g.fna.gz", gzip.compress(FASTA) + bytes(100), None, 0),
    "short_garbage": ("g.fna.gz", gzip.compress(FASTA) + b"junk\n", None, 0),
    "long_garbage": ("g.fna.gz", gzip.compress(FASTA) + b"trailing junk " * 4, None, 0),
    "truncated": ("g.fna.gz", gzip.compress(FASTA)[:-100], None, 0),
    "bad_member": ("g.fna.gz", gzip.compress(FASTA) + b"\x1f\x8b" + bytes(30), None, 0),
    # each member 1 MB of one base: the last ISIZE passes for a single
    # member's size and under-sizes the buffer, which must grow
    "isize_undersized": ("g.fna.gz", gzip.compress(b">a\n")
                         + b"".join(gzip.compress(bytes([c]) * (1 << 20), 9) for c in b"ACGTA"),
                         None, 0),
    "empty_gz": ("g.fna.gz", gzip.compress(b""), None, 0),
    "header_only_gz": ("g.fna.gz", gzip.compress(b">only a header\n"), None, 0),
    "plain": ("g.fasta", FASTA, None, 0),
    "plain_empty": ("g.fasta", b"", None, 0),
    "bz2": ("g.fna.bz2", bz2.compress(FASTA), None, 0),
    "fastq_gz": ("r.fq.gz", _bgzip_like(FASTQ), None, 0),
    "fastq_gz_q": ("r.fq.gz", gzip.compress(FASTQ), None, 58),
    "fastq_plain_q": ("r.fastq", FASTQ, None, 45),
    "pipe": ("r.fa", FASTQ, "cat", 50),
}


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # the error is the outcome compared
        return "raises", type(e), str(e)


def _same(a, b):
    assert a[0] == b[0], (a, b)
    if a[0] == "raises":
        assert a[1:] == b[1:]
    else:
        np.testing.assert_array_equal(a[1], b[1])
        assert a[1].dtype == b[1].dtype == np.uint8


@pytest.fixture(params=["kssd", "kssd_no_libdeflate", "libdeflate", "libz",
                        "gzip_module"])
def route(request, monkeypatch):
    if request.param.startswith("kssd"):
        if native.get_lib() is None:
            pytest.skip("native toolchain unavailable")
    else:
        monkeypatch.setattr(seqio, "_KSSD", False)
    if request.param == "libdeflate":
        if seqio._LIBDEFLATE is None or jax_seqio._LIBDEFLATE is None:
            pytest.skip("libdeflate is not installed")
    elif request.param != "kssd":
        monkeypatch.setattr(seqio, "_LIBDEFLATE", None)
        monkeypatch.setattr(jax_seqio, "_LIBDEFLATE", None)
    if request.param == "libz" and seqio._LIBZ is None:
        pytest.skip("the system zlib cannot be loaded")
    if request.param == "gzip_module":
        monkeypatch.setattr(seqio, "_LIBZ", None)
    want = {"kssd_no_libdeflate": "kssd", "libz": "zlib", "gzip_module": "gzip module"}
    assert seqio.inflate_route() == want.get(request.param, request.param)
    return request.param


@pytest.mark.parametrize("case", sorted(CASES))
def test_parse_one_matches_jax(case, route, tmp_path):
    name, body, pipecmd, min_qual = CASES[case]
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(body)
    port = pipeline.SketchOptions(min_qual=min_qual, pipecmd=pipecmd)
    orig = jax_pipeline.SketchOptions(min_qual=min_qual, pipecmd=pipecmd)
    got = _outcome(lambda: pipeline.parse_one(path, port))
    _same(got, _outcome(lambda: jax_pipeline.parse_one(path, orig)))
    fastq = name.endswith((".fq.gz", ".fastq")) or bool(pipecmd)
    if fastq:
        want = _outcome(lambda: jax_seqio.fastq_to_codes(
            jax_seqio.read_bytes(path, pipecmd), min_qual))
    else:
        want = _outcome(lambda: jax_seqio.fasta_to_codes(jax_seqio.read_bytes(path, pipecmd)))
    _same(got, want)
    # the bytes themselves, through the thin wrappers
    raw = _outcome(lambda: np.frombuffer(seqio.read_bytes(path, pipecmd), np.uint8))
    _same(raw, _outcome(lambda: np.frombuffer(jax_seqio.read_bytes(path, pipecmd), np.uint8)))
    if got[0] == "ok" and case not in ("plain_empty", "empty_gz", "header_only_gz"):
        assert got[1].size > 0
    if got[0] == "ok" and name.endswith(".gz") and route != "gzip_module":
        # the library inflated it, not the gzip module behind it
        assert seqio.inflate(body) is not None


def test_garbage_routes_differ_as_in_the_jax_package(tmp_path):
    """Trailing garbage stops libdeflate's route and fails zlib's, in
    the port as in the JAX package (not repaired here)."""
    if seqio._LIBDEFLATE is None:
        pytest.skip("libdeflate is not installed")
    data = CASES["short_garbage"][1]
    assert seqio.gzip_decompress(data) == jax_seqio.gzip_decompress(data) == FASTA
    with pytest.raises(gzip.BadGzipFile):
        gzip.decompress(data)


def _owner(a: np.ndarray) -> np.ndarray:
    while a.base is not None:
        a = a.base
    return a


@pytest.mark.parametrize("suffix", [".fna.gz", ".fasta"])
def test_symbols_pin_at_most_their_size(route, suffix, tmp_path):
    """A single-member file's symbols are a view of the one buffer they
    were inflated and scanned in, at most 1.3x their size."""
    path = str(tmp_path / f"g{suffix}")
    with open(path, "wb") as f:
        f.write(gzip.compress(FASTA) if suffix.endswith(".gz") else FASTA)
    sym = pipeline.parse_one(path, pipeline.SketchOptions())
    assert sym.size > 0.98 * len(FASTA)
    assert _owner(sym).nbytes <= 1.3 * sym.nbytes
    if route != "gzip_module" and suffix.endswith(".gz"):
        buf = seqio.inflate(gzip.compress(FASTA))
        assert buf.flags.writeable and _owner(buf).nbytes == len(FASTA)


class _SliceCountingBytes(bytes):
    """bytes that record the length of every slice taken of them."""

    def __new__(cls, data):
        self = super().__new__(cls, data)
        self.slices = []
        return self

    def __getitem__(self, key):
        out = super().__getitem__(key)
        if isinstance(key, slice):
            self.slices.append(len(out))
        return out


class _CountingLib:
    """libdeflate, libz or the port's helper with the input address and
    length of each decompress call recorded."""

    def __init__(self, lib):
        self._lib = lib
        self.calls = []

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def libdeflate_gzip_decompress_ex(self, d, src, n_src, *rest):
        self.calls.append((src, n_src))
        return self._lib.libdeflate_gzip_decompress_ex(d, src, n_src, *rest)

    def inflate(self, zp, flush):
        self.calls.append((zp._obj.next_in, zp._obj.avail_in))
        return self._lib.inflate(zp, flush)

    def gzip_member(self, src, n_src, *rest):
        self.calls.append((src, n_src))
        return self._lib.gzip_member(src, n_src, *rest)


@pytest.mark.parametrize("lib", ["kssd", "libdeflate", "libz"])
@pytest.mark.parametrize("n_members", [1, 90, 400])
def test_members_read_in_place(lib, n_members, monkeypatch):
    """Each member is read at an address offset into the one input: one
    call a member (and one for each growth), no slice of the input
    longer than the four trailer bytes, and the calls walk the input
    front to back."""
    mod, name = {"kssd": (native, "gzip_member"), "libdeflate": (seqio, "_LIBDEFLATE"),
                 "libz": (seqio, "_LIBZ")}[lib]
    if lib == "kssd" and native.get_lib() is None:
        pytest.skip("native toolchain unavailable")
    if getattr(mod, name) is None:
        pytest.skip(f"{lib} cannot be loaded")
    if lib != "kssd":
        monkeypatch.setattr(seqio, "_KSSD", False)
    if lib == "libz":
        monkeypatch.setattr(seqio, "_LIBDEFLATE", None)
    body = FASTA[: 400 * 500]
    data = _SliceCountingBytes(_members(body, -(-len(body) // n_members)))
    # the helper's wrapper is replaced by the stub's, which calls it
    stub = _CountingLib(SimpleNamespace(gzip_member=native.gzip_member)
                        if lib == "kssd" else getattr(seqio, name))
    monkeypatch.setattr(mod, name, stub.gzip_member if lib == "kssd" else stub)
    out = seqio.inflate(data)
    assert out.tobytes() == body
    assert max(data.slices) <= 4
    base = np.frombuffer(data, np.uint8).ctypes.data
    offsets = [src - base for src, _ in stub.calls]
    assert offsets[0] == 0 and offsets == sorted(offsets)
    assert all(n == len(data) - o for o, (_, n) in zip(offsets, stub.calls))
    assert n_members <= len(stub.calls) <= n_members + 8
    assert len(set(offsets)) == n_members


_ALPHABET = b"ACGTNacgtn>@+\n\r"


@settings(max_examples=300, deadline=None)
@given(st.lists(st.sampled_from(_ALPHABET), max_size=600).map(bytes),
       st.sampled_from([0, 40, 66]))
@example(b">", 0)  # a header with no newline in the input
def test_in_place_scan_matches_python(raw, min_qual):
    if native.get_lib() is None:
        pytest.skip("native toolchain unavailable")
    buf = np.frombuffer(raw, np.uint8).copy()
    got = native.fasta_codes_in_place(buf)
    np.testing.assert_array_equal(got, seqio.fasta_to_codes_py(raw))
    assert got.size == 0 or np.shares_memory(got, buf)
    buf = np.frombuffer(raw, np.uint8).copy()
    got = native.fastq_codes_in_place(buf, min_qual)
    np.testing.assert_array_equal(got, seqio.fastq_to_codes_py(raw, min_qual))
    assert got.size == 0 or np.shares_memory(got, buf)


def test_in_place_scan_needs_a_writable_array():
    if native.get_lib() is None:
        pytest.skip("native toolchain unavailable")
    with pytest.raises(ValueError, match="writable"):
        native.fasta_codes_in_place(np.frombuffer(b"ACGT", np.uint8))
    with pytest.raises(ValueError, match="writable"):
        native.fastq_codes_in_place(np.zeros(8, np.uint16))


def test_read_codes_without_the_c_scanner(monkeypatch, tmp_path):
    """No compiler on the host: the numpy scanners, the same symbols."""
    path = str(tmp_path / "r.fq.gz")
    with open(path, "wb") as f:
        f.write(gzip.compress(FASTQ))
    want = seqio.read_codes(path, True, 50)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    np.testing.assert_array_equal(seqio.read_codes(path, True, 50), want)
    np.testing.assert_array_equal(seqio.read_codes(path), jax_seqio.fasta_to_codes_py(
        jax_seqio.read_bytes(path)))
