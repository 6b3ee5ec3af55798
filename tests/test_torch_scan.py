"""The port's FASTA scanner (native/kssd_scan.c, ``kssd_fasta_scan``)
held to the reference scanner of the same helper library
(``kssd_fasta_to_codes``, kssd_host.c), on the CPU: the same symbols and
the same length on every input, in place and into another array, on
each block loop this host runs (``kssd_fasta_scan_at``: 8-byte SWAR,
SSE2, AVX2) and on the one ``kssd_fasta_scan`` picks. The inputs: long
base runs between junk bytes (hypothesis), 60- and 80-column FASTA with
"\\n" and "\\r\\n" line ends, lowercase bases and N runs, headers across
block edges and one with no newline, every length to 130 at every start
offset to 31, and the in-place case where a block store would overwrite
input not yet read. A few cases also go through the JAX package's
``fasta_to_codes``; only those import it, so the rest runs with
``--noconftest`` where there is no jax. A small C program runs every
loop under AddressSanitizer and UndefinedBehaviorSanitizer with each
input at the very end of its allocation."""

import ctypes
import os
import shutil
import struct
import subprocess

import numpy as np
import pytest
from hypothesis import example, given, settings, strategies as st

from public_kssd_tpu_torch import native

SRC_DIR = os.path.dirname(native.__file__)
NO_LOOP = ctypes.c_size_t(-1).value  # kssd_fasta_scan_at: no loop of that width
# 0: kssd_fasta_scan, the loop it picks; else kssd_fasta_scan_at's width
WIDTHS = [0, 8, 16, 32]
BASES = np.frombuffer(b"ACGTacgt", np.uint8)


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    if lib is None:
        pytest.skip("native toolchain unavailable")
    return lib


def _scanner(lib, width):
    """The scanner of ``width`` as f(data, n, out) -> count; skips the
    test where this host has no such loop."""
    if width == 0:
        return lib.kssd_fasta_scan
    probe = np.zeros(1, np.uint8)
    if lib.kssd_fasta_scan_at(probe, 0, probe, width) == NO_LOOP:
        pytest.skip(f"no {width}-byte loop in this build or CPU")
    return lambda data, n, out: lib.kssd_fasta_scan_at(data, n, out, width)


def _reference(lib, raw: bytes) -> bytes:
    data = np.frombuffer(raw, np.uint8)
    out = np.empty(max(data.size, 1), np.uint8)
    return out[: lib.kssd_fasta_to_codes(data, data.size, out)].tobytes()


def _check(lib, scan, raw: bytes, offset: int = 0) -> bytes:
    """``scan`` on ``raw`` into another array and in place, the input
    starting ``offset`` bytes into its array: both equal to the
    reference's symbols. Returns them."""
    want = _reference(lib, raw)
    n = len(raw)
    src = np.zeros(n + 64, np.uint8)
    data = src[offset : offset + n]
    data[:] = np.frombuffer(raw, np.uint8)
    out = np.full(n + 64, 0xEE, np.uint8)[offset : offset + max(n, 1)]
    got = scan(data, n, out)
    assert out[:got].tobytes() == want, ("out of place", offset, raw[:120])
    assert data.tobytes() == raw  # the input is left as it was
    got = scan(data, n, data)
    assert data[:got].tobytes() == want, ("in place", offset, raw[:120])
    return want


def _bases(rng, n: int, letters=BASES) -> bytes:
    return rng.choice(letters, n).astype(np.uint8).tobytes()


def _fasta(rng, cols: int, eol: bytes, records: int = 3, bp: int = 3000) -> bytes:
    """``records`` records of ``bp`` bases in ``cols``-column lines:
    mixed case, runs of N and n, headers of 0-70 bytes."""
    out = []
    for _ in range(records):
        seq = bytearray(_bases(rng, bp, np.frombuffer(b"ACGT", np.uint8)))
        for _ in range(rng.integers(0, 4)):  # a lowercase stretch
            a, k = int(rng.integers(0, bp)), int(rng.integers(1, 300))
            seq[a : a + k] = seq[a : a + k].lower()
        for _ in range(rng.integers(0, 4)):  # an N run
            a, k = int(rng.integers(0, bp)), int(rng.integers(1, 120))
            seq[a : a + k] = (b"N" if rng.random() < 0.7 else b"n") * len(seq[a : a + k])
        out.append(b">" + bytes(rng.integers(32, 127, rng.integers(0, 70)).astype(np.uint8)) + eol)
        out.extend(bytes(seq[j : j + cols]) + eol for j in range(0, bp, cols))
    return b"".join(out)


# ---- the cases --------------------------------------------------------------

JUNK = [b"\n", b"\r", b"\r\n", b"\n\n", b"N", b"n", b"NNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNN",
        b">", b">h\n", b">" + b"x" * 40 + b"\n", b"-", b" ", b"\x00", b"\xff", b"@", b"U"]


@st.composite
def base_runs(draw):
    """Runs of 0-200 bases (mixed case) between junk bytes."""
    seed = draw(st.integers(0, 2**32 - 1))
    shape = draw(st.lists(st.tuples(st.integers(0, 200), st.sampled_from(JUNK)), max_size=12))
    rng = np.random.default_rng(seed)
    return b"".join(_bases(rng, n) + junk for n, junk in shape) + _bases(
        rng, draw(st.integers(0, 40)))


@pytest.mark.parametrize("width", WIDTHS)
@settings(max_examples=150, deadline=None)
@given(raw=base_runs(), offset=st.integers(0, 31))
@example(raw=b">", offset=0)  # a header with no newline
@example(raw=b"A" * 64 + b"\n" + b"C" * 64, offset=0)
def test_long_base_runs_match_the_reference(lib, width, raw, offset):
    _check(lib, _scanner(lib, width), raw, offset)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("cols", [60, 80])
@pytest.mark.parametrize("eol", [b"\n", b"\r\n"], ids=["lf", "crlf"])
def test_fasta_lines_match_the_reference(lib, width, cols, eol):
    rng = np.random.default_rng(cols + len(eol))
    raw = _fasta(rng, cols, eol)
    want = _check(lib, _scanner(lib, width), raw)
    assert len(want) > 3 * 2900  # the bases came through


def _texts(rng) -> list[bytes]:
    """Inputs whose every prefix is scanned: bases in 80-column lines
    behind a header, one line of bases, and a mixture."""
    return [
        b">r\n" + b"\n".join(_bases(rng, 80) for _ in range(2)),
        _bases(rng, 140),
        b"ACGTN\r\nacgt>hd\nGGGGGGGGGGGGGGGGGGGGGGGGGGGGGGGGGGG--TTTTTTTTTTTTTTTTT\nNNNNNN"
        + _bases(rng, 33) + b"\n>\n" + _bases(rng, 40),
    ]


@pytest.mark.parametrize("width", WIDTHS)
def test_every_length_at_every_offset(lib, width):
    scan = _scanner(lib, width)
    for raw in _texts(np.random.default_rng(7)):
        for n in range(131):
            for offset in range(32):
                _check(lib, scan, raw[:n], offset)


@pytest.mark.parametrize("width", WIDTHS)
def test_headers_across_block_edges(lib, width):
    """A header at every position of the first 70 bytes, of lengths
    around one, two and four blocks of 16, then bases; and the same
    header with no newline at the end of the input."""
    scan = _scanner(lib, width)
    rng = np.random.default_rng(11)
    before, after = _bases(rng, 70), _bases(rng, 90)
    for at in range(70):
        for length in (0, 1, 14, 15, 16, 17, 31, 32, 33, 63, 64, 65):
            head = b">" + b"h" * length
            _check(lib, scan, before[:at] + head + b"\n" + after)
            _check(lib, scan, before[:at] + head + b"\r\n" + after)
            assert _check(lib, scan, before[:at] + head) == _reference(lib, before[:at])


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("lead", ["newlines", "header"])
def test_in_place_stores_never_overwrite_unread_input(lib, width, lead):
    """In place, the write position trails the read position by the
    bytes skipped so far (``lag``). After a run of ``r`` bases a store of
    a whole block at the write position would cover the byte that ended
    the run and the bases after it whenever lag < W - r: the symbols
    would then differ from the reference's."""
    scan = _scanner(lib, width)
    rng = np.random.default_rng(13)
    tail = _bases(rng, 70) + b"\n" + _bases(rng, 50)
    for lag in range(2, 41):
        skipped = b"\n" * lag if lead == "newlines" else b">" + b"x" * (lag - 2) + b"\n"
        for r in range(41):
            for stop in (b"N", b">h\n", b"\n", b"-\n"):
                _check(lib, scan, skipped + _bases(rng, r) + stop + tail)


@pytest.mark.parametrize("width", WIDTHS)
def test_every_byte_value(lib, width):
    """Each of the 256 byte values alone, between bases and inside a
    header."""
    scan = _scanner(lib, width)
    run = b"ACGTACGTACGTACGTACGTACGTACGTACGTACGTAC"
    for b in range(256):
        c = bytes([b])
        _check(lib, scan, c)
        _check(lib, scan, run + c + run)
        _check(lib, scan, run + c * 40 + run)
        _check(lib, scan, b">" + c + b"\n" + run + c + b">" + c * 33 + b"\n" + run)


def test_wrappers_run_the_vector_scanner(lib):
    """native.fasta_to_codes and native.fasta_codes_in_place give the
    reference's symbols; the in-place one a view of its array."""
    raw = _fasta(np.random.default_rng(3), 80, b"\n")
    want = _reference(lib, raw)
    assert native.fasta_to_codes(raw).tobytes() == want
    buf = np.frombuffer(raw, np.uint8).copy()
    got = native.fasta_codes_in_place(buf)
    assert got.tobytes() == want and np.shares_memory(got, buf)


# ---- the JAX package's scanner ---------------------------------------------


@pytest.mark.parametrize("case", ["fasta80", "fasta60_crlf", "runs", "junk"])
def test_jax_package_gives_the_same_symbols(lib, case):
    jax_seqio = pytest.importorskip("public_kssd_tpu.seqio")
    rng = np.random.default_rng(17)
    raw = {
        "fasta80": _fasta(rng, 80, b"\n", records=4),
        "fasta60_crlf": _fasta(rng, 60, b"\r\n", records=4),
        "runs": b"".join(_bases(rng, int(n)) + JUNK[int(j)] for n, j in zip(
            rng.integers(0, 200, 300), rng.integers(0, len(JUNK), 300))),
        "junk": bytes(rng.integers(0, 256, 5000).astype(np.uint8)) + b"\n",
    }[case]
    want = jax_seqio.fasta_to_codes(raw)
    np.testing.assert_array_equal(native.fasta_to_codes(raw), want)
    buf = np.frombuffer(raw, np.uint8).copy()
    np.testing.assert_array_equal(native.fasta_codes_in_place(buf), want)


# ---- the sanitizer run ------------------------------------------------------

RUNNER = r"""
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

size_t kssd_fasta_to_codes(const uint8_t *data, size_t n, uint8_t *out);
size_t kssd_fasta_scan(const uint8_t *data, size_t n, uint8_t *out);
size_t kssd_fasta_scan_at(const uint8_t *data, size_t n, uint8_t *out, int width);

/* n bytes at the very end of an allocation of at least a page: a read or
 * write past them is a sanitizer error */
static uint8_t *at_end(const uint8_t *src, size_t n, uint8_t **block)
{
    size_t cap = n > 4096 ? n : 4096;
    *block = malloc(cap);
    memcpy(*block + cap - n, src, n);
    return *block + cap - n;
}

static size_t run(int width, const uint8_t *in, size_t n, uint8_t *out)
{
    return width ? kssd_fasta_scan_at(in, n, out, width) : kssd_fasta_scan(in, n, out);
}

int main(int argc, char **argv)
{
    FILE *f = fopen(argv[1], "rb");
    uint32_t n;
    long checks = 0;
    int loops = 0;
    static const int widths[] = {0, 8, 16, 32};
    while (fread(&n, 4, 1, f) == 1) {
        uint8_t *raw = malloc(n + 1), *want = malloc(n + 1), *b1, *b2;
        if (fread(raw, 1, n, f) != n)
            return 3;
        size_t m = kssd_fasta_to_codes(raw, n, want);
        for (int w = 0; w < 4; w++) {
            uint8_t *in = at_end(raw, n, &b1), *out = at_end(raw, n, &b2);
            size_t got = run(widths[w], in, n, out);
            if (got == (size_t)-1) {
                free(b1);
                free(b2);
                continue;
            }
            loops |= 1 << w;
            if (got != m || memcmp(out, want, m)) {
                fprintf(stderr, "width %d out of place: %zu symbols, want %zu\n", widths[w], got, m);
                return 4;
            }
            got = run(widths[w], in, n, in);
            if (got != m || memcmp(in, want, m)) {
                fprintf(stderr, "width %d in place: %zu symbols, want %zu\n", widths[w], got, m);
                return 5;
            }
            checks += 2;
            free(b1);
            free(b2);
        }
        free(raw);
        free(want);
    }
    printf("%ld %d\n", checks, loops);
    return 0;
}
"""

SAN_FLAGS = ["-fsanitize=address,undefined", "-fno-sanitize-recover=all", "-g", "-O1"]


def _corpus() -> list[bytes]:
    rng = np.random.default_rng(19)
    cases = [t[:n] for t in _texts(rng) for n in range(131)]
    cases += [_fasta(rng, cols, eol, records=2, bp=700)
              for cols in (60, 80) for eol in (b"\n", b"\r\n")]
    for _ in range(600):
        k = int(rng.integers(0, 12))
        cases.append(b"".join(_bases(rng, int(n)) + JUNK[int(j)] for n, j in zip(
            rng.integers(0, 200, k), rng.integers(0, len(JUNK), k))))
    for lag in range(2, 41, 3):
        for r in range(0, 41, 3):
            cases.append(b"\n" * lag + _bases(rng, r) + b"N" + _bases(rng, 40))
    cases += [bytes([b]) for b in range(256)] + [b">", b">\n", b"\r", b"A", b""]
    return cases


@pytest.mark.parametrize("build", ["as_built", "generic"])
def test_scanners_under_the_sanitizers(lib, tmp_path, build):
    cc = shutil.which("cc")
    probe = tmp_path / "probe.c"
    probe.write_text("int main(void) { return 0; }\n")
    if cc is None or subprocess.run([cc, *SAN_FLAGS, str(probe), "-o", str(tmp_path / "probe")],
                                    capture_output=True).returncode != 0:
        pytest.skip("cc cannot link -fsanitize=address,undefined on this host")
    (tmp_path / "runner.c").write_text(RUNNER)
    cases = _corpus()
    with open(tmp_path / "corpus.bin", "wb") as f:
        for raw in cases:
            f.write(struct.pack("<I", len(raw)) + raw)
    # the generic build's kssd_fasta_scan runs the portable loop; both
    # builds hold every loop this CPU runs through kssd_fasta_scan_at
    extra = ["-DKSSD_SCAN_GENERIC"] if build == "generic" else []
    exe = tmp_path / "runner"
    subprocess.run([cc, *SAN_FLAGS, *extra, str(tmp_path / "runner.c"),
                    os.path.join(SRC_DIR, "kssd_scan.c"), os.path.join(SRC_DIR, "kssd_host.c"),
                    "-o", str(exe), "-lm"], check=True, capture_output=True)
    r = subprocess.run([str(exe), str(tmp_path / "corpus.bin")], capture_output=True, text=True,
                       timeout=300, env=dict(os.environ, ASAN_OPTIONS="detect_leaks=0",
                                             UBSAN_OPTIONS="print_stacktrace=1"))
    assert r.returncode == 0, r.stderr[-4000:]
    checks, loops = map(int, r.stdout.split())
    widths = [w for w in WIDTHS if w == 0 or lib.kssd_fasta_scan_at(
        np.zeros(1, np.uint8), 0, np.zeros(1, np.uint8), w) != NO_LOOP]
    assert loops == sum(1 << WIDTHS.index(w) for w in widths)
    assert checks == 2 * len(widths) * len(cases)
