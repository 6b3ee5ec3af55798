"""The port's gzip inflater (native/kssd_inflate.c, ``seqio.inflate``'s
"kssd" route) held to the gzip module, on the CPU: every stream it
accepts inflates to the bytes of ``gzip.decompress`` / ``zlib``, and
every stream the gzip module refuses it refuses too. The streams:
zlib's output at every level and strategy, several members, hand-built
headers and blocks at deflate's edges, one hand-built invalid stream for
each rejection, and seeded mutations and truncations of valid members.
A small C program also runs the decoder under AddressSanitizer and
UndefinedBehaviorSanitizer over a corpus and its mutations."""

import gzip
import os
import shutil
import struct
import subprocess
import zlib

import numpy as np
import pytest
from hypothesis import example, given, settings, strategies as st

from public_kssd_tpu_torch import native, seqio

SRC = os.path.join(os.path.dirname(native.__file__), "kssd_inflate.c")
STRATEGIES = [zlib.Z_DEFAULT_STRATEGY, zlib.Z_FILTERED, zlib.Z_HUFFMAN_ONLY,
              zlib.Z_RLE, zlib.Z_FIXED]


@pytest.fixture(autouse=True)
def kssd_route(monkeypatch):
    """The port's inflater, with gzip.decompress's rule where the members
    end, so that the gzip module is the whole oracle."""
    if native.get_lib() is None:
        pytest.skip("native toolchain unavailable")
    monkeypatch.setattr(seqio, "_LIBDEFLATE", None)
    assert seqio.inflate_route() == "kssd"


def _member(data: bytes, cap: int | None = None):
    """native.gzip_member on ``data`` into a new array of ``cap`` bytes
    (default: as large as deflate's ratio allows): (code, read, output)."""
    src = np.frombuffer(data, np.uint8)
    out = np.empty(max(1032 * len(data) + 64 if cap is None else cap, 1), np.uint8)
    rc, n_in, n_out = native.gzip_member(src.ctypes.data, src.size, out.ctypes.data, out.size)
    return rc, n_in, out[:n_out].tobytes()


def _gzip_outcome(data: bytes):
    try:
        return gzip.decompress(data)
    except Exception:  # the gzip module's refusal is the outcome compared
        return None


def _route_outcome(data: bytes):
    out = seqio.inflate(data)
    return None if out is None else out.tobytes()


def _body(kind: str, n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    if kind == "dna":  # 80-column FASTA, as the benchmark's genomes
        seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].tobytes()
        return b">g\n" + b"\n".join(seq[i : i + 80] for i in range(0, n, 80)) + b"\n"
    if kind == "text":
        words = [b"kssd", b"sketch", b"genome", b"distance", b"the", b"of", b"\n"]
        return b" ".join(words[i] for i in rng.integers(0, len(words), n // 5))[:n]
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    # long runs of one byte, some past deflate's longest match
    runs = [bytes([int(rng.integers(0, 256))]) * int(rng.integers(1, 700)) for _ in range(n // 300 + 1)]
    return b"".join(runs)[:n]


def _compress(body: bytes, level: int, strategy: int) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, 31, 9, strategy)
    return c.compress(body) + c.flush()


def _header(flags: int, extra: bytes = b"", name: bytes = b"", comment: bytes = b"") -> bytes:
    """A gzip header with FEXTRA (4), FNAME (8), FCOMMENT (16) and FHCRC
    (2) as ``flags`` sets them; its CRC-16 is the low half of the
    header's CRC-32, as RFC 1952 has it."""
    h = b"\x1f\x8b\x08" + bytes([flags]) + struct.pack("<I", 123456789) + b"\x00\x03"
    if flags & 4:
        h += struct.pack("<H", len(extra)) + extra
    if flags & 8:
        h += name + b"\x00"
    if flags & 16:
        h += comment + b"\x00"
    if flags & 2:
        h += struct.pack("<H", zlib.crc32(h) & 0xFFFF)
    return h


def _wrap(deflate: bytes, body: bytes, header: bytes = b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\xff") -> bytes:
    return header + deflate + struct.pack("<II", zlib.crc32(body), len(body) & 0xFFFFFFFF)


def _raw(body: bytes, level: int = 6, strategy: int = zlib.Z_DEFAULT_STRATEGY) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, -15, 9, strategy)
    return c.compress(body) + c.flush()


# ---- zlib's output ----------------------------------------------------------


@pytest.mark.parametrize("kind", ["dna", "text", "random", "runs"])
@pytest.mark.parametrize("level", range(10))
def test_every_level_and_strategy(kind, level):
    body = _body(kind, 60_000, level)
    for strategy in STRATEGIES:
        data = _compress(body, level, strategy)
        assert _member(data) == (native.INFLATE_OK, len(data), body)
        assert _member(data, cap=len(body)) == (native.INFLATE_OK, len(data), body)
        if body:
            assert _member(data, cap=len(body) - 1)[0] == native.INFLATE_NO_SPACE
        assert _route_outcome(data) == body == gzip.decompress(data)


@settings(max_examples=120, deadline=None, derandomize=True, database=None)
@given(st.lists(st.tuples(st.sampled_from(["dna", "text", "random", "runs"]),
                          st.integers(0, 40_000), st.integers(0, 9),
                          st.sampled_from(STRATEGIES), st.integers(0, 2**31)),
                min_size=1, max_size=5),
       st.integers(0, 255), st.binary(max_size=40), st.binary(max_size=30).map(lambda b: b.replace(b"\0", b"")))
@example([("dna", 0, 6, zlib.Z_DEFAULT_STRATEGY, 0)] * 3, 0, b"", b"")  # empty members
@example([("dna", 300_000, 6, zlib.Z_DEFAULT_STRATEGY, 5)], 30, b"x" * 40, b"name.fna")
def test_members_match_the_gzip_module(members, flags, extra, name):
    """1-5 members of any body, level and strategy, the first with the
    header fields ``flags`` sets (FTEXT, FHCRC, FEXTRA, FNAME, FCOMMENT,
    and the reserved bits, which the gzip module ignores)."""
    parts, bodies = [], []
    for i, (kind, n, level, strategy, seed) in enumerate(members):
        body = _body(kind, n, seed)
        if i == 0:
            parts.append(_wrap(_raw(body, level, strategy), body,
                               _header(flags, extra, name, name[::-1])))
        else:
            parts.append(_compress(body, level, strategy))
        bodies.append(body)
    data = b"".join(parts)
    want = b"".join(bodies)
    assert gzip.decompress(data) == want
    assert _route_outcome(data) == want
    assert _member(data, cap=len(bodies[0])) == (native.INFLATE_OK, len(parts[0]), bodies[0])


def test_crc32_matches_zlib():
    rng = np.random.default_rng(3)
    buf = rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
    for n in (0, 1, 7, 8, 15, 16, 17, 63, 64, 65, 79, 80, 127, 128, 129, 1000, 4099):
        for off in range(9):
            assert native.crc32(buf[off : off + n]) == zlib.crc32(buf[off : off + n]), (n, off)


# ---- hand-built streams ----------------------------------------------------

_LEN_BASE = [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43, 51, 59,
             67, 83, 99, 115, 131, 163, 195, 227, 258]
_LEN_BITS = [0] * 8 + [1] * 4 + [2] * 4 + [3] * 4 + [4] * 4 + [5] * 4 + [0]
_DIST_BASE = [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257, 385, 513,
              769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577]
_DIST_BITS = [max(0, (i - 2) // 2) for i in range(30)]
_PRE_ORDER = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15]
_FIXED_LIT = [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8


class _Bits:
    """A deflate bit stream: fields LSB first, Huffman codes MSB first."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, nbits: int) -> None:
        self.acc |= value << self.n
        self.n += nbits
        while self.n >= 8:
            self.out.append(self.acc & 0xFF)
            self.acc >>= 8
            self.n -= 8

    def code(self, code: int, length: int) -> None:
        self.put(int(format(code, f"0{length}b")[::-1], 2), length)

    def align(self) -> None:
        if self.n:
            self.put(0, 8 - self.n)

    def raw(self, data: bytes) -> None:
        assert self.n == 0
        self.out += data

    def bytes(self) -> bytes:
        return bytes(self.out) + (bytes([self.acc]) if self.n else b"")


def _canonical(lens: list[int]) -> dict[int, tuple[int, int]]:
    """RFC 1951's canonical codes: symbol -> (code, length)."""
    count = [lens.count(n) for n in range(16)]
    count[0] = 0
    code, nxt = 0, [0] * 16
    for n in range(1, 16):
        code = (code + count[n - 1]) << 1
        nxt[n] = code
    out = {}
    for s, n in enumerate(lens):
        if n:
            out[s] = (nxt[n], n)
            nxt[n] += 1
    return out


def _symbols(w: _Bits, items, lit: dict, dist: dict) -> None:
    """("lit", byte), ("match", length, distance[, length symbol]),
    ("sym", litlen symbol), ("dsym", distance symbol) or ("eob",)."""
    for item in items:
        if item[0] == "lit":
            w.code(*lit[item[1]])
        elif item[0] == "eob":
            w.code(*lit[256])
        elif item[0] == "sym":
            w.code(*lit[item[1]])
        elif item[0] == "dsym":
            w.code(*dist[item[1]])
        else:
            length, distance = item[1], item[2]
            ls = item[3] if len(item) > 3 else max(i for i, b in enumerate(_LEN_BASE) if b <= length)
            w.code(*lit[257 + ls])
            w.put(length - _LEN_BASE[ls], _LEN_BITS[ls])
            ds = max(i for i, b in enumerate(_DIST_BASE) if b <= distance)
            w.code(*dist[ds])
            w.put(distance - _DIST_BASE[ds], _DIST_BITS[ds])


def _fixed(w: _Bits, items, final: int = 1) -> None:
    w.put(final, 1)
    w.put(1, 2)
    _symbols(w, items, _canonical(_FIXED_LIT), _canonical([5] * 32))


def _stored(w: _Bits, payload: bytes, final: int = 0, nlen: int | None = None) -> None:
    w.put(final, 1)
    w.put(0, 2)
    w.align()
    w.put(len(payload), 16)
    w.put((len(payload) ^ 0xFFFF) if nlen is None else nlen, 16)
    w.raw(payload)


def _lit_lens() -> list[int]:
    """A complete litlen code over symbols 0-285: 226 codes of 8 bits and
    60 of 9 (226/256 + 60/512 = 1)."""
    return [8] * 226 + [9] * 60


def _pre(symbol: int | None = None) -> list[int]:
    """A complete precode: symbols 0-15 of four bits, or 0-14 and
    ``symbol`` (a repeat code)."""
    lens = [4] * 16 + [0, 0, 0]
    if symbol is not None:
        lens[15], lens[symbol] = 0, 4
    return lens


def _dynamic(w: _Bits, lit_lens, dist_lens, items, *, pre_lens=None, cl=None,
             nlit=None, ndist=None, final: int = 1) -> None:
    """A dynamic block: the code lengths sent with ``pre_lens`` (default:
    symbols 0-15 of 4 bits), as the precode symbols ``cl`` (default: one
    a length, no repeats), then ``items``."""
    nlit = len(lit_lens) if nlit is None else nlit
    ndist = len(dist_lens) if ndist is None else ndist
    pre_lens = _pre() if pre_lens is None else pre_lens
    w.put(final, 1)
    w.put(2, 2)
    w.put(nlit - 257, 5)
    w.put(ndist - 1, 5)
    w.put(19 - 4, 4)
    for s in _PRE_ORDER:
        w.put(pre_lens[s], 3)
    pre = _canonical(pre_lens)
    for item in ([(n,) for n in lit_lens + dist_lens] if cl is None else cl):
        w.code(*pre[item[0]])
        if len(item) > 1:
            w.put(*item[1])
    _symbols(w, items, _canonical(lit_lens + [0] * (288 - len(lit_lens))),
             _canonical(dist_lens + [0] * (32 - len(dist_lens))))


def _stream(build, body: bytes) -> bytes:
    w = _Bits()
    build(w)
    return _wrap(w.bytes(), body)


def _overlap_body() -> bytes:
    out = bytearray(b"\x01\x02\x03")
    for length, dist in ((100, 3), (9, 2), (30, 7), (3, 1)):
        for _ in range(length):
            out.append(out[-dist])
    return bytes(out)


_WINDOW = np.random.default_rng(7).integers(0, 256, 32768, dtype=np.uint8).tobytes()

# name -> (block writer, the output zlib gives)
VALID = {
    # a match from 32,768 bytes back, the window's far end, of 258 bytes
    "distance_32768_length_258": (
        lambda w: (_stored(w, _WINDOW), _fixed(w, [("match", 258, 32768), ("eob",)])),
        _WINDOW + _WINDOW[:258]),
    # length symbol 284 with its five extra bits all set: 258, as zlib reads it
    "length_284_plus_31": (
        lambda w: _fixed(w, [("lit", 65), ("match", 258, 1, 27), ("eob",)]), b"A" * 259),
    "overlapping_distances": (
        lambda w: _fixed(w, [("lit", 1), ("lit", 2), ("lit", 3), ("match", 100, 3),
                             ("match", 9, 2), ("match", 30, 7), ("match", 3, 1), ("eob",)]),
        _overlap_body()),
    "empty_stored_final": (lambda w: _stored(w, b"", final=1), b""),
    "fixed_eob_only": (lambda w: _fixed(w, [("eob",)]), b""),
    # zlib's exceptions to complete codes: one distance code of one bit,
    # no distance code at all, and a litlen code of the end of block alone
    "one_distance_code": (
        lambda w: _dynamic(w, _lit_lens(), [1], [("lit", 7), ("match", 5, 1), ("eob",)]),
        b"\x07" * 6),
    "no_distance_code": (
        lambda w: _dynamic(w, _lit_lens(), [0], [("lit", 7), ("lit", 9), ("eob",)]), b"\x07\x09"),
    "end_of_block_alone": (
        lambda w: (_dynamic(w, [0] * 256 + [1], [0], [("eob",)], final=0),
                   _fixed(w, [("lit", 5), ("eob",)])), b"\x05"),
    # a run of zero lengths (code 17) from the litlen lengths into the
    # distance lengths
    "repeat_across_the_codes": (
        lambda w: _dynamic(w, [8] * 228 + [9] * 56 + [0, 0], [0, 1, 1],
                           [("lit", 3), ("lit", 3), ("match", 4, 2), ("eob",)],
                           pre_lens=_pre(17),
                           cl=[(8,)] * 228 + [(9,)] * 56 + [(17, (0, 3)), (1,), (1,)]),
        b"\x03" * 6),
}

@pytest.mark.parametrize("case", sorted(VALID))
def test_hand_built_valid_streams(case):
    build, body = VALID[case]
    data = _stream(build, body)
    assert gzip.decompress(data) == body
    assert _member(data) == (native.INFLATE_OK, len(data), body)
    assert _route_outcome(data) == body


def _pre_over(w):  # precode: three codes of one bit
    _dynamic(w, _lit_lens(), [1, 1], [("eob",)], pre_lens=[1, 1, 1] + [0] * 16,
             cl=[(0,)] * 3)


def _pre_incomplete(w):  # precode: symbols 0-14 of four bits, one short
    _dynamic(w, _lit_lens(), [1, 1], [("eob",)], pre_lens=[4] * 15 + [0] * 4,
             cl=[(8,)] * 3)


# name -> (block writer, the C code expected)
INVALID = {
    "block_type_3": (lambda w: (w.put(1, 1), w.put(3, 2), w.put(0, 16)), native.INFLATE_BAD_DATA),
    "stored_nlen_mismatch": (lambda w: _stored(w, b"abc", final=1, nlen=0x1234),
                             native.INFLATE_BAD_DATA),
    "litlen_symbol_286": (lambda w: _fixed(w, [("lit", 1), ("sym", 286), ("eob",)]),
                          native.INFLATE_BAD_DATA),
    "litlen_symbol_287": (lambda w: _fixed(w, [("sym", 287), ("eob",)]), native.INFLATE_BAD_DATA),
    "distance_symbol_30": (lambda w: _fixed(w, [("lit", 1), ("sym", 257), ("dsym", 30), ("eob",)]),
                           native.INFLATE_BAD_DATA),
    "distance_symbol_31": (lambda w: _fixed(w, [("lit", 1), ("sym", 257), ("dsym", 31), ("eob",)]),
                           native.INFLATE_BAD_DATA),
    "distance_past_the_start": (lambda w: _fixed(w, [("lit", 1), ("lit", 2), ("match", 3, 3),
                                                     ("eob",)]), native.INFLATE_BAD_DATA),
    "distance_past_the_start_after_a_stored_block": (
        lambda w: (_stored(w, _WINDOW[:1000]), _fixed(w, [("match", 258, 1001), ("eob",)])),
        native.INFLATE_BAD_DATA),
    "too_many_litlen_codes": (lambda w: _dynamic(w, _lit_lens() + [0], [1, 1], [("eob",)], nlit=287),
                              native.INFLATE_BAD_DATA),
    "too_many_distance_codes": (lambda w: _dynamic(w, _lit_lens(), [5] * 31, [("eob",)], ndist=31),
                                native.INFLATE_BAD_DATA),
    "precode_over_subscribed": (_pre_over, native.INFLATE_BAD_DATA),
    "precode_incomplete": (_pre_incomplete, native.INFLATE_BAD_DATA),
    "litlen_over_subscribed": (lambda w: _dynamic(w, [8] * 227 + [9] * 59, [1, 1], [("eob",)]),
                               native.INFLATE_BAD_DATA),
    "litlen_incomplete": (lambda w: _dynamic(w, [8] * 225 + [9] * 61, [1, 1], [("eob",)]),
                          native.INFLATE_BAD_DATA),
    "litlen_incomplete_two_codes": (lambda w: _dynamic(w, [0] * 65 + [2] + [0] * 190 + [2], [1, 1],
                                                       [("lit", 65), ("eob",)]),
                                    native.INFLATE_BAD_DATA),
    "distance_over_subscribed": (lambda w: _dynamic(w, _lit_lens(), [1, 1, 1], [("eob",)]),
                                 native.INFLATE_BAD_DATA),
    "distance_incomplete": (lambda w: _dynamic(w, _lit_lens(), [2, 2, 2], [("eob",)]),
                            native.INFLATE_BAD_DATA),
    # the codeword an incomplete code leaves unused, or a code with none
    "unused_distance_codeword": (lambda w: (_dynamic(w, _lit_lens(), [1], [("lit", 7)], final=0),
                                            w.code(*_canonical(_lit_lens())[257]), w.put(1, 1)),
                                 native.INFLATE_BAD_DATA),
    "match_without_a_distance_code": (lambda w: (_dynamic(w, _lit_lens(), [0], [("lit", 7)]),
                                                 w.code(*_canonical(_lit_lens())[257]), w.put(0, 1)),
                                      native.INFLATE_BAD_DATA),
    "repeat_with_nothing_before": (lambda w: _dynamic(w, _lit_lens(), [1, 1], [("eob",)],
                                                      pre_lens=_pre(16),
                                                      cl=[(16, (0, 2))]), native.INFLATE_BAD_DATA),
    "repeat_past_the_lengths": (lambda w: _dynamic(w, _lit_lens(), [1, 1], [("eob",)],
                                                   pre_lens=_pre(18),
                                                   cl=[(8,)] * 285 + [(18, (0, 7))]),
                                native.INFLATE_BAD_DATA),
    "no_end_of_block_code": (lambda w: _dynamic(w, [8] * 228 + [9] * 28 + [0] + [9] * 28, [1, 1],
                                                [("lit", 1)]), native.INFLATE_BAD_DATA),
}


@pytest.mark.parametrize("case", sorted(INVALID))
def test_hand_built_invalid_streams(case):
    build, code = INVALID[case]
    data = _stream(build, b"\x01\x02" * 200)
    with pytest.raises(Exception):
        gzip.decompress(data)
    assert _member(data)[0] == code
    assert seqio.inflate(data) is None


def test_check_and_header_rejections():
    body = _body("dna", 5000, 1)
    good = gzip.compress(body)
    bad_crc = good[:-8] + struct.pack("<I", zlib.crc32(body) ^ 1) + good[-4:]
    bad_isize = good[:-4] + struct.pack("<I", len(body) + 1)
    bad_method = good[:2] + b"\x07" + good[3:]
    bad_magic = b"\x1f\x8c" + good[2:]
    for data, code in ((bad_crc, native.INFLATE_BAD_CHECK), (bad_isize, native.INFLATE_BAD_CHECK),
                       (bad_method, native.INFLATE_BAD_DATA), (bad_magic, native.INFLATE_BAD_DATA)):
        with pytest.raises(Exception):
            gzip.decompress(data)
        assert _member(data)[0] == code
        assert seqio.inflate(data) is None
    # unterminated FNAME, a short FEXTRA, no trailer: truncations
    for data in (_header(8, name=b"name")[:-1], _header(4, b"x" * 9)[:-3], good[:-3], good[:5]):
        assert _member(data)[0] == native.INFLATE_TRUNCATED
        assert _gzip_outcome(data) is None


def _valid_corpus() -> list[tuple[bytes, bytes]]:
    """(member, body) pairs for the mutation runs: every strategy, hand
    headers, stored blocks, the hand-built edges."""
    out = []
    for i, kind in enumerate(["dna", "text", "random", "runs"]):
        for strategy in STRATEGIES:
            body = _body(kind, 3000 + 500 * i, i)
            out.append((_compress(body, [6, 9, 1, 0][i], strategy), body))
    body = _body("dna", 4000, 9)
    out.append((_wrap(_raw(body), body, _header(30, b"ex", b"nm", b"cm")), body))
    for case in ("distance_32768_length_258", "one_distance_code", "repeat_across_the_codes"):
        build, body = VALID[case]
        out.append((_stream(build, body), body))
    return out


def test_mutations_and_truncations_agree_with_the_gzip_module():
    """Seeded single-byte mutations and truncations of valid members:
    the route's bytes are the gzip module's, or None where it raises."""
    rng = np.random.default_rng(15)
    n_raise = n_same = 0
    for data, body in _valid_corpus():
        assert _route_outcome(data) == body
        cases = []
        for k in range(40):  # a quarter in the header and first block's
            pos = int(rng.integers(0, len(data) if k % 4 else min(12, len(data))))
            cases.append(data[:pos] + bytes([int(rng.integers(0, 256))]) + data[pos + 1 :])
        for cut in rng.integers(1, len(data), 8):
            cases.append(data[: int(cut)])
            assert _member(data[: int(cut)])[0] == native.INFLATE_TRUNCATED
        for case in cases:
            want = _gzip_outcome(case)
            got = _route_outcome(case)
            assert got == want, (len(case), want is None, got is None)
            n_raise += want is None
            n_same += want is not None
    assert n_raise > 500 and n_same > 50  # both outcomes were exercised


# ---- the sanitizer run ------------------------------------------------------

RUNNER = r"""
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

int kssd_gzip_inflate(const uint8_t *src, size_t n_src, uint8_t *dst,
                      size_t n_dst, size_t *n_read, size_t *n_written);

static uint64_t rng = 0x9E3779B97F4A7C15ull;
static uint64_t next(void) { rng ^= rng << 13; rng ^= rng >> 7; rng ^= rng << 17; return rng; }

/* each call on buffers of exactly n_src and n_dst bytes, so a read or
 * write past either is a sanitizer error */
static int run(const uint8_t *in, size_t n_in, size_t n_dst, uint8_t **out, size_t *n_out)
{
    uint8_t *src = malloc(n_in ? n_in : 1), *dst = malloc(n_dst ? n_dst : 1);
    size_t r, w;
    memcpy(src, in, n_in);
    int rc = kssd_gzip_inflate(src, n_in, dst, n_dst, &r, &w);
    if (rc < 0 || rc > 4 || (rc == 0 && (r > n_in || w > n_dst))) {
        fprintf(stderr, "bad result %d\n", rc);
        exit(2);
    }
    *out = dst;
    *n_out = w;
    free(src);
    return rc;
}

int main(int argc, char **argv)
{
    FILE *f = fopen(argv[1], "rb");
    int mutations = atoi(argv[2]);
    uint32_t hdr[2];
    long n_cases = 0;
    while (fread(hdr, 4, 2, f) == 2) {
        uint8_t *in = malloc(hdr[0] + 1), *want = malloc(hdr[1] + 1), *out;
        size_t n_out;
        if (fread(in, 1, hdr[0], f) != hdr[0] || fread(want, 1, hdr[1], f) != hdr[1])
            return 3;
        if (run(in, hdr[0], hdr[1], &out, &n_out) != 0 || n_out != hdr[1]
            || memcmp(out, want, n_out)) {
            fprintf(stderr, "valid member refused or wrong\n");
            return 4;
        }
        free(out);
        if (hdr[1] && run(in, hdr[0], hdr[1] - 1, &out, &n_out) != 3)
            return 5;
        free(out);
        for (int m = 0; m < mutations; m++, n_cases++) {
            uint8_t *c = malloc(hdr[0]);
            memcpy(c, in, hdr[0]);
            c[next() % hdr[0]] = (uint8_t)next();
            if (next() & 1)
                c[next() % hdr[0]] ^= (uint8_t)(1u << (next() & 7));
            run(c, hdr[0], hdr[1] + next() % 600, &out, &n_out);
            free(out);
            size_t cut = next() % hdr[0];
            if (run(in, cut, hdr[1] + 300, &out, &n_out) != 4) {
                fprintf(stderr, "a truncation at %zu not reported\n", cut);
                return 6;
            }
            free(out);
            free(c);
        }
        free(in);
        free(want);
    }
    printf("%ld\n", n_cases);
    return 0;
}
"""

SAN_FLAGS = ["-fsanitize=address,undefined", "-fno-sanitize-recover=all", "-g", "-O1"]


def test_decoder_under_the_sanitizers(tmp_path):
    cc = shutil.which("cc")
    probe = tmp_path / "probe.c"
    probe.write_text("int main(void) { return 0; }\n")
    if cc is None or subprocess.run([cc, *SAN_FLAGS, str(probe), "-o", str(tmp_path / "probe")],
                                    capture_output=True).returncode != 0:
        pytest.skip("cc cannot link -fsanitize=address,undefined on this host")
    (tmp_path / "runner.c").write_text(RUNNER)
    with open(tmp_path / "corpus.bin", "wb") as f:
        for data, body in _valid_corpus():
            f.write(struct.pack("<II", len(data), len(body)) + data + body)
    # as built, and its generic build (no BMI2 decode loop, no PCLMULQDQ)
    for extra in ([], ["-DKSSD_INFLATE_GENERIC"]):
        exe = tmp_path / f"runner{len(extra)}"
        subprocess.run([cc, *SAN_FLAGS, *extra, str(tmp_path / "runner.c"), SRC, "-o", str(exe)],
                       check=True, capture_output=True)
        r = subprocess.run([str(exe), str(tmp_path / "corpus.bin"), "120"], capture_output=True,
                           text=True, timeout=300,
                           env=dict(os.environ, ASAN_OPTIONS="detect_leaks=0",
                                    UBSAN_OPTIONS="print_stacktrace=1"))
        assert r.returncode == 0, (extra, r.stderr[-4000:])
        assert int(r.stdout) >= 2000
