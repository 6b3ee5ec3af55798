"""The port's bulk stat readers (``stattab``) against the JAX package's
``formats`` readers, field for field and name for name, on hand-written
stat files (ASCII and UTF-8 names, bytes after a name's NUL, a 256-byte
name with no NUL, an empty table, a file that ends early, invalid
UTF-8); ``native.Names`` of a table against ``Names`` of the list; and
the search and both composite routes reading each stat file once a
call, their outputs byte-equal to the goldens. Exact equality."""

import builtins
import collections
import os
import shutil
import struct

import numpy as np
import pytest
import torch

from conftest import assert_files_equal

from public_kssd_tpu import formats as jax_formats
from public_kssd_tpu_torch import composite, index, native, search, stattab
from public_kssd_tpu_torch.ops import stats as stats_ops

torch.set_num_threads(1)

CPU = torch.device("cpu")
PATHLEN = 256


def _row(name: bytes, tail: bytes = b"") -> bytes:
    """One PATHLEN-byte row: ``name``, then (when it is short) a NUL,
    ``tail`` and NULs."""
    if len(name) == PATHLEN:
        return name
    row = name + b"\0" + tail
    assert len(row) <= PATHLEN
    return row + b"\0" * (PATHLEN - len(row))


def _names(case: str) -> list[bytes]:
    rng = np.random.default_rng(7)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789_./-", np.uint8)
    ascii_rows = [_row(bytes(rng.choice(letters, int(n))))
                  for n in rng.integers(1, PATHLEN, 40)]
    return {
        "ascii": ascii_rows + [_row(b"x" * 255), _row(b"")],
        "utf8": [_row("génome_é.fna".encode()), _row("大肠杆菌.fa.gz".encode()),
                 _row("🧬/ref.fna".encode()), *ascii_rows[:3],
                 _row(("é" * 127).encode())],  # 254 bytes
        "after_nul": [_row(b"ref1.fna", b"\xff\xfe junk"),
                      _row(b"ref2.fna", "é".encode() * 20),
                      _row(b"", b"ignored"), *ascii_rows[:2]],
        "full_row": [b"a" * PATHLEN, ("é" * 128).encode(), *ascii_rows[:2],
                     b"b" * (PATHLEN - 1) + b"\0"],
        "empty": [],
        "invalid": [*ascii_rows[:3], _row(b"bad\xff\xfename"), _row(b"\xc3")],
    }[case]


CASES = ("ascii", "utf8", "after_nul", "full_row", "empty")


def _write_stat(d: str, kind: str, rows: list[bytes], cut: int = 0) -> None:
    """A cofiles.stat or mcofiles.stat of ``rows``, written by hand
    (``_pack_names`` refuses a name of PATHLEN bytes), less its last
    ``cut`` bytes."""
    n = len(rows)
    ctx = np.arange(100, 100 + n, dtype="<u4") * 3
    if kind == "co":
        head = struct.pack("<IB3x4iq", 4242, 1, 20, 6, 1, n, int(ctx.sum()))
        name = jax_formats.CO_DSTAT
    else:
        head = struct.pack("<I4i", 4242, 20, 6, 1, n)
        name = jax_formats.MCO_DSTAT
    raw = head + ctx.tobytes() + b"".join(rows)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, name), "wb") as f:
        f.write(raw[:len(raw) - cut])


def _read_both(d: str, kind: str):
    if kind == "co":
        return jax_formats.read_co_stat(d), stattab.read_co_stat_table(d)
    return jax_formats.read_mco_stat(d), stattab.read_mco_stat_table(d)


def _assert_same_stat(want, got) -> None:
    for f in ("params_id", "kmerlen", "dim_rd_len", "comp_num", "infile_num"):
        assert getattr(got, f) == getattr(want, f), f
    if hasattr(want, "koc"):
        assert (got.koc, got.all_ctx_ct) == (want.koc, want.all_ctx_ct)
    assert got.ctx_ct.dtype == want.ctx_ct.dtype
    np.testing.assert_array_equal(got.ctx_ct, want.ctx_ct)
    names = got.names
    assert isinstance(names, stattab.NameTable)
    assert len(names) == len(want.names)
    assert [names[i] for i in range(len(names))] == want.names
    assert list(names) == want.names
    if want.names:
        assert names[-1] == want.names[-1] and names[np.int64(0)] == want.names[0]
    with pytest.raises(IndexError):
        names[len(names)]
    with pytest.raises(IndexError):
        names[-len(names) - 1]
    lengths = [len(n.encode()) for n in want.names]
    np.testing.assert_array_equal(names.lengths, np.array(lengths, np.int64))
    # the rows are kept as wide as the longest name and its NUL
    assert names.rows.shape == (len(lengths), min(max(lengths, default=0) + 1, PATHLEN))
    np.testing.assert_array_equal(stattab._lengths(names.rows, block=3), names.lengths)


@pytest.mark.parametrize("kind", ["co", "mco"])
@pytest.mark.parametrize("case", CASES)
def test_table_reader_matches_formats(tmp_path, kind, case):
    d = str(tmp_path / case)
    _write_stat(d, kind, _names(case))
    _assert_same_stat(*_read_both(d, kind))


@pytest.mark.parametrize("kind", ["co", "mco"])
@pytest.mark.parametrize("cut", [PATHLEN + 100, 3 * PATHLEN])
def test_table_reader_of_a_short_file(tmp_path, kind, cut):
    """A file that ends inside or before its last rows reads as if padded
    with NULs, as formats reads it."""
    d = str(tmp_path / "short")
    _write_stat(d, kind, _names("utf8"), cut=cut)
    _assert_same_stat(*_read_both(d, kind))


@pytest.mark.parametrize("kind", ["co", "mco"])
def test_invalid_utf8_raises_at_read_as_formats_does(tmp_path, kind):
    d = str(tmp_path / "bad")
    _write_stat(d, kind, _names("invalid"))
    read = {"co": (jax_formats.read_co_stat, stattab.read_co_stat_table),
            "mco": (jax_formats.read_mco_stat, stattab.read_mco_stat_table)}[kind]
    with pytest.raises(UnicodeDecodeError) as want:
        read[0](d)
    with pytest.raises(UnicodeDecodeError) as got:
        read[1](d)
    assert got.value.args == want.value.args


@pytest.mark.parametrize("case", ["ascii", "after_nul"])
def test_ascii_table_decodes_nothing_until_asked(tmp_path, monkeypatch, case):
    """Names of ASCII bytes (whatever follows their NUL) are decoded one
    by one as they are asked for."""
    calls = []
    real = stattab.NameTable._decode
    monkeypatch.setattr(stattab.NameTable, "_decode",
                        lambda self, i: calls.append(i) or real(self, i))
    d = str(tmp_path / "a")
    _write_stat(d, "co", _names(case))
    names = stattab.read_co_stat_table(d).names
    assert calls == []
    assert names[1] == names[1] and calls == [1]  # decoded once, then kept


@pytest.mark.parametrize("case", CASES)
def test_native_names_of_a_table_match_the_list(tmp_path, case):
    d = str(tmp_path / case)
    _write_stat(d, "mco", _names(case))
    want_stat, got_stat = _read_both(d, "mco")
    want, got = native.Names(want_stat.names), native.Names(got_stat.names)
    assert got.longest == want.longest
    assert got.offsets.size == want.offsets.size == len(want_stat.names)

    def at(names, off):
        blob = names.blob.tobytes()
        return blob[off:blob.index(b"\0", off)]

    for i, name in enumerate(want_stat.names):
        assert at(got, got.offsets[i]) == at(want, want.offsets[i]) == name.encode()


@pytest.mark.parametrize("case", ["ascii", "utf8", "after_nul", "full_row"])
def test_dist_rows_buf_same_bytes_from_table_and_list(tmp_path, case):
    assert native.get_lib() is not None
    _write_stat(str(tmp_path / "r"), "mco", _names(case))
    _write_stat(str(tmp_path / "q"), "co", _names("utf8")[:4])
    rw, rg = _read_both(str(tmp_path / "r"), "mco")
    qw, qg = _read_both(str(tmp_path / "q"), "co")
    n_ref, n_qry = rw.infile_num, qw.infile_num
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 90, (n_qry, n_ref)).astype(np.uint32)
    outs = []
    for q, r in ((qw.names, rw.names), (qg.names, rg.names)):
        buf, n = native.dist_rows_buf(
            native.Names(q), qw.ctx_ct, native.Names(r), rw.ctx_ct, counts,
            0, 0, n_ref, None, None, 20, 6, float(n_ref * n_qry), 0, 2, 0, 1.0,
            np.zeros(1 << 16, np.uint8))
        outs.append(bytes(buf[:n]))
    assert outs[0] == outs[1] and outs[0].count(b"\n") == n_qry * n_ref


def _count_opens(monkeypatch) -> collections.Counter:
    """Counts each path ``open`` is given, from now on."""
    opened = collections.Counter()
    real = builtins.open

    def counting(file, *a, **k):
        if isinstance(file, (str, os.PathLike)):
            opened[os.path.realpath(file)] += 1
        return real(file, *a, **k)

    monkeypatch.setattr(builtins, "open", counting)
    return opened


def _stat_opens(opened, *dirs) -> dict:
    return {os.path.join(os.path.basename(d), n): opened[os.path.realpath(
        os.path.join(d, n))] for d in dirs
        for n in (jax_formats.CO_DSTAT, jax_formats.MCO_DSTAT)}


@pytest.fixture(scope="module")
def gold(golden7, tmp_path_factory):
    """The golden reference sketches indexed by the port's stage II
    (``csr``), unindexed (``raw``), the query sketches and samples."""
    root = str(tmp_path_factory.mktemp("stattab_gold"))
    skip = shutil.ignore_patterns("abundance_Vec*", "mco*")
    for d in ("raw", "csr"):
        shutil.copytree(f"{golden7}/ref_co", f"{root}/{d}", ignore=skip)
    for d in ("qry_co", "fq_koc"):
        shutil.copytree(f"{golden7}/{d}", f"{root}/{d}")
    index.run_stage2(f"{root}/csr", f"{root}/csr", 7, dense=False)
    for f in ("distout/distance.out", "composite_report.txt"):
        shutil.copy(f"{golden7}/{f}", f"{root}/{os.path.basename(f)}")
    return root


@pytest.mark.parametrize("printer", ["native", "python"])
def test_search_reads_each_stat_file_once(gold, tmp_path, monkeypatch, printer):
    if printer == "python":
        monkeypatch.setenv("KSSD_TPU_NATIVE_PRINT", "off")
    tables = []
    real = stattab.read_mco_stat_table
    monkeypatch.setattr(stattab, "read_mco_stat_table",
                        lambda d: tables.append(real(d)) or tables[-1])
    written = []
    real_write = stats_ops.write_distance_out
    monkeypatch.setattr(stats_ops, "write_distance_out",
                        lambda *a, **k: written.append(a[4]) or real_write(*a, **k))
    opened = _count_opens(monkeypatch)
    out = search.search(f"{gold}/csr", f"{gold}/qry_co", str(tmp_path / "o"),
                        device=CPU)
    monkeypatch.undo()
    assert_files_equal(f"{gold}/distance.out", out)
    assert _stat_opens(opened, f"{gold}/csr", f"{gold}/qry_co") == {
        "csr/cofiles.stat": 0, "csr/mcofiles.stat": 1,
        "qry_co/cofiles.stat": 1, "qry_co/mcofiles.stat": 0}
    # the print is given the table; the native print decodes none of it
    assert len(written) == 1 and written[0] is tables[0].names
    decoded = sum(n is not None for n in tables[0].names._names)
    assert decoded == (0 if printer == "native" else tables[0].infile_num)


@pytest.mark.parametrize("route", ["raw", "csr"])
def test_composite_reads_each_stat_file_once(gold, monkeypatch, route):
    tables = {}
    real = stattab.read_co_stat_table

    def keep(d):
        tables[os.path.basename(d)] = real(d)
        return tables[os.path.basename(d)]

    monkeypatch.setattr(stattab, "read_co_stat_table", keep)
    opened = _count_opens(monkeypatch)
    got = composite.species_abundance(f"{gold}/{route}", f"{gold}/fq_koc",
                                      device=CPU)
    monkeypatch.undo()
    with open(f"{gold}/composite_report.txt") as f:
        assert got == f.read() and got
    assert _stat_opens(opened, f"{gold}/{route}", f"{gold}/fq_koc") == {
        f"{route}/cofiles.stat": 1, f"{route}/mcofiles.stat": int(route == "csr"),
        "fq_koc/cofiles.stat": 1, "fq_koc/mcofiles.stat": 0}
    # the report decodes the reference names it writes, and no other
    reported = {line.split("\t")[1] for line in got.splitlines()}
    decoded = [n for n in tables[route].names._names if n is not None]
    assert set(decoded) == reported and len(decoded) < len(tables[route].names)
