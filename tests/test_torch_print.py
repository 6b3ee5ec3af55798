"""The port's threaded distance.out writer (native/kssd_print.c, blocks
formatted on many threads and written in query order) against the port's
Python formatter (KSSD_TPU_NATIVE_PRINT=off) and the JAX package's
writer, byte for byte, at every thread count; its float field writers
against libc's snprintf and Python's formatting; and ``kssd_torch dist
-p`` against ``kssd_tpu dist``."""

import contextlib
import ctypes
import itertools
import math
import os
import struct
import sys
from fractions import Fraction

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from public_kssd_tpu import cli as jax_cli
from public_kssd_tpu.ops import stats as jax_stats
from public_kssd_tpu_torch import cli, native
from public_kssd_tpu_torch.ops import stats as stats_ops

torch.set_num_threads(1)

THREADS = (1, 2, 3, 20)  # 20: more threads than queries


@pytest.fixture(autouse=True)
def _native_lib():
    if native.get_lib() is None:
        pytest.skip("no C compiler: the native writer cannot be built")


def _matrix(seed=0, n_qry=7, n_ref=32):
    """Counts and sizes with the corners tests/test_native.py plants: a
    self-pair (x = y = xny: -nan columns), a zero share, a tiny ref; and
    a query sharing nothing, so that -D drops all of its lines."""
    rng = np.random.default_rng(seed)
    ref_sizes = rng.integers(2, 2000, n_ref).astype(np.uint32)
    qry_sizes = rng.integers(2, 2000, n_qry).astype(np.uint32)
    counts = np.minimum(
        rng.integers(0, 1500, (n_qry, n_ref)),
        np.minimum(ref_sizes[None, :], qry_sizes[:, None]) - 1,
    ).astype(np.uint32)
    ref_sizes[0] = qry_sizes[0] = counts[0, 0] = 1277  # self-pair
    counts[0, 1] = 0  # no sharing
    ref_sizes[2] = 1
    counts[:, 2] = np.minimum(counts[:, 2], 1)  # tiny ref
    counts[3] = 0  # a query sharing nothing
    # names of varying length, UTF-8 beyond ASCII included
    rnames = [f"ref_{i}" + "x" * (i % 5) for i in range(n_ref)]
    rnames[-1] = "réf_dernière"
    qnames = [f"q{i}" + "/long/path" * (i % 3) for i in range(n_qry)]
    return counts, ref_sizes, qry_sizes, rnames, qnames


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _write(monkeypatch, module, path, args, opts, mode="auto", **kw):
    monkeypatch.setenv("KSSD_TPU_NATIVE_PRINT", mode)
    module.write_distance_out(path, *args, 16, 4, opts, **kw)
    return _read(path)


def _tie_matrix():
    """Counts whose fields sit on the formatter's edges: m = odd/128, an
    exact tie at the sixth decimal (Jaccard: x + y - xny = 128 in rows
    0-2; containment: min(x, y) = 128 in rows 3-4), small m whose lower
    CI is negative (its distance -nan), and a tiny ref."""
    rng = np.random.default_rng(7)
    n_qry, n_ref = 6, 24
    ref_sizes = np.empty(n_ref, np.uint32)
    ref_sizes[:12] = 29 + 6 * np.arange(12)  # odd, 29..95
    ref_sizes[12:22] = 128
    ref_sizes[22] = 1
    ref_sizes[23] = 5000
    qry_sizes = np.array([100, 100, 100, 1000, 1000, 7000], np.uint32)
    counts = np.zeros((n_qry, n_ref), np.uint32)
    counts[:3, :12] = ref_sizes[:12] - 28  # x + 100 - xny = 128, xny odd
    counts[:3, 12:22] = rng.integers(0, 101, (3, 10))
    counts[3:5, :12] = rng.integers(0, 29, (2, 12))
    counts[3:5, 12:22] = 2 * rng.integers(0, 64, (2, 10)) + 1  # odd/128
    counts[5, :22] = np.minimum(rng.integers(0, 1000, 22), ref_sizes[:22])
    counts[:, 22] = [0, 1, 0, 1, 1, 0]
    counts[:, 23] = [3, 0, 9, 1, 5, 7]
    rnames = [f"t{i}" for i in range(n_ref)]
    qnames = [f"tq{i}" for i in range(n_qry)]
    return counts, ref_sizes, qry_sizes, rnames, qnames


GRID = list(itertools.product(
    (stats_ops.Metric.JACCARD, stats_ops.Metric.CONTAINMENT),
    (stats_ops.Fields.DIST, stats_ops.Fields.QV, stats_ops.Fields.CI),
    (False, True), (1.0, 0.05), (0, 5),
))


@pytest.mark.parametrize("metric, fields, corr, maxd, topn", GRID)
def test_threaded_writer_matches_python_and_jax(tmp_path, monkeypatch, metric,
                                                fields, corr, maxd, topn):
    """The -M/-O/-N/-D/--correction grid of tests/test_native.py, at 1,
    2, 3 and 20 threads: 7 queries, so no block size divides them, rows
    cut into ref ranges (no -N) or grouped whole (-N)."""
    python = _check_grid(tmp_path, monkeypatch, _matrix(), metric, fields, corr,
                         maxd, topn)
    if maxd < 1 and not corr:  # every line of the query sharing nothing is dropped
        assert b"\nq3\t" not in python


@pytest.mark.parametrize("metric, fields, corr, maxd, topn", GRID)
def test_threaded_writer_on_ties_matches_python_and_jax(tmp_path, monkeypatch,
                                                        metric, fields, corr,
                                                        maxd, topn):
    """The same grid on _tie_matrix: exact ties, negative CIs and a
    field printed by snprintf."""
    python = _check_grid(tmp_path, monkeypatch, _tie_matrix(), metric, fields,
                         corr, maxd, topn)
    if maxd == 1 and not topn:
        if metric == stats_ops.Metric.JACCARD and not corr:
            assert b"\t1-0|29|100\t0.007812\t" in python  # 1/128: half to even
        if metric == stats_ops.Metric.CONTAINMENT and not corr:
            assert b"|128|1000\t0." in python


@pytest.mark.parametrize("metric, fields", itertools.product(
    (stats_ops.Metric.JACCARD, stats_ops.Metric.CONTAINMENT),
    (stats_ops.Fields.DIST, stats_ops.Fields.QV, stats_ops.Fields.CI)))
def test_snprintf_fields_in_a_line_match_jax(tmp_path, monkeypatch, metric, fields):
    """A ref of 3e9 codes beside a query of 6e8, --correction: m below
    -4.5e15, printed by snprintf inside the line, the same bytes as the
    JAX package's native writer (kssd_host.c) at 1 and 3 threads. (Its
    Python formatter differs here: rs past 2^63 and x + y past 2^32 do
    not wrap as the C casts do.)"""
    from public_kssd_tpu import native as jax_native

    assert jax_native.get_lib() is not None
    counts = np.array([[7, 3, 0], [1, 5, 1]], np.uint32)
    ref_sizes = np.array([3_000_000_000, 1000, 1], np.uint32)
    qry_sizes = np.array([600_000_000, 2000], np.uint32)
    args = (counts, ref_sizes, qry_sizes, ["big", "r1", "r2"], ["q0", "q1"])
    opts = stats_ops.OutputOptions(metric=metric, fields=fields, correction=True)
    jopts = jax_stats.OutputOptions(metric=jax_stats.Metric(int(metric)),
                                    fields=jax_stats.Fields(int(fields)),
                                    correction=True)
    jax = _write(monkeypatch, jax_stats, str(tmp_path / "jax"), args, jopts)
    big = float(jax.split(b"\n")[1].split(b"\t")[3])
    assert big < -2**53 / 1e6 and native.format_field(big, "%.6f")[1]  # snprintf
    for t in (1, 3):
        assert _write(monkeypatch, stats_ops, str(tmp_path / f"t{t}"), args, opts,
                      threads=t) == jax


def _check_grid(tmp_path, monkeypatch, args, metric, fields, corr, maxd, topn):
    """The native writer at every thread count against the port's Python
    formatter and the JAX package's writer; returns their text."""
    opts = stats_ops.OutputOptions(metric=metric, fields=fields, correction=corr,
                                   max_dist=maxd, top_n=topn)
    jopts = jax_stats.OutputOptions(metric=jax_stats.Metric(int(metric)),
                                    fields=jax_stats.Fields(int(fields)),
                                    correction=corr, max_dist=maxd, top_n=topn)
    python = _write(monkeypatch, stats_ops, str(tmp_path / "py"), args, opts, "off")
    jax = _write(monkeypatch, jax_stats, str(tmp_path / "jax"), args, jopts)
    assert python == jax
    assert python.count(b"\n") > 1
    for t in THREADS:
        got = _write(monkeypatch, stats_ops, str(tmp_path / f"t{t}"), args, opts,
                     threads=t)
        assert got == python, f"{t} threads"
    return python


FORMATS = tuple(native.FIELD_KINDS)
_LIBC = ctypes.CDLL(None)


def _snprintf(x: float, fmt: str) -> str:
    buf = ctypes.create_string_buffer(512)
    n = _LIBC.snprintf(buf, ctypes.c_size_t(512), fmt.encode(), ctypes.c_double(x))
    return buf.raw[:n].decode()


def _check_field(x: float, fmt: str) -> bool:
    """The writer's text of x is libc's, and for a finite x Python's
    (which prints no sign on a nan); returns whether it took snprintf."""
    got, slow = native.format_field(x, fmt)
    assert got == _snprintf(x, fmt), repr(x)
    if math.isfinite(x):
        assert got == format(x, fmt[1:]), repr(x)
    return slow


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("x", native.FIELD_CORNERS, ids=repr)
def test_field_writer_corners(x, fmt):
    _check_field(x, fmt)


def _bits_to_double(b: int) -> float:
    return struct.unpack("<d", struct.pack("<Q", b))[0]


@pytest.mark.parametrize("fmt", FORMATS)
@settings(max_examples=2000, deadline=None, database=None, derandomize=True,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(x=st.floats() | st.floats(-2, 2) | st.floats(1e-300, 1e10)
       | st.integers(0, 2**64 - 1).map(_bits_to_double))
def test_field_writer_drawn_doubles(fmt, x):
    _check_field(x, fmt)


@pytest.mark.parametrize("fmt", FORMATS)
def test_field_writer_seeded_sample(fmt):
    """200,000 seeded doubles of every kind (native.field_values) against
    snprintf, in C."""
    values = native.field_values(200_000, seed=12)
    bad, _ = native.check_fields(values, fmt)
    assert bad == -1, f"{values[bad]!r}: {native.format_field(values[bad], fmt)[0]!r}"


@pytest.mark.parametrize("fmt", FORMATS)
def test_ordinary_values_take_no_snprintf(fmt):
    """Values in (1e-16, 1e7), the range of every finite field of a
    count's line, are written by the exact paths alone."""
    rng = np.random.default_rng(5)
    x = np.concatenate([10.0 ** rng.uniform(-16, 7, 100_000),
                        rng.uniform(-2, 2, 100_000),
                        rng.integers(0, 2**17, 10_000) / 128])
    x[::3] *= -1
    assert native.check_fields(x, fmt) == (-1, 0)
    assert not _check_field(1.0000001e-16, fmt) and not _check_field(9999999.0, fmt)


def test_pow10_table_within_its_bound():
    """The formatter's double-double 10^k, k in [0, 308], within 2^-96 of
    10^k relative (the bound its deferral to snprintf assumes); exact up
    to 10^22."""
    for k in range(309):
        hi, lo = native.pow10_dd(k)
        exact = Fraction(10) ** k
        assert abs(Fraction(hi) + Fraction(lo) - exact) <= exact / 2**96, k
        assert abs(lo) <= math.ulp(hi) / 2, k
        if k <= 22:
            assert (hi, lo) == (10.0**k, 0.0)
    with pytest.raises(ValueError):
        native.pow10_dd(309)


@pytest.mark.parametrize("topn", [0, 2])
def test_whole_row_blocks_with_a_remainder(tmp_path, monkeypatch, topn):
    """3 refs, 49 queries: several whole rows a block, the last block
    shorter."""
    args = _matrix(seed=3, n_qry=49, n_ref=3)
    opts = stats_ops.OutputOptions(top_n=topn)
    python = _write(monkeypatch, stats_ops, str(tmp_path / "py"), args, opts, "off")
    assert python.count(b"\n") - 1 == 147 if not topn else python.count(b"\n") > 49
    blocks = stats_ops.print_blocks(49, topn or 3, 3, 100, split=not topn)
    assert blocks[0][1] - blocks[0][0] > 1
    assert 0 < blocks[-1][1] - blocks[-1][0] < blocks[0][1] - blocks[0][0]
    for t in (1, 3, 7, 64):
        got = _write(monkeypatch, stats_ops, str(tmp_path / f"t{t}"), args, opts,
                     threads=t)
        assert got == python, f"{t} threads"


@pytest.mark.parametrize("n_qry, row_items, threads, line_bytes, split", [
    (7, 32, 3, 100, True), (7, 32, 1, 100, True), (50, 3, 3, 100, True),
    (5, 10, 2, 100, False), (0, 10, 4, 100, True), (4, 0, 2, 100, True),
    (1, 1, 1, 100, True), (20, 1000, 4, stats_ops.PRINT_BUFFER_BYTES // 64, True),
])
def test_print_blocks_cover_every_line_once_in_order(n_qry, row_items, threads,
                                                      line_bytes, split):
    blocks = stats_ops.print_blocks(n_qry, row_items, threads, line_bytes, split)
    items = [(q, r) for q0, q1, r0, r1 in blocks
             for q in range(q0, q1) for r in range(r0, r1)]
    assert items == [(q, r) for q in range(n_qry) for r in range(row_items)]
    in_flight = 2 * threads * line_bytes * max(
        (q1 - q0) * (r1 - r0) for q0, q1, r0, r1 in blocks) if blocks else 0
    if split:  # rows cut: the blocks in flight keep to the budget
        assert in_flight <= stats_ops.PRINT_BUFFER_BYTES
    if n_qry * row_items >= 8 * stats_ops.BLOCKS_PER_THREAD * threads and split:
        assert len(blocks) >= stats_ops.BLOCKS_PER_THREAD * threads // 2


def test_block_formatter_grows_a_small_buffer():
    """A buffer too small for the block's text is never written past;
    the binding calls again with the size the formatter asked for."""
    counts, ref_sizes, qry_sizes, rnames, qnames = _matrix()
    q, r = native.Names(qnames), native.Names(rnames)
    call = dict(qnames=q, qry_sizes=qry_sizes, rnames=r, ref_sizes=ref_sizes,
                rows=counts[1:4], q0=1, r0=0, r1=32, rid_sel=None, sel_off=None,
                kmerlen=16, dim_rd_len=4, cmprsn_num=224.0, metric=0, pfield=2,
                correction=1, dthreshold=1.0)
    big, n = native.dist_rows_buf(**call, buf=np.zeros(1 << 20, np.uint8))
    guard = np.full(64, 7, np.uint8)
    grown, m = native.dist_rows_buf(**call, buf=guard[:40])
    assert grown.base is not guard and grown.size > 40 and m == n > 40
    assert bytes(grown[:m]) == bytes(big[:n])
    assert bytes(guard[:39]) == bytes(big[:39]) and guard[39] == 0  # NUL at cap
    assert (guard[40:] == 7).all()
    assert bytes(big[:n]).count(b"\n") == 3 * 32
    with pytest.raises(ValueError):
        native.dist_rows_buf(**{**call, "r1": 33}, buf=big)
    with pytest.raises(ValueError):
        native.dist_rows_buf(**{**call, "rid_sel": np.array([0, 32]),
                                "sel_off": np.array([0, 1, 1, 2])}, buf=big)


def test_memmap_counts_print_the_same(tmp_path, monkeypatch):
    counts, *rest = _matrix()
    mm = np.memmap(str(tmp_path / "skf"), dtype="<u4", mode="w+", shape=counts.shape)
    mm[:] = counts
    mm.flush()
    opts = stats_ops.OutputOptions(top_n=4)
    want = _write(monkeypatch, stats_ops, str(tmp_path / "a"), (counts, *rest), opts)
    assert _write(monkeypatch, stats_ops, str(tmp_path / "b"), (mm, *rest), opts,
                  threads=3) == want


def test_many_threads_short_switch_interval(tmp_path, monkeypatch):
    """More threads than cores, the interpreter switching threads every
    microsecond: 600 blocks still land in query order."""
    args = _matrix(seed=5, n_qry=40, n_ref=500)
    opts = stats_ops.OutputOptions()
    want = _write(monkeypatch, stats_ops, str(tmp_path / "one"), args, opts,
                  threads=1)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = _write(monkeypatch, stats_ops, str(tmp_path / "many"), args, opts,
                     threads=64)
    finally:
        sys.setswitchinterval(old)
    assert got == want and got.count(b"\n") == 1 + 40 * 500


def test_print_threads():
    assert stats_ops.print_threads(0) == len(os.sched_getaffinity(0))
    assert stats_ops.print_threads(3) == 3
    with pytest.raises(ValueError):
        stats_ops.print_threads(-1)


@contextlib.contextmanager
def _cd(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


@pytest.fixture(scope="module")
def indexed(golden7):
    """The golden reference sketches indexed by each CLI, and kssd_tpu
    dist -r <its index> qry_co."""
    with _cd(golden7):
        assert jax_cli.main(["dist", "-o", "print_jref", "--no-dense-index",
                             "ref_co"]) == 0
        assert jax_cli.main(["dist", "-r", "print_jref", "-o", "print_jax",
                             "qry_co"]) == 0
        assert cli.main(["dist", "-o", "print_tref", "--no-dense-index",
                         "--device", "cpu", "ref_co"]) == 0
        return _read("print_jax/distance.out")


@pytest.mark.parametrize("flags", [["-p", "1"], ["-p", "3"], [], ["-m", "1e-5", "-p", "2"]])
def test_cli_threads_match_jax(golden7, indexed, flags):
    """kssd_torch dist -p 1, -p 3, the default (every usable CPU), and
    the -m route (a disk-backed count matrix): the same bytes as
    kssd_tpu dist and the reference's golden."""
    out = "print_torch_" + "_".join(f.strip("-") for f in flags)
    with _cd(golden7):
        assert cli.main(["dist", "-r", "print_tref", "-o", out, *flags,
                         "--device", "cpu", "qry_co"]) == 0
        got = _read(f"{out}/distance.out")
        assert got == _read("distout/distance.out")
    assert got == indexed


def test_cli_rejects_negative_threads(golden7):
    with _cd(golden7), pytest.raises(SystemExit, match="-p"):
        cli.main(["dist", "-r", "print_tref", "-o", "print_neg", "-p", "-1",
                  "--device", "cpu", "qry_co"])
