"""The port's composite query table and hit statistics on a torch device
(``composite._query_table_device``, ``composite._hits_to_stats_torch``)
against the JAX package's host versions (``_query_table``,
``_hits_to_stats``), on CPU tensors, where the same torch calls run as on
a card: exact equality, tensor for array. Then whole reports of the
device routes (CSR, raw codes, a mesh of four slots) against the JAX
package's host oracle, ``-b`` files included, with the host versions
refused; and the statistics' memory budget."""

import os

import numpy as np
import pytest
import torch

from conftest import assert_files_equal
from test_composite_scale import _mk_db

from public_kssd_tpu import composite as jax_composite
from public_kssd_tpu_torch import composite, formats, index, parallel
from public_kssd_tpu_torch.parallel import sharded_composite

torch.set_num_threads(1)

CPU = torch.device("cpu")


# ------------------------------------------------------------ query table

def _combco(case):
    """(codes uint32, index uint64, abundances uint16, n_qry) of one
    component's query sketches."""
    rng = np.random.default_rng(31)
    if case == "empty component":
        return (np.zeros(0, np.uint32), np.zeros(4, np.uint64),
                np.zeros(0, np.uint16), 3)
    if case == "codes at and above 2^31":
        edge = np.array([0, 1, (1 << 31) - 1, 1 << 31, (1 << 31) + 1,
                         (1 << 32) - 2, (1 << 32) - 1], np.uint32)
        qs = [rng.permutation(np.concatenate(
            [edge, rng.integers(1 << 31, 1 << 32, 40, dtype=np.uint64)
             .astype(np.uint32)])) for _ in range(3)]
    elif case == "duplicate (code, query) pairs":
        # each query carries some codes twice or three times, with other
        # abundances: the first occurrence in file order is kept
        qs = []
        for _ in range(4):
            c = rng.integers(0, 1 << 12, 60, dtype=np.uint64).astype(np.uint32)
            qs.append(np.concatenate([c, c[::3], c[::7]]))
    elif case == "empty samples":
        qs = [np.zeros(0, np.uint32),
              rng.integers(0, 1 << 32, 50, dtype=np.uint64).astype(np.uint32),
              np.zeros(0, np.uint32), np.zeros(0, np.uint32),
              rng.integers(0, 1 << 32, 30, dtype=np.uint64).astype(np.uint32),
              np.zeros(0, np.uint32)]
    else:  # seeded random sketches over a small space: shared codes
        qs = [rng.integers(0, 1 << 10, int(rng.integers(100, 400)),
                           dtype=np.uint64).astype(np.uint32) for _ in range(7)]
    qi = np.zeros(len(qs) + 1, np.uint64)
    np.cumsum([q.size for q in qs], out=qi[1:])
    qc = np.concatenate(qs).astype(np.uint32)
    qa = rng.integers(0, 1 << 16, qc.size).astype(np.uint16)
    qa[::5] = 0xFFFF
    return qc, qi, qa, len(qs)


@pytest.mark.parametrize("case", [
    "random sketches", "codes at and above 2^31",
    "duplicate (code, query) pairs", "empty samples", "empty component",
])
def test_query_table_device_matches_jax(case):
    """The table's entries, in their order, with their abundances: the
    unpadded prefix of the JAX package's _query_table; the directory is
    query_directory of that table."""
    qc, qi, qa, n_qry = _combco(case)
    sq_p, sqid_p, sab_p, n = jax_composite._query_table(qc, qi, qa, n_qry)
    sq, sqid, sab, (directory, shift) = composite._query_table_device(
        qc, qi, qa, n_qry, CPU)
    for got in (sq, sqid, sab):
        assert got.dtype == torch.int32 and got.device == CPU
    np.testing.assert_array_equal(sq.numpy().view(np.uint32), sq_p[:n])
    np.testing.assert_array_equal(sqid.numpy(), sqid_p[:n])
    np.testing.assert_array_equal(sab.numpy(), sab_p[:n].astype(np.int32))
    want_dir, want_shift = composite.query_directory(
        torch.from_numpy(sq_p[:n].view(np.int32)), int(sq_p[n - 1]) if n else 0)
    assert shift == want_shift and torch.equal(directory, want_dir)
    if case == "duplicate (code, query) pairs":
        assert n < qc.size
    if case == "codes at and above 2^31":
        assert (sq_p[:n] >= np.uint32(1 << 31)).any()
        assert (sq_p[:n] < np.uint32(1 << 31)).any()
    if case == "empty component":
        assert n == 0 and sq.numel() == 0


# --------------------------------------------------------- hit statistics

def _keys(seed, n_ref, n_qry, shift):
    """Packed hit keys ``qid << shift | rid << 16 | abundance`` in no
    order, as the join emits them, with (query, ref) segments of 1, 2, 3,
    50, 100, 101, 150 and 300 hits, refs and queries without hits, the
    abundance 0xFFFF and the largest rid (n_ref - 1)."""
    rng = np.random.default_rng(seed)
    keys = []
    sizes = [1, 2, 3, 50, 100, 101, 150, 300]
    for q in range(n_qry):
        if q == 1:
            continue  # a query without hits
        refs = rng.choice(n_ref - 1, len(sizes) + 20, replace=False)
        refs[0] = n_ref - 1
        for i, r in enumerate(refs):
            k = sizes[i] if i < len(sizes) else int(rng.integers(1, 8))
            ab = rng.integers(0, 1 << 16, k)
            ab[rng.random(k) < 0.2] = 0xFFFF
            ab[rng.random(k) < 0.1] = 0
            keys.append((np.int64(q) << shift) | (np.int64(r) << 16) | ab)
    keys = np.concatenate(keys).astype(np.int64)
    return keys[rng.permutation(keys.size)]


def _split(keys, n_parts, rng):
    cuts = np.sort(rng.integers(0, keys.size + 1, n_parts - 1))
    return np.split(keys, cuts)


@pytest.mark.parametrize("n_ref", [1000, 1023, 1024])
@pytest.mark.parametrize("parts", [1, 2, 5])
def test_hits_to_stats_torch_matches_jax(n_ref, parts):
    """Every query's six aggregates equal the JAX package's host
    statistics of the same keys, split over 1, 2 or 5 parts (empty parts
    among them); the largest rid sits at the top of the rid field when
    n_ref is 1024."""
    n_qry = 5
    shift = 16 + n_ref.bit_length()
    keys = _keys(n_ref, n_ref, n_qry, shift)
    chunks = _split(keys, parts, np.random.default_rng(parts))
    if parts == 5:
        chunks.insert(2, keys[:0])
    want = jax_composite._hits_to_stats(chunks, n_qry, n_ref, shift)
    got = composite._hits_to_stats_torch(
        [torch.from_numpy(c.copy()) for c in chunks], n_qry, n_ref, shift)
    assert len(got) == len(want) == n_qry
    for qn, (g, w) in enumerate(zip(got, want)):
        for name, a, b in zip(("kmer_num", "total", "median", "max", "lastsum",
                               "lastn"), g, w):
            assert a.dtype == np.int64 and a.shape == (n_ref,), name
            np.testing.assert_array_equal(a, b, err_msg=f"query {qn} {name}")
    assert not got[1][0].any() and (got[1][5] == 1).all()  # no hits
    counts = got[0][0]
    assert counts[n_ref - 1] == 1 and {1, 2, 3, 100, 101, 300} <= set(counts)
    big = counts > 100
    assert (got[0][5][big] > 1).all()  # the percentile window spans hits


@pytest.mark.parametrize("parts", [[], [np.zeros(0, np.int64)],
                                   [np.zeros(0, np.int64)] * 3],
                         ids=["no parts", "one empty part", "three empty parts"])
def test_hits_to_stats_torch_without_keys(parts):
    """No keys at all: every ref of every query gets (0, 0, 0, 0, 0, 1),
    as the JAX package's statistics give."""
    n_qry, n_ref, shift = 3, 20, 21
    want = jax_composite._hits_to_stats(parts, n_qry, n_ref, shift)
    got = composite._hits_to_stats_torch(
        [torch.from_numpy(p) for p in parts], n_qry, n_ref, shift)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == np.int64
            np.testing.assert_array_equal(a, b)


def test_hits_to_stats_torch_moves_parts_to_its_device(monkeypatch):
    """Parts are joined on the device named (the first part's by
    default), and the aggregates alone are fetched."""
    n_ref, n_qry = 300, 4
    shift = 16 + n_ref.bit_length()
    keys = _keys(3, n_ref, n_qry, shift)
    seen = []
    real = composite._segments_torch

    def spy(k, s):
        seen.append(k.device)
        out = real(k, s)
        assert out.shape[0] == 8 and out.shape[1] < k.numel()
        return out

    want = jax_composite._hits_to_stats([keys], n_qry, n_ref, shift)
    monkeypatch.setattr(composite, "_segments_torch", spy)
    got = composite._hits_to_stats_torch(
        [torch.from_numpy(keys)], n_qry, n_ref, shift, CPU)
    assert seen == [CPU]
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def _spy_ranges(monkeypatch):
    """Record every ``_stats_ranges`` call: (parts, qid_shift, ranges)."""
    seen = []
    real = composite._stats_ranges

    def spy(parts, n, n_qry, n_ref, qid_shift, device):
        out = real(parts, n, n_qry, n_ref, qid_shift, device)
        seen.append((parts, qid_shift, out))
        return out

    monkeypatch.setattr(composite, "_stats_ranges", spy)
    return seen


def _free_for(cap, parts):
    """The free bytes that leave room for ``cap`` keys a range."""
    return cap * composite.STATS_BYTES_PER_KEY + composite._slice_bytes(parts)


@pytest.mark.parametrize("free", [0, 64 * 1000 - 1])
def test_stats_budget_raises(monkeypatch, free):
    """Keys whose sort and reduction would pass the device's free memory
    are split by key range: 1000 keys of one query on 1000 references,
    one byte short of their budget, are cut by reference into two ranges
    whose statistics equal one pass's. With no free bytes a single
    (query, reference) run cannot fit: MemoryError. At the budget the
    keys take one range. The host has no budget."""
    assert composite._free_bytes(CPU) is None
    keys = torch.arange(1000, dtype=torch.int64) << 16
    want = jax_composite._hits_to_stats([keys.numpy()], 1, 1000, 26)
    seen = _spy_ranges(monkeypatch)
    monkeypatch.setattr(composite, "_free_bytes", lambda device: free)
    if free == 0:
        with pytest.raises(MemoryError, match="query 0 on reference 0 .* free "
                                              "memory on cpu, or run composite "
                                              "with --device cpu"):
            composite._hits_to_stats_torch([keys[:400], keys[400:]], 1, 1000, 26)
    else:
        got = composite._hits_to_stats_torch([keys[:400], keys[400:]], 1, 1000, 26)
        for a, b in zip(got[0], want[0], strict=True):
            np.testing.assert_array_equal(a, b)
        ranges = seen[-1][2]
        assert len(ranges) == 2 and sum(k for *_, k in ranges) == 1000
    monkeypatch.setattr(composite, "_free_bytes",
                        lambda device: composite.STATS_BYTES_PER_KEY * 1000)
    got = composite._hits_to_stats_torch([keys], 1, 1000, 26)
    assert (got[0][0] == 1).all() and seen[-1][2] == [(None, None, 1000)]


@pytest.mark.parametrize("cap", ["all", "half", "largest query",
                                 "within one query", "largest run"])
@pytest.mark.parametrize("slice_keys", [7, 1 << 22])
def test_hits_to_stats_torch_split_matches_jax(monkeypatch, cap, slice_keys):
    """Under a budget of ``cap`` keys a range, read 7 keys or a whole
    part at a time, the statistics of keys split over five parts equal
    the JAX package's host statistics; the ranges ascend, hold every key
    once and none holds more than ``cap``."""
    n_ref, n_qry = 1000, 5
    shift = 16 + n_ref.bit_length()
    keys = _keys(9, n_ref, n_qry, shift)
    chunks = _split(keys, 5, np.random.default_rng(9))
    parts = [torch.from_numpy(c.copy()) for c in chunks]
    per_q = np.bincount(keys >> shift, minlength=n_qry)
    runs = np.unique(keys >> 16, return_counts=True)[1]
    k = {"all": keys.size, "half": keys.size // 2, "largest query": per_q.max(),
         "within one query": per_q.max() - 1, "largest run": runs.max()}[cap]
    monkeypatch.setattr(composite, "STATS_SLICE", slice_keys)
    monkeypatch.setattr(composite, "_free_bytes",
                        lambda device: _free_for(int(k), parts))
    seen = _spy_ranges(monkeypatch)
    want = jax_composite._hits_to_stats(chunks, n_qry, n_ref, shift)
    got = composite._hits_to_stats_torch(parts, n_qry, n_ref, shift)
    for g, w in zip(got, want, strict=True):
        for a, b in zip(g, w, strict=True):
            np.testing.assert_array_equal(a, b)
    ranges = seen[0][2]
    assert sum(n for *_, n in ranges) == keys.size
    if cap == "all":
        assert ranges == [(None, None, keys.size)]
        return
    assert len(ranges) >= 2 and all(n <= k for *_, n in ranges)
    bounds = [b for lo, hi, _ in ranges for b in (lo, hi)]
    assert bounds == sorted(bounds)
    by_ref = any(lo % (1 << shift) or hi % (1 << shift) for lo, hi, _ in ranges)
    assert by_ref == (cap in ("within one query", "largest run"))


def test_stats_budget_reaches_the_report(tmp_path, monkeypatch):
    """species_abundance on a device route under a budget that splits its
    keys into ranges gives the JAX package's host report; with no free
    bytes it raises MemoryError: there is no host route to fall back
    to."""
    ref_dir, qry_dir, *_ = _mk_db(tmp_path, n_ref=30, sk=64, n_qry=2, seed=4)
    want = jax_composite.species_abundance(ref_dir, qry_dir, device=None)
    seen = _spy_ranges(monkeypatch)
    assert composite.species_abundance(ref_dir, qry_dir, device=CPU) == want
    parts, _, [(_, _, n)] = seen[0]
    monkeypatch.setattr(composite, "_free_bytes",
                        lambda device: _free_for(n // 3, parts))
    assert composite.species_abundance(ref_dir, qry_dir, device=CPU) == want
    assert len(seen[1][2]) >= 3 and want
    monkeypatch.setattr(composite, "_free_bytes", lambda device: 0)
    with pytest.raises(MemoryError, match="run composite with --device cpu"):
        composite.species_abundance(ref_dir, qry_dir, device=CPU)


# ------------------------------------------------------------ whole reports

DBS = {
    "dense hits": dict(n_ref=300, sk=64, n_qry=3, seed=7, space=1 << 16),
    "codes >= 2^31": dict(n_ref=64, sk=256, n_qry=4, seed=11, space=1 << 32),
    "one query": dict(n_ref=40, sk=64, n_qry=1, seed=5, space=1 << 20),
}


def _db(tmp_path, name, route):
    ref_dir, qry_dir, *_ = _mk_db(tmp_path, **DBS[name])
    if route == "csr":
        index.run_stage2(ref_dir, ref_dir, 7, dense=False)
    return ref_dir, qry_dir


def _report(route, ref_dir, qry_dir, out_dir=None, binvec=False):
    if route == "mesh [cpu]*4":
        return sharded_composite.species_abundance_sharded(
            ref_dir, qry_dir, parallel.Mesh(1, 4, (CPU,) * 4), out_dir=out_dir,
            binvec=binvec)
    return composite.species_abundance(ref_dir, qry_dir, out_dir, binvec,
                                       device=CPU)


def _refuse_host_versions(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a device route reached a host version")

    for name in ("_hits_to_stats", "_query_table", "_segment_stats_np",
                 "_raw_components"):
        monkeypatch.setattr(composite, name, refuse)


ROUTES = ["raw", "csr", "mesh [cpu]*4"]


@pytest.mark.parametrize("name", sorted(DBS))
@pytest.mark.parametrize("route", ROUTES)
def test_device_routes_match_jax_host_oracle(tmp_path, monkeypatch, route, name):
    """The report and the -b .abv files of each device route equal the
    JAX package's host oracle (device=None) byte for byte, and no device
    route reaches _hits_to_stats, _query_table, _segment_stats_np or
    _raw_components (the host's genome ids of the DB codes)."""
    ref_dir, qry_dir = _db(tmp_path, name, route)
    want = jax_composite.species_abundance(ref_dir, qry_dir, device=None)
    out_j, out_t = str(tmp_path / "abv_j"), str(tmp_path / "abv_t")
    jax_composite.species_abundance(ref_dir, qry_dir, out_j, binvec=True,
                                    device=None)
    _refuse_host_versions(monkeypatch)
    got = _report(route, ref_dir, qry_dir)
    assert got == want and want.count("\n") >= DBS[name]["n_qry"]
    _report(route, ref_dir, qry_dir, out_t, binvec=True)
    names = sorted(os.listdir(out_j))
    assert names and sorted(os.listdir(out_t)) == names
    for n in names:
        assert_files_equal(f"{out_j}/{n}", f"{out_t}/{n}", n)


@pytest.mark.parametrize("route", ROUTES)
def test_device_routes_multi_component(tmp_path, monkeypatch, route):
    """Two components, a code value in both, a query without codes in
    one of them: each component's table and the joined keys of both
    give the JAX package's host report."""
    rng = np.random.default_rng(41)
    ref_dir, qry_dir = str(tmp_path / "ref"), str(tmp_path / "qry")
    os.makedirs(ref_dir)
    os.makedirs(qry_dir)
    n_ref, sk, n_qry = 24, 60, 3
    refs = []
    for c in range(2):
        ref = np.sort(rng.integers(0, 1 << 14, (n_ref, sk), dtype=np.uint32), 1)
        refs.append(ref)
        formats.write_combco(ref_dir, c, ref.ravel(),
                             np.arange(n_ref + 1, dtype=np.uint64) * sk)
    formats.write_co_stat(ref_dir, formats.CoStat(
        params_id=5, koc=False, kmerlen=16, dim_rd_len=4, comp_num=2,
        infile_num=n_ref, all_ctx_ct=2 * n_ref * sk,
        ctx_ct=np.full(n_ref, 2 * sk, np.uint32),
        names=[f"r{i}" for i in range(n_ref)]))
    for c in range(2):
        qs = []
        for q in range(n_qry):
            if c == 1 and q == 2:
                qs.append(np.zeros(0, np.uint32))
                continue
            pool = np.unique(refs[c][q * 5: q * 5 + 6].ravel())
            qs.append(np.unique(np.concatenate(
                [pool[: 3 * sk], rng.integers(0, 1 << 14, 50).astype(np.uint32)])))
        qi = np.zeros(n_qry + 1, np.uint64)
        np.cumsum([q.size for q in qs], out=qi[1:])
        qc = np.concatenate(qs).astype(np.uint32)
        ab = rng.integers(1, 40, qc.size).astype(np.uint16)
        formats.write_combco(qry_dir, c, qc, qi, ab)
    formats.write_co_stat(qry_dir, formats.CoStat(
        params_id=5, koc=True, kmerlen=16, dim_rd_len=4, comp_num=2,
        infile_num=n_qry, all_ctx_ct=0, ctx_ct=np.ones(n_qry, np.uint32),
        names=[f"q{i}" for i in range(n_qry)]))
    if route == "csr":
        index.run_stage2(ref_dir, ref_dir, 7, dense=False)
    want = jax_composite.species_abundance(ref_dir, qry_dir, device=None)
    _refuse_host_versions(monkeypatch)
    assert want.count("\n") >= n_qry
    assert _report(route, ref_dir, qry_dir) == want


BUDGETS = ["one range", "two ranges", "a query a range", "within one query",
           "below one run"]


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("route", ROUTES)
def test_forced_budget_routes_match_jax_host_oracle(tmp_path, monkeypatch,
                                                    route, budget):
    """Each device route's report, under a budget (``_free_bytes``
    patched, parts read 64 keys at a time) that takes the keys in one
    range, in two ranges of queries, a query a range, or cuts the largest
    query by reference, equals the JAX package's host oracle byte for
    byte; below the largest (query, reference) run it raises
    MemoryError."""
    ref_dir, qry_dir = _db(tmp_path, "dense hits", route)
    want = jax_composite.species_abundance(ref_dir, qry_dir, device=None)
    monkeypatch.setattr(composite, "STATS_SLICE", 64)
    seen = _spy_ranges(monkeypatch)
    assert _report(route, ref_dir, qry_dir) == want
    parts, shift, [(_, _, n)] = seen.pop()
    keys = np.concatenate([p.numpy() for p in parts])
    per_q = np.bincount(keys >> shift)
    runs = np.unique(keys >> 16, return_counts=True)[1]
    cum = np.cumsum(per_q)[:-1]
    cap = {"one range": n, "two ranges": np.maximum(cum, n - cum).min(),
           "a query a range": per_q.max(), "within one query": per_q.max() - 1,
           "below one run": runs.max() - 1}[budget]
    assert per_q.size == 3 and runs.max() < per_q.min() < per_q.max() < n // 2
    monkeypatch.setattr(composite, "_free_bytes",
                        lambda device: _free_for(int(cap), parts))
    _refuse_host_versions(monkeypatch)
    if budget == "below one run":
        with pytest.raises(MemoryError, match="free memory on cpu"):
            _report(route, ref_dir, qry_dir)
        return
    assert _report(route, ref_dir, qry_dir) == want
    ranges = seen.pop()[2]
    assert sum(k for *_, k in ranges) == n and all(k <= cap for *_, k in ranges)
    whole = [lo is not None and lo % (1 << shift) == hi % (1 << shift) == 0
             for lo, hi, _ in ranges]
    if budget == "one range":
        assert ranges == [(None, None, n)]
    elif budget == "two ranges":
        assert len(ranges) == 2 and all(whole)
    elif budget == "a query a range":
        assert [hi - lo for lo, hi, _ in ranges] == [1 << shift] * 3
    else:
        assert len(ranges) > 3 and not all(whole)
