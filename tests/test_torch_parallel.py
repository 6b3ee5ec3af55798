"""The port's sharded paths (parallel/) against the JAX package's on the
CPU: the port's mesh is a list of torch devices (``[cpu] * n``, the twin
of the JAX tests' 8 virtual CPU devices), the JAX package's a
``jax.sharding.Mesh`` over those devices. Mesh search counts, the
``--mesh`` CLI outputs and the mesh composite report must equal the
single-device and host results and the JAX package's, exactly; so must
the 64-bit-key plain versions of the count and join kernels on keys with
bit 63 set."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from conftest import assert_files_equal
from test_composite_scale import _mk_db
from test_sharded_search import db7  # noqa: F401  (module fixture)
from test_torch_mesh_device import host_fold_refused  # noqa: F401  (fixture)

from public_kssd_tpu import cli as jax_cli
from public_kssd_tpu import composite as jax_composite
from public_kssd_tpu import formats as jax_formats
from public_kssd_tpu import search as jax_search
from public_kssd_tpu.ops import count as jax_count
from public_kssd_tpu.parallel import sharded_composite as jax_sc
from public_kssd_tpu.parallel import sharded_search as jax_ss
from public_kssd_tpu_torch import cli, composite, index, parallel, search
from public_kssd_tpu_torch.ops import count
from public_kssd_tpu_torch.parallel import sharded_composite, sharded_search

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _mesh(dp, ref):
    return parallel.Mesh(dp, ref, (CPU,) * (dp * ref))


def _jax_mesh(dp, ref):
    return JaxMesh(np.array(jax.devices()[: dp * ref]).reshape(dp, ref),
                   ("dp", "ref"))


# ------------------------------------------------------------ mesh search

@pytest.mark.parametrize("strategy", ["genome", "code"])
@pytest.mark.parametrize("dp,ref", [(1, 8), (8, 1), (2, 4), (4, 2)])
def test_sharded_counts_equal_oracle(db7, indexed7, dp, ref, strategy):  # noqa: F811
    root, params, comps, oracle = db7
    qry = os.path.join(root, "my_qry_hit")
    got = sharded_search.sharded_search_counts(
        qry, os.path.join(indexed7, "my_ref"), params.comp_code_bits,
        _mesh(dp, ref), strategy=strategy,
    )
    want = jax_ss.sharded_search_counts(
        qry, comps, params, _jax_mesh(dp, ref), strategy=strategy,
    )
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle)


@pytest.mark.parametrize("strategy", ["genome", "code"])
@pytest.mark.parametrize("n_shards", [3, 4])
def test_sharded_db_construction(db7, indexed7, strategy, n_shards):  # noqa: F811
    """Same cut points and shard contents, built on the device from the
    index directory, as the JAX package's sharded DB of the same index,
    whose shards are padded to one shape (the port's are not)."""
    _, params, comps, _ = db7
    key, offsets, gids = jax_ss.merge_components(comps, params.comp_code_bits)
    n_ref = comps[0].n_genomes
    build = (jax_ss.build_genome_sharded_db if strategy == "genome"
             else jax_ss.build_sharded_db)
    jdb = build(key, offsets, gids, n_ref, n_shards)
    db = sharded_search.device_shards(os.path.join(indexed7, "my_ref"),
                                      _mesh(1, n_shards), params.comp_code_bits,
                                      strategy)
    np.testing.assert_array_equal(db.row_bounds, jdb.row_bounds)
    assert db.n_shards == n_shards and db.n_ref == n_ref
    shards = [db.index[(s, CPU)] for s in range(n_shards)]
    for s, ix in enumerate(shards):
        n, g = ix.uniq.numel(), ix.gids.numel()
        np.testing.assert_array_equal(ix.uniq.numpy().view(np.uint64), jdb.uniq[s, :n])
        assert (jdb.uniq[s, n:] == np.iinfo(np.uint64).max).all()
        np.testing.assert_array_equal(ix.offsets.numpy(), jdb.offsets[s, : n + 1])
        assert int(jdb.offsets[s, -1]) == g
        np.testing.assert_array_equal(ix.gids.numpy().view(np.uint32), jdb.gids[s, :g])
    assert sum(ix.gids.numel() for ix in shards) == gids.size
    if strategy == "code":
        assert sum(ix.uniq.numel() for ix in shards) == key.size


@pytest.mark.parametrize("strategy", ["genome", "code"])
@pytest.mark.parametrize("batch", [1, 3])
def test_mesh_query_batching_equals_unbatched(db7, indexed7, batch,  # noqa: F811
                                               strategy):
    """The -m governor inside the sharded path: per-batch counting into a
    caller matrix equals the single-shot result."""
    root, params, comps, oracle = db7
    out = np.full(oracle.shape, 7, dtype=np.uint32)
    got = sharded_search.sharded_search_counts(
        os.path.join(root, "my_qry_hit"), os.path.join(indexed7, "my_ref"),
        params.comp_code_bits, _mesh(2, 2), batch=batch, counts_out=out,
        strategy=strategy,
    )
    assert got is out
    np.testing.assert_array_equal(out, oracle)


@pytest.fixture(scope="module")
def koc7(db7):  # noqa: F811
    """The planted query dir of db7 with synthetic .a abundances (the
    JAX package's test_sharded_koc_counts_equal_oracle construction)."""
    root = db7[0]
    src = os.path.join(root, "my_qry_hit")
    koc_dir = os.path.join(root, "torch_koc_qry")
    if not os.path.isdir(koc_dir):
        stat = jax_formats.read_co_stat(src)
        os.makedirs(koc_dir)
        rng = np.random.default_rng(3)
        for c in range(stat.comp_num):
            codes, idx = jax_formats.read_combco(src, c)
            ab = rng.integers(1, 500, size=codes.size).astype(np.uint16)
            jax_formats.write_combco(koc_dir, c, codes, idx, ab)
        jax_formats.write_co_stat(koc_dir, dataclasses.replace(stat, koc=True))
    return koc_dir


@pytest.mark.parametrize("dp,ref,strategy", [(2, 4, "genome"), (4, 2, "code")])
def test_sharded_koc_counts_equal_oracle(db7, indexed7, koc7, dp, ref,  # noqa: F811
                                         strategy):
    _, params, comps, _ = db7
    n_qry, n_ref = 3, comps[0].n_genomes
    koc_want = np.zeros((n_qry, n_ref), np.uint64)
    counts_want = jax_search.compute_shared_counts(
        koc7, comps, n_qry, use_device=False, koc_out=koc_want
    )
    koc_jax = np.zeros((n_qry, n_ref), np.uint64)
    jax_ss.sharded_search_counts(koc7, comps, params, _jax_mesh(dp, ref),
                                 koc_out=koc_jax, strategy=strategy)
    koc_got = np.zeros((n_qry, n_ref), np.uint64)
    counts_got = sharded_search.sharded_search_counts(
        koc7, os.path.join(indexed7, "my_ref"), params.comp_code_bits,
        _mesh(dp, ref), koc_out=koc_got, strategy=strategy,
    )
    np.testing.assert_array_equal(counts_got, counts_want)
    np.testing.assert_array_equal(koc_got, koc_want)
    np.testing.assert_array_equal(koc_got, koc_jax)
    assert koc_want.sum() > 0 and counts_want.sum() > 0


@pytest.fixture(scope="module")
def indexed7(db7):  # noqa: F811
    root = db7[0]
    if not os.path.isfile(os.path.join(root, "my_ref", "mcofiles.stat")):
        index.run_stage2(os.path.join(root, "my_ref"),
                         os.path.join(root, "my_ref"), 7, dense=False)
    return root


@pytest.mark.parametrize("koc", [False, True])
@pytest.mark.parametrize("strategy", ["genome", "code"])
def test_cli_mesh_search_matches_plain(indexed7, koc7, tmp_path, strategy, koc,
                                       host_fold_refused):
    """kssd_torch dist --mesh 2x4 --device cpu == the plain port run ==
    kssd_tpu --mesh 2x4, byte for byte (with -m 1: batched), the port's
    host index read refused."""
    root = indexed7
    qry = koc7 if koc else os.path.join(root, "my_qry_hit")
    ref = os.path.join(root, "my_ref")
    flags = ["--koc-out"] if koc else []
    mesh = ["--mesh", "2x4", "--shard-strategy", strategy, "-m", "1"]
    outs = {}
    for tag, main, extra in (
        ("plain", cli.main, ["--device", "cpu"]),
        ("mesh", cli.main, ["--device", "cpu", *mesh]),
        ("jax", jax_cli.main, mesh),
    ):
        outs[tag] = str(tmp_path / tag)
        assert main(["dist", "-r", ref, "-o", outs[tag], *flags, *extra,
                     qry]) == 0
    for tag in ("mesh", "jax"):
        assert_files_equal(f"{outs['plain']}/distance.out",
                           f"{outs[tag]}/distance.out", tag)
    with open(f"{outs['plain']}/distance.out") as f:
        lines = f.read().splitlines()
    assert len(lines) == 1 + (2 if koc else 1) * 3 * 4


def test_cli_mesh_rejects_bad_specs(indexed7, tmp_path):
    root = indexed7
    for bad in ("bogus", "2", "0x2"):
        with pytest.raises(SystemExit, match="--mesh"):
            cli.main(["dist", "-r", os.path.join(root, "my_ref"), "-o",
                      str(tmp_path / "x"), "--device", "cpu", "--mesh", bad,
                      os.path.join(root, "my_qry_hit")])


def test_make_mesh():
    m = parallel.make_mesh(2, 4, "cpu")
    assert (m.dp, m.ref) == (2, 4) and m.devices == (CPU,) * 8
    assert [s[:2] for s in m.local_slots()] == [(d, r) for d in range(2)
                                                 for r in range(4)]
    with pytest.raises(ValueError, match="needs 4 devices"):
        parallel.Mesh(2, 2, (CPU,))
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match=r"need 2 devices \(0 visible\)"):
            parallel.make_mesh(1, 2, "cuda")


# ------------------------------------------------------ 64-bit-key kernels

def _folded_csr(seed, n_ref=60, sk=200, n_qry=7, shift=36):
    """A random CSR over 28-bit codes, its keys moved to code << shift | 5
    (so keys of codes >= 2^27 have bit 63 set), and planted queries."""
    rng = np.random.default_rng(seed)
    ref = [np.unique(rng.integers(0, 1 << 28, sk, dtype=np.uint64))
           for _ in range(n_ref)]
    flat = np.concatenate(ref)
    gid = np.repeat(np.arange(n_ref, dtype=np.uint32), [r.size for r in ref])
    order = np.argsort(flat, kind="stable")
    uniq, first = np.unique(flat[order], return_index=True)
    offsets = np.append(first, flat.size).astype(np.int64)
    gids = gid[order]
    q = rng.integers(0, 1 << 28, n_qry * sk, dtype=np.uint64)
    hit = rng.random(q.size) < 0.3
    q[hit] = flat[rng.integers(0, flat.size, int(hit.sum()))]
    qidx = np.arange(n_qry + 1, dtype=np.uint64) * np.uint64(sk)

    def fold(c):
        return (c << np.uint64(shift)) | np.uint64(5)

    return fold(uniq), offsets, gids, fold(q), qidx, n_ref, n_qry


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_count64_plain_matches_np_on_high_keys(seed):
    """count_shared_torch / count_shared_koc_torch over an index of
    uint64 keys (int64 bit views) equal the numpy oracle on uint64, with
    keys >= 2^63 on both sides of the search."""
    uniq, offsets, gids, q, qidx, n_ref, n_qry = _folded_csr(seed)
    assert (uniq >= np.uint64(1 << 63)).any() and (uniq < np.uint64(1 << 63)).any()
    w = np.random.default_rng(seed).integers(1, 1 << 16, q.size).astype(np.uint32)
    want = count.count_shared_np(q, qidx, uniq, offsets, gids, n_qry, n_ref)
    want_w = count.count_shared_weighted_np(q, qidx, w, uniq, offsets, gids,
                                            n_qry, n_ref)
    assert want.sum() > 0
    np.testing.assert_array_equal(
        want, jax_count.count_shared_np(q, qidx, uniq, offsets, gids, n_qry, n_ref)
    )
    idx = count.DeviceIndex.from_arrays(uniq, offsets, gids, n_ref, CPU)
    assert idx.uniq.dtype == torch.int64
    qc = count._key_view(q)
    qq = torch.from_numpy(count.query_ids(qidx, q.size))
    got = count.count_shared_kernel(qc, qq, idx, n_qry)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    got_c, got_w = count.count_shared_koc_kernel(qc, qq, count._u32_view(w),
                                                 idx, n_qry)
    np.testing.assert_array_equal(got_c.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(got_w.numpy().view(np.uint64), want_w)


def test_ordered_keeps_unsigned_order():
    keys = np.array([0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1], np.uint64)
    o = count._ordered(count._key_view(keys))
    assert torch.equal(torch.argsort(o), torch.arange(5))
    o32 = count._ordered(count._u32_view(np.array([0, 1 << 31, 0xFFFFFFFF],
                                                  np.uint32)))
    assert o32.tolist() == [0, 1 << 31, 0xFFFFFFFF]


@pytest.mark.parametrize("seed,hot", [(4, False), (5, False), (6, True)],
                         ids=["4", "5", "hot-row"])
def test_join64_plain_equals_32bit_join(seed, hot):
    """join_torch on uint64 keys (code << 36 | 7, bit 63 set for half the
    codes) gives the keys the 32-bit join gives on the codes: the fold is
    monotone and injective, so matches and their order are the same.
    ``hot``: one code >= 2^27 (a key >= 2^63) in a row of each of the 300
    references and in the table for each of the 5 queries."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 1 << 28, 5000, dtype=np.uint64)
    rid = rng.integers(0, 300, codes.size).astype(np.int32)
    q = np.sort(np.concatenate([rng.choice(codes, 800),
                                rng.integers(0, 1 << 28, 800, dtype=np.uint64)]))
    sqid = rng.integers(0, 5, q.size).astype(np.int32)
    if hot:
        h = np.uint64((1 << 27) + 777)
        codes = np.concatenate([codes, np.full(300, h)])
        rid = np.concatenate([rid, np.arange(300, dtype=np.int32)])
        at = np.searchsorted(q, h)
        q = np.insert(q, at, np.full(5, h))
        sqid = np.insert(sqid, at, np.arange(5, dtype=np.int32))
    sab = rng.integers(1, 1 << 16, q.size).astype(np.int32)
    fold = lambda c: (c << np.uint64(36)) | np.uint64(7)  # noqa: E731
    shift = 16 + 9
    want = composite.join_torch(
        count._u32_view(codes.astype(np.uint32)), None, torch.from_numpy(rid),
        count._u32_view(q.astype(np.uint32)), torch.from_numpy(sqid),
        torch.from_numpy(sab), shift,
    )
    got = composite.join_kernel(
        count._key_view(fold(codes)), None, torch.from_numpy(rid),
        count._key_view(fold(q)), torch.from_numpy(sqid),
        torch.from_numpy(sab), shift,
    )
    assert want.numel() > 0 and (fold(codes) >= np.uint64(1 << 63)).any()
    assert torch.equal(got, want)
    if hot:  # the last 300 rows: each the 5 queries' keys, in table order
        tail = got[-300 * 5:].reshape(300, 5).numpy()
        assert (tail >> shift == np.arange(5)).all()
        assert ((tail >> 16) & 0x1FF == np.arange(300)[:, None]).all()


# --------------------------------------------------------- mesh composite

@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_sharded_composite_equals_host(tmp_path, n_dev):
    ref_dir, qry_dir, *_ = _mk_db(tmp_path, n_ref=40, sk=64, n_qry=3, seed=3)
    want = jax_composite.species_abundance(ref_dir, qry_dir, device=False)
    jax_got = jax_sc.species_abundance_sharded(
        ref_dir, qry_dir, JaxMesh(np.array(jax.devices()[:n_dev]), ("ref",))
    )
    got = sharded_composite.species_abundance_sharded(ref_dir, qry_dir,
                                                      _mesh(1, n_dev))
    assert want and jax_got == want
    assert got == want
    assert composite.species_abundance(ref_dir, qry_dir, device=None) == want


def test_sharded_composite_skewed_hits(tmp_path):
    """The JAX package's overflow-retry DB (every genome mostly the same
    8 codes): the exact-size join needs no retry and gives the host
    report."""
    rng = np.random.default_rng(9)
    ref_dir, qry_dir = str(tmp_path / "ref"), str(tmp_path / "qry")
    os.makedirs(ref_dir)
    os.makedirs(qry_dir)
    n_ref, sk = 50, 200
    hot = np.arange(100, 108, dtype=np.uint32)
    ref = np.tile(hot, (n_ref, sk // hot.size))
    jax_formats.write_combco(ref_dir, 0, ref.ravel().astype(np.uint32),
                             np.arange(n_ref + 1, dtype=np.uint64) * sk)
    jax_formats.write_co_stat(ref_dir, jax_formats.CoStat(
        params_id=5, koc=False, kmerlen=16, dim_rd_len=4, comp_num=1,
        infile_num=n_ref, all_ctx_ct=int(ref.size),
        ctx_ct=np.full(n_ref, sk, np.uint32),
        names=[f"r{i}" for i in range(n_ref)]))
    qry = np.unique(np.concatenate(
        [hot, rng.integers(1000, 1 << 20, 16, dtype=np.uint32)]))[:16]
    ab = rng.integers(1, 40, size=qry.size).astype(np.uint16)
    jax_formats.write_combco(qry_dir, 0, qry.astype(np.uint32),
                             np.array([0, qry.size], np.uint64), ab)
    jax_formats.write_co_stat(qry_dir, jax_formats.CoStat(
        params_id=5, koc=True, kmerlen=16, dim_rd_len=4, comp_num=1,
        infile_num=1, all_ctx_ct=int(qry.size),
        ctx_ct=np.array([qry.size], np.uint32), names=["q0"]))
    want = jax_composite.species_abundance(ref_dir, qry_dir, device=False)
    got = sharded_composite.species_abundance_sharded(ref_dir, qry_dir,
                                                      _mesh(1, 4))
    assert want and got == want


def test_sharded_composite_multi_component(tmp_path):
    """comp_num > 1: the comp << 32 | code fold keeps per-component joins
    separate (a code value shared across components is distinct)."""
    rng = np.random.default_rng(17)
    ref_dir, qry_dir = str(tmp_path / "ref"), str(tmp_path / "qry")
    os.makedirs(ref_dir)
    os.makedirs(qry_dir)
    n_ref, sk = 20, 40
    refs = []
    for c in range(2):
        ref = rng.integers(0, 1 << 16, size=(n_ref, sk), dtype=np.uint32)
        refs.append(np.sort(ref, axis=1))
        jax_formats.write_combco(ref_dir, c, refs[-1].ravel(),
                                 np.arange(n_ref + 1, dtype=np.uint64) * sk)
    jax_formats.write_co_stat(ref_dir, jax_formats.CoStat(
        params_id=5, koc=False, kmerlen=16, dim_rd_len=4, comp_num=2,
        infile_num=n_ref, all_ctx_ct=2 * n_ref * sk,
        ctx_ct=np.full(n_ref, 2 * sk, np.uint32),
        names=[f"r{i}" for i in range(n_ref)]))
    for c in range(2):
        pool = np.unique(refs[c][:6].ravel())
        other = np.unique(refs[1 - c][:6].ravel())
        q = np.unique(np.concatenate([pool[:60], other[:60]]))
        ab = rng.integers(1, 30, size=q.size).astype(np.uint16)
        jax_formats.write_combco(qry_dir, c, q, np.array([0, q.size], np.uint64),
                                 ab)
    jax_formats.write_co_stat(qry_dir, jax_formats.CoStat(
        params_id=5, koc=True, kmerlen=16, dim_rd_len=4, comp_num=2,
        infile_num=1, all_ctx_ct=0, ctx_ct=np.array([1], np.uint32),
        names=["q0"]))
    want = jax_composite.species_abundance(ref_dir, qry_dir, device=False)
    jax_got = jax_sc.species_abundance_sharded(
        ref_dir, qry_dir, JaxMesh(np.array(jax.devices()[:4]), ("ref",))
    )
    got = sharded_composite.species_abundance_sharded(ref_dir, qry_dir,
                                                      _mesh(1, 4))
    assert want and jax_got == want and got == want


def test_sharded_composite_duplicate_query_codes_count_once(tmp_path):
    """A forged query sketch carrying each code twice: the first
    occurrence wins, as in the host oracle."""
    rng = np.random.default_rng(23)
    ref_dir, qry_dir = str(tmp_path / "ref"), str(tmp_path / "qry")
    os.makedirs(ref_dir)
    os.makedirs(qry_dir)
    n_ref, sk = 25, 64
    ref = np.sort(rng.integers(0, 1 << 16, size=(n_ref, sk), dtype=np.uint32),
                  axis=1)
    jax_formats.write_combco(ref_dir, 0, ref.ravel(),
                             np.arange(n_ref + 1, dtype=np.uint64) * sk)
    jax_formats.write_co_stat(ref_dir, jax_formats.CoStat(
        params_id=5, koc=False, kmerlen=16, dim_rd_len=4, comp_num=1,
        infile_num=n_ref, all_ctx_ct=int(ref.size),
        ctx_ct=np.full(n_ref, sk, np.uint32),
        names=[f"r{i}" for i in range(n_ref)]))
    base = np.unique(ref[:5].ravel())[:80]
    qry = np.concatenate([base, base])
    ab = np.concatenate([rng.integers(1, 30, size=base.size),
                         rng.integers(30, 60, size=base.size)]).astype(np.uint16)
    jax_formats.write_combco(qry_dir, 0, qry, np.array([0, qry.size], np.uint64),
                             ab)
    jax_formats.write_co_stat(qry_dir, jax_formats.CoStat(
        params_id=5, koc=True, kmerlen=16, dim_rd_len=4, comp_num=1,
        infile_num=1, all_ctx_ct=int(qry.size),
        ctx_ct=np.array([qry.size], np.uint32), names=["q0"]))
    host = jax_composite.species_abundance(ref_dir, qry_dir, device=False)
    got = sharded_composite.species_abundance_sharded(ref_dir, qry_dir,
                                                      _mesh(1, 4))
    assert host and got == host
    assert composite.species_abundance(ref_dir, qry_dir, device=CPU) == host


def test_cli_composite_mesh_rejects_bad_specs(tmp_path, capsys):
    ref_dir, qry_dir, *_ = _mk_db(tmp_path, n_ref=10, sk=32, n_qry=1, seed=7)
    for bad in ("bogus", "0"):
        with pytest.raises(SystemExit, match="--mesh"):
            cli.main(["composite", "-r", ref_dir, "-q", qry_dir,
                      "--device", "cpu", "--mesh", bad])
    # DPxREF spec is accepted (dp folds into the device count)
    assert cli.main(["composite", "-r", ref_dir, "-q", qry_dir,
                     "--device", "cpu", "--mesh", "2x2"]) == 0
    capsys.readouterr()


def test_cli_mesh_composite_matches_plain(tmp_path, capsys, host_fold_refused):
    """kssd_torch composite --mesh 4 --device cpu == the plain port run
    == kssd_tpu composite --mesh 4, and -b writes the same .abv files;
    the port's host index read refused."""
    ref_dir, qry_dir, *_ = _mk_db(tmp_path, n_ref=30, sk=48, n_qry=2, seed=5)
    outs = []
    for argv in (
        ["--device", "cpu"], ["--device", "cpu", "--mesh", "4"],
    ):
        assert cli.main(["composite", "-r", ref_dir, "-q", qry_dir, *argv]) == 0
        outs.append(capsys.readouterr().out)
    assert jax_cli.main(["composite", "-r", ref_dir, "-q", qry_dir,
                         "--mesh", "4"]) == 0
    outs.append(capsys.readouterr().out)
    assert outs[0] and outs[1] == outs[0] and outs[2] == outs[0]
    for tag, argv in (("plain", []), ("mesh", ["--mesh", "4"])):
        assert cli.main(["composite", "-r", ref_dir, "-q", qry_dir, "-b",
                         "-o", str(tmp_path / tag), "--device", "cpu",
                         *argv]) == 0
    names = sorted(os.listdir(tmp_path / "plain"))
    assert names and names == sorted(os.listdir(tmp_path / "mesh"))
    for n in names:
        assert_files_equal(str(tmp_path / "plain" / n), str(tmp_path / "mesh" / n))
