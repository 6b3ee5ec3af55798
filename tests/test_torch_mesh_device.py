"""The mesh paths' DB and query construction on the slots' devices
(``parallel/sharded_search.device_shards``, ``DeviceQueries``,
``parallel/sharded_composite._slot_db``, ``_fold_queries_device``)
against the JAX package's numpy construction on the CPU, exactly: the
shards' cut rows, keys, offsets and genome ids of both strategies
(folded keys >= 2^63 included, the index read in groups of whole
components, of one component, or of a few rows), each dp block's query
keys, and composite's folded DB and query table (duplicates included).
The port has no numpy construction of its own; its host index read
(``index.load_sparse_index``) must not be reached."""

import os
import shutil

import numpy as np
import pytest
import torch

from public_kssd_tpu import index as jax_index
from public_kssd_tpu.parallel import sharded_composite as jax_sc
from public_kssd_tpu.parallel import sharded_search as jax_ss
from public_kssd_tpu_torch import composite, formats, index, parallel
from public_kssd_tpu_torch.ops import staging
from public_kssd_tpu_torch.parallel import sharded_composite, sharded_search

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _mesh(dp, ref):
    return parallel.Mesh(dp, ref, (CPU,) * (dp * ref))


def _sketch_dir(path, n_ref, comp_num, space, sk, seed, koc=False, dups=False):
    """A sketch dir of ``comp_num`` components: each genome's codes a
    sorted set drawn from ``space`` (a third of them from a small hot
    pool, so rows carry many postings), genome 1 without codes; with
    ``dups`` each genome's codes twice (a forged query sketch)."""
    rng = np.random.default_rng(seed)
    os.makedirs(path)
    hot = rng.integers(0, space, 64, dtype=np.uint64)
    ctx = np.zeros(n_ref, np.uint32)
    for c in range(comp_num):
        parts = []
        for g in range(n_ref):
            n = 0 if g == 1 else int(rng.integers(1, sk))
            got = np.unique(np.concatenate([
                rng.integers(0, space, n, dtype=np.uint64),
                rng.choice(hot, n // 3)])).astype(np.uint32)
            parts.append(np.concatenate([got, got[::-1]]) if dups else got)
            ctx[g] += parts[-1].size
        idx = np.zeros(n_ref + 1, np.uint64)
        np.cumsum([p.size for p in parts], out=idx[1:])
        codes = np.concatenate(parts).astype(np.uint32)
        ab = rng.integers(1, 1 << 16, codes.size).astype(np.uint16) if koc else None
        formats.write_combco(path, c, codes, idx, ab)
    formats.write_co_stat(path, formats.CoStat(
        params_id=5, koc=koc, kmerlen=16, dim_rd_len=4, comp_num=comp_num,
        infile_num=n_ref, all_ctx_ct=int(ctx.sum()), ctx_ct=ctx,
        names=[f"g{i}" for i in range(n_ref)]))
    return path


# name -> (genomes, components, code space, codes a genome, fold bits,
# component size of stage II, dense index)
INDEXES = {
    # 32-bit codes under a 32-bit fold: keys of codes >= 2^31 pass 2^63
    "high keys": (40, 3, 1 << 32, 90, 32, 8, False),
    # component 1 keeps only the reference's dense mco.index.1
    "dense component": (30, 2, 1 << 16, 70, 4, 4, True),
    # fewer postings than shards: cut targets of 0
    "tiny": (3, 1, 1 << 10, 2, 0, 4, False),
}


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_device")
    out = {}
    for name, (n_ref, comps, space, sk, bits, csz, dense) in INDEXES.items():
        d = _sketch_dir(str(root / name.replace(" ", "_")), n_ref, comps, space,
                        sk, seed=len(out) + 1)
        index.run_stage2(d, d, csz, dense=dense)
        if dense:
            for f in index._csr_paths(d, 1):
                os.remove(f)
        out[name] = (d, bits)
    return out


def _host_db(d, bits, strategy, n_shards):
    """The JAX package's shards of index dir ``d``."""
    _, comps = jax_index.load_sparse_index(d)
    key, offsets, gids = jax_ss.merge_components(comps, bits)
    build = (jax_ss.build_genome_sharded_db if strategy == "genome"
             else jax_ss.build_sharded_db)
    return build(key, offsets, gids, comps[0].n_genomes, n_shards), key.size


def _check_shards(db, want, n_shards):
    np.testing.assert_array_equal(db.row_bounds, want.row_bounds)
    assert db.n_shards == n_shards and db.n_ref == want.n_ref
    for s in range(n_shards):
        got = db.index[(s, CPU)]
        n, g = got.uniq.numel(), got.gids.numel()
        np.testing.assert_array_equal(got.uniq.numpy().view(np.uint64),
                                      want.uniq[s, :n])
        assert (want.uniq[s, n:] == np.iinfo(np.uint64).max).all()
        np.testing.assert_array_equal(got.offsets.numpy(), want.offsets[s, :n + 1])
        np.testing.assert_array_equal(got.gids.numpy().view(np.uint32),
                                      want.gids[s, :g])
        assert int(want.offsets[s, -1]) == g
        lo, hi = db.columns(s)
        assert got.n_ref == hi - lo


@pytest.fixture
def host_fold_refused(monkeypatch):
    """The port's host index read raises: a mesh route reads the index
    and the sketches onto its devices."""
    def refuse(*a, **k):
        raise AssertionError("a mesh route read the index on the host")

    monkeypatch.setattr(index, "load_sparse_index", refuse)


# how the index is read: (components a group, bytes a group, cut bucket
# bits), or None for the defaults
GROUPS = {
    "one group": None,
    # a bucket of 3 bits holds many rows of several components
    "a component a group": (1, None, 3),
    # every component cut into pieces of a few rows
    "a few rows a group": (64, 200, 3),
}


def _groups(monkeypatch, groups):
    if GROUPS[groups]:
        comps, nbytes, bucket_bits = GROUPS[groups]
        monkeypatch.setattr(index, "_OPEN_COMPONENTS", comps)
        if nbytes:
            monkeypatch.setattr(index, "MESH_GROUP_BYTES", nbytes)
        monkeypatch.setattr(sharded_search, "CUT_BUCKET_BITS", bucket_bits)


@pytest.mark.parametrize("groups", sorted(GROUPS))
@pytest.mark.parametrize("n_shards", [3, 4])
@pytest.mark.parametrize("strategy", ["genome", "code"])
@pytest.mark.parametrize("name", sorted(INDEXES))
def test_device_shards_equal_host(indexes, host_fold_refused, monkeypatch,
                                  name, strategy, n_shards, groups):
    """device_shards of an index dir equals the JAX package's
    build_sharded_db / build_genome_sharded_db of merge_components: cut
    rows, keys, offsets, ids, however the index is read (``GROUPS``)."""
    d, bits = indexes[name]
    _groups(monkeypatch, groups)
    want, nnz = _host_db(d, bits, strategy, n_shards)
    db = sharded_search.device_shards(d, _mesh(2, n_shards), bits, strategy)
    assert sorted(db.index) == [(s, CPU) for s in range(n_shards)]
    _check_shards(db, want, n_shards)
    if strategy == "code":
        assert sum(db.index[(s, CPU)].uniq.numel() for s in range(n_shards)) == nnz
    if name == "high keys":
        top = max(int(db.index[(s, CPU)].uniq.numpy().view(np.uint64).max(initial=0))
                  for s in range(n_shards))
        assert top >= 1 << 63


@pytest.mark.parametrize("groups", ["a component a group", "a few rows a group"])
@pytest.mark.parametrize("strategy", ["genome", "code"])
def test_one_component_group_at_a_time(indexes, monkeypatch, strategy, groups):
    """A group's device buffer is gone before the next group is read, no
    group holds more than MESH_GROUP_BYTES, and the build reads each
    posting once: a device holds its shards and one bounded group. The
    code strategy's cut reads codes and offsets only, and its shards
    only their own rows."""
    d, bits = indexes["high keys"]
    _groups(monkeypatch, groups)
    held: list = []  # each group's buffer, held here too
    reads, postings = [], []
    real = index._runs_on_device

    def runs_on_device(runs, *a, **k):
        # the earlier buffers that something besides ``held`` still uses
        reads.append(sum(torch._C._storage_Use_Count(st._cdata) > 1
                         for st in held))
        assert sum(size for run in runs for _, _, size in run) <= index.MESH_GROUP_BYTES
        if len(runs) == 3:
            postings.append(sum(size for _, _, size in runs[2]) // 4)
        got = real(runs, *a, **k)
        held.append(got[0][0].untyped_storage())
        return got

    monkeypatch.setattr(index, "_runs_on_device", runs_on_device)
    stat = formats.read_mco_stat(d)
    total = sum(os.path.getsize(formats.mco_path(d, c)) // 4
                for c in range(stat.comp_num))
    db = sharded_search.device_shards(d, _mesh(1, 3), bits, strategy)
    assert reads == [0] * len(reads) and len(reads) >= stat.comp_num
    assert sum(postings) == total
    assert sum(db.index[(s, CPU)].gids.numel() for s in range(3)) == total


@pytest.fixture(scope="module")
def queries(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_queries")
    return _sketch_dir(str(root / "q"), 7, 3, 1 << 32, 50, seed=9, koc=True)


@pytest.mark.parametrize("with_abund", [False, True])
@pytest.mark.parametrize("q0,q1", [(0, 7), (1, 4), (2, 2), (6, 7)])
def test_device_query_keys_equal_host(queries, q0, q1, with_abund):
    """A dp block's keys, local query ids and weights, sliced from the
    query sketch folded on the device, equal the host query_keys' entries
    of those queries, by query (query 1 has no codes)."""
    got = sharded_search.DeviceQueries(queries, CPU, with_abund, 32).block(q0, q1)
    want = jax_ss.query_keys(queries, 32, with_abund=with_abund)
    m = (want[1] >= q0) & (want[1] < q1)
    o = np.argsort(want[1][m], kind="stable")
    np.testing.assert_array_equal(got[0].numpy().view(np.uint64), want[0][m][o])
    assert got[1].dtype == torch.int32
    np.testing.assert_array_equal(got[1].numpy(), want[1][m][o] - q0)
    if with_abund:
        np.testing.assert_array_equal(got[2].numpy().view(np.uint32), want[2][m][o])
    else:
        assert len(got) == 2
    assert (want[0][m] >= np.uint64(1 << 63)).any() or q1 - q0 < 2


def test_device_queries_refuse_torn_files(queries, tmp_path):
    d = str(tmp_path / "q")
    shutil.copytree(queries, d)
    with open(formats.abund_path(d, 2), "ab") as f:
        f.write(b"\0\0")
    with pytest.raises(ValueError, match="component 2"):
        sharded_search.DeviceQueries(d, CPU, True, 32)


@pytest.fixture(scope="module")
def composite_dbs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_composite")
    ref = _sketch_dir(str(root / "ref"), 25, 3, 1 << 32, 60, seed=13)
    qry = _sketch_dir(str(root / "qry"), 4, 3, 1 << 32, 60, seed=14, koc=True,
                      dups=True)
    # each query holds the codes of three references besides its own
    rng = np.random.default_rng(15)
    for c in range(3):
        rc, ri = formats.read_combco(ref, c)
        qc, qi, qa = formats.read_combco(qry, c, with_abund=True)
        parts = []
        for g in range(4):
            own = qc[int(qi[g]):int(qi[g + 1])]
            picked = np.concatenate([rc[int(ri[r]):int(ri[r + 1])]
                                     for r in (3 * g, 3 * g + 2, 3 * g + 4)])
            got = np.unique(np.concatenate([own, picked]))
            parts.append(np.concatenate([got, got[::-1]]))
        idx = np.zeros(5, np.uint64)
        np.cumsum([p.size for p in parts], out=idx[1:])
        codes = np.concatenate(parts)
        formats.write_combco(qry, c, codes, idx,
                             rng.integers(1, 1 << 16, codes.size).astype(np.uint16))
    return ref, qry


@pytest.mark.parametrize("chunk,groups", [(1 << 26, 64), (37, 1)])
@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_composite_slot_db_equals_fold_ref(composite_dbs, host_fold_refused,
                                           monkeypatch, n_shards, chunk, groups):
    """Each slot's slice of the folded DB, read and folded on its device,
    is the host _shard_db's slice of the JAX package's _fold_ref; all
    slots together are _fold_ref (keys >= 2^63 of no component: comp <<
    32 | code stays below 2^34), in JOIN_CHUNK pieces."""
    ref, _ = composite_dbs
    keys, rids, _ = jax_sc._fold_ref(ref)
    monkeypatch.setattr(composite, "JOIN_CHUNK", chunk)
    monkeypatch.setattr(index, "_OPEN_COMPONENTS", groups)
    per = -(-keys.size // n_shards)
    got_k, got_r = [], []
    for r in range(n_shards):
        pieces = list(sharded_composite._slot_db(ref, formats.read_co_stat(ref), r,
                                                 n_shards, CPU))
        assert all(k.numel() <= chunk for k, _ in pieces)
        k = (torch.cat([p[0] for p in pieces]) if pieces
             else torch.zeros(0, dtype=torch.int64))
        rid = (torch.cat([p[1] for p in pieces]) if pieces
               else torch.zeros(0, dtype=torch.int32))
        assert rid.dtype == torch.int32
        np.testing.assert_array_equal(k.numpy().view(np.uint64),
                                      keys[r * per:(r + 1) * per])
        np.testing.assert_array_equal(rid.numpy(), rids[r * per:(r + 1) * per])
        got_k.append(k)
        got_r.append(rid)
    np.testing.assert_array_equal(torch.cat(got_k).numpy().view(np.uint64), keys)
    np.testing.assert_array_equal(torch.cat(got_r).numpy(), rids)


@pytest.mark.parametrize("groups", [64, 2])
def test_composite_query_table_equals_fold_queries(composite_dbs, host_fold_refused,
                                                   monkeypatch, groups):
    """The query table made on the device equals the JAX package's
    _fold_queries: every code of the forged query sketch is there twice,
    the first occurrence (its abundance) is kept."""
    _, qry = composite_dbs
    monkeypatch.setattr(index, "_OPEN_COMPONENTS", groups)
    k, q, a = sharded_composite._fold_queries_device(qry, CPU)
    wk, wq, wa = jax_sc._fold_queries(qry)
    assert wk.size * 2 == sum(formats.read_combco(qry, c)[0].size for c in range(3))
    np.testing.assert_array_equal(k.numpy().view(np.uint64), wk)
    np.testing.assert_array_equal(q.numpy(), wq)
    np.testing.assert_array_equal(a.numpy().view(np.uint32), wa)


def test_composite_mesh_report_with_host_folds_refused(composite_dbs,
                                                       host_fold_refused):
    """The mesh report over 1, 3 and 4 slots equals the device route's on
    the DB whose codes reach 2^32 - 1, the host folds refused."""
    ref, qry = composite_dbs
    want = composite.species_abundance(ref, qry, device=CPU)
    assert want
    for n in (1, 3, 4):
        assert sharded_composite.species_abundance_sharded(
            ref, qry, _mesh(1, n)) == want


@pytest.mark.parametrize("block", [64, 1000])
def test_staging_fetch_into_place(block):
    """Staging.fetch lands a count block in its place in a strided view
    of a larger array, a piece of whole rows at a time, or column ranges
    of a row wider than a buffer."""
    st = staging.Staging(CPU, block, 3)
    src = torch.arange(9 * 70, dtype=torch.int32).reshape(9, 70) - 100
    out = np.full((12, 80), 5, np.uint32)
    st.fetch(src, out[2:11, 4:74])
    np.testing.assert_array_equal(out[2:11, 4:74].view(np.int32), src.numpy())
    out[2:11, 4:74] = 5
    assert (out == 5).all()
    wide = torch.arange(4 * 3, dtype=torch.int64).reshape(4, 3) << 40
    dst = np.zeros((4, 3), np.uint64)
    st.fetch(wide, dst)
    np.testing.assert_array_equal(dst.view(np.int64), wide.numpy())
    with pytest.raises(ValueError, match="cannot fetch"):
        st.fetch(src, np.zeros((9, 70), np.uint64))


def test_mesh_counts_into_a_memmap(indexes, tmp_path, host_fold_refused):
    """Batched (-m) mesh counts land in a memmap, each block in place,
    equal to the single-device counts of the same index."""
    d, bits = indexes["high keys"]
    qry = _sketch_dir(str(tmp_path / "q"), 5, 3, 1 << 32, 60, seed=2, koc=True)
    stat = formats.read_mco_stat(d)
    qstat = formats.read_co_stat(qry)
    assert qstat.comp_num == stat.comp_num
    _, comps = index.load_device_index(d, CPU)
    # plant reference codes so the counts are not all zero
    for c in range(3):
        rc, _ = formats.read_combco(d, c)
        qc, qi, qa = formats.read_combco(qry, c, with_abund=True)
        qc[::2] = rc[: qc[::2].size]
        parts = [np.unique(qc[int(qi[g]):int(qi[g + 1])]) for g in range(5)]
        qi = np.zeros(6, np.uint64)
        np.cumsum([p.size for p in parts], out=qi[1:])
        formats.write_combco(qry, c, np.concatenate(parts), qi, qa[:int(qi[-1])])
    from public_kssd_tpu_torch import search

    koc_want = np.zeros((5, stat.infile_num), np.uint64)
    want = search.compute_shared_counts(qry, comps, 5, CPU, koc_out=koc_want)
    assert want.sum() > 0
    for strategy in ("genome", "code"):
        out = np.memmap(str(tmp_path / f"{strategy}.dat"), dtype="<u4", mode="w+",
                        shape=want.shape)
        koc = np.full(want.shape, 3, np.uint64)
        sharded_search.sharded_search_counts(qry, d, bits, _mesh(2, 3), batch=2,
                                             counts_out=out, koc_out=koc,
                                             strategy=strategy)
        np.testing.assert_array_equal(out, want)
        np.testing.assert_array_equal(koc, koc_want)


def test_tiny_index_leaves_shards_empty(indexes):
    """A DB with fewer postings than shards: empty shards are valid
    indexes that count nothing."""
    d, bits = indexes["tiny"]
    db = sharded_search.device_shards(d, _mesh(1, 4), bits, "code")
    sizes = [db.index[(s, CPU)].uniq.numel() for s in range(4)]
    assert 0 in sizes and sum(sizes) == db.row_bounds[-1]


@pytest.mark.parametrize("fault", ["last offset", "offsets file one short"])
def test_device_shards_refuse_a_torn_sidecar(indexes, tmp_path, fault):
    """A sidecar whose offsets do not end at its postings, or whose
    offsets file is not one offset a code and one more, raises."""
    d = str(tmp_path / "torn")
    shutil.copytree(indexes["high keys"][0], d)
    path = index._csr_paths(d, 1)[1]
    if fault == "last offset":
        offsets = np.fromfile(path, "<u8")
        offsets[-1] += 1
        offsets.tofile(path)
    else:
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 8)
    for strategy in ("genome", "code"):
        with pytest.raises(ValueError, match="offsets"):
            sharded_search.device_shards(d, _mesh(1, 3), 32, strategy)
