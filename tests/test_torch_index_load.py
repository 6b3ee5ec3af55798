"""The search's index loader (``index.load_device_index``: the CSR files
read into staging buffers and uploaded as they are read) against the host
route (``DeviceIndex.from_sparse(load_sparse_index(...))``), tensor for
tensor, on the CPU: the goldens' indexes (one component at CSZ=7, sixteen
at CSZ=4), a seeded index with more keys than ``HOST_DIRECTORY_KEYS``,
an empty component and dense-only databases, at staging buffers smaller
than a file, not dividing it and larger than every file, on one and
three reading threads; the checks it shares with ``from_arrays``; and a
search and its CLI through it, byte-equal to the JAX package's and to
the golden."""

import os
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from conftest import assert_files_equal

from public_kssd_tpu import cli as jax_cli
from public_kssd_tpu_torch import cli, formats, index, search
from public_kssd_tpu_torch.ops import count

torch.set_num_threads(1)

CPU = torch.device("cpu")
FIELDS = ("uniq", "offsets", "gids", "dir")


def _write_refs(d: str, per_comp: list[np.ndarray], n_ref: int) -> None:
    """A sketch dir of ``n_ref`` genomes: component c holds the codes
    ``per_comp[c]`` (uint32 [n_ref, k]), k codes a genome."""
    os.makedirs(d)
    for c, codes in enumerate(per_comp):
        idx = np.arange(n_ref + 1, dtype=np.uint64) * codes.shape[1]
        formats.write_combco(d, c, codes.ravel(), idx)
    total = sum(int(c.size) for c in per_comp)
    formats.write_co_stat(d, formats.CoStat(
        params_id=5, koc=False, kmerlen=16, dim_rd_len=4,
        comp_num=len(per_comp), infile_num=n_ref, all_ctx_ct=total,
        ctx_ct=np.full(n_ref, total // n_ref, np.uint32),
        names=[f"r{i}" for i in range(n_ref)]))


@pytest.fixture(scope="module")
def dbs(golden7, golden4, tmp_path_factory):
    """Index dirs with the CSR sidecar: the goldens' references (csz7 one
    component, csz4 sixteen), a seeded one of 300 x 400 codes (~120k keys:
    its directory is built on the device) and one whose second component
    is empty."""
    root = str(tmp_path_factory.mktemp("index_load"))
    out = {}
    for name, gold, csz in (("csz7", golden7, 7), ("csz4", golden4, 4)):
        index.run_stage2(f"{gold}/ref_co", f"{root}/{name}", csz, dense=False)
        out[name] = f"{root}/{name}"
    rng = np.random.default_rng(17)
    big = np.sort(rng.integers(0, 1 << 28, (300, 400)).astype(np.uint32), axis=1)
    _write_refs(f"{root}/seeded_co", [big], 300)
    small = np.sort(rng.integers(0, 1 << 20, (40, 64)).astype(np.uint32), axis=1)
    _write_refs(f"{root}/empty_co", [small, small[:, :0]], 40)
    for name in ("seeded", "empty"):
        index.run_stage2(f"{root}/{name}_co", f"{root}/{name}", 7, dense=False)
        out[name] = f"{root}/{name}"
    assert count.DeviceIndex.from_sparse(
        index.load_sparse_index(out["seeded"])[1][0], CPU
    ).uniq.numel() > count.HOST_DIRECTORY_KEYS
    assert os.path.getsize(f"{out['empty']}/mco.uniq.1") == 0
    return out


def _host_route(mco_dir):
    stat, comps = index.load_sparse_index(mco_dir)
    return stat, [count.DeviceIndex.from_sparse(sp, CPU) for sp in comps]


def _assert_same(got, want):
    assert len(got) == len(want)
    for c, (a, b) in enumerate(zip(got, want)):
        for f in FIELDS:
            ta, tb = getattr(a, f), getattr(b, f)
            assert ta.dtype == tb.dtype and torch.equal(ta, tb), (c, f)
        assert (a.dir_shift, a.n_ref, a.device) == (b.dir_shift, b.n_ref, b.device), c


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("block", [64, 1000, 1 << 24])
@pytest.mark.parametrize("db", ["csz7", "csz4", "seeded", "empty"])
def test_device_index_equals_host_route(dbs, monkeypatch, db, block, threads):
    """Buffers of 64 bytes divide every file into many pieces, 1000 bytes
    into pieces that do not divide it, 16 MiB hold every file whole."""
    stat_want, want = _host_route(dbs[db])
    monkeypatch.setattr(index, "INDEX_BLOCK", block)
    monkeypatch.setattr(index, "INDEX_READ_THREADS", threads)
    stat, got = index.load_device_index(dbs[db], CPU)
    assert (stat.infile_num, stat.comp_num, stat.names) == (
        stat_want.infile_num, stat_want.comp_num, stat_want.names)
    _assert_same(got, want)


def test_concurrent_loads_share_readers_and_staging(dbs, monkeypatch):
    """Loads on more threads than CPUs, in pieces of 4000 bytes (a few
    hundred a load), the interpreter switching threads every microsecond:
    the reader pool and the staging sets are shared safely, and every
    load is the host route's index."""
    _, want = _host_route(dbs["seeded"])
    monkeypatch.setattr(index, "INDEX_BLOCK", 4000)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(2 * (os.cpu_count() or 4)) as pool:
            loads = [pool.submit(index.load_device_index, dbs["seeded"], CPU)
                     for _ in range(16)]
            got = [f.result(timeout=120)[1] for f in loads]
    finally:
        sys.setswitchinterval(old)
    for comps in got:
        _assert_same(comps, want)


@pytest.fixture(scope="module")
def dense4(golden4, tmp_path_factory):
    """The CSZ=4 golden's references indexed with the dense export too."""
    d = str(tmp_path_factory.mktemp("dense4") / "ref")
    index.run_stage2(f"{golden4}/ref_co", d, 4, dense=True)
    return d


@pytest.mark.parametrize("open_components", [64, 3])
@pytest.mark.parametrize("dense_only", ["all", "even"])
def test_dense_only_components_load(dense4, tmp_path, monkeypatch, dense_only,
                                    open_components):
    """A database without the sidecar (as the reference binary builds
    it), or with it for only some components, loads each component from
    the dense rows, as the host route does; in one batch of open files
    or in batches of three components."""
    d = str(tmp_path / "dense")
    shutil.copytree(dense4, d)
    for c in range(16):
        if dense_only == "all" or c % 2 == 0:
            for p in index._csr_paths(d, c):
                os.remove(p)
    _, want = _host_route(d)
    monkeypatch.setattr(index, "_OPEN_COMPONENTS", open_components)
    _, got = index.load_device_index(d, CPU)
    _assert_same(got, want)


def test_missing_postings_file_raises_and_no_file_stays_open(dbs, tmp_path):
    """A sidecar whose mco.<c> is missing raises FileNotFoundError on
    both routes, and the loader leaves no file open, on success or not."""
    d = str(tmp_path / "no_postings")
    shutil.copytree(dbs["csz4"], d)
    os.remove(f"{d}/mco.5")
    with pytest.raises(FileNotFoundError):
        index.load_sparse_index(d)
    index.load_device_index(dbs["csz4"], CPU)  # the reader threads start
    open_fds = len(os.listdir("/proc/self/fd"))
    with pytest.raises(FileNotFoundError):
        index.load_device_index(d, CPU)
    index.load_device_index(dbs["csz4"], CPU)
    assert len(os.listdir("/proc/self/fd")) == open_fds


def test_device_route_makes_no_host_copy(dbs, monkeypatch):
    """The loader reads no index file (mco.<c>, mco.uniq.<c>,
    mco.csroff.<c>) with np.fromfile and calls no host loader: the files
    go through the staging buffers."""
    want = {db: _host_route(dbs[db])[1] for db in ("csz4", "seeded")}
    fromfile = np.fromfile

    def refuse(*args, **kwargs):
        raise AssertionError("a host copy of the index was made")

    def guarded(file, *args, **kwargs):
        if os.path.basename(getattr(file, "name", file)).startswith("mco."):
            refuse()
        return fromfile(file, *args, **kwargs)

    monkeypatch.setattr(np, "fromfile", guarded)
    monkeypatch.setattr(index, "load_sparse_index", refuse)
    for db, comps in want.items():
        _assert_same(index.load_device_index(dbs[db], CPU)[1], comps)


def _corrupt(dbs, tmp_path, case):
    d = str(tmp_path / case)
    shutil.copytree(dbs["seeded"], d)
    if case == "gids_2^31":
        gids = np.fromfile(f"{d}/mco.0", "<u4")
        gids[3] = np.uint32(1 << 31)
        gids.tofile(f"{d}/mco.0")
    elif case == "offsets_2^63":
        offs = np.fromfile(f"{d}/mco.csroff.0", "<u8")
        offs[-1] = np.uint64(1 << 63)
        offs.tofile(f"{d}/mco.csroff.0")
    else:  # a postings file cut inside a value
        with open(f"{d}/mco.0", "ab") as f:
            f.write(b"\x01")
    return d


@pytest.mark.parametrize("case,match", [
    ("gids_2^31", "genome ids"), ("offsets_2^63", "postings total"),
])
def test_out_of_range_refused_as_from_arrays(dbs, tmp_path, case, match):
    """A genome id >= 2^31 and a postings total >= 2^63 raise the
    ValueError that from_arrays raises, through the same checks."""
    d = _corrupt(dbs, tmp_path, case)
    with pytest.raises(ValueError, match=match):
        _host_route(d)
    with pytest.raises(ValueError, match=match):
        index.load_device_index(d, CPU)


def test_torn_postings_file_refused(dbs, tmp_path):
    """A file that is not a whole number of values is refused."""
    with pytest.raises(ValueError, match="not a whole number"):
        index.load_device_index(_corrupt(dbs, tmp_path, "torn"), CPU)


def test_loaded_components_count_like_the_host_index(golden4, dbs):
    """compute_shared_counts takes the loaded DeviceIndex components as
    they are (from_sparse returns them; n_genomes reads n_ref) and gives
    the host oracle's counts; an index on another device is refused."""
    stat, sparse = index.load_sparse_index(dbs["csz4"])
    _, loaded = index.load_device_index(dbs["csz4"], CPU)
    qry = f"{golden4}/qry_co"
    n_qry = formats.read_co_stat(qry).infile_num
    want = search.compute_shared_counts(qry, sparse, n_qry, None)
    got = search.compute_shared_counts(qry, loaded, n_qry, CPU)
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0 and loaded[0].n_genomes == stat.infile_num
    assert count.DeviceIndex.from_sparse(loaded[0], CPU) is loaded[0]
    with pytest.raises(ValueError, match="not meta"):
        count.DeviceIndex.from_sparse(loaded[0], torch.device("meta"))


def test_loader_refuses_a_missing_card(dbs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the loader runs there")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        index.load_device_index(dbs["csz7"], "cuda")


def test_cli_search_through_the_loader_matches_jax_and_golden(
    golden7, tmp_path, monkeypatch
):
    """dist -r ref -o out qry --device cpu on the golden's references
    (indexed by the port) loads the index on the device route only, and
    writes the JAX package's CLI bytes on the same dirs and the golden's."""
    ref = str(tmp_path / "ref")
    shutil.copytree(f"{golden7}/ref_co", ref)
    index.run_stage2(ref, ref, 7, dense=False)
    qry = f"{golden7}/qry_co"
    assert jax_cli.main(["dist", "-r", ref, "-o", str(tmp_path / "jax"), qry]) == 0

    def refuse(*args, **kwargs):
        raise AssertionError("the search loaded the index on the host route")

    monkeypatch.setattr(index, "load_sparse_index", refuse)
    out = str(tmp_path / "torch")
    assert cli.main(["dist", "-r", ref, "-o", out, qry, "--device", "cpu"]) == 0
    assert_files_equal(f"{tmp_path}/jax/distance.out", f"{out}/distance.out")
    assert_files_equal(f"{golden7}/distout/distance.out", f"{out}/distance.out")
