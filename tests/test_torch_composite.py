"""The port's composite (species abundance, .abv vectors, index and
search) against the reference goldens (tests/golden/) and the JAX
package, on the CPU: the host oracle (device=None) and the plain PyTorch
version of the join kernel (device=cpu), over the stage II inverted
index and over raw DB codes. Exact equality (the report is built from
integer aggregates) except the dense .abv search, which sums float32 in
another order than XLA: rtol 1e-5."""

import glob
import os
import shutil

import numpy as np
import pytest
import torch

from conftest import assert_files_equal
from test_composite_scale import _mk_db

from public_kssd_tpu import cli as jax_cli
from public_kssd_tpu import composite as jax_composite
from public_kssd_tpu import index as jax_index
from public_kssd_tpu_torch import cli, composite, formats, index

torch.set_num_threads(1)

CPU = torch.device("cpu")
REPORTS = (("fq_koc", "composite_report.txt"),
           ("deep_koc", "composite_deep_report.txt"))
# (route, device): the host oracle, the raw-code join and the CSR join
BACKENDS = [("host", None), ("raw", CPU), ("csr", CPU)]


@pytest.fixture(scope="module")
def gold(golden7, tmp_path_factory):
    """The golden composite inputs and outputs, copied: ``raw`` is the
    reference's ref_co (no CSR sidecar), ``csr`` the same sketches
    indexed by the port's stage II (sidecar present)."""
    root = str(tmp_path_factory.mktemp("composite_gold"))
    for d in ("ref_co", "fq_koc", "deep_koc"):
        shutil.copytree(f"{golden7}/{d}", f"{root}/{d}")
    for f in ("abv_dump.txt", "abv_s0.txt", "abv_s1.txt", "abv_s2.txt",
              *(r for _, r in REPORTS)):
        shutil.copy(f"{golden7}/{f}", f"{root}/{f}")
    for route in ("raw", "host", "csr"):
        shutil.copytree(f"{root}/ref_co", f"{root}/{route}",
                        ignore=shutil.ignore_patterns("abundance_Vec*"))
    index.run_stage2(f"{root}/csr", f"{root}/csr", 7, dense=False)
    return root


def _read(path):
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("route,device", BACKENDS)
def test_composite_report_matches_golden(gold, route, device, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the CSR route loaded its index on the host")

    # the CSR route reads its index straight onto the device
    monkeypatch.setattr(index, "load_sparse_index", refuse)
    for qdir, report in REPORTS:
        got = composite.species_abundance(f"{gold}/{route}", f"{gold}/{qdir}",
                                          device=device)
        assert got == _read(f"{gold}/{report}") and got, report


@pytest.mark.parametrize("route,device", BACKENDS)
def test_composite_binvec_index_search_match_golden(gold, route, device):
    """-b .abv files, then -i and -s 0|1|2 over them, and -d."""
    ref = f"{gold}/{route}"
    abv_dir = f"{ref}/{composite.BINVEC_DIRNAME}"
    for qdir, _ in REPORTS:
        composite.species_abundance(ref, f"{gold}/{qdir}", binvec=True,
                                    device=device)
    want = sorted(glob.glob(f"{gold}/ref_co/{composite.BINVEC_DIRNAME}/*.abv"))
    assert sorted(os.listdir(abv_dir)) == [os.path.basename(f) for f in want]
    for f in want:
        assert_files_equal(f, f"{abv_dir}/{os.path.basename(f)}")
    assert composite.read_abv_text([f"{abv_dir}/deep.fq.gz.abv"]) == _read(
        f"{gold}/abv_dump.txt"
    )
    composite.index_abv(ref)
    for mode in (0, 1, 2):
        got = composite.abv_search(ref, ["deep.fq.gz.abv"], mode)
        assert got == _read(f"{gold}/abv_s{mode}.txt"), mode


@pytest.mark.parametrize(
    "n_ref,sk,n_qry,seed,space,chunk",
    [
        (300, 64, 2, 7, 1 << 16, None),  # dense hits
        (40, 64, 3, 3, 1 << 20, None),
        (40, 64, 2, 5, 1 << 20, 1 << 10),  # chunk tail
        (64, 48, 3, 11, 1 << 32, 1 << 9),  # codes >= 2^31
    ],
)
@pytest.mark.parametrize("route", ["raw", "csr"])
def test_species_abundance_matches_jax_device_join(
    tmp_path, monkeypatch, route, n_ref, sk, n_qry, seed, space, chunk
):
    ref_dir, qry_dir, *_ = _mk_db(tmp_path, n_ref=n_ref, sk=sk, n_qry=n_qry,
                                  seed=seed, space=space)
    if chunk:
        monkeypatch.setattr(composite, "JOIN_CHUNK", chunk)
        monkeypatch.setattr(jax_composite, "JOIN_CHUNK", chunk)
    if route == "csr":
        index.run_stage2(ref_dir, ref_dir, 7, dense=False)
    want = jax_composite.species_abundance(ref_dir, qry_dir, device=True)
    assert want == jax_composite.species_abundance(ref_dir, qry_dir,
                                                   device=False)
    out_t, out_j = str(tmp_path / "abv_t"), str(tmp_path / "abv_j")
    got = composite.species_abundance(ref_dir, qry_dir, device=CPU)
    assert got == want and want.count("\n") >= n_qry
    assert composite.species_abundance(ref_dir, qry_dir, device=None) == want
    composite.species_abundance(ref_dir, qry_dir, out_t, binvec=True,
                                device=CPU)
    jax_composite.species_abundance(ref_dir, qry_dir, out_j, binvec=True,
                                    device=True)
    names = sorted(os.listdir(out_j))
    assert names and sorted(os.listdir(out_t)) == names
    for n in names:
        assert_files_equal(f"{out_j}/{n}", f"{out_t}/{n}", n)


def test_csr_route_shares_the_search_index(tmp_path):
    """Given SparseIndex components, the join runs over their cached
    device form (the one search uploads), and gives the host bytes."""
    from public_kssd_tpu_torch.ops import count

    ref_dir, qry_dir, *_ = _mk_db(tmp_path, n_ref=40, sk=64, n_qry=3, seed=3)
    codes, idx = formats.read_combco(ref_dir, 0)
    sp = index.build_component_index(codes, idx, 40)
    dev = count.DeviceIndex.from_sparse(sp, CPU)
    got = composite.species_abundance(ref_dir, qry_dir, device=CPU,
                                      ref_components=[sp])
    assert count.DeviceIndex.from_sparse(sp, CPU) is dev
    assert got == composite.species_abundance(ref_dir, qry_dir, device=None) and got


def test_species_abundance_rejects_plain_query(gold):
    with pytest.raises(ValueError, match="abundance"):
        composite.species_abundance(f"{gold}/raw", f"{gold}/raw", device=CPU)


def _table(qc, qi, qa, n_qry):
    """The padded query table (the JAX join's input) and its unpadded
    int32 tensors (the port's)."""
    tab = composite._query_table(qc, qi, qa, n_qry)
    sq, sqid, sab, n = tab
    t = tuple(torch.from_numpy(a[:n].astype(np.uint32).view(np.int32))
              for a in (sq, sqid, sab))
    return tab, t


def _join_db(seed, space, n_ref=50, sk=80, n_qry=4, hot=False):
    """Random DB + koc queries with planted hits, a duplicated code in
    query 0 and the code 0xFFFFFFFF (the query table's pad value) in a
    reference and in query 1. ``hot``: one more code that every
    reference and every query holds (a hot row: n_qry x n_ref keys)."""
    rng = np.random.default_rng(seed)
    ref = [np.unique(rng.integers(0, space, sk, dtype=np.uint64))
           for _ in range(n_ref)]
    ref[3] = np.union1d(ref[3], [(1 << 32) - 1])
    hot_code = (1 << 31) + 12345
    if hot:
        ref = [np.union1d(r, [hot_code]) for r in ref]
    codes = np.concatenate(ref).astype(np.uint32)
    ridx = np.zeros(n_ref + 1, np.uint64)
    np.cumsum([r.size for r in ref], out=ridx[1:])
    qs = []
    for q in range(n_qry):
        c = rng.integers(0, space, 3 * sk, dtype=np.uint64)
        hit = rng.random(c.size) < 0.4
        c[hit] = codes[rng.integers(0, codes.size, int(hit.sum()))]
        if q == 0:
            c = np.concatenate([c, c[:5]])  # duplicates: first one kept
        if q == 1:
            c = np.concatenate([c, [(1 << 32) - 1]])
        if hot:
            c = np.concatenate([c, [hot_code]])
        qs.append(c.astype(np.uint32))
    qidx = np.zeros(n_qry + 1, np.uint64)
    np.cumsum([q.size for q in qs], out=qidx[1:])
    qc = np.concatenate(qs)
    qa = rng.integers(1, 1 << 16, qc.size).astype(np.uint16)
    return codes, ridx, qc, qidx, qa


def _valid_sorted(buf, n_qry, shift):
    keys = np.asarray(buf)[:-1]
    assert int(np.asarray(buf)[-1]) <= keys.size  # capacity held every hit
    return np.sort(keys[keys < (np.int64(n_qry) << shift)])


@pytest.mark.parametrize(
    "seed,space,hot", [(1, 1 << 12, False), (2, 1 << 32, False), (3, 1 << 32, True)],
    ids=["1-4096", "2-4294967296", "hot-row"],
)
def test_join_plain_matches_jax_joins(seed, space, hot):
    """join_torch's keys equal the valid keys of the JAX package's CSR
    and raw-code joins (XLA on the CPU backend); the hot row's keys come
    in the kernel's order: query entry outer, posting inner."""
    import jax.numpy as jnp

    n_ref, n_qry = 50, 4
    codes, ridx, qc, qidx, qa = _join_db(seed, space, n_ref, n_qry=n_qry,
                                         hot=hot)
    shift = 16 + n_ref.bit_length()
    (sq, sqid, sab, n), (tsq, tsqid, tsab) = _table(qc, qidx, qa, n_qry)
    kw = dict(n_qry=n_qry, n_ref=n_ref, qid_shift=shift, cap=1 << 16)
    jargs = tuple(jnp.asarray(a) for a in (sq, sqid, sab))

    sp = jax_index.build_component_index(codes, ridx, n_ref)
    want = _valid_sorted(jax_composite._csr_join_fn()(
        jnp.asarray(sp.uniq_codes), jnp.asarray(sp.offsets),
        jnp.asarray(sp.gids), *jargs, **kw), n_qry, shift)
    got = composite.join_torch(
        torch.from_numpy(sp.uniq_codes.view(np.int32)),
        torch.from_numpy(sp.offsets.astype(np.int64)),
        torch.from_numpy(sp.gids.astype(np.int32)),
        tsq, tsqid, tsab, shift,
    )
    assert got.numel() == want.size > 0
    np.testing.assert_array_equal(np.sort(got.numpy()), want)
    assert (got.numpy() >> shift == 1).any() and got.min() >= 0

    rid = np.searchsorted(ridx[1:], np.arange(codes.size, dtype=np.uint64),
                          "right").astype(np.int32)
    want_raw = _valid_sorted(jax_composite._batched_join_fn()(
        jnp.asarray(codes), jnp.asarray(rid), *jargs, **kw), n_qry, shift)
    got_raw = composite.join_torch(
        torch.from_numpy(codes.view(np.int32)), None, torch.from_numpy(rid),
        tsq, tsqid, tsab, shift,
    )
    np.testing.assert_array_equal(np.sort(got_raw.numpy()), want_raw)
    np.testing.assert_array_equal(want_raw, want)  # a set of codes per ref
    if hot:  # the hot row's keys: its n_qry entries x its n_ref postings
        h = np.searchsorted(sp.uniq_codes, (1 << 31) + 12345)
        assert sp.offsets[h + 1] - sp.offsets[h] == n_ref
        start = int(np.searchsorted(sq[:n], (1 << 31) + 12345))
        keys_before = composite.join_torch(
            torch.from_numpy(sp.uniq_codes[:h].view(np.int32)),
            torch.from_numpy(sp.offsets[: h + 1].astype(np.int64)),
            torch.from_numpy(sp.gids.astype(np.int32)), tsq, tsqid, tsab, shift,
        ).numel()
        hot_keys = got.numpy()[keys_before: keys_before + n_qry * n_ref]
        entries = np.arange(start, start + n_qry)
        gids = sp.gids[sp.offsets[h]: sp.offsets[h + 1]].astype(np.int64)
        want_hot = ((sqid[entries, None].astype(np.int64) << shift)
                    | (gids[None, :] << 16) | sab[entries, None].astype(np.int64))
        np.testing.assert_array_equal(hot_keys, want_hot.ravel())


def test_join_wrapper_order_and_limit(monkeypatch):
    """The CPU wrapper is the plain version; keys come row-major (query
    entry outer, posting inner); a chunk past the hit limit raises the
    JAX package's MemoryError."""
    u = torch.tensor([5, 9, 7], dtype=torch.int32)
    offs = torch.tensor([0, 2, 3, 5], dtype=torch.int64)
    gids = torch.tensor([1, 4, 0, 2, 3], dtype=torch.int32)
    sq = torch.tensor([5, 5, 7], dtype=torch.int32)
    sqid = torch.tensor([0, 1, 1], dtype=torch.int32)
    sab = torch.tensor([10, 20, 30], dtype=torch.int32)
    got = composite.join_kernel(u, offs, gids, sq, sqid, sab, 20).tolist()
    assert got == [
        (0 << 20) | (1 << 16) | 10, (0 << 20) | (4 << 16) | 10,
        (1 << 20) | (1 << 16) | 20, (1 << 20) | (4 << 16) | 20,
        (1 << 20) | (2 << 16) | 30, (1 << 20) | (3 << 16) | 30,
    ]
    directory = composite.query_directory(sq, 7)
    assert composite.join_kernel(u, offs, gids, sq, sqid, sab, 20,
                                 directory).tolist() == got
    monkeypatch.setattr(composite, "MAX_CHUNK_HITS", 5)
    with pytest.raises(MemoryError, match="expansion limit"):
        composite.join_kernel(u, offs, gids, sq, sqid, sab, 20)


def _directory_table(case):
    """(unsigned ascending table keys, (dir, shift)) as the join's callers
    build them: ``_query_table_device`` for uint32 codes,
    ``query_directory`` over folded uint64 keys for the mesh join."""
    from public_kssd_tpu_torch.ops import count

    if case == "uint64 keys >= 2^63":
        rng = np.random.default_rng(8)
        codes = np.sort(rng.integers(0, 1 << 28, 3000, dtype=np.uint64))
        keys = (np.repeat(codes, 3) << np.uint64(36)) | np.uint64(7)  # 3 queries a code
        return keys, composite.query_directory(count._key_view(keys), int(keys[-1]))
    if case == "uint32 codes":
        _, _, qc, qidx, qa = _join_db(2, 1 << 32)
        n_qry = 4
    elif case == "one entry":
        qc, qidx, qa = (np.array([0x9ABCDEF0], np.uint32), np.array([0, 1], np.uint64),
                        np.array([7], np.uint16))
        n_qry = 1
    else:  # an empty table
        qc, qidx, qa = (np.zeros(0, np.uint32), np.zeros(3, np.uint64),
                        np.zeros(0, np.uint16))
        n_qry = 2
    sq, _, _, directory = composite._query_table_device(qc, qidx, qa, n_qry, CPU)
    return sq.numpy().view(np.uint32), directory


@pytest.mark.parametrize(
    "case", ["uint32 codes", "uint64 keys >= 2^63", "one entry", "empty table"]
)
def test_query_directory_matches_numpy(case):
    """Exact: the join's directory has 2^(bit_length(n_q) + 1) buckets (at
    most the largest key's bit length), equals np.searchsorted of every bucket
    boundary b << shift, and holds every table key's run of equal
    entries inside its bucket dir[b] .. dir[b + 1]."""
    from test_torch_count import _directory_want

    keys, (directory, shift) = _directory_table(case)
    d = directory.numpy()
    top = int(keys[-1]).bit_length() if keys.size else 0
    bits = min(keys.size.bit_length() + 1, top)
    want, want_shift = _directory_want(keys, bits, keys.dtype.itemsize * 8)
    assert shift == want_shift and directory.dtype == torch.int32
    np.testing.assert_array_equal(d, want)
    if case == "uint32 codes":
        # 0.25-0.5 entries a bucket
        assert keys[-1] == 0xFFFFFFFF and keys.size >> (bits - 2) == 1
    if case == "uint64 keys >= 2^63":
        assert (keys >= np.uint64(1 << 63)).any() and (keys < np.uint64(1 << 63)).any()
    b = np.array([int(k) >> shift if shift < 64 else 0 for k in keys.tolist()],
                 np.int64)
    assert (d[b] <= np.searchsorted(keys, keys, "left")).all()
    assert (np.searchsorted(keys, keys, "right") <= d[b + 1]).all()


@pytest.mark.parametrize("n_q", [1000, 70_000])
def test_query_directory_small_table_builds_on_host(monkeypatch, n_q):
    """A table of up to HOST_DIRECTORY_KEYS entries builds its directory
    from the host copy, a larger one from the device table; either way it
    is the same directory, on the device table's device, int32."""
    from public_kssd_tpu_torch.ops import count

    keys = np.sort(np.random.default_rng(9).integers(0, 1 << 32, n_q, dtype=np.uint64))
    sq, host_sq = count._u32_view(keys), count._u32_view(keys)
    seen = []
    build = count.bucket_directory
    monkeypatch.setattr(count, "bucket_directory",
                        lambda t, *a: seen.append(t) or build(t, *a))
    directory, shift = composite.query_directory(sq, int(keys[-1]), host_sq)
    assert seen[0] is (host_sq if n_q <= count.HOST_DIRECTORY_KEYS else sq)
    want, want_shift = composite.query_directory(sq, int(keys[-1]))
    assert shift == want_shift and directory.dtype == torch.int32
    assert directory.device == sq.device and torch.equal(directory, want)


def test_hit_key_width_guard():
    composite._check_key_width(16 + 20, 1000)
    with pytest.raises(ValueError, match="hit-key overflow"):
        composite._check_key_width(16 + 33, 1 << 30)


def _measures(text):
    """{sample: value} of an .abv search report, plus its header lines."""
    rows = [ln.split("\t") for ln in text.splitlines() if not ln.startswith("#")]
    return {a: float(b) for a, b in rows}, [
        ln for ln in text.splitlines() if ln.startswith("#")
    ]


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_abv_search_device_matches_jax(gold, mode):
    ref = f"{gold}/ref_co"  # the golden abundance_Vec index
    qs = sorted(os.path.basename(f) for f in
                glob.glob(f"{ref}/{composite.BINVEC_DIRNAME}/*.abv"))
    got, got_h = _measures(composite.abv_search_device(ref, qs, mode, CPU))
    want, want_h = _measures(jax_composite.abv_search_device(ref, qs, mode))
    assert got_h == want_h and len(got_h) == len(qs)
    assert got.keys() == want.keys() and got
    for name, v in want.items():
        assert got[name] == pytest.approx(v, rel=1e-5, abs=1e-6), name


# ---------------------------------------------------------------- CLI


def _run(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


def test_cli_composite_matches_kssd_tpu(gold, tmp_path, capsys):
    """-q, -q -b, -i, -s 0|1|2 (host walk and --device-search) and -d
    through both CLIs."""
    refs = {}
    for tag in ("jax", "torch"):
        refs[tag] = str(tmp_path / f"{tag}_ref")
        shutil.copytree(f"{gold}/csr", refs[tag])
    out = {}
    for main, tag, extra in ((jax_cli.main, "jax", []),
                             (cli.main, "torch", ["--device", "cpu"])):
        ref = refs[tag]
        o = out[tag] = {}
        for qdir, _ in REPORTS:
            o[qdir] = _run(main, ["composite", "-r", ref, "-q",
                                  f"{gold}/{qdir}", *extra], capsys)
            o[qdir + "-b"] = _run(main, ["composite", "-r", ref, "-q",
                                         f"{gold}/{qdir}", "-b", *extra],
                                  capsys)
        o["-i"] = _run(main, ["composite", "-r", ref, "-i", *extra], capsys)
        for mode in "012":
            o[f"-s{mode}"] = _run(main, ["composite", "-r", ref, "-s", mode,
                                         "deep.fq.gz.abv", *extra], capsys)
            o[f"-s{mode}dev"] = _run(main, [
                "composite", "-r", ref, "-s", mode, "--device-search",
                "deep.fq.gz.abv", "reads0.fq.gz.abv", *extra], capsys)
        o["-d"] = _run(main, ["composite", "-d",
                              f"{ref}/abundance_Vec/deep.fq.gz.abv"], capsys)
    for key, text in out["jax"].items():
        if key.endswith("dev"):
            got, got_h = _measures(out["torch"][key])
            want, want_h = _measures(text)
            assert got_h == want_h and got.keys() == want.keys() and got
            for name, v in want.items():
                assert got[name] == pytest.approx(v, rel=1e-5, abs=1e-6)
        else:
            assert out["torch"][key] == text, key
    for qdir, report in REPORTS:
        assert out["torch"][qdir] == _read(f"{gold}/{report}")
    for mode in "012":
        assert out["torch"][f"-s{mode}"] == _read(f"{gold}/abv_s{mode}.txt")
    assert out["torch"]["-d"] == _read(f"{gold}/abv_dump.txt")
    base = composite.BINVEC_DIRNAME
    files = sorted(os.listdir(f"{refs['jax']}/{base}"))
    assert len(files) == 3
    for rel in [f"{base}/{f}" for f in files] + [
        f"{base}.{x}" for x in ("name", "yl2n", "abm", "abmi")
    ]:
        assert_files_equal(f"{refs['jax']}/{rel}", f"{refs['torch']}/{rel}",
                           rel)


def test_cli_composite_mesh_refused(gold, capsys):
    """composite --mesh refuses a spec that names no device; a valid one
    prints the golden report (parallel/sharded_composite)."""
    argv = ["composite", "-r", f"{gold}/csr", "-q", f"{gold}/fq_koc",
            "--device", "cpu", "--mesh"]
    for bad in ("0", "x"):
        with pytest.raises(SystemExit, match="--mesh"):
            cli.main([*argv, bad])
    assert cli.main([*argv, "2"]) == 0
    assert capsys.readouterr().out == _read(f"{gold}/composite_report.txt")


def test_cli_composite_default_device_raises_without_card(gold):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["composite", "-r", f"{gold}/csr", "-q", f"{gold}/fq_koc"])
