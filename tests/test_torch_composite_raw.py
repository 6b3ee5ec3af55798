"""composite's raw route with its DB on the device: the reader
(``composite._raw_device_components``, over ``index.combco_on_device``)
and the genome ids made from the combco index there
(``composite._genome_ids``, a join chunk at a time) against the host's
``_raw_components`` and its ``rid_of``, on CPU tensors, where the same
torch calls run as on a card; then the route's reports against the JAX
package's host oracle, with the host's DB read refused. Databases with
genomes without codes (first, in the middle, last), codes at and above
2^31, two components, and join chunks whose edges fall inside
genomes."""

import os

import numpy as np
import pytest
import torch

from conftest import assert_files_equal

from public_kssd_tpu import composite as jax_composite
from public_kssd_tpu_torch import composite, formats, index

torch.set_num_threads(1)

CPU = torch.device("cpu")

CASES = ["genomes without codes", "codes at and above 2^31", "two components",
         "chunk edges inside genomes"]


def _write_db(root, case, n_qry=3):
    """(ref_dir, qry_dir, comp_num) of a seeded DB of ``case`` and koc
    samples drawn from a few of its genomes, each sample a set of codes
    a component, with abundances."""
    rng = np.random.default_rng(CASES.index(case) + 61)
    n_ref = 40
    comp_num = 2 if case == "two components" else 1
    space = 1 << 32 if case == "codes at and above 2^31" else 1 << 16
    ref_dir, qry_dir = str(root / "ref"), str(root / "qry")
    os.makedirs(ref_dir)
    os.makedirs(qry_dir)
    total = 0
    genomes = []
    for c in range(comp_num):
        sizes = rng.integers(20, 120, n_ref)
        if case == "genomes without codes":
            sizes[[0, 5, 6, 20, n_ref - 2, n_ref - 1]] = 0
        gs = [np.unique(rng.integers(0, space, s, dtype=np.uint64))
              .astype(np.uint32) for s in sizes]
        genomes.append(gs)
        idx = np.zeros(n_ref + 1, np.uint64)
        np.cumsum([g.size for g in gs], out=idx[1:])
        formats.write_combco(ref_dir, c, np.concatenate(gs), idx)
        total += int(idx[-1])
    formats.write_co_stat(ref_dir, formats.CoStat(
        params_id=5, koc=False, kmerlen=16, dim_rd_len=4, comp_num=comp_num,
        infile_num=n_ref, all_ctx_ct=total,
        ctx_ct=np.ones(n_ref, np.uint32), names=[f"r{i}" for i in range(n_ref)]))
    for c in range(comp_num):
        qs = []
        for _ in range(n_qry):
            picks = rng.choice(n_ref, 6, replace=False)
            pool = np.concatenate([genomes[c][p] for p in picks])
            noise = rng.integers(0, space, 40, dtype=np.uint64).astype(np.uint32)
            qs.append(rng.permutation(np.unique(np.concatenate([pool, noise]))))
        qi = np.zeros(n_qry + 1, np.uint64)
        np.cumsum([q.size for q in qs], out=qi[1:])
        qc = np.concatenate(qs).astype(np.uint32)
        formats.write_combco(qry_dir, c, qc, qi,
                             rng.integers(1, 60, qc.size).astype(np.uint16))
    formats.write_co_stat(qry_dir, formats.CoStat(
        params_id=5, koc=True, kmerlen=16, dim_rd_len=4, comp_num=comp_num,
        infile_num=n_qry, all_ctx_ct=0, ctx_ct=np.ones(n_qry, np.uint32),
        names=[f"q{i}" for i in range(n_qry)]))
    return ref_dir, qry_dir, comp_num


def _chunk(monkeypatch, case):
    if case == "chunk edges inside genomes":
        monkeypatch.setattr(composite, "JOIN_CHUNK", 37)
    return composite.JOIN_CHUNK


@pytest.mark.parametrize("block", [64, 1000, 1 << 24])
@pytest.mark.parametrize("case", CASES)
def test_genome_ids_match_rid_of(tmp_path, monkeypatch, case, block):
    """The reader's codes and query arrays equal ``_raw_components``'s,
    and the genome ids made a join chunk at a time equal its ``rid_of``,
    with the DB streamed through staging buffers of 64 B, 1000 B (both
    smaller than it) and 16 MiB."""
    ref_dir, qry_dir, comp_num = _write_db(tmp_path, case)
    chunk = _chunk(monkeypatch, case)
    monkeypatch.setattr(index, "INDEX_BLOCK", block)
    host = composite._raw_components(ref_dir, qry_dir, comp_num)
    dev = composite._raw_device_components(ref_dir, qry_dir, comp_num, 40, CPU)
    assert len(dev) == len(host) == comp_num
    for (codes, ends, *qry), (h_codes, rid_of, *h_qry) in zip(dev, host):
        assert codes.dtype == torch.int32 and ends.dtype == torch.int64
        np.testing.assert_array_equal(codes.numpy().view(np.uint32), h_codes)
        ids = [composite._genome_ids(ends, c0, min(c0 + chunk, codes.numel()))
               for c0 in range(0, codes.numel(), chunk)]
        assert all(i.dtype == torch.int32 for i in ids)
        np.testing.assert_array_equal(torch.cat(ids).numpy(), rid_of)
        for a, b in zip(qry, h_qry, strict=True):
            np.testing.assert_array_equal(a, b)
    if case == "genomes without codes":
        rid_of = host[0][1]
        assert not np.isin([0, 5, 6, 20, 38, 39], rid_of).any()
        assert rid_of.max() == 37
    if case == "codes at and above 2^31":
        assert (host[0][0] >= np.uint32(1 << 31)).any()
        assert (host[0][0] < np.uint32(1 << 31)).any()
    if case == "chunk edges inside genomes":
        assert len(ids) > 10


@pytest.mark.parametrize("case", CASES)
def test_raw_route_matches_jax_host_oracle(tmp_path, monkeypatch, case):
    """The raw route's report and -b .abv files equal the JAX package's
    host oracle (device=None) byte for byte, with ``_raw_components`` and
    every host read of the DB's combco files refused: the DB reaches the
    device through ``index.combco_on_device`` alone, and each join chunk
    gets its genome ids there."""
    ref_dir, qry_dir, _ = _write_db(tmp_path, case)
    want = jax_composite.species_abundance(ref_dir, qry_dir, device=None)
    out_j, out_t = str(tmp_path / "abv_j"), str(tmp_path / "abv_t")
    jax_composite.species_abundance(ref_dir, qry_dir, out_j, binvec=True,
                                    device=None)
    chunk = _chunk(monkeypatch, case)

    def refuse(*args, **kwargs):
        raise AssertionError("the raw device route read its DB on the host")

    real_read, real_runs = formats.read_combco, index._runs_on_device
    uploaded, joins = [], []

    def read_combco(dirpath, *args, **kwargs):
        if os.path.samefile(dirpath, ref_dir):
            refuse()
        return real_read(dirpath, *args, **kwargs)

    def runs_on_device(runs, device, spans):
        # each component's files, in their order: codes, index
        uploaded.extend(p if isinstance(p, str) else p[0]
                        for files in zip(*runs) for p in files)
        return real_runs(runs, device, spans)

    real_join = composite.join_kernel

    def join(u, offs, gids, *args):
        assert offs is None and gids.dtype == torch.int32
        joins.append(u.numel())
        return real_join(u, offs, gids, *args)

    monkeypatch.setattr(composite, "_raw_components", refuse)
    monkeypatch.setattr(formats, "read_combco", read_combco)
    monkeypatch.setattr(index, "_runs_on_device", runs_on_device)
    monkeypatch.setattr(composite, "join_kernel", join)
    got = composite.species_abundance(ref_dir, qry_dir, device=CPU)
    assert got == want and want.count("\n") >= 3
    composite.species_abundance(ref_dir, qry_dir, out_t, binvec=True, device=CPU)
    names = sorted(os.listdir(out_j))
    assert names and sorted(os.listdir(out_t)) == names
    for n in names:
        assert_files_equal(f"{out_j}/{n}", f"{out_t}/{n}", n)
    n_comp = 2 if case == "two components" else 1
    assert uploaded[:2 * n_comp] == [
        p for c in range(n_comp) for p in (formats.combco_path(ref_dir, c),
                                           formats.combco_index_path(ref_dir, c))]
    assert max(joins) <= chunk and len(joins) >= 2 * n_comp


@pytest.mark.parametrize("fault", ["index one short", "codes one short",
                                   "codes not whole"])
def test_raw_device_components_refuse_a_torn_db(tmp_path, fault):
    """A component whose index does not hold one offset a genome and one
    more, or whose codes do not end where its index does, raises before
    anything is uploaded."""
    ref_dir, qry_dir, _ = _write_db(tmp_path, "genomes without codes")
    path = formats.combco_index_path(ref_dir, 0)
    if fault != "index one short":
        path = formats.combco_path(ref_dir, 0)
    cut = 3 if fault == "codes not whole" else (8 if "index" in fault else 4)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - cut)
    with pytest.raises(ValueError, match="combco"):
        composite._raw_device_components(ref_dir, qry_dir, 1, 40, CPU)
