"""The port's main path (stage I sketch -> stage II index -> search, and
the kssd_torch CLI) against the reference goldens (tests/golden/) and the
JAX package, byte for byte, on the CPU (--device cpu: the plain PyTorch
versions of the kernels). The wide-geometry section runs the same path
at 32- and 36-bit codes split into 16 components."""

import contextlib
import gzip
import json
import os
import shutil

import numpy as np
import pytest
import torch

from conftest import assert_co_stat_equal, assert_files_equal

from public_kssd_tpu import cli as jax_cli
from public_kssd_tpu import formats as jax_formats
from public_kssd_tpu import pipeline as jax_pipeline
from public_kssd_tpu import shufspace as jax_shufspace
from public_kssd_tpu.config import SketchParams as JaxParams
from public_kssd_tpu_torch import (
    cli, formats, index, pipeline, search, shufspace, utils,
)
from public_kssd_tpu_torch.config import SketchParams
from public_kssd_tpu_torch.ops import stats as stats_ops

torch.set_num_threads(1)

CPU = torch.device("cpu")
SHUF = {7: "fix_k8.shuf", 4: "fix_k7.shuf"}
COMPS = {7: 1, 4: 16}


@contextlib.contextmanager
def _cd(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def _stage1_both(root, csz):
    """Sketch the golden ref/qry genome sets with the port (torch_*) and
    with the JAX package (torchjax_*), in the golden's own file order."""
    with _cd(root):
        params, shuf = formats.read_shuf(SHUF[csz], component_sz=csz)
        jparams, jshuf = jax_formats.read_shuf(SHUF[csz], component_sz=csz)
        assert shufspace.detect(params, shuf) is None  # a table, not Feistel
        for tag in ("ref", "qry"):
            names = formats.read_co_stat(f"{tag}_co").names
            pipeline.run_stage1(names, f"torch_{tag}", params, shuf, device=CPU)
            jax_pipeline.run_stage1(names, f"torchjax_{tag}", jparams, jshuf)
    return root


@pytest.fixture(scope="module")
def slice7(golden7):
    root = _stage1_both(golden7, 7)
    index.run_stage2(f"{root}/torch_ref", f"{root}/torch_ref", 7, dense=False)
    return root


@pytest.fixture(scope="module")
def slice4(golden4):
    return _stage1_both(golden4, 4)


def _cmp_combco(root, a, b, comp_num, abund=False):
    for c in range(comp_num):
        names = [f"combco.{c}", f"combco.index.{c}"]
        if abund:
            names.append(f"combco.{c}.a")
        for f in names:
            assert_files_equal(f"{root}/{a}/{f}", f"{root}/{b}/{f}", f"{b}/{f}")
    assert_co_stat_equal(f"{root}/{a}", f"{root}/{b}")


# ---------------------------------------------------------------- stage I

@pytest.mark.parametrize("csz", [7, 4])
@pytest.mark.parametrize("tag", ["ref", "qry"])
def test_stage1_combco_parity(slice7, slice4, csz, tag):
    root = slice7 if csz == 7 else slice4
    _cmp_combco(root, f"{tag}_co", f"torch_{tag}", COMPS[csz])
    _cmp_combco(root, f"torchjax_{tag}", f"torch_{tag}", COMPS[csz])


@pytest.mark.parametrize(
    "gdir,kwargs",
    [
        ("fq_plain", {}),
        ("fq_n2", dict(min_occurrence=2)),
        ("fq_q40", dict(min_qual=40)),
        ("fq_koc", dict(abundance=True)),
        ("deep_koc", dict(abundance=True)),
    ],
)
def test_fastq_parity(golden7, gdir, kwargs):
    with _cd(golden7):
        params, shuf = formats.read_shuf(SHUF[7], component_sz=7)
        stat = formats.read_co_stat(gdir)
        pipeline.run_stage1(
            stat.names, f"torch_{gdir}", params, shuf,
            pipeline.SketchOptions(**kwargs), device=CPU,
        )
    _cmp_combco(golden7, gdir, f"torch_{gdir}", 1, abund=stat.koc)


def test_byread_parity(golden7):
    with _cd(golden7):
        params, shuf = formats.read_shuf(SHUF[7], component_sz=7)
        opts = pipeline.SketchOptions(byread=True)
        for src, gdir in (("g0.fasta", "fa_byread"), ("reads0.fq", "fq_byread")):
            pipeline.run_stage1([src], f"torch_{gdir}", params, shuf, opts,
                                device=CPU)
            for f in ("combco.0", "combco.index.0"):
                assert_files_equal(f"{gdir}/{f}", f"torch_{gdir}/{f}")


# ---------------------------------------------------------------- stage II

def test_index_postings_parity(slice7):
    assert_files_equal(f"{slice7}/ref_co/mco.0", f"{slice7}/torch_ref/mco.0")


def test_index_device_sort_parity(slice7):
    """--device-index: the sign-safe torch.sort gives the same files."""
    out = f"{slice7}/torch_ref_devsort"
    index.run_stage2(f"{slice7}/torch_ref", out, 7, dense=False, device=CPU)
    for f in ("mco.0", "mco.uniq.0", "mco.csroff.0", "mcofiles.stat"):
        assert_files_equal(f"{slice7}/torch_ref/{f}", f"{out}/{f}", f)


# ---------------------------------------------------------------- search

def _refuse_host_index(mp):
    """A search on one device loads its index with index.load_device_index:
    the host route, which would hold a host copy of it, refuses."""
    def refuse(*args, **kwargs):
        raise AssertionError("the index was loaded on the host route")

    mp.setattr(index, "load_sparse_index", refuse)


@pytest.mark.parametrize(
    "name,kwargs",
    [
        ("distout", {}),
        ("dv_m1", dict(metric=stats_ops.Metric.CONTAINMENT)),
        ("dv_o0", dict(fields=stats_ops.Fields.DIST)),
        ("dv_o1", dict(fields=stats_ops.Fields.QV)),
        ("dv_n2", dict(top_n=2)),
        ("dv_corr", dict(correction=True)),
        ("dv_d02", dict(max_dist=0.2)),
    ],
)
def test_distance_out_parity(slice7, name, kwargs, monkeypatch):
    _refuse_host_index(monkeypatch)  # one device: the index goes straight there
    search.search(
        f"{slice7}/torch_ref", f"{slice7}/torch_qry",
        f"{slice7}/torch_{name}", stats_ops.OutputOptions(**kwargs),
        device=CPU,
    )
    assert_files_equal(
        f"{slice7}/{name}/distance.out", f"{slice7}/torch_{name}/distance.out"
    )


def test_search_batched_keepskf_and_resume(slice7):
    """-m batching (one query per counting call, disk-backed matrix),
    --keepskf, then -f reprints the same file from sharedk_ct.dat."""
    out = f"{slice7}/torch_m"
    search.search(f"{slice7}/torch_ref", f"{slice7}/torch_qry", out,
                  device=CPU, keep_shared_kmer=True, mem_gb=1e-5)
    assert search.query_batch_size(3, 4, 1e-5) == 1
    assert_files_equal(f"{slice7}/distout/distance.out", f"{out}/distance.out")
    skf = f"{out}/sharedk_ct.dat"
    resumed = f"{slice7}/torch_f"
    search.search(f"{slice7}/torch_ref", f"{slice7}/torch_qry", resumed,
                  shared_kmer_path=skf)
    assert_files_equal(f"{slice7}/distout/distance.out",
                       f"{resumed}/distance.out")


def test_search_rejects_unported(slice7):
    """A mesh that is not the port's (e.g. a jax.sharding.Mesh) is
    refused, not run on some other path."""
    with pytest.raises(TypeError, match="parallel.Mesh"):
        search.search(f"{slice7}/torch_ref", f"{slice7}/torch_qry",
                      f"{slice7}/torch_mesh", device=CPU, mesh=object())


@pytest.fixture(scope="module")
def koc_jax(slice7):
    """The JAX package's koc search of the golden fq_koc sketches (the
    reference's -A output) against the port's index."""
    from public_kssd_tpu import search as jax_search

    jax_search.search(f"{slice7}/torch_ref", f"{slice7}/fq_koc",
                      f"{slice7}/jax_koc", koc=True)
    return f"{slice7}/jax_koc/distance.out"


@pytest.mark.parametrize("device", [CPU, None])
def test_koc_search_matches_jax(slice7, koc_jax, device):
    out = search.search(f"{slice7}/torch_ref", f"{slice7}/fq_koc",
                        f"{slice7}/torch_koc_{device}", device=device, koc=True)
    assert_files_equal(koc_jax, out)
    with open(out) as f:
        lines = f.read().splitlines()
    n_qry, n_ref = 2, 4
    assert len(lines) == 1 + 2 * n_qry * n_ref  # plain rows + koc rows
    assert all(len(r.split("\t")) == 16 for r in lines[1 + n_qry * n_ref:])


def test_koc_search_batched_matches_jax(slice7, koc_jax):
    """-m batching (one query per counting call, disk-backed matrix)."""
    out = search.search(f"{slice7}/torch_ref", f"{slice7}/fq_koc",
                        f"{slice7}/torch_koc_m", device=CPU, koc=True,
                        mem_gb=1e-5)
    assert_files_equal(koc_jax, out)


def test_koc_search_resume_rejected(slice7):
    out = f"{slice7}/torch_koc_f"
    search.search(f"{slice7}/torch_ref", f"{slice7}/fq_koc", out, device=CPU,
                  keep_shared_kmer=True)
    with pytest.raises(ValueError, match="koc"):
        search.search(f"{slice7}/torch_ref", f"{slice7}/fq_koc", out,
                      shared_kmer_path=f"{out}/sharedk_ct.dat", koc=True)


def test_koc_search_without_abundance_is_plain(slice7):
    """A query dir without .a files: koc switches off silently."""
    out = search.search(f"{slice7}/torch_ref", f"{slice7}/torch_qry",
                        f"{slice7}/torch_koc_plain", device=CPU, koc=True)
    assert_files_equal(f"{slice7}/distout/distance.out", out)


@pytest.fixture(scope="module")
def skf_jax(slice7):
    """The JAX package's sharedk_ct.dat (--keepskf) of the golden queries
    and of the fq_koc sketches."""
    from public_kssd_tpu import search as jax_search

    out = {}
    for qry in ("torch_qry", "fq_koc"):
        d = f"{slice7}/jax_skf_{qry}"
        jax_search.search(f"{slice7}/torch_ref", f"{slice7}/{qry}", d,
                          use_device=False, keep_shared_kmer=True)
        out[qry] = f"{d}/sharedk_ct.dat"
    return out


@pytest.mark.parametrize(
    "case,kwargs,during,kept",
    [
        ("plain", {}, False, False),
        ("koc", dict(koc=True), False, False),
        ("keepskf", dict(keep_shared_kmer=True), True, True),
        ("koc_keepskf", dict(koc=True, keep_shared_kmer=True), True, True),
        ("m", dict(mem_gb=1e-5), True, False),
        ("m_keepskf", dict(mem_gb=1e-5, keep_shared_kmer=True), True, True),
    ],
)
def test_search_writes_sharedk_only_when_kept(slice7, koc_jax, skf_jax, monkeypatch,
                                              case, kwargs, during, kept):
    """sharedk_ct.dat is written under --keepskf (the JAX package's
    bytes) and is -m's disk-backed matrix; with neither it is never
    written, so never removed. Seen from the print stage, which starts
    after counting, and from every os.remove of the call."""
    qry = "fq_koc" if kwargs.get("koc") else "torch_qry"
    out = f"{slice7}/torch_skf_{case}"
    seen, removed = [], []
    write, remove = stats_ops.write_distance_out, os.remove

    def spy_write(*args, **kw):
        seen.append(os.path.isfile(f"{out}/sharedk_ct.dat"))
        return write(*args, **kw)

    def spy_remove(path, *args, **kw):
        removed.append(os.path.basename(path))
        return remove(path, *args, **kw)

    monkeypatch.setattr(stats_ops, "write_distance_out", spy_write)
    monkeypatch.setattr(os, "remove", spy_remove)
    path = search.search(f"{slice7}/torch_ref", f"{slice7}/{qry}", out,
                         device=CPU, **kwargs)
    monkeypatch.undo()
    assert seen == [during]
    assert removed == (["sharedk_ct.dat"] if during and not kept else [])
    assert os.path.isfile(f"{out}/sharedk_ct.dat") == kept
    if kept:
        assert_files_equal(skf_jax[qry], f"{out}/sharedk_ct.dat")
    assert_files_equal(koc_jax if kwargs.get("koc") else
                       f"{slice7}/distout/distance.out", path)


# ---------------------------------------------------------------- CLI

TUTORIAL_FILES = [
    "F.shuf",
    "ref/combco.0", "ref/combco.index.0", "ref/cofiles.stat",
    "ref/mco.0", "ref/mco.uniq.0", "ref/mco.csroff.0", "ref/mcofiles.stat",
    "qry/combco.0", "qry/combco.index.0", "qry/cofiles.stat",
    "out/distance.out",
]


def _mutated_queries(golden7, qdir):
    """Query genomes that share k-mers with the references: refs 0 and 2
    with 1% and 4% point mutations, beside an unrelated golden query."""
    os.makedirs(qdir)
    rng = np.random.default_rng(17)
    for i, rate in ((0, 0.01), (2, 0.04)):
        with gzip.open(f"{golden7}/genomes/g{i}.fasta.gz", "rb") as f:
            raw = np.frombuffer(f.read(), np.uint8).copy()
        bases = np.flatnonzero(np.isin(raw, np.frombuffer(b"ACGT", np.uint8)))
        hit = bases[rng.random(bases.size) < rate]
        raw[hit] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, hit.size)]
        with open(f"{qdir}/mut{i}.fasta", "wb") as f:
            f.write(raw.tobytes())
    shutil.copy(f"{golden7}/qry/g0.fasta.gz", f"{qdir}/g0.fasta.gz")
    return qdir


@pytest.fixture(scope="module")
def tutorial(golden7, tmp_path_factory):
    """The dist tutorial through both CLIs on a Feistel .shuf:
    shuffle -> sketch+index refs -> sketch queries -> search."""
    root = str(tmp_path_factory.mktemp("tutorial"))
    qdir = _mutated_queries(golden7, f"{root}/queries")
    for main, tag, extra in (
        (jax_cli.main, "jax", []),
        (cli.main, "torch", ["--device", "cpu"]),
    ):
        d = os.path.join(root, tag)
        os.makedirs(d)
        assert main(["shuffle", "-k", "8", "-s", "5", "-l", "2", "--seed", "7",
                     "-o", f"{d}/F"]) == 0
        assert main(["dist", "-r", f"{golden7}/genomes", "-L", f"{d}/F.shuf",
                     "-o", f"{d}/ref", "--no-dense-index", *extra]) == 0
        assert main(["dist", "-L", f"{d}/F.shuf", "-o", f"{d}/qry", qdir,
                     *extra]) == 0
        with pytest.MonkeyPatch.context() as mp:
            if tag == "torch":
                _refuse_host_index(mp)
            assert main(["dist", "-r", f"{d}/ref", "-o", f"{d}/out", f"{d}/qry",
                         *extra]) == 0
    return root


@pytest.mark.parametrize("rel", TUTORIAL_FILES)
def test_cli_tutorial_matches_jax(tutorial, rel):
    assert_files_equal(f"{tutorial}/jax/{rel}", f"{tutorial}/torch/{rel}", rel)


def test_cli_tutorial_outputs(tutorial):
    params, perm = formats.read_shuf(f"{tutorial}/torch/F.shuf")
    assert shufspace.detect(params, perm) is not None  # Feistel space
    with open(f"{tutorial}/torch/out/distance.out") as f:
        lines = f.read().splitlines()
    assert len(lines) == 1 + 3 * 4
    stat = formats.read_co_stat(f"{tutorial}/torch/qry")
    assert stat.infile_num == 3 and stat.all_ctx_ct > 0


def test_cli_tutorial_counts_device_equals_host(tutorial):
    """The mutated queries share k-mers with their references; the
    plain PyTorch counting equals the host oracle on them."""
    _, comps = index.load_sparse_index(f"{tutorial}/torch/ref")
    qry = f"{tutorial}/torch/qry"
    a = search.compute_shared_counts(qry, comps, 3, None)
    b = search.compute_shared_counts(qry, comps, 3, CPU)
    np.testing.assert_array_equal(a, b)
    names = formats.read_co_stat(qry).names
    for q, name in enumerate(names):
        if "mut" in name:  # its own reference shares most codes
            r = int(name.split("mut")[1][0])
            assert a[q].argmax() == r and a[q, r] > a[q].sum() // 2


# the sharded flags refuse bad specs
_REJECTED = {"--mesh": "expected DPxREF", "--shard": "expected I:N",
             "--merge-shards": "manifest"}


@pytest.mark.parametrize(
    "flag", [["--mesh", "2"], ["--shard", "0"], ["--merge-shards"]],
)
def test_cli_bad_sharding_flags_rejected(tutorial, flag):
    with pytest.raises((SystemExit, FileNotFoundError),
                       match=_REJECTED[flag[0]]):
        cli.main(["dist", "-r", f"{tutorial}/torch/ref", "-o",
                  f"{tutorial}/torch/out_x", f"{tutorial}/torch/qry",
                  "--device", "cpu", *flag])


@pytest.mark.parametrize(
    "step,outputs",
    [
        ("stage1", ["qry/combco.0", "qry/combco.index.0", "qry/cofiles.stat"]),
        ("search", ["out/distance.out"]),
    ],
)
def test_cli_profile_writes_a_trace(tutorial, step, outputs):
    """dist --profile DIR writes a torch.profiler trace of the command
    into DIR (CPU events on --device cpu) and changes no output."""
    d = f"{tutorial}/torch"
    trace = f"{d}/trace_{step}"
    if step == "stage1":
        argv = ["-L", f"{d}/F.shuf", "-o", f"{d}/prof_qry", f"{tutorial}/queries"]
    else:
        argv = ["-r", f"{d}/ref", "-o", f"{d}/prof_out", f"{d}/qry"]
    assert cli.main(["dist", *argv, "--profile", trace, "--device", "cpu"]) == 0
    for rel in outputs:
        assert_files_equal(f"{d}/{rel}", f"{d}/prof_{rel}", rel)
    files = os.listdir(trace)
    assert files and all(f.endswith(".pt.trace.json") for f in files)
    with open(f"{trace}/{files[0]}") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)


def test_profile_trace_without_logdir_records_nothing(tmp_path):
    for logdir in (None, ""):
        with _cd(tmp_path), utils.profile_trace(logdir, CPU):
            assert not torch.autograd._profiler_enabled()
            torch.ones(3).sum()
    assert not os.listdir(tmp_path)


def test_cli_primer_matches_kssd_tpu(capsys):
    outs = []
    for main in (cli.main, jax_cli.main):
        assert main(["primer"]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    primes = [int(x) for x in outs[0].split("\n") if x.isdigit()]
    assert len(primes) == 44 and primes[0] == 251


def test_cli_koc_out_matches_kssd_tpu(tutorial, golden7):
    """dist --koc-out on -A sketches of the golden fastq reads through
    both CLIs (their own Feistel .shuf and index), and the same on a
    query dir without .a files."""
    for main, tag, extra in (
        (jax_cli.main, "jax", []),
        (cli.main, "torch", ["--device", "cpu"]),
    ):
        d = os.path.join(tutorial, tag)
        reads = [f"{golden7}/reads0.fq.gz", f"{golden7}/reads1.fq.gz"]
        assert main(["dist", "-A", "-L", f"{d}/F.shuf", "-o", f"{d}/koc",
                     *reads, *extra]) == 0
        for qry, out in (("koc", "out_koc"), ("qry", "out_koc_plain")):
            assert main(["dist", "-r", f"{d}/ref", "-o", f"{d}/{out}",
                         "--koc-out", f"{d}/{qry}", *extra]) == 0
    for rel in ("koc/combco.0", "koc/combco.0.a", "out_koc/distance.out",
                "out_koc_plain/distance.out"):
        assert_files_equal(f"{tutorial}/jax/{rel}", f"{tutorial}/torch/{rel}",
                           rel)
    assert_files_equal(f"{tutorial}/torch/out/distance.out",
                       f"{tutorial}/torch/out_koc_plain/distance.out")
    with open(f"{tutorial}/torch/out_koc/distance.out") as f:
        assert len(f.read().splitlines()) == 1 + 2 * 2 * 4  # + koc rows


# ---------------------------------------------------------------- wide

WIDE_COMPS = 16  # (11,6,3) at CSZ=7 and (12,6,3) at CSZ=8: 4 excess bits
WIDE_SINGLE_FILES = [
    "F.shuf", "ref/cofiles.stat", "qry/cofiles.stat", "ref/mcofiles.stat",
    "out/distance.out",
]
WIDE_COMPONENT_FILES = [
    "ref/combco.{c}", "ref/combco.index.{c}", "qry/combco.{c}",
    "qry/combco.index.{c}", "ref/mco.{c}", "ref/mco.uniq.{c}",
    "ref/mco.csroff.{c}",
]


@pytest.fixture(scope="module")
def wide_tutorial(golden7, tmp_path_factory):
    """The dist tutorial through both CLIs at (k,s,l) = (11,6,3): 32-bit
    codes, 16 components at CSZ=7, compat-order dedup with a 33.5M-slot
    hash table; stage II without the dense export (16^7 rows x 8 B per
    component)."""
    root = str(tmp_path_factory.mktemp("wide_tutorial"))
    qdir = _mutated_queries(golden7, f"{root}/queries")
    for main, tag, extra in (
        (jax_cli.main, "jax", []),
        (cli.main, "torch", ["--device", "cpu"]),
    ):
        d = os.path.join(root, tag)
        os.makedirs(d)
        assert main(["shuffle", "-k", "11", "-s", "6", "-l", "3", "--seed", "7",
                     "-o", f"{d}/F"]) == 0
        assert main(["dist", "-r", f"{golden7}/genomes", "-L", f"{d}/F.shuf",
                     "-o", f"{d}/ref", "--no-dense-index", *extra]) == 0
        assert main(["dist", "-L", f"{d}/F.shuf", "-o", f"{d}/qry", qdir,
                     *extra]) == 0
        assert main(["dist", "-r", f"{d}/ref", "-o", f"{d}/out", f"{d}/qry",
                     *extra]) == 0
    return root


@pytest.mark.parametrize("rel", WIDE_SINGLE_FILES)
def test_cli_wide_matches_jax(wide_tutorial, rel):
    assert_files_equal(f"{wide_tutorial}/jax/{rel}",
                       f"{wide_tutorial}/torch/{rel}", rel)


@pytest.mark.parametrize("pattern", WIDE_COMPONENT_FILES)
def test_cli_wide_components_match_jax(wide_tutorial, pattern):
    for c in range(WIDE_COMPS):
        rel = pattern.format(c=c)
        assert_files_equal(f"{wide_tutorial}/jax/{rel}",
                           f"{wide_tutorial}/torch/{rel}", rel)


def test_cli_wide_outputs(wide_tutorial):
    """16 components with codes in them, and each mutated query shares
    most of its codes with its source reference."""
    params, perm = formats.read_shuf(f"{wide_tutorial}/torch/F.shuf")
    assert params.drtuple_bits == 32 and params.component_num == WIDE_COMPS
    assert shufspace.detect(params, perm) is not None
    stat = formats.read_co_stat(f"{wide_tutorial}/torch/ref")
    assert stat.comp_num == WIDE_COMPS and stat.all_ctx_ct > 0
    _, comps = index.load_sparse_index(f"{wide_tutorial}/torch/ref")
    assert len(comps) == WIDE_COMPS
    qry = f"{wide_tutorial}/torch/qry"
    counts = search.compute_shared_counts(qry, comps, 3, CPU)
    np.testing.assert_array_equal(
        counts, search.compute_shared_counts(qry, comps, 3, None)
    )
    for q, name in enumerate(formats.read_co_stat(qry).names):
        if "mut" in name:
            r = int(name.split("mut")[1][0])
            assert counts[q].argmax() == r and counts[q, r] > counts[q].sum() // 2
    with open(f"{wide_tutorial}/torch/out/distance.out") as f:
        assert len(f.read().splitlines()) == 1 + 3 * 4


@pytest.fixture(scope="module")
def wide_koc(wide_tutorial, golden7):
    """-A sketches of the golden fastq read sets at (11,6,3), searched
    with --koc-out by the JAX package: its distance.out."""
    from public_kssd_tpu import search as jax_search

    params, perm = formats.read_shuf(f"{wide_tutorial}/torch/F.shuf")
    qry = f"{wide_tutorial}/torch/qry_koc"
    with _cd(golden7):
        pipeline.run_stage1(["reads0.fq.gz", "reads1.fq.gz", "deep.fq.gz"], qry,
                            params, perm, pipeline.SketchOptions(abundance=True),
                            device=CPU)
    jax_search.search(f"{wide_tutorial}/torch/ref", qry,
                      f"{wide_tutorial}/jax/out_koc", use_device=False, koc=True)
    return qry, f"{wide_tutorial}/jax/out_koc/distance.out"


@pytest.mark.parametrize(
    "case,kwargs",
    [
        ("plain", {}),
        ("m", dict(mem_gb=1e-5)),
        ("koc", dict(koc=True)),
        ("koc_m", dict(koc=True, mem_gb=1e-5)),
    ],
)
def test_wide_search_sums_components_like_jax(wide_tutorial, wide_koc, case, kwargs):
    """16 components summed where they were counted, one copy a batch
    (-m: one query a batch): distance.out byte-equal to kssd_tpu's, with
    and without --koc-out."""
    qry, want = ((*wide_koc,) if kwargs.get("koc") else
                 (f"{wide_tutorial}/torch/qry",
                  f"{wide_tutorial}/jax/out/distance.out"))
    out = search.search(f"{wide_tutorial}/torch/ref", qry,
                        f"{wide_tutorial}/torch/out_sum_{case}", device=CPU,
                        **kwargs)
    assert_files_equal(want, out)
    if kwargs.get("koc"):
        with open(out) as f:
            assert len(f.read().splitlines()) == 1 + 2 * 3 * 4


def _wide_params(k, s, l, csz=7):
    p = SketchParams.create(k=k, drlevel=l, subk=s, seed=k, component_sz=csz)
    jp = JaxParams(id=p.id, half_ctx_len=k, half_subctx_len=s, drlevel=l,
                   component_sz=csz)
    return (p, shufspace.ComputedShuf(p.id, s),
            jp, jax_shufspace.ComputedShuf(p.id, s))


def _stage1_wide(golden7, tag, files, params, opts=None, jopts=None):
    """run_stage1 of the port and of the JAX package on ``files`` (paths
    relative to the golden root) into torch_<tag> and jax_<tag>."""
    p, shuf, jp, jshuf = params
    with _cd(golden7):
        pipeline.run_stage1(files, f"torch_{tag}", p, shuf, opts, device=CPU)
        jax_pipeline.run_stage1(files, f"jax_{tag}", jp, jshuf, jopts)
    return p


def test_stage1_wide_csz8_matches_jax(golden7):
    """(12,6,3): 36-bit codes, 16 components at CSZ=8, 536.9M-slot
    compat-order hash table."""
    genomes = [f"genomes/g{i}.fasta.gz" for i in range(2)]
    p = _stage1_wide(golden7, "w12", genomes, _wide_params(12, 6, 3, csz=8))
    assert p.drtuple_bits == 36 and p.component_num == WIDE_COMPS
    _cmp_combco(golden7, "jax_w12", "torch_w12", WIDE_COMPS)
    assert formats.read_co_stat(f"{golden7}/torch_w12").all_ctx_ct > 0


def test_stage1_wide_fastq_abundance_matches_jax(golden7):
    """-A on deep fastq reads at (11,6,3): 16-bit counters, .a files."""
    p = _stage1_wide(
        golden7, "w11_koc", ["deep.fq.gz"], _wide_params(11, 6, 3),
        pipeline.SketchOptions(abundance=True),
        jax_pipeline.SketchOptions(abundance=True),
    )
    _cmp_combco(golden7, "jax_w11_koc", "torch_w11_koc", p.component_num,
                abund=True)
    a = np.concatenate([
        np.fromfile(f"{golden7}/torch_w11_koc/combco.{c}.a", "<u2")
        for c in range(p.component_num)
    ])
    assert a.size > 0 and a.max() > 1


def test_stage1_wide_byread_matches_jax(golden7):
    """--byread at (11,6,3): one sketch row per read."""
    opts = pipeline.SketchOptions(byread=True)
    jopts = jax_pipeline.SketchOptions(byread=True)
    params = _wide_params(11, 6, 3)
    for src in ("g0.fasta", "reads0.fq"):
        tag = "w11_byread_" + src.split(".")[0]
        p = _stage1_wide(golden7, tag, [src], params, opts, jopts)
        for c in range(p.component_num):
            for f in (f"combco.{c}", f"combco.index.{c}"):
                assert_files_equal(f"{golden7}/jax_{tag}/{f}",
                                   f"{golden7}/torch_{tag}/{f}", f)
        assert formats.read_co_stat(f"{golden7}/torch_{tag}").all_ctx_ct > 0
