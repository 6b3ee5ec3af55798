"""The port's post-processing converters (postproc, kssd_torch convert)
against the JAX package's on the same seeded inputs: equal strings, equal
files. The JAX package's own golden tests run the original Perl scripts
and skip where those are absent; these cases hold the port to the JAX
package everywhere."""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from conftest import assert_files_equal

from public_kssd_tpu import cli as jax_cli
from public_kssd_tpu import postproc as jax_postproc
from public_kssd_tpu_torch import cli, postproc

torch.set_num_threads(1)


@pytest.fixture()
def inputs(tmp_path):
    """A seeded composite report of one sample (40 references), its
    psid -> taxonomy and psid -> NCBI species tables, a seven-rank NCBI
    node chain per species, and the small tables of the nine utilities."""
    rng = np.random.default_rng(2)
    d = {}
    rows = []
    for i in range(40):
        avg = float(rng.uniform(0, 8))
        rows.append("\t".join(str(x) for x in (
            "/data/sampleA.fq.gz", f"{1000 + i}_GCA_0000{i}.1_genomic",
            int(rng.integers(0, 40)), round(avg + 0.3, 4), round(avg, 4),
            float(rng.integers(0, 4)), round(avg + 0.5, 4),
        )))
    files = {
        "composite": "\n".join(rows) + "\n",
        "psid2tax": "".join(f"{1000 + i}\td__Bacteria\tp__P{i % 3}\t"
                            f"s__Species {i}\n" for i in range(40)),
        "psid2ncbi": "".join(f"{1000 + i}\t{5000 + i}\n" for i in range(40)),
        "g2t": "GCA_000001.1\t55\tEco\nGCF_000002.2\t66\nGCA_000003.1\t77\tSau\n",
        "genomes": "x_GCA_000001.1_y\nGCF_000002.2\nGCA_000009.9\n",
        "ac2tid": "AC1\t10\tnameA\nAC2\t20\nAC3\t30\tnameC\n",
        "acs": "AC2\nAC9\nAC1\n",
        "all_csv": "a,1,2\nb,3,4\nc,5,6\n",
        "selected": "c\textra\na\n",
        "acc": "GCA_000123456.1\tASM 12v1\nGCF_009876543.2\tXyz9\n",
        "fasta": ">r1 desc\nACGTacgTNNA\nCCGTA\n>r2\nGGGTTTacgt\n",
        "t2s": " 12 \tEscherichia coli\n34\tStaph aureus\n",
        "names": "Staph aureus\nUnknown sp\nEscherichia coli\n",
        "g2n": "d__B;s__Eco\t561\tEscherichia\nd__B;s__Eco\t562\tE. coli\n"
               "d__B;s__Sau\t1280\tS. aureus\nnospecies\t99\tX\n",
        "species": "Eco\nSau\nMissing\n",
        "meta": "run,bioproject,biosample,organism\n"
                "R1,P1,S1,Ecoli\nR2,P2,,\nR3,P3,S3,Worm\n",
        "abv": "Qry\t0.99\nR1.abv\t0.88\nR2.abv\t0.77\nR9.abv\t0.5\n",
        "gtdb": "GTDB_AC\theader\n"
                "GCA_1\t7\tEco\t2|561|562\tBacteria|Escherichia|E coli\n"
                "GCA_2\t7\tEco\t2|561|562\tBacteria|Escherichia|E coli\n"
                "GCA_3\t7\tEco\t2|561|563\tBacteria|Escherichia|E fergusonii\n"
                "GCA_4\t8\tSau\t2|1279|1280\tBacteria|Staph|S aureus\n"
                "badrow\t9\tX\t1|2\tA|B\n",
    }
    ranks = list(postproc.RANKS)
    nodes = []
    for i in range(40):
        chain = [5000 + i] + [6000 + 10 * j + i % 2 for j in range(6)]
        for lvl, node in enumerate(chain):
            pa = chain[lvl + 1] if lvl + 1 < len(chain) else 1
            nodes.append(f"{node}\t{ranks[-1 - lvl]}\t{pa}\tname_{node}\n")
    files["nodes"] = "".join(nodes)
    for name, text in files.items():
        d[name] = str(tmp_path / f"{name}.txt")
        with open(d[name], "w") as f:
            f.write(text)
    # a second Krona table: the first one's rows reversed
    krona = jax_postproc.composite_to_krona(d["composite"], d["psid2tax"],
                                            str(tmp_path / "krona_in"))
    with open(krona) as f:
        lines = f.read().splitlines()
    d["krona1"], d["krona2"] = krona, str(tmp_path / "krona2.tsv")
    with open(d["krona2"], "w") as f:
        f.write("\n".join(reversed(lines)) + "\n")
    d["tmp"] = str(tmp_path)
    return d


# mode -> (function name, argument keys) of the converters returning text
TEXT = {
    "cami": ("composite_to_cami", ["composite", "psid2ncbi", "nodes"]),
    "extract-taxid": ("extract_taxid", ["genomes", "g2t"]),
    "ac2psid": ("ac2pseudotaxid", ["acs", "ac2tid"]),
    "csv-subset": ("csv_table_subset", ["all_csv", "selected"]),
    "ncbi-ftp": ("ncbi_accession2ftp", ["acc"]),
    "kmer-finder": ("kmer_finder", ["fasta", 4]),
    "species2psid": ("gtdbspecies2pseudo_taxid", ["names", "t2s"]),
    "species2ncbi": ("gtdbspecies2ncbitaxonomy", ["species", "g2n"]),
    "abv-meta": ("abv_match_metadata", ["abv", "meta"]),
    "psid2ncbitax": ("gtdbpsid2ncbitax_by_genomesupport", ["gtdb", True]),
}


def _args(inputs, keys):
    return [inputs[k] if isinstance(k, str) else k for k in keys]


@pytest.mark.parametrize("mode", sorted(TEXT))
def test_converter_matches_jax(inputs, mode):
    name, keys = TEXT[mode]
    got = getattr(postproc, name)(*_args(inputs, keys))
    assert got == getattr(jax_postproc, name)(*_args(inputs, keys))
    assert got


def test_krona_matches_jax(inputs):
    outs = [m.composite_to_krona(inputs["composite"], inputs["psid2tax"],
                                 f"{inputs['tmp']}/{tag}")
            for m, tag in ((postproc, "tk"), (jax_postproc, "jk"))]
    assert [os.path.basename(p) for p in outs] == ["sampleA", "sampleA"]
    assert_files_equal(outs[1], outs[0])
    assert_files_equal(inputs["krona1"], outs[0])


def test_qiime_matches_jax(inputs):
    tables = [inputs["krona1"], inputs["krona2"]]
    for m, tag in ((postproc, "tq"), (jax_postproc, "jq")):
        m.merge_krona_to_qiime(f"{inputs['tmp']}/{tag}", tables)
    for f in ("otu.tsv", "taxonomy.tsv", "meta.tsv"):
        assert_files_equal(f"{inputs['tmp']}/jq/{f}", f"{inputs['tmp']}/tq/{f}", f)


# mode -> convert arguments (keys of ``inputs``; -o is added per CLI)
CLI = {
    "krona": ["-t", "psid2tax", "composite"],
    "qiime": ["krona1", "krona2"],
    "cami": ["-t", "psid2ncbi", "-n", "nodes", "composite"],
    "extract-taxid": ["genomes", "g2t"],
    "ac2psid": ["acs", "ac2tid"],
    "csv-subset": ["all_csv", "selected"],
    "ncbi-ftp": ["acc"],
    "kmer-finder": ["fasta", "4"],
    "species2psid": ["names", "t2s"],
    "species2ncbi": ["species", "g2n"],
    "abv-meta": ["abv", "meta"],
    "psid2ncbitax": ["gtdb", "0"],
}


@pytest.mark.parametrize("mode", sorted(CLI))
def test_cli_convert_matches_kssd_tpu(inputs, mode):
    argv = [inputs.get(a, a) if not a.startswith("-") else a for a in CLI[mode]]
    outs = []
    for main, tag in ((cli.main, "tcli"), (jax_cli.main, "jcli")):
        outdir = f"{inputs['tmp']}/{tag}"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["convert", mode, "-o", outdir, *argv]) == 0
        outs.append((outdir, buf.getvalue().replace(outdir, "OUT")))
        assert outs[-1][1] or mode == "qiime"
    (tdir, tout), (jdir, jout) = outs
    assert tout == jout
    if mode in ("krona", "qiime"):
        assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
        for f in os.listdir(tdir):
            assert_files_equal(f"{jdir}/{f}", f"{tdir}/{f}", f)
