"""The port's sketch reversal (reverse, kssd_torch reverse) against the
reference goldens (tests/golden/) and the JAX package, byte for byte, and
a round trip: reverse the port's sketch to k-mers, sketch the k-mers
again, get the same codes."""

import os

import numpy as np
import pytest
import torch

from conftest import assert_files_equal

from public_kssd_tpu import cli as jax_cli
from public_kssd_tpu import formats as jax_formats
from public_kssd_tpu import reverse as jax_reverse
from public_kssd_tpu_torch import cli, formats, reverse, shufspace
from public_kssd_tpu_torch.config import SketchParams

torch.set_num_threads(1)

SHUF = {7: "fix_k8.shuf", 4: "fix_k7.shuf"}


def _assert_same_dir(a, b):
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for f in sorted(os.listdir(a)):
        assert_files_equal(f"{a}/{f}", f"{b}/{f}", f"{b}/{f}")


def test_reverse_codir_matches_golden_and_jax(in_dir, golden7):
    with in_dir(golden7):
        reverse.reverse_codir("qry_co", SHUF[7], "trev_out", component_sz=7)
        jax_reverse.reverse_codir("qry_co", SHUF[7], "jrev_out", component_sz=7)
        _assert_same_dir("rev_out", "trev_out")
        _assert_same_dir("jrev_out", "trev_out")


def test_reverse_byreads_matches_golden_and_jax(in_dir, golden7):
    with in_dir(golden7):
        got = reverse.reverse_byreads("fa_byread", SHUF[7], component_sz=7)
        with open("rev_byread.txt") as f:
            assert got == f.read()
        assert got == jax_reverse.reverse_byreads("fa_byread", SHUF[7],
                                                  component_sz=7)
    assert got.startswith(">read 1\n")


@pytest.mark.parametrize("byreads", [False, True])
def test_cli_reverse_matches_kssd_tpu(in_dir, golden7, capsys, byreads):
    src = "fa_byread" if byreads else "qry_co"
    flags = ["-b"] if byreads else []
    outs = []
    with in_dir(golden7):
        for main, tag in ((cli.main, "t"), (jax_cli.main, "j")):
            assert main(["reverse", "-L", SHUF[7], "-o", f"{tag}cli_rev_{byreads}",
                         *flags, src]) == 0
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1]
        if byreads:
            with open("rev_byread.txt") as f:
                assert outs[0] == f.read()
        else:
            assert outs[0] == ""
            _assert_same_dir("jcli_rev_False", "tcli_rev_False")
            _assert_same_dir("rev_out", "tcli_rev_False")


def test_reverse_rejects_a_space_below_4096_dims(tmp_path):
    """The inverse table has 4,096 ranks (command_reverse.c:150-158): a
    space of 16^2 substrings (s = 2, l = 0) cannot fill it, in both
    packages."""
    params = SketchParams.create(k=8, drlevel=0, subk=2)
    perm = shufspace.make_feistel_dim(params)
    path = str(tmp_path / "s2l0.shuf")
    formats.write_shuf(path, params, perm)
    errors = []
    for fmt, mod in ((formats, reverse), (jax_formats, jax_reverse)):
        p, table = fmt.read_shuf(path)
        with pytest.raises(ValueError, match="not match") as e:
            mod.reverse_shuffle(p, table)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_reverse_round_trip_multicomponent(in_dir, golden4):
    """CSZ=4 (16 components): the port sketches the golden references,
    reverses the sketch to k-mers, writes each genome's k-mers as a fasta
    of one record per k-mer, and sketches those; each genome's codes in
    each component, sorted, come back the same."""
    csz = ["--component-sz", "4", "--device", "cpu"]
    with in_dir(golden4):
        names = formats.read_co_stat("ref_co").names
        assert cli.main(["dist", "-L", SHUF[4], "-o", "rt_ref", *csz,
                         *names]) == 0
        assert cli.main(["reverse", "-L", SHUF[4], "--component-sz", "4",
                         "-o", "rt_kmers", "rt_ref"]) == 0
        os.makedirs("rt_fasta")
        stat = formats.read_co_stat("rt_ref")
        fastas = []
        for name in stat.names:
            with open(f"rt_kmers/{os.path.basename(name)}") as f:
                kmers = f.read().split()
            fastas.append(f"rt_fasta/{os.path.basename(name)}.fa")
            with open(fastas[-1], "w") as f:
                f.write("".join(f">{i}\n{s}\n" for i, s in enumerate(kmers)))
        assert cli.main(["dist", "-L", SHUF[4], "-o", "rt_again", *csz,
                         *fastas]) == 0
        again = formats.read_co_stat("rt_again")
        row = {os.path.basename(n): g for g, n in enumerate(again.names)}
        n_codes = 0
        for c in range(stat.comp_num):
            codes, idx = formats.read_combco("rt_ref", c)
            codes2, idx2 = formats.read_combco("rt_again", c)
            for g, name in enumerate(stat.names):
                h = row[os.path.basename(name) + ".fa"]
                a = np.sort(codes[int(idx[g]):int(idx[g + 1])])
                b = np.sort(codes2[int(idx2[h]):int(idx2[h + 1])])
                np.testing.assert_array_equal(a, b)
                n_codes += a.size
    assert stat.comp_num == 16 and n_codes == stat.all_ctx_ct > 0
