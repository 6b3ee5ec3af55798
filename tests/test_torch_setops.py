"""The port's sketch set algebra (setops, kssd_torch set) against the
reference goldens (tests/golden/) and the JAX package, byte for byte. Set
operations are host work in both packages: the same numpy code on the
same files."""

import os

import pytest
import torch

from conftest import assert_co_stat_equal, assert_files_equal

from public_kssd_tpu import cli as jax_cli
from public_kssd_tpu import setops as jax_setops
from public_kssd_tpu_torch import cli, setops

torch.set_num_threads(1)

USAGE = "set operation use : -u, -q, -i or -s\n"

# golden dir -> the call that made it (command_set.c through make_goldens.py)
OPS = {
    "set_union": lambda m, out: m.sketch_union("ref_co", out),
    "set_uniqu": lambda m, out: m.sketch_union("ref_co", out, uniq=True),
    "set_sub": lambda m, out: m.sketch_operate("qry_co", "set_union", out,
                                               intersect=False),
    "set_int": lambda m, out: m.sketch_operate("qry_co", "set_union", out,
                                               intersect=True),
    "set_comb": lambda m, out: m.combin_pans(["set_union", "set_uniqu"], out),
    "set_grp": lambda m, out: m.grouping_genomes("ref_co", "tax.tsv", out),
}

# the same operations through the CLI: golden dir -> kssd set arguments
CLI_OPS = {
    "set_union": ["-u", "ref_co"],
    "set_uniqu": ["-q", "ref_co"],
    "set_sub": ["-s", "set_union", "qry_co"],
    "set_int": ["-i", "set_union", "qry_co"],
    "set_comb": ["-c", "set_union", "set_uniqu"],
    "set_grp": ["-g", "tax.tsv", "ref_co"],
}

# cofiles.stat written from a CoStat, not copied: the reference leaves
# uninitialised padding after each name, so only its fields compare
STAT_REWRITTEN = ("set_comb", "set_grp")


def _files(d):
    return sorted(os.listdir(d))


def _assert_same_dir(a, b):
    """Every file of ``a`` and ``b`` byte-equal, and the same file names."""
    assert _files(a) == _files(b)
    for f in _files(a):
        assert_files_equal(f"{a}/{f}", f"{b}/{f}", f"{b}/{f}")


def _assert_like_golden(golden, out, name):
    assert _files(golden) == _files(out)
    for f in _files(golden):
        if f == "cofiles.stat" and name in STAT_REWRITTEN:
            assert_co_stat_equal(golden, out)
        else:
            assert_files_equal(f"{golden}/{f}", f"{out}/{f}", f"{out}/{f}")


@pytest.mark.parametrize("name", sorted(OPS))
def test_setops_match_golden_and_jax(in_dir, golden7, name):
    with in_dir(golden7):
        OPS[name](setops, f"tset_{name}")
        OPS[name](jax_setops, f"jset_{name}")
        _assert_same_dir(f"jset_{name}", f"tset_{name}")
        _assert_like_golden(name, f"tset_{name}", name)


@pytest.mark.parametrize("name", ["set_union", "set_sub"])
def test_setops_multicomponent_match_golden_and_jax(in_dir, golden4, name):
    """16 components (CSZ=4): one pan or combco file each."""
    with in_dir(golden4):
        OPS[name](setops, f"tset_{name}")
        OPS[name](jax_setops, f"jset_{name}")
        _assert_same_dir(f"jset_{name}", f"tset_{name}")
        _assert_like_golden(name, f"tset_{name}", name)
        assert sum(f.startswith(("pan.", "combco.index."))
                   for f in _files(f"tset_{name}")) == 16


@pytest.mark.parametrize("name", sorted(CLI_OPS))
def test_cli_set_matches_kssd_tpu(in_dir, golden7, name):
    with in_dir(golden7):
        for main, tag in ((cli.main, "tcli"), (jax_cli.main, "jcli")):
            assert main(["set", "-o", f"{tag}_{name}", *CLI_OPS[name]]) == 0
        _assert_same_dir(f"jcli_{name}", f"tcli_{name}")
        _assert_like_golden(name, f"tcli_{name}", name)


def test_cli_set_print_names(in_dir, golden7, capsys):
    with in_dir(golden7):
        outs = []
        for main in (cli.main, jax_cli.main):
            assert main(["set", "-P", "ref_co"]) == 0
            outs.append(capsys.readouterr().out)
        with open("set_names.txt") as f:
            golden = f.read()
    assert outs[0] == outs[1] == golden
    assert len(golden.splitlines()) == 4


@pytest.mark.parametrize("argv", [["set"], ["set", "-o", "x"]])
def test_cli_set_usage_error(argv, capsys):
    outs = []
    for main in (cli.main, jax_cli.main):
        assert main(argv) == -1
        outs.append(capsys.readouterr().out)
    assert outs == [USAGE, USAGE]
