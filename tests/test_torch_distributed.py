"""The port's sharded artifacts and multi-process paths against the JAX
package's, on the CPU: stage I in shards (``dist --shard`` /
``--merge-shards``), combining sketch dirs (``dist -o out <co> <co>``,
against the reference golden), and mesh search / composite across two
processes joined by torch.distributed (gloo, loopback rendezvous), whose
every process must write what one process writes."""

import dataclasses
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from conftest import assert_co_stat_equal, assert_files_equal
from test_composite_scale import _mk_db
from test_multiprocess_search import db_env  # noqa: F401  (module fixture)

from public_kssd_tpu import cli as jax_cli
from public_kssd_tpu import composite as jax_composite
from public_kssd_tpu import formats as jax_formats
from public_kssd_tpu import search as jax_search
from public_kssd_tpu_torch import cli, combine, formats, pipeline
from public_kssd_tpu_torch.parallel import distributed

torch.set_num_threads(1)

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT = 60  # seconds, per process


def _combco_equal(a, b, comp_num=1):
    for c in range(comp_num):
        for f in (f"combco.{c}", f"combco.index.{c}"):
            assert_files_equal(f"{a}/{f}", f"{b}/{f}", f)
    assert_co_stat_equal(a, b)


# ------------------------------------------------------ shards and combine

def test_shard_merge_equals_single_run(golden7, in_dir):
    """dist --shard 0:2 and 1:2, then --merge-shards, through both CLIs:
    the port's merged dir equals the JAX package's and a single run over
    the round-robin order."""
    with in_dir(golden7):
        files = formats.read_co_stat("ref_co").names
        for main, tag, extra in ((jax_cli.main, "jax", []),
                                 (cli.main, "torch", ["--device", "cpu"])):
            for s in range(2):
                assert main(["dist", "-L", "fix_k8.shuf", "-o", f"{tag}_shards",
                             "--shard", f"{s}:2", *extra, *files]) == 0
            assert main(["dist", "--merge-shards", "-o", f"{tag}_merged",
                         *extra, f"{tag}_shards"]) == 0
        _combco_equal("jax_merged", "torch_merged")
        params, shuf = formats.read_shuf("fix_k8.shuf")
        rr = [f for s in range(2) for f in distributed.shard_files(files, 2, s)]
        assert rr != files  # the merge really reorders
        pipeline.run_stage1(rr, "torch_single_rr", params, shuf, device=CPU)
        _combco_equal("torch_single_rr", "torch_merged")
        man = distributed.read_manifest("torch_shards")
        assert man["n_shards"] == 2 and man["params_id"] == params.id
        assert man["shards"]["1"]["files"] == files[1::2]


def test_shard_restart_idempotent(golden7, in_dir):
    with in_dir(golden7):
        params, shuf = formats.read_shuf("fix_k8.shuf")
        names = formats.read_co_stat("qry_co").names
        root = "torch_shard_root2"
        d1 = distributed.sketch_shard(names, root, params, shuf, shard_id=0,
                                      n_shards=1, device=CPU)
        mtime = os.path.getmtime(os.path.join(d1, "combco.0"))
        d2 = distributed.sketch_shard(names, root, params, shuf, shard_id=0,
                                      n_shards=1, device=CPU)
        assert d1 == d2
        assert os.path.getmtime(os.path.join(d2, "combco.0")) == mtime
        assert distributed.read_manifest(root)["shards"]["0"]["files"] == names
        os.remove(os.path.join(d1, ".complete"))
        with pytest.raises(RuntimeError, match="incomplete"):
            distributed.merge_shards(root, "torch_merged2")


def test_combine_queries_parity(golden7, in_dir):
    """dist -o out <co> <co> (combine_queries) against the reference's
    golden comb_q, through the port's CLI and its API."""
    with in_dir(golden7):
        assert cli.main(["dist", "-o", "torch_combq", "--device", "cpu",
                         "qry_co", "qry_co"]) == 0
        _combco_equal("comb_q", "torch_combq")
        stat = combine.combine_queries(["qry_co", "qry_co"], "torch_combq2")
        assert stat.infile_num == 2 * formats.read_co_stat("qry_co").infile_num
        _combco_equal("comb_q", "torch_combq2")


# --------------------------------------------------------- two processes

def _run_workers(tmp_path, body: str, n: int = 2, prelude: str = "") -> list[str]:
    """Run ``body`` in n processes joined by torch.distributed (gloo on a
    free loopback port); ``pid`` and ``world`` are bound in it. ``prelude``
    runs before the group is initialised. Returns each process's stdout;
    every process must exit 0."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    worker = tmp_path / "torch_worker.py"
    worker.write_text(textwrap.dedent(f"""
        import os, sys
        sys.path.insert(0, {REPO!r})
        import torch
        torch.set_num_threads(1)
        from public_kssd_tpu_torch import parallel
        from public_kssd_tpu_torch.parallel import distributed
    """) + textwrap.dedent(prelude) + textwrap.dedent(f"""
        pid, world = distributed.initialize("127.0.0.1:{port}", {n},
                                            int(sys.argv[1]), device="cpu")
        assert world == {n} and pid == int(sys.argv[1])
        cpu4 = [torch.device("cpu")] * 4
    """) + textwrap.dedent(body))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["OMP_NUM_THREADS"] = "1"
    procs = [
        subprocess.Popen([sys.executable, str(worker), str(i)], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for i in range(n)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORKER_TIMEOUT)
            assert p.returncode == 0, err.decode()[-3000:]
            outs.append(out.decode())
    finally:
        for p in procs:
            p.kill()
    return outs


@pytest.mark.parametrize("round_", range(5))
def test_two_process_group_ends_at_exit(tmp_path, round_):
    """A two-process gloo group, started, used and left at exit, five
    times in a row: every worker exits 0, and the group is destroyed
    before the interpreter ends (the teardown ``initialize`` registers;
    a group left to the interpreter's exit once aborted a worker)."""
    outs = _run_workers(tmp_path, """
        import torch.distributed as dist
        t = torch.full((4,), float(pid + 1))
        dist.all_reduce(t)
        assert t.tolist() == [3.0] * 4, t
    """, prelude="""
        import atexit
        import torch.distributed as dist
        # registered first, so it runs after initialize's teardown
        atexit.register(lambda: print("destroyed:", not dist.is_initialized()))
    """)
    assert [o.split() for o in outs] == [["destroyed:", "True"]] * 2


def test_two_process_db_sharded_search(db_env, tmp_path):  # noqa: F811
    """The genome strategy on a 2x4 mesh over 2 processes x 4 CPU slots
    (blocks gathered) and the code strategy on 1x8 (partials summed
    across processes): every process writes the single-process
    distance.out."""
    _run_workers(tmp_path, f"""
        from public_kssd_tpu_torch import search
        os.chdir({db_env!r})
        for strategy, (dp, ref) in (("genome", (2, 4)), ("code", (1, 8))):
            mesh = parallel.make_mesh(dp, ref, "cpu", local_devices=cpu4)
            assert len(mesh.local_slots()) == 4
            search.search("mp_ref", "mp_qry", f"torch_mp_{{strategy}}_{{pid}}",
                          mesh=mesh, shard_strategy=strategy)
    """)
    for strategy in ("genome", "code"):
        for pid in range(2):
            assert_files_equal(
                os.path.join(db_env, "mp_single", "distance.out"),
                os.path.join(db_env, f"torch_mp_{strategy}_{pid}", "distance.out"),
            )


@pytest.fixture(scope="module")
def mp_koc(db_env):  # noqa: F811
    """mp_qry with planted DB codes and synthetic .a abundances, and the
    JAX package's single-process koc search of it."""
    old = os.getcwd()
    os.chdir(db_env)
    try:
        if not os.path.isdir("torch_mp_koc"):
            stat = jax_formats.read_co_stat("mp_qry")
            os.makedirs("torch_mp_koc")
            rng = np.random.default_rng(7)
            per_file = np.zeros(stat.infile_num, np.uint64)
            total = 0
            for c in range(stat.comp_num):
                rc, _ = jax_formats.read_combco("mp_ref", c)
                qc, qi = jax_formats.read_combco("mp_qry", c)
                parts, idx = [], [0]
                for q in range(stat.infile_num):
                    sl = qc[int(qi[q]): int(qi[q + 1])].copy()
                    n_plant = min(sl.size // 2, 150)
                    if rc.size and n_plant:
                        sl[:n_plant] = rng.choice(rc, n_plant, replace=False)
                    sl = np.unique(sl)
                    parts.append(sl)
                    idx.append(idx[-1] + sl.size)
                    per_file[q] += sl.size
                codes = np.concatenate(parts)
                ab = rng.integers(1, 300, size=codes.size).astype(np.uint16)
                jax_formats.write_combco("torch_mp_koc", c, codes,
                                         np.array(idx, np.uint64), ab)
                total += codes.size
            jax_formats.write_co_stat("torch_mp_koc", dataclasses.replace(
                stat, koc=True, ctx_ct=per_file.astype(np.uint32),
                all_ctx_ct=total))
            jax_search.search("mp_ref", "torch_mp_koc", "torch_mp_koc_single",
                              koc=True)
    finally:
        os.chdir(old)
    return os.path.join(db_env, "torch_mp_koc_single", "distance.out")


def test_two_process_sharded_koc_search(db_env, mp_koc, tmp_path):  # noqa: F811
    """--koc-out over a 2-process mesh: the weighted appendix (uint64
    sums, int64 all_reduce under the code strategy) equals the single-
    process JAX search's bytes."""
    _run_workers(tmp_path, f"""
        from public_kssd_tpu_torch import search
        os.chdir({db_env!r})
        for strategy, (dp, ref) in (("genome", (2, 4)), ("code", (1, 8))):
            mesh = parallel.make_mesh(dp, ref, "cpu", local_devices=cpu4)
            search.search("mp_ref", "torch_mp_koc",
                          f"torch_mp_koc_{{strategy}}_{{pid}}", mesh=mesh,
                          koc=True, shard_strategy=strategy)
    """)
    with open(mp_koc) as f:
        single = f.read()
    assert any(ln.split("\t")[2].split("-")[0] not in ("0", "")
               for ln in single.splitlines()[1:])
    for strategy in ("genome", "code"):
        for pid in range(2):
            assert_files_equal(mp_koc, os.path.join(
                db_env, f"torch_mp_koc_{strategy}_{pid}", "distance.out"))


def test_two_process_sharded_composite(tmp_path):
    """composite over a 1x8 mesh of 2 processes x 4 CPU slots: each
    process joins its 4 DB shards, the hits are gathered, and every
    process returns the host report; only process 0 writes .abv files."""
    ref_dir, qry_dir, *_ = _mk_db(tmp_path, n_ref=40, sk=64, n_qry=3, seed=11)
    want = jax_composite.species_abundance(ref_dir, qry_dir, device=False)
    assert want
    _run_workers(tmp_path, f"""
        from public_kssd_tpu_torch.parallel import sharded_composite
        mesh = parallel.make_mesh(1, 8, "cpu", local_devices=cpu4)
        got = sharded_composite.species_abundance_sharded(
            {ref_dir!r}, {qry_dir!r}, mesh)
        with open({str(tmp_path)!r} + f"/got_{{pid}}.txt", "w") as f:
            f.write(got)
        sharded_composite.species_abundance_sharded(
            {ref_dir!r}, {qry_dir!r}, mesh, binvec=True,
            out_dir={str(tmp_path / "abv")!r} + (f"_{{pid}}" if pid else ""))
    """)
    for pid in range(2):
        assert (tmp_path / f"got_{pid}.txt").read_text() == want
    assert os.listdir(tmp_path / "abv")
    assert not os.path.exists(tmp_path / "abv_1")
