"""The start of a kssd_torch dist call: stage I's parse pool started
before the .shuf is read (pipeline.ParsedStreams), the card started on a
thread (start.CardStart) only for a command that runs work on a card,
and the package's import without torch. On the CPU: the CLI's outputs
byte-equal to the JAX package's with the early pool, failures before the
first genome or of the card's start leave no thread behind, and a
--device cpu run never reaches the start."""

import os
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import assert_co_stat_equal, assert_files_equal

from public_kssd_tpu import cli as jax_cli
from public_kssd_tpu_torch import cli, formats, pipeline, start, stattab
from public_kssd_tpu_torch.ops import staging

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _threads(prefix: str) -> list[str]:
    return [t.name for t in threading.enumerate()
            if t.name.startswith(prefix) and t.is_alive()]


def _record_order(monkeypatch, calls: list[str]) -> None:
    """Log, in ``calls``, when the CLI makes its parse stream and when it
    reads the .shuf."""
    made, read = pipeline.parsed_streams, formats.read_shuf

    def parsed_streams(*a, **k):
        calls.append("pool")
        return made(*a, **k)

    def read_shuf(*a, **k):
        calls.append("shuf")
        return read(*a, **k)

    monkeypatch.setattr(pipeline, "parsed_streams", parsed_streams)
    monkeypatch.setattr(formats, "read_shuf", read_shuf)


# ---------------------------------------------------------- the early pool

@pytest.mark.parametrize("route", ["ref", "query"])
def test_cli_stage1_early_pool_matches_jax(golden7, tmp_path, monkeypatch, route):
    """dist -r <seqs> and dist <seqs> with the pool started before the
    .shuf read: combco.* and cofiles.stat byte-equal to kssd_tpu's."""
    shuf = f"{golden7}/fix_k8.shuf"
    seqs = f"{golden7}/genomes" if route == "ref" else f"{golden7}/qry"
    calls: list[str] = []
    _record_order(monkeypatch, calls)
    outs = {}
    for main, tag, extra in ((jax_cli.main, "jax", []),
                             (cli.main, "torch", ["--device", "cpu"])):
        out = str(tmp_path / tag)
        argv = (["dist", "-r", seqs, "-L", shuf, "-o", out, "--no-dense-index"]
                if route == "ref" else ["dist", "-L", shuf, "-o", out, seqs])
        assert main(argv + extra) == 0
        outs[tag] = out
    assert calls == ["pool", "shuf"]
    names = sorted(n for n in os.listdir(outs["jax"]) if n.startswith("combco."))
    assert names and names == sorted(
        n for n in os.listdir(outs["torch"]) if n.startswith("combco."))
    for n in names:
        assert_files_equal(f"{outs['jax']}/{n}", f"{outs['torch']}/{n}", n)
    assert_co_stat_equal(outs["jax"], outs["torch"])
    assert not _threads("kssd-parse")


@pytest.mark.parametrize("bad", ["truncated", "missing_dir"])
def test_shuf_failure_after_the_pool_started(golden7, tmp_path, monkeypatch, bad):
    """A .shuf that fails to load after the pool has started fails the
    command with the error the .shuf read raises alone, and no pool
    thread is left."""
    shuf = tmp_path / "bad.shuf"
    if bad == "truncated":
        with open(f"{golden7}/fix_k8.shuf", "rb") as f:
            shuf.write_bytes(f.read()[:100])
    else:
        shuf.write_bytes(b"")
    with pytest.raises(Exception) as alone:
        formats.read_shuf(str(shuf), component_sz=7)
    calls: list[str] = []
    _record_order(monkeypatch, calls)
    with pytest.raises(type(alone.value)) as got:
        cli.main(["dist", "-L", str(shuf), "-o", str(tmp_path / "o"),
                  f"{golden7}/genomes", "--device", "cpu"])
    assert str(got.value) == str(alone.value)
    assert calls == ["pool", "shuf"]
    assert not _threads("kssd-parse")


def _stub_parse(monkeypatch, seen: list, gate: threading.Event | None = None):
    def parse_one(path, opts):
        seen.append(path)
        if gate is not None:
            assert gate.wait(10)
        if path.endswith("bad"):
            raise ValueError(f"cannot parse {path}")
        return np.full(3, len(path), np.uint8)

    monkeypatch.setattr(pipeline, "parse_one", parse_one)


def test_parsed_streams_submit_when_made(monkeypatch):
    """The first 2 x workers parses run before the first next; the rest
    follow one a genome taken, in order."""
    seen: list[str] = []
    _stub_parse(monkeypatch, seen)
    paths = [f"g{i}" for i in range(9)]
    stream = pipeline.parsed_streams(paths, pipeline.SketchOptions(), workers=2)
    deadline = time.monotonic() + 10
    while len(seen) < 4 and time.monotonic() < deadline:
        time.sleep(0.001)
    time.sleep(0.05)
    assert sorted(seen) == paths[:4]
    got = [(i, p, s.tolist()) for i, p, s in stream]
    assert got == [(i, p, [len(p)] * 3) for i, p in enumerate(paths)]
    assert sorted(seen) == sorted(paths)
    assert not _threads("kssd-parse")


def test_parsed_streams_close_stops_the_pool(monkeypatch):
    """close() before the end cancels the parses not started and waits
    for the running ones: no pool thread is left."""
    seen: list[str] = []
    gate = threading.Event()
    _stub_parse(monkeypatch, seen, gate)
    with pipeline.parsed_streams([f"g{i}" for i in range(50)],
                                 pipeline.SketchOptions(), workers=3):
        assert _threads("kssd-parse")
        gate.set()
    assert not _threads("kssd-parse")
    assert len(seen) <= 6


def test_parsed_streams_parse_error_at_next(monkeypatch):
    """A parse that raises raises at its next, and the pool is closed."""
    _stub_parse(monkeypatch, [])
    stream = pipeline.parsed_streams(["g0", "g1bad", "g2"], pipeline.SketchOptions(),
                                     workers=2)
    assert next(stream)[1] == "g0"
    with pytest.raises(ValueError, match="cannot parse g1bad"):
        next(stream)
    assert not _threads("kssd-parse")


def test_run_stage1_refuses_a_stream_of_other_files(monkeypatch):
    _stub_parse(monkeypatch, [])
    with pipeline.parsed_streams(["a", "b"], pipeline.SketchOptions()) as stream:
        with pytest.raises(ValueError, match="not a parse of input_files"):
            pipeline.run_stage1(["b", "a"], "unused", None, None, stream=stream,
                                device=torch.device("cpu"))


# ---------------------------------------------------------- the card's start

def test_card_start_reraises_at_join(monkeypatch):
    """The thread's exception is raised by join (every time), close raises
    nothing, and the thread has ended either way."""
    class Boom(RuntimeError):
        pass

    def cuinit(ordinal):
        raise Boom(f"no card {ordinal}")

    monkeypatch.setattr(start, "_cuinit", cuinit)
    monkeypatch.setattr(start, "_fresh", lambda: True)
    card = start.CardStart("cuda:3", ("sketch",))
    card.close()
    for _ in range(2):
        with pytest.raises(Boom, match="no card 3"):
            card.join()
    assert not _threads("kssd-card-start")


def test_card_start_steps(monkeypatch):
    """In a process that has imported torch, the start skips ``cuInit`` and
    does the rest on its thread: the libraries of its work, the context on
    the named card, the staging sets of its work, in that order."""
    steps = []
    monkeypatch.setattr(start, "_cuinit", lambda o: steps.append(("cuinit", o)))
    monkeypatch.setattr(start, "_context", lambda d: steps.append(("context", str(d))))
    from public_kssd_tpu_torch import index, kernels
    from public_kssd_tpu_torch.ops import sketch

    monkeypatch.setattr(kernels.CudaKernel, "library",
                        lambda k: steps.append(("library", k.name)))
    monkeypatch.setattr(staging, "prepare",
                        lambda d, b, c=staging.STAGING_BUFFERS:
                        steps.append(("staging", str(d), b, c)))
    card = start.CardStart("cuda:1", ("sketch", "count", "index"))
    card.join()
    assert steps == [
        ("library", "sketch"), ("library", "sketch_wide"),
        ("library", "count"), ("library", "count_koc"),
        ("context", "cuda:1"),
        ("staging", "cuda:1", sketch.STREAM_BLOCK, staging.STAGING_BUFFERS),
        ("staging", "cuda:1", index.INDEX_BLOCK, index.INDEX_READ_THREADS + 2),
    ]


def test_card_start_without_libcuda():
    """Where libcuda.so.1 does not load, the start fails with the reason and the
    CPU route to take."""
    try:
        import ctypes

        ctypes.CDLL("libcuda.so.1")
    except OSError:
        pass
    else:
        pytest.skip("libcuda.so.1 loads here")
    with pytest.raises(RuntimeError, match="libcuda.so.1.*--device cpu"):
        start._cuinit(0)


def _fake_card(monkeypatch, fail: BaseException | None = None) -> list:
    """resolve_device("cuda") gives cuda:0 and the start's steps are
    logged (or its cuInit step raises ``fail``): a card's route runs on
    the CPU up to its first device call."""
    import public_kssd_tpu_torch as port

    real = port.resolve_device
    log = []

    def resolve(name):
        return torch.device("cuda", 0) if str(name) == "cuda" else real(name)

    def cuinit(ordinal):
        log.append("cuinit")
        if fail is not None:
            raise fail

    monkeypatch.setattr(port, "resolve_device", resolve)
    monkeypatch.setattr(start, "_cuinit", cuinit)
    monkeypatch.setattr(start, "_fresh", lambda: True)
    return log


@pytest.mark.parametrize("route", ["stage1", "search"])
def test_failed_card_start_fails_the_command(golden7, tmp_path, monkeypatch, route):
    """The start's failure is raised at the route's first device call
    (after the pool has started, for stage I), and neither the start's
    thread nor the pool's are left; no device work was begun."""
    class NoCard(RuntimeError):
        pass

    if route == "stage1":
        argv = ["dist", "-L", f"{golden7}/fix_k8.shuf", "-o", str(tmp_path / "o"),
                f"{golden7}/genomes"]
    else:
        ref, qry = _search_dirs(golden7, tmp_path)
        argv = ["dist", "-r", ref, "-o", str(tmp_path / "s"), qry]
    _fake_card(monkeypatch, NoCard("the card did not start"))
    began = []
    monkeypatch.setattr("public_kssd_tpu_torch.shufspace.detect",
                        lambda *a: began.append("detect"))
    monkeypatch.setattr("public_kssd_tpu_torch.index.load_device_index",
                        lambda *a: began.append("load"))
    with pytest.raises(NoCard, match="did not start"):
        cli.main(argv)
    assert began == []
    assert not _threads("kssd-parse") and not _threads("kssd-card-start")


def _search_dirs(golden7, tmp_path) -> tuple[str, str]:
    """An indexed reference dir and a query sketch dir, made on the CPU."""
    ref, qry = str(tmp_path / "ref"), str(tmp_path / "qry")
    shuf = f"{golden7}/fix_k8.shuf"
    assert cli.main(["dist", "-r", f"{golden7}/genomes", "-L", shuf, "-o", ref,
                     "--no-dense-index", "--device", "cpu"]) == 0
    assert cli.main(["dist", "-L", shuf, "-o", qry, f"{golden7}/qry",
                     "--device", "cpu"]) == 0
    return ref, qry


def test_card_start_joined_before_the_first_device_call(golden7, tmp_path, monkeypatch):
    """On a card's route the start is made before torch is imported (in a
    fresh process) and joined before the .shuf check and before the index
    load; the search's stat files are read before the join."""
    ref, qry = _search_dirs(golden7, tmp_path)
    log = _fake_card(monkeypatch)
    events = []
    real_join = start.CardStart.join

    def join(self):
        events.append("join")
        return real_join(self)

    monkeypatch.setattr(start.CardStart, "join", join)
    monkeypatch.setattr(start, "_context", lambda d: events.append("context"))
    from public_kssd_tpu_torch import kernels

    monkeypatch.setattr(kernels.CudaKernel, "library", lambda k: None)
    monkeypatch.setattr(staging, "prepare", lambda *a: events.append("staging"))
    monkeypatch.setattr("public_kssd_tpu_torch.shufspace.detect",
                        lambda *a: events.append("detect") or SimpleNamespace())

    class Stop(Exception):
        pass

    def stop(*a):
        events.append("device work")
        raise Stop

    monkeypatch.setattr("public_kssd_tpu_torch.ops.sketch.as_shuf", stop)
    with pytest.raises(Stop):
        cli.main(["dist", "-L", f"{golden7}/fix_k8.shuf", "-o", str(tmp_path / "o"),
                  f"{golden7}/genomes"])
    assert log == ["cuinit"]
    assert events.index("join") < events.index("detect") < events.index("device work")
    assert events.count("staging") == 1 and events.index("context") < events.index("detect")

    events.clear()
    read = stattab.read_co_stat_table  # the search's stat reader
    monkeypatch.setattr(stattab, "read_co_stat_table",
                        lambda *a, **k: events.append("stats") or read(*a, **k))
    monkeypatch.setattr("public_kssd_tpu_torch.index.load_device_index", stop)
    with pytest.raises(Stop):
        cli.main(["dist", "-r", ref, "-o", str(tmp_path / "s"), qry])
    assert events.index("stats") < events.index("join") < events.index("device work")
    assert not _threads("kssd-card-start")


def test_device_cpu_never_starts_the_card(golden7, tmp_path, monkeypatch):
    """A --device cpu run reaches no start and no CUDA call: a start, a
    cuInit step and torch's CUDA entry points that raise leave it
    passing, byte-equal to the run without them."""
    def refuse(*a, **k):
        raise AssertionError("a --device cpu run reached the card's start")

    shuf = f"{golden7}/fix_k8.shuf"
    argv = ["dist", "-r", f"{golden7}/genomes", "-L", shuf, "--no-dense-index",
            "--device", "cpu"]
    assert cli.main([*argv, "-o", str(tmp_path / "plain")]) == 0
    monkeypatch.setattr(start.CardStart, "__init__", refuse)
    monkeypatch.setattr(start, "_cuinit", refuse)
    for name in ("is_available", "current_device", "_lazy_init", "init",
                 "synchronize"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    assert cli.main([*argv, "-o", str(tmp_path / "ref")]) == 0
    assert cli.main(["dist", "-L", shuf, "-o", str(tmp_path / "qry"),
                     f"{golden7}/qry", "--device", "cpu"]) == 0
    assert cli.main(["dist", "-r", str(tmp_path / "ref"), "-o", str(tmp_path / "out"),
                     str(tmp_path / "qry"), "--device", "cpu"]) == 0
    for n in os.listdir(tmp_path / "plain"):
        assert_files_equal(str(tmp_path / "plain" / n), str(tmp_path / "ref" / n), n)


def _tree(tmp_path) -> dict[str, str]:
    """Inputs of each kind the dispatch tells apart: raw sequences, a
    sketch dir, an indexed sketch dir."""
    d = {"raw": tmp_path / "raw", "co": tmp_path / "co", "co2": tmp_path / "co2",
         "mco": tmp_path / "mco"}
    for p in d.values():
        p.mkdir()
    (d["raw"] / "g.fa").write_text(">g\nACGT\n")
    for k in ("co", "co2", "mco"):
        (d[k] / formats.CO_DSTAT).write_bytes(b"")
    (d["mco"] / formats.MCO_DSTAT).write_bytes(b"")
    return {k: str(v) for k, v in d.items()}


WORK_CASES = [
    # (arguments, the start's work; None: no start)
    (["-r", "raw", "-L", "x.shuf"], ("sketch",)),
    (["-r", "raw", "-L", "x.shuf", "co"], ("sketch", "count", "index")),
    (["-r", "mco", "co"], ("count", "index")),
    (["-r", "mco", "co", "--koc-out"], ("count", "index")),
    (["-r", "mco", "co", "--mesh", "1x1"], ("count", "index")),
    (["-r", "mco", "co", "--cpu-count"], None),
    (["-r", "mco", "co", "-f", "skf.dat"], None),
    (["-r", "mco"], None),
    (["-r", "co"], None),
    (["-r", "co", "--device-index"], ()),
    (["-L", "x.shuf", "raw"], ("sketch",)),
    (["-L", "3", "raw", "--byread"], ("sketch",)),
    (["-l", "list.txt"], ("sketch",)),
    (["co"], None),
    (["co", "--device-index"], ()),
    (["co", "co2"], None),
    (["co", "co2", "--device-index"], None),
    (["--shard", "0:2", "raw"], ("sketch",)),
    (["--merge-shards", "co"], None),
    (["-L", "x.shuf", "raw", "--device", "cpu"], None),
    (["-r", "mco", "co", "--device", "cpu"], None),
]


@pytest.mark.parametrize("argv,work", WORK_CASES, ids=[" ".join(a) for a, _ in WORK_CASES])
def test_card_work_follows_the_dispatch(tmp_path, argv, work):
    paths = _tree(tmp_path)
    argv = [paths.get(a, a) for a in argv]
    parser_args = []

    def capture(args):
        parser_args.append(args)
        return 0

    real = cli._cmd_dist
    cli._cmd_dist = capture
    try:
        cli.main(["dist", "-o", str(tmp_path / "out"), *argv])
    finally:
        cli._cmd_dist = real
    args = parser_args[0]
    assert cli._card_work(args, cli._dist_steps(args)) == work


def test_staging_prepare_is_what_borrow_finds():
    dev = torch.device("cpu")
    staging.prepare(dev, 96, 2)
    with staging.borrow(dev, 96, 2) as st:
        made = st
        assert st.count == 2 and st.host[0].size == 96
    staging.prepare(dev, 96, 2)  # one is kept there already
    with staging.borrow(dev, 96, 2) as st:
        assert st is made
    assert len(staging._SETS[(dev, 96, 2)]) == 1


def test_package_and_cli_import_no_torch():
    """Importing the package and its CLI imports no torch, and neither does
    a host command; a dist command imports it."""
    code = (
        "import sys\n"
        "import public_kssd_tpu_torch, public_kssd_tpu_torch.cli as cli\n"
        "assert 'torch' not in sys.modules, 'imported'\n"
        "assert cli.main(['primer']) == 0\n"
        "assert 'torch' not in sys.modules, 'primer'\n"
        "cli.main(['dist', '-o', sys.argv[1], '--device', 'cpu'])\n"
        "assert 'torch' in sys.modules\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code, os.path.join(REPO, "build", "x")],
                       capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


def test_no_card_cli_exits_nonzero_with_the_reason(tmp_path):
    """kssd_torch dist on a host with no card, as a user runs it: a
    nonzero exit naming --device cpu, and no output written."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    fa = tmp_path / "seqs"
    fa.mkdir()
    (fa / "g.fa").write_text(">g\n" + "ACGT" * 100 + "\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m", "public_kssd_tpu_torch.cli", "dist",
                        "-L", "3", "-o", str(tmp_path / "o"), str(fa)],
                       capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode != 0
    assert "--device cpu" in r.stderr
    assert not (tmp_path / "o" / formats.CO_DSTAT).exists()
