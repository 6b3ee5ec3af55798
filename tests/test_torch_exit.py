"""How a kssd_torch process ends: ``cli.entry`` (``python -m
public_kssd_tpu_torch.cli`` and the installed ``kssd_torch``) ends the
process with ``os._exit`` through ``cli.close_out`` once a command has
returned its code, and every other end goes through the interpreter's
exit as it did when the module ran ``sys.exit(main())`` (the old route).
Every process here is a fresh subprocess on the CPU: the outputs and
stdout of a command through the entry are byte-equal to the same command
run in process through ``cli.main``, and its code and stderr on each
failure equal the old route's."""

import os
import subprocess
import sys

import pytest

from conftest import assert_files_equal

from public_kssd_tpu_torch import cli, formats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRY = ["-m", "public_kssd_tpu_torch.cli"]
OLD_ROUTE = ["-c", "import sys; from public_kssd_tpu_torch.cli import main; "
             "sys.exit(main(sys.argv[1:]))"]
# the entry as ``python -m`` runs it, after an atexit handler is registered
WITH_HANDLER = ["-c", "import atexit, runpy, sys\n"
                "atexit.register(lambda: print('atexit ran', file=sys.stderr))\n"
                "sys.argv[0] = 'kssd_torch'\n"
                "runpy.run_module('public_kssd_tpu_torch.cli', run_name='__main__')\n"]
TIMEOUT = 120


def _env(buffered: bool = True) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    env.pop("PYTHONUNBUFFERED", None)
    if not buffered:
        env["PYTHONUNBUFFERED"] = "1"
    return env


def _run(route: list[str], argv: list[str], **kw) -> subprocess.CompletedProcess:
    kw.setdefault("stdout", subprocess.PIPE)
    return subprocess.run([sys.executable, *route, *argv], env=kw.pop("env", _env()),
                          stderr=subprocess.PIPE, timeout=TIMEOUT, **kw)


def _stderr_key(text: bytes) -> list[str]:
    """A process's stderr less the traceback's frames above ``main``,
    where the entry's route and the old route differ."""
    lines = text.decode().splitlines()
    if "Traceback (most recent call last):" not in lines:
        return lines
    head = lines.index("Traceback (most recent call last):")
    frames = next((i for i in range(head, len(lines)) if lines[i].endswith(", in main")),
                  head + 1)
    return lines[:head + 1] + lines[frames:]


def _assert_dirs_equal(a: str, b: str) -> None:
    names = sorted(os.listdir(a))
    assert names and names == sorted(os.listdir(b))
    for n in names:
        assert_files_equal(os.path.join(a, n), os.path.join(b, n), n)


# ------------------------------------------------------- a command that succeeds

@pytest.fixture(scope="module")
def in_process(golden7, tmp_path_factory):
    """Stage I of the query genomes, stage II of the reference genomes'
    sketch and a search, each run in this process through ``cli.main``
    (--device cpu): {step: (argv with OUT for its output dir, output dir,
    stdout)}."""
    import contextlib
    import io

    root = tmp_path_factory.mktemp("exit_in_process")
    shuf = f"{golden7}/fix_k8.shuf"
    co = str(root / "ref_co")
    assert cli.main(["dist", "-L", shuf, "-o", co, f"{golden7}/genomes",
                     "--device", "cpu"]) == 0
    steps = {
        "stage1": ["dist", "-L", shuf, "-o", "OUT", f"{golden7}/qry", "--device", "cpu"],
        "stage2": ["dist", "-o", "OUT", co, "--device", "cpu"],
    }
    out = {}
    for step, argv in steps.items():
        d = str(root / step)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main([d if a == "OUT" else a for a in argv]) == 0
        out[step] = (argv, d, buf.getvalue())
    argv = ["dist", "-r", out["stage2"][1], "-o", "OUT", out["stage1"][1],
            "--device", "cpu"]
    d = str(root / "search")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main([d if a == "OUT" else a for a in argv]) == 0
    out["search"] = (argv, d, buf.getvalue())
    return out


@pytest.mark.parametrize("step", ["stage1", "stage2", "search"])
def test_entry_outputs_equal_in_process(in_process, tmp_path, step):
    """``python -m public_kssd_tpu_torch.cli dist --device cpu`` of stage
    I, stage II and a search: exit 0, the stdout and every output file
    byte-equal to the same command run in process."""
    argv, want, stdout = in_process[step]
    got = str(tmp_path / step)
    r = _run(ENTRY, [got if a == "OUT" else a for a in argv])
    assert r.returncode == 0, r.stderr.decode()[-3000:]
    assert r.stdout.decode() == stdout
    _assert_dirs_equal(want, got)


@pytest.mark.parametrize("step", ["stage1", "search"])
def test_entry_takes_the_fast_end(in_process, tmp_path, step):
    """On success the entry ends the process at ``os._exit``: an atexit
    handler registered before it does not run (no pool thread is left for
    the interpreter to wait for), and the outputs are whole."""
    argv, want, _ = in_process[step]
    got = str(tmp_path / step)
    r = _run(WITH_HANDLER, [got if a == "OUT" else a for a in argv])
    assert r.returncode == 0, r.stderr.decode()[-3000:]
    assert b"atexit ran" not in r.stderr
    _assert_dirs_equal(want, got)


# ------------------------------------------------------------------ set -P

def _names_dir(path: str, n: int, src: str) -> str:
    """A sketch dir whose cofiles.stat holds ``n`` long genome names (the
    stat of ``src`` with its names replaced)."""
    import dataclasses

    import numpy as np

    stat = formats.read_co_stat(src)
    os.makedirs(path)
    names = [f"/data/collection/{i:07d}/GCF_{i:09d}.1_ASM{i:06d}v1_genomic.fna.gz"
             for i in range(n)]
    formats.write_co_stat(path, dataclasses.replace(
        stat, infile_num=n, names=names, ctx_ct=np.ones(n, np.uint32), all_ctx_ct=n))
    return path


@pytest.fixture(scope="module")
def many_names(in_process, tmp_path_factory):
    """A sketch dir whose ``set -P`` prints 2,000 names, 164 KB."""
    return _names_dir(str(tmp_path_factory.mktemp("names") / "many"), 2000,
                      in_process["stage1"][1])


@pytest.mark.parametrize("buffered", [True, False])
def test_set_names_through_a_pipe(many_names, buffered):
    """``set -P`` of more names than a pipe holds (64 KiB), read whole by
    this process: every byte, as ``print_gnames`` prints it in process,
    and exit 0, with stdout buffered or not."""
    import contextlib
    import io

    from public_kssd_tpu_torch import setops

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        setops.print_gnames(many_names)
    want = buf.getvalue().encode()
    assert len(want) > 1 << 16
    r = _run(ENTRY, ["set", "-P", many_names], env=_env(buffered))
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout == want


@pytest.mark.parametrize("size", ["small", "large"])
@pytest.mark.parametrize("buffered", [True, False])
def test_set_names_into_a_closed_pipe(many_names, in_process, tmp_path, size, buffered):
    """``set -P`` into a pipe whose reader has gone: the entry ends with
    the old route's code and stderr (with a buffered stdout, Python 3.12
    reports the failed flush at exit as "Exception ignored" and ends
    with 120, where the output fits the buffer; a write that fails
    inside ``main`` is a traceback and 1)."""
    src = many_names if size == "large" else _names_dir(
        str(tmp_path / "few"), 3, in_process["stage1"][1])
    ends = []
    for route in (ENTRY, OLD_ROUTE):
        r_fd, w_fd = os.pipe()
        os.close(r_fd)
        try:
            r = _run(route, ["set", "-P", src], stdout=w_fd, env=_env(buffered))
        finally:
            os.close(w_fd)
        ends.append((r.returncode, _stderr_key(r.stderr)))
    assert ends[0] == ends[1]
    assert ends[0][0] != 0 and "BrokenPipeError" in ends[0][1][-1]
    if buffered and size == "small":
        assert ends[0][0] == 120 and ends[0][1][0].startswith("Exception ignored")


def test_set_names_with_stdout_closed(in_process):
    """``set -P`` with its stdout descriptor closed (``sys.stdout`` is
    None): the code and stderr of the old route."""
    ends = []
    for route in (ENTRY, OLD_ROUTE):
        r = subprocess.run(["sh", "-c", 'exec "$@" >&-', "sh", sys.executable, *route,
                            "set", "-P", in_process["stage1"][1]],
                           env=_env(), stderr=subprocess.PIPE, timeout=TIMEOUT)
        ends.append((r.returncode, _stderr_key(r.stderr)))
    assert ends[0] == ends[1]


# ---------------------------------------------------------------- failures

FAILURES = {
    # sys.exit with a message, before torch is imported
    "exit_message": ["dist", "-p", "-1", "-o", "x", "y"],
    # argparse's usage error
    "usage": ["dist", "--no-such-flag"],
    # an exception in a host command
    "exception": ["set", "-u", "-o", "OUT", "MISSING"],
    # main's own non-zero code (set's usage line, -1)
    "code": ["set"],
}


@pytest.mark.parametrize("case", sorted(FAILURES))
def test_failure_ends_as_the_old_route(tmp_path, case):
    """A failing command through the entry: the exit code, stdout and
    stderr (the traceback from ``main`` down) of the old route."""
    argv = [str(tmp_path / a) if a in ("OUT", "MISSING") else a for a in FAILURES[case]]
    ends = []
    for route in (ENTRY, OLD_ROUTE):
        r = _run(route, argv)
        ends.append((r.returncode, r.stdout, _stderr_key(r.stderr)))
    assert ends[0] == ends[1]
    assert ends[0][0] != 0
    if case == "exception":
        assert ends[0][2][0] == "Traceback (most recent call last):"
        assert ends[0][2][1].endswith(", in main")


def test_shuf_mismatch_ends_as_the_old_route(in_process, golden7, tmp_path):
    """A search of a query sketched with another .shuf (``ShufIdMismatch``
    raised in the search, as phase 4 of chip_smoke.py runs it on a card):
    the same code and traceback through the entry as through the old
    route."""
    shuf = str(tmp_path / "other")
    assert cli.main(["shuffle", "-k", "8", "-s", "5", "-l", "2", "--seed", "7",
                     "-o", shuf]) == 0
    qry = str(tmp_path / "qry")
    assert cli.main(["dist", "-L", shuf + ".shuf", "-o", qry, f"{golden7}/qry",
                     "--device", "cpu"]) == 0
    argv = ["dist", "-r", in_process["stage2"][1], "-o", str(tmp_path / "out"), qry,
            "--device", "cpu"]
    ends = []
    for route in (ENTRY, OLD_ROUTE):
        r = _run(route, argv)
        ends.append((r.returncode, r.stdout, _stderr_key(r.stderr)))
    assert ends[0] == ends[1]
    assert ends[0][0] == 1 and "ShufIdMismatch" in ends[0][2][-1]


def test_keyboard_interrupt_ends_as_the_old_route():
    """A KeyboardInterrupt out of ``main`` passes through the entry: the
    code and stderr the interpreter gives it on the old route."""
    patch = ("import sys\nfrom public_kssd_tpu_torch import cli\n"
             "def main(argv=None):\n    raise KeyboardInterrupt\n"
             "cli.main = main\n")
    ends = []
    for call in ("cli.entry()", "cli.main()"):
        r = _run(["-c", patch + f"sys.exit({call})"], [])
        ends.append((r.returncode, r.stderr.decode().splitlines()[-1]))
    assert ends[0] == ends[1]
    assert ends[0][1] == "KeyboardInterrupt"


def test_failure_runs_the_interpreters_exit(tmp_path):
    """A command that fails through the entry ends through the
    interpreter's exit: the atexit handler runs."""
    r = _run(WITH_HANDLER, ["set", "-u", "-o", str(tmp_path / "o"),
                            str(tmp_path / "missing")])
    assert r.returncode == 1
    assert r.stderr.decode().splitlines()[-1] == "atexit ran"


def test_live_thread_keeps_the_interpreters_exit(in_process, tmp_path):
    """A thread that is not a daemon and still runs when ``main`` returns
    is waited for, as the interpreter's exit waits: its file is written
    and the atexit handler runs. The thread starts its sleep only once
    ``close_out`` has returned, so it is alive there however long the
    import and ``main`` take; a ``close_out`` that ended the process
    would leave the file unwritten."""
    mark = tmp_path / "late"
    code = ("import atexit, sys, threading, time\n"
            "atexit.register(lambda: print('atexit ran', file=sys.stderr))\n"
            "closed = threading.Event()\n"
            "def late():\n    closed.wait()\n    time.sleep(0.5)\n"
            f"    open({str(mark)!r}, 'w').write('done')\n"
            "threading.Thread(target=late).start()\n"
            "from public_kssd_tpu_torch import cli\n"
            "close_out = cli.close_out\n"
            "def closing(rc):\n    try:\n        return close_out(rc)\n"
            "    finally:\n        closed.set()\n"
            "cli.close_out = closing\n"
            "sys.exit(cli.entry(sys.argv[1:]))\n")
    r = _run(["-c", code], ["set", "-P", in_process["stage1"][1]])
    assert r.returncode == 0, r.stderr.decode()
    assert mark.read_text() == "done"
    assert r.stderr.decode().splitlines()[-1] == "atexit ran"


def test_close_out_returns_a_code_that_is_not_an_int():
    """``close_out`` of a code ``sys.exit`` would print returns it, in
    this process."""
    assert cli.close_out("a message") == "a message"


def test_two_process_group_survives_the_close_out(tmp_path):
    """Two gloo workers end through the close-out with their group up:
    the close-out returns, and the group's teardown still runs at the
    interpreter's exit before a handler registered before it."""
    import socket
    import textwrap

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    worker = tmp_path / "worker.py"
    worker.write_text(textwrap.dedent(f"""
        import atexit, sys
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        from public_kssd_tpu_torch import cli
        from public_kssd_tpu_torch.parallel import distributed
        # registered first, so it runs after initialize's teardown
        atexit.register(lambda: print("destroyed:", not dist.is_initialized()))
        pid, world = distributed.initialize("127.0.0.1:{port}", 2, int(sys.argv[1]),
                                            device="cpu")
        t = torch.full((4,), float(pid + 1))
        dist.all_reduce(t)
        assert t.tolist() == [3.0] * 4, t
        sys.exit(cli.close_out(0))
    """))
    procs = [subprocess.Popen([sys.executable, str(worker), str(i)], env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for i in range(2)]
    try:
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, err.decode()[-3000:]
            outs.append(out.decode().split())
    finally:
        for p in procs:
            p.kill()
    assert outs == [["destroyed:", "True"]] * 2
