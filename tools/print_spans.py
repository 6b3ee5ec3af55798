"""Where a search call's ``load_index``, ``count`` and ``print`` stages
spend their time.

Runs the benchmark's search call (``bench_torch``'s cell
``search_L3K10_1000x10k``: 1,000 query sketches against 10,000
reference sketches of 1,300 codes, the whole 10,000,001-line
``distance.out`` printed) and splits the main thread's stages into
their spans. ``load_index`` (on one device, ``index.load_device_index``:
the index files read into pinned staging buffers and uploaded as they
are read):

* ``index.read``: waiting for a staging buffer's read;
* ``index.wait``: a staging buffer waiting for its upload to end before
  it is read into again;
* ``index.directory``: the checks (postings total, genome ids) and the
  bucket directory;
* ``load_index``: the rest of the stage (opening the files, allocating
  the device tensors, queuing the uploads).

``load_spans`` holds these, ``index_bytes`` the index files' bytes,
``read_gb_s`` those bytes over ``index.read`` (the reads' rate as the
main thread waits for them) and ``load_gb_s`` over the whole stage.
``count``:

* ``count.queries``: reading the query sketches, their query ids and
  segments, and their upload;
* ``count.index``: ``DeviceIndex.from_sparse``, which returns the index
  ``load_index`` loaded (a cache hit; on a parent tree without the
  loader, the index's upload and its bucket directory);
* ``count.kernel``: the count kernel's wrapper call;
* ``count.fetch``: the count matrix coming back to the host;
* ``count.skf``: writing ``sharedk_ct.dat``;
* ``count``: the rest of the stage.

``stat.read``: reading a stat file (``formats.read_co_stat`` and
``read_mco_stat``, and ``stattab.read_co_stat_table`` and
``read_mco_stat_table`` where the tree has them), wherever it runs:
``stat_read_s`` splits its seconds a call by the stage it ran in
(``outside``: before the first stage; a tree whose loader reads
mcofiles.stat again does so in ``load_index``). ``outside_s`` is the
mean wall less the mean of the logged stages.

``print``:

* ``print.names``: the formatter's name tables (``native.Names``, the
  query's and the references');
* ``print.wait``: waiting for the next block of lines from the
  formatting threads (``ops/stats.py`` ``_write_native``);
* ``print.write``: writing a formatted block to ``distance.out``;
* ``print``: the rest of the stage (the header, cutting the blocks,
  submitting them).

``--clock N`` times N unprofiled calls in this process with the spans
read on the host clock (``tools/stage1_spans.py``'s ``HostClock``: no
profiler, so no per-op overhead) and reports each span's mean self
seconds a call, and each logged stage's mean. ``--calls N`` runs N
calls with ``--profile`` in fresh processes and reports each trace's
span self times, idle share and longest idle gaps by innermost span.
Both report the ``load_index`` and ``count`` spans again under
``load_spans`` and ``count_spans``. ``write_floor_s`` is the seconds
one thread takes to write as many bytes as the call's ``distance.out``
from memory, in blocks of 16 MiB, into a file beside it: what the write
costs with no formatting at all; ``write_floor_par_s`` the same bytes
written by ``dist -p`` threads, each ``pwrite``-ing whole blocks at
their known offsets.

``--fresh N`` runs N calls in fresh processes without the profiler,
through ``tools/fresh_start.py``: each process's wall, where its start
went (the interpreter, ``import torch``, the port's imports, the
arguments, ``resolve_device``, the context, the staging sets, each
kernel library's load and first launch, the stages it logged, the exit),
its peak resident host memory (``max_rss_mb``, /proc/<pid>/statm sampled
every 5 ms) split into anonymous and file-backed memory, and the median
of each piece over the N runs. The printed line leaves out each run's
spans; ``--out`` keeps them.

``--exit N`` and ``--compare N --parent DIR`` run the call in fresh
processes in turns, N rounds (``fresh_start.exit_ways``: the three ways a
process ends; ``fresh_start.compare``: the parent checkout's port against
this one's).

``--load`` loads the reference index onto the device in fresh
processes (the card touched first, so no load pays for CUDA's start),
once per route: the host route (``load_sparse_index``'s ``np.fromfile``,
then ``DeviceIndex.from_sparse``) and ``index.load_device_index`` on 1,
2, 4 and 8 read threads (``index.INDEX_READ_THREADS``); for each, the
first load of the process (``first_s``, pinning the staging buffers
included) and the mean of the next ones (``next_mean_s``), their spans,
read and load rates, and how far the first load raised the process's
resident memory (``rss_growth_mb``, the host arrays of the host route
held as a search holds them). On a tree without
``load_device_index`` only the host route runs.

``--refs 100000 --queries 10 --calls 0 --load`` times a screen: a few
queries against an index of GTDB's order (130M postings).

``--reuse`` keeps the work directory's sketches and index when they were
made for the same shape and seed (and makes them when not), and leaves
them in place: so that a parent tree's copy of this tool can time the
same database (``--work`` of the first run).

Run from the checkout's root, on a card::

    python3 tools/print_spans.py [--clock 3] [--calls 1] [--threads 0]
                                 [--fresh N] [--exit N] [--compare N --parent DIR]
                                 [--load] [--refs N] [--queries N]
                                 [--seed N] [--work DIR] [--reuse] [--out FILE]

One JSON line per run on stdout, the last line a summary with the device
name; ``--out`` also writes them to a file.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bench_torch import data  # noqa: E402
from bench_torch.run import SEARCH, SEED, device_names, search_dirs  # noqa: E402
import fresh_start  # noqa: E402
from stage1_spans import brief, clocked_calls, profiled_call  # noqa: E402

BLOCK = 16 << 20


def write_floor(path: str, n_bytes: int, reps: int, block: int = BLOCK) -> list[float]:
    """Seconds to write ``n_bytes`` from one buffer to ``path`` in
    ``block``-byte writes, ``reps`` times (the file is removed after
    each)."""
    import numpy as np

    buf = memoryview(np.full(block, ord("x"), np.uint8))
    out = []
    for _ in range(reps):
        t = time.perf_counter()
        with open(path, "wb") as f:
            left = n_bytes
            while left > 0:
                f.write(buf[:min(left, block)])
                left -= block
        out.append(time.perf_counter() - t)
        os.remove(path)
    return out


def write_floor_par(path: str, n_bytes: int, threads: int, reps: int,
                    block: int = BLOCK) -> list[float]:
    """Seconds for ``threads`` threads to write ``n_bytes`` to ``path``,
    each ``os.pwrite``-ing whole ``block``-byte pieces (one buffer each)
    at their offsets, ``reps`` times (the file is removed after each)."""
    import numpy as np

    bufs = [memoryview(np.full(block, ord("x"), np.uint8)) for _ in range(threads)]
    offsets = range(0, n_bytes, block)
    out = []
    for _ in range(reps):
        t = time.perf_counter()
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            def part(i: int) -> None:
                for off in offsets[i::threads]:
                    n = min(block, n_bytes - off)
                    if os.pwrite(fd, bufs[i][:n], off) != n:
                        raise OSError(f"short pwrite at {off}")

            with ThreadPoolExecutor(threads) as pool:
                list(pool.map(part, range(threads)))
        finally:
            os.close(fd)
        out.append(time.perf_counter() - t)
        os.remove(path)
    return out


def stage_spans(self_s: dict[str, float], stage: str, prefix: str) -> dict[str, float]:
    """A stage's own entries of a span -> self time map: the stage's self
    time and its spans, named ``prefix``."""
    return {k: v for k, v in self_s.items() if k == stage or k.startswith(prefix)}


def count_spans(self_s: dict[str, float]) -> dict[str, float]:
    """The ``count`` stage's own entries of a span -> self time map."""
    return stage_spans(self_s, "count", "count.")


def load_spans(self_s: dict[str, float]) -> dict[str, float]:
    """The ``load_index`` stage's own entries of a span -> self time map."""
    return stage_spans(self_s, "load_index", "index.")


_INDEX_FILE = re.compile(r"mco\.(uniq\.|csroff\.)?\d+$")


def index_bytes(sref: str) -> int:
    """The bytes of an index directory's CSR files (mco.uniq.<c>,
    mco.csroff.<c>, mco.<c>)."""
    return sum(os.path.getsize(os.path.join(sref, n)) for n in os.listdir(sref)
               if _INDEX_FILE.match(n))


def rates(n_bytes: int, read_s: float | None, load_s: float | None) -> dict:
    """GB/s of the index's bytes over the reads' wait and the whole load."""
    return {"index_bytes": n_bytes,
            "read_gb_s": n_bytes / read_s / 1e9 if read_s else None,
            "load_gb_s": n_bytes / load_s / 1e9 if load_s else None}


def resident_mb(pid: int | str = "self") -> float | None:
    """A process's resident memory now (/proc/<pid>/statm), in MiB; None
    once it has exited."""
    try:
        with open(f"/proc/{pid}/statm") as f:
            pages = int(f.read().split()[1])
    except (FileNotFoundError, ProcessLookupError, IndexError, ValueError):
        return None
    return pages * os.sysconf("SC_PAGE_SIZE") / 2**20


def fresh_calls(argv: list[str], n: int, timeout: float = 900) -> dict:
    """n calls of ``argv`` in fresh processes, unprofiled, through
    ``fresh_start.fresh_runs``: each process's wall (imports and the CUDA
    start included), where its start went (``pieces``), the stages its
    search logged and its peak resident memory, split into anonymous and
    file-backed memory; the medians over the runs."""
    runs = fresh_start.fresh_runs(argv, n, timeout, clean=argv[argv.index("-o") + 1])
    return {**fresh_start.summary(runs),
            "stages_s": [r["at"]["stages"] for r in runs], "runs": runs}


@contextlib.contextmanager
def stat_spans():
    """Spans ``stat.read`` around the stat readers and ``print.names``
    around ``native.Names``, for clocked calls (the spans go to whatever
    ``torch.profiler.record_function`` is when they run). Yields a dict:
    the stage a stat read ran in (the outermost open span; ``outside``
    when none) -> its seconds."""
    import torch

    from public_kssd_tpu_torch import formats, native

    try:
        from public_kssd_tpu_torch import stattab
    except ImportError:  # a tree that reads every stat file as a list
        stattab = None
    where: dict[str, float] = {}

    def spanned(name, fn):
        def wrapped(*a, **k):
            rf = torch.profiler.record_function
            stack = getattr(rf, "_stack", None)
            t = time.perf_counter()
            try:
                with rf(name):
                    return fn(*a, **k)
            finally:
                if name == "stat.read":
                    stage = stack[0][0] if stack else "outside"
                    where[stage] = where.get(stage, 0.0) + time.perf_counter() - t
        return wrapped

    wraps = [(formats, "read_co_stat", "stat.read"),
             (formats, "read_mco_stat", "stat.read"), (native, "Names", "print.names")]
    if hasattr(stattab, "read_co_stat_table"):
        wraps += [(stattab, "read_co_stat_table", "stat.read"),
                  (stattab, "read_mco_stat_table", "stat.read")]
    saved = [(m, f, getattr(m, f)) for m, f, _ in wraps]
    for m, f, name in wraps:
        setattr(m, f, spanned(name, getattr(m, f)))
    try:
        yield where
    finally:
        for m, f, fn in saved:
            setattr(m, f, fn)


def load_child(sref: str, route: str, threads: int, reps: int, device: str) -> dict:
    """In this (fresh) process: the reference index of ``sref`` loaded
    onto ``device`` ``reps`` + 1 times by ``route`` ("host":
    ``load_sparse_index`` and ``DeviceIndex.from_sparse``; "device":
    ``index.load_device_index`` on ``threads`` read threads); the first
    load's seconds and spans, the mean of the rest, and how far the
    first raised the resident memory while its result (and, on the host
    route, the host arrays a search holds) is alive. The card is touched once
    before, so no load pays for the process's CUDA start."""
    import torch

    from public_kssd_tpu_torch import index as index_mod, resolve_device
    from public_kssd_tpu_torch.ops import count
    from stage1_spans import HostClock

    dev = resolve_device(device)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    torch.zeros(1, device=dev)
    sync()
    clock = HostClock()
    torch.profiler.record_function = clock
    if route == "device":
        index_mod.INDEX_READ_THREADS = threads
    n_bytes = index_bytes(sref)
    rss0 = resident_mb()
    times, spans = [], []
    for _ in range(reps + 1):
        clock.self_s.clear()
        t = time.perf_counter()
        if route == "host":
            _, held = index_mod.load_sparse_index(sref)  # search holds them
            comps = [count.DeviceIndex.from_sparse(sp, dev) for sp in held]
        else:
            _, comps = index_mod.load_device_index(sref, dev)
            held = None
        sync()
        times.append(time.perf_counter() - t)
        spans.append(dict(clock.self_s))
        if len(times) == 1:
            rss1 = resident_mb()
        del comps, held
    nxt = times[1:] or times
    read_next = sum(sp.get("index.read", 0.0) for sp in spans[1:]) / max(reps, 1)
    return {"route": route, "threads": threads if route == "device" else None,
            "first_s": times[0], "next_mean_s": sum(nxt) / len(nxt),
            "first_spans": spans[0], "next_spans": spans[1:],
            "first": rates(n_bytes, spans[0].get("index.read"), times[0]),
            "next": rates(n_bytes, read_next, sum(nxt) / len(nxt)),
            "rss_growth_mb": None if None in (rss0, rss1) else rss1 - rss0}


def load_times(sref: str, reps: int, device: str) -> list[dict]:
    """``load_child`` of each route in a fresh process; the device route
    on 1, 2, 4 and 8 read threads, where this tree has it."""
    from public_kssd_tpu_torch import index as index_mod

    runs = [("host", 0)]
    if hasattr(index_mod, "load_device_index"):
        runs += [("device", n) for n in (1, 2, 4, 8)]
    out = []
    env = dict(os.environ, PYTHONPATH=ROOT)
    for route, threads in runs:
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--load-child", route,
             "--load-threads", str(threads), "--work", os.path.dirname(sref),
             "--clock", str(reps), "--device", device],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            raise RuntimeError(f"load child {route} exited {r.returncode}: "
                               f"{r.stderr[-2000:]}")
        out.append(json.loads(r.stdout.strip().splitlines()[-1]))
    return out


def prepare(work: str, shape: dict, seed: int, reuse: bool,
            dev: str) -> tuple[str, str, float | None]:
    """The search cell's sketches of ``shape`` and the index of its
    references under ``work`` (bench_torch/run.py search_cell): made
    anew, or with ``reuse`` kept where ``work`` holds them for this shape
    and seed. Returns sref, sqry and the index call's wall (None when
    kept)."""
    marker = os.path.join(work, "shape.json")
    want = dict(shape, seed=seed)
    if reuse and os.path.isfile(marker):
        with open(marker) as f:
            if json.load(f) == want:
                return os.path.join(work, "sref"), os.path.join(work, "sqry"), None
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    _, ref_codes, qry = data.synth_csr(shape["refs"], shape["sketch"],
                                       shape["queries"], seed + 2)
    sref, sqry, t_index = search_dirs(
        work, ref_codes, qry.reshape(shape["queries"], shape["sketch"]), dev)
    with open(marker, "w") as f:
        json.dump(want, f)
    return sref, sqry, t_index


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clock", type=int, default=3)
    ap.add_argument("--calls", type=int, default=1)
    ap.add_argument("--threads", type=int, default=0, help="dist -p (0: every CPU)")
    ap.add_argument("--fresh", type=int, default=0)
    ap.add_argument("--exit", type=int, default=0)
    ap.add_argument("--compare", type=int, default=0)
    ap.add_argument("--parent", help="the parent checkout of --compare")
    ap.add_argument("--load", action="store_true")
    ap.add_argument("--load-child", choices=("host", "device"), help=argparse.SUPPRESS)
    ap.add_argument("--load-threads", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--refs", type=int, default=10_000)
    ap.add_argument("--queries", type=int, default=1_000)
    ap.add_argument("--sketch", type=int, default=1_300)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--work", default=os.path.join(ROOT, "build", "print_spans"))
    ap.add_argument("--reuse", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.load_child:
        print(json.dumps(load_child(os.path.join(args.work, "sref"), args.load_child,
                                    args.load_threads, args.clock, args.device)))
        return 0
    import torch

    from public_kssd_tpu_torch import resolve_device
    from public_kssd_tpu_torch.ops import stats

    device = resolve_device(args.device)
    kind, smi = device_names(device)
    shape = {"refs": args.refs, "queries": args.queries, "sketch": args.sketch}
    t = time.perf_counter()
    sref, sqry, t_index = prepare(args.work, shape, args.seed, args.reuse, device.type)
    setup_s = time.perf_counter() - t
    n_bytes = index_bytes(sref)

    def dist(out: str) -> list[str]:
        return ["dist", "-r", sref, "-o", os.path.join(args.work, out),
                "-p", str(args.threads), sqry, "--device", device.type]

    def split(self_s: dict[str, float], load_s: float | None) -> dict:
        return {"load_spans": load_spans(self_s), "count_spans": count_spans(self_s),
                **rates(n_bytes, self_s.get("index.read"), load_s)}

    from bench_torch.run import run_cli

    run_cli(*dist("warm"))  # builds the kernels and the host library
    size = os.path.getsize(os.path.join(args.work, "warm", "distance.out"))
    shutil.rmtree(os.path.join(args.work, "warm"))
    lines = []
    for i in range(args.calls):
        res = profiled_call(dist(f"p{i}"), os.path.join(args.work, f"trace{i}"), 900)
        shutil.rmtree(os.path.join(args.work, f"p{i}"))
        shutil.rmtree(os.path.join(args.work, f"trace{i}"))
        self_s = {k: v / 1e3 for k, v in res["self_ms"].items()}
        lines.append({"cell": SEARCH, **shape, "call": i,
                      **split(self_s, self_s.get("load_index")), **res})
        print(json.dumps(lines[-1]), flush=True)
    if args.clock:
        with stat_spans() as stat_where:
            res = clocked_calls(dist("c"), args.clock)
        res.update(split(res["self_s"], res["stages_s"].get("load_index")))
        res["stat_read_s"] = {k: v / args.clock for k, v in stat_where.items()}
        res["outside_s"] = (sum(res["walls_s"]) / args.clock
                            - sum(res["stages_s"].values()))
        floor = os.path.join(args.work, "floor")
        res["write_floor_s"] = write_floor(floor, size, args.clock)
        res["write_floor_par_s"] = write_floor_par(
            floor, size, stats.print_threads(args.threads), args.clock)
        lines.append({"cell": SEARCH, **shape, "clocked_calls": args.clock,
                      "distance_out_bytes": size, **res})
        print(json.dumps(lines[-1]), flush=True)
    if args.fresh:
        lines.append({"cell": SEARCH, **shape, "fresh_calls": args.fresh,
                      "index_bytes": n_bytes, **fresh_calls(dist("f"), args.fresh)})
        print(json.dumps(brief(lines[-1])), flush=True)
    for line in fresh_start.in_turn_lines(dist("f"), os.path.join(args.work, "f"),
                                          args.exit, args.compare, args.parent):
        lines.append({"cell": SEARCH, **shape, **line})
        print(json.dumps(fresh_start.without_runs(lines[-1])), flush=True)
    if args.load:
        lines.append({"cell": SEARCH, **shape,
                      "load": load_times(sref, max(args.clock, 1), device.type)})
        print(json.dumps(lines[-1]), flush=True)
    lines.append({"device": kind, "gpu": smi, "torch": torch.__version__,
                  "seed": args.seed, "print_threads": stats.print_threads(args.threads),
                  "host_cpus": len(os.sched_getaffinity(0)), "setup_s": setup_s,
                  "index_s": t_index})
    print(json.dumps(lines[-1]), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)
    if not args.reuse:
        shutil.rmtree(args.work)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
