"""Where a stage I call spends its host time, span by span.

Runs the benchmark's stage I call (``bench_torch``'s cell
``stage1_L3K10_128x5.3Mb``: 128 gzip genomes of 5.3 Mb, L3K10) with
``--profile`` in fresh processes and reads each trace:

* ``self_ms``: for every ``record_function`` span name of the main
  thread (the ``TracedStageTimer`` stages and the sketch stream's
  ``sketch.*`` spans), the time inside it and in none of its children;
* the trace's idle share and longest idle gaps (``bench_torch.trace.
  read_trace``), and for each gap the milliseconds of it under each
  innermost span (``under``);
* the stage times that the call logged.

``--clock N`` also times N unprofiled calls in this process with the
spans read on the host clock (``record_function`` replaced by a
``perf_counter`` stack while they run: no profiler, so no per-op
overhead), with the mean of each logged stage, the mean wall outside
them (``outside_s``) and the mean seconds of the ``.shuf`` read and
check (``cli._load_params``, which overlaps the parse pool since the
pool starts first) and of stage II (``timed_s``); the parse pool's own
floor: the seconds ``pipeline.parsed_streams`` takes to parse every
genome with nothing consuming its output but the loop; and the stream's
own cost: the genomes parsed first, then sketched group by group
(``ops.sketch.sketch_codes_multi`` over stage I's 64 MB groups) with no
parse thread running, its spans on the host clock.

``--parse-split`` also splits the parse of one genome on one thread
into reading the gzip file, inflating it and scanning it (the median
milliseconds over the genomes, each the best of three), names the
inflater this host takes (``seqio.inflate_route()``: the port's own,
"kssd", where its helper builds; else libdeflate, the system zlib, or
the gzip module where neither loads), times one thread's inflate of the
same genomes on every route this host can load (``inflate_ms_by_route``:
kssd, libdeflate, zlib; their bytes held equal), and times the parse
pool alone at 1, 2, 4, 6, 7 and 8 workers (seconds for all the genomes,
three passes each). Between the two, one thread's scan of the same
genomes by scanner (``scan_ms_by_route``: the reference
``kssd_fasta_to_codes`` against native/kssd_scan.c's loops, on a copy
of the inflated bytes; ``scan_ms_after_inflate``: the reference and
``kssd_fasta_scan`` right after each inflater route).

``--exit N`` and ``--compare N --parent DIR`` run the call in fresh
processes in turns, N rounds (``fresh_start.exit_ways``: the three ways a
process ends; ``fresh_start.compare``: the parent checkout's port against
this one's).

``--fresh N`` runs the call in N fresh processes without the profiler,
through ``tools/fresh_start.py``: each process's wall and where its
start went (the interpreter, ``import torch``, the port's imports, the
arguments and the file listing, ``resolve_device``, the context, the
staging set, the sketch library's load and first launch, the ``.shuf``
read and check, the first genome's parse and when it ended against when
the check did, the stages it logged, the exit), its peak resident memory
split into anonymous and file-backed memory, and the median of each
piece. The printed line leaves out each run's spans; ``--out`` keeps
them.

Run from the checkout's root, on a card::

    python3 tools/stage1_spans.py [--calls 2] [--clock 5] [--parse-split]
                                  [--fresh N] [--exit N] [--compare N --parent DIR]
                                  [--seed N] [--out FILE]

One JSON line per profiled call (and one for the clocked calls) on
stdout, the last line a summary with the device name; ``--out`` also
writes them to a file.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bench_torch import data  # noqa: E402
from bench_torch.run import SEED, STAGE1, device_names, genomes, run_cli  # noqa: E402
from bench_torch.trace import STAGE_WALL, load_trace, read_trace  # noqa: E402


def innermost(events: list[dict], tid) -> list[tuple[float, float, str]]:
    """(start, end, name) pieces of thread ``tid``'s timeline, each named
    by the innermost ``user_annotation`` span open there."""
    spans = sorted(
        ((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
         for e in events
         if e.get("ph") == "X" and e.get("cat") == "user_annotation"
         and e.get("tid") == tid),
        key=lambda s: (s[0], -s[1]),
    )
    out: list[tuple[float, float, str]] = []
    stack: list[tuple[float, float, str]] = []
    t = None

    def emit(upto: float) -> None:
        if stack and t is not None and upto > t:
            out.append((t, upto, stack[-1][2]))

    for s, e, name in spans:
        while stack and stack[-1][1] <= s:
            emit(stack[-1][1])
            t = stack.pop()[1]
        emit(s)
        stack.append((s, e, name))
        t = s
    while stack:
        emit(stack[-1][1])
        t = stack.pop()[1]
    return out


def main_tid(events: list[dict]):
    """The thread whose ``user_annotation`` spans cover the most time:
    the CLI's main thread."""
    cover: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            cover[e.get("tid")] = cover.get(e.get("tid"), 0.0) + float(e["dur"])
    return max(cover, key=cover.get)


def breakdown(events: list[dict], n_gaps: int = 5) -> dict:
    pieces = innermost(events, main_tid(events))
    self_us: dict[str, float] = {}
    for s, e, name in pieces:
        self_us[name] = self_us.get(name, 0.0) + e - s
    rt = read_trace(events, top=n_gaps)
    t0 = min(float(e["ts"]) for e in events if e.get("ph") == "X" and "dur" in e)
    for gap in rt["gaps"]:
        a = t0 + gap["start_ms"] * 1e3
        b = a + gap["ms"] * 1e3
        under: dict[str, float] = {}
        for s, e, name in pieces:
            o = min(b, e) - max(a, s)
            if o > 0:
                under[name] = under.get(name, 0.0) + o / 1e3
        covered = sum(under.values())
        under["outside any span"] = gap["ms"] - covered
        gap["under"] = dict(sorted(under.items(), key=lambda kv: -kv[1]))
    return {
        "self_ms": {n: us / 1e3 for n, us in sorted(self_us.items(), key=lambda kv: -kv[1])},
        **rt,
    }


class HostClock:
    """``record_function`` stand-in: the self seconds of every span name,
    on the host clock."""

    def __init__(self):
        self.self_s: dict[str, float] = {}
        self._stack: list[list] = []  # [name, start, child seconds]

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        self._stack.append([name, t, 0.0])
        try:
            yield
        finally:
            _, t0, child = self._stack.pop()
            dt = time.perf_counter() - t0
            self.self_s[name] = self.self_s.get(name, 0.0) + dt - child
            if self._stack:
                self._stack[-1][2] += dt


def clocked_calls(argv: list[str], n: int, timed: dict | None = None) -> dict:
    """n in-process calls of ``argv`` with the spans on the host clock:
    the mean self seconds of each span a call, the mean of each stage
    the calls logged, and each call's wall; ``outside_s``, the mean wall
    less the mean logged stages; and, for each name of ``timed`` (name
    -> (module, function name)), the mean seconds a call spent in that
    function (``timed_s``), to say where the time outside the stages
    goes."""
    import functools

    import torch

    clock = HostClock()
    walls, stages = [], {}
    spent = {name: 0.0 for name in timed or {}}
    real = torch.profiler.record_function
    originals = []
    for name, (module, attr) in (timed or {}).items():
        fn = getattr(module, attr)

        def wrapped(*a, _fn=fn, _name=name, **k):
            t = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                spent[_name] += time.perf_counter() - t

        originals.append((module, attr, fn))
        setattr(module, attr, functools.wraps(fn)(wrapped))
    torch.profiler.record_function = clock
    try:
        for _ in range(n):
            wall, logged = run_cli(*argv)
            walls.append(wall)
            for k, v in logged.items():
                stages[k] = stages.get(k, 0.0) + v / n
            shutil.rmtree(argv[argv.index("-o") + 1])
    finally:
        torch.profiler.record_function = real
        for module, attr, fn in originals:
            setattr(module, attr, fn)
    out = {"walls_s": walls, "stages_s": stages,
           "self_s": {k: v / n for k, v in sorted(clock.self_s.items(),
                                                  key=lambda kv: -kv[1])}}
    if timed:
        out["outside_s"] = sum(walls) / n - sum(stages.values())
        out["timed_s"] = {k: v / n for k, v in spent.items()}
    return out


def parse_floor(refs: str, n: int) -> list[float]:
    """Seconds the parse pool takes for every genome of ``refs``, n
    times, with nothing but the loop consuming what it yields."""
    from public_kssd_tpu_torch import infiles, pipeline

    files = infiles.organize_infiles([refs])
    out = []
    for _ in range(n):
        t = time.perf_counter()
        for _item in pipeline.parsed_streams(files, pipeline.SketchOptions()):
            pass
        out.append(time.perf_counter() - t)
    return out


POOL_WORKERS = (1, 2, 4, 6, 7, 8)


def inflater(seqio) -> str:
    """The route that inflates gzip into the parse's array on this host
    (``seqio.inflate_route()``: "kssd", "libdeflate", "zlib" or "gzip
    module"); on a tree from before that function, "libdeflate" where it
    is loaded, else "zlib" where the system zlib is bound, else "gzip
    module"."""
    if hasattr(seqio, "inflate_route"):
        return seqio.inflate_route()
    if seqio._LIBDEFLATE is not None:
        return "libdeflate"
    return "zlib" if getattr(seqio, "_LIBZ", None) is not None else "gzip module"


@contextlib.contextmanager
def on_route(seqio, route: str):
    """``seqio.inflate`` held to ``route`` while the block runs: the
    port's inflater switched off (``seqio._KSSD = False``) for the
    library routes, libdeflate unloaded for zlib's."""
    own, lib = getattr(seqio, "_KSSD", None), seqio._LIBDEFLATE
    if route != "kssd":
        seqio._KSSD = False
    if route == "zlib":
        seqio._LIBDEFLATE = None
    try:
        if inflater(seqio) != route:
            raise RuntimeError(f"cannot hold seqio.inflate to the {route} route")
        yield
    finally:
        seqio._LIBDEFLATE = lib
        if own is None:
            del seqio._KSSD
        else:
            seqio._KSSD = own


def routes(seqio, native) -> list[str]:
    """Every route ``seqio.inflate`` can take on this host and tree."""
    out = ["kssd"] if hasattr(seqio, "inflate_route") and native.get_lib() else []
    if seqio._LIBDEFLATE is not None:
        out.append("libdeflate")
    if getattr(seqio, "_LIBZ", None) is not None:
        out.append("zlib")
    return out


def scanners(native) -> dict:
    """The FASTA scanners this tree's helper binds, each f(buf) scanning
    ``buf`` in place and returning the symbols' count: the reference,
    ``kssd_fasta_to_codes``; on a tree with native/kssd_scan.c also
    ``kssd_fasta_scan`` (the loop this CPU takes) and its SSE2 and SWAR
    loops through ``kssd_fasta_scan_at``."""
    lib = native.get_lib()
    out = {"kssd_fasta_to_codes": lambda b: lib.kssd_fasta_to_codes(b, b.size, b)}
    if hasattr(lib, "kssd_fasta_scan"):
        out["kssd_fasta_scan"] = lambda b: lib.kssd_fasta_scan(b, b.size, b)
        for w in (16, 8):
            out[f"kssd_fasta_scan_at {w}"] = (
                lambda w: lambda b: lib.kssd_fasta_scan_at(b, b.size, b, w))(w)
    return out


def scan_split(files: list[str], inflate, seqio, native, passes: int) -> dict:
    """One thread's scan of each genome in place, the median ms a genome
    (each the best of ``passes``), the scanners interleaved genome by
    genome, their symbols held equal:

    * ``scan_ms_by_route``: every scanner of ``scanners`` on a copy of
      the inflated bytes made just before it (the bytes in cache), and
      ``kssd_fasta_scan`` on the same bases with no line ends
      (``one line``: what the lines' ends cost it);
    * ``scan_ms_after_inflate``: the reference and ``kssd_fasta_scan``
      right after each inflater route has written the array, as the
      parse pool runs them."""
    import hashlib
    import statistics

    import numpy as np

    scan = scanners(native)
    by_route = {name: [] for name in scan}
    if "kssd_fasta_scan" in scan:
        by_route["kssd_fasta_scan, one line"] = []
    pair = {k: scan[k] for k in ("kssd_fasta_to_codes", "kssd_fasta_scan") if k in scan}
    after = {(route, name): [] for route in routes(seqio, native) for name in pair}

    def best(f, fresh) -> tuple[float, bytes]:
        ms = float("inf")
        for _ in range(passes):
            buf = fresh()
            t = time.perf_counter()
            n = f(buf)
            ms = min(ms, (time.perf_counter() - t) * 1e3)
        return ms, hashlib.blake2b(buf[:n], digest_size=16).digest()

    for path in files:
        with open(path, "rb") as f:
            data = f.read()
        raw = inflate(data)
        head = int(np.flatnonzero(raw == ord("\n"))[0]) + 1
        one_line = np.concatenate([raw[:head], raw[head:][raw[head:] != ord("\n")]])
        work = np.empty_like(raw)

        def copy(src):
            def fresh():
                out = work[: src.size]
                np.copyto(out, src)
                return out
            return fresh

        digests = set()
        for name, f in scan.items():
            ms, digest = best(f, copy(raw))
            by_route[name].append(ms)
            digests.add(digest)
        if "kssd_fasta_scan" in scan:
            by_route["kssd_fasta_scan, one line"].append(best(scan["kssd_fasta_scan"],
                                                              copy(one_line))[0])
        for route, name in after:
            with on_route(seqio, route):
                ms, digest = best(pair[name], lambda: inflate(data))
            after[route, name].append(ms)
            digests.add(digest)
        if len(digests) != 1:
            raise RuntimeError(f"the scanners' symbols differ on {path}")
    return {
        "scan_ms_by_route": {k: statistics.median(v) for k, v in by_route.items()},
        "scan_ms_after_inflate": {
            route: {name: statistics.median(after[route, name]) for name in pair}
            for route in routes(seqio, native)},
    }


def parse_split(refs: str, passes: int = 3) -> dict:
    """One thread's read, inflate and scan milliseconds per genome, and
    the pool's seconds at each of POOL_WORKERS; then one thread's inflate
    of the same genomes on every route this host can load (the median
    ms a genome, each the best of ``passes``; every route's bytes equal
    to the first's). A tree from before ``seqio.inflate`` (the bytes
    route) is split as it parses: ``gzip_decompress``, then
    ``fasta_to_codes``."""
    import hashlib
    import statistics

    from public_kssd_tpu_torch import infiles, native, pipeline, seqio

    files = infiles.organize_infiles([refs])
    inflate = getattr(seqio, "inflate", None)
    split = {"read_ms": [], "inflate_ms": [], "scan_ms": []}
    for path in files:
        best = [float("inf")] * 3
        for _ in range(passes):
            t0 = time.perf_counter()
            with open(path, "rb") as f:
                data = f.read()
            t1 = time.perf_counter()
            buf = None if inflate is None else inflate(data)
            if buf is None:
                raw = seqio.gzip_decompress(data)
            t2 = time.perf_counter()
            if buf is None:
                seqio.fasta_to_codes(raw)
            else:
                native.fasta_codes_in_place(buf)
            t3 = time.perf_counter()
            best = [min(b, t) for b, t in zip(best, (t1 - t0, t2 - t1, t3 - t2))]
        for key, b in zip(split, best):
            split[key].append(b * 1e3)
    by_route = {}
    if inflate is not None:  # the routes interleaved genome by genome
        ms = {route: [] for route in routes(seqio, native)}
        for path in files:
            with open(path, "rb") as f:
                data = f.read()
            digests = set()
            for route in ms:
                best = float("inf")
                with on_route(seqio, route):
                    for _ in range(passes):
                        t = time.perf_counter()
                        buf = inflate(data)
                        best = min(best, time.perf_counter() - t)
                if buf is None:
                    raise RuntimeError(f"the {route} route refused {path}")
                digests.add(hashlib.blake2b(buf, digest_size=16).digest())
                ms[route].append(best * 1e3)
            if len(digests) != 1:
                raise RuntimeError(f"the routes' bytes differ on {path}")
        by_route = {route: statistics.median(v) for route, v in ms.items()}
    scans = {} if inflate is None else scan_split(files, inflate, seqio, native, passes)
    opts = pipeline.SketchOptions()
    pools = {}
    for w in POOL_WORKERS:
        pools[w] = []
        for _ in range(passes):
            t = time.perf_counter()
            for _item in pipeline.parsed_streams(files, opts, workers=w):
                pass
            pools[w].append(time.perf_counter() - t)
    return {
        "inflater": inflater(seqio),
        "route": "bytes" if inflate is None else "in place",
        "genomes": len(files),
        **{k: statistics.median(v) for k, v in split.items()},
        "inflate_ms_by_route": by_route,
        **scans,
        "pool_s": pools,
    }


def stream_alone(refs: str, shuf: str, device, n: int) -> dict:
    """The sketch stream without the parse pool beside it: every genome
    parsed first, then n passes of ``sketch_codes_multi`` over stage I's
    groups of 64 MB of symbols; the mean seconds a pass and its spans'
    self seconds on the host clock."""
    import torch

    from public_kssd_tpu_torch import formats, infiles, pipeline, shufspace
    from public_kssd_tpu_torch.ops import sketch

    files = infiles.organize_infiles([refs])
    syms = [pipeline.parse_one(f, pipeline.SketchOptions()) for f in files]
    groups, used = [[]], 0
    for sym in syms:  # run_stage1's grouping
        if groups[-1] and used >= 64 << 20:
            groups.append([])
            used = 0
        groups[-1].append(sym)
        used += sym.size
    params, table = formats.read_shuf(shuf)
    comp = shufspace.detect(params, table, device)
    shuf_dev = sketch.as_shuf(table if comp is None else comp, device)
    sketch.sketch_codes_multi(iter(groups[0]), shuf_dev, params, device=device)
    clock = HostClock()
    real = torch.profiler.record_function
    torch.profiler.record_function = clock
    walls = []
    try:
        for _ in range(n):
            t = time.perf_counter()
            for g in groups:
                sketch.sketch_codes_multi(iter(g), shuf_dev, params, device=device)
            walls.append(time.perf_counter() - t)
    finally:
        torch.profiler.record_function = real
    return {"groups": len(groups), "walls_s": walls,
            "self_s": {k: v / n for k, v in sorted(clock.self_s.items(),
                                                   key=lambda kv: -kv[1])}}


def profiled_call(argv: list[str], trace_dir: str, timeout: float) -> dict:
    env = dict(os.environ, PYTHONPATH=ROOT)
    shutil.rmtree(trace_dir, ignore_errors=True)
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "public_kssd_tpu_torch.cli", *argv,
         "--profile", trace_dir],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"kssd_torch exited {r.returncode}: {r.stderr[-2000:]}")
    logged = [line for line in r.stderr.splitlines() if STAGE_WALL.search(line)]
    _, events = load_trace(trace_dir)
    return {"fresh_process_s": wall, "logged": logged, **breakdown(events)}


def brief(line: dict) -> dict:
    """A result line without its runs' spans (``--out`` keeps them)."""
    if "runs" not in line:
        return line
    return {**line, "runs": [{k: v for k, v in r.items() if k != "spans"}
                             for r in line["runs"]]}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=2)
    ap.add_argument("--fresh", type=int, default=0)
    ap.add_argument("--exit", type=int, default=0)
    ap.add_argument("--compare", type=int, default=0)
    ap.add_argument("--parent", help="the parent checkout of --compare")
    ap.add_argument("--clock", type=int, default=0)
    ap.add_argument("--parse-split", action="store_true")
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--genomes", type=int, default=128)
    ap.add_argument("--genome-bp", type=int, default=data.GENOME_BP)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--work", default=os.path.join(ROOT, "build", "stage1_spans"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from public_kssd_tpu_torch import resolve_device

    device = resolve_device(args.device)
    kind, smi = device_names(device)
    cache = os.path.join(ROOT, "build", "bench_torch",
                         f"genomes_seed{args.seed}_{args.genomes}x{args.genome_bp}")
    refs = genomes(cache, args.genomes, args.genome_bp, args.seed)
    shutil.rmtree(args.work, ignore_errors=True)
    os.makedirs(args.work)
    shuf = os.path.join(args.work, "L3K10")
    run_cli("shuffle", "-k", "10", "-s", "6", "-l", "3", "--seed", str(args.seed),
            "-o", shuf)

    def dist(out: str) -> list[str]:
        return ["dist", "-r", refs, "-L", shuf + ".shuf", "-o", out,
                "--no-dense-index", "--device", device.type]

    run_cli(*dist(os.path.join(args.work, "warm")))  # builds the kernels
    lines = []
    for i in range(args.calls):
        res = profiled_call(dist(os.path.join(args.work, f"p{i}")),
                            os.path.join(args.work, f"trace{i}"), 900)
        lines.append({"cell": STAGE1, "call": i, **res})
        print(json.dumps(lines[-1]), flush=True)
    if args.clock:
        from public_kssd_tpu_torch import cli, index

        res = clocked_calls(dist(os.path.join(args.work, "c")), args.clock,
                            {".shuf read and check": (cli, "_load_params"),
                             "stage II": (index, "run_stage2")})
        res["parse_pool_s"] = parse_floor(refs, args.clock)
        res["stream_alone"] = stream_alone(refs, shuf + ".shuf", device, args.clock)
        lines.append({"cell": STAGE1, "clocked_calls": args.clock, **res})
        print(json.dumps(lines[-1]), flush=True)
    if args.fresh:
        import fresh_start

        out = os.path.join(args.work, "f")
        runs = fresh_start.fresh_runs(dist(out), args.fresh, clean=out)
        lines.append({"cell": STAGE1, "fresh_calls": args.fresh,
                      **fresh_start.summary(runs), "runs": runs})
        print(json.dumps(brief(lines[-1])), flush=True)
    if args.exit or args.compare:
        import fresh_start

        out = os.path.join(args.work, "f")
        for line in fresh_start.in_turn_lines(dist(out), out, args.exit, args.compare,
                                              args.parent):
            lines.append({"cell": STAGE1, **line})
            print(json.dumps(fresh_start.without_runs(lines[-1])), flush=True)
    if args.parse_split:
        lines.append({"cell": STAGE1, "parse_split": parse_split(refs)})
        print(json.dumps(lines[-1]), flush=True)
    lines.append({"device": kind, "gpu": smi, "torch": torch.__version__,
                  "seed": args.seed, "genomes": args.genomes})
    print(json.dumps(lines[-1]), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)
    shutil.rmtree(args.work)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
