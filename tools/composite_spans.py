"""Where a composite call's stages spend their time, on both routes, and
one tree against another in turns.

Runs ``kssd_torch composite -r <db> -q <samples>`` in process at the GTDB
species-group shape of ``chip_smoke.py`` phase 7b: 65,702 references x
300 codes (``synthdb.build_synth_ref``) and 8 koc samples of 200,000
codes (``synthdb.build_synth_queries``, hit rate 0.3, 200 focus
references), over the CSR route (a copy of the DB indexed by ``dist -o
idx idx --no-dense-index``) and the raw route (the DB unindexed). The
database, its index and the host oracle's report
(``species_abundance(device=None)``) are made once per seed and shape
under ``build/composite_spans/``.

Each measured tree runs in a fresh process (``--worker``) that imports
that tree's package. For each route: one warm-up call, whose report must
equal the host oracle's byte for byte before anything is timed, and
whose hit keys are counted (``hits``: the keys the join emitted, the
input of ``_hits_to_stats`` or ``_hits_to_stats_torch``); then
``--calls N`` calls with the stages as the call logs them and the wall
(``cli.main``, then ``torch.cuda.synchronize()``); then N calls split
into spans on the host clock, the device synchronized as each span
starts and ends, so that a span holds the device work it launched. A
span's self seconds are kept under the stage it ran in (``split``:
stage -> span -> mean seconds a call; the stage's own name holds the
rest of the stage; ``split_minor_faults`` the same for the process's
minor page faults, ``minor_faults_mean`` those of a whole call).
``outside_s`` is the mean wall less the mean of the logged stages: the
call's time outside every stage. Every report of
every call is checked against the oracle's. The spans:

* ``stat.read``: reading a stat file (``formats.read_co_stat`` and
  ``read_mco_stat``, and ``stattab.read_co_stat_table`` and
  ``read_mco_stat_table`` where the tree has them): the DB's and the
  samples' ``cofiles.stat`` before the first stage (kept under its own
  name, as a stage of its own), the index's ``mcofiles.stat`` in
  ``load``;
* ``read``: ``formats.read_combco`` (the query sketch's files; on a
  parent's raw route the DB's too, in ``load``, whose rest is then the
  host's genome ids, ``rid_of``);
* ``raw.upload``, ``raw.read``, ``raw.wait``: the raw route's DB read
  straight onto the device (``_raw_device_components``, in ``load``):
  the uploads and the loop's own time, waiting for a read of the DB's
  files into a staging buffer, and a staging buffer waiting for its
  upload;
* ``raw.ids``: the raw route's genome ids made on the device a join
  chunk at a time (``_genome_ids``, in ``join``);
* ``table.sort``: the query table's sort and keep-first filter (a
  parent's host ``_query_table``; ``_query_table_device``'s span);
* ``table.upload``: the query table's upload (a parent's
  ``_upload_table`` less its directory; ``_query_table_device``'s
  span: the combco arrays as read);
* ``table.directory``: ``query_directory``;
* ``join.kernel``: ``join_kernel`` (csrc/join.cu, both passes);
* ``join.fetch``: on a tree without ``_hits_to_stats_torch``, every
  ``Tensor.cpu()`` (the hit keys' fetch to the host);
* ``stats.sort``: the keys' concatenation and sort (a parent's
  ``_hits_to_stats`` less ``_segment_stats_np``, on the host; the span
  of ``_hits_to_stats_torch``, on the device);
* ``stats.reduce``: the per-(query, reference) aggregates (a parent's
  ``_segment_stats_np`` per query; ``_segments_torch`` on the device);
* ``stats.fetch``, ``stats.host``: the aggregates' fetch and the
  per-query arrays built from them (``_hits_to_stats_torch`` only).

``--fresh N`` times instead what a ``kssd_torch composite`` process
pays for its one call: for each route, N fresh processes a tree
(``--fresh-worker``), each of which starts the card and loads the kernel
libraries, then times one call (the wall from ``cli.main`` to
``torch.cuda.synchronize()``, and the stages it logs) and checks its
report against the oracle's. Nothing runs before that call that a CLI
process would not run, so the host's allocator starts as a CLI
process's does. With ``--parent DIR`` the two trees take turns, round by
round.

``--compare N --parent DIR`` runs the parent checkout's port (unpack
it with ``git archive`` into the gitignored ``scratch_runs/``) and this
one's, each in its own worker, N rounds in turns (P C, C P, ...), and
prints each tree's medians over the rounds and the change less the
parent, round by round, of each route's mean wall.

Run from the checkout's root, on a card::

    python3 tools/composite_spans.py [--calls 3] [--compare N --parent DIR]
                                     [--fresh N [--parent DIR]]
                                     [--tree DIR] [--refs N] [--samples N]
                                     [--sample-codes N] [--seed N]
                                     [--work DIR] [--out FILE]

``--device cpu --refs 2000 --samples 3 --sample-codes 5000`` rehearses it
on the host. One JSON line per worker on stdout, the last line a summary
with the device's name and power limit; ``--out`` also writes them to a
file. The tool prints numbers only and writes under ``--work`` alone.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import logging
import os
import re
import resource
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 20261016  # chip_smoke.SEED: the same database as phase 7b
ROUTES = ("csr", "raw")


# ----------------------------------------------------------------- worker

def minor_faults() -> int:
    """This process's minor page faults so far (getrusage)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_minflt


class SyncClock:
    """``record_function`` stand-in: the self seconds and self minor page
    faults of every span on the host clock, kept under the outermost span
    it ran in (the stage), the device synchronized as each span starts
    and ends."""

    def __init__(self, sync):
        self.sync = sync
        self.self_s: dict[str, dict[str, float]] = {}
        self.self_faults: dict[str, dict[str, int]] = {}
        # [name, start, child seconds, faults at start, child faults]
        self._stack: list[list] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        self.sync()
        self._stack.append([name, time.perf_counter(), 0.0, minor_faults(), 0])
        try:
            yield
        finally:
            self.sync()
            _, t0, child, f0, child_f = self._stack.pop()
            dt, df = time.perf_counter() - t0, minor_faults() - f0
            stage = self._stack[0][0] if self._stack else name
            spans = self.self_s.setdefault(stage, {})
            spans[name] = spans.get(name, 0.0) + dt - child
            faults = self.self_faults.setdefault(stage, {})
            faults[name] = faults.get(name, 0) + df - child_f
            if self._stack:
                self._stack[-1][2] += dt
                self._stack[-1][4] += df


class Stages(logging.Handler):
    """The stages of the last ``composite`` log line."""

    def __init__(self):
        super().__init__()
        self.last: dict[str, float] = {}

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("composite:") and "[" in msg:
            body = msg[msg.rindex("[") + 1:]
            self.last = {k: float(v)
                         for k, v in re.findall(r"(\w+): ([0-9.]+)s", body)}


@contextlib.contextmanager
def patched(pairs):
    """Set ``obj.attr = value`` for each (obj, attr, value), restored at
    exit."""
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in pairs]
    try:
        for obj, attr, value in pairs:
            setattr(obj, attr, value)
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)


def spanned(clock, name, fn):
    def wrapped(*a, **k):
        with clock(name):
            return fn(*a, **k)
    return wrapped


def worker(args) -> dict:
    """Measure the tree at ``args.tree`` (its package imported): one JSON
    object with each route's checks, hits, stages, walls and split."""
    sys.path.insert(0, args.tree)
    import torch

    from public_kssd_tpu_torch import cli, composite, formats, utils

    pkg = os.path.dirname(composite.__file__)
    if os.path.realpath(pkg) != os.path.realpath(
            os.path.join(args.tree, "public_kssd_tpu_torch")):
        raise RuntimeError(f"imported {pkg}, not the package of {args.tree}")
    dev = torch.device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    with open(os.path.join(args.work, "oracle.txt")) as f:
        oracle = f.read()
    on_device = hasattr(composite, "_hits_to_stats_torch")
    try:
        from public_kssd_tpu_torch import stattab
    except ImportError:  # a tree that reads every stat file as a list
        stattab = None
    stat_readers = [(formats, "read_co_stat"), (formats, "read_mco_stat")]
    if hasattr(stattab, "read_co_stat_table"):
        stat_readers += [(stattab, "read_co_stat_table"),
                         (stattab, "read_mco_stat_table")]
    stats_fn = "_hits_to_stats_torch" if on_device else "_hits_to_stats"
    stages = Stages()
    utils.log.addHandler(stages)

    def call(d):
        buf = io.StringIO()
        f0, t0 = minor_faults(), time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["composite", "-r", d, "-q", f"{args.work}/qry",
                           "--device", args.device])
        sync()
        wall, faults = time.perf_counter() - t0, minor_faults() - f0
        if rc != 0 or buf.getvalue() != oracle:
            raise AssertionError(f"{args.tree}: the composite report over {d} "
                                 "differs from the host oracle")
        return wall, dict(stages.last), faults

    out = {"tree": args.tree, "device": args.device,
           "stats": "device" if on_device else "host", "routes": {}}
    for route in ROUTES:
        d = f"{args.work}/{'idx' if route == 'csr' else 'ref'}"
        hits = []
        real = getattr(composite, stats_fn)

        def count(parts, *a, _real=real, **k):
            hits.append(sum(int(p.numel() if hasattr(p, "numel") else p.size)
                            for p in parts))
            return _real(parts, *a, **k)

        with patched([(composite, stats_fn, count)]):
            warm, *_ = call(d)
        walls, st, faults = [], {}, []
        for _ in range(args.calls):
            wall, logged, n_faults = call(d)
            walls.append(wall)
            faults.append(n_faults)
            for k, v in logged.items():
                st[k] = st.get(k, 0.0) + v / args.calls
        clock = SyncClock(sync)
        wraps = [(torch.profiler, "record_function", clock),
                 (formats, "read_combco", spanned(clock, "read", formats.read_combco)),
                 (composite, "query_directory",
                  spanned(clock, "table.directory", composite.query_directory)),
                 (composite, "join_kernel",
                  spanned(clock, "join.kernel", composite.join_kernel))]
        wraps += [(m, f, spanned(clock, "stat.read", getattr(m, f)))
                  for m, f in stat_readers]
        if not on_device:
            wraps += [
                (composite, "_query_table",
                 spanned(clock, "table.sort", composite._query_table)),
                (composite, "_upload_table",
                 spanned(clock, "table.upload", composite._upload_table)),
                (composite, "_hits_to_stats",
                 spanned(clock, "stats.sort", composite._hits_to_stats)),
                (composite, "_segment_stats_np",
                 spanned(clock, "stats.reduce", composite._segment_stats_np)),
                (torch.Tensor, "cpu", spanned(clock, "join.fetch", torch.Tensor.cpu)),
            ]
        split_walls = []
        with patched(wraps):
            for _ in range(args.calls):
                split_walls.append(call(d)[0])
        split = {s: {k: v / args.calls for k, v in spans.items()}
                 for s, spans in clock.self_s.items()}
        split_faults = {s: {k: v / args.calls for k, v in spans.items()}
                        for s, spans in clock.self_faults.items()}
        out["routes"][route] = {
            "check": "byte-equal to the host oracle", "hits": hits[0],
            "warmup_s": warm, "walls": walls,
            "wall_mean": sum(walls) / len(walls), "stages": st,
            "outside_s": sum(walls) / len(walls) - sum(st.values()),
            "minor_faults_mean": sum(faults) / len(faults),
            "split_minor_faults": split_faults,
            "split": split, "split_wall_mean": sum(split_walls) / len(split_walls),
        }
    utils.log.removeHandler(stages)
    return out


def fresh_worker(args) -> dict:
    """One timed composite call of ``args.route`` in this fresh process,
    after the card's start and the kernel libraries' load."""
    sys.path.insert(0, args.tree)
    import torch

    from public_kssd_tpu_torch import cli, kernels, utils

    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.zeros(1, device=dev)
        for k in kernels.ALL:
            k.library()
        torch.cuda.synchronize()
    stages = Stages()
    utils.log.addHandler(stages)
    d = f"{args.work}/{'idx' if args.route == 'csr' else 'ref'}"
    buf = io.StringIO()
    f0, t0 = minor_faults(), time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["composite", "-r", d, "-q", f"{args.work}/qry",
                       "--device", args.device])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    faults = minor_faults() - f0
    with open(os.path.join(args.work, "oracle.txt")) as f:
        if rc != 0 or buf.getvalue() != f.read():
            raise AssertionError(f"{args.tree}: the composite report over {d} "
                                 "differs from the host oracle")
    return {"tree": args.tree, "route": args.route, "wall": wall,
            "minor_faults": faults, "stages": dict(stages.last)}


# ------------------------------------------------------------------- main

def build(args) -> None:
    """The database, its CSR copy and the host oracle's report under
    ``args.work``, made once per seed and shape (this tree's package)."""
    sys.path.insert(0, ROOT)
    from public_kssd_tpu_torch import cli, composite, synthdb

    w = args.work
    if os.path.isfile(f"{w}/oracle.txt"):
        return
    shutil.rmtree(w, ignore_errors=True)
    os.makedirs(w)
    synthdb.build_synth_ref(f"{w}/ref", args.refs, args.sketch, seed=args.seed + 5)
    synthdb.build_synth_queries(f"{w}/qry", f"{w}/ref", args.samples,
                                args.sample_codes, hit_rate=0.3,
                                seed=args.seed + 6, koc=True, focus_refs=200)
    shutil.copytree(f"{w}/ref", f"{w}/idx")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["dist", "-o", f"{w}/idx", f"{w}/idx", "--no-dense-index",
                       "--device", args.device])
    if rc != 0:
        raise RuntimeError(f"stage II of {w}/idx exited {rc}")
    t0 = time.perf_counter()
    report = composite.species_abundance(f"{w}/ref", f"{w}/qry", device=None)
    if not report:
        raise AssertionError("the host oracle reports nothing")
    print(f"host oracle {time.perf_counter() - t0:.3f} s, "
          f"{len(report.splitlines())} lines", file=sys.stderr)
    with open(f"{w}/oracle.txt.part", "w") as f:
        f.write(report)
    os.replace(f"{w}/oracle.txt.part", f"{w}/oracle.txt")


def run_worker(args, tree: str, route: str | None = None) -> dict:
    cmd = [sys.executable, os.path.abspath(__file__), "--worker", "--tree", tree,
           "--work", args.work, "--device", args.device, "--calls", str(args.calls)]
    if route:
        cmd += ["--fresh-worker", route]
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=tree)
    if r.returncode != 0:
        raise RuntimeError(f"worker on {tree} exited {r.returncode}:\n"
                           f"{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def card() -> dict:
    import torch

    if not torch.cuda.is_available():
        return {"name": "cpu", "smi": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return {"name": torch.cuda.get_device_name(0), "smi": smi[0] if smi else None}


def medians(runs: list[dict], route: str) -> dict:
    """Median over ``runs`` of a route's mean wall, stages and split."""
    rs = [r["routes"][route] for r in runs]
    med = lambda xs: statistics.median(xs)  # noqa: E731
    split = {}
    for s in sorted({s for r in rs for s in r["split"]}):
        names = sorted({k for r in rs for k in r["split"].get(s, {})})
        split[s] = {k: med([r["split"].get(s, {}).get(k, 0.0) for r in rs])
                    for k in names}
    return {
        "wall_mean": med([r["wall_mean"] for r in rs]),
        "outside_s": med([r["outside_s"] for r in rs]),
        "stages": {k: med([r["stages"].get(k, 0.0) for r in rs])
                   for k in sorted({k for r in rs for k in r["stages"]})},
        "split": split, "hits": rs[0]["hits"],
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--compare", type=int, default=0, metavar="N")
    ap.add_argument("--parent", help="the parent checkout's root (--compare)")
    ap.add_argument("--tree", default=ROOT, help="the checkout to measure")
    ap.add_argument("--refs", type=int, default=65_702)
    ap.add_argument("--sketch", type=int, default=300)
    ap.add_argument("--samples", type=int, default=8)
    ap.add_argument("--sample-codes", type=int, default=200_000)
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--work")
    ap.add_argument("--out")
    ap.add_argument("--fresh", type=int, default=0, metavar="N")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--fresh-worker", dest="route", choices=ROUTES,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.calls < 1:
        ap.error("--calls must be at least 1")
    args.tree = os.path.abspath(args.tree)
    if args.worker:
        print(json.dumps(fresh_worker(args) if args.route else worker(args)))
        return 0
    if args.compare and not args.parent:
        ap.error("--compare needs --parent DIR")
    args.work = os.path.abspath(args.work or os.path.join(
        ROOT, "build", "composite_spans",
        f"s{args.seed}_{args.refs}x{args.sketch}_{args.samples}x{args.sample_codes}"))
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card is visible; use --device cpu")
    build(args)
    lines = []

    def emit(obj):
        lines.append(json.dumps(obj))
        print(lines[-1], flush=True)

    summary = {"shape": {"refs": args.refs, "sketch": args.sketch,
                         "samples": args.samples, "sample_codes": args.sample_codes,
                         "seed": args.seed},
               "calls": args.calls, "card": card()}
    if args.fresh:
        trees = {"change": args.tree}
        if args.parent:
            trees["parent"] = os.path.abspath(args.parent)
        walls = {t: {r: [] for r in ROUTES} for t in trees}
        for i in range(args.fresh):
            order = sorted(trees, reverse=i % 2 == 1)
            for r in ROUTES:
                for tag in order:
                    run = run_worker(args, trees[tag], r)
                    run["tag"], run["round"] = tag, i
                    walls[tag][r].append(run["wall"])
                    emit(run)
        summary["fresh"] = args.fresh
        summary["routes"] = {r: {t: {"walls": walls[t][r],
                                     "median_s": statistics.median(walls[t][r])}
                                 for t in trees} for r in ROUTES}
        if args.parent:
            for r in ROUTES:
                diff = [c - p for c, p in zip(walls["change"][r], walls["parent"][r])]
                summary["routes"][r].update(
                    change_less_parent_s=diff,
                    change_less_parent_median_s=statistics.median(diff),
                    rounds_lower=sum(d < 0 for d in diff))
    elif not args.compare:
        run = run_worker(args, args.tree)
        emit(run)
        summary["routes"] = {r: medians([run], r) for r in ROUTES}
    else:
        parent = os.path.abspath(args.parent)
        runs: dict[str, list[dict]] = {"parent": [], "change": []}
        for i in range(args.compare):
            order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
            for tag in order:
                run = run_worker(args, parent if tag == "parent" else args.tree)
                run["tag"], run["round"] = tag, i
                runs[tag].append(run)
                emit(run)
        summary["compare"] = args.compare
        summary["routes"] = {}
        for r in ROUTES:
            diff = [c["routes"][r]["wall_mean"] - p["routes"][r]["wall_mean"]
                    for p, c in zip(runs["parent"], runs["change"])]
            summary["routes"][r] = {
                "parent": medians(runs["parent"], r),
                "change": medians(runs["change"], r),
                "change_less_parent_s": diff,
                "change_less_parent_median_s": statistics.median(diff),
                "rounds_lower": sum(d < 0 for d in diff),
            }
    emit(summary)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
