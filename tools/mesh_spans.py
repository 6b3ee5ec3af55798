"""Where the sharded paths' calls spend their time, and one tree against
another in turns.

Four shapes, their data made from a seed by the tool (``bench_torch.data``
and ``synthdb``, read-only) and cached under ``build/mesh_spans/``:

* ``search_1000x10k``: 10,000 reference sketches x 1,300 28-bit codes
  (indexed by ``dist -o sref sref --no-dense-index``) and 1,000 queries
  with 30% planted codes, the search cell's shape;
* ``screen_10x100k``: 10 queries against 100,000 references, the screen
  cell's shape;
* ``wide_l3k12``: ``chip_smoke.py`` phase 6's DB, 16 random genomes
  sketched at L3K12 (256 components; the same seeds) and indexed, and 4
  mutated copies as queries, sketched on the CPU: many small components;
* ``composite_gtdb``: the GTDB species-group shape of ``chip_smoke.py``
  phase 7b, 65,702 references x 300 codes and 8 koc samples of 200,000
  codes, unindexed.

The search shapes run ``search.search`` in process over the meshes 1x1
and 1x4 of one card (``parallel.Mesh(1, n, (dev,) * n)``, as ``dist
--mesh`` builds them), by the genome and the code strategy; composite
runs ``species_abundance_sharded`` over 1 and 4 slots of the card (``1``
is ``composite --mesh 1``). Each tree runs in a fresh process
(``--worker``) that imports that tree's package; each route: one warm-up
call whose output must equal the tree's one-card route byte for byte
(``search.search`` on the device; ``species_abundance`` on the device),
then ``--calls N`` calls with the wall (the card synchronized at the end)
and the search's stages as its log line gives them, then N calls split
into spans on the host clock, the card synchronized at each span's edges
(``composite_spans.SyncClock``): a span's self seconds, kept under the
stage it ran in. The spans: ``mesh.upload`` (a component group's or a
slot's files onto the card through pinned staging) around ``mesh.read``
(waiting for a read) and ``mesh.wait`` (a buffer waiting for its
upload), ``mesh.cut`` (the code strategy's cut keys), ``mesh.fold``
(folding and splitting each component group, or the composite DB's
chunks and query table), ``mesh.build`` (the shards sorted and checked),
``mesh.queries`` (a dp block's query keys), ``count.kernel`` and
``join.kernel`` (the wrappers), ``mesh.fetch`` (the count blocks into
place), ``mesh.table`` (composite's query table), ``stats``
(composite's statistics), ``mesh.report``; on a tree that builds on the
host: ``host.load`` (``load_sparse_index``), ``host.merge``
(``merge_components``), ``host.build`` (``build_*_db``),
``host.queries`` (``query_keys``), ``host.upload`` (``upload_shards``),
``host.fold`` (``_fold_ref``, ``_fold_queries``).

``--compare N --parent DIR`` runs the parent checkout's port (unpack it
with ``git archive`` into the gitignored ``scratch_runs/``) and this
one's, N rounds in turns (P C, C P, ...), and prints each tree's medians
and the change less the parent, round by round, of each route's mean
wall. ``--shapes`` picks shapes.

Run from the checkout's root, on a card::

    python3 tools/mesh_spans.py [--calls 3] [--compare N --parent DIR]
                                [--shapes search_1000x10k,...] [--seed N]
                                [--tree DIR] [--work DIR] [--out FILE]

``--device cpu --small`` rehearses it on the host at a tenth of each
shape's references and queries. One JSON line per worker on stdout, the
last line a summary with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import logging
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from composite_spans import SyncClock, card, patched, spanned  # noqa: E402

SEED = 20261016  # chip_smoke.SEED
SHAPES = ("search_1000x10k", "screen_10x100k", "wide_l3k12", "composite_gtdb")
# shape -> (references, codes a reference, queries, codes a query); the
# wide shape's sketches are those of its genomes
SIZES = {
    "search_1000x10k": (10_000, 1_300, 1_000, 1_300),
    "screen_10x100k": (100_000, 1_300, 10, 1_300),
    "wide_l3k12": (16, None, 4, None),
    "composite_gtdb": (65_702, 300, 8, 200_000),
}
SLOTS = (1, 4)


def routes(shape: str) -> list[tuple[str, int, str | None]]:
    """(route name, slots, strategy) of a shape."""
    if shape == "composite_gtdb":
        return [(f"mesh {n}", n, None) for n in SLOTS]
    return [(f"1x{n} {s}", n, s) for n in SLOTS for s in ("genome", "code")]


# ----------------------------------------------------------------- worker

class Stages(logging.Handler):
    """The stages of the last ``search:`` log line."""

    def __init__(self):
        super().__init__()
        self.last: dict[str, float] = {}

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("search:") and "[" in msg:
            body = msg[msg.rindex("[") + 1:]
            self.last = {k: float(v)
                         for k, v in re.findall(r"(\w+): ([0-9.]+)s", body)}


def host_wraps(clock, modules) -> list:
    """Spans around the host construction of a tree that has it on its
    mesh path (a parent's), and around the kernels' wrappers."""
    index, ss, sc, count, composite = modules
    names = [(index, "load_sparse_index", "host.load"),
             (ss, "merge_components", "host.merge"),
             (ss, "build_sharded_db", "host.build"),
             (ss, "build_genome_sharded_db", "host.build"),
             (ss, "query_keys", "host.queries"),
             (ss, "upload_shards", "host.upload"),
             (sc, "_fold_ref", "host.fold"), (sc, "_fold_queries", "host.fold"),
             (count, "count_shared_kernel", "count.kernel"),
             (count, "count_shared_koc_kernel", "count.kernel"),
             (composite, "join_kernel", "join.kernel"),
             (composite, "_hits_to_stats_torch", "stats")]
    return [(m, n, spanned(clock, span, getattr(m, n)))
            for m, n, span in names if hasattr(m, n)]


def worker(args) -> dict:
    """Measure the tree at ``args.tree`` (its package imported): one JSON
    object with each route's check, walls, stages and split."""
    sys.path.insert(0, args.tree)
    import torch

    from public_kssd_tpu_torch import composite, index, parallel, search, utils
    from public_kssd_tpu_torch.ops import count
    from public_kssd_tpu_torch.parallel import sharded_composite as sc
    from public_kssd_tpu_torch.parallel import sharded_search as ss

    pkg = os.path.dirname(composite.__file__)
    if os.path.realpath(pkg) != os.path.realpath(
            os.path.join(args.tree, "public_kssd_tpu_torch")):
        raise RuntimeError(f"imported {pkg}, not the package of {args.tree}")
    dev = torch.device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    stages = Stages()
    utils.log.addHandler(stages)
    scratch = os.path.join(args.work, f"out_{os.getpid()}")
    out = {"tree": args.tree, "device": args.device, "shapes": {}}
    try:
        for shape in args.shapes:
            d = os.path.join(args.work, shape)
            if shape == "composite_gtdb":
                def call(n, strategy, clock=None, d=d):
                    mesh = parallel.Mesh(1, n, (dev,) * n)
                    with clock("composite") if clock else contextlib.nullcontext():
                        return sc.species_abundance_sharded(f"{d}/ref", f"{d}/qry", mesh)

                with contextlib.redirect_stdout(io.StringIO()):
                    want = composite.species_abundance(f"{d}/ref", f"{d}/qry",
                                                       device=dev)
            else:
                def call(n, strategy, clock=None, d=d):
                    search.search(f"{d}/sref", f"{d}/sqry", scratch, device=dev,
                                  mesh=parallel.Mesh(1, n, (dev,) * n),
                                  shard_strategy=strategy)
                    with open(f"{scratch}/distance.out", "rb") as f:
                        return f.read()

                search.search(f"{d}/sref", f"{d}/sqry", scratch, device=dev)
                with open(f"{scratch}/distance.out", "rb") as f:
                    want = f.read()
            res = {}
            for name, n, strategy in routes(shape):
                t0 = time.perf_counter()
                if call(n, strategy) != want:
                    raise AssertionError(f"{args.tree}: {shape} {name} differs from "
                                         "the one-card route")
                sync()
                warm = time.perf_counter() - t0
                walls, st = [], {}
                for _ in range(args.calls):
                    stages.last = {}
                    t0 = time.perf_counter()
                    call(n, strategy)
                    sync()
                    walls.append(time.perf_counter() - t0)
                    for k, v in stages.last.items():
                        st[k] = st.get(k, 0.0) + v / args.calls
                clock = SyncClock(sync)
                wraps = [(torch.profiler, "record_function", clock)] + host_wraps(
                    clock, (index, ss, sc, count, composite))
                with patched(wraps):
                    for _ in range(args.calls):
                        if call(n, strategy, clock) != want:
                            raise AssertionError(f"{shape} {name}: a split call "
                                                 "differs")
                split = {s: {k: v / args.calls for k, v in spans.items()}
                         for s, spans in clock.self_s.items()}
                res[name] = {"check": "byte-equal to the one-card route",
                             "warmup_s": warm, "walls": walls,
                             "wall_mean": sum(walls) / len(walls), "stages": st,
                             "split": split}
            out["shapes"][shape] = res
    finally:
        utils.log.removeHandler(stages)
        shutil.rmtree(scratch, ignore_errors=True)
    return out


# ------------------------------------------------------------------- main

def build(args, shape: str) -> None:
    """A shape's data under ``args.work``/<shape>, made once per seed
    (this tree's package and ``bench_torch.data``)."""
    sys.path.insert(0, ROOT)
    from bench_torch import data
    from public_kssd_tpu_torch import cli, synthdb

    d = os.path.join(args.work, shape)
    if os.path.isfile(f"{d}/complete"):
        return
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    n_ref, sketch, n_qry, q_codes = SIZES[shape]
    if args.small:
        n_ref, n_qry = max(n_ref // 10, 10), max(n_qry // 10, 2)
    if shape == "composite_gtdb":
        synthdb.build_synth_ref(f"{d}/ref", n_ref, sketch, seed=args.seed + 5)
        synthdb.build_synth_queries(f"{d}/qry", f"{d}/ref", n_qry, q_codes,
                                    hit_rate=0.3, seed=args.seed + 6, koc=True,
                                    focus_refs=200)
    elif shape == "wide_l3k12":  # chip_smoke.py phase 6's seeds
        refs, qrys, _ = data.make_genomes(f"{d}/fa", n_ref, n_qry, args.seed + 4)
        shuf = f"{d}/L3K12.shuf"
        for argv in (["shuffle", "-k", "12", "-s", "6", "-l", "3", "--seed", "3",
                      "-o", f"{d}/L3K12"],
                     ["dist", "-r", refs, "-L", shuf, "-o", f"{d}/sref",
                      "--no-dense-index", "--device", "cpu"],
                     ["dist", "-L", shuf, "-o", f"{d}/sqry", "--device", "cpu", qrys]):
            with contextlib.redirect_stdout(io.StringIO()):
                if cli.main(argv) != 0:
                    raise RuntimeError(f"kssd_torch {' '.join(argv)} failed")
    else:
        _, ref_codes, qry = data.synth_csr(n_ref, sketch, n_qry, args.seed)
        data.write_stage1_dir(f"{d}/sref", ref_codes, 7, "r")
        data.write_stage1_dir(f"{d}/sqry", qry.reshape(n_qry, sketch), 7, "q")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["dist", "-o", f"{d}/sref", f"{d}/sref",
                           "--no-dense-index", "--device", args.device])
        if rc != 0:
            raise RuntimeError(f"stage II of {d}/sref exited {rc}")
    open(f"{d}/complete", "w").close()


def run_worker(args, tree: str) -> dict:
    cmd = [sys.executable, os.path.abspath(__file__), "--worker", "--tree", tree,
           "--work", args.work, "--device", args.device, "--calls", str(args.calls),
           "--shapes", ",".join(args.shapes)]
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=tree)
    if r.returncode != 0:
        raise RuntimeError(f"worker on {tree} exited {r.returncode}:\n"
                           f"{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def medians(runs: list[dict], shape: str, route: str) -> dict:
    """Median over ``runs`` of a route's mean wall, stages and split."""
    rs = [r["shapes"][shape][route] for r in runs]
    med = statistics.median
    split = {}
    for s in sorted({s for r in rs for s in r["split"]}):
        names = sorted({k for r in rs for k in r["split"].get(s, {})})
        split[s] = {k: med([r["split"].get(s, {}).get(k, 0.0) for r in rs])
                    for k in names}
    return {"wall_mean": med([r["wall_mean"] for r in rs]),
            "stages": {k: med([r["stages"].get(k, 0.0) for r in rs])
                       for k in sorted({k for r in rs for k in r["stages"]})},
            "split": split}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--compare", type=int, default=0, metavar="N")
    ap.add_argument("--parent", help="the parent checkout's root (--compare)")
    ap.add_argument("--tree", default=ROOT, help="the checkout to measure")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--small", action="store_true",
                    help="a tenth of each shape's references and queries")
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--work")
    ap.add_argument("--out")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    args.shapes = [s for s in args.shapes.split(",") if s]
    if args.calls < 1 or not args.shapes or set(args.shapes) - set(SHAPES):
        ap.error(f"--calls must be at least 1 and --shapes among {SHAPES}")
    args.tree = os.path.abspath(args.tree)
    if args.worker:
        print(json.dumps(worker(args)))
        return 0
    if args.compare and not args.parent:
        ap.error("--compare needs --parent DIR")
    args.work = os.path.abspath(args.work or os.path.join(
        ROOT, "build", "mesh_spans", f"s{args.seed}{'_small' if args.small else ''}"))
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card is visible; use --device cpu")
    t0 = time.perf_counter()
    for shape in args.shapes:
        build(args, shape)
    lines = []

    def emit(obj):
        lines.append(json.dumps(obj))
        print(lines[-1], flush=True)

    summary = {"shapes": {s: SIZES[s] for s in args.shapes}, "small": args.small,
               "seed": args.seed, "calls": args.calls,
               "data_s": time.perf_counter() - t0, "card": card()}
    if not args.compare:
        run = run_worker(args, args.tree)
        emit(run)
        summary["routes"] = {s: {r: medians([run], s, r) for r, _, _ in routes(s)}
                             for s in args.shapes}
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
        for s in args.shapes:
            summary["routes"][s] = {}
            for r, _, _ in routes(s):
                diff = [c["shapes"][s][r]["wall_mean"] - p["shapes"][s][r]["wall_mean"]
                        for p, c in zip(runs["parent"], runs["change"])]
                summary["routes"][s][r] = {
                    "parent": medians(runs["parent"], s, r),
                    "change": medians(runs["change"], s, r),
                    "change_less_parent_s": diff,
                    "change_less_parent_median_s": statistics.median(diff),
                    "rounds_lower": sum(x < 0 for x in diff),
                }
    emit(summary)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
