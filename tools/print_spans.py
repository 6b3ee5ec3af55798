"""Where a search call's ``count`` and ``print`` stages spend their time.

Runs the benchmark's search call (``bench_torch``'s cell
``search_L3K10_1000x10k``: 1,000 query sketches against 10,000
reference sketches of 1,300 codes, the whole 10,000,001-line
``distance.out`` printed) and splits the main thread's stages into
their spans. ``count``:

* ``count.queries``: reading the query sketches, their query ids and
  segments, and their upload;
* ``count.index``: ``DeviceIndex.from_sparse`` (the index's upload and
  its bucket directory; once a call);
* ``count.kernel``: the count kernel's wrapper call;
* ``count.fetch``: the count matrix coming back to the host;
* ``count.skf``: writing ``sharedk_ct.dat``;
* ``count``: the rest of the stage.

``print``:

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
Both report the ``count`` spans again under ``count_spans``.
``write_floor_s`` is the seconds one thread takes to write as many
bytes as the call's ``distance.out`` from memory, in blocks of 16 MiB,
into a file beside it: what the write costs with no formatting at all;
``write_floor_par_s`` the same bytes written by ``dist -p`` threads,
each ``pwrite``-ing whole blocks at their known offsets.

``--fresh N`` runs N calls in fresh processes without the profiler:
each process's wall and the stages it logged.

``--upload`` times, in two fresh processes, the upload of the
reference index's three arrays (``uniq``, ``offsets``, ``gids``) to the
card: from pageable memory through their zero-copy signed views, and
from pinned staging (``pin_memory`` included); the first upload of the
process and the mean of the next ones.

``--refs 100000 --queries 10 --calls 0 --upload`` times a screen: a few
queries against an index of GTDB's order (130M postings).

Run from the checkout's root, on a card::

    python3 tools/print_spans.py [--clock 3] [--calls 1] [--threads 0]
                                 [--fresh N] [--upload] [--refs N] [--queries N]
                                 [--seed N] [--out FILE]

One JSON line per run on stdout, the last line a summary with the
device name; ``--out`` also writes them to a file.
"""

from __future__ import annotations

import argparse
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
from stage1_spans import clocked_calls, profiled_call  # noqa: E402

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


def count_spans(self_s: dict[str, float]) -> dict[str, float]:
    """The ``count`` stage's own entries of a span -> self time map."""
    return {k: v for k, v in self_s.items() if k == "count" or k.startswith("count.")}


def fresh_calls(argv: list[str], n: int, timeout: float = 900) -> dict:
    """n calls of ``argv`` in fresh processes, unprofiled: each process's
    wall (imports and the CUDA start included) and the stages its search
    logged."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    walls, stages = [], []
    for _ in range(n):
        t = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "public_kssd_tpu_torch.cli", *argv],
                           cwd=ROOT, env=env, capture_output=True, text=True,
                           timeout=timeout)
        walls.append(time.perf_counter() - t)
        if r.returncode != 0:
            raise RuntimeError(f"kssd_torch exited {r.returncode}: {r.stderr[-2000:]}")
        line = [x for x in r.stderr.splitlines() if "search:" in x][-1]
        stages.append({k: float(v) for k, v in
                       re.findall(r"(\w+): ([0-9.]+)s", line[line.rindex("["):])})
        shutil.rmtree(argv[argv.index("-o") + 1])
    return {"walls_s": walls, "stages_s": stages}


def upload_child(sref: str, mode: str, reps: int) -> dict:
    """In this (fresh) process: the reference index of ``sref`` uploaded
    ``reps`` + 1 times from pageable memory or pinned staging; the first
    upload's seconds and the mean of the rest. The card is touched once
    before, so neither pays for the process's CUDA start."""
    import numpy as np
    import torch

    from public_kssd_tpu_torch import index as index_mod

    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    _, comps = index_mod.load_sparse_index(sref)
    sp = comps[0]
    host = [sp.uniq_codes.view(np.int32), sp.offsets.view(np.int64),
            sp.gids.view(np.int32)]
    times = []
    for _ in range(reps + 1):
        t = time.perf_counter()
        if mode == "pinned":
            got = [torch.from_numpy(a).pin_memory().to(dev, non_blocking=True)
                   for a in host]
        else:
            got = [torch.from_numpy(a).to(dev) for a in host]
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        del got
    return {"mode": mode, "bytes": sum(a.nbytes for a in host),
            "first_s": times[0], "next_mean_s": sum(times[1:]) / max(reps, 1)}


def upload_times(sref: str, reps: int = 3) -> list[dict]:
    """``upload_child`` of each mode in a fresh process."""
    out = []
    env = dict(os.environ, PYTHONPATH=ROOT)
    for mode in ("pageable", "pinned"):
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--upload-child", mode,
             "--work", os.path.dirname(sref), "--clock", str(reps)],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
            check=True)
        out.append(json.loads(r.stdout.strip().splitlines()[-1]))
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clock", type=int, default=3)
    ap.add_argument("--calls", type=int, default=1)
    ap.add_argument("--threads", type=int, default=0, help="dist -p (0: every CPU)")
    ap.add_argument("--fresh", type=int, default=0)
    ap.add_argument("--upload", action="store_true")
    ap.add_argument("--upload-child", choices=("pageable", "pinned"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--refs", type=int, default=10_000)
    ap.add_argument("--queries", type=int, default=1_000)
    ap.add_argument("--sketch", type=int, default=1_300)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--work", default=os.path.join(ROOT, "build", "print_spans"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.upload_child:
        print(json.dumps(upload_child(os.path.join(args.work, "sref"),
                                      args.upload_child, args.clock)))
        return 0
    import torch

    from public_kssd_tpu_torch import resolve_device
    from public_kssd_tpu_torch.ops import stats

    device = resolve_device(args.device)
    kind, smi = device_names(device)
    shutil.rmtree(args.work, ignore_errors=True)
    os.makedirs(args.work)
    # the search cell's sketches (bench_torch/run.py search_cell)
    t = time.perf_counter()
    _, ref_codes, qry = data.synth_csr(args.refs, args.sketch, args.queries,
                                       args.seed + 2)
    sref, sqry, t_index = search_dirs(args.work, ref_codes,
                                      qry.reshape(args.queries, args.sketch),
                                      device.type)
    del ref_codes, qry
    setup_s = time.perf_counter() - t

    def dist(out: str) -> list[str]:
        return ["dist", "-r", sref, "-o", os.path.join(args.work, out),
                "-p", str(args.threads), sqry, "--device", device.type]

    from bench_torch.run import run_cli

    run_cli(*dist("warm"))  # builds the kernels and the host library
    size = os.path.getsize(os.path.join(args.work, "warm", "distance.out"))
    shutil.rmtree(os.path.join(args.work, "warm"))
    shape = {"refs": args.refs, "queries": args.queries, "sketch": args.sketch}
    lines = []
    for i in range(args.calls):
        res = profiled_call(dist(f"p{i}"), os.path.join(args.work, f"trace{i}"), 900)
        shutil.rmtree(os.path.join(args.work, f"p{i}"))
        lines.append({"cell": SEARCH, **shape, "call": i,
                      "count_spans": count_spans(res["self_ms"]), **res})
        print(json.dumps(lines[-1]), flush=True)
    if args.clock:
        res = clocked_calls(dist("c"), args.clock)
        res["count_spans"] = count_spans(res["self_s"])
        floor = os.path.join(args.work, "floor")
        res["write_floor_s"] = write_floor(floor, size, args.clock)
        res["write_floor_par_s"] = write_floor_par(
            floor, size, stats.print_threads(args.threads), args.clock)
        lines.append({"cell": SEARCH, **shape, "clocked_calls": args.clock,
                      "distance_out_bytes": size, **res})
        print(json.dumps(lines[-1]), flush=True)
    if args.fresh:
        lines.append({"cell": SEARCH, **shape, "fresh_calls": args.fresh,
                      **fresh_calls(dist("f"), args.fresh)})
        print(json.dumps(lines[-1]), flush=True)
    if args.upload and device.type == "cuda":
        lines.append({"cell": SEARCH, **shape,
                      "upload": upload_times(sref, max(args.clock, 1))})
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
    shutil.rmtree(args.work)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
