"""Where a search call's ``print`` stage spends its time.

Runs the benchmark's search call (``bench_torch``'s cell
``search_L3K10_1000x10k``: 1,000 query sketches against 10,000
reference sketches of 1,300 codes, the whole 10,000,001-line
``distance.out`` printed) and splits the main thread's ``print`` stage
into its spans:

* ``print.wait``: waiting for the next block of lines from the
  formatting threads (``ops/stats.py`` ``_write_native``);
* ``print.write``: writing a formatted block to ``distance.out``;
* ``print``: the rest of the stage (the header, cutting the blocks,
  submitting them).

``--clock N`` times N unprofiled calls in this process with the spans
read on the host clock (``tools/stage1_spans.py``'s ``HostClock``: no
profiler, so no per-op overhead) and reports each span's mean self
seconds a call. ``--calls N`` runs N calls with ``--profile`` in fresh
processes and reports each trace's span self times, idle share and
longest idle gaps by innermost span. ``write_floor_s`` is the seconds
one thread takes to write as many bytes as the call's ``distance.out``
from memory, in blocks of 16 MiB, into a file beside it: what the
write costs with no formatting at all.

Run from the checkout's root, on a card::

    python3 tools/print_spans.py [--clock 3] [--calls 1] [--threads 0]
                                 [--seed N] [--out FILE]

One JSON line per run on stdout, the last line a summary with the
device name; ``--out`` also writes them to a file.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bench_torch import data  # noqa: E402
from bench_torch.run import SEARCH, SEED, device_names, search_dirs  # noqa: E402
from stage1_spans import clocked_calls, profiled_call  # noqa: E402


def write_floor(path: str, n_bytes: int, reps: int, block: int = 16 << 20) -> list[float]:
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


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clock", type=int, default=3)
    ap.add_argument("--calls", type=int, default=1)
    ap.add_argument("--threads", type=int, default=0, help="dist -p (0: every CPU)")
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--refs", type=int, default=10_000)
    ap.add_argument("--queries", type=int, default=1_000)
    ap.add_argument("--sketch", type=int, default=1_300)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--work", default=os.path.join(ROOT, "build", "print_spans"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from public_kssd_tpu_torch import resolve_device
    from public_kssd_tpu_torch.ops import stats

    device = resolve_device(args.device)
    kind, smi = device_names(device)
    shutil.rmtree(args.work, ignore_errors=True)
    os.makedirs(args.work)
    # the search cell's sketches (bench_torch/run.py search_cell)
    _, ref_codes, qry = data.synth_csr(args.refs, args.sketch, args.queries,
                                       args.seed + 2)
    sref, sqry, _ = search_dirs(args.work, ref_codes,
                                qry.reshape(args.queries, args.sketch), device.type)

    def dist(out: str) -> list[str]:
        return ["dist", "-r", sref, "-o", os.path.join(args.work, out),
                "-p", str(args.threads), sqry, "--device", device.type]

    from bench_torch.run import run_cli

    run_cli(*dist("warm"))  # builds the kernels and the host library
    size = os.path.getsize(os.path.join(args.work, "warm", "distance.out"))
    shutil.rmtree(os.path.join(args.work, "warm"))
    lines = []
    for i in range(args.calls):
        res = profiled_call(dist(f"p{i}"), os.path.join(args.work, f"trace{i}"), 900)
        shutil.rmtree(os.path.join(args.work, f"p{i}"))
        lines.append({"cell": SEARCH, "call": i, **res})
        print(json.dumps(lines[-1]), flush=True)
    if args.clock:
        res = clocked_calls(dist("c"), args.clock)
        res["write_floor_s"] = write_floor(os.path.join(args.work, "floor"), size,
                                           args.clock)
        lines.append({"cell": SEARCH, "clocked_calls": args.clock,
                      "distance_out_bytes": size, **res})
        print(json.dumps(lines[-1]), flush=True)
    lines.append({"device": kind, "gpu": smi, "torch": torch.__version__,
                  "seed": args.seed, "print_threads": stats.print_threads(args.threads),
                  "host_cpus": len(os.sched_getaffinity(0))})
    print(json.dumps(lines[-1]), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)
    shutil.rmtree(args.work)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
