#!/usr/bin/env python3
"""Smoke test of public_kssd_tpu_torch on one NVIDIA GPU (sm_90a: H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then nonzero):

  1. device   a CUDA card must be visible; prints its name and power limit
  2. build    compiles csrc/sketch.cu (kernels sketch and sketch_wide),
              csrc/count.cu (count, count_koc, count64, count_koc64) and
              csrc/join.cu (join, join64) with nvcc into
              build/public_kssd_tpu_torch/, one nvcc per source, all
              started together
  3. kernels  each kernel against its plain PyTorch version on the card,
              exact equality, with the time of both (CUDA events around
              the wrapper call), the device time split by kernel
              (torch.profiler) and the bound (the bytes the call must
              move over 3.35 TB/s, or its operations over the ALU rate):
              sketch (positions and codes of the kept windows) at
              (k,s,l) = (10,6,3) Feistel, (8,5,2) table and (6,5,1)
              Feistel on 2^24 packed symbols; sketch_wide at (12,6,3)
              Feistel and table (36-bit codes), (15,7,1) Feistel (56
              bits) and (16,6,1) Feistel (60 bits, W = 32); both on 2^24
              symbols holding a poly-A run of 2^20 bases in a space that
              keeps every window of it; sketch_codes_stream at (10,6,3)
              and (12,6,3) on the card against the same call on CPU
              tensors; pack2_torch on the card against pack2;
              sketch_codes_multi over 200 streams of 2^22 symbols in
              chunks of 2^16 (the pinned staging rotation, the deferred
              fill pass, one fetch) on the card against the CPU; count
              at 1,000 queries x 10,000 refs x ~1,300 codes (13M
              postings, the shared-row variant) and on full 32-bit
              codes; count_koc (the abundance-weighted twin) at
              the same shape with abundances 1..65535 and one planted
              cell past 2^32; count64 and count_koc64 (the 64-bit-key
              instances of the mesh search) at the same shape with every
              key moved to code << 36 | 5, so that about half are >=
              2^63, also against the host oracle (count64's on the
              uint64 keys); all four instances again in the
              global-atomics variant at the GTDB species-group shape of
              phase 7b (65,702 refs x 8 samples), against the host
              oracle; join
              (composite) over the inverted index and over raw DB codes,
              and join64 on the raw route with keys code << 36 | 7 (its
              keys equal the 32-bit join's): on the GTDB-species-shaped
              database of phase 7b (timed, with bounds for both join
              routes), the same with one hot code that every reference
              and every sample holds, chunk tails (1,000,003 and 7 rows)
              and a table no DB row matches; the stage II device sort
  4. sketch-heavy main path through kssd_torch's CLI: 64 reference and 16
              query genomes of 5.3 Mb (queries are references with 1-5%
              point mutations); shuffle, dist -r refs, dist queries, dist
              -r ref qry; distance.out byte-equal to the --cpu-count run;
              shufspace.detect of the .shuf on the card (the whole-table
              Feistel check the CLI runs before stage I), timed, its
              verdict equal to the numpy check's on the run's .shuf and on
              a copy with two entries swapped past the spot-check; the
              references again as gzip, each one member but the first
              bgzip-style (a member for each 64 KB, then an empty one):
              dist -r of them gives combco files byte-equal to the plain
              FASTA run's; logs the inflater the host loaded (libdeflate,
              the system zlib, or the gzip module) and the parse pool's
              seconds over those files; each reference's FASTA scanned
              in place by native/kssd_scan.c's kssd_fasta_scan and by the
              reference scanner kssd_fasta_to_codes, the same symbols,
              with one thread's ms a file for each; then the three
              commands as a user runs them, each in its own fresh process
              through the CLI's entry (python3 -m public_kssd_tpu_torch.cli):
              the outputs byte-equal to the in-process runs', each
              process's wall logged; and each again through
              tools/fresh_start.py's probed child (the same cli.main and
              the entry's close-out), its outputs byte-equal too, with
              where its start went (the interpreter, import torch, the
              card's start on its thread and the main thread's wait for
              it, the .shuf check, the first genome's parse, the stages)
              and its exit's steps; then a failing search through the
              entry, with the exit code and stderr of main's code handed
              to the interpreter's exit
  5. search-heavy main path: the 10,000-ref synthetic DB of phase 3 as a
              stage I directory, indexed and searched by 1,000 queries
              through the CLI; distance.out byte-equal to --cpu-count and
              to dist -p 1 (the print on one thread); the print stage
              logged with its thread count (dist -p's default: every CPU
              the process may use), and the load_index and count stages
              with their spans (index.read, index.wait, index.directory;
              count.queries, count.index, count.kernel, count.fetch,
              count.skf; on the host clock, as tools/print_spans.py
              --clock reads them) and no sharedk_ct.dat written (no
              --keepskf, no -m); the database loaded onto the card both
              ways, DeviceIndex.from_sparse of load_sparse_index and
              index.load_device_index (the search's route), every tensor
              equal, both walls logged; first, the %.6lf and %E field writers
              of native/kssd_print.c against this host's snprintf on
              10^7 seeded doubles and the corner list
              (native.field_values), no difference allowed, with the share
              of values that took snprintf
  6. wide main path at L3K12 (k=12 s=6 l=3: 36-bit codes, 256
              components): 16 reference and 4 query genomes of 5.3 Mb
              through the CLI (stage II with --no-dense-index);
              distance.out byte-equal to --cpu-count, each query matches
              its source best, and the combco files of two queries are
              byte-equal between --device cuda and --device cpu; the
              stage I timer's stages logged, dedup among them (the
              slot-order dedup of native/kssd_dedup.c, over the filled
              slots of a 536,870,909-slot table at L3K12); the 256
              components' index loaded both ways, as in phase 5
  7. abundance main path through the CLI:
     7a. metagenome reads: 2 FASTQ samples of 1,000,000 x 150 bp reads,
              90% drawn from 12 of phase 4's 64 references (shares a
              geometric series of ratio 1.5, 0.5% substitutions), 10%
              random; sketched with dist -A; dist -r ref --koc-out
              byte-equal to --cpu-count; composite -q reports byte-equal
              between --device cuda, --device cpu and the host oracle,
              naming exactly the 12 planted references, the three
              largest shares leading the mean-abundance column in order;
              -b .abv files byte-equal between cuda and cpu; -i, then -s
              0|1|2 by the host walk and by the dense search on the card;
              the -q runs of both devices never reach the host query
              table or hit statistics (_query_table, _hits_to_stats)
     7b. composite at the GTDB species-group database's shape (65,702
              references x 300 codes, synthdb) with 8 samples of
              200,000 codes (koc): the reports over the indexed DB (CSR
              route) and over an unindexed copy (raw route) byte-equal
              to the host oracle, each route's stages and hit keys
              logged; the host versions refused while they run (the
              host's DB read and genome ids, _raw_components, too: the
              raw route reads its DB straight onto the card), each
              query table the route built on the card equal to
              _query_table's (directory included), and the card's
              statistics of the route's hit keys equal to _hits_to_stats
              of the same keys fetched to the host; both routes again
              under two forced small budgets of free bytes, one that
              splits the statistics into ranges of whole queries and one
              that cuts the largest query by reference: reports
              byte-equal to the host oracle, the ranges logged
  8. sharded main path (the mesh search and composite on one card; the
     shards, query keys and folded DB built on the card, the host index
     read refused in 8a-8c):
     8a. sharded_search_counts on phase 5's 1,000 x 10k DB over the
              meshes [cuda:0] 1x1 and [cuda:0]*4 at 1x4 and 2x2, by the
              genome and the code strategy, equal to the single-device
              counts; and the --koc-out counts of phase 7a's samples over
              1x4 and 2x2, equal to the single-device count_shared_koc;
              each wall logged with the shards' build apart from the
              count, and the card's peak allocation against the shards'
              bytes; 1x4 again with the index read in 16 MiB groups
     8b. kssd_torch dist --mesh 1x1, both strategies, on phase 6's L3K12
              DB (256 components folded into one key space):
              distance.out byte-equal to phase 6's plain run
     8c. kssd_torch composite --mesh 1 on phase 7b's GTDB shape, and the
              same join over [cuda:0]*4: reports byte-equal to 7b's host
              oracle report, the statistics on the card (the host
              versions refused)
     8d. dist --shard 0:2, --shard 1:2 and --merge-shards on phase 4's
              references: the merged combco files byte-equal to phase
              4's unsharded stage I
  9. host commands and --profile, on phase 4's sketches:
     9a. in one fresh process, as a user runs them: dist -L L3K10
              --profile DIR on two raw references: combco files
              byte-equal to the run without the flag, and the trace names
              sketch_keep_kernel and sketch_fill_kernel; dist -r ref
              --keepskf --profile DIR on the card: distance.out and
              sharedk_ct.dat byte-equal to phase 4's, and the trace names
              a count kernel
     9b. set -u of the references (pan.0 = their distinct codes), set -i
              and set -s of the queries against it (together each query's
              codes); the intersected queries searched on the card give
              phase 4's sharedk_ct.dat byte for byte, the subtracted ones
              all zeros; set -P prints the 64 reference names
     9c. reverse of the queries to k-mers, written as fastas of one record
              per k-mer and sketched again on the card: each query's codes
     9d. primer (44 primes) and convert krona / qiime / cami on a seeded
              report of 40 references: their line counts

Launch counts are reset before phase 4 and read after phase 5 (sketch,
count), reset before phase 6 and read after it (sketch_wide), reset
before phase 7 and read after it (count_koc, join on each route), and
reset before phase 8 and read after it (count64, count_koc64, join64).
Phase 9 resets them again and logs its own launches; they are not in the
JSON line of per-kernel results. The output ends with a JSON line of per-kernel results, the card's name and
power limit from nvidia-smi, and the line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Everything the run writes goes under build/chip_smoke/ in the checkout
and is removed at the end. The seeded genomes and synthetic sketch
databases come from bench_torch/data.py, which the benchmark
(python3 -m bench_torch) shares.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from bench_torch.data import GENOME_BP, make_genomes, synth_csr
from bench_torch.trace import STAGE_WALL, StageLog, kernel_names, load_trace

ROOT = os.path.dirname(os.path.abspath(__file__))
N_REF_GENOMES, N_QRY_GENOMES = 64, 16
N_WIDE_REFS, N_WIDE_QRYS = 16, 4
SYNTH_REFS, SYNTH_QRYS, SYNTH_SKETCH = 10_000, 1_000, 1_300
SKETCH_SYMBOLS = 1 << 24
# phase 3's sketch_codes_multi check: a quarter of the symbols with
# breaks, cut into this many streams, in chunks of this many symbols
MULTI_STREAMS, MULTI_BLOCK = 200, 1 << 16
SEED = 20261016
N_SAMPLES, N_READS, READ_LEN = 2, 1_000_000, 150
N_PLANTED, SHARE_RATIO = 12, 1.5
GTDB_REFS, GTDB_SKETCH = 65_702, 300  # synthdb.py: GTDB species groups
# 8 samples, not 16: with 16 the host oracle alone took 61.5 s of the
# phase's 66.5 s on an H100's host (one searchsorted of all 19.7M DB
# codes per sample; PERF.md)
GTDB_SAMPLES, GTDB_SAMPLE_CODES = 8, 200_000
FIELD_VALUES = 10_000_000  # phase 5: doubles through the print's field writers


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean device milliseconds per call of ``fn`` (CUDA events, after
    one warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 3) -> tuple[float | None, dict[str, float]]:
    """Device milliseconds per call of ``fn`` (the kernels, copies and
    memsets it puts on the card, once each per call; torch.profiler over
    ``reps`` calls after a warm-up call) and the same split by name;
    (None, {}) where the profiler reports no device time. Each name's
    time is its mean per occurrence: the profiler may drop a call's
    events, and a sum over ``reps`` would then read low."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0 and e.count:
            by_name[e.key] = us / 1e3 / e.count
    total = sum(by_name.values())
    return (total or None), by_name


def device_note(fn) -> str:
    """``device_ms`` of ``fn`` as a log fragment: the total and the three
    largest parts (names cut to 40 characters after the anonymous
    namespace of the kernel sources)."""
    total, parts = device_ms(fn)
    if total is None:
        return "device time not measured (the profiler saw no device work)"
    top = sorted(parts.items(), key=lambda kv: -kv[1])[:3]
    return f"device {total:.4f} ms [" + "; ".join(
        f"{k.replace('void (anonymous namespace)::', '')[:40]} {v:.4f}"
        for k, v in top) + "]"


def max_abs_err(a, b) -> int:
    """Largest absolute difference of two integer tensors (int64)."""
    import torch

    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    err = int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
    # a difference of 2^63 wraps to a negative int64
    return err if err > 0 or torch.equal(a, b) else 1 << 63


def run_cli(*argv: str) -> float:
    """kssd_torch <argv> in this process; returns its wall seconds."""
    return run_cli_out(*argv)[0]


def run_cli_out(*argv: str) -> tuple[float, str]:
    """kssd_torch <argv> in this process; returns its wall seconds and
    what it printed on stdout."""
    import torch

    from public_kssd_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"kssd_torch {' '.join(argv)} exited {rc}")
    return dt, buf.getvalue()


@contextlib.contextmanager
def host_stats_refused():
    """composite's host query table and hit statistics (_query_table,
    _hits_to_stats: the JAX package's host versions, kept as oracles) and
    the host oracle's DB read with its genome ids (_raw_components,
    rid_of) raise while this is open: a device route must not reach
    them."""
    from public_kssd_tpu_torch import composite

    def refuse(*args, **kwargs):
        raise AssertionError("a device route of composite reached its host "
                             "query table, hit statistics or DB read")

    names = ("_query_table", "_hits_to_stats", "_raw_components")
    saved = [getattr(composite, n) for n in names]
    for n in names:
        setattr(composite, n, refuse)
    try:
        yield
    finally:
        for n, fn in zip(names, saved):
            setattr(composite, n, fn)


@contextlib.contextmanager
def host_fold_refused():
    """The port's host index read (index.load_sparse_index) raises while
    this is open: a mesh route must read the index and the sketches onto
    the card, fold them and build its shards there (the port has no
    numpy construction of the shards to fall back to)."""
    from public_kssd_tpu_torch import index

    def refuse(*args, **kwargs):
        raise AssertionError("a mesh route read the index on the host")

    saved = index.load_sparse_index
    index.load_sparse_index = refuse
    try:
        yield
    finally:
        index.load_sparse_index = saved


def same_bytes(a: str, b: str) -> int:
    """Assert two files are byte-equal; returns their size."""
    with open(a, "rb") as fa, open(b, "rb") as fb:
        xa, xb = fa.read(), fb.read()
    if xa != xb:
        raise AssertionError(f"{a} ({len(xa)} B) differs from {b} ({len(xb)} B)")
    return len(xa)


# ------------------------------------------------------------------ data

def read_fasta_2bit(path: str) -> np.ndarray:
    """A one-record ACGT fasta written by write_fasta -> uint8 0..3."""
    with open(path, "rb") as f:
        raw = f.read()
    seq = np.frombuffer(raw[raw.index(b"\n") + 1:].replace(b"\n", b""), np.uint8)
    lut = np.zeros(256, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    return lut[seq]


def write_reads(path: str, genomes: list[np.ndarray], shares: np.ndarray,
                rng: np.random.Generator) -> None:
    """N_READS reads of READ_LEN bp as plain fastq: 90% drawn from
    ``genomes`` in proportion to ``shares`` (either strand, 0.5%
    substitutions), 10% uniformly random sequence."""
    n_planted = int(N_READS * 0.9)
    counts = np.floor(shares / shares.sum() * n_planted).astype(np.int64)
    counts[0] += n_planted - counts.sum()
    parts = []
    for g, c in zip(genomes, counts):
        starts = rng.integers(0, g.size - READ_LEN + 1, c)
        parts.append(g[starts[:, None] + np.arange(READ_LEN)])
    parts.append(rng.integers(0, 4, (N_READS - n_planted, READ_LEN), dtype=np.uint8))
    reads = np.concatenate(parts)
    rc = rng.random(N_READS) < 0.5
    reads[rc] = 3 - reads[rc, ::-1]
    sub = rng.random(reads.shape) < 0.005
    reads[sub] = (reads[sub] + rng.integers(1, 4, int(sub.sum()), dtype=np.uint8)) % 4
    reads = reads[rng.permutation(N_READS)]
    acgt = np.frombuffer(b"ACGT", np.uint8)
    head = np.frombuffer(
        b"".join(b"@r%07d\n" % i for i in range(N_READS)), np.uint8
    ).reshape(N_READS, -1)
    sep = np.frombuffer(b"\n+\n", np.uint8)[None].repeat(N_READS, 0)
    qual = np.full((N_READS, READ_LEN), ord("I"), np.uint8)
    rec = np.hstack([head, acgt[reads], sep, qual, sep[:, :1]])
    with open(path, "wb") as f:
        f.write(rec.tobytes())


def make_samples(root: str, ref_dir: str) -> list[list[int]]:
    """N_SAMPLES fastq samples, each from its own N_PLANTED of the
    references in ``ref_dir`` (chosen from SEED) with shares 1.5^-j.
    Returns the planted reference indices of each sample, largest share
    first."""
    rng = np.random.default_rng(SEED + 7)
    names = sorted(os.listdir(ref_dir))
    shares = SHARE_RATIO ** -np.arange(N_PLANTED, dtype=np.float64)
    os.makedirs(root)
    planted = []
    for s in range(N_SAMPLES):
        pick = [int(i) for i in rng.choice(len(names), N_PLANTED, replace=False)]
        genomes = [read_fasta_2bit(f"{ref_dir}/{names[i]}") for i in pick]
        write_reads(f"{root}/sample{s}.fq", genomes, shares, rng)
        planted.append(pick)
    return planted


def build_gtdb(root: str) -> tuple[str, str]:
    """The GTDB species-group database's shape (synthdb: 65,702 groups,
    uniform 300 codes, 28-bit codes) and GTDB_SAMPLES metagenome-shaped
    koc samples; returns (ref dir, query dir)."""
    from public_kssd_tpu_torch import synthdb

    ref, qry = f"{root}/ref", f"{root}/qry"
    synthdb.build_synth_ref(ref, GTDB_REFS, GTDB_SKETCH, seed=SEED + 5)
    synthdb.build_synth_queries(qry, ref, GTDB_SAMPLES, GTDB_SAMPLE_CODES,
                                hit_rate=0.3, seed=SEED + 6, koc=True,
                                focus_refs=200)
    return ref, qry


def report_rows(report: str) -> dict[str, list[list[str]]]:
    """Composite report -> {sample: [[ref, kmer_num, mean, pctl_mean,
    median, max], ...]} in report order."""
    rows: dict[str, list[list[str]]] = {}
    for line in report.splitlines():
        f = line.split("\t")
        rows.setdefault(f[0], []).append(f[1:])
    return rows


def abv_measures(report: str) -> dict[str, float]:
    return {a: float(b) for a, b in (
        ln.split("\t") for ln in report.splitlines() if not ln.startswith("#")
    )}


# ------------------------------------------------------------------ phases

def phase_device() -> tuple[str, str]:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit(
            "chip_smoke: torch.cuda.is_available() is False; this smoke "
            "test needs a CUDA card"
        )
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {kind}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"nvidia-smi: {smi}")
    return kind, smi


def phase_build() -> None:
    from public_kssd_tpu_torch import kernels

    first = {}  # one kernel per source: kernels of a source share a library
    for k in kernels.ALL:
        first.setdefault(k.source, k)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(first)) as ex:
        list(ex.map(lambda k: k.build(), first.values()))
    for k in kernels.ALL:
        k.function()
        log(f"[build] {k.name}: {k.entry} in {k.so_path()}")
    log(f"[build] {len(first)} sources in {time.perf_counter() - t0:.3f} s")


def phase_kernels(device, work: str) -> tuple[dict, tuple[np.ndarray, np.ndarray]]:
    import torch

    from public_kssd_tpu_torch import formats, kernels, shufspace
    from public_kssd_tpu_torch import index as index_mod
    from public_kssd_tpu_torch.config import SketchParams
    from public_kssd_tpu_torch.ops import count, sketch
    from public_kssd_tpu_torch.seqio import BREAK

    res = {k.name: {"err": 0} for k in kernels.ALL}
    rng = np.random.default_rng(SEED + 1)
    n = SKETCH_SYMBOLS
    n_valid = n - 12_345
    sym = rng.integers(0, 4, size=n, dtype=np.uint8)
    words = torch.from_numpy(sketch.pack2(sym, n).view(np.int32)).to(device)
    timed = ((10, 6, 3, "feistel"), (12, 6, 3, "feistel"))  # main-path geometries
    for k, s, l, mode in (
        (10, 6, 3, "feistel"), (8, 5, 2, "table"), (6, 5, 1, "feistel"),
        (12, 6, 3, "feistel"), (12, 6, 3, "table"), (15, 7, 1, "feistel"),
        (16, 6, 1, "feistel"),
    ):
        p = SketchParams.create(k=k, drlevel=l, subk=s, seed=k)
        name = "sketch_wide" if p.drtuple_bits > 31 else "sketch"
        if mode == "feistel":
            shuf = shufspace.ComputedShuf(p.id, p.half_subctx_len)
        else:
            shuf = sketch.as_shuf(formats.make_shuffled_dim(p, seed=k), device)
        kept, ms, plain_ms = check_sketch(name, res, words, n_valid, shuf, p,
                                          (k, s, l, mode))
        log(f"[kernels] {name} (k,s,l)=({k},{s},{l}) {mode}, {p.drtuple_bits}-bit "
            f"codes: {n} windows, {kept} kept, (pos, code) equal; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
        if (k, s, l, mode) in timed:
            res[name].update(ms=ms, plain_ms=plain_ms,
                             bound=sketch_bound(words.numel(), n_valid - p.TL + 1,
                                                kept, p))

    # every window kept: a poly-A run of 2^20 bases in a space whose rank
    # of the inner value 0 (poly-A's canonical k-mer) is kept
    poly = sym.copy()
    run = (n // 4, n // 4 + n // 16)  # 2^20 bases at 2^24 symbols
    poly[run[0]:run[1]] = 0
    poly_words = torch.from_numpy(sketch.pack2(poly, n).view(np.int32)).to(device)
    for k in (10, 12):
        p = kept_at_zero(k, 6, 3)
        shuf = shufspace.ComputedShuf(p.id, p.half_subctx_len)
        name = "sketch_wide" if p.drtuple_bits > 31 else "sketch"
        pos, kept = check_sketch(name, res, poly_words, n, shuf, p,
                                 (k, 6, 3, "poly-A"), timing=False)
        in_run = run[1] - run[0] - p.TL + 1
        if int(((pos >= run[0]) & (pos < run[1] - p.TL + 1)).sum()) != in_run:
            raise AssertionError(f"{name}: a window of the poly-A run was dropped")
        log(f"[kernels] {name} (k,s,l)=({k},6,3) Feistel id {p.id}, poly-A run of "
            f"{run[1] - run[0]} bases: all {in_run} windows of the run kept, "
            f"{kept} in all, (pos, code) equal to plain")

    # the streaming path around the kernels: breaks, tails, chunking
    brk = sym.copy()
    brk[rng.integers(0, n, size=2000)] = BREAK
    brk[n // 3 : n // 3 + 300] = BREAK  # an N run
    for k in (10, 12):
        p = SketchParams.create(k=k, drlevel=3, subk=6, seed=k)
        comp = shufspace.ComputedShuf(p.id, p.half_subctx_len)
        t0 = time.perf_counter()
        codes_d, pos_d = sketch.sketch_codes_stream(brk, comp, p, device=device)
        t_dev = time.perf_counter() - t0
        t0 = time.perf_counter()
        codes_c, pos_c = sketch.sketch_codes_stream(brk, comp, p, device=torch.device("cpu"))
        t_cpu = time.perf_counter() - t0
        if not (np.array_equal(codes_d, codes_c) and np.array_equal(pos_d, pos_c)) or not codes_d.size:
            raise AssertionError(f"sketch_codes_stream at k={k} on the card != on the CPU")
        log(f"[kernels] sketch_codes_stream (k,s,l)=({k},6,3) 2^24 symbols with "
            f"breaks: {codes_d.size} codes, card == CPU; card {t_dev:.3f} s, CPU "
            f"plain {t_cpu:.3f} s (host clock)")

    # the card's packer against the host's, on the symbols with breaks
    packed = sketch.pack2_torch(torch.from_numpy(brk).to(device), n)
    if not np.array_equal(packed.cpu().numpy(), sketch.pack2(brk, n).view(np.int32)):
        raise AssertionError("pack2_torch on the card != pack2 on the host")
    log("[kernels] pack2_torch of 2^24 symbols with breaks on the card == pack2")

    # many streams at a small block: the pinned staging rotation, the
    # deferred fill and the group's one fetch, over many chunks
    cuts = np.sort(rng.choice(n // 4, size=MULTI_STREAMS - 1, replace=False))
    streams = np.split(brk[: n // 4], cuts)
    for k in (10, 12):
        p = SketchParams.create(k=k, drlevel=3, subk=6, seed=k)
        comp = shufspace.ComputedShuf(p.id, p.half_subctx_len)
        got, walls = {}, {}
        for on in (device, torch.device("cpu")):
            t0 = time.perf_counter()
            got[on.type] = sketch.sketch_codes_multi(iter(streams), comp, p,
                                                     block=MULTI_BLOCK, device=on)
            walls[on.type] = time.perf_counter() - t0
        if any(not np.array_equal(a, b)
               for a, b in zip(got["cuda"], got["cpu"], strict=True)):
            raise AssertionError(f"sketch_codes_multi at k={k} on the card != on the CPU")
        log(f"[kernels] sketch_codes_multi (k,s,l)=({k},6,3) {len(streams)} streams, "
            f"{n // 4} symbols, block {MULTI_BLOCK} ({-(-n // 4 // MULTI_BLOCK)}+ "
            f"chunks): {sum(g.size for g in got['cpu'])} codes, card == CPU; card "
            f"{walls['cuda']:.3f} s, CPU plain {walls['cpu']:.3f} s (host clock)")

    # counting at the 1000 x 10k bench shape
    t0 = time.perf_counter()
    sp, ref_codes, qry = synth_csr(SYNTH_REFS, SYNTH_SKETCH, SYNTH_QRYS, SEED + 2)
    log(f"[kernels] synthetic DB: {SYNTH_REFS} refs, {sp.gids.size} postings, "
        f"{sp.uniq_codes.size} codes, {SYNTH_QRYS} queries "
        f"({time.perf_counter() - t0:.1f} s host)")
    qidx = np.arange(SYNTH_QRYS + 1, dtype=np.uint64) * SYNTH_SKETCH
    index = count.DeviceIndex.from_sparse(sp, device)
    if count.count_variant(index.n_ref, koc=True) != "shared":
        raise AssertionError("1,000 x 10k should take the shared-row variant")
    qc = torch.from_numpy(qry.view(np.int32)).to(device)
    qq = torch.from_numpy(count.query_ids(qidx, qry.size)).to(device)
    seg = torch.from_numpy(qidx.astype(np.int64)).to(device)
    host = count.count_shared_np(qry, qidx, sp.uniq_codes, sp.offsets, sp.gids,
                                 SYNTH_QRYS, SYNTH_REFS)
    want = count.count_shared_torch(qc, qq, index, SYNTH_QRYS)
    for args in ((qc, qq, index, SYNTH_QRYS), (qc, qq, index, SYNTH_QRYS, seg)):
        got = count.count_shared_kernel(*args)
        err = max_abs_err(got, want)
        res["count"]["err"] = max(res["count"]["err"], err)
        if (err or not np.array_equal(got.cpu().numpy().view(np.uint32), host)
                or not host.sum()):
            raise AssertionError(f"count kernel != plain/host: max_abs_err {err}")
    ms = cuda_ms(lambda: count.count_shared_kernel(qc, qq, index, SYNTH_QRYS, seg))
    ms_check = cuda_ms(lambda: count.count_shared_kernel(qc, qq, index, SYNTH_QRYS))
    plain_ms = cuda_ms(lambda: count.count_shared_torch(qc, qq, index, SYNTH_QRYS))
    pairs = SYNTH_QRYS * SYNTH_REFS
    log(f"[kernels] count {SYNTH_QRYS} x {SYNTH_REFS}, shared-row variant: "
        f"{int(host.sum())} shared codes, equal to plain and host; kernel {ms:.4f} "
        f"ms ({pairs / ms * 1e3:.4g} pairs/s; {ms_check:.4f} ms without the "
        f"segments, with the order check), plain {plain_ms:.4f} ms")
    log("[kernels] count: " + device_note(
        lambda: count.count_shared_kernel(qc, qq, index, SYNTH_QRYS, seg)))
    res["count"].update(ms=ms, plain_ms=plain_ms,
                        bound=count_bound(qry, sp.uniq_codes, sp.offsets, pairs, False))

    # the koc twin at the same shape: abundances 1..65535, and query 0
    # repeats one code of reference 0 70,000 times at 65535, so that cell
    # passes 2^32 (a uint32 accumulator would wrap)
    n_rep = 70_000
    w = rng.integers(1, 1 << 16, qry.size + n_rep).astype(np.uint32)
    w[qry.size:] = (1 << 16) - 1
    qry_k = np.concatenate([qry, np.full(n_rep, ref_codes[0, 0], np.uint32)])
    qid_k = np.concatenate([count.query_ids(qidx, qry.size), np.zeros(n_rep, np.int32)])
    qidx_k = qidx.copy()
    qidx_k[1:] += np.uint64(n_rep)  # host oracle: the repeats join query 0
    order = np.argsort(qid_k, kind="stable")
    qry_k, qid_k, w = qry_k[order], qid_k[order], w[order]
    qc_k = torch.from_numpy(qry_k.view(np.int32)).to(device)
    qq_k = torch.from_numpy(qid_k).to(device)
    qw_k = torch.from_numpy(w.view(np.int32)).to(device)
    seg_k = torch.from_numpy(qidx_k.astype(np.int64)).to(device)
    got_c, got_w = count.count_shared_koc_kernel(qc_k, qq_k, qw_k, index, SYNTH_QRYS, seg_k)
    want_c, want_w = count.count_shared_koc_torch(qc_k, qq_k, qw_k, index, SYNTH_QRYS)
    err = max(max_abs_err(got_c, want_c), max_abs_err(got_w, want_w))
    res["count_koc"]["err"] = err
    host_w = count.count_shared_weighted_np(
        qry_k, qidx_k, w, sp.uniq_codes, sp.offsets, sp.gids, SYNTH_QRYS, SYNTH_REFS
    )
    host_c = count.count_shared_np(qry_k, qidx_k, sp.uniq_codes, sp.offsets,
                                   sp.gids, SYNTH_QRYS, SYNTH_REFS)
    if (err or not np.array_equal(got_w.cpu().numpy().view(np.uint64), host_w)
            or not np.array_equal(got_c.cpu().numpy().view(np.uint32), host_c)
            or int(host_w[0, 0]) <= 1 << 32):
        raise AssertionError(f"count_koc kernel != plain/host: max_abs_err {err}, "
                             f"cell (0, 0) {int(host_w[0, 0])}")
    ms = cuda_ms(lambda: count.count_shared_koc_kernel(qc_k, qq_k, qw_k, index,
                                                       SYNTH_QRYS, seg_k))
    plain_ms = cuda_ms(
        lambda: count.count_shared_koc_torch(qc_k, qq_k, qw_k, index, SYNTH_QRYS)
    )
    log(f"[kernels] count_koc {SYNTH_QRYS} x {SYNTH_REFS} + {n_rep} repeats, "
        f"shared-row variant: {int(host_c.sum())} shared codes, weighted sum "
        f"{int(host_w.sum())}, cell (0, 0) {int(host_w[0, 0])} > 2^32; counts and "
        f"sums equal to plain and host; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    log("[kernels] count_koc: " + device_note(
        lambda: count.count_shared_koc_kernel(qc_k, qq_k, qw_k, index, SYNTH_QRYS, seg_k)))
    res["count_koc"].update(ms=ms, plain_ms=plain_ms,
                            bound=count_bound(qry_k, sp.uniq_codes, sp.offsets,
                                              pairs, True))
    phase_count64(device, res, sp, qry, qidx, host,
                  (qry_k, qid_k, w, qidx_k, host_c, host_w))

    # full 32-bit codes (CSZ=8 reaches them): unsigned order in the kernel
    sp32, _, q32 = synth_csr(300, 500, 40, SEED + 3, space=1 << 32)
    assert int(sp32.uniq_codes[-1]) >= 1 << 31
    i32 = count.DeviceIndex.from_sparse(sp32, device)
    qidx32 = np.arange(41, dtype=np.uint64) * 500
    qc32 = torch.from_numpy(q32.view(np.int32)).to(device)
    qq32 = torch.from_numpy(count.query_ids(qidx32, q32.size)).to(device)
    got = count.count_shared_kernel(qc32, qq32, i32, 40)
    err = max_abs_err(got, count.count_shared_torch(qc32, qq32, i32, 40))
    res["count"]["err"] = max(res["count"]["err"], err)
    host = count.count_shared_np(q32, qidx32, sp32.uniq_codes, sp32.offsets,
                                 sp32.gids, 40, 300)
    if err or not np.array_equal(got.cpu().numpy().view(np.uint32), host) or not host.sum():
        raise AssertionError(f"count kernel != plain/host on 32-bit codes: {err}")
    log(f"[kernels] count on 32-bit codes (40 x 300): {int(host.sum())} shared, "
        "equal to plain and host")

    # stage II's optional device sort (--device-index): unsigned 64-bit
    # keys through torch.sort's signed int64
    keys = rng.integers(0, 1 << 64, size=1 << 22, dtype=np.uint64)
    keys[:4] = [0, (1 << 63) - 1, 1 << 63, (1 << 64) - 1]
    if not np.array_equal(index_mod.sort_u64(keys, device), np.sort(keys)):
        raise AssertionError("device sort of uint64 keys != np.sort")
    log("[kernels] sign-safe device sort of 2^22 uint64 keys == np.sort")
    phase_join_kernel(device, work, res)
    return res, (ref_codes, qry)


# Bounds: the larger of the bytes a call must move over an H100's HBM
# rate (3.35 TB/s) and its operations over the card's peak rate. NVIDIA's
# data sheet gives no int32 rate; its float32 rate outside the tensor
# cores, 67 TFLOP/s with an FMA counted as two, is 33.5e12 lane operations
# a second, which stands in for the integer ALU (an optimistic bound: the
# int32 lanes are half as many).
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 33.5e12
# integer operations a Feistel window needs at least: rolling two 64-bit
# strands by one base (~14), the canonical minimum (4), the inner
# substring (2), three Feistel rounds and the high-half test (~23; the
# fourth round runs for ~1 window in 4,096), the keep bit (2)
OPS_PER_WINDOW = 45


def bound(n_bytes: float, n_ops: float = 0.0) -> tuple[float, str]:
    """(bound_ms, bound_by) of a call that moves n_bytes and does n_ops."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ALU_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def sketch_bound(n_words: int, n_windows: int, kept: int, p) -> tuple[float, str]:
    """Packed words read once, each kept (pos, code) written once; the
    window work of every window."""
    code_bytes = 8 if p.drtuple_bits > 31 else 4
    return bound(4 * n_words + kept * (8 + code_bytes), OPS_PER_WINDOW * n_windows)


def count_bound(codes: np.ndarray, uniq: np.ndarray, offsets: np.ndarray,
                n_cells: int, koc: bool) -> tuple[float, str]:
    """The bytes a count call must move with this run's data: the query
    codes, their ids (and weights) read once, one index key per code, the
    offsets and postings of the codes found, and the count matrix (and the
    koc sums) written once."""
    row = np.searchsorted(uniq, codes)
    found = row < uniq.size
    found[found] = uniq[row[found]] == codes[found]
    postings = int((offsets[row[found] + 1] - offsets[row[found]]).sum())
    per_code = 2 * codes.itemsize + 4 + (4 if koc else 0)
    return bound(codes.size * per_code + int(found.sum()) * 16 + postings * 4
                 + n_cells * (12 if koc else 4))


def join_bound(n_rows: int, key_bytes: int, n_q: int, hit_rows: int,
               hit_postings: int, n_keys: int, csr: bool) -> tuple[float, str]:
    """The bytes a join call must move with this run's data: every DB row's
    key and the query table (key, id, abundance) read once, the offsets
    (CSR) and genome ids of the rows that hit, and the hit keys written
    once."""
    return bound(n_rows * key_bytes + n_q * (key_bytes + 8)
                 + hit_rows * (16 if csr else 0) + hit_postings * 4 + n_keys * 8)


def kept_at_zero(k: int, s: int, l: int):
    """SketchParams at (k, s, l) whose Feistel space keeps the inner value
    0: the first .shuf id whose rank of 0 is below dim_end."""
    from public_kssd_tpu_torch import shufspace
    from public_kssd_tpu_torch.config import SketchParams

    zero = np.zeros(1, np.uint32)
    for seed in range(1 << 20):
        p = SketchParams(id=seed, half_ctx_len=k, half_subctx_len=s, drlevel=l)
        if int(shufspace.feistel(np, zero, seed, s)[0]) < p.dim_end:
            return p
    raise AssertionError("no .shuf id keeps the inner value 0")


def check_sketch(name: str, res: dict, words, n_valid: int, shuf, p, case,
                 timing: bool = True):
    """sketch_windows_kept on the card against its plain version on the
    same tensors: positions and codes equal element for element, in
    ascending position, none reaching past n_valid. Returns (kept, ms,
    plain_ms), or (positions, kept) without timing."""
    import torch

    from public_kssd_tpu_torch.ops import sketch

    pos, code = sketch.sketch_windows_kept(words, n_valid, shuf, p)
    want_pos, want_code = sketch.sketch_windows_kept_plain(words, n_valid, shuf, p)
    err = max(max_abs_err(pos, want_pos), max_abs_err(code, want_code))
    res[name]["err"] = max(res[name]["err"], err)
    kept = pos.numel()
    if (err or kept == 0 or code.dtype != sketch.dense_dtype(p)
            or bool((pos[1:] <= pos[:-1]).any())
            or int(pos[-1]) + p.TL > n_valid):
        raise AssertionError(f"{name} kernel != plain at {case}: max_abs_err "
                             f"{err}, kept {kept}, {code.dtype}")
    if not timing:
        return pos, kept
    ms = cuda_ms(lambda: sketch.sketch_windows_kept(words, n_valid, shuf, p))
    plain_ms = cuda_ms(
        lambda: sketch.sketch_windows_kept_plain(words, n_valid, shuf, p), 2
    )
    log(f"[kernels] {name} {case}: "
        + device_note(lambda: sketch.sketch_windows_kept(words, n_valid, shuf, p)))
    torch.cuda.synchronize()
    return kept, ms, plain_ms


def fold64(codes: np.ndarray, low: int) -> np.ndarray:
    """Codes below 2^28 -> uint64 keys code << 36 | low: ascending codes
    stay ascending, equal codes stay equal, and every code >= 2^27 gets
    a key >= 2^63 (an unsigned-compare fault shows there)."""
    return (codes.astype(np.uint64) << np.uint64(36)) | np.uint64(low)


def phase_count64(device, res: dict, sp, qry, qidx, host, koc) -> None:
    """count64 and count_koc64 vs their plain versions at the 1000 x 10k
    shape, every key moved to code << 36 | 5; the counts must also equal
    the 32-bit results of the same data (host: the numpy oracle)."""
    import torch

    from public_kssd_tpu_torch.ops import count

    uniq64 = fold64(sp.uniq_codes, 5)
    assert int(uniq64[0]) < 1 << 63 <= int(uniq64[-1])
    index = count.DeviceIndex.from_arrays(uniq64, sp.offsets, sp.gids,
                                          SYNTH_REFS, device)
    q64 = fold64(qry, 5)
    qc = torch.from_numpy(q64.view(np.int64)).to(device)
    qq = torch.from_numpy(count.query_ids(qidx, qry.size)).to(device)
    seg = torch.from_numpy(qidx.astype(np.int64)).to(device)
    got = count.count_shared_kernel(qc, qq, index, SYNTH_QRYS, seg)
    err = max_abs_err(got, count.count_shared_torch(qc, qq, index, SYNTH_QRYS))
    res["count64"]["err"] = err
    host64 = count.count_shared_np(q64, qidx, uniq64, sp.offsets, sp.gids,
                                   SYNTH_QRYS, SYNTH_REFS)
    got_np = got.cpu().numpy().view(np.uint32)
    if err or not np.array_equal(got_np, host64) or not np.array_equal(got_np, host):
        raise AssertionError(f"count64 kernel != plain/host: max_abs_err {err}")
    ms = cuda_ms(lambda: count.count_shared_kernel(qc, qq, index, SYNTH_QRYS, seg))
    plain_ms = cuda_ms(lambda: count.count_shared_torch(qc, qq, index, SYNTH_QRYS))
    log(f"[kernels] count64 {SYNTH_QRYS} x {SYNTH_REFS}, shared-row variant, keys "
        f"code << 36 | 5 ({int((q64 >= np.uint64(1 << 63)).sum())} query keys >= "
        f"2^63; directory shift {index.dir_shift}): equal to plain, to the uint64 "
        f"host oracle and to the 32-bit counts; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms")
    log("[kernels] count64: " + device_note(
        lambda: count.count_shared_kernel(qc, qq, index, SYNTH_QRYS, seg)))
    pairs = SYNTH_QRYS * SYNTH_REFS
    res["count64"].update(ms=ms, plain_ms=plain_ms,
                          bound=count_bound(q64, uniq64, sp.offsets, pairs, False))

    qry_k, qid_k, w, qidx_k, host_c, host_w = koc
    q64_k = fold64(qry_k, 5)
    qc_k = torch.from_numpy(q64_k.view(np.int64)).to(device)
    qq_k = torch.from_numpy(qid_k).to(device)
    qw_k = torch.from_numpy(w.view(np.int32)).to(device)
    seg_k = torch.from_numpy(qidx_k.astype(np.int64)).to(device)
    got_c, got_w = count.count_shared_koc_kernel(qc_k, qq_k, qw_k, index, SYNTH_QRYS)
    want_c, want_w = count.count_shared_koc_torch(qc_k, qq_k, qw_k, index, SYNTH_QRYS)
    err = max(max_abs_err(got_c, want_c), max_abs_err(got_w, want_w))
    res["count_koc64"]["err"] = err
    if (err or not np.array_equal(got_w.cpu().numpy().view(np.uint64), host_w)
            or not np.array_equal(got_c.cpu().numpy().view(np.uint32), host_c)):
        raise AssertionError(f"count_koc64 kernel != plain/host: max_abs_err {err}")
    ms = cuda_ms(lambda: count.count_shared_koc_kernel(qc_k, qq_k, qw_k, index,
                                                       SYNTH_QRYS, seg_k))
    plain_ms = cuda_ms(
        lambda: count.count_shared_koc_torch(qc_k, qq_k, qw_k, index, SYNTH_QRYS)
    )
    log(f"[kernels] count_koc64 {SYNTH_QRYS} x {SYNTH_REFS} + 70000 repeats, "
        f"shared-row variant, keys code << 36 | 5: counts and sums equal to plain "
        f"and to the 32-bit host oracle (cell (0, 0) {int(host_w[0, 0])}); kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
    log("[kernels] count_koc64: " + device_note(
        lambda: count.count_shared_koc_kernel(qc_k, qq_k, qw_k, index, SYNTH_QRYS,
                                              seg_k)))
    res["count_koc64"].update(ms=ms, plain_ms=plain_ms,
                              bound=count_bound(q64_k, uniq64, sp.offsets, pairs, True))


def phase_count_global(device, sp, qc: np.ndarray, qi: np.ndarray,
                       qa: np.ndarray) -> None:
    """The global-atomics variant of all four count instances, at the GTDB
    species-group shape (65,702 references: a row exceeds a block's shared
    memory) with the GTDB_SAMPLES koc samples as queries, against the
    plain versions and the host oracles; the 64-bit instances on keys
    code << 36 | 3."""
    import torch

    from public_kssd_tpu_torch.ops import count

    n_qry, n_ref = GTDB_SAMPLES, GTDB_REFS
    for koc in (False, True):
        if count.count_variant(n_ref, koc) != "global":
            raise AssertionError("the GTDB shape should take the global variant")
    w = qa.astype(np.uint32)
    host_c = count.count_shared_np(qc, qi, sp.uniq_codes, sp.offsets, sp.gids,
                                   n_qry, n_ref)
    host_w = count.count_shared_weighted_np(qc, qi, w, sp.uniq_codes, sp.offsets,
                                            sp.gids, n_qry, n_ref)
    qq = torch.from_numpy(count.query_ids(qi, qc.size)).to(device)
    qw = torch.from_numpy(w.view(np.int32)).to(device)
    times = []
    for wide in (False, True):
        if wide:
            index = count.DeviceIndex.from_arrays(fold64(sp.uniq_codes, 3),
                                                  sp.offsets, sp.gids, n_ref, device)
            q = torch.from_numpy(fold64(qc, 3).view(np.int64)).to(device)
        else:
            index = count.DeviceIndex.from_sparse(sp, device)
            q = torch.from_numpy(qc.view(np.int32)).to(device)
        c = count.count_shared_kernel(q, qq, index, n_qry)
        kc, kw = count.count_shared_koc_kernel(q, qq, qw, index, n_qry)
        err = max(max_abs_err(c, count.count_shared_torch(q, qq, index, n_qry)),
                  *(max_abs_err(a, b) for a, b in zip(
                      (kc, kw), count.count_shared_koc_torch(q, qq, qw, index, n_qry))))
        for t, want in ((c, host_c), (kc, host_c), (kw, host_w)):
            if err or not np.array_equal(t.cpu().numpy().view(want.dtype), want):
                raise AssertionError(f"count global variant (64-bit keys: {wide}) "
                                     f"!= plain/host: max_abs_err {err}")
        times.append(cuda_ms(lambda: count.count_shared_kernel(q, qq, index, n_qry)))
        times.append(cuda_ms(lambda: count.count_shared_koc_kernel(q, qq, qw, index,
                                                                   n_qry)))
        log(f"[kernels] count{'64' if wide else ''}, global variant: " + device_note(
            lambda: count.count_shared_kernel(q, qq, index, n_qry)))
    log(f"[kernels] count, count_koc, count64, count_koc64, global-atomics variant "
        f"at {n_qry} x {n_ref} ({qc.size} query codes, {int(host_c.sum())} shared): "
        f"equal to plain and host; kernels {', '.join(f'{t:.4f}' for t in times)} ms")


def phase_join_kernel(device, work: str, res: dict) -> None:
    """join (CSR and raw routes) and join64 against their plain version,
    element for element, on (a) the GTDB-shaped database and its samples;
    (b) the same with one hot code that every reference and every sample
    holds (65,702 x 8 keys from one CSR row); (c) chunk tails: 1,000,003
    rows, 7 rows with the directory built by the wrapper, and a table
    none of whose codes a DB row holds; (d) join64 on every case with
    keys code << 36 | 7 (half of them >= 2^63), equal to the raw route's
    keys. Times, device splits and bounds at (a)."""
    from public_kssd_tpu_torch import composite, formats
    from public_kssd_tpu_torch import index as index_mod

    t0 = time.perf_counter()
    ref_dir, qry_dir = build_gtdb(f"{work}/gtdb")
    codes, ridx = formats.read_combco(ref_dir, 0)
    sp = index_mod.build_component_index(codes, ridx, GTDB_REFS)
    qc, qi, qa = formats.read_combco(qry_dir, 0, with_abund=True)
    sq, sqid, sab, n_q = composite._query_table(qc, qi, qa, GTDB_SAMPLES)
    table = (sq[:n_q], sqid[:n_q], sab[:n_q])
    log(f"[kernels] GTDB-shaped DB: {GTDB_REFS} refs x {GTDB_SKETCH} codes "
        f"({sp.uniq_codes.size} unique), {GTDB_SAMPLES} samples x "
        f"{GTDB_SAMPLE_CODES} codes ({n_q} table entries) "
        f"({time.perf_counter() - t0:.1f} s host)")
    phase_count_global(device, sp, qc, qi, qa)
    rid = np.searchsorted(ridx[1:], np.arange(codes.size, dtype=np.uint64),
                          "right").astype(np.int32)
    csr = (sp.uniq_codes, sp.offsets.astype(np.int64), sp.gids.astype(np.int32))

    inst, n_keys = join_case(device, res, "(a) GTDB shape", table, (codes, rid), csr)
    if n_keys["csr"] != n_keys["raw"] or not n_keys["raw"]:
        raise AssertionError(f"join routes disagree on the hit count: {n_keys}")
    hit = np.isin(sp.uniq_codes, table[0])
    postings = int(np.diff(csr[1])[hit].sum())
    raw_hit = np.isin(codes, table[0])
    hit_rows = int(raw_hit.sum())
    bounds = {
        "csr": join_bound(hit.size, 4, n_q, int(hit.sum()), postings, n_keys["csr"], True),
        "raw": join_bound(codes.size, 4, n_q, hit_rows, hit_rows, n_keys["raw"], False),
        "join64": join_bound(codes.size, 8, n_q, hit_rows, hit_rows, n_keys["join64"],
                             False),
    }
    times = {}
    for route, args in inst.items():
        times[route] = (cuda_ms(lambda: composite.join_kernel(*args)),
                        cuda_ms(lambda: composite.join_torch(*args[:7])))
        log(f"[kernels] join (a), {route}: kernel {times[route][0]:.4f} ms, plain "
            f"{times[route][1]:.4f} ms, bound {bounds[route][0]:.4f} ms "
            f"({bounds[route][1]}); " + device_note(
                lambda: composite.join_kernel(*args)))
    res["join"].update(ms=times["csr"][0], plain_ms=times["csr"][1],
                       bound=bounds["csr"], extra={
                           "ms_raw": times["raw"][0],
                           "plain_ms_raw": times["raw"][1],
                           "bound_raw_ms": bounds["raw"][0],
                           "bound_raw_by": bounds["raw"][1]})
    res["join64"].update(ms=times["join64"][0], plain_ms=times["join64"][1],
                         bound=bounds["join64"])
    del inst

    # (b) a hot code, held by every reference and every sample: one CSR
    # row with 65,702 postings x 8 table entries; on the raw route 65,702
    # rows at the end of the DB
    cand = np.arange(1 << 27, (1 << 27) + 4096, dtype=np.uint32)
    h = np.setdiff1d(cand, np.union1d(sp.uniq_codes, table[0]))[0]
    at, q_at = np.searchsorted(sp.uniq_codes, h), np.searchsorted(table[0], h)
    refs = np.arange(GTDB_REFS, dtype=np.int32)
    plen = np.insert(np.diff(csr[1]), at, GTDB_REFS)
    hot_csr = (np.insert(csr[0], at, h),
               np.concatenate([[0], np.cumsum(plen)]).astype(np.int64),
               np.insert(csr[2], csr[1][at], refs))
    samples = np.arange(GTDB_SAMPLES)
    hot_table = (np.insert(table[0], q_at, np.full(GTDB_SAMPLES, h, np.uint32)),
                 np.insert(table[1], q_at, samples.astype(np.int32)),
                 np.insert(table[2], q_at, (samples + 1).astype(np.uint32)))
    hot_raw = (np.concatenate([codes, np.full(GTDB_REFS, h, np.uint32)]),
               np.concatenate([rid, refs]))
    _, hot_keys = join_case(device, res, "(b) one hot code", hot_table, hot_raw,
                            hot_csr)
    want = {r: n + GTDB_REFS * GTDB_SAMPLES for r, n in n_keys.items()}
    if hot_keys != want:
        raise AssertionError(f"hot code: {hot_keys} keys, expected {want}")

    # (c) chunk tails, the wrapper's own directory, and no hits at all
    n = 1_000_003
    join_case(device, res, f"(c) {n} rows", table, (codes[:n], rid[:n]),
              (csr[0][:n], csr[1][: n + 1], csr[2]))
    r0, c0 = int(np.argmax(raw_hit)), int(np.argmax(hit))  # first hit rows
    _, few = join_case(device, res, "(c) 7 rows from the first hit, directory "
                       "built by the wrapper", table,
                       (codes[r0: r0 + 7], rid[r0: r0 + 7]),
                       (csr[0][c0: c0 + 7], csr[1][c0: c0 + 8], csr[2]),
                       directory=False)
    if not all(few.values()):
        raise AssertionError(f"7 rows from the first hit: {few} keys")
    miss = ~np.isin(table[0], codes)
    _, none = join_case(device, res, "(c) a table no DB row matches",
                        tuple(a[miss] for a in table), (codes, rid), csr)
    if any(none.values()):
        raise AssertionError(f"join on a table no row matches: {none} keys")


def join_case(device, res: dict, case: str, table, raw, csr, directory=True):
    """The three join instances on one case, each against join_torch on
    the same tensors, element for element: the CSR route over ``csr``
    (uniq, absolute offsets, gids) and the raw route over ``raw`` (codes,
    genome ids) with the uint32 query ``table`` (codes, ids, abundances),
    and join64 over the raw rows and the table folded to code << 36 | 7,
    whose keys must equal the raw route's. ``directory``: pass each
    table's query_directory, as the main path does, or let the wrapper
    build it. Returns ({instance: args}, {instance: keys})."""
    import torch

    from public_kssd_tpu_torch import composite

    def dev(a, view):
        return torch.from_numpy(np.ascontiguousarray(a).view(view)).to(device)

    tq = [dev(a.astype(np.uint32), np.int32) for a in table]
    sq64 = fold64(table[0], 7)
    tq64 = dev(sq64, np.int64)
    d32 = d64 = None
    if directory:
        d32 = composite.query_directory(tq[0], int(table[0][-1]) if table[0].size else 0)
        d64 = composite.query_directory(tq64, int(sq64[-1]) if sq64.size else 0)
    shift = 16 + GTDB_REFS.bit_length()
    g = dev(raw[1], np.int32)
    inst = {
        "csr": (dev(csr[0], np.int32), dev(csr[1], np.int64), dev(csr[2], np.int32),
                *tq, shift, d32),
        "raw": (dev(raw[0], np.int32), None, g, *tq, shift, d32),
        "join64": (dev(fold64(raw[0], 7), np.int64), None, g, tq64, *tq[1:], shift,
                   d64),
    }
    keys = {}
    for route, args in inst.items():
        name = "join64" if route == "join64" else "join"
        got = composite.join_kernel(*args)
        err = max_abs_err(got, composite.join_torch(*args[:7]))
        res[name]["err"] = max(res[name]["err"], err)
        if err or (got.numel() and int(got.min()) < 0):
            raise AssertionError(f"{name} kernel != plain at {case}, {route} route: "
                                 f"max_abs_err {err}, {got.numel()} keys")
        keys[route] = got
    if not torch.equal(keys["join64"], keys["raw"]):
        raise AssertionError(f"join64 keys != the 32-bit raw route's at {case}")
    counts = {r: k.numel() for r, k in keys.items()}
    log(f"[kernels] join {case}: {raw[0].size} raw rows, {csr[0].size} CSR rows, "
        f"{table[0].size} table entries; keys {counts}, each instance equal to "
        "plain element for element, join64 to the raw route")
    return inst, counts


def phase_sketch_heavy(work: str) -> None:
    from public_kssd_tpu_torch import kernels

    t0 = time.perf_counter()
    ref_dir, qry_dir, source = make_genomes(work, N_REF_GENOMES, N_QRY_GENOMES, SEED)
    log(f"[sketch-heavy] wrote {N_REF_GENOMES} + {N_QRY_GENOMES} genomes of "
        f"{GENOME_BP} bp in {time.perf_counter() - t0:.1f} s")
    shuf = f"{work}/L3K10"
    run_cli("shuffle", "-k", "10", "-s", "6", "-l", "3", "--seed", "3", "-o", shuf)
    check_detect(shuf + ".shuf")
    t_ref = run_cli("dist", "-r", ref_dir, "-L", shuf + ".shuf", "-o",
                    f"{work}/ref", "--no-dense-index")
    t_qry = run_cli("dist", "-L", shuf + ".shuf", "-o", f"{work}/qry", qry_dir)
    t_search = run_cli("dist", "-r", f"{work}/ref", "-o", f"{work}/out",
                       "--keepskf", f"{work}/qry")
    run_cli("dist", "-r", f"{work}/ref", "-o", f"{work}/out_cpu", "--cpu-count",
            f"{work}/qry")
    size = same_bytes(f"{work}/out/distance.out", f"{work}/out_cpu/distance.out")
    with open(f"{work}/out/distance.out") as f:
        n_lines = sum(1 for _ in f)
    if n_lines != 1 + N_QRY_GENOMES * N_REF_GENOMES:
        raise AssertionError(f"distance.out has {n_lines} lines")
    shared = np.fromfile(f"{work}/out/sharedk_ct.dat", "<u4").reshape(
        N_QRY_GENOMES, N_REF_GENOMES
    )
    if list(shared.argmax(axis=1)) != source or shared.max(axis=1).min() == 0:
        raise AssertionError("a query does not match its source reference best")
    for k in (kernels.sketch_kernel, kernels.count_kernel):
        if k.launches == 0:
            raise AssertionError(f"{k.name} kernel was not launched by the main path")
    check_fresh_cli(work, ref_dir, qry_dir, shuf + ".shuf")
    mb = GENOME_BP / 1e6
    log(f"[sketch-heavy] distance.out {n_lines} lines, {size} B, byte-equal to "
        f"--cpu-count; shared codes with own ref: {shared.max(axis=1).tolist()}")
    log(f"[sketch-heavy] stage I+II refs: {N_REF_GENOMES / t_ref:.3f} genomes/s, "
        f"{N_REF_GENOMES * mb / t_ref:.2f} Mbases/s ({t_ref:.3f} s); stage I "
        f"queries: {N_QRY_GENOMES / t_qry:.3f} genomes/s, "
        f"{N_QRY_GENOMES * mb / t_qry:.2f} Mbases/s ({t_qry:.3f} s); search "
        f"{N_QRY_GENOMES * N_REF_GENOMES / t_search:.1f} pairs/s ({t_search:.3f} s)")
    check_gzip_refs(work, ref_dir, shuf + ".shuf")
    shutil.rmtree(qry_dir)  # the references feed phase 7's reads


# the pieces of a fresh process's start that phase 4 logs, in order
FRESH_PIECES = ("interpreter", "import_torch", "port_imports", "resolve_device",
                "start.thread", "start.cuinit", "start.context", "start.join",
                "staging", "library sketch", "library count", "shuf_read", "detect",
                "first_genome", "stat_read", "stages_sum", "exit", "exit.return",
                "exit.close_out", "exit.threads", "exit.atexit", "exit.finalize",
                "exit.teardown")
# a command's code and stderr in the two routes that must end alike: the
# CLI's entry, and main's code handed to the interpreter's exit
ENTRY = ["-m", "public_kssd_tpu_torch.cli"]
OLD_ROUTE = ["-c", "import sys; from public_kssd_tpu_torch.cli import main; "
             "sys.exit(main(sys.argv[1:]))"]


def stderr_key(text: str) -> list[str]:
    """``text`` (a process's stderr) less the traceback's frames above
    ``main``, where the entry's route and the old route differ."""
    lines = text.splitlines()
    if "Traceback (most recent call last):" not in lines:
        return lines
    head = lines.index("Traceback (most recent call last):")
    frames = next((i for i in range(head, len(lines)) if lines[i].endswith(", in main")),
                  head + 1)
    return lines[:head + 1] + lines[frames:]


def check_fresh_cli(work: str, ref_dir: str, qry_dir: str, shuf: str) -> None:
    """Phase 4's three commands as a user runs them: each in its own fresh
    process through ``python3 -m public_kssd_tpu_torch.cli``, the outputs
    byte-equal to the same commands run in this process (``work``/ref,
    qry, out); then each again through ``tools/fresh_start.py``'s probed
    child, outputs byte-equal too. Logs each process's wall and the
    probed run's split of its start and its exit. Then a failing search
    (the query sketches under another ``.shuf``'s id: ``ShufIdMismatch``)
    through the entry and through the old route (``main``'s code to the
    interpreter's exit): the same non-zero code and stderr."""
    from tools import fresh_start

    def commands(tag: str) -> dict[str, list[str]]:
        return {
            "ref": ["dist", "-r", ref_dir, "-L", shuf, "-o", f"{work}/{tag}_ref",
                    "--no-dense-index"],
            "qry": ["dist", "-L", shuf, "-o", f"{work}/{tag}_qry", qry_dir],
            "out": ["dist", "-r", f"{work}/f_ref", "-o", f"{work}/{tag}_out",
                    "--keepskf", f"{work}/f_qry"],
        }

    def same_dirs(mine: str, tag: str) -> int:
        names = sorted(os.listdir(f"{work}/{tag}"))
        if names != sorted(os.listdir(mine)):
            raise AssertionError(f"{mine} holds {sorted(os.listdir(mine))}, not {names}")
        return sum(same_bytes(f"{work}/{tag}/{n}", f"{mine}/{n}") for n in names)

    env = dict(os.environ, PYTHONPATH=ROOT)
    for tag, argv in commands("f").items():
        t = time.perf_counter()
        r = subprocess.run([sys.executable, *ENTRY, *argv], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t
        if r.returncode != 0:
            raise RuntimeError(f"kssd_torch {' '.join(argv)} exited {r.returncode}: "
                               f"{r.stderr[-2000:]}")
        size = same_dirs(f"{work}/f_{tag}", tag)
        probed = commands("p")[tag]
        run = fresh_start.fresh_runs(probed, 1)[0]
        same_dirs(f"{work}/p_{tag}", tag)
        shutil.rmtree(f"{work}/p_{tag}")
        split = ", ".join(f"{k} {run['pieces'][k]:.3f}" for k in FRESH_PIECES
                          if run["pieces"].get(k) is not None)
        at = {k: round(v, 3) for k, v in run["at"].items()
              if k not in ("stages",) and v is not None}
        log(f"[fresh] {' '.join(argv[:2])} ... ({tag}): a fresh process (python3 -m "
            f"public_kssd_tpu_torch.cli) {wall:.3f} s, outputs {size} B byte-equal to "
            f"the in-process run; probed {run['wall_s']:.3f} s (ended by "
            f"{run['exit']['end']}): {split} s; events "
            f"(s from the spawn) {at}; peak RSS {run['max_rss_mb']:.0f} MiB")
    # the query sketches under another .shuf's id (no sketch launched)
    from public_kssd_tpu_torch import formats

    shutil.copytree(f"{work}/qry", f"{work}/x_qry")
    stat = formats.read_co_stat(f"{work}/x_qry")
    formats.write_co_stat(f"{work}/x_qry", dataclasses.replace(
        stat, params_id=stat.params_id ^ 1))
    bad = ["dist", "-r", f"{work}/f_ref", "-o", f"{work}/x_out", f"{work}/x_qry"]
    ends = []
    for route in (ENTRY, OLD_ROUTE):
        r = subprocess.run([sys.executable, *route, *bad], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=300)
        ends.append((r.returncode, stderr_key(r.stderr)))
    if ends[0] != ends[1] or ends[0][0] == 0 or "ShufIdMismatch" not in ends[0][1][-1]:
        raise AssertionError(f"a failing search ended {ends[0]} through the entry, "
                             f"{ends[1]} through main")
    log(f"[fresh] a failing search (a query of another .shuf) through the entry: "
        f"exit code {ends[0][0]}, '{ends[0][1][-1]}', as through main's code")
    shutil.rmtree(f"{work}/x_qry")
    shutil.rmtree(f"{work}/x_out", ignore_errors=True)
    for tag in ("ref", "qry", "out"):
        shutil.rmtree(f"{work}/f_{tag}")


def check_gzip_refs(work: str, ref_dir: str, shuf: str) -> None:
    """Phase 4's references as gzip files, sketched through the CLI: the
    combco files byte-equal to the plain FASTA run's (``work/ref``). The
    first is bgzip-style, a member for each 64 KB and an empty member
    at the end; the others are one member each. Every file must inflate
    on the port's own inflater (``seqio.inflate_route()`` "kssd": the
    helper built here), not through the gzip module behind it, to its
    FASTA's bytes and to the library route's (``seqio._KSSD = False``:
    libdeflate, else the system zlib). Logs the routes, one
    thread's inflate of the files on each, and the parse pool's seconds
    over them (``parsed_streams`` alone, its default workers). Then
    ``check_scan``."""
    import gzip

    from public_kssd_tpu_torch import infiles, pipeline, seqio

    gz_dir, out = f"{work}/refs_gz", f"{work}/ref_gz"
    os.makedirs(gz_dir)
    names = sorted(os.listdir(ref_dir))

    def put(i: int) -> None:
        with open(f"{ref_dir}/{names[i]}", "rb") as f:
            body = f.read()
        if i == 0:
            data = b"".join(gzip.compress(body[j : j + 65280], 6)
                            for j in range(0, len(body), 65280)) + gzip.compress(b"")
        else:
            data = gzip.compress(body, 1)
        with open(f"{gz_dir}/{names[i]}.gz", "wb") as f:
            f.write(data)

    with ThreadPoolExecutor(8) as ex:
        list(ex.map(put, range(len(names))))
    route = seqio.inflate_route()
    if route != "kssd":
        raise AssertionError(f"gzip is inflated on the {route} route, not the port's")
    took = {route: 0.0}
    for name in names:
        with open(f"{gz_dir}/{name}.gz", "rb") as f:
            data = f.read()
        t = time.perf_counter()
        own = seqio.inflate(data)
        took[route] += time.perf_counter() - t
        if own is None:
            raise AssertionError(f"the port's inflater refused {name}.gz")
        with open(f"{ref_dir}/{name}", "rb") as f:
            if own.tobytes() != f.read():
                raise AssertionError(f"{name}.gz inflated to other bytes than its FASTA")
        seqio._KSSD = False
        try:
            lib_route = seqio.inflate_route()
            t = time.perf_counter()
            other = seqio.inflate(data)
            took[lib_route] = took.get(lib_route, 0.0) + time.perf_counter() - t
        finally:
            seqio._KSSD = True
        if other is None or not np.array_equal(own, other):
            raise AssertionError(f"{name}.gz: the {lib_route} route refused it or differs")
    t_dist = run_cli("dist", "-r", gz_dir, "-L", shuf, "-o", out, "--no-dense-index")
    combco = sorted(n for n in os.listdir(f"{work}/ref") if n.startswith("combco"))
    if not combco or combco != sorted(n for n in os.listdir(out) if n.startswith("combco")):
        raise AssertionError(f"combco files {combco} vs {os.listdir(out)}")
    size = sum(same_bytes(f"{work}/ref/{n}", f"{out}/{n}") for n in combco)
    files = infiles.organize_infiles([gz_dir])
    pool = []
    for _ in range(3):
        t = time.perf_counter()
        for _item in pipeline.parsed_streams(files, pipeline.SketchOptions()):
            pass
        pool.append(time.perf_counter() - t)
    log(f"[sketch-heavy] gzip references ({names[0]} in "
        f"{-(-os.path.getsize(f'{ref_dir}/{names[0]}') // 65280) + 1} members): "
        f"{len(combco)} combco files, {size} B, byte-equal to the FASTA run's; "
        f"dist -r {t_dist:.3f} s; inflater {route}, every file inflated to its "
        f"FASTA's bytes and to the {lib_route} route's; one thread's inflate of the "
        f"{len(names)} files: "
        + ", ".join(f"{k} {v * 1e3 / len(names):.3f} ms" for k, v in took.items())
        + f" a file; parse pool over {len(files)} files "
        f"{', '.join(f'{t:.3f}' for t in pool)} s")
    shutil.rmtree(gz_dir)
    shutil.rmtree(out)
    check_scan(ref_dir, names)


def check_scan(ref_dir: str, names: list[str]) -> None:
    """Each reference's FASTA scanned in place by the port's scanner
    (native/kssd_scan.c's kssd_fasta_scan, which read_codes takes) and
    by the reference scanner (kssd_host.c's kssd_fasta_to_codes), each
    on its own copy: the same symbols and count, else it raises. Logs one
    thread's ms a file for each and the width of the loop this CPU
    takes."""
    from public_kssd_tpu_torch import native

    lib = native.get_lib()
    if lib is None:
        raise AssertionError("the native helper did not build")
    scanners = {"kssd_fasta_scan": lib.kssd_fasta_scan,
                "kssd_fasta_to_codes": lib.kssd_fasta_to_codes}
    took = dict.fromkeys(scanners, 0.0)
    probe = np.zeros(1, np.uint8)
    width = 32 if lib.kssd_fasta_scan_at(probe, 0, probe, 32) != ctypes.c_size_t(-1).value else 16
    for name in names:
        raw = np.fromfile(f"{ref_dir}/{name}", np.uint8)
        got = []
        for scanner, f in scanners.items():
            buf = raw.copy()
            t = time.perf_counter()
            n = f(buf, buf.size, buf)
            took[scanner] += time.perf_counter() - t
            got.append(buf[:n])
        if not np.array_equal(*got):
            raise AssertionError(f"{name}: kssd_fasta_scan's symbols differ from "
                                 f"kssd_fasta_to_codes' ({got[0].size} vs {got[1].size})")
    log(f"[sketch-heavy] FASTA scan of the {len(names)} references in place, one thread, "
        f"the {width}-byte loop: "
        + ", ".join(f"{k} {v * 1e3 / len(names):.3f} ms" for k, v in took.items())
        + " a file; the same symbols")


def check_detect(path: str) -> None:
    """shufspace.detect on the card (the whole 16^s table compared there)
    against its numpy comparison, on the .shuf at ``path`` (a Feistel
    space: shuffle writes one) and on a copy with two entries swapped at
    indices the spot-check does not probe."""
    import torch

    from public_kssd_tpu_torch import formats, shufspace

    params, table = formats.read_shuf(path)
    swapped = table.copy()
    swapped[[1, 2]] = swapped[[2, 1]]
    card = torch.device("cuda", torch.cuda.current_device())
    shufspace.detect(params, table, card)  # warm-up: the card's first ops
    times = []
    for name, tab, feistel in (("the run's .shuf", table, True),
                               ("two entries swapped", swapped, False)):
        t = time.perf_counter()
        got = shufspace.detect(params, tab, card)
        t_card = time.perf_counter() - t
        t = time.perf_counter()
        want = shufspace.detect(params, tab)
        t_host = time.perf_counter() - t
        if got != want or (want is not None) != feistel:
            raise AssertionError(f"detect of {name}: card {got}, numpy {want}")
        times.append(f"{name}: card {t_card * 1e3:.3f} ms, numpy {t_host * 1e3:.3f} ms")
    log(f"[sketch-heavy] shufspace.detect of {params.dim_shuf_len} entries "
        f"(host wall, upload included), the same verdict on the card and in "
        f"numpy; " + "; ".join(times))


def check_field_writers(smi: str) -> None:
    """native/kssd_print.c's %.6lf and %E field writers against this
    host's snprintf on FIELD_VALUES seeded doubles and the corner list,
    in chunks over every usable CPU; raises on any difference."""
    from public_kssd_tpu_torch import native
    from public_kssd_tpu_torch.ops import stats as stats_ops

    if native.get_lib() is None:  # built once, before the threads share it
        raise AssertionError("the native host library did not build")
    values = native.field_values(FIELD_VALUES, SEED)
    threads = stats_ops.print_threads(0)
    chunks = np.array_split(values, 4 * threads)
    starts = np.cumsum([0] + [c.size for c in chunks[:-1]])
    with ThreadPoolExecutor(threads) as pool:
        for fmt in native.FIELD_KINDS:
            t = time.perf_counter()
            res = list(pool.map(lambda c: native.check_fields(c, fmt), chunks))
            bad = [int(i + b) for (b, _), i in zip(res, starts) if b >= 0]
            if bad:
                x = float(values[bad[0]])
                raise AssertionError(f"{fmt} of {x!r}: native "
                                     f"{native.format_field(x, fmt)[0]!r} differs "
                                     f"from snprintf (Python's: {fmt % x!r})")
            slow = sum(n for _, n in res)
            log(f"[search-heavy] field writer {fmt}: {values.size} doubles equal to "
                f"snprintf's text ({time.perf_counter() - t:.2f} s on {threads} "
                f"threads, snprintf included); {slow} ({slow / values.size:.4%}) "
                f"went through snprintf; {smi}")


def compare_index_loads(sref: str, smi: str, tag: str) -> None:
    """A database loaded onto the card both ways, host, device, device,
    host: ``DeviceIndex.from_sparse`` of ``load_sparse_index``'s host
    arrays and ``index.load_device_index`` (the files read into pinned
    staging and uploaded as they are read). Every tensor, the directory's
    shift and n_ref must be equal."""
    import torch

    from public_kssd_tpu_torch import index
    from public_kssd_tpu_torch.ops import count

    dev = torch.device("cuda", 0)
    walls: dict[str, list[float]] = {"host": [], "device": []}
    loaded = {}
    for route in ("host", "device", "device", "host"):
        loaded.pop(route, None)
        torch.cuda.synchronize()
        t = time.perf_counter()
        if route == "host":
            _, comps = index.load_sparse_index(sref)
            comps = [count.DeviceIndex.from_sparse(sp, dev) for sp in comps]
        else:
            _, comps = index.load_device_index(sref, dev)
        torch.cuda.synchronize()
        walls[route].append(round(time.perf_counter() - t, 4))
        loaded[route] = comps
    for c, (a, b) in enumerate(zip(loaded["host"], loaded["device"], strict=True)):
        for f in ("uniq", "offsets", "gids", "dir"):
            ta, tb = getattr(a, f), getattr(b, f)
            if ta.dtype != tb.dtype or ta.device != tb.device or not torch.equal(ta, tb):
                raise AssertionError(f"component {c}: {f} differs between the "
                                     "host route and load_device_index")
        if (a.dir_shift, a.n_ref) != (b.dir_shift, b.n_ref):
            raise AssertionError(f"component {c}: directory shift or n_ref differs")
    nbytes = sum(t.numel() * t.element_size() for comp in loaded["device"]
                 for t in (comp.uniq, comp.offsets, comp.gids))
    log(f"[{tag}] index load of {len(loaded['device'])} components, {nbytes} B, "
        f"onto the card, every tensor equal: host route (np.fromfile, from_sparse) {walls['host']} s, "
        f"load_device_index {walls['device']} s ({index.INDEX_READ_THREADS} "
        f"read threads, {index.INDEX_BLOCK} B buffers); {smi}")


def phase_search_heavy(work: str, synth, smi: str) -> None:
    import torch

    from bench_torch import run as bench
    from public_kssd_tpu_torch.ops import stats as stats_ops
    from tools.stage1_spans import HostClock

    check_field_writers(smi)
    ref_codes, qry = synth
    qry_rows = qry.reshape(SYNTH_QRYS, SYNTH_SKETCH)
    sref, sqry, t_index = bench.search_dirs(work, ref_codes, qry_rows, "cuda")
    # the search's spans on the host clock (tools/print_spans.py --clock)
    clock = HostClock()
    real_span = torch.profiler.record_function
    torch.profiler.record_function = clock
    try:
        t_search, stages = bench.run_cli("dist", "-r", sref, "-o", f"{work}/sout", sqry)
    finally:
        torch.profiler.record_function = real_span
    if os.path.exists(f"{work}/sout/sharedk_ct.dat"):
        raise AssertionError("a search without --keepskf or -m wrote sharedk_ct.dat")
    t_cpu = run_cli("dist", "-r", sref, "-o", f"{work}/sout_cpu", "--cpu-count", sqry)
    size = same_bytes(f"{work}/sout/distance.out", f"{work}/sout_cpu/distance.out")
    t_one, one = bench.run_cli("dist", "-r", sref, "-o", f"{work}/sout_p1", "-p", "1",
                               sqry)
    same_bytes(f"{work}/sout/distance.out", f"{work}/sout_p1/distance.out")
    t = time.perf_counter()
    bad = bench.check_search(f"{work}/sout/distance.out", ref_codes, qry_rows, SEED)
    if bad:
        raise AssertionError(f"distance.out differs from the plain search: {bad}")
    pairs = SYNTH_QRYS * SYNTH_REFS
    log(f"[search-heavy] {SYNTH_QRYS} x {SYNTH_REFS}: distance.out {size} B "
        f"byte-equal to --cpu-count and to -p 1, and to the plain count and "
        f"formula (bench_torch/oracle.py, {time.perf_counter() - t:.1f} s); index "
        f"{t_index:.3f} s; search {pairs / t_search:.1f} pairs/s ({t_search:.3f} s, "
        f"CLI wall incl. index load and distance.out print); --cpu-count "
        f"{t_cpu:.3f} s; {smi}")
    spans = {k: round(v, 6) for k, v in clock.self_s.items()
             if k.startswith(("count", "index.", "load_index"))}
    log(f"[search-heavy] count stage {stages['count']:.3f} s (load_index "
        f"{stages['load_index']:.3f} s); the spans' self seconds on the host "
        f"clock: {spans}; {smi}")
    compare_index_loads(sref, smi, "search-heavy")
    log(f"[search-heavy] print stage {stages['print']:.3f} s on "
        f"{stats_ops.print_threads(0)} threads (dist -p default: the CPUs of "
        f"sched_getaffinity; os.cpu_count() {os.cpu_count()}); with -p 1: print "
        f"{one['print']:.3f} s, wall {t_one:.3f} s; {smi}")


def phase_wide(work: str, smi: str) -> dict[str, float]:
    """Returns the search's stage times; keeps ref/, qry/ and out/ under
    work/wide for phase 8b."""
    from public_kssd_tpu_torch import formats, utils

    root = f"{work}/wide"
    t0 = time.perf_counter()
    ref_dir, qry_dir, source = make_genomes(root, N_WIDE_REFS, N_WIDE_QRYS, SEED + 4)
    log(f"[wide] wrote {N_WIDE_REFS} + {N_WIDE_QRYS} genomes of {GENOME_BP} bp "
        f"in {time.perf_counter() - t0:.1f} s")
    two = f"{root}/two"  # two queries, sketched on the card and on the CPU
    os.makedirs(two)
    for name in sorted(os.listdir(qry_dir))[:2]:
        shutil.copy(f"{qry_dir}/{name}", two)
    shuf = f"{root}/L3K12.shuf"
    stages = StageLog()
    utils.log.addHandler(stages)
    try:
        run_cli("shuffle", "-k", "12", "-s", "6", "-l", "3", "--seed", "3",
                "-o", f"{root}/L3K12")
        t_ref = run_cli("dist", "-r", ref_dir, "-L", shuf, "-o", f"{root}/ref",
                        "--no-dense-index")
        stage1 = stages.stages["stage I"]
        t_qry = run_cli("dist", "-L", shuf, "-o", f"{root}/qry", qry_dir)
        t_search = run_cli("dist", "-r", f"{root}/ref", "-o", f"{root}/out",
                           "--keepskf", f"{root}/qry")
        search_stages = stages.stages["search"]
        t_cpu = run_cli("dist", "-r", f"{root}/ref", "-o", f"{root}/out_cpu",
                        "--cpu-count", f"{root}/qry")
        run_cli("dist", "-L", shuf, "-o", f"{root}/two_cuda", two)
        run_cli("dist", "-L", shuf, "-o", f"{root}/two_cpu", "--device", "cpu", two)
    finally:
        utils.log.removeHandler(stages)

    stat = formats.read_co_stat(f"{root}/ref")
    comps = stat.comp_num
    if comps != 256 or not os.path.isfile(f"{root}/ref/combco.{comps - 1}"):
        raise AssertionError(f"L3K12 wrote {comps} components, not 256")
    size = same_bytes(f"{root}/out/distance.out", f"{root}/out_cpu/distance.out")
    with open(f"{root}/out/distance.out") as f:
        n_lines = sum(1 for _ in f)
    if n_lines != 1 + N_WIDE_QRYS * N_WIDE_REFS:
        raise AssertionError(f"distance.out has {n_lines} lines")
    shared = np.fromfile(f"{root}/out/sharedk_ct.dat", "<u4").reshape(
        N_WIDE_QRYS, N_WIDE_REFS
    )
    if list(shared.argmax(axis=1)) != source or shared.max(axis=1).min() == 0:
        raise AssertionError("a query does not match its source reference best")
    two_bytes = same_bytes(f"{root}/two_cuda/cofiles.stat", f"{root}/two_cpu/cofiles.stat")
    for c in range(comps):
        for f in (f"combco.{c}", f"combco.index.{c}"):
            two_bytes += same_bytes(f"{root}/two_cuda/{f}", f"{root}/two_cpu/{f}")
    wall1 = sum(stage1.values())
    mb = GENOME_BP / 1e6
    log(f"[wide] L3K12, {comps} components: distance.out {n_lines} lines, {size} "
        f"B, byte-equal to --cpu-count; shared codes with own ref: "
        f"{shared.max(axis=1).tolist()}; two queries' combco files ({two_bytes} B) "
        f"byte-equal between --device cuda and --device cpu")
    log(f"[wide] stage I+II refs: {N_WIDE_REFS / t_ref:.3f} genomes/s, "
        f"{N_WIDE_REFS * mb / t_ref:.2f} Mbases/s ({t_ref:.3f} s CLI wall); "
        f"stage I timer {wall1:.3f} s ({N_WIDE_REFS / wall1:.3f} genomes/s), "
        f"dedup {stage1.get('dedup', 0.0):.3f} s = share "
        f"{stage1.get('dedup', 0.0) / wall1:.3f} [{stage1}]; {smi}")
    compare_index_loads(f"{root}/ref", smi, "wide")
    log(f"[wide] stage I queries {t_qry:.3f} s; search "
        f"{N_WIDE_QRYS * N_WIDE_REFS} pairs in {t_search:.3f} s CLI wall, count "
        f"stage {search_stages.get('count', 0.0):.3f} s over {comps} components, "
        f"summed on the card and fetched once [{search_stages}]; --cpu-count "
        f"{t_cpu:.3f} s; {smi}")
    for d in (ref_dir, qry_dir, two, f"{root}/two_cuda", f"{root}/two_cpu"):
        shutil.rmtree(d)
    return search_stages


def phase_reads(work: str) -> None:
    """7a: metagenome samples from reads through dist -A, --koc-out and
    every composite mode."""
    from public_kssd_tpu_torch import composite, kernels

    root = f"{work}/meta"
    t0 = time.perf_counter()
    planted = make_samples(f"{root}/samples", f"{work}/refs")
    log(f"[abundance] wrote {N_SAMPLES} samples of {N_READS} x {READ_LEN} bp "
        f"reads in {time.perf_counter() - t0:.1f} s; planted refs {planted}")
    ref, koc, shuf = f"{work}/ref", f"{root}/koc", f"{work}/L3K10.shuf"
    t_sketch = run_cli("dist", "-A", "-L", shuf, "-o", koc, f"{root}/samples")
    t_koc = run_cli("dist", "-r", ref, "-o", f"{root}/out", "--koc-out", koc)
    run_cli("dist", "-r", ref, "-o", f"{root}/out_cpu", "--koc-out",
            "--cpu-count", koc)
    size = same_bytes(f"{root}/out/distance.out", f"{root}/out_cpu/distance.out")
    with open(f"{root}/out/distance.out") as f:
        n_lines = sum(1 for _ in f)
    if n_lines != 1 + 2 * N_SAMPLES * N_REF_GENOMES or not kernels.count_koc_kernel.launches:
        raise AssertionError(f"--koc-out distance.out has {n_lines} lines, "
                             f"{kernels.count_koc_kernel.launches} count_koc launches")
    log(f"[abundance] dist -A {2 * N_READS} reads {t_sketch:.3f} s "
        f"({N_SAMPLES * N_READS * READ_LEN / t_sketch / 1e6:.2f} Mbases/s); "
        f"--koc-out search {t_koc:.3f} s; distance.out {n_lines} lines, {size} B, "
        "byte-equal to --cpu-count")

    with host_stats_refused():
        t_cuda, rep = run_cli_out("composite", "-r", ref, "-q", koc)
        t_cpu, rep_cpu = run_cli_out("composite", "-r", ref, "-q", koc,
                                     "--device", "cpu")
    oracle = composite.species_abundance(ref, koc, device=None)
    if not rep or rep != rep_cpu or rep != oracle:
        raise AssertionError("composite report differs between --device cuda, "
                             "--device cpu and the host oracle")
    rows = report_rows(rep)
    for s, pick in enumerate(planted):
        sample = next(k for k in rows if k.endswith(f"sample{s}.fq"))
        got = [int(re.search(r"ref(\d+)\.fasta", r[0]).group(1)) for r in rows[sample]]
        by_mean = sorted(rows[sample], key=lambda r: -float(r[2]))
        top = [int(re.search(r"ref(\d+)\.fasta", r[0]).group(1)) for r in by_mean[:3]]
        if sorted(got) != sorted(pick) or top != pick[:3]:
            raise AssertionError(f"sample {s}: reported {got}, top by mean {top}, "
                                 f"planted {pick}")
        log(f"[abundance] sample {s}: the {N_PLANTED} planted refs reported; mean "
            f"abundance of the top three {[r[2] for r in by_mean[:3]]} in planted order")
    abv = {}
    for dev in ("cuda", "cpu"):
        with host_stats_refused():
            run_cli("composite", "-r", ref, "-q", koc, "-b", "-o",
                    f"{root}/abv_{dev}", "--device", dev)
        abv[dev] = sorted(os.listdir(f"{root}/abv_{dev}"))
    if abv["cuda"] != abv["cpu"] or len(abv["cuda"]) != N_SAMPLES:
        raise AssertionError(f".abv files differ: {abv}")
    abv_bytes = sum(same_bytes(f"{root}/abv_cuda/{n}", f"{root}/abv_cpu/{n}")
                    for n in abv["cuda"])
    run_cli("composite", "-r", ref, "-q", koc, "-b")
    run_cli("composite", "-r", ref, "-i")
    for mode in (0, 1, 2):
        for q in abv["cuda"]:
            _, host = run_cli_out("composite", "-r", ref, "-s", str(mode), q)
            _, dense = run_cli_out("composite", "-r", ref, "-s", str(mode),
                                   "--device-search", q)
            check_dense_search(ref, q, mode, host, dense)
    log(f"[abundance] composite -q: {len(rep.splitlines())} report lines equal on "
        f"cuda ({t_cuda:.3f} s), cpu ({t_cpu:.3f} s) and the host oracle; -b "
        f".abv files ({abv_bytes} B) equal; -i and -s 0|1|2 (host walk and "
        "dense on the card) agree")
    shutil.rmtree(f"{root}/samples")  # koc/ feeds phase 8a


def check_dense_search(ref: str, query: str, mode: int, host: str,
                       dense: str) -> None:
    """The dense -s search on the card reports the samples the host walk
    reports; its cosine and L1 equal the walk's within rtol 1e-5 (and the
    absolute rounding of the walk's float32 sums). Its L2
    is over full vectors where the walk sums only dimensions both samples
    have (composite.abv_search_device), so it is held to a float64 numpy
    evaluation of that definition instead."""
    from public_kssd_tpu_torch import composite, formats

    h, d = abv_measures(host), abv_measures(dense)
    if h.keys() != d.keys() or not h:
        raise AssertionError(f"-s {mode}: samples {sorted(h)} != {sorted(d)}")
    if mode == 2:
        base = f"{ref}/{composite.BINVEC_DIRNAME}"
        with open(base + ".name") as f:
            names = [ln.rstrip("\n") for ln in f if ln.strip()]
        vec = {}
        for n in names:
            a = formats.read_abv(f"{base}/{n}")
            v = np.zeros(N_REF_GENOMES)
            v[a["ref_idx"]] = a["pct"]
            vec[n] = v
        want = {n: float(np.sqrt(((vec[n] - vec[query]) ** 2).sum())) for n in d}
        if not all(np.isclose(d[n], want[n], rtol=1e-5, atol=1e-5) for n in d):
            raise AssertionError(f"-s 2 dense {d} != numpy {want}")
        return
    # the walk's L1 ends with + (200 - xs - ys), where xs and ys are
    # float32 sums of percentages near 100: their rounding (~1e-5 an
    # addition) stays when the shared terms cancel, e.g. 3.1e-05 for a
    # sample against itself, which the dense search gives as 0
    atol = 1e-4 if mode == 1 else 1e-5
    bad = [n for n in h if not np.isclose(d[n], h[n], rtol=1e-5, atol=atol)]
    if bad:
        raise AssertionError(f"-s {mode}: dense {d} != host walk {h}")


def phase_gtdb(work: str) -> tuple[dict[str, int], str]:
    """7b: composite at the GTDB species-group database's shape over the
    inverted index and over raw DB codes, against the host oracle.
    Returns the join launches by route and the oracle report; keeps the
    DB for phase 8c."""
    from public_kssd_tpu_torch import composite, kernels, utils

    root = f"{work}/gtdb"
    ref, qry, idx = f"{root}/ref", f"{root}/qry", f"{root}/ref_idx"
    shutil.copytree(ref, idx)
    t_index = run_cli("dist", "-o", idx, idx, "--no-dense-index")
    t0 = time.perf_counter()
    oracle = composite.species_abundance(ref, qry, device=None)
    t_oracle = time.perf_counter() - t0
    stages = StageLog()
    utils.log.addHandler(stages)
    launches = {}
    walls = {}
    route_stages: dict[str, dict] = {}
    slice_bytes: dict[str, int] = {}
    seen: dict[str, list] = {}
    real_table, real_stats = composite._query_table_device, composite._hits_to_stats_torch

    def table(*args):
        seen["tables"].append((args, real_table(*args)))
        return seen["tables"][-1][1]

    def stats(*args):
        seen["stats"].append((args, real_stats(*args)))
        return seen["stats"][-1][1]

    composite._query_table_device, composite._hits_to_stats_torch = table, stats
    try:
        for route, d in (("csr", idx), ("raw", ref)):
            seen.update(tables=[], stats=[])
            before = kernels.join_kernel.launches
            with host_stats_refused():
                walls[route], rep = run_cli_out("composite", "-r", d, "-q", qry)
            launches[route] = kernels.join_kernel.launches - before
            if rep != oracle or not rep:
                raise AssertionError(f"GTDB-shaped composite report on the {route} "
                                     "route differs from the host oracle")
            hits, rows = check_device_stats(route, seen)
            route_stages[route] = dict(stages.stages["composite"])
            (parts, *_), got = seen["stats"][0]
            slice_bytes[route] = composite._slice_bytes(parts)
            per_query = [int(g[0].sum()) for g in got]
            largest_run = max(int(g[0].max()) for g in got)
            del parts, got
            seen.update(tables=[], stats=[])
            log(f"[gtdb] {route} route: report ({len(rep.splitlines())} lines) "
                f"byte-equal to the host oracle; CLI wall {walls[route]:.3f} s, "
                f"stages {route_stages[route]}; join launches "
                f"{launches[route]}; {hits} hit keys stayed on the card, "
                f"{rows} (query, ref) rows of aggregates fetched; the card's "
                "statistics equal _hits_to_stats of the same keys on the host, "
                "its query table _query_table's; the DB read straight onto the "
                "card, _raw_components refused")
        log("[gtdb] stages by route: " + "; ".join(
            f"{r} load {route_stages[r].get('load', 0.0):.3f} s, join "
            f"{route_stages[r].get('join', 0.0):.3f} s" for r in ("csr", "raw")))
        check_forced_budgets(idx, ref, qry, oracle, per_query, largest_run,
                             slice_bytes, seen)
    finally:
        utils.log.removeHandler(stages)
        composite._query_table_device, composite._hits_to_stats_torch = (
            real_table, real_stats)
    log(f"[gtdb] {GTDB_REFS} refs x {GTDB_SKETCH} codes, {GTDB_SAMPLES} samples x "
        f"{GTDB_SAMPLE_CODES} codes: stage II index {t_index:.3f} s; host oracle "
        f"{t_oracle:.3f} s; CLI composite csr {walls['csr']:.3f} s, raw "
        f"{walls['raw']:.3f} s")
    shutil.rmtree(idx)
    return launches, oracle


def check_forced_budgets(idx: str, ref: str, qry: str, oracle: str,
                         per_query: list[int], largest_run: int,
                         slice_bytes: dict[str, int], seen: dict) -> None:
    """7b: both routes under a forced small budget of the card's free
    bytes (composite._free_bytes), one that cuts the hit keys' statistics
    into ranges of whole queries and one that cuts the largest query by
    reference: reports byte-equal to the host oracle, the ranges counted
    and logged."""
    from public_kssd_tpu_torch import composite

    n = sum(per_query)
    qid_shift = 16 + GTDB_REFS.bit_length()
    real_free, real_ranges = composite._free_bytes, composite._stats_ranges
    caps = {"queries": max(n // 3, max(per_query)),
            "references": max(largest_run, max(per_query) // 4)}
    for budget, cap in caps.items():
        for route, d in (("csr", idx), ("raw", ref)):
            taken = []

            def ranges(*args):
                taken.append(real_ranges(*args))
                return taken[-1]

            free = cap * composite.STATS_BYTES_PER_KEY + slice_bytes[route]
            composite._free_bytes = lambda device, free=free: free
            composite._stats_ranges = ranges
            try:
                with host_stats_refused():
                    wall, rep = run_cli_out("composite", "-r", d, "-q", qry)
            finally:
                composite._free_bytes, composite._stats_ranges = real_free, real_ranges
                seen.update(tables=[], stats=[])
            if rep != oracle:
                raise AssertionError(f"the {route} route's report under the forced "
                                     f"{budget} budget differs from the host oracle")
            (got,) = taken
            whole = [lo % (1 << qid_shift) == hi % (1 << qid_shift) == 0
                     for lo, hi, _ in got]
            if (len(got) < 2 or sum(k for *_, k in got) != n
                    or any(k > cap for *_, k in got)
                    or all(whole) != (budget == "queries")):
                raise AssertionError(f"the {route} route under the forced {budget} "
                                     f"budget took the ranges {got}")
            log(f"[gtdb] {route} route, forced budget of {cap} keys a range "
                f"({free} B free): the {n} hit keys' statistics in {len(got)} "
                f"ranges ({budget}); report byte-equal to the host oracle; CLI "
                f"wall {wall:.3f} s")


def check_device_stats(route: str, seen: dict, on: str = "cuda") -> tuple[int, int]:
    """7b: each query table the route built on the card
    (_query_table_device) against _query_table of the same combco arrays,
    directory included, and the card's statistics of the route's hit keys
    (_hits_to_stats_torch) against _hits_to_stats of the same keys
    fetched to the host; exact; ``on``: the device type both must be on.
    Returns (hit keys, rows of aggregates)."""
    import torch

    from public_kssd_tpu_torch import composite

    if not seen["tables"] or len(seen["stats"]) != 1:
        raise AssertionError(f"{route} route: {len(seen['tables'])} query tables, "
                             f"{len(seen['stats'])} statistics calls")
    for (qc, qi, qa, n_qry, dev), (sq, sqid, sab, (qdir, shift)) in seen["tables"]:
        if sq.device.type != on:
            raise AssertionError(f"{route} route: the query table is on {sq.device}")
        w_sq, w_sqid, w_sab, n = composite._query_table(qc, qi, qa, n_qry)
        host = torch.from_numpy(w_sq[:n].view(np.int32))
        w_dir, w_shift = composite.query_directory(host, int(w_sq[n - 1]) if n else 0)
        if not (np.array_equal(sq.cpu().numpy().view(np.uint32), w_sq[:n])
                and np.array_equal(sqid.cpu().numpy(), w_sqid[:n])
                and np.array_equal(sab.cpu().numpy(), w_sab[:n].astype(np.int32))
                and shift == w_shift and torch.equal(qdir.cpu(), w_dir)):
            raise AssertionError(f"{route} route: the card's query table != "
                                 "_query_table's")
    (parts, n_qry, n_ref, qid_shift, dev), got = seen["stats"][0]
    if any(p.device.type != on for p in parts):
        raise AssertionError(f"{route} route: hit keys left the card")
    keys = [p.cpu().numpy() for p in parts]
    want = composite._hits_to_stats(keys, n_qry, n_ref, qid_shift)
    for qn, (g, w) in enumerate(zip(got, want, strict=True)):
        for a, b in zip(g, w, strict=True):
            if a.dtype != np.int64 or not np.array_equal(a, b):
                raise AssertionError(f"{route} route, query {qn}: the card's "
                                     "statistics != _hits_to_stats's")
    return sum(k.size for k in keys), sum(int((g[0] > 0).sum()) for g in got)


def phase_sharded_counts(device, work: str) -> None:
    """8a: sharded_search_counts over one-card meshes, both strategies,
    against the single-device counts, and the --koc-out counts; the
    shards built on the card from the index directory (the host index
    read refused), their build timed apart from the count, with the card's
    peak memory against the shards' bytes."""
    import torch

    from public_kssd_tpu_torch import formats, index, parallel, search
    from public_kssd_tpu_torch.parallel import sharded_search

    builds = []
    real = sharded_search.device_shards

    def timed_shards(*a, **k):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        db = real(*a, **k)
        torch.cuda.synchronize()
        held = sum(t.numel() * t.element_size() for ix in db.index.values()
                   for t in (ix.uniq, ix.offsets, ix.gids, ix.dir))
        builds.append((time.perf_counter() - t0,
                       torch.cuda.max_memory_allocated() - base, held))
        return db

    # (dp, ref, the bytes of index files a build group reads; None: the
    # default); the 16 MiB groups show the card's peak follow the bound
    cases = (
        ("sref", "sqry", False, ((1, 1, None), (1, 4, None), (2, 2, None),
                                 (1, 4, 16 << 20))),
        ("ref", "meta/koc", True, ((1, 4, None), (2, 2, None))),
    )
    for ref, qry, koc, shapes in cases:
        ref, qry = f"{work}/{ref}", f"{work}/{qry}"
        n_qry = formats.read_co_stat(qry).infile_num
        t0 = time.perf_counter()
        _, comps = index.load_device_index(ref, device)
        n_ref = comps[0].n_genomes
        koc_want = np.zeros((n_qry, n_ref), np.uint64) if koc else None
        want = search.compute_shared_counts(qry, comps, n_qry, device,
                                            koc_out=koc_want)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        del comps
        if not want.sum() or (koc and not koc_want.sum()):
            raise AssertionError(f"{qry} shares no codes with {ref}")
        walls = []
        for dp, nref, group in shapes:
            mesh = parallel.Mesh(dp, nref, (device,) * (dp * nref))
            for strategy in ("genome", "code"):
                koc_got = np.zeros((n_qry, n_ref), np.uint64) if koc else None
                builds.clear()
                sharded_search.device_shards = timed_shards
                default_group = index.MESH_GROUP_BYTES
                index.MESH_GROUP_BYTES = group or default_group
                try:
                    with host_fold_refused():
                        t0 = time.perf_counter()
                        got = sharded_search.sharded_search_counts(
                            qry, ref, 0, mesh, koc_out=koc_got, strategy=strategy,
                        )
                        wall = time.perf_counter() - t0
                finally:
                    sharded_search.device_shards = real
                    index.MESH_GROUP_BYTES = default_group
                (build, peak, held), = builds
                label = f" in {group >> 20} MiB groups" if group else ""
                walls.append(f"{dp}x{nref} {strategy}{label} {wall:.3f} s (shards "
                             f"{build:.3f}, count {wall - build:.3f}; peak "
                             f"{peak / 2**20:.1f} MiB for {held / 2**20:.1f} MiB "
                             f"of shards)")
                if not np.array_equal(got, want) or (
                        koc and not np.array_equal(koc_got, koc_want)):
                    raise AssertionError(f"sharded counts {dp}x{nref} {strategy} "
                                         f"of {qry} != the single-device counts")
        log(f"[sharded] {n_qry} x {n_ref}{' --koc-out' if koc else ''}: "
            f"sharded_search_counts equal to the single-device counts on every "
            f"mesh, shards built on the card from the index directory (the host "
            f"index read refused); walls (host clock; the shards' build on the card, "
            f"the count with its queries and fetch, the card's peak allocation "
            f"above what was held before): {'; '.join(walls)}; single device "
            f"(index load and count) {t_plain:.3f} s")


def phase_sharded_cli(work: str, wide_stages: dict[str, float],
                      gtdb_oracle: str) -> None:
    """8b-8d through kssd_torch: dist --mesh 1x1 at L3K12, composite
    --mesh 1 at the GTDB shape (and its join over [cuda:0]*4), and the
    --shard / --merge-shards stage I."""
    from public_kssd_tpu_torch import formats, parallel, resolve_device, utils
    from public_kssd_tpu_torch.parallel import sharded_composite

    wide = f"{work}/wide"
    stages = StageLog()
    utils.log.addHandler(stages)
    try:
        for strategy in ("genome", "code"):
            with host_fold_refused():
                t = run_cli("dist", "-r", f"{wide}/ref", "-o",
                            f"{wide}/out_{strategy}", "--mesh", "1x1",
                            "--shard-strategy", strategy, f"{wide}/qry")
            size = same_bytes(f"{wide}/out/distance.out",
                              f"{wide}/out_{strategy}/distance.out")
            log(f"[sharded] L3K12 dist --mesh 1x1 --shard-strategy {strategy}: "
                f"distance.out {size} B byte-equal to phase 6's; CLI wall {t:.3f} "
                f"s, count stage {stages.stages['search']['count']:.3f} s over one "
                f"folded index (phase 6, per component: "
                f"{wide_stages.get('count', 0.0):.3f} s) [{stages.stages['search']}]")
    finally:
        utils.log.removeHandler(stages)

    gtdb = f"{work}/gtdb"
    dev = resolve_device("cuda")
    with host_stats_refused(), host_fold_refused():
        t, rep = run_cli_out("composite", "-r", f"{gtdb}/ref", "-q", f"{gtdb}/qry",
                             "--mesh", "1")
        t0 = time.perf_counter()
        rep4 = sharded_composite.species_abundance_sharded(
            f"{gtdb}/ref", f"{gtdb}/qry", parallel.Mesh(1, 4, (dev,) * 4)
        )
        t4 = time.perf_counter() - t0
    if not rep or rep != gtdb_oracle or rep4 != gtdb_oracle:
        raise AssertionError("composite --mesh report differs from the host oracle")
    log(f"[sharded] GTDB shape composite --mesh 1: report ({len(rep.splitlines())} "
        f"lines) byte-equal to the host oracle, CLI wall {t:.3f} s; the same over "
        f"[cuda:0]*4 {t4:.3f} s; neither reached the host statistics or the "
        f"host index read")

    files = sorted(os.listdir(f"{work}/refs"))
    half = -(-len(files) // 2)
    # round-robin shards of this list are the two halves of the sorted
    # files, so the merge restores phase 4's order
    order = [f for pair in zip(files[:half], files[half:]) for f in pair]
    with open(f"{work}/refs.list", "w") as f:
        f.write("".join(f"{work}/refs/{n}\n" for n in order))
    t0 = time.perf_counter()
    for s in range(2):
        run_cli("dist", "-L", f"{work}/L3K10.shuf", "-o", f"{work}/shards",
                "--shard", f"{s}:2", "-l", f"{work}/refs.list")
    run_cli("dist", "--merge-shards", "-o", f"{work}/merged", f"{work}/shards")
    t_shards = time.perf_counter() - t0
    size = sum(same_bytes(f"{work}/ref/{n}", f"{work}/merged/{n}")
               for n in ("combco.0", "combco.index.0"))
    a, b = formats.read_co_stat(f"{work}/ref"), formats.read_co_stat(f"{work}/merged")
    if a.names != b.names or a.ctx_ct.tolist() != b.ctx_ct.tolist():
        raise AssertionError("merged shards' cofiles.stat differs from stage I's")
    log(f"[sharded] dist --shard 0:2, 1:2 and --merge-shards of {len(files)} refs "
        f"in {t_shards:.3f} s: combco.0 and combco.index.0 ({size} B) byte-equal to "
        f"phase 4's stage I")


def trace_kernels(trace_dir: str) -> tuple[int, int, set[str]]:
    """The one torch.profiler trace that ``dist --profile`` wrote into
    ``trace_dir``: its size in bytes, its event count and the names of its
    CUDA kernel events."""
    path, events = load_trace(trace_dir)
    return os.path.getsize(path), len(events), kernel_names(events)


def codes_by_genome(co_dir: str) -> dict[str, list[np.ndarray]]:
    """Base name of each genome -> its sorted codes, one array per
    component."""
    from public_kssd_tpu_torch import formats

    stat = formats.read_co_stat(co_dir)
    comps = [formats.read_combco(co_dir, c) for c in range(stat.comp_num)]
    return {
        os.path.basename(name).split(".")[0]: [
            np.sort(codes[int(idx[g]):int(idx[g + 1])]) for codes, idx in comps
        ]
        for g, name in enumerate(stat.names)
    }


# runs kssd_torch commands one after another in a fresh process; prints
# the seconds to import the package and reach the card, then each
# command's wall, as a JSON list on its last line
FRESH_CLI = """
import json, sys, time
t0 = time.perf_counter()
import torch
from public_kssd_tpu_torch import cli
torch.zeros(1, device="cuda")
walls = [time.perf_counter() - t0]
for argv in json.loads(sys.argv[1]):
    t = time.perf_counter()
    if cli.main(argv) != 0:
        sys.exit(f"kssd_torch {argv} failed")
    walls.append(time.perf_counter() - t)
print(json.dumps(walls))
"""


def run_cli_fresh(*commands: list[str]) -> tuple[list[float], list[float]]:
    """The kssd_torch ``commands`` in one fresh process; returns the
    process's start-up and command walls (``FRESH_CLI``) and the stage
    walls that the commands logged (``STAGE_WALL``), in order."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", FRESH_CLI, json.dumps(commands)],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"kssd_torch {commands} failed: {r.stderr[-2000:]}")
    stages = [float(w) for _, w in STAGE_WALL.findall(r.stderr)]
    return json.loads(r.stdout.splitlines()[-1]), stages


def phase_profile(work: str) -> None:
    """9a: dist --profile on the card, for stage I and for the search, in
    a fresh process as a user runs it (torch.profiler drops GPU events
    from a session that follows much unprofiled CUDA work in the same
    process, as every session after phase 3's would): outputs byte-equal
    to the same commands without the flag, and the traces name the
    sketch and the count kernels."""
    from public_kssd_tpu_torch import utils

    refs = sorted(os.listdir(f"{work}/refs"))[:2]
    sketch = ["dist", "-L", f"{work}/L3K10.shuf"] + [f"{work}/refs/{r}" for r in refs]
    search = ["dist", "-r", f"{work}/ref", "--keepskf", f"{work}/qry"]
    stages = StageLog()
    utils.log.addHandler(stages)
    try:
        k_wall = run_cli(*sketch, "-o", f"{work}/k_noprof")
        k_plain = stages.walls["stage I"]
        s_wall = run_cli(*search, "-o", f"{work}/out_noprof")
        s_plain = stages.walls["search"]
    finally:
        utils.log.removeHandler(stages)
    walls, (k_prof, s_prof) = run_cli_fresh(
        sketch + ["-o", f"{work}/k_prof", "--profile", f"{work}/trace_k"],
        search + ["-o", f"{work}/out_prof", "--profile", f"{work}/trace_s"],
    )
    for name in sorted(os.listdir(f"{work}/k_noprof")):
        if name.startswith("combco."):
            same_bytes(f"{work}/k_noprof/{name}", f"{work}/k_prof/{name}")
    for name in ("distance.out", "sharedk_ct.dat"):
        same_bytes(f"{work}/out/{name}", f"{work}/out_prof/{name}")
    traces = {}
    for tag, kernels in (("k", ("sketch_keep_kernel", "sketch_fill_kernel")),
                         ("s", ("count_row_kernel|count_global_kernel",))):
        size, n_events, names = trace_kernels(f"{work}/trace_{tag}")
        for kernel in kernels:
            if not any(re.search(kernel, n) for n in names):
                raise AssertionError(f"trace_{tag} names no {kernel}: {sorted(names)}")
        traces[tag] = f"{size} B, {n_events} events, {len(names)} CUDA kernel names"
    log(f"[host] dist --profile in a fresh process: start-up (import, first CUDA "
        f"call) {walls[0]:.3f} s; stage I of 2 refs {walls[1]:.3f} s (stage "
        f"{k_prof:.3f} s; not profiled, in this process: {k_wall:.3f} s, stage "
        f"{k_plain:.3f} s), combco files byte-equal to the run without the flag, "
        f"trace {traces['k']} with sketch_keep_kernel and sketch_fill_kernel; "
        f"search {walls[2]:.3f} s (stage {s_prof:.3f} s; not profiled {s_wall:.3f} "
        f"s, stage {s_plain:.3f} s), distance.out and sharedk_ct.dat byte-equal to "
        f"phase 4's, trace {traces['s']} with a count kernel")


def phase_set(work: str) -> None:
    """9b: set -u / -i / -s / -P on phase 4's sketches, and the
    intersected and subtracted queries searched on the card."""
    from public_kssd_tpu_torch import formats, kernels

    ref, qry, pan = f"{work}/ref", f"{work}/qry", f"{work}/pan"
    t_union = run_cli("set", "-u", "-o", pan, ref)
    stat = formats.read_co_stat(ref)
    for c in range(stat.comp_num):
        if not np.array_equal(formats.read_pan(pan, c),
                              np.unique(formats.read_combco(ref, c)[0])):
            raise AssertionError(f"pan.{c} is not the distinct codes of combco.{c}")
    t_int = run_cli("set", "-i", pan, "-o", f"{work}/q_int", qry)
    t_sub = run_cli("set", "-s", pan, "-o", f"{work}/q_sub", qry)
    whole, inter, sub = (codes_by_genome(f"{work}/{d}") for d in ("qry", "q_int", "q_sub"))
    n_int = n_sub = 0
    for name, comps in whole.items():
        for c, codes in enumerate(comps):
            if not np.array_equal(np.sort(np.concatenate([inter[name][c], sub[name][c]])),
                                  codes):
                raise AssertionError(f"{name}: -i and -s codes do not make up its sketch")
            n_int += inter[name][c].size
            n_sub += sub[name][c].size
    before = kernels.count_kernel.launches
    t_search = {}
    for d in ("q_int", "q_sub"):
        t_search[d] = run_cli("dist", "-r", ref, "-o", f"{work}/out_{d}", "--keepskf",
                              f"{work}/{d}")
    same_bytes(f"{work}/out/sharedk_ct.dat", f"{work}/out_q_int/sharedk_ct.dat")
    if np.fromfile(f"{work}/out_q_sub/sharedk_ct.dat", "<u4").any():
        raise AssertionError("a subtracted query shares codes with a reference")
    launches = kernels.count_kernel.launches - before
    if not launches:
        raise AssertionError("the searches of 9b did not launch the count kernel")
    t_names, names = run_cli_out("set", "-P", ref)
    if names.splitlines() != stat.names or len(stat.names) != N_REF_GENOMES:
        raise AssertionError("set -P does not print the reference names")
    log(f"[host] set -u of {stat.infile_num} sketches ({stat.all_ctx_ct} codes) "
        f"{t_union:.3f} s; -i {t_int:.3f} s and -s {t_sub:.3f} s of "
        f"{len(whole)} queries ({n_int} codes shared, {n_sub} not): they make up "
        f"each query; search of q_int {t_search['q_int']:.3f} s gives "
        f"sharedk_ct.dat byte-equal to phase 4's, of q_sub {t_search['q_sub']:.3f} "
        f"s all zeros ({launches} count launches); set -P {t_names:.3f} s")


def phase_reverse(work: str) -> None:
    """9c: reverse phase 4's queries to k-mers and sketch them again on
    the card: the same codes."""
    from public_kssd_tpu_torch import kernels

    shuf = f"{work}/L3K10.shuf"
    t_rev = run_cli("reverse", "-L", shuf, "-o", f"{work}/rev", f"{work}/qry")
    os.makedirs(f"{work}/rev_fa")
    n_kmers = 0
    for name in sorted(os.listdir(f"{work}/rev")):
        with open(f"{work}/rev/{name}") as f:
            kmers = f.read().split()
        n_kmers += len(kmers)
        with open(f"{work}/rev_fa/{name.split('.')[0]}.fa", "w") as f:
            f.write("".join(f">{i}\n{s}\n" for i, s in enumerate(kmers)))
    before = kernels.sketch_kernel.launches
    t_sketch = run_cli("dist", "-L", shuf, "-o", f"{work}/again", f"{work}/rev_fa")
    launches = kernels.sketch_kernel.launches - before
    want, got = codes_by_genome(f"{work}/qry"), codes_by_genome(f"{work}/again")
    if sorted(want) != sorted(got) or len(want) != N_QRY_GENOMES:
        raise AssertionError(f"resketched genomes {sorted(got)} != {sorted(want)}")
    for name in want:
        for a, b in zip(want[name], got[name]):
            if not np.array_equal(a, b):
                raise AssertionError(f"{name}: the resketched k-mers give other codes")
    if not launches:
        raise AssertionError("the resketch of 9c did not launch the sketch kernel")
    log(f"[host] reverse of {N_QRY_GENOMES} queries to {n_kmers} k-mers "
        f"{t_rev:.3f} s; their resketch on the card ({launches} sketch launches) "
        f"{t_sketch:.3f} s gives each query's codes")


def phase_convert(work: str) -> None:
    """9d: primer, and convert krona / qiime / cami on a seeded report of
    40 references that all pass the converters' thresholds."""
    t, out = run_cli_out("primer")
    primes = [int(x) for x in out.splitlines() if x.isdigit()]
    if len(primes) != 44 or primes[0] != 251:
        raise AssertionError(f"primer printed {len(primes)} primes")
    rng = np.random.default_rng(SEED)
    d = f"{work}/convert"
    os.makedirs(d)
    n = 40
    avg = rng.uniform(4, 8, n)
    with open(f"{d}/report.tsv", "w") as f:
        f.write("".join(
            f"/data/sampleA.fq.gz\t{1000 + i}_GCA_{i:06d}.1\t{rng.integers(10, 40)}\t"
            f"{avg[i] + 0.3:.4f}\t{avg[i]:.4f}\t{rng.integers(2, 4)}.0\t"
            f"{avg[i] + 0.5:.4f}\n" for i in range(n)))
    with open(f"{d}/psid2tax.tsv", "w") as f:
        f.write("".join(f"{1000 + i}\td__Bacteria\tp__P{i % 3}\ts__Species {i}\n"
                        for i in range(n)))
    with open(f"{d}/psid2ncbi.tsv", "w") as f:
        f.write("".join(f"{1000 + i}\t{5000 + i}\n" for i in range(n)))
    ranks = ("species", "genus", "family", "order", "class", "phylum", "superkingdom")
    with open(f"{d}/nodes.tsv", "w") as f:
        for i in range(n):
            chain = [5000 + i] + [6000 + 10 * j + i % 2 for j in range(6)] + [1]
            f.write("".join(f"{node}\t{ranks[lvl]}\t{chain[lvl + 1]}\tname_{node}\n"
                            for lvl, node in enumerate(chain[:-1])))
    _, out = run_cli_out("convert", "krona", "-t", f"{d}/psid2tax.tsv", "-o",
                         f"{d}/krona", f"{d}/report.tsv")
    krona = out.strip()
    with open(krona) as f:
        lines = f.read().splitlines()
    with open(f"{d}/krona2.tsv", "w") as f:
        f.write("\n".join(reversed(lines)) + "\n")
    run_cli("convert", "qiime", "-o", f"{d}/qiime", krona, f"{d}/krona2.tsv")
    with open(f"{d}/qiime/otu.tsv") as f:
        n_otu = len(f.read().splitlines())
    _, cami = run_cli_out("convert", "cami", "-t", f"{d}/psid2ncbi.tsv", "-n",
                          f"{d}/nodes.tsv", "-o", f"{d}/cami", f"{d}/report.tsv")
    # 7 header lines, 40 species and two nodes at each of the 6 other ranks
    if (len(lines), n_otu, len(cami.splitlines())) != (n, n + 1, 7 + n + 6 * 2):
        raise AssertionError(f"convert line counts: krona {len(lines)}, otu.tsv "
                             f"{n_otu}, cami {len(cami.splitlines())}")
    log(f"[host] primer: 44 primes ({t:.3f} s); convert krona {len(lines)} lines, "
        f"qiime otu.tsv {n_otu}, cami {len(cami.splitlines())}")


def main() -> int:
    if len(sys.argv) > 1:
        raise SystemExit("usage: python3 chip_smoke.py (no arguments)")
    kind, smi = phase_device()
    import torch

    sys.path.insert(0, ROOT)
    from public_kssd_tpu_torch import kernels, resolve_device

    device = resolve_device("cuda")
    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t_all = time.perf_counter()
    phase_build()
    res, synth = phase_kernels(device, work)
    for k in kernels.ALL:  # count only what each main path launches
        k.launches = 0
    phase_sketch_heavy(work)
    phase_search_heavy(work, synth, smi)
    launches = {k.name: k.launches for k in (kernels.sketch_kernel, kernels.count_kernel)}
    for k in kernels.ALL:
        k.launches = 0
    wide_stages = phase_wide(work, smi)
    wide = {k.name: k.launches for k in kernels.ALL}
    log(f"[wide] launches on this path: {wide}")
    launches["sketch_wide"] = wide["sketch_wide"]
    for k in kernels.ALL:
        k.launches = 0
    t7 = time.perf_counter()
    phase_reads(work)
    join_routes, gtdb_oracle = phase_gtdb(work)
    abundance = {k.name: k.launches for k in kernels.ALL}
    log(f"[abundance] phase 7 in {time.perf_counter() - t7:.1f} s; launches on "
        f"this path: {abundance}, join by route {join_routes}")
    launches["count_koc"] = abundance["count_koc"]
    launches["join"] = abundance["join"]
    for k in kernels.ALL:
        k.launches = 0
    t8 = time.perf_counter()
    phase_sharded_counts(device, work)
    phase_sharded_cli(work, wide_stages, gtdb_oracle)
    sharded = {k.name: k.launches for k in kernels.ALL}
    log(f"[sharded] phase 8 in {time.perf_counter() - t8:.1f} s; launches on this "
        f"path: {sharded}")
    for name in ("count64", "count_koc64", "join64"):
        launches[name] = sharded[name]
    for k in kernels.ALL:
        k.launches = 0
    t9 = time.perf_counter()
    phase_profile(work)
    phase_set(work)
    phase_reverse(work)
    phase_convert(work)
    log(f"[host] phase 9 in {time.perf_counter() - t9:.1f} s; launches (not in the "
        f"kernels line): {({k.name: k.launches for k in kernels.ALL})}")
    for name, n in list(launches.items()) + [
        ("count (wide path)", wide["count"]),
        ("sketch (abundance path)", abundance["sketch"]),
        ("join (csr route)", join_routes["csr"]),
        ("join (raw route)", join_routes["raw"]),
        ("sketch (sharded stage I)", sharded["sketch"]),
    ]:
        if n == 0:
            raise AssertionError(f"{name} kernel was not launched by its main path")
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
    if bad:
        raise AssertionError(f"jax was imported: {bad[:5]}")
    shutil.rmtree(work)
    log(f"[done] all phases passed in {time.perf_counter() - t_all:.1f} s")
    replaces = {
        "sketch": "public_kssd_tpu/ops/pallas_sketch.py:437",
        "sketch_wide": "public_kssd_tpu/ops/pallas_sketch.py:492",
        "count": "public_kssd_tpu/ops/count.py:300",
        "count_koc": "public_kssd_tpu/ops/count.py:563",
        "join": "public_kssd_tpu/composite.py:152",
        "count64": "public_kssd_tpu/parallel/sharded_search.py:341",
        "count_koc64": "public_kssd_tpu/parallel/sharded_search.py:379",
        "join64": "public_kssd_tpu/parallel/sharded_composite.py:109",
    }
    print(json.dumps({"kernels": [
        {
            "name": k.name,
            "route": "cuda",
            "source": os.path.relpath(k.source, ROOT),
            "replaces": replaces[k.name],
            "launches": launches[k.name],
            "max_abs_err": res[k.name]["err"],
            "ms": res[k.name]["ms"],
            "plain_ms": res[k.name]["plain_ms"],
            "bound_ms": res[k.name]["bound"][0],
            "bound_by": res[k.name]["bound"][1],
            # no one PyTorch call computes a sketch, a sparse count or a
            # join (PERF.md)
            "library_ms": None,
            **res[k.name].get("extra", {}),  # join: its raw route
        }
        for k in kernels.ALL
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
