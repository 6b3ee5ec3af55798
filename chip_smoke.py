#!/usr/bin/env python3
"""Smoke test of public_kssd_tpu_torch on one NVIDIA GPU (sm_90a: H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then nonzero):

  1. device   a CUDA card must be visible; prints its name and power limit
  2. build    compiles csrc/sketch.cu (kernels sketch and sketch_wide) and
              csrc/count.cu with nvcc into build/public_kssd_tpu_torch/,
              one nvcc per source, all started together
  3. kernels  each kernel against its plain PyTorch version on the card,
              exact equality, with the time of both:
              sketch at (k,s,l) = (10,6,3) Feistel, (8,5,2) table and
              (6,5,1) Feistel on 2^24 packed symbols; sketch_wide at
              (12,6,3) Feistel and table (36-bit codes), (15,7,1) Feistel
              (56 bits) and (16,6,1) Feistel (60 bits, W = 32);
              sketch_codes_stream at (10,6,3) and (12,6,3) on the card
              against the same call on CPU tensors; count at
              1,000 queries x 10,000 refs x ~1,300 codes (13M postings)
              and on full 32-bit codes; the stage II device sort
  4. sketch-heavy main path through kssd_torch's CLI: 64 reference and 16
              query genomes of 5.3 Mb (queries are references with 1-5%
              point mutations); shuffle, dist -r refs, dist queries, dist
              -r ref qry; distance.out byte-equal to the --cpu-count run
  5. search-heavy main path: the 10,000-ref synthetic DB of phase 3 as a
              stage I directory, indexed and searched by 1,000 queries
              through the CLI; distance.out byte-equal to --cpu-count
  6. wide main path at L3K12 (k=12 s=6 l=3: 36-bit codes, 256
              components): 16 reference and 4 query genomes of 5.3 Mb
              through the CLI (stage II with --no-dense-index);
              distance.out byte-equal to --cpu-count, each query matches
              its source best, and the combco files of two queries are
              byte-equal between --device cuda and --device cpu

Launch counts are reset before phase 4 and read after phase 5 (sketch,
count), and reset before phase 6 and read after it (sketch_wide). The
output ends with a JSON line of per-kernel results, the card's name and
power limit from nvidia-smi, and the line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Everything the run writes goes under build/chip_smoke/ in the checkout
and is removed at the end.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GENOME_BP = 5_300_000
N_REF_GENOMES, N_QRY_GENOMES = 64, 16
N_WIDE_REFS, N_WIDE_QRYS = 16, 4
SYNTH_REFS, SYNTH_QRYS, SYNTH_SKETCH = 10_000, 1_000, 1_300
SKETCH_SYMBOLS = 1 << 24
SEED = 20261016


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


def max_abs_err(a, b) -> int:
    """Largest absolute difference of two integer tensors (int64)."""
    import torch

    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def run_cli(*argv: str) -> float:
    """kssd_torch <argv> in this process; returns its wall seconds."""
    import torch

    from public_kssd_tpu_torch import cli

    t0 = time.perf_counter()
    rc = cli.main(list(argv))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"kssd_torch {' '.join(argv)} exited {rc}")
    return dt


class StageLog(logging.Handler):
    """Keeps the stage timers that kssd_torch logs ("stage I: ... [name:
    1.234s; ...]", "search: ... [...]") of the last call."""

    def __init__(self):
        super().__init__()
        self.stages: dict[str, dict[str, float]] = {}

    def emit(self, record):
        msg = record.getMessage()
        head = msg.split(":", 1)[0]
        if head in ("stage I", "search") and "[" in msg:
            body = msg[msg.rindex("[") + 1:]
            self.stages[head] = {
                k: float(v) for k, v in re.findall(r"(\w+): ([0-9.]+)s", body)
            }


def same_bytes(a: str, b: str) -> int:
    """Assert two files are byte-equal; returns their size."""
    with open(a, "rb") as fa, open(b, "rb") as fb:
        xa, xb = fa.read(), fb.read()
    if xa != xb:
        raise AssertionError(f"{a} ({len(xa)} B) differs from {b} ({len(xb)} B)")
    return len(xa)


# ------------------------------------------------------------------ data

def write_fasta(path: str, seq: np.ndarray, name: str) -> None:
    """uint8 ACGT bytes -> plain fasta with 80-column lines."""
    width = 80
    pad = (-seq.size) % width
    body = np.concatenate([seq, np.full(pad, ord("\n"), np.uint8)])
    rows = body.reshape(-1, width)
    lines = np.hstack([rows, np.full((rows.shape[0], 1), ord("\n"), np.uint8)])
    blob = lines.tobytes()
    if pad:
        blob = blob[: -(pad + 1)] + b"\n"
    with open(path, "wb") as f:
        f.write(f">{name} synthetic genome\n".encode())
        f.write(blob)


def make_genomes(root: str, n_ref: int = N_REF_GENOMES,
                 n_qry: int = N_QRY_GENOMES, seed: int = SEED,
                 ) -> tuple[str, str, list[int]]:
    """n_ref random 5.3 Mb references; query q is reference (n_ref/n_qry)q
    with a point mutation rate rising from 1% to 5%. Returns (ref dir,
    qry dir, the reference index of each query)."""
    rng = np.random.default_rng(seed)
    lut = np.frombuffer(b"ACGT", np.uint8)
    ref_dir, qry_dir = f"{root}/refs", f"{root}/qrys"
    os.makedirs(ref_dir)
    os.makedirs(qry_dir)
    source = []
    step = n_ref // n_qry
    for i in range(n_ref):
        seq = lut[rng.integers(0, 4, GENOME_BP, dtype=np.uint8)]
        write_fasta(f"{ref_dir}/ref{i:02d}.fasta", seq, f"ref{i:02d}")
        if i % step == 0:
            q = i // step
            rate = 0.01 + 0.04 * q / (n_qry - 1)
            hit = np.flatnonzero(rng.random(GENOME_BP) < rate)
            mut = seq.copy()
            mut[hit] = lut[(rng.integers(1, 4, hit.size) + np.searchsorted(lut, seq[hit])) % 4]
            write_fasta(f"{qry_dir}/qry{q:02d}.fasta", mut, f"qry{q:02d}")
            source.append(i)
    return ref_dir, qry_dir, source


def synth_csr(n_ref: int, sketch_sz: int, n_qry: int, seed: int,
              space: int = 1 << 28):
    """Synthetic DB of n_ref sketches of codes below ``space`` (28 bits:
    4(k-l) at k=10, l=3) as a CSR index, plus n_qry query sketches with
    ~30% codes planted from the DB."""
    from public_kssd_tpu_torch import index as index_mod

    rng = np.random.default_rng(seed)
    ref_codes = rng.integers(0, space, size=(n_ref, sketch_sz), dtype=np.uint64)
    flat = np.sort(ref_codes, axis=None).astype(np.uint32)
    gids = np.argsort(ref_codes, axis=None, kind="stable") // sketch_sz
    uniq, first = np.unique(flat, return_index=True)
    offsets = np.zeros(uniq.size + 1, dtype=np.uint64)
    offsets[1:-1] = first[1:]
    offsets[-1] = flat.size
    sp = index_mod.SparseIndex(
        uniq_codes=uniq.astype(np.uint32),
        offsets=offsets,
        gids=gids.astype(np.uint32),
        n_genomes=n_ref,
    )
    qry = rng.integers(0, space, size=n_qry * sketch_sz, dtype=np.uint64)
    hit = rng.random(qry.size) < 0.3
    qry[hit] = ref_codes.ravel()[rng.integers(0, ref_codes.size, size=int(hit.sum()))]
    return sp, ref_codes.astype(np.uint32), qry.astype(np.uint32)


def write_stage1_dir(path: str, codes: np.ndarray, params_id: int, prefix: str) -> None:
    """[n, sketch] uint32 codes -> a stage I sketch directory (k=10, l=3,
    one component)."""
    from public_kssd_tpu_torch import formats

    n, sz = codes.shape
    os.makedirs(path)
    index = np.arange(n + 1, dtype=np.uint64) * np.uint64(sz)
    formats.write_combco(path, 0, codes.ravel(), index)
    ctx = np.full(n, sz, np.uint32)
    formats.write_co_stat(path, formats.CoStat(
        params_id=params_id, koc=False, kmerlen=20, dim_rd_len=6, comp_num=1,
        infile_num=n, all_ctx_ct=int(ctx.sum()), ctx_ct=ctx,
        names=[f"{prefix}{i:05d}" for i in range(n)],
    ))


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


def phase_kernels(device) -> tuple[dict, tuple[np.ndarray, np.ndarray]]:
    import torch

    from public_kssd_tpu_torch import formats, shufspace
    from public_kssd_tpu_torch import index as index_mod
    from public_kssd_tpu_torch.config import SketchParams
    from public_kssd_tpu_torch.ops import count, sketch
    from public_kssd_tpu_torch.seqio import BREAK

    res = {"sketch": {"err": 0}, "sketch_wide": {"err": 0}, "count": {"err": 0}}
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
        got = sketch.sketch_windows_dense(words, n_valid, shuf, p)
        want = sketch.sketch_windows_dense_plain(words, n_valid, shuf, p)
        err = max_abs_err(got, want)
        res[name]["err"] = max(res[name]["err"], err)
        kept = int((got != sketch.SENTINEL).sum())
        if (err or kept == 0 or got.dtype != sketch.dense_dtype(p)
                or bool((got[n_valid - p.TL + 1:] != -1).any())):
            raise AssertionError(f"{name} kernel != plain at {(k, s, l, mode)}: "
                                 f"max_abs_err {err}, kept {kept}, {got.dtype}")
        ms = cuda_ms(lambda: sketch.sketch_windows_dense(words, n_valid, shuf, p))
        plain_ms = cuda_ms(
            lambda: sketch.sketch_windows_dense_plain(words, n_valid, shuf, p), 2
        )
        log(f"[kernels] {name} (k,s,l)=({k},{s},{l}) {mode}, {p.drtuple_bits}-bit "
            f"codes: {n} windows, {kept} kept, equal; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms")
        if (k, s, l, mode) in timed:
            res[name].update(ms=ms, plain_ms=plain_ms)

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

    # counting at the 1000 x 10k bench shape
    t0 = time.perf_counter()
    sp, ref_codes, qry = synth_csr(SYNTH_REFS, SYNTH_SKETCH, SYNTH_QRYS, SEED + 2)
    log(f"[kernels] synthetic DB: {SYNTH_REFS} refs, {sp.gids.size} postings, "
        f"{sp.uniq_codes.size} codes, {SYNTH_QRYS} queries "
        f"({time.perf_counter() - t0:.1f} s host)")
    qidx = np.arange(SYNTH_QRYS + 1, dtype=np.uint64) * SYNTH_SKETCH
    index = count.DeviceIndex.from_sparse(sp, device)
    qc = torch.from_numpy(qry.view(np.int32)).to(device)
    qq = torch.from_numpy(count.query_ids(qidx, qry.size)).to(device)
    got = count.count_shared_kernel(qc, qq, index, SYNTH_QRYS)
    want = count.count_shared_torch(qc, qq, index, SYNTH_QRYS)
    err = max_abs_err(got, want)
    res["count"]["err"] = err
    host = count.count_shared_np(qry, qidx, sp.uniq_codes, sp.offsets, sp.gids,
                                 SYNTH_QRYS, SYNTH_REFS)
    if err or not np.array_equal(got.cpu().numpy().view(np.uint32), host) or not host.sum():
        raise AssertionError(f"count kernel != plain/host: max_abs_err {err}")
    ms = cuda_ms(lambda: count.count_shared_kernel(qc, qq, index, SYNTH_QRYS))
    plain_ms = cuda_ms(lambda: count.count_shared_torch(qc, qq, index, SYNTH_QRYS))
    pairs = SYNTH_QRYS * SYNTH_REFS
    log(f"[kernels] count {SYNTH_QRYS} x {SYNTH_REFS}: {int(host.sum())} shared "
        f"codes, equal to plain and host; kernel {ms:.4f} ms "
        f"({pairs / ms * 1e3:.4g} pairs/s), plain {plain_ms:.4f} ms")
    res["count"].update(ms=ms, plain_ms=plain_ms)

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
    return res, (ref_codes, qry)


def phase_sketch_heavy(work: str) -> None:
    from public_kssd_tpu_torch import kernels

    t0 = time.perf_counter()
    ref_dir, qry_dir, source = make_genomes(work)
    log(f"[sketch-heavy] wrote {N_REF_GENOMES} + {N_QRY_GENOMES} genomes of "
        f"{GENOME_BP} bp in {time.perf_counter() - t0:.1f} s")
    shuf = f"{work}/L3K10"
    run_cli("shuffle", "-k", "10", "-s", "6", "-l", "3", "--seed", "3", "-o", shuf)
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
    mb = GENOME_BP / 1e6
    log(f"[sketch-heavy] distance.out {n_lines} lines, {size} B, byte-equal to "
        f"--cpu-count; shared codes with own ref: {shared.max(axis=1).tolist()}")
    log(f"[sketch-heavy] stage I+II refs: {N_REF_GENOMES / t_ref:.3f} genomes/s, "
        f"{N_REF_GENOMES * mb / t_ref:.2f} Mbases/s ({t_ref:.3f} s); stage I "
        f"queries: {N_QRY_GENOMES / t_qry:.3f} genomes/s, "
        f"{N_QRY_GENOMES * mb / t_qry:.2f} Mbases/s ({t_qry:.3f} s); search "
        f"{N_QRY_GENOMES * N_REF_GENOMES / t_search:.1f} pairs/s ({t_search:.3f} s)")
    shutil.rmtree(ref_dir)
    shutil.rmtree(qry_dir)


def phase_search_heavy(work: str, synth) -> None:
    ref_codes, qry = synth
    params_id = 12345
    write_stage1_dir(f"{work}/sref", ref_codes, params_id, "r")
    write_stage1_dir(f"{work}/sqry", qry.reshape(SYNTH_QRYS, SYNTH_SKETCH),
                     params_id, "q")
    t_index = run_cli("dist", "-o", f"{work}/sref", f"{work}/sref",
                      "--no-dense-index")
    t_search = run_cli("dist", "-r", f"{work}/sref", "-o", f"{work}/sout",
                       f"{work}/sqry")
    t_cpu = run_cli("dist", "-r", f"{work}/sref", "-o", f"{work}/sout_cpu",
                    "--cpu-count", f"{work}/sqry")
    size = same_bytes(f"{work}/sout/distance.out", f"{work}/sout_cpu/distance.out")
    pairs = SYNTH_QRYS * SYNTH_REFS
    log(f"[search-heavy] {SYNTH_QRYS} x {SYNTH_REFS}: distance.out {size} B "
        f"byte-equal to --cpu-count; index {t_index:.3f} s; search "
        f"{pairs / t_search:.1f} pairs/s ({t_search:.3f} s, CLI wall incl. "
        f"index load and distance.out print); --cpu-count {t_cpu:.3f} s")


def phase_wide(work: str) -> None:
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
        f"{stage1.get('dedup', 0.0) / wall1:.3f} [{stage1}]")
    log(f"[wide] stage I queries {t_qry:.3f} s; search "
        f"{N_WIDE_QRYS * N_WIDE_REFS} pairs in {t_search:.3f} s CLI wall, count "
        f"stage {search_stages.get('count', 0.0):.3f} s over {comps} components "
        f"[{search_stages}]; --cpu-count {t_cpu:.3f} s")
    shutil.rmtree(root)


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
    res, synth = phase_kernels(device)
    for k in kernels.ALL:  # count only what each main path launches
        k.launches = 0
    phase_sketch_heavy(work)
    phase_search_heavy(work, synth)
    launches = {k.name: k.launches for k in (kernels.sketch_kernel, kernels.count_kernel)}
    for k in kernels.ALL:
        k.launches = 0
    phase_wide(work)
    wide = {k.name: k.launches for k in kernels.ALL}
    log(f"[wide] launches on this path: {wide}")
    launches["sketch_wide"] = wide["sketch_wide"]
    for name, n in list(launches.items()) + [("count (wide path)", wide["count"])]:
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
