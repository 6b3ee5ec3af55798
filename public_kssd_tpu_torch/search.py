"""Search: query sketch dir vs reference index dir -> distance.out.

Orchestrates the counting kernel over components and the statistics
printer; mirrors mco_cbdco_nobin_dist (command_dist.c:670-808) +
dist_print_nobin (:1161-1250) including the sharedk_ct.dat artifact
(--keepskf / -f resume, command_dist.c:735-738, 1164, 1249), the -m
memory-governed query batching (:707-768), and the opt-in koc
(abundance-weighted) output appendix (koc_dist_print_nobin,
command_dist.c:1080-1160 — dead code in the reference, see
ops/stats.format_koc_pair_line). Counting runs on a torch device
(csrc/count.cu on a CUDA card, the default) or, with ``device=None``,
in the host oracle; with a ``parallel.Mesh`` it runs DB-sharded over
the mesh's devices (parallel/sharded_search.py).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from public_kssd_tpu_torch import (formats, index as index_mod, resolve_device,
                                   stattab, utils)
from public_kssd_tpu_torch.ops import count as count_ops
from public_kssd_tpu_torch.ops import stats as stats_ops

PAGE_SZ = 4096  # reference batches in sysconf(_SC_PAGESIZE) units (:747)


class ShufIdMismatch(ValueError):
    pass


def query_batch_size(n_qry: int, n_ref: int, mem_gb: float) -> int:
    """Queries per counting batch under the -m budget: the reference's
    num_cof_batch = (mem/(ref_num*4*page_sz)) * page_sz (command_dist.c:
    745-752, where the unit is pages of the mmap'ed count matrix)."""
    if mem_gb <= 0:
        return n_qry
    num_unit_mem = int(mem_gb * 1e9) // (n_ref * 4 * PAGE_SZ)
    return max(min(num_unit_mem * PAGE_SZ, n_qry), 1)


def compute_shared_counts(
    qry_dir: str,
    ref_components: list,
    n_qry: int,
    device: torch.device | str | None = "cuda",
    counts_out: np.ndarray | None = None,
    batch: int = 0,
    koc_out: np.ndarray | None = None,
) -> np.ndarray:
    """Sum shared-code counts across components -> uint32 [n_qry, n_ref].

    ``ref_components`` are ``index.SparseIndex`` objects, or on a device
    the ``ops.count.DeviceIndex`` objects of ``index.load_device_index``.
    ``device`` runs the counting there: a card by default (raising when
    none is visible), ``"cpu"`` for the plain PyTorch path, ``None`` for
    the host oracle; each batch of query rows is summed over the
    components where it was counted and copied once into its rows of
    the result. ``counts_out``
    (e.g. a np.memmap over sharedk_ct.dat) bounds host RAM the way the
    reference's mmap does; ``batch`` bounds the query rows materialised
    per device call; ``koc_out`` additionally receives abundance-weighted
    counts from the query ``.a`` files, made in the same walk of the
    index (``count_ops.count_shared_tensors``).
    """
    if device is not None:
        device = resolve_device(device)
    n_ref = ref_components[0].n_genomes
    counts = (
        counts_out
        if counts_out is not None
        else np.empty((n_qry, n_ref), dtype=np.uint32)
    )
    span = torch.profiler.record_function
    with span("count.queries"):
        sketches = [formats.read_combco(qry_dir, c, with_abund=koc_out is not None)
                    for c in range(len(ref_components))]
    batch = batch or n_qry
    for q0 in range(0, n_qry, batch):
        q1 = min(q0 + batch, n_qry)
        total = None
        for sp, (codes, idx, *abund) in zip(ref_components, sketches):
            lo, hi = int(idx[q0]), int(idx[q1])
            part = count_ops.count_shared_tensors(
                codes[lo:hi], idx[q0 : q1 + 1] - idx[q0], sp, q1 - q0, device,
                abund[0][lo:hi].astype(np.uint32) if abund else None,
            )
            # int32 / int64 bit views: the sums wrap as uint32 / uint64 do
            total = part if total is None else [t.add_(p) for t, p in zip(total, part)]
        with span("count.fetch"):
            torch.from_numpy(counts[q0:q1].view(np.int32)).copy_(total[0])
            if koc_out is not None:
                torch.from_numpy(koc_out[q0:q1].view(np.int64)).copy_(total[1])
    return counts


def search(
    ref_dir: str,
    qry_dir: str,
    out_dir: str,
    opts: stats_ops.OutputOptions | None = None,
    device: torch.device | str | None = "cuda",
    keep_shared_kmer: bool = False,
    shared_kmer_path: str | None = None,
    mesh=None,
    component_sz: int = 7,
    mem_gb: float = 0.0,
    koc: bool = False,
    shard_strategy: str = "genome",
    threads: int = 0,
    ready=None,
) -> str:
    """Full search -> ``<out_dir>/distance.out``; returns its path.

    ``shared_kmer_path`` (-f) skips counting and reprints statistics from
    a saved sharedk_ct.dat matrix; ``keep_shared_kmer`` (--keepskf)
    writes the matrix there and keeps it. ``mem_gb`` (-m) batches
    queries through counting and disk-backs the count matrix (that file,
    removed after printing unless kept) so peak RAM is bounded by the
    budget, not the DB size; with neither, no file is written.
    ``device`` runs the counting there: a card by default (raising when
    none is visible, before any work), ``"cpu"`` for the plain PyTorch
    path, ``None`` for the host oracle.
    ``koc`` appends the abundance-weighted table when the query dir
    carries ``.a`` files.
    With ``mesh`` (a ``parallel.Mesh``; it takes the place of ``device``)
    counting runs DB-sharded over its devices by ``shard_strategy``
    ('genome' or 'code'), components folded into one key space.
    ``threads`` (-p) format ``distance.out``; 0 = every CPU this process
    may use. The output does not depend on it. ``ready`` (a function of
    no arguments) is called after the stat files are read and before the
    first device call: the CLI waits there for the card's start
    (``start.CardStart.join``).
    """
    if mesh is not None:
        from public_kssd_tpu_torch import parallel

        if not isinstance(mesh, parallel.Mesh):
            raise TypeError(
                f"mesh must be a public_kssd_tpu_torch.parallel.Mesh, not "
                f"{type(mesh).__name__}"
            )
    elif isinstance(device, str):
        # a name ("cuda", the default) is resolved before any work, so a
        # host with no card raises here; a torch.device (the CLI's, which
        # it resolved) is checked at its first device call, after ``ready``
        device = resolve_device(device)
    opts = opts or stats_ops.OutputOptions()
    timer = utils.TracedStageTimer()
    # each stat file read once, its names in bulk (the print formats
    # them from the table's rows)
    mco_stat = stattab.read_mco_stat_table(ref_dir)
    qry_stat = stattab.read_co_stat_table(qry_dir)
    if qry_stat.params_id != mco_stat.params_id:
        raise ShufIdMismatch(
            f"qry shuf_id {qry_stat.params_id} != ref shuf_id {mco_stat.params_id}"
        )
    if qry_stat.comp_num != mco_stat.comp_num:
        raise ValueError(
            f"qry comp_num {qry_stat.comp_num} != ref comp_num {mco_stat.comp_num}"
        )
    os.makedirs(out_dir, exist_ok=True)
    n_qry, n_ref = qry_stat.infile_num, mco_stat.infile_num
    skf = shared_kmer_path or os.path.join(out_dir, "sharedk_ct.dat")
    koc = koc and qry_stat.koc
    if koc and shared_kmer_path:
        # sharedk_ct.dat holds only the unweighted counts: the weighted
        # table cannot be reconstructed on a -f reprint (silently writing
        # all-zero abundances would be a bogus koc appendix)
        raise ValueError(
            "--koc-out cannot be combined with -f (resume from "
            "sharedk_ct.dat): abundance-weighted counts are not stored "
            "in the shared-k matrix; rerun the full search with --koc-out"
        )
    koc_counts = np.empty((n_qry, n_ref), dtype=np.uint64) if koc else None
    if ready is not None:
        ready()
    if shared_kmer_path:
        counts = np.fromfile(skf, dtype="<u4").reshape(n_qry, n_ref)
    else:
        with timer.stage("load_index"):
            # one device loads the index straight onto itself; the mesh
            # builds its shards on its devices from the directory, in the
            # count stage; the host oracle reads host arrays
            if mesh is None and device is not None:
                _, comps = index_mod.load_device_index(ref_dir, device, mco_stat)
            elif mesh is None:
                _, comps = index_mod.load_sparse_index(ref_dir)
        with timer.stage("count"):
            # the count matrix is disk-backed under -m, exactly like
            # the reference's ftruncate+mmap (command_dist.c:742-748)
            if mem_gb > 0:
                counts = np.memmap(
                    skf, dtype="<u4", mode="w+", shape=(n_qry, n_ref)
                )
            else:  # every row is written whole
                counts = np.empty((n_qry, n_ref), dtype=np.uint32)
            batch = query_batch_size(n_qry, n_ref, mem_gb)
            if mesh is not None:
                from public_kssd_tpu_torch.parallel import sharded_search

                # component-fold shift straight from the stat geometry
                # (comp_num = 16^(k-l-CSZ)): no fabricated SketchParams
                comp_code_bits = max(
                    4 * (mco_stat.kmerlen // 2 - mco_stat.dim_rd_len // 2
                         - component_sz), 0,
                )
                if (1 << comp_code_bits) < mco_stat.comp_num:
                    raise ValueError(
                        f"{mco_stat.comp_num} components do not fit "
                        f"{comp_code_bits} fold bits: wrong --component-sz?"
                    )
                sharded_search.sharded_search_counts(
                    qry_dir, ref_dir, comp_code_bits, mesh, batch=batch,
                    counts_out=counts, koc_out=koc_counts,
                    strategy=shard_strategy,
                )
            else:
                compute_shared_counts(
                    qry_dir, comps, n_qry, device, counts_out=counts,
                    batch=batch, koc_out=koc_counts,
                )
            with torch.profiler.record_function("count.skf"):
                if isinstance(counts, np.memmap):
                    counts.flush()
                elif keep_shared_kmer:
                    counts.astype("<u4", copy=False).tofile(skf)

    out_path = os.path.join(out_dir, "distance.out")
    with timer.stage("print"):
        threads = stats_ops.write_distance_out(
            out_path,
            counts,
            mco_stat.ctx_ct,
            qry_stat.ctx_ct,
            mco_stat.names,
            qry_stat.names,
            qry_stat.kmerlen,
            qry_stat.dim_rd_len,
            opts,
            threads=threads,
        )
        if koc_counts is not None:
            stats_ops.write_koc_distance_out(
                out_path, counts, koc_counts,
                mco_stat.ctx_ct, qry_stat.ctx_ct,
                mco_stat.names, qry_stat.names,
                qry_stat.kmerlen, qry_stat.dim_rd_len,
            )
    if not shared_kmer_path:
        pairs = int(n_qry) * int(n_ref)
        dt = timer.stages["count"][0]
        utils.log.info(
            "search: %d x %d pairs in %.3fs (%.0f pairs/s), print threads %d "
            "[%s]",
            n_qry, n_ref, dt, pairs / dt if dt else 0.0, threads, timer.report(),
        )
    if isinstance(counts, np.memmap) and not keep_shared_kmer:
        del counts  # -m's disk-backed matrix, not asked to be kept
        os.remove(skf)
    return out_path
