"""Multi-device / multi-process search: reference DB sharded over a mesh.

The reference has no distributed backend at all (single node, OpenMP +
mmap; SURVEY.md §2). This is the JAX package's parallel/sharded_search.py
on torch devices (a ``parallel.Mesh``). Query code batches are split over
the mesh axis ``dp`` into contiguous query-id blocks; the CSR inverted
index is split over the axis ``ref`` by one of two strategies:

  * ``genome`` (default): each shard owns a contiguous BLOCK OF GENOMES
    (a per-shard CSR over only its genomes' postings, local genome ids)
    and emits the count COLUMNS it alone owns; the global matrix is
    their concatenation, with no reduction.
  * ``code``: each shard owns a contiguous slice of the sorted unique
    code space (balanced by postings mass) over ALL genomes; the
    per-shard partial [n_qry, n_ref] counts are summed.

Components are folded into a single uint64 key space
(key = id << comp_code_bits | component — a bijection of the reference's
(component, in-component id) pair, iseq2comem.c:540-543), so one sharded
index serves all components. Each mesh slot counts its query block
against its shard with the 64-bit-key instances of csrc/count.cu
(``count64``, ``count_koc64`` for ``--koc-out``) on its device; the merge
runs on the host, and across processes through ``parallel``'s
all_gather (genome blocks) and all_reduce (code partials).

Left out on purpose, being TPU workarounds: the uniform shard padding
(the shards here are ragged tensors), the row-gather rank tables
(``_attach_buckets``, ``_window_search``, ``_rowgather_lookup``: the
kernel's binary search replaces them), the per-device pair capacity
(``estimate_capacity``: atomics need no pair budget) and the 22-bit
planes of ``merge_u64`` (a sum of int64 bit views is exact mod 2^64).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from public_kssd_tpu_torch import formats, parallel
from public_kssd_tpu_torch.index import SparseIndex
from public_kssd_tpu_torch.ops import count as count_ops


@dataclasses.dataclass
class ShardedDB:
    """A merged CSR split into ``n_shards`` ragged shards (no padding).

    Shard s holds ascending uint64 keys ``uniq[s]``, int64 offsets
    ``offsets[s]`` [len + 1] from 0, and uint32 ``gids[s]``: global genome
    ids under the ``code`` strategy, ids local to the shard's genome block
    under ``genome``. ``row_bounds`` [S+1] are the shard cut rows of the
    merged CSR (``code``) or the genome-block boundaries, i.e. each shard's
    first count column (``genome``)."""

    uniq: list[np.ndarray]
    offsets: list[np.ndarray]
    gids: list[np.ndarray]
    n_ref: int
    n_shards: int
    row_bounds: np.ndarray

    def columns(self, s: int, strategy: str) -> tuple[int, int]:
        """The global count columns [lo, hi) that shard s writes."""
        if strategy == "genome":
            return int(self.row_bounds[s]), int(self.row_bounds[s + 1])
        return 0, self.n_ref


def merge_components(
    components: list[SparseIndex], comp_code_bits: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fold per-component CSR indices into one uint64-keyed CSR."""
    keys, counts, gids = [], [], []
    for c, sp in enumerate(components):
        keys.append((sp.uniq_codes.astype(np.uint64) << np.uint64(comp_code_bits))
                    | np.uint64(c))
        counts.append(np.diff(sp.offsets).astype(np.int64))
        gids.append(sp.gids)
    key = np.concatenate(keys)
    cnt = np.concatenate(counts)
    gid = np.concatenate(gids)
    order = np.argsort(key, kind="stable")
    key = key[order]
    # reorder postings blocks: build gather of ragged blocks
    starts = np.zeros(cnt.size, dtype=np.int64)
    np.cumsum(cnt[:-1], out=starts[1:])
    from public_kssd_tpu_torch.ops.count import _ragged_indices_np

    gid = gid[_ragged_indices_np(starts[order], cnt[order])]
    cnt = cnt[order]
    offsets = np.zeros(key.size + 1, dtype=np.int64)
    np.cumsum(cnt, out=offsets[1:])
    return key, offsets, gid


def query_keys(
    qry_dir: str, comp_code_bits: int, with_abund: bool = False
):
    """All query codes of a sketch dir as merged uint64 keys + query ids
    (+ per-code uint32 abundances from the ``.a`` files with
    ``with_abund``)."""
    stat = formats.read_co_stat(qry_dir)
    keys, qids, abunds = [], [], []
    for c in range(stat.comp_num):
        if with_abund:
            codes, index, ab = formats.read_combco(qry_dir, c, with_abund=True)
            abunds.append(ab.astype(np.uint32))
        else:
            codes, index = formats.read_combco(qry_dir, c)
        keys.append((codes.astype(np.uint64) << np.uint64(comp_code_bits))
                    | np.uint64(c))
        qids.append(
            np.searchsorted(
                index[1:], np.arange(codes.size, dtype=np.uint64), "right"
            ).astype(np.int32)
        )
    if with_abund:
        return (
            np.concatenate(keys), np.concatenate(qids), np.concatenate(abunds)
        )
    return np.concatenate(keys), np.concatenate(qids)


def build_sharded_db(
    key: np.ndarray, offsets: np.ndarray, gids: np.ndarray,
    n_ref: int, n_shards: int,
) -> ShardedDB:
    """Split a merged CSR into ``n_shards`` contiguous code ranges,
    balanced by postings mass (the JAX package's cut points)."""
    total = int(offsets[-1])
    # balanced split points in postings space -> code-row boundaries
    targets = (np.arange(1, n_shards) * total) // n_shards
    cuts = np.searchsorted(offsets[1:], targets, side="left")
    row_bounds = np.concatenate([[0], cuts, [key.size]]).astype(np.int64)
    uniq, offs, gd = [], [], []
    for s in range(n_shards):
        lo, hi = int(row_bounds[s]), int(row_bounds[s + 1])
        uniq.append(key[lo:hi])
        offs.append((offsets[lo : hi + 1] - offsets[lo]).astype(np.int64))
        gd.append(gids[int(offsets[lo]) : int(offsets[hi])])
    return ShardedDB(uniq=uniq, offsets=offs, gids=gd, n_ref=n_ref,
                     n_shards=n_shards, row_bounds=row_bounds)


def build_genome_sharded_db(
    key: np.ndarray, offsets: np.ndarray, gids: np.ndarray,
    n_ref: int, n_shards: int,
) -> ShardedDB:
    """Split a merged CSR into ``n_shards`` GENOME blocks: shard s owns
    genomes [s*per, (s+1)*per) and carries a per-shard CSR over only the
    codes that have >=1 posting in its block, with LOCAL genome ids.
    ``row_bounds`` here stores the genome-block boundaries (per-shard
    column offsets of the global count matrix)."""
    per = -(-max(n_ref, 1) // n_shards)
    owner = gids // np.uint32(per)
    # row (merged-CSR code index) of every posting; int32 suffices
    # (key.size < 2^31)
    row_of = np.repeat(
        np.arange(key.size, dtype=np.int32), np.diff(offsets).astype(np.int64)
    )
    uniq, offs, gd = [], [], []
    for s in range(n_shards):
        m = owner == s
        rows = row_of[m]
        # postings of one shard keep merged-CSR order: rows is SORTED
        # nondecreasing, so boundary-diff gives the shard CSR without
        # np.unique's re-sort
        if rows.size:
            change = np.empty(rows.size, bool)
            change[0] = True
            np.not_equal(rows[1:], rows[:-1], out=change[1:])
            first = np.flatnonzero(change)
            urows = rows[first]
            counts = np.diff(np.append(first, rows.size))
        else:
            urows = rows.astype(np.int64)
            counts = np.zeros(0, np.int64)
        o = np.zeros(urows.size + 1, dtype=np.int64)
        np.cumsum(counts, out=o[1:])
        uniq.append(key[urows])
        offs.append(o)
        gd.append(gids[m].astype(np.uint32) - np.uint32(s * per))
    bounds = np.minimum(
        np.arange(n_shards + 1, dtype=np.int64) * per, n_ref
    )
    return ShardedDB(uniq=uniq, offsets=offs, gids=gd, n_ref=n_ref,
                     n_shards=n_shards, row_bounds=bounds)


def upload_shards(db: ShardedDB, mesh: parallel.Mesh,
                  strategy: str) -> dict:
    """Each of this process's mesh slots' DB shard as a ``DeviceIndex``
    on the slot's device, keyed (shard, device): a shard that several dp
    rows share on one device is uploaded once."""
    out = {}
    for _, r, dev in mesh.local_slots():
        if (r, dev) not in out:
            lo, hi = db.columns(r, strategy)
            out[(r, dev)] = count_ops.DeviceIndex.from_arrays(
                db.uniq[r], db.offsets[r], db.gids[r], hi - lo, dev
            )
    return out


def sharded_search_counts(
    qry_dir: str,
    components: list[SparseIndex],
    comp_code_bits: int,
    mesh: parallel.Mesh,
    batch: int = 0,
    counts_out: np.ndarray | None = None,
    koc_out: np.ndarray | None = None,
    strategy: str = "genome",
) -> np.ndarray:
    """End-to-end sharded counting of a query sketch dir against CSR
    components; returns uint32 [n_qry, n_ref]. ``comp_code_bits`` is the
    component-fold shift.

    ``batch`` bounds the query rows counted per step (the -m governor:
    the DB shards stay resident, only the per-step count blocks scale
    with the batch); ``counts_out`` (e.g. a np.memmap) receives the rows
    so host RAM stays bounded. ``koc_out`` (uint64 [n_qry, n_ref])
    additionally receives the abundance-weighted counts from the query
    ``.a`` files — the --koc-out table under --mesh, from the same walk.
    ``strategy``: 'genome' (column blocks, default) or 'code' (code-range
    shards, summed partials) — see the module docstring.
    """
    if strategy not in ("genome", "code"):
        raise ValueError(f"unknown sharding strategy {strategy!r}")
    n_ref = components[0].n_genomes
    key, offsets, gids = merge_components(components, comp_code_bits)
    build_db = (
        build_genome_sharded_db if strategy == "genome" else build_sharded_db
    )
    db = build_db(key, offsets, gids, n_ref, mesh.ref)

    if koc_out is not None:
        qk_all, qq_all, qw_all = query_keys(
            qry_dir, comp_code_bits, with_abund=True
        )
    else:
        qk_all, qq_all = query_keys(qry_dir, comp_code_bits)
        qw_all = None
    n_qry_total = formats.read_co_stat(qry_dir).infile_num
    out = (
        counts_out
        if counts_out is not None
        else np.zeros((n_qry_total, n_ref), dtype=np.uint32)
    )
    # DB shards go on their devices ONCE; query batches stream against them
    db_dev = upload_shards(db, mesh, strategy)
    batch = batch or n_qry_total
    for b0 in range(0, n_qry_total, batch):
        b1 = min(b0 + batch, n_qry_total)
        m = (qq_all >= b0) & (qq_all < b1)
        blk = _sharded_count_block(
            qk_all[m], qq_all[m] - b0, b1 - b0, db, db_dev, mesh,
            qw=qw_all[m] if qw_all is not None else None,
            strategy=strategy,
        )
        if koc_out is not None:
            out[b0:b1], koc_out[b0:b1] = blk
        else:
            out[b0:b1] = blk[0]
    return out


def _sharded_count_block(
    qk, qq, n_qry: int, db: ShardedDB, db_dev: dict, mesh: parallel.Mesh,
    qw=None, strategy: str = "code",
):
    """Count one contiguous block of queries (LOCAL ids [0, n_qry)) against
    the resident DB shards; returns ``(uint32 counts,)``, or the (uint32
    counts, uint64 koc) pair when ``qw`` carries abundances.

    Every local slot's kernel is launched before any result is fetched,
    so slots on different cards run at the same time."""
    per_dp = -(-n_qry // mesh.dp)
    queries = {}  # dp block -> (its query rows, tensors per device)
    launched = []
    for d, r, dev in mesh.local_slots():
        qlo, qhi = d * per_dp, min((d + 1) * per_dp, n_qry)
        if qhi <= qlo:
            continue
        rows, on_dev = queries.setdefault(d, ((qlo, qhi), {}))
        if dev not in on_dev:
            m = (qq >= qlo) & (qq < qhi)
            on_dev[dev] = [
                count_ops._key_view(qk[m]).to(dev),
                torch.from_numpy((qq[m] - qlo).astype(np.int32)).to(dev),
            ] + ([count_ops._u32_view(qw[m]).to(dev)] if qw is not None else [])
        index = db_dev[(r, dev)]
        if qw is not None:
            res = count_ops.count_shared_koc_kernel(
                *on_dev[dev], index, qhi - qlo
            )
        else:
            res = (count_ops.count_shared_kernel(*on_dev[dev], index, qhi - qlo),)
        launched.append((rows, db.columns(r, strategy), res))
    outs = [np.zeros((n_qry, db.n_ref), np.uint32)]
    if qw is not None:
        outs.append(np.zeros((n_qry, db.n_ref), np.uint64))
    blocks = []
    for (qlo, qhi), (c0, c1), res in launched:
        for k, (o, t) in enumerate(zip(outs, res)):
            part = t.cpu().numpy().view(o.dtype)
            if strategy == "genome":
                blocks.append((k, qlo, qhi, c0, c1, part))
                o[qlo:qhi, c0:c1] = part
            else:
                o[qlo:qhi] += part
    if parallel.process_count() > 1:
        if strategy == "genome":
            # each block is owned by exactly one slot: gather them
            for got in parallel.all_gather_objects(blocks):
                for k, qlo, qhi, c0, c1, part in got:
                    outs[k][qlo:qhi, c0:c1] = part
        else:
            for o in outs:
                parallel.all_reduce_sum(o)
    return tuple(outs)
