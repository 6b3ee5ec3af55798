"""Mesh-sharded composite: the -q abundance join's reference DB sharded
over a device mesh (the JAX package's parallel/sharded_composite.py on
torch devices).

The reference's composite hot loop probes every reference genome's codes
against a per-query abundance hash with OpenMP threads on one node
(get_species_abundance, command_composite.c:464-481). The single-device
path (composite.py) joins the whole DB against ONE combined sorted query
table for all queries; this module shards that join over the ``ref``
axis of a 1 x S mesh:

  * the DB's (code, ref-id) pairs — components folded into uint64 keys
    ``comp << 32 | code`` — are split by position over the S shards; each
    slot joins its slice (in JOIN_CHUNK pieces) against the query table
    on its device with the 64-bit-key instance of csrc/join.cu
    (``join64``), which sizes its output exactly: no capacity, no retry,
    no padding;
  * the packed hit keys ``qid << shift | rid << 16 | abundance`` stay on
    the devices in one process; across processes they are gathered with
    ``parallel.all_gather_objects`` and uploaded again;
  * per-(query, ref) count/sum/median/percentile statistics run on the
    first local slot's device (composite._hits_to_stats_torch: one sort
    of the keys there, or one a key range past its free memory; only the
    per-(query, ref) aggregates come back),
    so the report text is integer-exact vs every other backend by
    construction.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from public_kssd_tpu_torch import composite, formats, parallel

FOLD_SHIFT = np.uint64(32)  # component in the high bits, code in the low


def _fold_ref(ref_dir: str) -> tuple[np.ndarray, np.ndarray, int]:
    """(keys uint64 [total], rid int32 [total], n_ref): all components'
    codes folded into one key space with their owning genome ids."""
    stat = formats.read_co_stat(ref_dir)
    keys, rids = [], []
    for c in range(stat.comp_num):
        codes, index = formats.read_combco(ref_dir, c)
        keys.append(
            (np.uint64(c) << FOLD_SHIFT) | codes.astype(np.uint64)
        )
        rids.append(
            np.searchsorted(
                index[1:], np.arange(codes.size, dtype=np.uint64), "right"
            ).astype(np.int32)
        )
    return np.concatenate(keys), np.concatenate(rids), stat.infile_num


def _fold_queries(qry_dir: str):
    """Combined query table over ALL queries and components: folded
    uint64 keys sorted ascending, with aligned query ids + abundances.
    Duplicate (query, code) pairs keep the FIRST occurrence — a sketch
    is a set (the reference hash-dedups before probing,
    command_composite.c:453-463), matching the host oracle exactly."""
    stat = formats.read_co_stat(qry_dir)
    ks, qs, abs_ = [], [], []
    for c in range(stat.comp_num):
        codes, index, abund = formats.read_combco(qry_dir, c, with_abund=True)
        ks.append((np.uint64(c) << FOLD_SHIFT) | codes.astype(np.uint64))
        qs.append(
            np.searchsorted(
                index[1:], np.arange(codes.size, dtype=np.uint64), "right"
            ).astype(np.int32)
        )
        abs_.append(abund.astype(np.uint32))
    k = np.concatenate(ks)
    q = np.concatenate(qs)
    a = np.concatenate(abs_)
    order = np.lexsort((np.arange(k.size), q, k))
    k, q, a = k[order], q[order], a[order]
    if k.size:
        keep = np.ones(k.size, bool)
        keep[1:] = (k[1:] != k[:-1]) | (q[1:] != q[:-1])
        k, q, a = k[keep], q[keep], a[keep]
    return k, q, a


def _shard_db(keys: np.ndarray, rids: np.ndarray, n_shards: int):
    """The folded DB split by position into ``n_shards`` contiguous
    slices [(keys, rids), ...] of ceil(size / n_shards) entries (the last
    ones shorter or empty): ragged, so there is no pad key."""
    per = -(-max(keys.size, 1) // n_shards)
    return [
        (keys[s * per : (s + 1) * per], rids[s * per : (s + 1) * per])
        for s in range(n_shards)
    ]


def species_abundance_sharded(
    ref_dir: str,
    qry_dir: str,
    mesh: parallel.Mesh,
    out_dir: str | None = None,
    binvec: bool = False,
) -> str:
    """Mesh-sharded twin of composite.species_abundance; identical report
    text (same integer aggregates, same shared report tail). ``mesh`` is
    1 x S: queries are not split, the DB is split over its S slots."""
    if mesh.dp != 1:
        raise ValueError(f"composite shards the DB only: mesh must be 1 x S, "
                         f"not {mesh.dp} x {mesh.ref}")
    qry_stat = formats.read_co_stat(qry_dir)
    if not qry_stat.koc:
        raise ValueError("get_species_abundance(): query has not abundance")
    n_qry = qry_stat.infile_num
    ref_stat = formats.read_co_stat(ref_dir)
    keys, rids, n_ref = _fold_ref(ref_dir)
    shards = _shard_db(keys, rids, mesh.ref)
    sq, sqid, sab = _fold_queries(qry_dir)
    qid_shift = 16 + max(int(n_ref).bit_length(), 1)
    composite._check_key_width(qid_shift, n_qry)

    host_table = [torch.from_numpy(a) for a in (
        sq.view(np.int64), sqid.astype(np.int32),
        sab.astype(np.uint32).view(np.int32))]
    max_key = int(sq[-1]) if sq.size else 0
    # the query table and its directory per device, built once there
    tables: dict[torch.device, tuple] = {}
    parts: list[torch.Tensor] = []
    slots = mesh.local_slots()
    for _, r, dev in slots:
        if dev not in tables:
            t = tuple(a.to(dev) for a in host_table)
            tables[dev] = (t, composite.query_directory(t[0], max_key,
                                                        host_table[0]))
        table, qdir = tables[dev]
        k, rid = shards[r]
        for c0 in range(0, k.size, composite.JOIN_CHUNK):
            c1 = min(c0 + composite.JOIN_CHUNK, k.size)
            parts.append(composite.join_kernel(
                torch.from_numpy(k[c0:c1].view(np.int64)).to(dev), None,
                torch.from_numpy(rid[c0:c1]).to(dev), *table, qid_shift, qdir,
            ))
    first = slots[0][2] if slots else torch.device("cpu")
    if parallel.process_count() > 1:
        hits = [t.cpu().numpy() for t in parts]
        parts = [torch.from_numpy(h).to(first)
                 for got in parallel.all_gather_objects(hits) for h in got]
    stats_all = composite._hits_to_stats_torch(parts, n_qry, n_ref, qid_shift,
                                               first)
    # every process reaches this tail with identical gathered hits; the
    # .abv SIDE-EFFECT writes must happen once (concurrent identical
    # writes race on shared filesystems), so only process 0 writes —
    # every process still returns the same report text
    write_files = parallel.process_index() == 0
    lines: list[str] = []
    for qn in range(n_qry):
        composite.append_query_report(
            lines, stats_all[qn], qn, ref_stat, qry_stat, binvec,
            out_dir or os.path.join(ref_dir, composite.BINVEC_DIRNAME),
            write_files=write_files,
        )
    return "".join(lines)
