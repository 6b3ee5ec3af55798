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
    slot reads only its slice of the DB's combco files straight onto its
    device (``_slot_db``: ``index.combco_on_device``, the index loader's
    pinned staging and threads), folds it there and makes each
    JOIN_CHUNK's genome ids there (``composite._genome_ids``), and joins
    the chunk against the query table on its device with the 64-bit-key
    instance of csrc/join.cu (``join64``), which sizes its output
    exactly: no capacity, no retry, no padding;
  * the query table is made on the first local slot's device
    (``_fold_queries_device``: two stable sorts and a compare of
    neighbours) and copied to the other devices;
  * the packed hit keys ``qid << shift | rid << 16 | abundance`` stay on
    the devices in one process; across processes they are gathered with
    ``parallel.all_gather_objects`` and uploaded again;
  * per-(query, ref) count/sum/median/percentile statistics run on the
    first local slot's device (composite._hits_to_stats_torch: one sort
    of the keys there, or one a key range past its free memory; only the
    per-(query, ref) aggregates come back),
    so the report text is integer-exact vs every other backend by
    construction.

The JAX package's host folds (``FOLD_SHIFT``, ``_fold_ref``,
``_fold_queries``, ``_shard_db``) have no copy here; the tests hold the
device folds to them.
"""

from __future__ import annotations

import os

import torch

from public_kssd_tpu_torch import composite, formats, index as index_mod, parallel
from public_kssd_tpu_torch.ops import count as count_ops


def _slot_db(ref_dir: str, stat: formats.CoStat, r: int, n_shards: int,
             device: torch.device):
    """Slot ``r``'s slice of the folded DB (``stat``: its stat, as read),
    the JAX package's ``_shard_db`` position cut (ceil(size / n_shards)
    entries a slice) of its ``_fold_ref`` order, made on ``device``:
    yields (keys int64, genome ids int32) a ``JOIN_CHUNK`` at most. Only
    the components the slice overlaps are read, and of each only the
    codes in it with the component's whole index
    (``index.combco_on_device``); the genome ids come from the index
    there (``composite._genome_ids``). Spans: ``mesh.upload`` around
    ``mesh.read`` and ``mesh.wait``; ``mesh.fold``."""
    sizes = [index_mod.check_combco(ref_dir, c, stat.infile_num)
             for c in range(stat.comp_num)]
    per = -(-max(sum(sizes), 1) // n_shards)
    lo, hi = r * per, (r + 1) * per
    parts, at = [], 0
    for c, n in enumerate(sizes):
        a, b = max(lo - at, 0), min(hi - at, n)
        if b > a:
            parts.append((c, a, b))
        at += n
    todo = iter(parts)
    for g in index_mod.combco_on_device(ref_dir, parts, stat.infile_num, device,
                                        "mesh"):
        at = 0
        for i, n in enumerate(g.sizes):
            c, a, b = next(todo)
            codes, ends = g.codes[at:at + n], g.index[i, 1:]
            at += n
            for c0 in range(a, b, composite.JOIN_CHUNK):
                c1 = min(c0 + composite.JOIN_CHUNK, b)
                with torch.profiler.record_function("mesh.fold"):
                    keys = count_ops._widen(codes[c0 - a:c1 - a]) | (c << 32)
                    rid = composite._genome_ids(ends, c0, c1)
                yield keys, rid
                del keys, rid
        # the group's buffer goes before the next group is read
        g = codes = ends = None


def _fold_queries_device(qry_dir: str, device: torch.device):
    """The JAX package's ``_fold_queries`` made on ``device``: (folded
    keys int64 ascending, query ids int32, abundances int32), the
    duplicates of a (key, query) dropped but the first. The combco files
    are read straight onto the device (``index.combco_on_device``) and
    folded a group of components at a time; one stable sort by query id
    and one stable sort by key (sign bit flipped: unsigned order) leave
    the entries in (key, query, position) order, as ``_fold_queries``'
    lexsort does, and a compare of neighbours keeps the first of each
    run."""
    stat = formats.read_co_stat(qry_dir)
    keys, qids, abunds = [], [], []
    for g in index_mod.combco_on_device(
            qry_dir, [(c, 0, None) for c in range(stat.comp_num)], stat.infile_num,
            device, "mesh", abund=True):
        with torch.profiler.record_function("mesh.fold"):
            part = g.part_of()
            comp = torch.tensor(g.comps, dtype=torch.int64, device=device)[part]
            keys.append(count_ops._widen(g.codes) | (comp << 32))
            qids.append(g.sketch_ids(part))
            abunds.append(g.abund.to(torch.int32) & 0xFFFF)
        del g, part, comp  # before the next group is read
    with torch.profiler.record_function("mesh.fold"):
        k, q, a = (torch.cat(ts) for ts in (keys, qids, abunds))
        del keys, qids, abunds
        order = torch.sort(q, stable=True).indices
        order = order[torch.sort(k[order] ^ count_ops._SIGN64, stable=True).indices]
        k, q, a = k[order], q[order], a[order]
        keep = torch.ones(k.numel(), dtype=torch.bool, device=device)
        keep[1:] = (k[1:] != k[:-1]) | (q[1:] != q[:-1])
        return k[keep], q[keep], a[keep]


def species_abundance_sharded(
    ref_dir: str,
    qry_dir: str,
    mesh: parallel.Mesh,
    out_dir: str | None = None,
    binvec: bool = False,
) -> str:
    """Mesh-sharded twin of composite.species_abundance; identical report
    text (same integer aggregates, same shared report tail). ``mesh`` is
    1 x S: queries are not split, the DB is split over its S slots, each
    slot's slice read and folded on its device (``_slot_db``); the query
    table is made on the first local slot's device
    (``_fold_queries_device``) and copied to the others. No part of the
    DB or the query table is built on the host."""
    if mesh.dp != 1:
        raise ValueError(f"composite shards the DB only: mesh must be 1 x S, "
                         f"not {mesh.dp} x {mesh.ref}")
    qry_stat = formats.read_co_stat(qry_dir)
    if not qry_stat.koc:
        raise ValueError("get_species_abundance(): query has not abundance")
    n_qry = qry_stat.infile_num
    ref_stat = formats.read_co_stat(ref_dir)
    n_ref = ref_stat.infile_num
    qid_shift = 16 + max(int(n_ref).bit_length(), 1)
    composite._check_key_width(qid_shift, n_qry)

    span = torch.profiler.record_function
    slots = mesh.local_slots()
    first = slots[0][2] if slots else torch.device("cpu")
    # the query table and its directory per device, built once there
    tables: dict[torch.device, tuple] = {}
    parts: list[torch.Tensor] = []
    for _, r, dev in slots:
        if dev not in tables:
            with span("mesh.table"):
                if not tables:
                    table = _fold_queries_device(qry_dir, dev)
                    max_key = int(table[0][-1]) if table[0].numel() else 0
                else:
                    table = tuple(t.to(dev) for t in next(iter(tables.values()))[0])
                tables[dev] = (table, composite.query_directory(table[0], max_key))
        table, qdir = tables[dev]
        for keys, rid in _slot_db(ref_dir, ref_stat, r, mesh.ref, dev):
            parts.append(composite.join_kernel(keys, None, rid, *table,
                                               qid_shift, qdir))
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
    with span("mesh.report"):
        for qn in range(n_qry):
            composite.append_query_report(
                lines, stats_all[qn], qn, ref_stat, qry_stat, binvec,
                out_dir or os.path.join(ref_dir, composite.BINVEC_DIRNAME),
                write_files=write_files,
            )
    return "".join(lines)
