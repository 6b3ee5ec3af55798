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

The shards are built on the slots' devices (``device_shards``) with the
JAX package's cut rows, keys, offsets and ids: the index directory's
row ranges are read onto each device a bounded group at a time
(``index.CsrSlices``: pinned staging, read threads, no host copy),
folded, split and sorted there with torch calls, and only the shards
stay. The query keys of each dp block are sliced from the query sketch
read onto the device (``DeviceQueries``), and each count block is
fetched through pinned staging straight into its place in the result.
The JAX package's numpy construction (``merge_components``,
``build_sharded_db``, ``build_genome_sharded_db``, ``query_keys``) has
no copy here; the tests hold the device construction to it.

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

from public_kssd_tpu_torch import formats, index as index_mod, parallel
from public_kssd_tpu_torch.ops import count as count_ops
from public_kssd_tpu_torch.ops import staging

# the code strategy's cut search: row counts and postings of the folded
# keys by the top CUT_BUCKET_BITS bits of their 32-bit code
CUT_BUCKET_BITS = 20


def _fold(uniq: torch.Tensor, c, bits: int) -> torch.Tensor:
    """int64 bit views of the folded keys ``code << bits | c`` of int32
    bit views of uint32 codes (int64 shifts wrap: the uint64 pattern);
    ``c`` an int or the component of each code."""
    return (count_ops._widen(uniq) << bits) | c


def _ragged(starts: torch.Tensor, lens: torch.Tensor, total: int) -> torch.Tensor:
    """[s0..s0+l0) ++ [s1..s1+l1) ++ ... as one int64 index tensor."""
    seg = torch.cumsum(lens, 0) - lens
    return torch.repeat_interleave(starts - seg, lens, output_size=total) + (
        torch.arange(total, dtype=torch.int64, device=starts.device))


@dataclasses.dataclass
class DeviceShards:
    """This process's DB shards, each a ``DeviceIndex`` over folded keys
    on its slot's device, keyed (shard, device): a shard that several dp
    rows share on one device is built once. ``row_bounds`` [S+1]: the
    shard cut rows of the merged CSR (``code``; None in a process without
    a slot) or the genome-block boundaries, i.e. each shard's first count
    column (``genome``)."""

    index: dict
    row_bounds: np.ndarray | None
    n_ref: int
    n_shards: int
    strategy: str

    def columns(self, s: int) -> tuple[int, int]:
        """The global count columns [lo, hi) that shard s writes."""
        if self.strategy == "genome":
            return int(self.row_bounds[s]), int(self.row_bounds[s + 1])
        return 0, self.n_ref


def _assemble(pieces: list, n_ref: int, device: torch.device, ascending: bool):
    """One shard's ``DeviceIndex`` from its pieces (folded keys int64,
    postings a key int64, genome ids int32), their keys disjoint: unless
    the pieces' keys are ``ascending`` one after another, one sort of the
    keys (sign bit flipped: unsigned order) and a ragged gather of the
    ids."""
    if not pieces:
        empty64 = torch.zeros(0, dtype=torch.int64, device=device)
        pieces = [(empty64, empty64, torch.zeros(0, dtype=torch.int32,
                                                 device=device))]
    keys, counts, gids = (torch.cat(ts) if len(ts) > 1 else ts[0]
                          for ts in zip(*pieces))
    total = int(gids.numel())
    if not ascending:
        order = torch.sort(keys ^ count_ops._SIGN64).indices
        starts = (torch.cumsum(counts, 0) - counts)[order]
        keys, counts = keys[order], counts[order]
        gids = gids[_ragged(starts, counts, total)]
    offsets = torch.zeros(keys.numel() + 1, dtype=torch.int64, device=device)
    torch.cumsum(counts, 0, out=offsets[1:])
    small = keys.numel() <= count_ops.HOST_DIRECTORY_KEYS
    host_keys = keys.cpu() if small else None
    max_key = (int((host_keys if small else keys)[-1]) % (1 << 64)
               if keys.numel() else 0)
    # the tensors' own device: "cuda" of a mesh is made "cuda:0" there
    return count_ops.DeviceIndex.checked(keys, offsets, gids, n_ref, keys.device,
                                         total=total, max_key=max_key,
                                         host_keys=host_keys)


def _folded(groups, bits: int):
    """Each ``index.CsrGroup`` of ``groups`` as one CSR of folded keys:
    (keys ``code << bits | c`` int64, postings a row int64, genome ids
    int32), ascending within each range of rows only."""
    for g in groups:
        with torch.profiler.record_function("mesh.fold"):
            folded = _fold(g.uniq, g.comp, bits), g.counts, g.gids
        del g  # before the next group is read
        yield folded
        del folded


def _row_of(counts: torch.Tensor, total: int) -> torch.Tensor:
    """int32 [total]: the row of each posting of a CSR."""
    return torch.repeat_interleave(
        torch.arange(counts.numel(), dtype=torch.int32, device=counts.device),
        counts, output_size=total)


def _genome_pieces(folded, shards: list[int], per: int, pieces: dict) -> None:
    """Add a folded group (``_folded``) to the pieces of the genome-block
    shards ``shards``: the postings of shard s's genomes [s*per,
    (s+1)*per), their rows' keys (the change points of their rows, which
    keep the group's order) and their ids less s*per."""
    keys, counts, gids = folded
    row_of = _row_of(counts, gids.numel())
    for s in shards:
        sel = torch.nonzero((gids >= s * per) & (gids < (s + 1) * per)).flatten()
        rows = row_of[sel]
        n = rows.numel()
        change = torch.ones(n, dtype=torch.bool, device=rows.device)
        torch.ne(rows[1:], rows[:-1], out=change[1:])
        first = torch.nonzero(change).flatten()
        lens = torch.diff(first, append=first.new_tensor([n]))
        pieces[s].append((keys[rows[first]], lens, gids[sel] - s * per))


def _code_pieces(folded, shards: list[int], edges: list, pieces: dict) -> None:
    """Add a folded group (``_folded``) of rows between the cut keys of
    the code-range shards ``shards`` to their pieces: shard s takes the
    rows whose key is in [edges[s], edges[s + 1]) (unsigned; None: no
    bound), with their postings; the ids are copied out of the group's
    buffer, which goes."""
    keys, counts, gids = folded
    if len(shards) == 1:  # every row is the shard's
        pieces[shards[0]].append((keys, counts, gids.clone()))
        return
    row_of = _row_of(counts, gids.numel())
    ordered = keys ^ count_ops._SIGN64  # u - 2^63 for an unsigned key u
    for s in shards:
        m = torch.ones(keys.numel(), dtype=torch.bool, device=keys.device)
        if edges[s] is not None:
            m &= ordered >= edges[s] - (1 << 63)
        if edges[s + 1] is not None:
            m &= ordered < edges[s + 1] - (1 << 63)
        pieces[s].append((keys[m], counts[m], gids[m[row_of]]))


def _cut_keys(csr: index_mod.CsrSlices, device: torch.device, n_shards: int,
              bits: int) -> tuple[np.ndarray, list]:
    """The code strategy's cuts, made on ``device``: (the cut rows of the
    merged CSR [n_shards + 1], int64 on the host, as the JAX package's
    ``build_sharded_db`` cuts it: ``searchsorted(offsets[1:], j * total
    // n_shards)``; the folded key at each inner cut row, as Python ints
    of the unsigned keys).

    Key order is code order first, so the postings and rows of every
    component are counted by the top ``CUT_BUCKET_BITS`` bits of their
    code, from their codes and offsets alone (no postings read); the
    cumulative postings put each target in one bucket. A bucket's rows
    are one row range of each component, found by a search of its codes
    on the host (``CsrSlices.rows_below``); those rows alone are read
    again and sorted by key to place the cut in its bucket."""
    comps = range(csr.stat.comp_num)
    nb = 1 << CUT_BUCKET_BITS
    shift = 32 - CUT_BUCKET_BITS
    mass = torch.zeros(nb, dtype=torch.int64, device=device)
    rows = torch.zeros(nb, dtype=torch.int64, device=device)
    for g in csr.groups(device, postings=False):
        b = count_ops._widen(g.uniq) >> shift
        mass.index_add_(0, b, g.counts)
        rows += torch.bincount(b, minlength=nb)
        del g, b  # before the next group is read
    cm, cr = torch.cumsum(mass, 0), torch.cumsum(rows, 0)
    total, nnz = (int(x) for x in torch.stack([cm[-1], cr[-1]]).tolist())
    targets = [j * total // n_shards for j in range(1, n_shards)]
    live = [t for t in targets if t > 0]
    cut_rows, cut_keys = [0], []
    if live:
        t = torch.tensor(live, dtype=torch.int64, device=device)
        b = torch.searchsorted(cm, t)
        b_host, below_m, below_r = (x.tolist() for x in (
            b, (cm - mass)[b], (cr - rows)[b]))
        ranges, want = [], sorted(set(b_host))
        # each wanted bucket b's rows: codes [b << shift, (b + 1) << shift)
        for c in comps:
            ends = csr.code_rows(c, [x << shift for bk in want for x in (bk, bk + 1)
                                     if x < nb]) + [csr.rows(c)]
            ranges += [(c, r0, r1) for r0, r1 in zip(ends[::2], ends[1::2]) if r1 > r0]
        found: tuple[list, list] = ([], [])  # keys, postings
        for keys, counts, _ in _folded(csr.groups(device, ranges, postings=False),
                                       bits):
            found[0].append(keys)
            found[1].append(counts)
        keys, lens = (torch.cat(ts) for ts in found)
        order = torch.sort(keys ^ count_ops._SIGN64).indices
        keys, lens = keys[order], lens[order]
        bucket = (keys >> bits & 0xFFFFFFFF) >> shift
        for j, tj in enumerate(live):
            run = torch.nonzero(bucket == b_host[j]).flatten()
            cum = torch.cumsum(lens[run], 0) + below_m[j]
            w = int(torch.searchsorted(cum, torch.tensor([tj], device=device)))
            cut_rows.append(below_r[j] + w)
            cut_keys.append(int(keys[run[w]]) % (1 << 64))
    # a target of 0 (fewer postings than shards) cuts before every row
    cut_rows = [0] * (len(targets) - len(live)) + cut_rows
    cut_keys = [0] * (len(targets) - len(live)) + cut_keys
    return np.array(cut_rows + [nnz], dtype=np.int64), cut_keys


def device_shards(ref: str, mesh: parallel.Mesh, comp_code_bits: int,
                  strategy: str = "genome") -> DeviceShards:
    """This process's DB shards built on its slots' devices from the
    index directory ``ref``, equal to the JAX package's
    ``build_sharded_db`` / ``build_genome_sharded_db`` of
    ``merge_components`` (keys, offsets, ids and cut rows) without a
    host copy of the index.

    The index is read through ``index.CsrSlices``, whose groups hold at
    most ``index.MESH_GROUP_BYTES`` of index files, and each group is
    folded into one CSR (``_folded``). ``genome``: each device of a local
    slot streams every row through itself, a group at a time, and keeps
    of each group the postings of its shards' genomes [s*per,
    (s+1)*per), with ids local to the block. ``code``: the cut keys are
    found first (``_cut_keys``, on the first local device, from the
    codes and offsets alone), then each device reads only the rows
    between its shards' first and last cut keys, one row range a
    component, and splits them among its shards by key (``_code_pieces``;
    one shard takes them whole). A shard's pieces are sorted into one CSR
    once they are all there (no sort for a one-component index). So no
    device holds more than its shards, one group with its folded copy and
    the scratch of cutting its shards' pieces from it (a few times
    ``MESH_GROUP_BYTES``), and, while a shard is put together, a second
    copy of that shard with the sort's scratch. A failed pin, read or
    copy raises: nothing is built on the host."""
    if strategy not in ("genome", "code"):
        raise ValueError(f"unknown sharding strategy {strategy!r}")
    stat = formats.read_mco_stat(ref)
    csr = index_mod.CsrSlices(ref, stat)
    bits = comp_code_bits
    n_ref, n_shards = stat.infile_num, mesh.ref
    per = -(-max(n_ref, 1) // n_shards)
    by_dev: dict[torch.device, list[int]] = {}
    for _, r, dev in mesh.local_slots():
        if r not in by_dev.setdefault(dev, []):
            by_dev[dev].append(r)
    span = torch.profiler.record_function
    if strategy == "genome":
        row_bounds = np.minimum(np.arange(n_shards + 1, dtype=np.int64) * per, n_ref)
    elif not by_dev:  # this process counts nothing: no cut is needed
        row_bounds = None
    elif n_shards == 1:  # no cut: the one shard's rows are counted once built
        row_bounds, edges = None, [None, None]
    else:
        with span("mesh.cut"):
            row_bounds, cuts = _cut_keys(csr, next(iter(by_dev)), n_shards, bits)
        edges = [None] + cuts + [None]
    out = {}
    for dev, shards in by_dev.items():
        pieces = {s: [] for s in shards}
        if strategy == "genome":
            ranges = None
        else:  # the rows between the device's first and last cut keys
            lo, hi = edges[min(shards)], edges[max(shards) + 1]
            ranges = [(c, 0 if lo is None else csr.rows_below(c, lo, bits),
                       csr.rows(c) if hi is None else csr.rows_below(c, hi, bits))
                      for c in range(stat.comp_num)]
        for folded in _folded(csr.groups(dev, ranges), bits):
            with span("mesh.fold"):
                if strategy == "genome":
                    _genome_pieces(folded, shards, per, pieces)
                else:
                    _code_pieces(folded, shards, edges, pieces)
            del folded
        with span("mesh.build"):
            for s in shards:
                c0, c1 = ((int(row_bounds[s]), int(row_bounds[s + 1]))
                          if strategy == "genome" else (0, n_ref))
                out[(s, dev)] = _assemble(pieces.pop(s), c1 - c0, dev,
                                          stat.comp_num == 1)
    if row_bounds is None and out:
        row_bounds = np.array([0, next(iter(out.values())).uniq.numel()], np.int64)
    return DeviceShards(out, row_bounds, n_ref, n_shards, strategy)


class DeviceQueries:
    """A query sketch directory on ``device``, read straight onto it
    (``index.combco_on_device``) and folded there a group of components
    at a time: every code's folded key (int64), query id (int32) and,
    ``with_abund``, weight (int32 bit view of its uint32 abundance),
    sorted by query (stably: by component and position within one), so
    that a dp block's entries are one slice."""

    def __init__(self, qry_dir: str, device: torch.device, with_abund: bool,
                 bits: int):
        stat = formats.read_co_stat(qry_dir)
        parts = [(c, 0, None) for c in range(stat.comp_num)]
        keys, qids, weights = [], [], []
        span = torch.profiler.record_function
        for g in index_mod.combco_on_device(qry_dir, parts, stat.infile_num,
                                            device, "mesh", with_abund):
            with span("mesh.fold"):
                part = g.part_of()
                comp = torch.tensor(g.comps, dtype=torch.int64, device=device)[part]
                keys.append(_fold(g.codes, comp, bits))
                qids.append(g.sketch_ids(part))
                if with_abund:
                    weights.append(g.abund.to(torch.int32) & 0xFFFF)
            del g, part, comp  # before the next group is read
        with span("mesh.fold"):
            qid = torch.cat(qids)
            order = torch.sort(qid, stable=True).indices
            self.qids, self.keys = qid[order], torch.cat(keys)[order]
            self.weights = torch.cat(weights)[order] if with_abund else None
            self.starts = torch.searchsorted(self.qids, torch.arange(
                stat.infile_num + 1, dtype=torch.int32, device=device)).tolist()

    def block(self, q0: int, q1: int):
        """The folded keys, query ids less ``q0`` and, with abundances, the
        weights of queries [q0, q1)."""
        p0, p1 = self.starts[q0], self.starts[q1]
        out = (self.keys[p0:p1], self.qids[p0:p1] - q0)
        return out + (self.weights[p0:p1],) if self.weights is not None else out


def _fetch(t: torch.Tensor, dst: np.ndarray) -> None:
    """A count block into its place in the result, through the index
    loader's staging set (pinned on a card)."""
    with staging.borrow(t.device, index_mod.INDEX_BLOCK,
                        index_mod.INDEX_READ_THREADS + 2) as st:
        st.fetch(t, dst)


def sharded_search_counts(
    qry_dir: str,
    ref: str,
    comp_code_bits: int,
    mesh: parallel.Mesh,
    batch: int = 0,
    counts_out: np.ndarray | None = None,
    koc_out: np.ndarray | None = None,
    strategy: str = "genome",
) -> np.ndarray:
    """End-to-end sharded counting of a query sketch dir against the
    reference index directory ``ref``; returns uint32 [n_qry, n_ref].
    ``comp_code_bits`` is the component-fold shift.

    ``batch`` bounds the query rows counted per step (the -m governor:
    the DB shards stay resident, only the per-step count blocks scale
    with the batch); ``counts_out`` (e.g. a np.memmap) receives the rows
    so host RAM stays bounded. ``koc_out`` (uint64 [n_qry, n_ref])
    additionally receives the abundance-weighted counts from the query
    ``.a`` files — the --koc-out table under --mesh, from the same walk.
    ``strategy``: 'genome' (column blocks, default) or 'code' (code-range
    shards, summed partials) — see the module docstring. The shards and
    the query keys are made on the slots' devices (``device_shards``,
    ``DeviceQueries``); each count block is fetched into its place.
    """
    db = device_shards(ref, mesh, comp_code_bits, strategy)
    n_ref = db.n_ref
    queries = {dev: DeviceQueries(qry_dir, dev, koc_out is not None,
                                  comp_code_bits)
               for dev in dict.fromkeys(dev for _, _, dev in mesh.local_slots())}
    n_qry_total = formats.read_co_stat(qry_dir).infile_num
    out = (
        counts_out
        if counts_out is not None
        else np.empty((n_qry_total, n_ref), dtype=np.uint32)
    )
    batch = batch or n_qry_total
    for b0 in range(0, n_qry_total, batch):
        b1 = min(b0 + batch, n_qry_total)
        outs = [out[b0:b1]] + ([koc_out[b0:b1]] if koc_out is not None else [])
        _sharded_count_block(queries, b0, b1 - b0, db, mesh, outs)
    return out


def _sharded_count_block(queries: dict, b0: int, n_qry: int, db: DeviceShards,
                         mesh: parallel.Mesh, outs: list[np.ndarray]) -> None:
    """Count queries [b0, b0 + n_qry) against the resident DB shards into
    ``outs`` (the uint32 counts' rows, and the uint64 koc sums' when the
    queries carry abundances), LOCAL rows [0, n_qry).

    Every local slot's kernel is launched before any result is fetched,
    so slots on different cards run at the same time. Under ``code`` the
    partial counts of one dp block are summed on its first slot's device
    and fetched once."""
    per_dp = -(-n_qry // mesh.dp)
    span = torch.profiler.record_function
    blocks: dict = {}  # (dp block, device) -> its query tensors
    launched = []
    for d, r, dev in mesh.local_slots():
        qlo, qhi = d * per_dp, min((d + 1) * per_dp, n_qry)
        if qhi <= qlo:
            continue
        if (d, dev) not in blocks:
            with span("mesh.queries"):
                blocks[(d, dev)] = queries[dev].block(b0 + qlo, b0 + qhi)
        q = blocks[(d, dev)]
        index = db.index[(r, dev)]
        if len(outs) > 1:
            res = count_ops.count_shared_koc_kernel(*q, index, qhi - qlo)
        else:
            res = (count_ops.count_shared_kernel(*q, index, qhi - qlo),)
        launched.append((d, qlo, qhi, db.columns(r), res))
    blocks.clear()
    gathered = []
    with span("mesh.fetch"):
        if db.strategy == "genome":
            for _, qlo, qhi, (c0, c1), res in launched:
                for k, t in enumerate(res):
                    _fetch(t, outs[k][qlo:qhi, c0:c1])
                    if parallel.process_count() > 1:
                        gathered.append((k, qlo, qhi, c0, c1,
                                         outs[k][qlo:qhi, c0:c1].copy()))
        else:
            sums: dict[int, list[torch.Tensor]] = {}
            for d, _, _, _, res in launched:
                if d not in sums:
                    sums[d] = list(res)
                else:
                    for t, p in zip(sums[d], res):
                        t.add_(p.to(t.device))
            for d in range(mesh.dp):
                qlo, qhi = d * per_dp, min((d + 1) * per_dp, n_qry)
                for k, o in enumerate(outs):
                    if d in sums:
                        _fetch(sums[d][k], o[qlo:qhi])
                    elif qhi > qlo:  # no local slot: this process adds 0
                        o[qlo:qhi] = 0
    if parallel.process_count() > 1:
        if db.strategy == "genome":
            # each block is owned by exactly one slot: gather them
            for got in parallel.all_gather_objects(gathered):
                for k, qlo, qhi, c0, c1, part in got:
                    outs[k][qlo:qhi, c0:c1] = part
        else:
            for o in outs:
                parallel.all_reduce_sum(o)
