"""Stage II: invert a sketch directory into the searchable index.

Reference: run_stageII (command_dist.c:381-417) + combco2mco
(co2mco.c:25-77) build, per component, a DENSE 16^COMPONENT_SZ-row
cumulative index (2 GiB at CSZ=7 regardless of data!) plus concatenated
genome-id postings.

Redesign: the index is built by a single stable argsort of the
component's codes (postings order = code ascending, genome ascending —
bit-identical to the reference's insertion order), and the in-memory /
on-device representation is CSR over the *occupied* rows only
(unique codes + offsets + postings). The dense on-disk format is kept as
an export for byte-compatibility; the sparse form is what search loads.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from public_kssd_tpu_torch import formats

_SIGN = np.uint64(1 << 63)


@dataclasses.dataclass
class SparseIndex:
    """CSR inverted index of one component over occupied code rows."""

    uniq_codes: np.ndarray  # uint32 [nnz] ascending
    offsets: np.ndarray  # uint32/uint64 [nnz+1] cumulative postings counts
    gids: np.ndarray  # uint32 [total] genome ids, grouped by code
    n_genomes: int


def build_component_index(
    codes: np.ndarray, index: np.ndarray, n_genomes: int,
    device: torch.device | None = None,
) -> SparseIndex:
    """Invert one component's concatenated codes (combco layout).

    One direct sort of packed (code << 32 | gid) keys: gid_of is
    nondecreasing in combco position, so this yields code-ascending,
    gid-ascending postings — identical to a stable argsort by code (the
    reference's insertion order) at a fraction of the cost (~5x on the
    412M-posting GTDB build: np.sort moves 8-byte keys, argsort moves
    8-byte indices AND pays two gather passes).

    ``device`` runs the sort — the stage II hot op (combco2mco's row
    fill, co2mco.c:42-55; SURVEY C9) — there with ``torch.sort``. torch
    sorts int64 only, so the unsigned keys (codes reach 2^32 - 1 at
    CSZ=8) are sorted as ``key ^ 2^63`` viewed as int64, which orders
    exactly as the unsigned keys do, and flipped back after. The host
    sort stays the default; boundary extraction is host-side either
    way."""
    gid_of = (
        np.searchsorted(index[1:], np.arange(codes.size, dtype=np.uint64), "right")
        .astype(np.uint32)
    )
    key = (codes.astype(np.uint64) << np.uint64(32)) | gid_of
    if device is not None and key.size:
        key = sort_u64(key, device)
    else:
        key.sort()
    sorted_codes = (key >> np.uint64(32)).astype(np.uint32)
    sorted_gids = key.astype(np.uint32)  # low 32 bits
    if sorted_codes.size:
        # unique over ALREADY-SORTED codes (np.unique would re-sort)
        change = np.empty(sorted_codes.size, bool)
        change[0] = True
        np.not_equal(sorted_codes[1:], sorted_codes[:-1], out=change[1:])
        first = np.flatnonzero(change)
        uniq = sorted_codes[first]
        counts = np.diff(np.append(first, sorted_codes.size))
    else:
        uniq = sorted_codes
        counts = np.zeros(0, np.int64)
    offsets = np.zeros(uniq.size + 1, dtype=np.uint64)
    np.cumsum(counts, out=offsets[1:])
    return SparseIndex(
        uniq_codes=uniq.astype(np.uint32),
        offsets=offsets,
        gids=sorted_gids,
        n_genomes=n_genomes,
    )


def sort_u64(key: np.ndarray, device: torch.device) -> np.ndarray:
    """Ascending sort of uint64 keys on ``device`` (sign-flipped int64)."""
    flipped = torch.from_numpy((key ^ _SIGN).view(np.int64)).to(device)
    out = torch.sort(flipped).values.cpu().numpy()
    return out.view(np.uint64) ^ _SIGN


def sparse_to_dense_offsets(idx: SparseIndex, comp_sz: int) -> np.ndarray:
    """Expand CSR offsets to the reference's dense inclusive-cumsum rows
    (combco2mco's row_offset after prefix sum, co2mco.c:57)."""
    counts = np.zeros(comp_sz, dtype=np.uint64)
    counts[idx.uniq_codes.astype(np.int64)] = np.diff(idx.offsets)
    return np.cumsum(counts)


def dense_to_sparse(row_offset: np.ndarray, gids: np.ndarray, n_genomes: int) -> SparseIndex:
    """Load a reference-format dense component into CSR."""
    counts = np.diff(row_offset, prepend=np.uint64(0))
    occupied = np.flatnonzero(counts)
    offsets = np.zeros(occupied.size + 1, dtype=np.uint64)
    np.cumsum(counts[occupied], out=offsets[1:])
    return SparseIndex(
        uniq_codes=occupied.astype(np.uint32),
        offsets=offsets,
        gids=gids,
        n_genomes=n_genomes,
    )


def _csr_paths(mco_dir: str, c: int) -> tuple[str, str]:
    return (
        os.path.join(mco_dir, f"mco.uniq.{c}"),
        os.path.join(mco_dir, f"mco.csroff.{c}"),
    )


def run_stage2(
    co_dir: str, mco_dir: str, comp_sz: int, dense: bool = True,
    device: torch.device | None = None,
) -> formats.McoStat:
    """Build the reference-compatible index directory from a sketch dir.

    Writes mcofiles.stat + mco.<c> + mco.index.<c> (dense format, for
    reference-binary interop) into ``mco_dir`` (usually the same
    directory, as the reference tutorial does), PLUS a CSR sidecar
    (mco.uniq.<c> uint32 + mco.csroff.<c> uint64) so our own search
    loads in milliseconds instead of re-deriving CSR from the 2 GiB
    dense rows (16^7 x 8 B at CSZ=7, co2mco.c:58-62 — ~2 min on a
    2-vCPU host). ``dense=False`` skips the dense export entirely for
    very large DBs."""
    co = formats.read_co_stat(co_dir)
    os.makedirs(mco_dir, exist_ok=True)
    comp_space = 1 << (4 * comp_sz)
    for c in range(co.comp_num):
        codes, index = formats.read_combco(co_dir, c)
        sp = build_component_index(codes, index, co.infile_num, device)
        up, op = _csr_paths(mco_dir, c)
        sp.uniq_codes.astype("<u4").tofile(up)
        sp.offsets.astype("<u8").tofile(op)
        if dense:
            dense_rows = sparse_to_dense_offsets(sp, comp_space)
            formats.write_mco_component(mco_dir, c, dense_rows, sp.gids)
        else:
            sp.gids.astype("<u4").tofile(formats.mco_path(mco_dir, c))
    stat = formats.McoStat(
        params_id=co.params_id,
        kmerlen=co.kmerlen,
        dim_rd_len=co.dim_rd_len,
        comp_num=co.comp_num,
        infile_num=co.infile_num,
        ctx_ct=co.ctx_ct,
        names=co.names,
    )
    formats.write_mco_stat(mco_dir, stat)
    return stat


def load_sparse_index(mco_dir: str) -> tuple[formats.McoStat, list[SparseIndex]]:
    """Load an index directory as CSR components.

    Prefers the CSR sidecar written by run_stage2; falls back to
    deriving CSR from the reference's dense mco.index.<c> rows (so
    databases built by the reference binary load unchanged)."""
    stat = formats.read_mco_stat(mco_dir)
    comps = []
    for c in range(stat.comp_num):
        up, op = _csr_paths(mco_dir, c)
        if os.path.isfile(up) and os.path.isfile(op):
            comps.append(
                SparseIndex(
                    uniq_codes=np.fromfile(up, dtype="<u4"),
                    offsets=np.fromfile(op, dtype="<u8"),
                    gids=np.fromfile(formats.mco_path(mco_dir, c), dtype="<u4"),
                    n_genomes=stat.infile_num,
                )
            )
            continue
        row_offset, gids = formats.read_mco_component(mco_dir, c)
        comps.append(dense_to_sparse(row_offset, gids, stat.infile_num))
    return stat, comps


def sparse_index_from_co(co_dir: str) -> tuple[formats.CoStat, list[SparseIndex]]:
    """Build CSR components directly from a sketch dir (no dense files) —
    the fast path used when reference-format export is not needed."""
    co = formats.read_co_stat(co_dir)
    comps = []
    for c in range(co.comp_num):
        codes, index = formats.read_combco(co_dir, c)
        comps.append(build_component_index(codes, index, co.infile_num))
    return co, comps
