"""Synthetic GTDB-shaped sketch databases, written through the REAL
on-disk artifact path (combco.* + cofiles.stat, formats.py), for scale
benchmarks and capacity planning.

The flagship scale target is the reference's 317k-genome GTDB species
database (SURVEY.md C17; the kssd data release's
specuq_grp_gtdb317kgenome_kssd, 65,702 species groups survive upstream)
at the measured ~1,300 codes per genome for the k=10/l=3 default
geometry (BASELINE.md).
Everything downstream of these files — stage II CSR build, index load,
-m governed or mesh-sharded search, composite — exercises the exact
code paths a real GTDB run uses.
"""

from __future__ import annotations

import os

import numpy as np

from public_kssd_tpu_torch import formats

SPACE_BITS = 28  # 4*(k-l) at k=10, l=3 — in-component id space at CSZ=7


def build_synth_ref(
    out_dir: str,
    n_ref: int,
    sketch_sz: int,
    seed: int = 0,
    space_bits: int = SPACE_BITS,
    params_id: int = 9,
    kmerlen: int = 20,
    dim_rd_len: int = 6,
) -> None:
    """Write a synthetic reference sketch dir (single component)."""
    if os.path.isfile(os.path.join(out_dir, formats.CO_DSTAT)):
        return  # cached
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    total = n_ref * sketch_sz
    codes = rng.integers(0, 1 << space_bits, size=total, dtype=np.uint32)
    index = np.arange(n_ref + 1, dtype=np.uint64) * sketch_sz
    formats.write_combco(out_dir, 0, codes, index)
    formats.write_co_stat(out_dir, formats.CoStat(
        params_id=params_id, koc=False, kmerlen=kmerlen,
        dim_rd_len=dim_rd_len, comp_num=1, infile_num=n_ref,
        all_ctx_ct=int(total),
        ctx_ct=np.full(n_ref, sketch_sz, np.uint32),
        names=[f"g{i:06d}" for i in range(n_ref)],
    ))


# the real size file of the kssd data release's GTDB species database,
# relative to the working directory (it is not part of this repository)
REAL_GTDB_INDEX = os.path.join(
    "specuq_grp_gtdb317kgenome_kssd", "combco.index.0"
)


def real_gtdb_sizes(index_path: str = REAL_GTDB_INDEX) -> np.ndarray:
    """The surviving REAL per-species-group sketch sizes of the GTDB
    317k-genome database (SURVEY.md C17): combco.index.0 holds 65,703
    uint64 cumulative offsets = 65,702 group sizes (total 19.7M codes,
    median 251, mean 300, max 23,925 — an 80x skew the uniform
    synthetic DB cannot exhibit). This is the one reference artifact
    that survived the large-blob purge, and the size distribution is
    what stresses genome-block padding and the postings-balanced code
    cut (parallel/sharded_search.py)."""
    idx = np.fromfile(index_path, dtype="<u8")
    return np.diff(idx.astype(np.int64))


def build_synth_ref_sizes(
    out_dir: str,
    sizes: np.ndarray,
    seed: int = 0,
    space_bits: int = SPACE_BITS,
    params_id: int = 9,
    kmerlen: int = 20,
    dim_rd_len: int = 6,
) -> None:
    """Write a synthetic reference sketch dir with PER-GENOME sketch
    sizes from ``sizes`` (e.g. real_gtdb_sizes()): same artifact path as
    build_synth_ref, real skew."""
    if os.path.isfile(os.path.join(out_dir, formats.CO_DSTAT)):
        return  # cached
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    sizes = np.asarray(sizes, dtype=np.int64)
    n_ref = sizes.size
    total = int(sizes.sum())
    codes = rng.integers(0, 1 << space_bits, size=total, dtype=np.uint32)
    index = np.zeros(n_ref + 1, dtype=np.uint64)
    np.cumsum(sizes, out=index[1:].view(np.int64))
    formats.write_combco(out_dir, 0, codes, index)
    formats.write_co_stat(out_dir, formats.CoStat(
        params_id=params_id, koc=False, kmerlen=kmerlen,
        dim_rd_len=dim_rd_len, comp_num=1, infile_num=n_ref,
        all_ctx_ct=total,
        ctx_ct=sizes.astype(np.uint32),
        names=[f"g{i:06d}" for i in range(n_ref)],
    ))


def build_synth_queries(
    out_dir: str,
    ref_dir: str,
    n_qry: int,
    sketch_sz: int,
    hit_rate: float = 0.3,
    seed: int = 1,
    koc: bool = False,
    space_bits: int = SPACE_BITS,
    focus_refs: int = 8,
) -> None:
    """Write a query sketch dir whose codes hit the reference DB at
    ``hit_rate``, CONCENTRATED in ``focus_refs`` genomes per query
    (metagenome-shaped: a sample contains a handful of species, so
    per-ref match counts clear composite's MIN_KM_S gate). Drawn from
    the ref combco via memmap — no second copy of the DB in RAM. With
    ``koc`` adds uint16 abundance counters."""
    if os.path.isfile(os.path.join(out_dir, formats.CO_DSTAT)):
        return  # cached
    os.makedirs(out_dir, exist_ok=True)
    ref_stat = formats.read_co_stat(ref_dir)
    ref_codes = np.memmap(
        os.path.join(ref_dir, "combco.0"), dtype="<u4", mode="r"
    )
    rng = np.random.default_rng(seed)
    total = n_qry * sketch_sz
    codes = rng.integers(0, 1 << space_bits, size=total, dtype=np.uint32)
    hit = rng.random(total) < hit_rate
    # per-ref sketch sizes from the stat (uniform OR skewed builds):
    # sample each planted code uniformly within the picked genome's
    # combco range, skipping empty groups (real GTDB has some)
    sizes = ref_stat.ctx_ct.astype(np.int64)
    starts = np.zeros(sizes.size + 1, dtype=np.int64)
    np.cumsum(sizes, out=starts[1:])
    nonempty = np.flatnonzero(sizes > 0)
    picks = nonempty[
        rng.integers(0, nonempty.size, size=(n_qry, focus_refs))
    ]
    which = rng.integers(0, focus_refs, size=(n_qry, sketch_sz))
    gsel = np.take_along_axis(picks, which, axis=1)
    offs = rng.integers(0, sizes[gsel])
    src = (starts[gsel] + offs).ravel()
    codes[hit] = ref_codes[src[hit]]
    index = np.arange(n_qry + 1, dtype=np.uint64) * sketch_sz
    abund = (
        rng.integers(1, 50, size=total).astype(np.uint16) if koc else None
    )
    formats.write_combco(out_dir, 0, codes, index, abund)
    formats.write_co_stat(out_dir, formats.CoStat(
        params_id=ref_stat.params_id, koc=koc, kmerlen=ref_stat.kmerlen,
        dim_rd_len=ref_stat.dim_rd_len, comp_num=1, infile_num=n_qry,
        all_ctx_ct=int(total),
        ctx_ct=np.full(n_qry, sketch_sz, np.uint32),
        names=[f"q{i:04d}" for i in range(n_qry)],
    ))
