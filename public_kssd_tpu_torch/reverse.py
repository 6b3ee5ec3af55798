"""Reverse: sketch codes -> canonical k-mer strings.

Inverts the drtuple repacking exactly (core_reverse2unituple,
command_reverse.c:311-321), vectorised with numpy:

  drtuple = (code << comp_code_bits) + component
  inner   = rev_shuffle[drtuple % 4096]
  tuple   = ((drtuple >> 4(s-l)) << 4s) + inner
  k-mer   = [left outer | right outer | inner] fields swapped back

Only shuffles with dim_end == MIN_SUBCTX_DIM_SMP_SZ (s = l + 3) are
reversible, as in the reference (command_reverse.c:150-158: the reverse
permutation array is sized 4096 and count must match exactly).
"""

from __future__ import annotations

import os

import numpy as np

from public_kssd_tpu_torch import formats
from public_kssd_tpu_torch.config import MIN_SUBCTX_DIM_SMP_SZ, SketchParams
from public_kssd_tpu_torch.seqio import MAPBASE


def reverse_shuffle(params: SketchParams, shuffled_dim: np.ndarray) -> np.ndarray:
    """rev[rank] = inner substring index, for ranks < 4096
    (command_reverse.c:150-158)."""
    mask = shuffled_dim < MIN_SUBCTX_DIM_SMP_SZ
    count = int(mask.sum())
    if count != MIN_SUBCTX_DIM_SMP_SZ:
        raise ValueError(
            f"count {count} not match MIN_SUBCTX_DIM_SMP_SZ "
            f"{MIN_SUBCTX_DIM_SMP_SZ}"
        )
    rev = np.zeros(MIN_SUBCTX_DIM_SMP_SZ, dtype=np.uint32)
    rev[shuffled_dim[mask]] = np.flatnonzero(mask)
    return rev


def codes_to_unituples(
    codes: np.ndarray, comp: int, params: SketchParams, rev: np.ndarray
) -> np.ndarray:
    """Vectorised core_reverse2unituple (command_reverse.c:311-321)."""
    pf_bits = 4 * (params.half_subctx_len - params.drlevel)
    inner_bits = 4 * params.half_subctx_len
    half_outer_bits = 2 * params.half_outctx_len
    drtuple = (codes.astype(np.uint64) << np.uint64(params.comp_code_bits)) + np.uint64(
        comp
    )
    ind = rev[(drtuple % np.uint64(MIN_SUBCTX_DIM_SMP_SZ)).astype(np.int64)]
    tup = ((drtuple >> np.uint64(pf_bits)) << np.uint64(inner_bits)) + ind.astype(
        np.uint64
    )
    houter_mask = np.uint64(((1 << half_outer_bits) - 1) << inner_bits)
    inner_mask = np.uint64((1 << inner_bits) - 1)
    uni = (
        (tup & (houter_mask << np.uint64(half_outer_bits)))
        + ((tup & houter_mask) >> np.uint64(inner_bits))
        + ((tup & inner_mask) << np.uint64(half_outer_bits))
    )
    return uni


def unituples_to_strings(uni: np.ndarray, TL: int) -> list[str]:
    """Decode 2-bit packed k-mers to base strings (command_reverse.c:300-305)."""
    if uni.size == 0:
        return []
    shifts = np.arange(TL - 1, -1, -1, dtype=np.uint64) * np.uint64(2)
    bases = ((uni[:, None] >> shifts[None, :]) & np.uint64(3)).astype(np.uint8)
    lut = np.frombuffer(MAPBASE.encode(), dtype=np.uint8)
    chars = lut[bases]
    return [row.tobytes().decode() for row in chars]


def reverse_codir(
    co_dir: str, shuf_path: str, out_dir: str, component_sz: int = 7
) -> None:
    """Whole-sketch reversal -> one k-mer text file per genome
    (co_reverse2kmer, command_reverse.c:219-310). K-mers appear in
    component-major order, matching the reference."""
    params, shuffled_dim = formats.read_shuf(shuf_path, component_sz=component_sz)
    rev = reverse_shuffle(params, shuffled_dim)
    stat = formats.read_co_stat(co_dir)
    os.makedirs(out_dir, exist_ok=True)
    per_genome: list[list[np.ndarray]] = [[] for _ in range(stat.infile_num)]
    for c in range(stat.comp_num):
        codes, index = formats.read_combco(co_dir, c)
        for k in range(stat.infile_num):
            seg = codes[int(index[k]) : int(index[k + 1])]
            per_genome[k].append(codes_to_unituples(seg, c, params, rev))
    for k in range(stat.infile_num):
        if stat.ctx_ct[k] == 0:
            continue
        uni = np.concatenate(per_genome[k])
        fname = os.path.basename(stat.names[k])
        with open(os.path.join(out_dir, fname), "w") as f:
            for s in unituples_to_strings(uni, params.TL):
                f.write(s + "\n")


def reverse_byreads(co_dir: str, shuf_path: str, component_sz: int = 7) -> str:
    """--byread reversal -> fasta-like text, one record per read
    (co_rvs2kmer_byreads, command_reverse.c:147-217)."""
    params, shuffled_dim = formats.read_shuf(shuf_path, component_sz=component_sz)
    rev = reverse_shuffle(params, shuffled_dim)
    stat = formats.read_co_stat(co_dir)
    comps = [formats.read_combco(co_dir, c) for c in range(stat.comp_num)]
    n_reads = comps[0][1].size - 1
    # the reference consumes codes sequentially with fread, so ranges are
    # cumulative LENGTHS from file start — if index[0] != 0 (record 0
    # non-empty) output shifts accordingly (command_reverse.c:196-208)
    cursors = [0] * len(comps)
    out = []
    for n in range(n_reads):
        out.append(f">read {n + 1}\n")
        for c, (codes, index) in enumerate(comps):
            ln = int(index[n + 1] - index[n])
            seg = codes[cursors[c] : cursors[c] + ln]
            cursors[c] += ln
            uni = codes_to_unituples(seg, c, params, rev)
            for s in unituples_to_strings(uni, params.TL):
                out.append(s + "\n")
    return "".join(out)


def cmd_reverse(args) -> int:
    if not args.remaining:
        raise SystemExit("need specify the query co dir")
    if args.byreads:
        print(
            reverse_byreads(args.remaining[0], args.shuf, args.component_sz), end=""
        )
    else:
        os.makedirs(args.outdir, exist_ok=True)
        reverse_codir(args.remaining[0], args.shuf, args.outdir, args.component_sz)
    return 0
