"""Byte-exact codecs for all on-disk artifacts shared with the reference.

Every format is little-endian flat binary; layouts verified against the
reference writers:

  .shuf            16-byte header {int id,k,subk,drlevel} + 16^subk int32
                   permutation (command_shuffle.c:184-185)
  cofiles.stat     32-byte co_dstat_t {u32 shuf_id; u8 koc; 3 pad; i32
                   kmerlen, dim_rd_len, comp_num, infile_num; u64
                   all_ctx_ct} + infile_num u32 sketch sizes + infile_num
                   256-char paths (global_basic.h:94-103; run_stageI
                   command_dist.c:361-378)
  combco.<c>       concatenated uint32 sketch codes (iseq2comem.c:525-551)
  combco.index.<c> (infile_num+1) uint64 cumulative offsets
                   (command_dist.c:314-357)
  combco.<c>.a     uint16 per-code abundances (iseq2comem.c:435-471)
  mcofiles.stat    20-byte mco_dstat_t {u32 shuf_id; i32 kmerlen,
                   dim_rd_len, comp_num, infile_num} + sizes + paths
                   (command_dist.h:57-64, run_stageII command_dist.c:397-413)
  mco.index.<c>    16^COMPONENT_SZ uint64 cumulative row offsets (dense)
                   (co2mco.c:57-62)
  mco.<c>          concatenated uint32 genome-id postings (co2mco.c:63-72)
  pan.<c>          sorted-unique uint32 union codes (command_set.c:263-291)
  .abv             array of {i32 ref_idx; f32 pct} (command_composite.h:25-29)

The 3 padding bytes after ``koc`` are uninitialised stack memory in the
reference; we always write zeros and ignore them on read.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Sequence

import numpy as np

from public_kssd_tpu_torch.config import SketchParams

PATHLEN = 256  # global_basic.h:40

CO_DSTAT = "cofiles.stat"  # command_dist.c:44
MCO_DSTAT = "mcofiles.stat"  # command_dist.c:45
SKCH_PREFIX = "combco"  # command_set.c:222
IDX_PREFIX = "combco.index"  # command_set.c:223
PAN_PREFIX = "pan"  # command_set.c:224
UNIQ_PAN_PREFIX = "uniq_pan"  # command_set.c:225
MCO_GIDS_PREFIX = "mco"  # co2mco.c:23
MCO_IDX_PREFIX = "mco.index"  # co2mco.c:24

_CO_DSTAT_STRUCT = struct.Struct("<IB3x4iq")  # co_dstat_t, 32 bytes
_MCO_DSTAT_STRUCT = struct.Struct("<I4i")  # mco_dstat_t, 20 bytes
_SHUF_HDR_STRUCT = struct.Struct("<4i")  # dim_shuffle_stat_t, 16 bytes


# --------------------------------------------------------------------------
# .shuf
# --------------------------------------------------------------------------

def write_shuf(path: str, params: SketchParams, shuffled_dim: np.ndarray) -> None:
    """Write a ``.shuf`` file (command_shuffle.c:161-191)."""
    shuffled_dim = np.ascontiguousarray(shuffled_dim, dtype="<i4")
    if shuffled_dim.shape != (params.dim_shuf_len,):
        raise ValueError(
            f"permutation has shape {shuffled_dim.shape}, "
            f"expected ({params.dim_shuf_len},)"
        )
    with open(path, "wb") as f:
        f.write(
            _SHUF_HDR_STRUCT.pack(
                params.id, params.half_ctx_len, params.half_subctx_len, params.drlevel
            )
        )
        f.write(shuffled_dim.tobytes())


def read_shuf(
    path: str, component_sz: int | None = None
) -> tuple[SketchParams, np.ndarray]:
    """Read a ``.shuf`` file (command_shuffle.c:192-207)."""
    with open(path, "rb") as f:
        id_, k, subk, drlevel = _SHUF_HDR_STRUCT.unpack(f.read(_SHUF_HDR_STRUCT.size))
        kwargs = {} if component_sz is None else {"component_sz": component_sz}
        params = SketchParams(
            id=id_, half_ctx_len=k, half_subctx_len=subk, drlevel=drlevel, **kwargs
        )
        shuffled_dim = np.fromfile(f, dtype="<i4", count=params.dim_shuf_len)
    if shuffled_dim.size != params.dim_shuf_len:
        raise ValueError(f"truncated .shuf file {path}")
    return params, shuffled_dim


def make_shuffled_dim(params: SketchParams, seed: int | None = None) -> np.ndarray:
    """Generate a fresh Fisher-Yates permutation of the 16^s inner space.

    The reference seeds libc rand() with time() (command_shuffle.c:180) so
    only the format is reproducible; we use a seeded numpy Generator so the
    whole pipeline is replayable from (params.id, seed).
    """
    rng = np.random.default_rng(params.id if seed is None else seed)
    return rng.permutation(params.dim_shuf_len).astype("<i4")


# --------------------------------------------------------------------------
# sketch directory ("co dir")
# --------------------------------------------------------------------------

@dataclasses.dataclass
class CoStat:
    """Parsed ``cofiles.stat``: header + per-genome sizes + names."""

    params_id: int
    koc: bool
    kmerlen: int
    dim_rd_len: int
    comp_num: int
    infile_num: int
    all_ctx_ct: int
    ctx_ct: np.ndarray  # uint32 [infile_num] per-genome sketch sizes
    names: list[str]  # [infile_num]


def write_co_stat(dirpath: str, stat: CoStat) -> None:
    ctx_ct = np.ascontiguousarray(stat.ctx_ct, dtype="<u4")
    assert ctx_ct.shape == (stat.infile_num,)
    assert len(stat.names) == stat.infile_num
    with open(os.path.join(dirpath, CO_DSTAT), "wb") as f:
        f.write(
            _CO_DSTAT_STRUCT.pack(
                stat.params_id,
                int(stat.koc),
                stat.kmerlen,
                stat.dim_rd_len,
                stat.comp_num,
                stat.infile_num,
                stat.all_ctx_ct,
            )
        )
        f.write(ctx_ct.tobytes())
        f.write(_pack_names(stat.names))


def read_co_stat(dirpath: str) -> CoStat:
    with open(os.path.join(dirpath, CO_DSTAT), "rb") as f:
        (shuf_id, koc, kmerlen, dim_rd_len, comp_num, infile_num, all_ctx_ct) = (
            _CO_DSTAT_STRUCT.unpack(f.read(_CO_DSTAT_STRUCT.size))
        )
        ctx_ct = np.fromfile(f, dtype="<u4", count=infile_num)
        names = _unpack_names(f.read(PATHLEN * infile_num), infile_num)
    return CoStat(
        params_id=shuf_id,
        koc=bool(koc),
        kmerlen=kmerlen,
        dim_rd_len=dim_rd_len,
        comp_num=comp_num,
        infile_num=infile_num,
        all_ctx_ct=all_ctx_ct,
        ctx_ct=ctx_ct,
        names=names,
    )


@dataclasses.dataclass
class McoStat:
    """Parsed ``mcofiles.stat`` (mirrors CoStat minus koc/all_ctx_ct)."""

    params_id: int
    kmerlen: int
    dim_rd_len: int
    comp_num: int
    infile_num: int
    ctx_ct: np.ndarray
    names: list[str]


def write_mco_stat(dirpath: str, stat: McoStat) -> None:
    ctx_ct = np.ascontiguousarray(stat.ctx_ct, dtype="<u4")
    with open(os.path.join(dirpath, MCO_DSTAT), "wb") as f:
        f.write(
            _MCO_DSTAT_STRUCT.pack(
                stat.params_id,
                stat.kmerlen,
                stat.dim_rd_len,
                stat.comp_num,
                stat.infile_num,
            )
        )
        f.write(ctx_ct.tobytes())
        f.write(_pack_names(stat.names))


def read_mco_stat(dirpath: str) -> McoStat:
    with open(os.path.join(dirpath, MCO_DSTAT), "rb") as f:
        shuf_id, kmerlen, dim_rd_len, comp_num, infile_num = _MCO_DSTAT_STRUCT.unpack(
            f.read(_MCO_DSTAT_STRUCT.size)
        )
        ctx_ct = np.fromfile(f, dtype="<u4", count=infile_num)
        names = _unpack_names(f.read(PATHLEN * infile_num), infile_num)
    return McoStat(
        params_id=shuf_id,
        kmerlen=kmerlen,
        dim_rd_len=dim_rd_len,
        comp_num=comp_num,
        infile_num=infile_num,
        ctx_ct=ctx_ct,
        names=names,
    )


def combco_path(dirpath: str, comp: int) -> str:
    return os.path.join(dirpath, f"{SKCH_PREFIX}.{comp}")


def combco_index_path(dirpath: str, comp: int) -> str:
    return os.path.join(dirpath, f"{IDX_PREFIX}.{comp}")


def abund_path(dirpath: str, comp: int) -> str:
    return combco_path(dirpath, comp) + ".a"


def write_combco(
    dirpath: str,
    comp: int,
    codes: np.ndarray,
    index: np.ndarray,
    abund: np.ndarray | None = None,
) -> None:
    """Write one component's concatenated codes + cumulative index."""
    np.ascontiguousarray(codes, dtype="<u4").tofile(combco_path(dirpath, comp))
    np.ascontiguousarray(index, dtype="<u8").tofile(combco_index_path(dirpath, comp))
    if abund is not None:
        np.ascontiguousarray(abund, dtype="<u2").tofile(abund_path(dirpath, comp))


def read_combco(
    dirpath: str, comp: int, with_abund: bool = False
) -> tuple[np.ndarray, np.ndarray] | tuple[np.ndarray, np.ndarray, np.ndarray]:
    codes = np.fromfile(combco_path(dirpath, comp), dtype="<u4")
    index = np.fromfile(combco_index_path(dirpath, comp), dtype="<u8")
    if with_abund:
        abund = np.fromfile(abund_path(dirpath, comp), dtype="<u2")
        return codes, index, abund
    return codes, index


# --------------------------------------------------------------------------
# inverted index directory ("mco dir")
# --------------------------------------------------------------------------

def mco_path(dirpath: str, comp: int) -> str:
    return os.path.join(dirpath, f"{MCO_GIDS_PREFIX}.{comp}")


def mco_index_path(dirpath: str, comp: int) -> str:
    return os.path.join(dirpath, f"{MCO_IDX_PREFIX}.{comp}")


def write_mco_component(
    dirpath: str, comp: int, row_offset: np.ndarray, gids: np.ndarray
) -> None:
    """Write the dense cumulative row index + postings (co2mco.c:57-72)."""
    np.ascontiguousarray(row_offset, dtype="<u8").tofile(mco_index_path(dirpath, comp))
    np.ascontiguousarray(gids, dtype="<u4").tofile(mco_path(dirpath, comp))


def read_mco_component(dirpath: str, comp: int) -> tuple[np.ndarray, np.ndarray]:
    row_offset = np.fromfile(mco_index_path(dirpath, comp), dtype="<u8")
    gids = np.fromfile(mco_path(dirpath, comp), dtype="<u4")
    return row_offset, gids


# --------------------------------------------------------------------------
# pan (set-operation output) files
# --------------------------------------------------------------------------

def pan_path(dirpath: str, comp: int, uniq: bool = False) -> str:
    prefix = UNIQ_PAN_PREFIX if uniq else PAN_PREFIX
    return os.path.join(dirpath, f"{prefix}.{comp}")


def read_pan(dirpath: str, comp: int) -> np.ndarray:
    """Read pan.<c> or uniq_pan.<c>, whichever exists (command_set.c:326-330)."""
    for uniq in (False, True):
        p = pan_path(dirpath, comp, uniq)
        if os.path.exists(p):
            return np.fromfile(p, dtype="<u4")
    raise FileNotFoundError(f"no pan/uniq_pan component {comp} in {dirpath}")


# --------------------------------------------------------------------------
# abundance vectors (.abv)
# --------------------------------------------------------------------------

ABV_DTYPE = np.dtype([("ref_idx", "<i4"), ("pct", "<f4")])  # binVec_t


def write_abv(path: str, ref_idx: np.ndarray, pct: np.ndarray) -> None:
    arr = np.empty(len(ref_idx), dtype=ABV_DTYPE)
    arr["ref_idx"] = ref_idx
    arr["pct"] = pct
    arr.tofile(path)


def read_abv(path: str) -> np.ndarray:
    return np.fromfile(path, dtype=ABV_DTYPE)


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def _pack_names(names: Sequence[str]) -> bytes:
    out = bytearray()
    for name in names:
        b = name.encode()
        if len(b) >= PATHLEN:
            raise ValueError(f"path longer than {PATHLEN}: {name}")
        out += b + b"\x00" * (PATHLEN - len(b))
    return bytes(out)


def _unpack_names(raw: bytes, n: int) -> list[str]:
    names = []
    for i in range(n):
        chunk = raw[i * PATHLEN : (i + 1) * PATHLEN]
        names.append(chunk.split(b"\x00", 1)[0].decode())
    return names
