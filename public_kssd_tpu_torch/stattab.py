"""Stat files read with their names in bulk.

``cofiles.stat`` and ``mcofiles.stat`` end in one ``PATHLEN``-byte,
NUL-padded name a genome (``formats``). ``formats.read_co_stat`` and
``read_mco_stat`` turn that table into a list of str, with a slice, a
split and a decode a genome: at GTDB's 65,702-100,000 names, tens of
milliseconds before a search or a composite call does anything else.

``read_co_stat_table`` and ``read_mco_stat_table`` return the same
``CoStat`` and ``McoStat`` with ``names`` a ``NameTable``: the table
read in one read, its rows cut to the longest name and kept as one
``uint8`` array, each name decoded when it is first asked for. A search
prints every name from that array (``native.Names``); a composite
report decodes only the names it writes. The names are those ``formats._unpack_names`` gives:
each row cut at its first NUL (or whole, where it has none) and decoded
as UTF-8, a file that ends early read as if NUL-padded; a row holding
invalid UTF-8 raises ``UnicodeDecodeError`` at read time, as there. Only
rows holding a byte of 0x80 or above are decoded then, so a table of
ASCII names costs no Python loop over its genomes.

Every other caller keeps ``formats``' list readers (``formats`` is a
verbatim copy of the JAX package's).
"""

from __future__ import annotations

import operator
import os
from collections.abc import Sequence

import numpy as np

from public_kssd_tpu_torch import formats
from public_kssd_tpu_torch.formats import PATHLEN


class NameTable(Sequence):
    """A read-only sequence of str over a stat file's fixed-width names.

    ``rows`` keeps each row's first ``width`` bytes (``uint8 [n,
    width]``, C-contiguous): the longest name and the NUL after it, or
    the whole row where a name fills it; ``native.Names`` hands them to
    the formatter as they are. ``lengths`` holds each name's length in
    bytes (int64 [n])."""

    def __init__(self, table: np.ndarray):
        self.lengths = _lengths(table)
        width = min(int(self.lengths.max(initial=0)) + 1, PATHLEN)
        self.rows = np.ascontiguousarray(table[:, :width])
        self.rows.flags.writeable = False
        self._names: list[str | None] = [None] * len(table)
        if self.rows.size and self.rows.max() >= 0x80:
            # the rows whose name (not what follows its NUL) holds such a byte
            inside = np.arange(width) < self.lengths[:, None]
            for i in np.flatnonzero(((self.rows >= 0x80) & inside).any(axis=1)):
                self._names[i] = self._decode(i)  # raises on invalid UTF-8

    def _decode(self, i: int) -> str:
        return self.rows[i].tobytes().split(b"\x00", 1)[0].decode()

    def __len__(self) -> int:
        return len(self._names)

    def __getitem__(self, i) -> str:
        i = operator.index(i)
        name = self._names[i]
        if name is None:
            name = self._names[i] = self._decode(i)
        return name


def _lengths(rows: np.ndarray, block: int = 8192) -> np.ndarray:
    """The first NUL of each row of ``rows``, or ``PATHLEN`` where a row
    has none (int64). A block of rows at a time: the temporaries stay a
    few MiB, whatever the table's size."""
    out = np.empty(len(rows), np.int64)
    for a in range(0, len(rows), block):
        sub = rows[a:a + block]
        first = np.argmin(sub != 0, axis=1)
        cut = sub[np.arange(len(first)), first] == 0
        out[a:a + block] = np.where(cut, first, PATHLEN)
    return out


def _read_names(f, n: int) -> NameTable:
    """The next ``n`` rows of ``f`` as a NameTable, in one read; rows past
    the end of the file are NULs, as ``formats._unpack_names`` reads
    them. The rows are read into a bytes object, as ``formats`` reads
    them, which is dropped once they are cut to their width: a
    composite's host work after the read allocates and frees tens of MiB
    a call, and a table kept at its full size (16.8 MB at GTDB's 65,702
    names) through that work made it several times slower on an H100
    host."""
    raw = f.read(n * PATHLEN)
    raw += bytes(n * PATHLEN - len(raw))
    return NameTable(np.frombuffer(raw, np.uint8).reshape(n, PATHLEN))


def read_co_stat_table(dirpath: str) -> formats.CoStat:
    """``formats.read_co_stat`` with ``names`` a ``NameTable``."""
    with open(os.path.join(dirpath, formats.CO_DSTAT), "rb") as f:
        (shuf_id, koc, kmerlen, dim_rd_len, comp_num, infile_num, all_ctx_ct) = (
            formats._CO_DSTAT_STRUCT.unpack(f.read(formats._CO_DSTAT_STRUCT.size))
        )
        ctx_ct = np.fromfile(f, dtype="<u4", count=infile_num)
        names = _read_names(f, infile_num)
    return formats.CoStat(
        params_id=shuf_id, koc=bool(koc), kmerlen=kmerlen, dim_rd_len=dim_rd_len,
        comp_num=comp_num, infile_num=infile_num, all_ctx_ct=all_ctx_ct,
        ctx_ct=ctx_ct, names=names,
    )


def read_mco_stat_table(dirpath: str) -> formats.McoStat:
    """``formats.read_mco_stat`` with ``names`` a ``NameTable``."""
    with open(os.path.join(dirpath, formats.MCO_DSTAT), "rb") as f:
        shuf_id, kmerlen, dim_rd_len, comp_num, infile_num = (
            formats._MCO_DSTAT_STRUCT.unpack(f.read(formats._MCO_DSTAT_STRUCT.size))
        )
        ctx_ct = np.fromfile(f, dtype="<u4", count=infile_num)
        names = _read_names(f, infile_num)
    return formats.McoStat(
        params_id=shuf_id, kmerlen=kmerlen, dim_rd_len=dim_rd_len,
        comp_num=comp_num, infile_num=infile_num, ctx_ct=ctx_ct, names=names,
    )
