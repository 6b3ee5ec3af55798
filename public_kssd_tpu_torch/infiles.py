"""Input-file organisation: dirs/lists/args -> ordered file tables.

Mirrors organize_infile_list / organize_infile_frm_arg / infile_fmt_count
(global_basic.c:143-303) and the suffix sniffing of isOK_fmt_infile
(global_basic.h:129-150).
"""

from __future__ import annotations

import os

ACPT_FMT = ("fna", "fas", "fasta", "fq", "fastq", "fa", "co")  # global_basic.c:90-98
FASTA_FMT = ("fasta", "fna", "fas", "fa")
FASTQ_FMT = ("fq", "fastq")
COMPRESS_FMT = (".gz", ".bz2")


def strip_compress(fname: str) -> str:
    for suf in COMPRESS_FMT:
        if fname.endswith(suf):
            return fname[: -len(suf)]
    return fname


def is_fmt(fname: str, fmts=ACPT_FMT) -> bool:
    base = strip_compress(fname)
    return any(base.endswith("." + f) for f in fmts)


def is_fasta(fname: str) -> bool:
    return is_fmt(fname, FASTA_FMT)


def is_fastq(fname: str) -> bool:
    return is_fmt(fname, FASTQ_FMT)


def organize_infiles(args: list[str], fmt_ck: bool = True) -> list[str]:
    """Expand dir / file arguments into an ordered file list.

    Directory entries come in os.listdir order; the reference uses
    readdir order (filesystem-dependent) — callers needing an exact order
    should pass explicit file lists.
    """
    files: list[str] = []
    for a in args:
        if os.path.isdir(a):
            for name in sorted(os.listdir(a)):
                full = os.path.join(a, name)
                if is_fmt(full):
                    files.append(full)
        elif not fmt_ck or is_fmt(a):
            files.append(a)
        else:
            raise ValueError(
                f"wrong format argument: {a}; supported: "
                + " ".join("." + f for f in ACPT_FMT)
            )
    return files


def organize_infile_list(list_path: str) -> list[str]:
    files = []
    with open(list_path) as f:
        for line in f:
            line = line.strip()
            if line:
                files.append(line)
    return files
