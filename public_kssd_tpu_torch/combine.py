"""Combine multiple query sketch dirs into one (combine_queries,
command_dist.c:1323-1475): concatenate combco blobs, rebase cumulative
indices, merge stat. Dirs with mismatched shuf_id or koc are skipped with
a message, exactly like the reference."""

from __future__ import annotations

import os

import numpy as np

from public_kssd_tpu_torch import formats


def combine_queries(qry_dirs: list[str], out_dir: str) -> formats.CoStat:
    os.makedirs(out_dir, exist_ok=True)
    first = formats.read_co_stat(qry_dirs[0])
    if first.koc:
        raise ValueError("combine_queries(): abundance model not supported yet")
    ctx_list = [first.ctx_ct]
    names = list(first.names)
    all_ctx_ct = first.all_ctx_ct
    infile_num = first.infile_num
    comp_blobs: list[list[np.ndarray]] = [[] for _ in range(first.comp_num)]
    comp_index: list[list[np.ndarray]] = [[] for _ in range(first.comp_num)]
    for c in range(first.comp_num):
        codes, index = formats.read_combco(qry_dirs[0], c)
        comp_blobs[c].append(codes)
        comp_index[c].append(index)
    for i, d in enumerate(qry_dirs[1:], start=1):
        try:
            st = formats.read_co_stat(d)
        except FileNotFoundError:
            print(f"{i}th query {d} is not a valid query: no cofiles.stat")
            continue
        if st.params_id != first.params_id:
            print(
                f"combine_queries(): {i}th shuf_id: {st.params_id} not match "
                f"0th shuf_id: {first.params_id}"
            )
            continue
        if st.koc:
            print(f"combine_queries(): {i}th query abundance model not supported yet")
            continue
        all_ctx_ct += st.all_ctx_ct
        infile_num += st.infile_num
        ctx_list.append(st.ctx_ct)
        names.extend(st.names)
        for c in range(first.comp_num):
            codes, index = formats.read_combco(d, c)
            base = comp_index[c][-1][-1]
            comp_blobs[c].append(codes)
            comp_index[c].append(index[1:] + base)
    for c in range(first.comp_num):
        formats.write_combco(
            out_dir,
            c,
            np.concatenate(comp_blobs[c]),
            np.concatenate(comp_index[c]),
        )
    stat = formats.CoStat(
        params_id=first.params_id,
        koc=False,
        kmerlen=first.kmerlen,
        dim_rd_len=first.dim_rd_len,
        comp_num=first.comp_num,
        infile_num=infile_num,
        all_ctx_ct=all_ctx_ct,
        ctx_ct=np.concatenate(ctx_list),
        names=names,
    )
    formats.write_co_stat(out_dir, stat)
    return stat
