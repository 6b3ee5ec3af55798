"""Distance statistics + reference-exact output formatting.

Implements the metric/distance/CI/p-value/FDR math of output_ctrl
(command_dist.c:1251-1287) and the printing pipeline of dist_print_nobin
(command_dist.c:1161-1250) with bit-identical float64 arithmetic and
glibc-printf-compatible formatting (including inf/-nan spellings), so
``distance.out`` matches the reference byte for byte.

Given shared counts XnY and sketch sizes X (ref), Y (qry):

  Jaccard  J = XnY / (X + Y - XnY)         MashD = -ln(2J/(1+J)) / kmerlen
  Containment C = XnY / min(X, Y)          AafD  = -ln(C) / kmerlen
  sd = sqrt(m (1-m) / denom)               p = 0.5 erfc(m / sd * sqrt(1/2))
  FDR = p * (#ref * #qry)                  CI95 = m -/+ 1.96 sd

with the optional shared-count correction term rs (--correction,
command_dist.c:1254-1261).
"""

from __future__ import annotations

import dataclasses
import math
import os
import struct
from enum import IntEnum

import numpy as np

ALP_SIZE = 4  # command_dist.c:418


class Metric(IntEnum):  # MTRIC (command_dist_wrapper.h:22)
    JACCARD = 0
    CONTAINMENT = 1


class Fields(IntEnum):  # PFIELD (command_dist_wrapper.h:23)
    DIST = 0
    QV = 1
    CI = 2
    FULL = 3  # extension: the README-documented 4-metric table (README.md:48-64)


@dataclasses.dataclass
class OutputOptions:
    """-M/-O/-N/-D/--correction semantics (command_dist_wrapper.c:41-65)."""

    metric: Metric = Metric.JACCARD
    fields: Fields = Fields.CI
    correction: bool = False
    max_dist: float = 1.0  # -D
    top_n: int = 0  # -N (0 = all)


def fmt_double(x: float, spec: str) -> str:
    """Format a double the way glibc printf does, including specials:
    %.6lf -> 'inf'/'nan'/'-nan'; %E -> 'INF'/'NAN'/'-NAN'."""
    if math.isnan(x):
        s = "-nan" if struct.pack("<d", x)[7] & 0x80 else "nan"
        return s.upper() if spec == "E" else s
    if math.isinf(x):
        s = "-inf" if x < 0 else "inf"
        return s.upper() if spec == "E" else s
    if spec == "E":
        return f"{x:E}"
    return f"{x:.6f}"


def _get_metric_arg(metric: Metric, m: float) -> float:
    """GET_MATRIC macro (command_dist.c:1251): the log argument.
    nan (with sign) propagates through like C doubles."""
    if metric == Metric.JACCARD:
        return 1.0 / (2.0 * m) + 0.5 if m != 0 else math.inf
    return 1.0 / m if m != 0 else math.inf


def correction_rs(x_only: float, y_only: float, kmerlen: int, dim_rd_len: int) -> float:
    """Shared-count correction term (command_dist.c:1254-1261)."""
    p_base = 1.0 - 1.0 / math.pow(ALP_SIZE, kmerlen - dim_rd_len)
    p_x = 1.0 - math.pow(p_base, x_only)
    p_y = 1.0 - math.pow(p_base, y_only)
    denom = p_x + p_y - 2.0 * p_x * p_y
    # self-pair (x_only = y_only = 0): 0/0 -> -nan like the reference's
    # SSE division, NOT a ZeroDivisionError
    return _c_div(p_x * p_y * (x_only + y_only), denom)


def format_pair_line(
    qname: str,
    rname: str,
    x_size: int,
    y_size: int,
    xny: int,
    kmerlen: int,
    dim_rd_len: int,
    cmprsn_num: int,
    opts: OutputOptions,
) -> str | None:
    """One distance.out line (output_ctrl, command_dist.c:1252-1287);
    None when filtered by -D."""
    rs = 0.0
    if opts.correction:
        rs = correction_rs(x_size - xny, y_size - xny, kmerlen, dim_rd_len)
    if opts.metric == Metric.JACCARD:
        denom = x_size + y_size - xny
    else:
        denom = min(x_size, y_size)
    m = (xny - rs) / denom
    arg = _get_metric_arg(opts.metric, m)
    with np.errstate(invalid="ignore", divide="ignore"):
        dist = _log(arg) / kmerlen
    if dist > 1:
        dist = 1.0
    if dist > opts.max_dist:
        return None
    parts = [
        f"{qname}\t{rname}\t{xny}-{_uint(rs)}|{x_size}|{y_size}"
        f"\t{fmt_double(m, 'f')}\t{fmt_double(dist, 'f')}"
    ]
    if opts.fields > Fields.DIST:
        var = m * (1 - m) / denom
        sd = math.sqrt(var) if var >= 0 else _NEG_NAN  # glibc pow(neg, 0.5) = -nan
        q = _c_div(m, sd)  # C double division: x/0 = +/-inf, 0/0 = -nan (SSE)
        # glibc erfc and IEEE multiply propagate the nan operand unchanged,
        # so 0.5*erfc(-nan * c) stays -nan and prints "-NAN" under %E
        pv = q if math.isnan(q) else 0.5 * _erfc(q * math.sqrt(0.5))
        parts.append(f"\t{fmt_double(pv, 'E')}\t{fmt_double(pv * cmprsn_num, 'E')}")
        if opts.fields > Fields.QV:
            ci1 = m - 1.96 * sd
            ci2 = m + 1.96 * sd
            d1 = _log(_get_metric_arg(opts.metric, ci2)) / kmerlen
            d2 = _log(_get_metric_arg(opts.metric, ci1)) / kmerlen
            parts.append(
                f"\t[{fmt_double(ci1, 'f')},{fmt_double(ci2, 'f')}]"
                f"\t[{fmt_double(d1, 'f')},{fmt_double(d2, 'f')}]"
            )
    parts.append("\n")
    return "".join(parts)


HEADER = {  # command_dist.c:1188-1191
    Metric.JACCARD: ("Jaccard\tMashD", "P-value(J)\tFDR(J)", "Jaccard_CI\tMashD_CI"),
    Metric.CONTAINMENT: (
        "ContainmentM\tAafD",
        "P-value(C)\tFDR(C)",
        "ContainmentM_CI\tAafD_CI",
    ),
}


def format_header(opts: OutputOptions) -> str:
    cols = ["Qry\tRef\tShared_k|Ref_s|Qry_s"]
    for i in range(int(opts.fields) + 1):
        cols.append("\t" + HEADER[opts.metric][i])
    return "".join(cols) + "\n"


def print_threads(threads: int = 0) -> int:
    """The threads that format distance.out (``dist -p``): ``threads``,
    or every CPU this process may run on when it is 0."""
    if threads < 0:
        raise ValueError(f"threads must be >= 0 (0 = every usable CPU), got {threads}")
    return threads or len(os.sched_getaffinity(0))


# The native writer's formatted blocks in flight hold at most about this
# many bytes (estimated from the longest names), whatever the thread
# count, and it cuts at least this many blocks for each thread, so that
# no thread is left with a long tail.
PRINT_BUFFER_BYTES = 256 << 20
BLOCKS_PER_THREAD = 8
# a line's bytes beside its two names, rounded up: four uint32s and up
# to eight formatted doubles of the values a count can give; a block
# whose values print longer (a huge corrected m) grows its buffer
LINE_BYTES = 160


def print_blocks(n_qry: int, row_items: int, threads: int, line_bytes: int,
                 split: bool):
    """Cuts the print into blocks, in file order: ``(q0, q1, r0, r1)``,
    items ``[r0, r1)`` of each query row in ``[q0, q1)``, each row
    holding ``row_items`` items. A block holds about the lines that keep
    2 x ``threads`` blocks of ``line_bytes`` a line within
    PRINT_BUFFER_BYTES, and no more than BLOCKS_PER_THREAD blocks a
    thread allow. Whole rows go together while they fit; a longer row is
    cut into item ranges when ``split`` (a -N row is never cut: its
    items are known only once it is selected)."""
    lines = max(1, min(PRINT_BUFFER_BYTES // (2 * threads * line_bytes),
                       -(-n_qry * row_items // (BLOCKS_PER_THREAD * threads))))
    if row_items > lines and split:
        return [(q, q + 1, r, min(r + lines, row_items))
                for q in range(n_qry) for r in range(0, row_items, lines)]
    k = max(1, lines // max(row_items, 1))
    return [(q, min(q + k, n_qry), 0, row_items) for q in range(0, n_qry, k)]


def _write_native(path, counts, ref_sizes, qry_sizes, ref_names, qry_names,
                  kmerlen, dim_rd_len, opts, threads):
    """distance.out through the native block formatter
    (native/kssd_print.c): blocks of lines format on ``threads`` threads
    (the ctypes call drops the GIL) into per-block buffers, and this
    thread writes them in query order after the header, while the later
    blocks format. At most 2 x ``threads`` blocks are in flight. The
    main thread's wait for each block and its write are the spans
    ``print.wait`` and ``print.write`` (``tools/print_spans.py``)."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from public_kssd_tpu_torch import native

    span = torch.profiler.record_function

    n_qry, n_ref = counts.shape
    cmprsn_num = float(n_ref * n_qry)
    qnames, rnames = native.Names(qry_names), native.Names(ref_names)
    ref_sz = np.ascontiguousarray(ref_sizes, np.uint32)
    qry_sz = np.ascontiguousarray(qry_sizes, np.uint32)
    row_items = min(opts.top_n, n_ref) if opts.top_n else n_ref
    line_bytes = qnames.longest + rnames.longest + LINE_BYTES
    blocks = print_blocks(n_qry, row_items, threads, line_bytes,
                          split=not opts.top_n)

    def fmt(block, buf):
        q0, q1, r0, r1 = block
        # a -m memmap's rows are read here, by the worker, as they print
        rows = np.ascontiguousarray(counts[q0:q1], np.uint32)
        sel = sel_off = None
        if opts.top_n:
            picks = [np.asarray(_top_n_rids(rows[i], ref_sizes, int(qry_sizes[q]),
                                            opts), np.int64)
                     for i, q in enumerate(range(q0, q1))]
            sel = np.concatenate(picks) if picks else np.zeros(0, np.int64)
            sel_off = np.zeros(len(picks) + 1, np.int64)
            np.cumsum([p.size for p in picks], out=sel_off[1:])
        need = (q1 - q0) * (r1 - r0) * line_bytes
        if buf is None or buf.size < need:
            buf = np.empty(need, np.uint8)
        return native.dist_rows_buf(
            qnames, qry_sz, rnames, ref_sz, rows, q0, r0, r1, sel, sel_off,
            kmerlen, dim_rd_len, cmprsn_num, int(opts.metric),
            int(opts.fields), int(opts.correction), float(opts.max_dist), buf,
        )

    with open(path, "wb") as f, ThreadPoolExecutor(threads) as pool:
        f.write(format_header(opts).encode())
        pending, free = deque(), [None] * (2 * threads)

        def write_first():
            with span("print.wait"):
                buf, n = pending.popleft().result()
            with span("print.write"):
                f.write(memoryview(buf)[:n])
            free.append(buf)

        try:
            for block in blocks:
                if not free:
                    write_first()
                pending.append(pool.submit(fmt, block, free.pop()))
            while pending:
                write_first()
        finally:
            for fut in pending:
                fut.cancel()


def write_distance_out(
    path: str,
    counts: np.ndarray,  # uint32 [n_qry, n_ref]
    ref_sizes: np.ndarray,
    qry_sizes: np.ndarray,
    ref_names: list[str],
    qry_names: list[str],
    kmerlen: int,
    dim_rd_len: int,
    opts: OutputOptions,
    threads: int = 0,
) -> int:
    """Emit distance.out (dist_print_nobin, command_dist.c:1161-1250);
    returns the threads that formatted it.

    The lines are formatted by the NATIVE block formatter
    (native/kssd_print.c) when available — the reference build's libm
    arithmetic, and each field written by hand with the bytes glibc's
    printf gives: the float fields rounded half to even from the exact
    value (fma two-products), snprintf itself for the rare value an
    exact path cannot decide (tests/test_torch_print.py holds the field
    writers against snprintf and Python's formatting) — on
    ``threads`` threads (``dist -p``; 0 = every CPU this process may
    use), and written in query order: the bytes do not depend on the
    thread count. ``counts`` may be a ``np.memmap`` (``-m``). Python
    fallback (and KSSD_TPU_NATIVE_PRINT=off, and the FULL table) keeps
    identical output; tests compare the writers byte for byte.
    """
    threads = print_threads(threads)
    n_qry, n_ref = counts.shape
    cmprsn_num = n_ref * n_qry
    full = opts.fields == Fields.FULL
    if not full and os.environ.get("KSSD_TPU_NATIVE_PRINT", "auto") != "off":
        from public_kssd_tpu_torch import native

        if native.get_lib() is not None:
            _write_native(path, counts, ref_sizes, qry_sizes, ref_names,
                          qry_names, kmerlen, dim_rd_len, opts, threads)
            return threads
    with open(path, "w") as f:
        f.write(FULL_HEADER if full else format_header(opts))
        for q in range(n_qry):
            y = int(qry_sizes[q])
            rids = range(n_ref)
            if opts.top_n:
                rids = _top_n_rids(counts[q], ref_sizes, y, opts)
            for r in rids:
                if full:
                    f.write(format_full_pair_line(
                        qry_names[q], ref_names[r], int(ref_sizes[r]), y,
                        int(counts[q, r]), kmerlen, dim_rd_len, n_ref, n_qry,
                    ))
                    continue
                line = format_pair_line(
                    qry_names[q],
                    ref_names[r],
                    int(ref_sizes[r]),
                    y,
                    int(counts[q, r]),
                    kmerlen,
                    dim_rd_len,
                    cmprsn_num,
                    opts,
                )
                if line:
                    f.write(line)
    return 1


def _full_pair_stats(
    x_size: int, y_size: int, xny: int, kmerlen: int, dim_rd_len: int,
    ref_num: int, qry_num: int,
) -> dict:
    """The shared 4-metric + corrected-CI + p/q body of the reference's
    full-table printers (fname_dist_print command_dist.c:1041-1075 and
    koc_dist_print_nobin :1106-1147), with C float semantics."""
    xuy = x_size + y_size - xny
    min_xy = min(x_size, y_size)
    x_only, y_only = x_size - xny, y_size - xny
    jac = _c_div(float(xny), float(xuy))
    contain = _c_div(float(xny), float(min_xy))
    dm = 0.0 if jac == 1 else -_log(_c_div(2 * jac, 1 + jac)) / kmerlen
    da = 0.0 if contain == 1 else -_log(contain) / kmerlen
    p_base = 1.0 - 1.0 / math.pow(ALP_SIZE, kmerlen - dim_rd_len)
    p_x = 1.0 - math.pow(p_base, x_only)
    p_y = 1.0 - math.pow(p_base, y_only)
    rs = _c_div(p_x * p_y * (x_only + y_only), p_x + p_y - 2 * p_x * p_y)
    j_prim = _c_div(xny - rs, float(xuy))
    c_prim = _c_div(xny - rs, float(min_xy))
    dm_prim = 0.0 if j_prim == 1 else -_log(_c_div(2 * j_prim, 1 + j_prim)) / kmerlen
    da_prim = 0.0 if c_prim == 1 else -_log(c_prim) / kmerlen
    sd_j = _pow_half(_c_div(j_prim * (1 - j_prim), float(xuy)))
    sd_c = _pow_half(_c_div(c_prim * (1 - c_prim), float(min_xy)))
    ci_j1, ci_j2 = j_prim - 1.96 * sd_j, j_prim + 1.96 * sd_j
    ci_c1, ci_c2 = c_prim - 1.96 * sd_c, c_prim + 1.96 * sd_c
    ci_dm1 = 0.0 if ci_j2 == 1 else -_log(_c_div(2 * ci_j2, 1 + ci_j2)) / kmerlen
    ci_dm2 = 0.0 if ci_j1 == 1 else -_log(_c_div(2 * ci_j1, 1 + ci_j1)) / kmerlen
    ci_da1 = 0.0 if ci_c2 == 1 else -_log(ci_c2) / kmerlen
    ci_da2 = 0.0 if ci_c1 == 1 else -_log(ci_c1) / kmerlen
    q_j = _c_div(j_prim, sd_j)
    q_c = _c_div(c_prim, sd_c)
    pv_j = q_j if math.isnan(q_j) else 0.5 * _erfc(q_j * math.sqrt(0.5))
    pv_c = q_c if math.isnan(q_c) else 0.5 * _erfc(q_c * math.sqrt(0.5))
    return dict(
        jac=jac, contain=contain, dm=dm, da=da, rs=rs,
        j_prim=j_prim, c_prim=c_prim, dm_prim=dm_prim, da_prim=da_prim,
        ci_j=(ci_j1, ci_j2), ci_c=(ci_c1, ci_c2),
        ci_dm=(ci_dm1, ci_dm2), ci_da=(ci_da1, ci_da2),
        pv_j=pv_j, pv_c=pv_c,
        qv_j=pv_j * ref_num * qry_num, qv_c=pv_c * ref_num * qry_num,
    )


def format_koc_pair_line(
    qname: str,
    rname: str,
    x_size: int,
    y_size: int,
    xny: int,
    shared_koc: int,
    kmerlen: int,
    dim_rd_len: int,
    ref_num: int,
    qry_num: int,
) -> str:
    """One abundance-weighted line, mirroring koc_dist_print_nobin's
    printf (command_dist.c:1148-1153) exactly.

    That reference path is UNREACHABLE dead code (no caller of
    koc_dist_print_nobin or mco_cbd_koc_compatible_dist exists;
    dist_dispatch only reaches mco_cbdco_nobin_dist, command_dist.c:134),
    so there is no binary to golden-test against — this port reproduces
    its arithmetic and formatting and is pinned by a Python oracle test.
    """
    s = _full_pair_stats(x_size, y_size, xny, kmerlen, dim_rd_len,
                         ref_num, qry_num)
    abund_pct = _c_div(float(shared_koc), float(xny))
    f = lambda x: fmt_double(x, "f")  # noqa: E731
    e = lambda x: fmt_double(x, "E")  # noqa: E731
    return (
        f"{qname}\t{rname}\t{f(abund_pct)}\t{xny}-{_uint(s['rs'])}|{x_size}|{y_size}"
        f"\t{f(s['jac'])}\t{f(s['dm'])}\t{f(s['contain'])}\t{f(s['da'])}"
        f"\t{f(s['j_prim'])}[{f(s['ci_j'][0])},{f(s['ci_j'][1])}]"
        f"\t{f(s['dm_prim'])}[{f(s['ci_dm'][0])},{f(s['ci_dm'][1])}]"
        f"\t{f(s['c_prim'])}[{f(s['ci_c'][0])},{f(s['ci_c'][1])}]"
        f"\t{f(s['da_prim'])}[{f(s['ci_da'][0])},{f(s['ci_da'][1])}]"
        f"\t{e(s['pv_j'])}\t{e(s['pv_c'])}\t{e(s['qv_j'])}\t{e(s['qv_c'])}\n"
    )


FULL_HEADER = (
    "Qry\tRef\tShared_k|Ref_s|Qry_s\tJaccard\tMashD\tContainmentM\tAafD"
    "\tJaccard_CI\tMashD_CI\tContainmentM_CI\tAafD_CI"
    "\tP-value(J)\tP-value(C)\tFDR(J)\tFDR(C)\n"
)


def format_full_pair_line(
    qname: str,
    rname: str,
    x_size: int,
    y_size: int,
    xny: int,
    kmerlen: int,
    dim_rd_len: int,
    ref_num: int,
    qry_num: int,
) -> str:
    """One full 4-metric line: the output the README documents
    (README.md:48-64), produced in the reference only by the UNREACHABLE
    legacy path fname_dist_print (command_dist.c:1070-1075 printf).
    Exposed here as ``-O 3`` so the documented table is actually
    obtainable."""
    s = _full_pair_stats(x_size, y_size, xny, kmerlen, dim_rd_len,
                         ref_num, qry_num)
    f = lambda x: fmt_double(x, "f")  # noqa: E731
    e = lambda x: fmt_double(x, "E")  # noqa: E731
    return (
        f"{qname}\t{rname}\t{xny}-{_uint(s['rs'])}|{x_size}|{y_size}"
        f"\t{f(s['jac'])}\t{f(s['dm'])}\t{f(s['contain'])}\t{f(s['da'])}"
        f"\t[{f(s['ci_j'][0])},{f(s['ci_j'][1])}]"
        f"\t[{f(s['ci_dm'][0])},{f(s['ci_dm'][1])}]"
        f"\t[{f(s['ci_c'][0])},{f(s['ci_c'][1])}]"
        f"\t[{f(s['ci_da'][0])},{f(s['ci_da'][1])}]"
        f"\t{e(s['pv_j'])}\t{e(s['pv_c'])}\t{e(s['qv_j'])}\t{e(s['qv_c'])}\n"
    )


def write_koc_distance_out(
    path: str,
    counts: np.ndarray,  # uint32 [n_qry, n_ref] shared_k_ct
    koc_counts: np.ndarray,  # uint64 [n_qry, n_ref] shared_koc_ct
    ref_sizes: np.ndarray,
    qry_sizes: np.ndarray,
    ref_names: list[str],
    qry_names: list[str],
    kmerlen: int,
    dim_rd_len: int,
) -> None:
    """Append the koc (abundance-weighted) table to ``path``
    (koc_dist_print_nobin opens distance.out in append mode and writes
    no header, command_dist.c:1094-1095)."""
    n_qry, n_ref = counts.shape
    with open(path, "a") as f:
        for q in range(n_qry):
            for r in range(n_ref):
                f.write(
                    format_koc_pair_line(
                        qry_names[q], ref_names[r],
                        int(ref_sizes[r]), int(qry_sizes[q]),
                        int(counts[q, r]), int(koc_counts[q, r]),
                        kmerlen, dim_rd_len, n_ref, n_qry,
                    )
                )


def _pow_half(x: float) -> float:
    """glibc pow(x, 0.5): negative base -> -nan (domain error QNaN)."""
    if math.isnan(x):
        return x
    if x < 0:
        return _NEG_NAN
    return math.sqrt(x)


def _top_n_rids(row: np.ndarray, ref_sizes: np.ndarray, y: int, opts: OutputOptions):
    """-N best-hit selection (insertion heap, command_dist.c:1212-1227):
    descending metric, ties keep the earlier ref id first."""
    x = ref_sizes.astype(np.float64)
    xny = row.astype(np.float64)
    if opts.metric == Metric.CONTAINMENT:
        denom = np.minimum(x, float(y))
    else:
        denom = x + float(y) - xny
    metric = xny / denom
    order = np.argsort(-metric, kind="stable")[: opts.top_n]
    # reference keeps only slots with metric strictly > 0-initialised
    return [int(r) for r in order if metric[r] > 0.0]


def _log(x: float) -> float:
    """glibc/x86 log: log(neg) = -nan, log(0) = -inf, log(inf) = inf."""
    if math.isnan(x):
        return x
    if x < 0:
        return _NEG_NAN
    if x == 0:
        return -math.inf
    return math.log(x) if not math.isinf(x) else math.inf


def _erfc(x: float) -> float:
    if math.isnan(x):
        return math.nan
    if math.isinf(x):
        return 0.0 if x > 0 else 2.0
    return math.erfc(x)


_NEG_NAN = struct.unpack("<d", b"\x00\x00\x00\x00\x00\x00\xf8\xff")[0]


def _c_div(a: float, b: float) -> float:
    """IEEE double division with x86 C semantics (no ZeroDivisionError):
    x/0 = +/-inf, 0/0 = default QNaN with sign bit set (-nan)."""
    if math.isnan(b):
        return b
    if b == 0.0:
        if math.isnan(a):
            return a
        if a == 0.0:
            return _NEG_NAN
        return math.copysign(math.inf, a) * math.copysign(1.0, b)
    return a / b


def _uint(rs: float) -> int:
    """(unsigned int) cast of the correction term for printing."""
    if math.isnan(rs):
        return 0
    return int(rs) & 0xFFFFFFFF
