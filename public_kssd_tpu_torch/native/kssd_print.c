/* distance.out block formatter: the lines of a block of query rows of
 * dist_print_nobin (output_ctrl, command_dist.c:1252-1287), written into
 * a caller-given buffer so that blocks format on many threads at once
 * and are written to the file in query order by the caller.
 *
 * The arithmetic is kssd_dist_row's (kssd_host.c) pair for pair, and
 * the text goes through glibc's own printf family (vsnprintf), so the
 * bytes are the reference build's: same libm, same printf, same x86
 * double semantics (log(neg) = -nan, 0/0 = -nan, (unsigned)nan = 0
 * after the int64 truncation gcc emits).
 *
 * Built into the same helper library as kssd_host.c, with its flags.
 */

#include <math.h>
#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>

/* Output cursor: bytes past cap are counted, never written. */
struct kssd_out {
    char *buf;
    int64_t cap;
    int64_t used;
    int full; /* some text did not fit */
};

static void kssd_put(struct kssd_out *o, const char *fmt, ...)
{
    va_list ap;
    int64_t room = o->used < o->cap ? o->cap - o->used : 0;
    va_start(ap, fmt);
    int n = vsnprintf(room ? o->buf + o->used : NULL, (size_t)room, fmt, ap);
    va_end(ap);
    /* vsnprintf keeps one byte for its NUL: the text fits iff n < room */
    if (n >= room)
        o->full = 1;
    o->used += n;
}

static inline double kssd_metric_arg(int metric, double m)
{
    return metric == 0 ? 1 / (2 * m) + 0.5 : 1 / m;
}

/* Formats, for each query q in [q0, q1), the items [r0, r1) of its row
 * into buf. An item is a ref id: j itself, or, when rid_sel is given,
 * rid_sel[sel_off[q - q0] + j] (the query's top-N selection in print
 * order; items past the selection's end are skipped). counts holds rows
 * q0..q1-1 of the shared-count matrix, n_ref columns each; qry_sizes,
 * qname_off index by q. Names are NUL-terminated at byte offsets.
 *
 * Returns the bytes the lines take when they fit in cap; otherwise a
 * value larger than cap, the capacity to call again with (nothing is
 * ever written past cap). */
int64_t kssd_dist_rows_buf(
    const uint8_t *qname_blob, const int64_t *qname_off,
    const uint32_t *qry_sizes,
    const uint8_t *rname_blob, const int64_t *rname_off,
    const uint32_t *ref_sizes, const uint32_t *counts, int64_t n_ref,
    int64_t q0, int64_t q1, int64_t r0, int64_t r1,
    const int64_t *rid_sel, const int64_t *sel_off,
    int kmerlen, int dim_rd_len, double cmprsn_num,
    int metric, int pfield, int correction, double dthreshold,
    char *buf, int64_t cap)
{
    struct kssd_out o = {buf, cap, 0, 0};
    for (int64_t q = q0; q < q1; q++) {
        const char *qname = (const char *)qname_blob + qname_off[q];
        const uint32_t *row = counts + (q - q0) * n_ref;
        uint32_t y_size = qry_sizes[q];
        int64_t end = r1;
        if (rid_sel) {
            int64_t n_sel = sel_off[q - q0 + 1] - sel_off[q - q0];
            if (end > n_sel)
                end = n_sel;
        }
        for (int64_t j = r0; j < end; j++) {
            int64_t r = rid_sel ? rid_sel[sel_off[q - q0] + j] : j;
            uint32_t x_size = ref_sizes[r];
            uint32_t xny = row[r];
            double rs = 0;
            if (correction) {
                unsigned int x_only = x_size - xny;
                unsigned int y_only = y_size - xny;
                double p_base = 1 - 1 / pow(4.0, (kmerlen - dim_rd_len));
                double p_x = 1 - pow(p_base, x_only);
                double p_y = 1 - pow(p_base, y_only);
                rs = p_x * p_y * (x_only + y_only)
                     / (p_x + p_y - 2 * p_x * p_y);
            }
            unsigned int tmp = metric == 0 ? x_size + y_size - xny
                               : (x_size < y_size ? x_size : y_size);
            double m = ((double)xny - rs) / tmp;
            double dist = log(kssd_metric_arg(metric, m)) / kmerlen;
            if (dist > 1)
                dist = 1;
            if (dist > dthreshold)
                continue;
            const char *rname = (const char *)rname_blob + rname_off[r];
            /* (unsigned int)rs via int64 truncation: the reference's plain
             * -O3 build lowers the cast through cvttsd2si (nan -> INT64_MIN
             * -> low32 0); -march=native here would otherwise pick AVX-512's
             * vcvttsd2usi (nan -> 0xFFFFFFFF) and diverge byte-wise. */
            unsigned int rs_u = (unsigned int)(int64_t)rs;
            if (pfield == 0) {
                kssd_put(&o, "%s\t%s\t%u-%u|%u|%u\t%.6lf\t%.6lf\n",
                         qname, rname, xny, rs_u, x_size, y_size, m, dist);
                continue;
            }
            double sd = pow(m * (1 - m) / tmp, 0.5);
            double pv = 0.5 * erfc(m / sd * pow(0.5, 0.5));
            if (pfield == 1) {
                kssd_put(&o, "%s\t%s\t%u-%u|%u|%u\t%.6lf\t%.6lf\t%E\t%E\n",
                         qname, rname, xny, rs_u, x_size, y_size, m, dist,
                         pv, pv * cmprsn_num);
                continue;
            }
            double c1 = m - 1.96 * sd;
            double c2 = m + 1.96 * sd;
            double d1 = log(kssd_metric_arg(metric, c2)) / kmerlen;
            double d2 = log(kssd_metric_arg(metric, c1)) / kmerlen;
            kssd_put(&o, "%s\t%s\t%u-%u|%u|%u\t%.6lf\t%.6lf\t%E\t%E"
                     "\t[%.6lf,%.6lf]\t[%.6lf,%.6lf]\n",
                     qname, rname, xny, rs_u, x_size, y_size, m, dist,
                     pv, pv * cmprsn_num, c1, c2, d1, d2);
        }
    }
    /* +1: the last vsnprintf's NUL */
    return o.full ? o.used + 1 : o.used;
}
