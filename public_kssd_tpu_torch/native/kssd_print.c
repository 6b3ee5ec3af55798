/* distance.out block formatter: the lines of a block of query rows of
 * dist_print_nobin (output_ctrl, command_dist.c:1252-1287), written into
 * a caller-given buffer so that blocks format on many threads at once
 * and are written to the file in query order by the caller.
 *
 * The arithmetic is kssd_dist_row's (kssd_host.c) pair for pair, with
 * the reference build's x86 double semantics (log(neg) = -nan, 0/0 =
 * -nan, (unsigned)nan = 0 after the int64 truncation gcc emits). The
 * text is written field by field, with the bytes glibc's printf gives
 * for every value:
 *   - names by memcpy, %u by a digit loop, the separators as bytes;
 *   - inf and nan as glibc spells them ("inf", "-nan"; "INF", "-NAN"
 *     for %E: the sign of a nan is its sign bit);
 *   - %.6lf and %E from the exact value: x * 10^k is y + t, with the
 *     product's rounding error t from fma() (exact; glibc's fma is the
 *     hardware instruction where the host has it and an exact emulation
 *     elsewhere) or the division's remainder, and rounded half to even
 *     as glibc rounds the exact binary value. Where no power of ten is
 *     an exact double (%E of values below 1e-16 or from 1e29 up), a
 *     double-double power with a relative error under 2^-96 gives y + t
 *     within y * 2^-95, and a value within twice that of a rounding
 *     boundary is printed by snprintf itself; so are %.6lf of |x| * 1e6
 *     >= 2^53 and %E of |x| < 1e-300.
 * tests/test_torch_print.py holds the field writers against snprintf and
 * Python's formatting (kssd_fmt_field, kssd_fmt_check).
 *
 * Built into the same helper library as kssd_host.c, with its flags:
 * no -march=native, -mfma or -ffast-math, under which gcc would fuse the
 * a * b + c of the arithmetic above and change its bits.
 */

#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

/* The most bytes a line takes beside its two names: four %u, six
 * %.6lf of up to 317 bytes (-DBL_MAX), two %E of 14, the separators and
 * snprintf's NUL. */
#define KSSD_LINE_MAX 2048
#define KSSD_F6_MAX 320

static const char kssd_pairs[] =
    "00010203040506070809101112131415161718192021222324252627282930313233"
    "34353637383940414243444546474849505152535455565758596061626364656667"
    "6869707172737475767778798081828384858687888990919293949596979899";

static char *kssd_put_u64(char *p, uint64_t v)
{
    char tmp[20];
    int n = 0;
    do {
        tmp[n++] = (char)('0' + v % 10);
        v /= 10;
    } while (v);
    while (n)
        *p++ = tmp[--n];
    return p;
}

/* v < 10^6 as exactly six digits */
static char *kssd_put_6(char *p, uint32_t v)
{
    for (int i = 4; i >= 0; i -= 2) {
        memcpy(p + i, kssd_pairs + 2 * (v % 100), 2);
        v /= 100;
    }
    return p + 6;
}

static char *kssd_put_str(char *p, const char *s, size_t n)
{
    memcpy(p, s, n);
    return p + n;
}

static char *kssd_put_nonfinite(char *p, double x, int upper)
{
    if (signbit(x))
        *p++ = '-';
    const char *s = isnan(x) ? (upper ? "NAN" : "nan") : (upper ? "INF" : "inf");
    return kssd_put_str(p, s, 3);
}

/* y + t rounded half to even, for y >= 0 a double below 2^53 and t of at
 * most half an ulp of y (its sign is all that is read unless ulp(y) = 1):
 * the exact value is above, at or below y's integer part + 1/2 as
 * frac(y) - 1/2 says, which is a multiple of ulp(y) when it is not 0
 * (or, for y < 1/2, farther from 0 than |t|). */
static uint64_t kssd_round(double y, double t)
{
    uint64_t n = (uint64_t)y;
    double s = (y - (double)n) - 0.5; /* y - n is exact */
    if (s > 0 || (s == 0 && t > 0))
        return n + 1;
    if (s == 0 && t == 0)
        return n + (n & 1);
    if (y >= 0x1p52 && (t == 0.5 || t == -0.5)) /* ulp(y) = 1: a tie */
        return t > 0 ? n + (n & 1) : n - (n & 1);
    return n;
}

/* %.6lf */
static char *kssd_put_f6(char *p, double x, int *slow)
{
    if (!isfinite(x))
        return kssd_put_nonfinite(p, x, 0);
    double a = fabs(x);
    double y = a * 1e6;
    if (!(y < 0x1p53)) {
        ++*slow;
        return p + snprintf(p, KSSD_F6_MAX, "%.6f", x);
    }
    uint64_t n = kssd_round(y, fma(a, 1e6, -y));
    if (signbit(x))
        *p++ = '-';
    p = kssd_put_u64(p, n / 1000000);
    *p++ = '.';
    return kssd_put_6(p, (uint32_t)(n % 1000000));
}

/* 10^k, k in [0, 308], as hi + lo. 10^0..10^22 are exact doubles; each
 * later power is the one before times 10 in double-double arithmetic, a
 * relative error of at most about 2^-105 a step, under 2^-96 at 10^308
 * (tests/test_torch_print.py checks every power against the exact
 * value). Filled once, when the library is loaded. */
#define KSSD_POW10_MAX 308
static double kssd_p10_hi[KSSD_POW10_MAX + 1], kssd_p10_lo[KSSD_POW10_MAX + 1];

__attribute__((constructor)) static void kssd_pow10_init(void)
{
    double hi = 1, lo = 0;
    for (int k = 0; k <= KSSD_POW10_MAX; k++) {
        kssd_p10_hi[k] = hi;
        kssd_p10_lo[k] = lo;
        double h = hi * 10;
        double l = fma(hi, 10, -h) + lo * 10;
        hi = h + l; /* |l| < ulp(h): renormalise exactly (fast two-sum) */
        lo = l - (hi - h);
    }
}

/* y + t = a * 10^k. Returns the absolute error bound of y + t: 0 when
 * it is exact (|k| <= 22; for k < 0 t is then the division's remainder,
 * of y + t's sign). */
static double kssd_scale(double a, int k, double *y, double *t)
{
    if (k >= 0 && k <= 22) {
        *y = a * kssd_p10_hi[k];
        *t = fma(a, kssd_p10_hi[k], -*y);
        return 0;
    }
    if (k < 0 && k >= -22) {
        double d = kssd_p10_hi[-k];
        *y = a / d;
        *t = fma(-*y, d, a);
        return 0;
    }
    if (k > 0) {
        double h = kssd_p10_hi[k];
        *y = a * h;
        *t = fma(a, h, -*y) + a * kssd_p10_lo[k];
    } else {
        double h = kssd_p10_hi[-k];
        double q = a / h;
        *y = q;
        *t = (fma(-q, h, a) - q * kssd_p10_lo[-k]) / h;
    }
    return *y * 0x1p-95;
}

/* %E: d.ddddddE+xx */
static char *kssd_put_E(char *p, double x, int *slow)
{
    if (!isfinite(x))
        return kssd_put_nonfinite(p, x, 1);
    double a = fabs(x);
    uint64_t n = 0; /* zero prints 0.000000E+00 */
    int e = 0;
    if (a != 0) {
        if (a < 1e-300)
            goto defer;
        int b;
        double f = frexp(a, &b);
        /* floor(log10 a) or one less: log2(a) >= b - 2 + 2f, by at most
         * 0.09 (an int cast floors the positive sum) */
        e = (int)((b - 2 + 2 * f) * 0.30102999566398120 + 400) - 400;
        double y, t, bound = kssd_scale(a, 6 - e, &y, &t);
        if (y >= 1e7)
            bound = kssd_scale(a, 6 - ++e, &y, &t);
        else if (y < 1e6)
            bound = kssd_scale(a, 6 - --e, &y, &t);
        /* at the two ends of [1e6, 1e7) either exponent prints the same
         * text: y + t rounds to 10^6 or carries from 10^7 */
        if (bound == 0) {
            n = kssd_round(y, t);
        } else {
            n = (uint64_t)y;
            double d = ((y - (double)n) - 0.5) + t;
            if (fabs(d) <= 2 * bound)
                goto defer;
            n += d > 0;
        }
        if (n >= 10000000) {
            n = 1000000;
            e++;
        }
    }
    if (signbit(x))
        *p++ = '-';
    *p++ = (char)('0' + n / 1000000);
    *p++ = '.';
    p = kssd_put_6(p, (uint32_t)(n % 1000000));
    *p++ = 'E';
    *p++ = e < 0 ? '-' : '+';
    unsigned ue = (unsigned)(e < 0 ? -e : e);
    if (ue >= 100)
        *p++ = (char)('0' + ue / 100);
    return kssd_put_str(p, kssd_pairs + 2 * (ue % 100), 2);
defer:
    ++*slow;
    return p + snprintf(p, KSSD_F6_MAX, "%E", x);
}

struct kssd_fields {
    uint32_t xny, rs_u, x_size, y_size;
    double m, dist, pv, pv_n, c1, c2, d1, d2;
};

/* One line; p has KSSD_LINE_MAX bytes beside the names' lengths. */
static char *kssd_line(char *p, const char *qname, size_t qlen,
                       const char *rname, size_t rlen, int pfield,
                       const struct kssd_fields *v, int *slow)
{
    p = kssd_put_str(p, qname, qlen);
    *p++ = '\t';
    p = kssd_put_str(p, rname, rlen);
    *p++ = '\t';
    p = kssd_put_u64(p, v->xny);
    *p++ = '-';
    p = kssd_put_u64(p, v->rs_u);
    *p++ = '|';
    p = kssd_put_u64(p, v->x_size);
    *p++ = '|';
    p = kssd_put_u64(p, v->y_size);
    *p++ = '\t';
    p = kssd_put_f6(p, v->m, slow);
    *p++ = '\t';
    p = kssd_put_f6(p, v->dist, slow);
    if (pfield >= 1) {
        *p++ = '\t';
        p = kssd_put_E(p, v->pv, slow);
        *p++ = '\t';
        p = kssd_put_E(p, v->pv_n, slow);
    }
    if (pfield >= 2) {
        p = kssd_put_str(p, "\t[", 2);
        p = kssd_put_f6(p, v->c1, slow);
        *p++ = ',';
        p = kssd_put_f6(p, v->c2, slow);
        p = kssd_put_str(p, "]\t[", 3);
        p = kssd_put_f6(p, v->d1, slow);
        *p++ = ',';
        p = kssd_put_f6(p, v->d2, slow);
        *p++ = ']';
    }
    *p++ = '\n';
    return p;
}

/* Output cursor: bytes past cap are counted, never written. */
struct kssd_out {
    char *buf;
    int64_t cap;
    int64_t used;
    int full; /* some text did not fit */
};

/* A line where the buffer may not hold its worst case: formatted aside,
 * then kept as vsnprintf would keep it (the text that fits before a
 * NUL; the text fits iff it is shorter than the room). */
static void kssd_line_aside(struct kssd_out *o, const char *qname, size_t qlen,
                            const char *rname, size_t rlen, int pfield,
                            const struct kssd_fields *v)
{
    char local[4096];
    size_t need = qlen + rlen + KSSD_LINE_MAX;
    char *tmp = need <= sizeof local ? local : malloc(need);
    if (!tmp) {
        /* nothing can be formatted: count the worst case, so the caller
         * asks again with room for it */
        o->full = 1;
        o->used += (int64_t)need;
        return;
    }
    int slow = 0;
    int64_t n = kssd_line(tmp, qname, qlen, rname, rlen, pfield, v, &slow) - tmp;
    int64_t room = o->used < o->cap ? o->cap - o->used : 0;
    if (room) {
        int64_t k = n < room ? n : room - 1;
        memcpy(o->buf + o->used, tmp, (size_t)k);
        o->buf[o->used + k] = 0;
    }
    if (n >= room)
        o->full = 1;
    o->used += n;
    if (tmp != local)
        free(tmp);
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
 * ever written past cap; what is written is what vsnprintf would write,
 * the text up to cap - 1 bytes and a NUL). */
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
    int slow = 0;
    for (int64_t q = q0; q < q1; q++) {
        const char *qname = (const char *)qname_blob + qname_off[q];
        size_t qlen = strlen(qname);
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
            struct kssd_fields v = {.xny = xny, .x_size = x_size, .y_size = y_size};
            v.m = ((double)xny - rs) / tmp;
            v.dist = log(kssd_metric_arg(metric, v.m)) / kmerlen;
            if (v.dist > 1)
                v.dist = 1;
            if (v.dist > dthreshold)
                continue;
            const char *rname = (const char *)rname_blob + rname_off[r];
            size_t rlen = strlen(rname);
            /* (unsigned int)rs via int64 truncation: the reference's plain
             * -O3 build lowers the cast through cvttsd2si (nan -> INT64_MIN
             * -> low32 0); -march=native here would otherwise pick AVX-512's
             * vcvttsd2usi (nan -> 0xFFFFFFFF) and diverge byte-wise. */
            v.rs_u = (unsigned int)(int64_t)rs;
            if (pfield >= 1) {
                double m = v.m;
                double sd = pow(m * (1 - m) / tmp, 0.5);
                v.pv = 0.5 * erfc(m / sd * pow(0.5, 0.5));
                v.pv_n = v.pv * cmprsn_num;
                if (pfield >= 2) {
                    v.c1 = m - 1.96 * sd;
                    v.c2 = m + 1.96 * sd;
                    v.d1 = log(kssd_metric_arg(metric, v.c2)) / kmerlen;
                    v.d2 = log(kssd_metric_arg(metric, v.c1)) / kmerlen;
                }
            }
            if (o.cap - o.used > (int64_t)(qlen + rlen + KSSD_LINE_MAX))
                o.used = kssd_line(buf + o.used, qname, qlen, rname, rlen,
                                   pfield, &v, &slow) - buf;
            else
                kssd_line_aside(&o, qname, qlen, rname, rlen, pfield, &v);
        }
    }
    if (o.full)
        return o.used + 1; /* +1: the NUL vsnprintf would have kept */
    if (o.used < o.cap)
        buf[o.used] = 0;
    return o.used;
}

/* Test hooks. kind 0 is %.6lf, 1 is %E. */

/* One field as a line prints it, NUL-terminated, into out (at least
 * KSSD_F6_MAX bytes); returns its length, and *slow is 1 when it went
 * through snprintf. */
int kssd_fmt_field(double x, int kind, char *out, int *slow)
{
    *slow = 0;
    char *end = kind ? kssd_put_E(out, x, slow) : kssd_put_f6(out, x, slow);
    *end = 0;
    return (int)(end - out);
}

/* The field writer of `kind` against snprintf on x[0 .. n): returns the
 * index of the first value whose text differs, or -1; adds the values
 * that went through snprintf to *n_slow. */
int64_t kssd_fmt_check(const double *x, int64_t n, int kind, int64_t *n_slow)
{
    char mine[KSSD_F6_MAX], libc[KSSD_F6_MAX];
    const char *fmt = kind ? "%E" : "%.6f";
    for (int64_t i = 0; i < n; i++) {
        int slow = 0;
        int len = kssd_fmt_field(x[i], kind, mine, &slow);
        *n_slow += slow;
        if (snprintf(libc, sizeof libc, fmt, x[i]) != len || memcmp(mine, libc, (size_t)len))
            return i;
    }
    return -1;
}

/* 10^k's double-double (hi, lo) for k in [0, 308]; 0 when k is out of
 * range. */
int kssd_pow10_dd(int k, double *hi, double *lo)
{
    if (k < 0 || k > KSSD_POW10_MAX)
        return 0;
    *hi = kssd_p10_hi[k];
    *lo = kssd_p10_lo[k];
    return 1;
}
