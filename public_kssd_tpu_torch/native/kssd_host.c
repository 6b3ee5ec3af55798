/* Native host helpers for public_kssd_tpu.
 *
 * The TPU owns the compute path (window extraction, filtering, counting);
 * these C routines own the host-side streaming work the reference also
 * does natively: byte-stream parsing/2-bit packing and the exact
 * open-addressing dedup that reproduces the reference's on-disk code
 * order (HASH/H1/H2, global_basic.h:228-230).
 *
 * Built as a shared library, bound with ctypes (no pybind11 dependency).
 *
 * Symbol stream contract (see seqio.py): 0..3 = ACGT code, 4 = BREAK.
 * Runs of BREAK are collapsed, boundary BREAKs trimmed.
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

#define BREAK 4
#define SENT_EMPTY 0xFFFFFFFFFFFFFFFFULL

static const int8_t BASEMAP[256] = {
    [0 ... 255] = -1,
    ['A'] = 0, ['a'] = 0, ['C'] = 1, ['c'] = 1,
    ['G'] = 2, ['g'] = 2, ['T'] = 3, ['t'] = 3,
};

/* fasta byte stream -> symbol stream; returns output length.
 * out must have capacity n. Mirrors the reference scanner
 * (fasta2co, iseq2comem.c:205-270): header '>'..'\n' skipped + reset,
 * newlines skipped, other alpha/junk reset. */
size_t kssd_fasta_to_codes(const uint8_t *data, size_t n, uint8_t *out)
{
    size_t o = 0;
    int in_header = 0;
    int last_break = 1; /* suppress leading BREAK */
    for (size_t i = 0; i < n; i++) {
        uint8_t ch = data[i];
        if (in_header) {
            if (ch == '\n')
                in_header = 0;
            continue;
        }
        int8_t b = BASEMAP[ch];
        if (b >= 0) {
            out[o++] = (uint8_t)b;
            last_break = 0;
        } else if (ch == '\n' || ch == '\r') {
            continue;
        } else if (ch == '>') {
            in_header = 1;
            if (!last_break) { out[o++] = BREAK; last_break = 1; }
        } else {
            if (!last_break) { out[o++] = BREAK; last_break = 1; }
        }
    }
    while (o > 0 && out[o - 1] == BREAK)
        o--;
    return o;
}

/* fastq byte stream -> symbol stream (fastq2co, iseq2comem.c:277-356):
 * record = 4 lines, seq = line 2, qual = line 4; base valid iff
 * Basemap-valid AND raw quality byte >= min_qual; read boundary = BREAK.
 * Trailing partial records are dropped (fgets-at-EOF semantics). */
size_t kssd_fastq_to_codes(const uint8_t *data, size_t n, int min_qual,
                           uint8_t *out)
{
    size_t o = 0;
    int last_break = 1;
    size_t i = 0;
    while (i < n) {
        /* locate the 4 lines of this record */
        size_t ls[4], le[4];
        int ok = 1;
        for (int l = 0; l < 4; l++) {
            ls[l] = i;
            while (i < n && data[i] != '\n')
                i++;
            le[l] = i;
            if (i < n)
                i++; /* skip newline */
            else if (l < 3) {
                ok = 0;
                break;
            }
        }
        if (!ok)
            break;
        size_t slen = le[1] - ls[1];
        size_t qlen = le[3] - ls[3];
        const uint8_t *seq = data + ls[1];
        const uint8_t *qual = data + ls[3];
        size_t m = slen;
        if (min_qual > 0 && qlen < m)
            m = qlen;
        for (size_t p = 0; p < m; p++) {
            int8_t b = BASEMAP[seq[p]];
            if (b >= 0 && (min_qual <= 0 || qual[p] >= (uint8_t)min_qual)) {
                out[o++] = (uint8_t)b;
                last_break = 0;
            } else if (!last_break) {
                out[o++] = BREAK;
                last_break = 1;
            }
        }
        if (!last_break) { out[o++] = BREAK; last_break = 1; }
    }
    while (o > 0 && out[o - 1] == BREAK)
        o--;
    return o;
}

/* ------------------------------------------------------------------ */
/* Exact reference dedup: open-addressing double hash, slot-order dump */
/* ------------------------------------------------------------------ */

/* fasta2co-style set dedup. table: caller-provided zeroed uint64[hashsize].
 * uniq != 0 replicates uniq_fasta2co (-u): codes seen >1 times marked via
 * the high bit and skipped on output (iseq2comem.c:616-703).
 * Returns the number of output codes written to out (capacity hashsize);
 * returns (size_t)-1 on "space too crowded" (keycount > hashlimit). */
size_t kssd_dedup_slot_order(const uint64_t *codes, size_t n,
                             uint64_t *table, uint32_t hashsize,
                             uint32_t hashlimit, int uniq, uint64_t *out)
{
#define HIBIT 0x8000000000000000ULL
    uint64_t keycount = 0;
    for (size_t i = 0; i < n; i++) {
        uint64_t c = codes[i];
        if (c == 0) { /* quirk: re-counted every occurrence, never stored */
            if (++keycount > hashlimit)
                return (size_t)-1;
            continue;
        }
        uint32_t h1 = (uint32_t)(c % hashsize);
        uint32_t h2 = 1 + (uint32_t)(c % (hashsize - 1));
        uint32_t s = h1;
        for (;;) {
            uint64_t v = table[s];
            if (v == 0) {
                table[s] = c;
                if (++keycount > hashlimit)
                    return (size_t)-1;
                break;
            }
            if ((v | HIBIT) == (c | HIBIT)) {
                if (uniq)
                    table[s] = v | HIBIT;
                break;
            }
            s += h2;
            if (s >= hashsize)
                s -= hashsize;
        }
    }
    size_t o = 0;
    for (uint32_t s = 0; s < hashsize; s++) {
        uint64_t v = table[s];
        if (v != 0 && v < HIBIT)
            out[o++] = v;
    }
    return o;
}

/* fastq2co / fastq2koc-style counted dedup.
 * count_bits = 4  -> fastq2co: output only codes whose counter saturated
 *                    (count reached min_occurrence then pinned to 15)
 * count_bits = 16 -> fastq2koc: output all codes with counters
 * table: zeroed uint64[hashsize], slot holds key<<count_bits|count.
 * Returns output length; out_codes/out_counts capacity hashsize. */
size_t kssd_dedup_counts(const uint64_t *codes, size_t n,
                         uint64_t *table, uint32_t hashsize,
                         int count_bits, int min_occurrence,
                         uint64_t *out_codes, uint32_t *out_counts)
{
    const uint64_t ct_max = (1ULL << count_bits) - 1;
    const uint64_t occupied_bit = 1ULL << 63; /* key 0 must look occupied */
    /* We cannot use slot==0 as empty marker: key 0 with count 0 never
     * happens in the reference either ((drtuple<<bits)+1 != 0), so the
     * reference's slot==0 test is safe; replicate directly. */
    for (size_t i = 0; i < n; i++) {
        uint64_t c = codes[i];
        uint32_t h1 = (uint32_t)(c % hashsize);
        uint32_t h2 = 1 + (uint32_t)(c % (hashsize - 1));
        uint32_t s = h1;
        for (;;) {
            uint64_t v = table[s];
            if (v == 0) {
                if (count_bits == 4 && min_occurrence == 1)
                    table[s] = (c << 4) | ct_max; /* iseq2comem.c:336 */
                else
                    table[s] = (c << count_bits) + 1;
                break;
            }
            if ((v >> count_bits) == c) {
                uint64_t cnt = v & ct_max;
                if (count_bits == 4) {
                    if (cnt != ct_max) {
                        v += 1;
                        if (!(((v & ct_max)) < (uint64_t)min_occurrence))
                            v |= ct_max;
                        table[s] = v;
                    }
                } else {
                    if (cnt < ct_max)
                        table[s] = v + 1;
                }
                break;
            }
            s += h2;
            if (s >= hashsize)
                s -= hashsize;
        }
    }
    size_t o = 0;
    const uint64_t pass4 = (1ULL << 4) - 1;
    for (uint32_t s = 0; s < hashsize; s++) {
        uint64_t v = table[s];
        if (v == 0)
            continue;
        if (count_bits == 4 && (v & pass4) != pass4)
            continue;
        out_codes[o] = v >> count_bits;
        out_counts[o] = (uint32_t)(v & ct_max);
        o++;
    }
    (void)occupied_bit;
    return o;
}

/* grouping_genomes per-taxon uint32 dedup (command_set.c:737-775):
 * probes on the 32-bit code, code 0 dropped, slot-order output. */
size_t kssd_dedup_u32_slot_order(const uint32_t *codes, size_t n,
                                 uint32_t *table, uint32_t hashsize,
                                 uint32_t *out)
{
    for (size_t i = 0; i < n; i++) {
        uint32_t c = codes[i];
        if (c == 0)
            continue;
        uint32_t h1 = c % hashsize;
        uint32_t h2 = 1 + c % (hashsize - 1);
        uint32_t s = h1;
        uint32_t probes = 0;
        for (; probes < hashsize; probes++) {
            uint32_t v = table[s];
            if (v == 0) { table[s] = c; break; }
            if (v == c) break;
            s += h2;
            if (s >= hashsize)
                s -= hashsize;
        }
    }
    size_t o = 0;
    for (uint32_t s = 0; s < hashsize; s++)
        if (table[s] != 0)
            out[o++] = table[s];
    return o;
}

/* 2-bit pack: symbol stream -> uint32 words, 16 bases/word, LSB-first.
 * BREAK(4) packs as code 0 (4&3) -- callers filter break windows by
 * position (ops/sketch.py packed upload path). Zero-fills padding up to
 * nwords. */
void kssd_pack2(const uint8_t *sym, size_t n, uint32_t *out, size_t nwords)
{
    size_t full = n / 16;
    for (size_t w = 0; w < full; w++) {
        const uint8_t *s = sym + w * 16;
        uint32_t v = 0;
        for (int j = 0; j < 16; j++)
            v |= (uint32_t)(s[j] & 3) << (2 * j);
        out[w] = v;
    }
    if (full < nwords) {
        memset(out + full, 0, (nwords - full) * sizeof(uint32_t));
        uint32_t v = 0;
        for (size_t i = full * 16; i < n; i++)
            v |= (uint32_t)(sym[i] & 3) << (2 * (i & 15));
        if (n & 15)
            out[full] = v;
    }
}

/* ---------------------------------------------------------------------
 * distance.out line writer: one query row of dist_print_nobin lines
 * (output_ctrl, command_dist.c:1252-1287), appended to `path`.
 *
 * Reference-exact BY CONSTRUCTION: same libm, same glibc printf, same
 * x86 double semantics (log(neg) = -nan, 0/0 = -nan, (unsigned)nan = 0
 * after the int64 truncation gcc emits) as the reference build — the
 * Python twin in ops/stats.py has to emulate each of those corners.
 * Exists because the per-pair Python formatter is the one remaining
 * serial host loop at the 317k-ref GTDB scale (2.5M+ lines per full
 * print); this writes at C printf speed.
 *
 * names_blob/name_off: NUL-terminated ref names at byte offsets.
 * rid_sel: optional top-N row selection (in print order); NULL = all.
 * Returns lines written, or (size_t)-1 if the file cannot be opened.
 */
#include <stdio.h>
#include <math.h>

static inline double kssd_get_metric_arg(int metric, double m)
{
    return metric == 0 ? 1 / (2 * m) + 0.5 : 1 / m;
}

size_t kssd_dist_row(
    const char *path, const char *qname,
    const uint8_t *names_blob, const int64_t *name_off,
    const uint32_t *ref_sizes, const uint32_t *counts,
    int64_t n_ref, const int64_t *rid_sel, int64_t n_sel,
    uint32_t y_size, int kmerlen, int dim_rd_len, double cmprsn_num,
    int metric, int pfield, int correction, double dthreshold)
{
    FILE *fp = fopen(path, "ab");
    if (!fp)
        return (size_t)-1;
    char buf[1 << 20];
    setvbuf(fp, buf, _IOFBF, sizeof buf);
    size_t written = 0;
    int64_t n_iter = rid_sel ? n_sel : n_ref;
    for (int64_t ii = 0; ii < n_iter; ii++) {
        int64_t r = rid_sel ? rid_sel[ii] : ii;
        uint32_t x_size = ref_sizes[r];
        uint32_t xny = counts[r];
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
        double dist = log(kssd_get_metric_arg(metric, m)) / kmerlen;
        if (dist > 1)
            dist = 1;
        if (dist > dthreshold)
            continue;
        /* (unsigned int)rs via int64 truncation: the reference's plain
         * -O3 build lowers the cast through cvttsd2si (nan -> INT64_MIN
         * -> low32 0); -march=native here would otherwise pick AVX-512's
         * vcvttsd2usi (nan -> 0xFFFFFFFF) and diverge byte-wise. */
        fprintf(fp, "%s\t%s\t%u-%u|%u|%u\t%.6lf\t%.6lf",
                qname, (const char *)names_blob + name_off[r],
                xny, (unsigned int)(int64_t)rs, x_size, y_size, m, dist);
        if (pfield > 0) {
            double sd = pow(m * (1 - m) / tmp, 0.5);
            double pv = 0.5 * erfc(m / sd * pow(0.5, 0.5));
            fprintf(fp, "\t%E\t%E", pv, pv * cmprsn_num);
            if (pfield > 1) {
                double c1 = m - 1.96 * sd;
                double c2 = m + 1.96 * sd;
                double d1 = log(kssd_get_metric_arg(metric, c2)) / kmerlen;
                double d2 = log(kssd_get_metric_arg(metric, c1)) / kmerlen;
                fprintf(fp, "\t[%.6lf,%.6lf]\t[%.6lf,%.6lf]",
                        c1, c2, d1, d2);
            }
        }
        fputc('\n', fp);
        written++;
    }
    fclose(fp);
    return written;
}
