/* FASTA scan: stage I's byte stream -> symbol stream, a block at a time.
 *
 * kssd_fasta_scan gives the symbols and the length of kssd_fasta_to_codes
 * (kssd_host.c, the reference scanner, fasta2co's rules) on every input:
 * ACGT and acgt -> 0-3; from '>' through the next '\n' skipped, the '>'
 * a BREAK (4); '\n' and '\r' skipped; any other byte a BREAK; runs of
 * BREAK collapsed, leading and trailing ones dropped; a header with no
 * newline runs to the end of the input. The reference takes a table
 * lookup and three branches a byte. A genome is almost all bases in
 * 60- or 80-column lines, so this scanner checks a block of W bytes at
 * once against the ACGT set:
 *   - the base mask: each byte folded to upper case (& 0xDF), compared
 *     with 'A', 'C', 'G' and 'T', the compares' top bits gathered into
 *     one word (movemask);
 *   - the codes: the low nibble through a 16-entry table (pshufb, AVX2),
 *     or ((c >> 1) ^ (c >> 2)) & 3 (SSE2, SWAR): A/a 0, C/c 1, G/g 2,
 *     T/t 3;
 *   - a block of bases is one store, and so is a block of bases around
 *     one line end ("\n" or "\r\n" at byte p): from p on, the codes of a
 *     second load t = 1 or 2 bytes on take the block's (a blend), and the
 *     output advances W - t. The next block's address then never waits
 *     for this block's bytes;
 *   - otherwise the leading run of bases (ctz of the inverted mask) is
 *     stored, and a line end after it skipped inside the loop;
 *   - any other byte goes through the reference's state machine: a BREAK,
 *     then a header's newline found by memchr, or the bytes up to the
 *     next base or '>' skipped a block at a time (after a BREAK, junk and
 *     line ends change nothing).
 * W is 32 (AVX2, under a target attribute, chosen at load time by
 * __builtin_cpu_supports), 16 (SSE2, baseline on x86-64) or 8 (64-bit
 * SWAR, the portable path: off x86, and under -DKSSD_SCAN_GENERIC; it
 * stores blocks of bases only and finishes a run byte by byte).
 *
 * In place (out == data): a scanner writes at most one symbol a byte
 * read, so its write position o never passes its read position i, and
 * every write lands on bytes already read. A block's full store at o
 * writes [o, o + W): for a block of bases, with or without a line end,
 * all of them lie below the next read position i + W; after a run of r < W bases the next read is at
 * i + r, so the full store is taken only when o + W <= i + r, and else
 * the r codes go through a register-sized temporary. Reads stay inside
 * [data, data + n), writes inside [out, out + n). The pointers are not
 * restrict.
 *
 * kssd_fasta_scan_at runs the loop of one width (a test hook); the
 * library is built with plain -O3 into the same helper library as
 * kssd_host.c, with its flags.
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#if defined(__x86_64__) && (defined(__GNUC__) || defined(__clang__))
#include <immintrin.h>
#define KSSD_SCAN_X86 1
#endif

#define BREAK 4

/* one more than the base code of each byte, 0 for the others */
static const uint8_t CODE1[256] = {
    ['A'] = 1, ['a'] = 1, ['C'] = 2, ['c'] = 2,
    ['G'] = 3, ['g'] = 3, ['T'] = 4, ['t'] = 4,
};

static inline int line_end(uint8_t c) { return c == '\n' || c == '\r'; }

/* A block's line ends, le (a bit a byte, the lowest at byte p), as one
 * run of t = 1 or 2 bytes ("\n", "\r\n"): t, or 0 when they are not. */
static inline unsigned line_end_run(uint32_t le, unsigned p)
{
    unsigned t = 1 + ((le >> p >> 1) & 1);
    return le == ((1u << t) - 1) << p ? t : 0;
}

/* A block loop of one width:
 * run: the bases and line ends from data[i], the bases' codes written at
 *   out[*o] (*o advanced); stops at any other byte, or may stop where
 *   fewer than W bytes remain, and returns where it stopped;
 * skip: the bytes from data[i] before the next base or '>', the end of
 *   the input at most. */
struct scan_loop {
    size_t (*run)(const uint8_t *data, size_t i, size_t n, uint8_t *out, size_t *o);
    size_t (*skip)(const uint8_t *data, size_t i, size_t n);
};

static size_t skip_tail(const uint8_t *data, size_t i, size_t n)
{
    while (i < n && !CODE1[data[i]] && data[i] != '>')
        i++;
    return i;
}

/* ---- 8 bytes: SWAR on 64-bit words -------------------------------------- */

#define ONES 0x0101010101010101ULL

/* 0x80 in each zero byte of x, 0 elsewhere (exact: no carry between bytes) */
static inline uint64_t zero_bytes(uint64_t x)
{
    const uint64_t low7 = 0x7f * ONES;
    return ~(((x & low7) + low7) | x | low7);
}

/* 0x80 in each byte of v that is a base */
static inline uint64_t bases8(uint64_t v)
{
    uint64_t f = v & (0xdf * ONES);
    return zero_bytes(f ^ ('A' * ONES)) | zero_bytes(f ^ ('C' * ONES))
           | zero_bytes(f ^ ('G' * ONES)) | zero_bytes(f ^ ('T' * ONES));
}

static size_t run_swar(const uint8_t *data, size_t i, size_t n, uint8_t *out, size_t *po)
{
    size_t o = *po;
    for (;;) {
        for (; i + 8 <= n; i += 8, o += 8) {
            uint64_t v;
            memcpy(&v, data + i, 8);
            if (bases8(v) != 0x80 * ONES)
                break;
            /* each byte's bits 1-3 only: no bit crosses into the low two */
            uint64_t c = ((v >> 1) ^ (v >> 2)) & (3 * ONES);
            memcpy(out + o, &c, 8);
        }
        /* the run's last bytes, one at a time (fewer than 8) */
        for (; i < n && CODE1[data[i]]; i++)
            out[o++] = CODE1[data[i]] - 1;
        if (i == n || !line_end(data[i]))
            break;
        i++;
    }
    *po = o;
    return i;
}

static size_t skip_swar(const uint8_t *data, size_t i, size_t n)
{
    for (; i + 8 <= n; i += 8) {
        uint64_t v;
        memcpy(&v, data + i, 8);
        if (bases8(v) | zero_bytes(v ^ ('>' * ONES)))
            break;
    }
    return skip_tail(data, i, n);
}

static const struct scan_loop loop8 = {run_swar, skip_swar};

#ifdef KSSD_SCAN_X86

/* ---- 16 bytes: SSE2 ----------------------------------------------------- */

static inline __m128i bases16(__m128i v)
{
    const __m128i f = _mm_and_si128(v, _mm_set1_epi8((char)0xdf));
    return _mm_or_si128(
        _mm_or_si128(_mm_cmpeq_epi8(f, _mm_set1_epi8('A')), _mm_cmpeq_epi8(f, _mm_set1_epi8('C'))),
        _mm_or_si128(_mm_cmpeq_epi8(f, _mm_set1_epi8('G')), _mm_cmpeq_epi8(f, _mm_set1_epi8('T'))));
}

static size_t run_sse2(const uint8_t *data, size_t i, size_t n, uint8_t *out, size_t *po)
{
    const __m128i iota = _mm_setr_epi8(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
    size_t o = *po;
    while (i + 16 <= n) {
        __m128i v = _mm_loadu_si128((const __m128i *)(data + i));
        unsigned m = (unsigned)_mm_movemask_epi8(bases16(v));
        /* 16-bit shifts: a byte's low two bits come from its own bits 1-3 */
        __m128i c = _mm_and_si128(_mm_xor_si128(_mm_srli_epi16(v, 1), _mm_srli_epi16(v, 2)),
                                  _mm_set1_epi8(3));
        if (m == 0xffff) {
            _mm_storeu_si128((__m128i *)(out + o), c);
            i += 16;
            o += 16;
            continue;
        }
        unsigned le = (unsigned)_mm_movemask_epi8(_mm_or_si128(
            _mm_cmpeq_epi8(v, _mm_set1_epi8('\n')), _mm_cmpeq_epi8(v, _mm_set1_epi8('\r'))));
        if ((m | le) == 0xffff) { /* bases around line ends: the blend */
            unsigned p = (unsigned)__builtin_ctz(le), t = line_end_run(le, p);
            if (t && i + 16 + t <= n) {
                __m128i w = _mm_loadu_si128((const __m128i *)(data + i + t));
                __m128i cw = _mm_and_si128(
                    _mm_xor_si128(_mm_srli_epi16(w, 1), _mm_srli_epi16(w, 2)), _mm_set1_epi8(3));
                __m128i from_p = _mm_cmpgt_epi8(iota, _mm_set1_epi8((char)(p - 1)));
                _mm_storeu_si128((__m128i *)(out + o), _mm_or_si128(_mm_and_si128(from_p, cw),
                                                                    _mm_andnot_si128(from_p, c)));
                i += 16;
                o += 16 - t;
                continue;
            }
        }
        unsigned r = (unsigned)__builtin_ctz(~m);
        if (o + 16 <= i + r) {
            _mm_storeu_si128((__m128i *)(out + o), c);
        } else if (r) {
            uint8_t t[16];
            _mm_storeu_si128((__m128i *)t, c);
            memcpy(out + o, t, r);
        }
        i += r;
        o += r;
        if (!line_end(data[i]))
            break;
        i++;
    }
    *po = o;
    return i;
}

static size_t skip_sse2(const uint8_t *data, size_t i, size_t n)
{
    for (; i + 16 <= n; i += 16) {
        __m128i v = _mm_loadu_si128((const __m128i *)(data + i));
        __m128i stop = _mm_or_si128(bases16(v), _mm_cmpeq_epi8(v, _mm_set1_epi8('>')));
        unsigned m = (unsigned)_mm_movemask_epi8(stop);
        if (m)
            return i + (unsigned)__builtin_ctz(m);
    }
    return skip_tail(data, i, n);
}

static const struct scan_loop loop16 = {run_sse2, skip_sse2};

/* ---- 32 bytes: AVX2 ----------------------------------------------------- */

__attribute__((target("avx2")))
static inline __m256i bases32(__m256i v)
{
    const __m256i f = _mm256_and_si256(v, _mm256_set1_epi8((char)0xdf));
    return _mm256_or_si256(
        _mm256_or_si256(_mm256_cmpeq_epi8(f, _mm256_set1_epi8('A')),
                        _mm256_cmpeq_epi8(f, _mm256_set1_epi8('C'))),
        _mm256_or_si256(_mm256_cmpeq_epi8(f, _mm256_set1_epi8('G')),
                        _mm256_cmpeq_epi8(f, _mm256_set1_epi8('T'))));
}

__attribute__((target("avx2")))
static size_t run_avx2(const uint8_t *data, size_t i, size_t n, uint8_t *out, size_t *po)
{
    /* by the low nibble: A/a 1 -> 0, C/c 3 -> 1, G/g 7 -> 2, T/t 4 -> 3 */
    const __m256i nib = _mm256_setr_epi8(0, 0, 0, 1, 3, 0, 0, 2, 0, 0, 0, 0, 0, 0, 0, 0,
                                         0, 0, 0, 1, 3, 0, 0, 2, 0, 0, 0, 0, 0, 0, 0, 0);
    const __m256i iota = _mm256_setr_epi8(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
                                          16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
                                          30, 31);
    size_t o = *po;
    while (i + 32 <= n) {
        __m256i v = _mm256_loadu_si256((const __m256i *)(data + i));
        uint32_t m = (uint32_t)_mm256_movemask_epi8(bases32(v));
        __m256i c = _mm256_shuffle_epi8(nib, v);
        if (m == 0xffffffffu) {
            _mm256_storeu_si256((__m256i *)(out + o), c);
            i += 32;
            o += 32;
            continue;
        }
        uint32_t le = (uint32_t)_mm256_movemask_epi8(_mm256_or_si256(
            _mm256_cmpeq_epi8(v, _mm256_set1_epi8('\n')), _mm256_cmpeq_epi8(v, _mm256_set1_epi8('\r'))));
        if ((m | le) == 0xffffffffu) { /* bases around line ends: the blend */
            unsigned p = (unsigned)__builtin_ctz(le), t = line_end_run(le, p);
            if (t && i + 32 + t <= n) {
                __m256i w = _mm256_loadu_si256((const __m256i *)(data + i + t));
                __m256i from_p = _mm256_cmpgt_epi8(iota, _mm256_set1_epi8((char)(p - 1)));
                _mm256_storeu_si256((__m256i *)(out + o),
                                    _mm256_blendv_epi8(c, _mm256_shuffle_epi8(nib, w), from_p));
                i += 32;
                o += 32 - t;
                continue;
            }
        }
        unsigned r = (unsigned)__builtin_ctz(~m);
        if (o + 32 <= i + r) {
            _mm256_storeu_si256((__m256i *)(out + o), c);
        } else if (r) {
            uint8_t t[32];
            _mm256_storeu_si256((__m256i *)t, c);
            memcpy(out + o, t, r);
        }
        i += r;
        o += r;
        if (!line_end(data[i]))
            break;
        i++;
    }
    *po = o;
    return i;
}

__attribute__((target("avx2")))
static size_t skip_avx2(const uint8_t *data, size_t i, size_t n)
{
    for (; i + 32 <= n; i += 32) {
        __m256i v = _mm256_loadu_si256((const __m256i *)(data + i));
        __m256i stop = _mm256_or_si256(bases32(v), _mm256_cmpeq_epi8(v, _mm256_set1_epi8('>')));
        uint32_t m = (uint32_t)_mm256_movemask_epi8(stop);
        if (m)
            return i + (unsigned)__builtin_ctz(m);
    }
    return skip_tail(data, i, n);
}

static const struct scan_loop loop32 = {run_avx2, skip_avx2};
static int have_avx2;

#endif /* KSSD_SCAN_X86 */

static const struct scan_loop *best = &loop8;

__attribute__((constructor)) static void kssd_scan_init(void)
{
#ifdef KSSD_SCAN_X86
    __builtin_cpu_init();
    have_avx2 = __builtin_cpu_supports("avx2");
#ifndef KSSD_SCAN_GENERIC /* tests build both */
    best = have_avx2 ? &loop32 : &loop16;
#endif
#endif
}

static size_t scan(const uint8_t *data, size_t n, uint8_t *out, const struct scan_loop *k)
{
    size_t i = 0, o = 0;
    int last_break = 1; /* suppress leading BREAK */
    for (;;) {
        size_t o0 = o;
        i = k->run(data, i, n, out, &o);
        if (o != o0)
            last_break = 0;
        if (i >= n)
            break;
        /* a byte that ended a run, or one of the last W - 1 */
        uint8_t ch = data[i++];
        if (CODE1[ch]) {
            out[o++] = CODE1[ch] - 1;
            last_break = 0;
            continue;
        }
        if (line_end(ch))
            continue;
        if (!last_break) {
            out[o++] = BREAK;
            last_break = 1;
        }
        if (ch == '>') {
            const uint8_t *nl = memchr(data + i, '\n', n - i);
            i = nl ? (size_t)(nl - data) + 1 : n;
        } else {
            i = k->skip(data, i, n);
        }
    }
    while (o > 0 && out[o - 1] == BREAK)
        o--;
    return o;
}

/* kssd_fasta_to_codes' symbols of data[0, n) in out (capacity n; out ==
 * data scans in place); returns their count. */
size_t kssd_fasta_scan(const uint8_t *data, size_t n, uint8_t *out)
{
    return scan(data, n, out, best);
}

/* kssd_fasta_scan on the block loop of `width` bytes (8, 16 or 32);
 * (size_t)-1 when this build or CPU has no such loop. */
size_t kssd_fasta_scan_at(const uint8_t *data, size_t n, uint8_t *out, int width)
{
    if (width == 8)
        return scan(data, n, out, &loop8);
#ifdef KSSD_SCAN_X86
    if (width == 16)
        return scan(data, n, out, &loop16);
    if (width == 32 && have_avx2)
        return scan(data, n, out, &loop32);
#endif
    return (size_t)-1;
}
