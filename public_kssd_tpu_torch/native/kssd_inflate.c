/* gzip inflate: one member from a caller's buffer into a caller's buffer.
 *
 * Stage I inflates every .fna.gz genome on the parse pool's threads. A
 * 5.3 Mb genome at gzip level 6 is about 70 dynamic-Huffman blocks whose
 * output comes 95% from matches of 6-7 bytes, so the hot path is the
 * match: a length symbol and its extra bits, a distance symbol and its
 * extra bits, and a short copy from a random offset in the window.
 *
 * The decoder follows libdeflate's design rather than zlib's:
 *   - a 64-bit bit buffer refilled by one unaligned 8-byte load, with no
 *     branch, to at least 56 bits: one refill covers a whole match
 *     (15 + 5 + 15 + 13 = 48 bits);
 *   - decode tables whose entries carry the codeword length, the value
 *     (a literal, a length or distance base) and the count of extra bits,
 *     so one lookup and one shift give a length or a distance; an 11-bit
 *     main table for literals and lengths, an 8-bit one for distances,
 *     subtables for the longer codewords;
 *   - a fast loop, while 268 bytes of output and 16 of input remain,
 *     that looks up the next entry before it refills or copies, decodes
 *     up to three literals on one refill, and copies a match as whole
 *     8-byte words (overlapping, the pattern replicated below a distance
 *     of 8); a bounds-checked loop for a block's tail near either end.
 * The decode loop is compiled twice, the second time for BMI2 (shifts and
 * masks of variable width in one instruction), chosen at run time.
 *
 * Acceptance follows the gzip module (its own header parse, then zlib's
 * raw inflate): every stream zlib rejects is rejected here. The header's
 * reserved flags and its FHCRC field are not checked, as the module does
 * not check them. The trailer's CRC-32 and ISIZE are. The CRC-32 runs
 * block by block, over each block's output while it is still in cache:
 * four-way carry-less-multiply folding (PCLMULQDQ, under a target
 * attribute, chosen at run time by __builtin_cpu_supports), slice-by-8
 * tables elsewhere and for the tails.
 *
 * Reads stay inside [src, src + n_src) and writes inside
 * [dst, dst + n_dst): the margins of the fast loop lie inside them.
 *
 * Built into the same helper library as kssd_host.c, with its flags.
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#if defined(__x86_64__) && (defined(__GNUC__) || defined(__clang__))
#include <immintrin.h>
#define KSSD_X86 1
#endif

/* kssd_gzip_inflate's results */
enum {
    KSSD_INFLATE_OK = 0,
    KSSD_INFLATE_BAD_DATA = 1,  /* not a gzip member zlib would decode */
    KSSD_INFLATE_BAD_CHECK = 2, /* the trailer's CRC-32 or ISIZE differs */
    KSSD_INFLATE_NO_SPACE = 3,  /* the member's output exceeds n_dst */
    KSSD_INFLATE_TRUNCATED = 4, /* the input ends inside the member */
};

static inline uint64_t load64(const uint8_t *p)
{
    uint64_t v;
    memcpy(&v, p, 8);
#if __BYTE_ORDER__ != __ORDER_LITTLE_ENDIAN__
    v = __builtin_bswap64(v);
#endif
    return v;
}

/* 8 bytes from s to d through a register: d may lie 1-7 bytes past s */
static inline void copy64(uint8_t *d, const uint8_t *s)
{
    uint64_t v;
    memcpy(&v, s, 8);
    memcpy(d, &v, 8);
}

static inline uint32_t load32(const uint8_t *p)
{
    return (uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16
           | (uint32_t)p[3] << 24;
}

/* ---- CRC-32 (gzip's: reflected, polynomial 0xEDB88320) ---------------- */

static uint32_t crc_tab[8][256]; /* [k][b]: byte b followed by k zero bytes */

/* The CRC register (the inverted CRC) after n more bytes. */
static uint32_t crc32_slice8(uint32_t r, const uint8_t *p, size_t n)
{
    for (; n && ((uintptr_t)p & 7); n--)
        r = crc_tab[0][(r ^ *p++) & 0xff] ^ (r >> 8);
    for (; n >= 8; n -= 8, p += 8) {
        uint64_t v = load64(p) ^ r;
        r = crc_tab[7][v & 0xff] ^ crc_tab[6][(v >> 8) & 0xff]
            ^ crc_tab[5][(v >> 16) & 0xff] ^ crc_tab[4][(v >> 24) & 0xff]
            ^ crc_tab[3][(v >> 32) & 0xff] ^ crc_tab[2][(v >> 40) & 0xff]
            ^ crc_tab[1][(v >> 48) & 0xff] ^ crc_tab[0][v >> 56];
    }
    for (; n; n--)
        r = crc_tab[0][(r ^ *p++) & 0xff] ^ (r >> 8);
    return r;
}

#ifdef KSSD_X86
static int have_clmul, have_bmi2;

/* The register after n bytes, n >= 64 and a multiple of 16: four
 * 128-bit lanes folded by x^512 while 64 bytes remain, folded into one
 * by x^128, then reduced to 32 bits (Barrett). The constants are
 * x^k mod P, bit-reflected and shifted left by one, for
 * k = 4*128+32, 4*128-32 (the four-lane fold), 128+32, 128-32 (one
 * lane), 64 (to 64 bits); then P itself and floor(x^64 / P). */
__attribute__((target("pclmul,sse4.1")))
static uint32_t crc32_clmul(uint32_t r, const uint8_t *p, size_t n)
{
    const __m128i k1k2 = _mm_set_epi64x(0x01c6e41596LL, 0x0154442bd4LL);
    const __m128i k3k4 = _mm_set_epi64x(0x00ccaa009eLL, 0x01751997d0LL);
    const __m128i k5 = _mm_set_epi64x(0, 0x0163cd6124LL);
    const __m128i poly = _mm_set_epi64x(0x01f7011641LL, 0x01db710641LL);
    const __m128i lo32 = _mm_setr_epi32(~0, 0, ~0, 0);
    __m128i x1 = _mm_loadu_si128((const __m128i *)(p + 0x00));
    __m128i x2 = _mm_loadu_si128((const __m128i *)(p + 0x10));
    __m128i x3 = _mm_loadu_si128((const __m128i *)(p + 0x20));
    __m128i x4 = _mm_loadu_si128((const __m128i *)(p + 0x30));
    __m128i t;
    x1 = _mm_xor_si128(x1, _mm_cvtsi32_si128((int)r));
    p += 64;
    n -= 64;
    for (; n >= 64; n -= 64, p += 64) {
        __m128i y1 = _mm_clmulepi64_si128(x1, k1k2, 0x00);
        __m128i y2 = _mm_clmulepi64_si128(x2, k1k2, 0x00);
        __m128i y3 = _mm_clmulepi64_si128(x3, k1k2, 0x00);
        __m128i y4 = _mm_clmulepi64_si128(x4, k1k2, 0x00);
        x1 = _mm_clmulepi64_si128(x1, k1k2, 0x11);
        x2 = _mm_clmulepi64_si128(x2, k1k2, 0x11);
        x3 = _mm_clmulepi64_si128(x3, k1k2, 0x11);
        x4 = _mm_clmulepi64_si128(x4, k1k2, 0x11);
        x1 = _mm_xor_si128(_mm_xor_si128(x1, y1),
                           _mm_loadu_si128((const __m128i *)(p + 0x00)));
        x2 = _mm_xor_si128(_mm_xor_si128(x2, y2),
                           _mm_loadu_si128((const __m128i *)(p + 0x10)));
        x3 = _mm_xor_si128(_mm_xor_si128(x3, y3),
                           _mm_loadu_si128((const __m128i *)(p + 0x20)));
        x4 = _mm_xor_si128(_mm_xor_si128(x4, y4),
                           _mm_loadu_si128((const __m128i *)(p + 0x30)));
    }
#define FOLD128(x, next) do { \
        t = _mm_clmulepi64_si128(x, k3k4, 0x00); \
        x = _mm_clmulepi64_si128(x, k3k4, 0x11); \
        x = _mm_xor_si128(_mm_xor_si128(x, t), next); \
    } while (0)
    FOLD128(x1, x2);
    FOLD128(x1, x3);
    FOLD128(x1, x4);
    for (; n >= 16; n -= 16, p += 16)
        FOLD128(x1, _mm_loadu_si128((const __m128i *)p));
#undef FOLD128
    /* 128 -> 64 bits */
    t = _mm_clmulepi64_si128(x1, k3k4, 0x10);
    x1 = _mm_xor_si128(_mm_srli_si128(x1, 8), t);
    t = _mm_srli_si128(x1, 4);
    x1 = _mm_clmulepi64_si128(_mm_and_si128(x1, lo32), k5, 0x00);
    x1 = _mm_xor_si128(x1, t);
    /* Barrett reduction to 32 bits */
    t = _mm_clmulepi64_si128(_mm_and_si128(x1, lo32), poly, 0x10);
    t = _mm_clmulepi64_si128(_mm_and_si128(t, lo32), poly, 0x00);
    x1 = _mm_xor_si128(x1, t);
    return (uint32_t)_mm_extract_epi32(x1, 1);
}
#endif

/* The CRC register after n more bytes at p. */
static uint32_t crc32_update(uint32_t r, const uint8_t *p, size_t n)
{
#ifdef KSSD_X86
    if (have_clmul && n >= 64) {
        size_t m = n & ~(size_t)15;
        r = crc32_clmul(r, p, m);
        p += m;
        n -= m;
    }
#endif
    return crc32_slice8(r, p, n);
}

/* ---- Huffman decode tables -------------------------------------------- */

/* An entry (uint32_t):
 *   bits 0-7    bits to drop: the codeword's length within its table plus
 *               the extra bits that follow it (a subtable pointer: the
 *               main table's bits)
 *   bits 8-11   the codeword's length within its table (a subtable
 *               pointer: the subtable's index bits)
 *   bit 13      end of block
 *   bit 14      subtable pointer
 *   bit 15      exceptional: a subtable pointer, the end of block, or a
 *               code that zlib rejects ("invalid code")
 *   bits 16-30  the value: a literal, a length or distance base, a
 *               subtable's first index, a precode symbol
 *   bit 31      literal
 */
#define E_LIT 0x80000000u
#define E_EXC 0x00008000u
#define E_SUB 0x00004000u
#define E_EOB 0x00002000u
#define E_INVALID (E_EXC | (1u << 8) | 1u) /* one bit, then an error */

#define LT_BITS 11
#define DT_BITS 8
#define PT_BITS 7
/* the largest tables a complete code can need (zlib's `enough` for these
 * main-table widths and symbol counts); build_table checks the bound */
#define LT_ENOUGH 2342
#define DT_ENOUGH 402
#define PT_ENOUGH 128

#define N_LITLEN 288
#define N_DIST 32
#define N_PRE 19

/* each symbol's entry without its lengths, and its extra bits */
static uint32_t lit_res[N_LITLEN], dist_res[N_DIST], pre_res[N_PRE];
static uint8_t lit_extra[N_LITLEN], dist_extra[N_DIST], no_extra[N_PRE];
static uint32_t fixed_lt[LT_ENOUGH], fixed_dt[DT_ENOUGH];

static const uint16_t len_base[29] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31,
    35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
static const uint8_t len_bits[29] = {
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2,
    3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
static const uint16_t dist_base[30] = {
    1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193,
    257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289,
    16385, 24577};
static const uint8_t dist_bits[30] = {
    0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6,
    7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
static const uint8_t pre_order[N_PRE] = {
    16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};

/* The decode table of the canonical code with these codeword lengths
 * (0: no codeword) into table[0, cap): 0, or -1 where zlib rejects the
 * lengths (over-subscribed; incomplete, except for a litlen or distance
 * code of one codeword of one bit or of no codeword at all, whose unused
 * codewords decode as invalid) or the table would pass cap. */
static int build_table(uint32_t *table, unsigned cap, unsigned tbits,
                       const uint8_t *lens, unsigned nsym, const uint32_t *res,
                       const uint8_t *extra, int incomplete_ok)
{
    unsigned count[16] = {0}, offs[16];
    uint16_t sorted[N_LITLEN];
    unsigned s, len, max = 15, mask = (1u << tbits) - 1;
    int left = 1;

    for (s = 0; s < nsym; s++)
        count[lens[s]]++;
    while (max > 0 && count[max] == 0)
        max--;
    for (len = 1; len <= 15; len++) {
        left = (left << 1) - (int)count[len];
        if (left < 0)
            return -1; /* over-subscribed */
    }
    if (left > 0 && !(incomplete_ok && max <= 1))
        return -1; /* incomplete */
    offs[1] = 0;
    for (len = 1; len < 15; len++)
        offs[len + 1] = offs[len] + count[len];
    for (s = 0; s < nsym; s++)
        if (lens[s])
            sorted[offs[lens[s]]++] = (uint16_t)s;

    unsigned n_codes = offs[15], huff = 0, next = mask + 1, low = ~0u;
    unsigned sub = 0, sub_bits = 0;
    for (unsigned i = 0; i < n_codes; i++) {
        s = sorted[i];
        len = lens[s];
        if (len <= tbits) {
            uint32_t e = res[s] | len << 8 | (len + extra[s]);
            for (unsigned j = huff; j <= mask; j += 1u << len)
                table[j] = e;
        } else {
            if ((huff & mask) != low) {
                /* a new subtable: wide enough for every codeword that
                 * shares these first tbits bits (zlib's sizing) */
                low = huff & mask;
                sub_bits = len - tbits;
                int room = 1 << sub_bits;
                while (sub_bits + tbits < max) {
                    room -= (int)count[sub_bits + tbits];
                    if (room <= 0)
                        break;
                    sub_bits++;
                    room <<= 1;
                }
                if (next + (1u << sub_bits) > cap)
                    return -1;
                sub = next;
                next += 1u << sub_bits;
                table[low] = E_EXC | E_SUB | sub << 16 | sub_bits << 8 | tbits;
            }
            unsigned l = len - tbits;
            uint32_t e = res[s] | l << 8 | (l + extra[s]);
            for (unsigned j = huff >> tbits; j < 1u << sub_bits; j += 1u << l)
                table[sub + j] = e;
        }
        count[len]--;
        /* the next codeword, its bits in reading order */
        unsigned inc = 1u << (len - 1);
        while (huff & inc)
            inc >>= 1;
        huff = inc ? (huff & (inc - 1)) + inc : 0;
    }
    if (left > 0) /* the unused codeword(s) of an allowed incomplete code */
        for (unsigned j = n_codes ? huff : 0; j <= mask; j += n_codes ? 2 : 1)
            table[j] = E_INVALID;
    return 0;
}

__attribute__((constructor)) static void kssd_inflate_init(void)
{
    for (unsigned n = 0; n < 256; n++) {
        uint32_t c = n;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? 0xedb88320u ^ (c >> 1) : c >> 1;
        crc_tab[0][n] = c;
    }
    for (unsigned n = 0; n < 256; n++)
        for (int k = 1; k < 8; k++)
            crc_tab[k][n] = crc_tab[0][crc_tab[k - 1][n] & 0xff] ^ (crc_tab[k - 1][n] >> 8);
#if defined(KSSD_X86) && !defined(KSSD_INFLATE_GENERIC) /* tests build both */
    __builtin_cpu_init();
    have_clmul = __builtin_cpu_supports("pclmul") && __builtin_cpu_supports("sse4.1");
    have_bmi2 = __builtin_cpu_supports("bmi2");
#endif
    for (unsigned s = 0; s < N_LITLEN; s++) {
        if (s < 256)
            lit_res[s] = E_LIT | s << 16;
        else if (s == 256)
            lit_res[s] = E_EXC | E_EOB;
        else if (s < 286) {
            lit_res[s] = (uint32_t)len_base[s - 257] << 16;
            lit_extra[s] = len_bits[s - 257];
        } else
            lit_res[s] = E_EXC; /* 286, 287: invalid */
    }
    for (unsigned s = 0; s < N_DIST; s++) {
        if (s < 30) {
            dist_res[s] = (uint32_t)dist_base[s] << 16;
            dist_extra[s] = dist_bits[s];
        } else
            dist_res[s] = E_EXC; /* 30, 31: invalid */
    }
    for (unsigned s = 0; s < N_PRE; s++)
        pre_res[s] = s << 16;

    uint8_t lens[N_LITLEN];
    memset(lens, 8, 144);
    memset(lens + 144, 9, 112);
    memset(lens + 256, 7, 24);
    memset(lens + 280, 8, 8);
    build_table(fixed_lt, LT_ENOUGH, LT_BITS, lens, N_LITLEN, lit_res, lit_extra, 0);
    memset(lens, 5, N_DIST);
    build_table(fixed_dt, DT_ENOUGH, DT_BITS, lens, N_DIST, dist_res, dist_extra, 0);
}

/* ---- the deflate stream ------------------------------------------------ */

#define MASK(n) (((uint64_t)1 << (n)) - 1)
#define UNLIKELY(x) __builtin_expect(!!(x), 0)
/* the fast loop's margins: an iteration writes at most two literals, a
 * match and the overhang of its last word, and refills at most twice
 * (7 bytes, then an 8-byte load) */
#define FAST_OUT (2 + 258 + 8)
#define FAST_IN 16
#define COPY_WORDS 3 /* words copied before a match's length is tested */

/* bits of the input: bb holds bl valid bits (0 <= bl <= 63, LSB first);
 * the bits above them are zero or the input's next bits */
#define REFILL_FAST() do { \
        bb |= load64(in) << (uint8_t)bl; \
        in += 7 - ((bl >> 3) & 7); \
        bl |= 56; \
    } while (0)
/* to at least 56 bits; the input ending here is a truncation, for a
 * complete member's trailer (8 bytes) covers every refill */
#define REFILL() do { \
        if (in_end - in >= 8) \
            REFILL_FAST(); \
        else \
            while (bl < 56) { \
                if (in == in_end) \
                    return KSSD_INFLATE_TRUNCATED; \
                bb |= (uint64_t)*in++ << bl; \
                bl += 8; \
            } \
    } while (0)
#define DROP(n) do { bb >>= (n); bl -= (n); } while (0)
#define BITS(n) ((unsigned)(bb & MASK(n)))

struct dyn_tables {
    uint32_t lt[LT_ENOUGH], dt[DT_ENOUGH], pt[PT_ENOUGH];
};

/* The deflate stream at *inp into *outp (dst: the member's first output
 * byte; out_end: the end of the space): on success *inp is the first
 * byte after it (its last byte's unused bits dropped), *outp the end of
 * its output and *crc the output's CRC-32. */
static inline __attribute__((always_inline)) int
inflate_blocks(const uint8_t **inp, const uint8_t *in_end, uint8_t *dst,
               uint8_t **outp, uint8_t *out_end, struct dyn_tables *dyn,
               uint32_t *crc)
{
    const uint8_t *in = *inp;
    uint8_t *out = *outp;
    uint64_t bb = 0;
    unsigned bl = 0, final;
    uint32_t reg = 0xffffffffu;

    do {
        const uint32_t *lt, *dt;
        uint32_t e, d;

        /* the CRC of the last block's output, while it is in cache */
        reg = crc32_update(reg, *outp, (size_t)(out - *outp));
        *outp = out;

        REFILL();
        final = BITS(1);
        unsigned type = (unsigned)(bb >> 1) & 3;
        DROP(3);
        if (type == 0) { /* stored */
            DROP(bl & 7);
            in -= bl >> 3; /* the whole bytes back to the input */
            bb = 0;
            bl = 0;
            if (in_end - in < 4)
                return KSSD_INFLATE_TRUNCATED;
            unsigned n = in[0] | in[1] << 8;
            if (n != ((in[2] | in[3] << 8) ^ 0xffffu))
                return KSSD_INFLATE_BAD_DATA;
            in += 4;
            if ((size_t)(in_end - in) < n)
                return KSSD_INFLATE_TRUNCATED;
            if ((size_t)(out_end - out) < n)
                return KSSD_INFLATE_NO_SPACE;
            memcpy(out, in, n);
            in += n;
            out += n;
            continue;
        }
        if (type == 1) {
            lt = fixed_lt;
            dt = fixed_dt;
        } else if (type == 2) {
            uint8_t lens[N_LITLEN + N_DIST];
            REFILL();
            unsigned nlit = BITS(5) + 257;
            unsigned ndist = (BITS(10) >> 5) + 1;
            unsigned npre = (BITS(14) >> 10) + 4;
            DROP(14);
            if (nlit > 286 || ndist > 30)
                return KSSD_INFLATE_BAD_DATA;
            memset(lens, 0, N_PRE);
            for (unsigned i = 0; i < npre; i++) {
                REFILL();
                lens[pre_order[i]] = (uint8_t)BITS(3);
                DROP(3);
            }
            if (build_table(dyn->pt, PT_ENOUGH, PT_BITS, lens, N_PRE, pre_res,
                            no_extra, 0))
                return KSSD_INFLATE_BAD_DATA;
            /* the litlen and distance lengths, one run: a repeat may
             * cross from one into the other */
            for (unsigned i = 0, n = nlit + ndist; i < n;) {
                REFILL();
                e = dyn->pt[BITS(PT_BITS)];
                DROP(e & 0xff);
                unsigned sym = e >> 16, rep;
                uint8_t v = 0;
                if (sym < 16) {
                    lens[i++] = (uint8_t)sym;
                    continue;
                }
                if (sym == 16) {
                    if (i == 0)
                        return KSSD_INFLATE_BAD_DATA;
                    v = lens[i - 1];
                    rep = 3 + BITS(2);
                    DROP(2);
                } else if (sym == 17) {
                    rep = 3 + BITS(3);
                    DROP(3);
                } else {
                    rep = 11 + BITS(7);
                    DROP(7);
                }
                if (rep > n - i)
                    return KSSD_INFLATE_BAD_DATA;
                memset(lens + i, v, rep);
                i += rep;
            }
            if (lens[256] == 0) /* no end-of-block code */
                return KSSD_INFLATE_BAD_DATA;
            if (build_table(dyn->lt, LT_ENOUGH, LT_BITS, lens, nlit, lit_res,
                            lit_extra, 1)
                || build_table(dyn->dt, DT_ENOUGH, DT_BITS, lens + nlit, ndist,
                               dist_res, dist_extra, 1))
                return KSSD_INFLATE_BAD_DATA;
            lt = dyn->lt;
            dt = dyn->dt;
        } else {
            return KSSD_INFLATE_BAD_DATA;
        }

        /* the fast loop, while FAST_OUT bytes of output and FAST_IN of
         * input remain. At its top bl >= 56 and e is the litlen entry of the
         * next bits; each entry's bits are dropped before its kind is
         * tested (a subtable pointer's low byte is the main table's
         * width). Each path looks up the next entry before it refills and
         * before it copies, so the lookup's latency overlaps them. Up to
         * three literals share one refill; a match refills once more,
         * after its distance lookup, when fewer than 28 + 11 bits remain.
         * Here bl is kept only modulo 256: the whole entry is subtracted
         * (its low byte is the bits dropped). */
        if (in_end - in >= 8 + FAST_IN && (size_t)(out_end - out) >= FAST_OUT) {
            const uint8_t *in_fast = in_end - FAST_IN;
            uint8_t *out_fast = out_end - FAST_OUT;
            uint64_t saved;
            REFILL_FAST();
            e = lt[BITS(LT_BITS)];
            do {
                saved = bb;
                bb >>= (uint8_t)e;
                bl -= e;
                if (e & E_LIT) {
                    unsigned lit = (e >> 16) & 0xff;
                    e = lt[BITS(LT_BITS)];
                    saved = bb;
                    bb >>= (uint8_t)e;
                    bl -= e;
                    *out++ = (uint8_t)lit;
                    if (e & E_LIT) {
                        lit = (e >> 16) & 0xff;
                        e = lt[BITS(LT_BITS)];
                        saved = bb;
                        bb >>= (uint8_t)e;
                        bl -= e;
                        *out++ = (uint8_t)lit;
                        if (e & E_LIT) {
                            lit = (e >> 16) & 0xff;
                            e = lt[BITS(LT_BITS)];
                            REFILL_FAST();
                            *out++ = (uint8_t)lit;
                            continue;
                        }
                    }
                }
                if (UNLIKELY(e & E_EXC)) {
                    if (!(e & E_SUB)) {
                        if (e & E_EOB)
                            goto fast_done;
                        return KSSD_INFLATE_BAD_DATA;
                    }
                    e = lt[(e >> 16) + BITS((e >> 8) & 15)];
                    saved = bb;
                    bb >>= (uint8_t)e;
                    bl -= e;
                    if (e & E_LIT) {
                        unsigned lit = (e >> 16) & 0xff;
                        e = lt[BITS(LT_BITS)];
                        REFILL_FAST();
                        *out++ = (uint8_t)lit;
                        continue;
                    }
                    if (e & E_EXC) {
                        if (e & E_EOB)
                            goto fast_done;
                        return KSSD_INFLATE_BAD_DATA;
                    }
                }
                size_t len = (e >> 16) + ((saved & MASK((uint8_t)e)) >> ((e >> 8) & 15));
                d = dt[BITS(DT_BITS)];
                if ((uint8_t)bl < 28 + LT_BITS)
                    REFILL_FAST();
                if (UNLIKELY(d & E_EXC)) {
                    if (!(d & E_SUB))
                        return KSSD_INFLATE_BAD_DATA;
                    bb >>= DT_BITS;
                    bl -= DT_BITS;
                    d = dt[(d >> 16) + BITS((d >> 8) & 15)];
                    if (d & E_EXC)
                        return KSSD_INFLATE_BAD_DATA;
                }
                saved = bb;
                bb >>= (uint8_t)d;
                bl -= d;
                size_t dist = (d >> 16) + ((saved & MASK((uint8_t)d)) >> ((d >> 8) & 15));
                if (UNLIKELY(dist > (size_t)(out - dst)))
                    return KSSD_INFLATE_BAD_DATA;
                e = lt[BITS(LT_BITS)];
                REFILL_FAST();
                uint8_t *o = out;
                const uint8_t *s = out - dist;
                out += len;
                if (dist >= 8) {
                    /* COPY_WORDS words cover most matches with no branch */
                    for (int w = 0; w < COPY_WORDS; w++)
                        copy64(o + 8 * w, s + 8 * w);
                    for (o += 8 * COPY_WORDS, s += 8 * COPY_WORDS; o < out; o += 8, s += 8)
                        copy64(o, s);
                } else if (dist == 1) {
                    uint64_t v = 0x0101010101010101ull * *s;
                    memcpy(o, &v, 8);
                    memcpy(o + 8, &v, 8);
                    for (o += 16; o < out; o += 8)
                        memcpy(o, &v, 8);
                } else {
                    /* each word puts dist right bytes at o; the rest is
                     * overwritten by the next word or lies past the match */
                    copy64(o, s);
                    o += dist;
                    s += dist;
                    do {
                        copy64(o, s);
                        o += dist;
                        s += dist;
                    } while (o < out);
                }
            } while (in <= in_fast && out <= out_fast);
            bl = (uint8_t)bl;
            goto careful;
        fast_done:
            bl = (uint8_t)bl;
            goto block_done;
        }
    careful:
        /* the careful loop: the rest of the block, bounds checked */
        for (;;) {
            REFILL();
            e = lt[BITS(LT_BITS)];
            if (e & E_SUB) {
                DROP(LT_BITS);
                e = lt[(e >> 16) + BITS((e >> 8) & 15)];
            }
            if (e & E_LIT) {
                if (out == out_end)
                    return KSSD_INFLATE_NO_SPACE;
                DROP(e & 0xff);
                *out++ = (uint8_t)(e >> 16);
                continue;
            }
            if (e & E_EXC) {
                if (!(e & E_EOB))
                    return KSSD_INFLATE_BAD_DATA;
                DROP(e & 0xff);
                break;
            }
            uint64_t saved = bb;
            DROP(e & 0xff);
            size_t len = (e >> 16) + ((saved & MASK(e & 0xff)) >> ((e >> 8) & 15));
            d = dt[BITS(DT_BITS)];
            if (d & E_SUB) {
                DROP(DT_BITS);
                d = dt[(d >> 16) + BITS((d >> 8) & 15)];
            }
            if (d & E_EXC)
                return KSSD_INFLATE_BAD_DATA;
            saved = bb;
            DROP(d & 0xff);
            size_t dist = (d >> 16) + ((saved & MASK(d & 0xff)) >> ((d >> 8) & 15));
            if (dist > (size_t)(out - dst))
                return KSSD_INFLATE_BAD_DATA;
            if (len > (size_t)(out_end - out))
                return KSSD_INFLATE_NO_SPACE;
            for (const uint8_t *s = out - dist, *end = out + len; out < end;)
                *out++ = *s++;
        }
    block_done:;
    } while (!final);

    DROP(bl & 7);
    *inp = in - (bl >> 3);
    *crc = ~crc32_update(reg, *outp, (size_t)(out - *outp));
    *outp = out;
    return KSSD_INFLATE_OK;
}

static int inflate_plain(const uint8_t **inp, const uint8_t *in_end, uint8_t *dst,
                         uint8_t **outp, uint8_t *out_end, struct dyn_tables *dyn,
                         uint32_t *crc)
{
    return inflate_blocks(inp, in_end, dst, outp, out_end, dyn, crc);
}

#ifdef KSSD_X86
__attribute__((target("bmi2")))
static int inflate_bmi2(const uint8_t **inp, const uint8_t *in_end, uint8_t *dst,
                        uint8_t **outp, uint8_t *out_end, struct dyn_tables *dyn,
                        uint32_t *crc)
{
    return inflate_blocks(inp, in_end, dst, outp, out_end, dyn, crc);
}
#endif

/* ---- the gzip member ---------------------------------------------------- */

/* One gzip member at src (n_src bytes readable; bytes after the member
 * are not read) inflated into dst (n_dst bytes writable). On
 * KSSD_INFLATE_OK, *n_read is the member's length, header and trailer
 * included, and *n_written its output's; otherwise both are 0 and dst's
 * bytes are unspecified. The header is parsed as the gzip module parses
 * it: ID1 ID2 CM (8), FLG, MTIME, XFL, OS, then FEXTRA, FNAME, FCOMMENT
 * and FHCRC where FLG sets them. */
int kssd_gzip_inflate(const uint8_t *src, size_t n_src, uint8_t *dst, size_t n_dst,
                      size_t *n_read, size_t *n_written)
{
    const uint8_t *in = src, *in_end = src + n_src;
    uint8_t *out = dst;
    struct dyn_tables dyn;
    uint32_t crc;
    int rc;

    *n_read = *n_written = 0;
    if (n_src < 10)
        return n_src >= 2 && (src[0] != 0x1f || src[1] != 0x8b)
                   ? KSSD_INFLATE_BAD_DATA : KSSD_INFLATE_TRUNCATED;
    if (src[0] != 0x1f || src[1] != 0x8b || src[2] != 8)
        return KSSD_INFLATE_BAD_DATA;
    unsigned flg = src[3];
    in += 10;
    if (flg & 4) { /* FEXTRA */
        if (in_end - in < 2)
            return KSSD_INFLATE_TRUNCATED;
        size_t xlen = in[0] | in[1] << 8;
        in += 2;
        if ((size_t)(in_end - in) < xlen)
            return KSSD_INFLATE_TRUNCATED;
        in += xlen;
    }
    for (unsigned f = 8; f <= 16; f += 8) /* FNAME, FCOMMENT */
        if (flg & f) {
            const uint8_t *z = memchr(in, 0, (size_t)(in_end - in));
            if (!z)
                return KSSD_INFLATE_TRUNCATED;
            in = z + 1;
        }
    if (flg & 2) { /* FHCRC */
        if (in_end - in < 2)
            return KSSD_INFLATE_TRUNCATED;
        in += 2;
    }
#ifdef KSSD_X86
    if (have_bmi2)
        rc = inflate_bmi2(&in, in_end, dst, &out, dst + n_dst, &dyn, &crc);
    else
#endif
        rc = inflate_plain(&in, in_end, dst, &out, dst + n_dst, &dyn, &crc);
    if (rc != KSSD_INFLATE_OK)
        return rc;
    if (in_end - in < 8)
        return KSSD_INFLATE_TRUNCATED;
    size_t n = (size_t)(out - dst);
    if (load32(in) != crc || load32(in + 4) != (uint32_t)n)
        return KSSD_INFLATE_BAD_CHECK;
    *n_read = (size_t)(in + 8 - src);
    *n_written = n;
    return KSSD_INFLATE_OK;
}

/* The CRC-32 of n bytes at p, as zlib.crc32 gives it from 0. */
uint32_t kssd_crc32(const uint8_t *p, size_t n)
{
    return ~crc32_update(0xffffffffu, p, n);
}
