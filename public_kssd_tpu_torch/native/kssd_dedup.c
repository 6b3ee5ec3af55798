/* Slot-order dedup that visits only the slots it fills.
 *
 * The reference dedups a genome's kept codes through an open-addressing
 * double hash of hashsize slots (HASH/H1/H2, global_basic.h:228-230) and
 * writes them in slot order. kssd_host.c's kssd_dedup_slot_order and
 * kssd_dedup_counts replicate it on a zeroed table of hashsize slots and
 * then scan all of them: 2,097,143 slots at L3K10, 536,870,909 (4.3 GB)
 * at L3K12, for a stream of a few thousand codes.
 *
 * The twins here run the same insertion loops over a virtual table: a
 * map from slot index to slot value that holds only the slots the stream
 * fills, so memory and time follow the stream's length, not hashsize.
 * A slot filled once stays filled, so slot order is the ascending order
 * of the filled slots' indices; radix-sorting them gives the scan's
 * bytes.
 *
 * Built into the same helper library as kssd_host.c, with its flags.
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#define HIBIT 0x8000000000000000ULL

/* The virtual table: slot s's value is val[e] where key[e] == s + 1
 * (s + 1 fits: hashsize < 2^32 - 1); an absent slot reads 0, as an
 * empty slot of the dense table does. Open addressing with linear
 * probing; the caller gives a zeroed key array whose capacity is a
 * power of two >= 4 and at least twice the slots that can fill, so the
 * map stays under half full. */
struct vtable {
    uint32_t *key;
    uint64_t *val;
    uint32_t mask;
    unsigned shift; /* 32 - log2(capacity): Fibonacci hashing */
};

static struct vtable vt_init(uint32_t *key, uint64_t *val, uint32_t cap)
{
    struct vtable t = {key, val, cap - 1, 32};
    while (cap > 1) {
        cap >>= 1;
        t.shift--;
    }
    return t;
}

/* The entry that holds slot s, or the empty entry where it would go. */
static uint32_t vt_find(const struct vtable *t, uint32_t s)
{
    uint32_t e = (uint32_t)(s * 0x9E3779B1u) >> t->shift;
    while (t->key[e] != 0 && t->key[e] != s + 1)
        e = (e + 1) & t->mask;
    return e;
}

#define RADIX_BITS 11
#define RADIX_SIZE (1u << RADIX_BITS)

/* Sorts a[0..m) ascending: LSD radix sort of 11-bit digits, as many
 * passes as slots below hashsize need, through tmp[0..m). Returns the
 * array that holds the sorted slots (a or tmp). */
static const uint32_t *sort_slots(uint32_t *a, uint32_t *tmp, size_t m,
                                  uint32_t hashsize)
{
    size_t count[RADIX_SIZE];
    uint32_t top = hashsize - 1;
    for (unsigned shift = 0; shift < 32 && (top >> shift) != 0;
         shift += RADIX_BITS) {
        memset(count, 0, sizeof count);
        for (size_t i = 0; i < m; i++)
            count[(a[i] >> shift) & (RADIX_SIZE - 1)]++;
        size_t sum = 0;
        for (size_t d = 0; d < RADIX_SIZE; d++) {
            size_t c = count[d];
            count[d] = sum;
            sum += c;
        }
        for (size_t i = 0; i < m; i++)
            tmp[count[(a[i] >> shift) & (RADIX_SIZE - 1)]++] = a[i];
        uint32_t *t = a;
        a = tmp;
        tmp = t;
    }
    return a;
}

/* kssd_dedup_slot_order's output. key / val: the virtual table (key
 * zeroed, cap entries, cap a power of two >= 4 and >= 2 * min(n,
 * hashlimit + 1)); slots: capacity 2 * min(n, hashlimit + 1) (the filled
 * slots, then the sort's work space); out: capacity min(n, hashlimit +
 * 1). Returns the number of codes written to out, or (size_t)-1 on
 * "space too crowded" (keycount > hashlimit). */
size_t kssd_dedup_slot_order_sparse(const uint64_t *codes, size_t n,
                                    uint32_t hashsize, uint32_t hashlimit,
                                    int uniq, uint32_t *key, uint64_t *val,
                                    uint32_t cap, uint32_t *slots,
                                    uint64_t *out)
{
    struct vtable t = vt_init(key, val, cap);
    uint64_t keycount = 0;
    size_t m = 0; /* filled slots */
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
            uint32_t e = vt_find(&t, s);
            uint64_t v = t.key[e] ? t.val[e] : 0;
            if (v == 0) {
                t.key[e] = s + 1;
                t.val[e] = c;
                slots[m++] = s;
                if (++keycount > hashlimit)
                    return (size_t)-1;
                break;
            }
            if ((v | HIBIT) == (c | HIBIT)) {
                if (uniq)
                    t.val[e] = v | HIBIT;
                break;
            }
            s += h2;
            if (s >= hashsize)
                s -= hashsize;
        }
    }
    const uint32_t *sorted = sort_slots(slots, slots + m, m, hashsize);
    size_t o = 0;
    for (size_t i = 0; i < m; i++) {
        uint64_t v = t.val[vt_find(&t, sorted[i])];
        if (v < HIBIT) /* a filled slot is never 0 */
            out[o++] = v;
    }
    return o;
}

/* kssd_dedup_counts's output. key / val: the virtual table (key zeroed,
 * cap a power of two >= 4 and >= 2 * min(n, hashsize)); slots: capacity
 * 2 * min(n, hashsize); out_codes / out_counts: capacity min(n,
 * hashsize). Returns the output length. */
size_t kssd_dedup_counts_sparse(const uint64_t *codes, size_t n,
                                uint32_t hashsize, int count_bits,
                                int min_occurrence, uint32_t *key,
                                uint64_t *val, uint32_t cap, uint32_t *slots,
                                uint64_t *out_codes, uint32_t *out_counts)
{
    struct vtable t = vt_init(key, val, cap);
    const uint64_t ct_max = (1ULL << count_bits) - 1;
    size_t m = 0; /* filled slots */
    for (size_t i = 0; i < n; i++) {
        uint64_t c = codes[i];
        uint32_t h1 = (uint32_t)(c % hashsize);
        uint32_t h2 = 1 + (uint32_t)(c % (hashsize - 1));
        uint32_t s = h1;
        for (;;) {
            uint32_t e = vt_find(&t, s);
            if (t.key[e] == 0) { /* (c << bits) + 1, (c << 4) | 15: never 0 */
                t.key[e] = s + 1;
                if (count_bits == 4 && min_occurrence == 1)
                    t.val[e] = (c << 4) | ct_max; /* iseq2comem.c:336 */
                else
                    t.val[e] = (c << count_bits) + 1;
                slots[m++] = s;
                break;
            }
            uint64_t v = t.val[e];
            if ((v >> count_bits) == c) {
                uint64_t cnt = v & ct_max;
                if (count_bits == 4) {
                    if (cnt != ct_max) {
                        v += 1;
                        if (!(((v & ct_max)) < (uint64_t)min_occurrence))
                            v |= ct_max;
                        t.val[e] = v;
                    }
                } else {
                    if (cnt < ct_max)
                        t.val[e] = v + 1;
                }
                break;
            }
            s += h2;
            if (s >= hashsize)
                s -= hashsize;
        }
    }
    const uint32_t *sorted = sort_slots(slots, slots + m, m, hashsize);
    size_t o = 0;
    for (size_t i = 0; i < m; i++) {
        uint64_t v = t.val[vt_find(&t, sorted[i])];
        if (count_bits == 4 && (v & 15) != 15)
            continue;
        out_codes[o] = v >> count_bits;
        out_counts[o] = (uint32_t)(v & ct_max);
        o++;
    }
    return o;
}
