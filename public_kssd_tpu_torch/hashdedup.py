"""Per-genome dedup of kept sketch codes.

Semantically, a genome's sketch is the SET of kept drtuples (plus
occurrence counters for fastq). The reference materialises this set with
an open-addressing double hash (HASH/H1/H2, global_basic.h:228-230) and
dumps occupied slots in slot order (wrt_co2cmpn_use_inn_subctx,
iseq2comem.c:525-551), so the on-disk code order is the hash-table layout.

On TPU we dedup by sort-unique (order-invariant; distances are identical),
but to produce byte-identical sketch files we also replicate the exact
slot ordering here on the host: the kept-code stream is tiny (~genome
bases / 16^drlevel), so an exact table simulation costs microseconds.

Reference quirk reproduced deliberately: drtuple == 0 occupies no slot
(``co[n] == 0`` doubles as the empty marker) and is silently dropped from
sketches (iseq2comem.c:254-268 with wrt filter co[count] != 0).
"""

from __future__ import annotations

import numpy as np

from public_kssd_tpu_torch.config import SketchParams


class HashCrowdedError(RuntimeError):
    """Mirror of the reference 'context space too crowded' abort
    (iseq2comem.c:262-263)."""


def _probe_insert(table: np.ndarray, key: int, hashsize: int) -> int:
    """Insert key; return slot, or -1 if already present. key > 0."""
    h1 = key % hashsize
    h2 = 1 + key % (hashsize - 1)
    n = h1
    for _ in range(hashsize):
        v = table[n]
        if v == 0:
            table[n] = key
            return n
        if v == key:
            return -1
        n = (n + h2) % hashsize
    raise HashCrowdedError("hash table full")


def dedup_slot_order(
    codes: np.ndarray, params: SketchParams, uniq: bool = False
) -> np.ndarray:
    """fasta2co-compatible dedup: return distinct codes in hash-slot order.

    uniq=True replicates uniq_fasta2co (iseq2comem.c:616-703): codes seen
    more than once are marked and dropped from the output (the ``-u``
    reference-dedup mode). Uses the native library when available.
    """
    from public_kssd_tpu_torch import native

    out = native.dedup_slot_order(codes, params.hashsize, params.hashlimit, uniq)
    if out is not None:
        return out
    return dedup_slot_order_py(codes, params, uniq)


def dedup_slot_order_py(
    codes: np.ndarray, params: SketchParams, uniq: bool = False
) -> np.ndarray:
    """Pure-python implementation (fallback + test oracle)."""
    hashsize = params.hashsize
    table = np.zeros(hashsize, dtype=np.uint64)
    marked = np.zeros(hashsize, dtype=bool) if uniq else None
    keycount = 0
    slot_of = {}  # key -> slot, to re-find duplicates without re-probing
    for c in codes.tolist():
        if c == 0:
            keycount += 1  # quirk: re-"inserted" every occurrence, never stored
            if keycount > params.hashlimit:
                raise HashCrowdedError(
                    f"the context space is too crowded, rerun with -k "
                    f"{params.half_ctx_len + 1}"
                )
            continue
        prev = slot_of.get(c)
        if prev is None:
            h1 = c % hashsize
            h2 = 1 + c % (hashsize - 1)
            n = h1
            while True:
                v = table[n]
                if v == 0:
                    table[n] = c
                    slot_of[c] = n
                    keycount += 1
                    if keycount > params.hashlimit:
                        raise HashCrowdedError(
                            f"the context space is too crowded, rerun with -k "
                            f"{params.half_ctx_len + 1}"
                        )
                    break
                if v == c:
                    slot_of[c] = n
                    if uniq:
                        marked[n] = True
                    break
                n = (n + h2) % hashsize
        elif uniq:
            marked[prev] = True
    occupied = table != 0
    if uniq:
        occupied &= ~marked
    return table[occupied]  # ascending slot order


def dedup_counts_slot_order(
    codes: np.ndarray,
    params: SketchParams,
    count_bits: int,
    min_occurrence: int = 1,
) -> tuple[np.ndarray, np.ndarray]:
    """Counted dedup in slot order; native when available (see the
    pure-python twin below for semantics)."""
    from public_kssd_tpu_torch import native

    out = native.dedup_counts(codes, params.hashsize, count_bits, min_occurrence)
    if out is not None:
        return out
    return dedup_counts_slot_order_py(codes, params, count_bits, min_occurrence)


def dedup_counts_slot_order_py(
    codes: np.ndarray,
    params: SketchParams,
    count_bits: int,
    min_occurrence: int = 1,
) -> tuple[np.ndarray, np.ndarray]:
    """fastq2co / fastq2koc-compatible dedup with occurrence counters.

    The table slot holds ``(drtuple << count_bits) | count``:

      * count_bits=4, saturate=False  -> fastq2co (iseq2comem.c:277-356):
        count saturates at CT_MAX=15; a code is "passed" once count
        reaches min_occurrence (then pinned to 15). Returns codes whose
        low nibble == 15, in slot order; counts returned are the raw
        nibbles (callers ignore them).
      * count_bits=16, saturate=True  -> fastq2koc (iseq2comem.c:359-434):
        count saturates at 65535; returns all codes with their counts.

    Here drtuple == 0 inserts as ``0<<bits|1`` != 0, matching the
    reference (the counter makes the slot non-zero, so unlike fasta the
    zero code IS kept in fastq mode).
    """
    ct_max = (1 << count_bits) - 1
    hashsize = params.hashsize
    table = {}  # key -> [slot, count]; slot assignment replicated below
    slots = np.zeros(hashsize, dtype=np.uint64)  # slot -> key<<bits|count
    key_at = np.full(hashsize, -1, dtype=np.int64)
    for c in codes.tolist():
        ent = table.get(c)
        if ent is None:
            # the reference probes HASH(drtuple, ...) — the raw drtuple key
            h1 = c % hashsize
            h2 = 1 + c % (hashsize - 1)
            n = h1
            while True:
                if key_at[n] == -1:
                    if count_bits == 4 and min_occurrence == 1:
                        cnt = ct_max  # fastq2co M==1 shortcut (iseq2comem.c:336)
                    else:
                        cnt = 1
                    key_at[n] = c
                    table[c] = [n, cnt]
                    break
                if key_at[n] == c:  # can't happen (ent None) but mirror logic
                    break
                n = (n + h2) % hashsize
        else:
            n, cnt = ent
            if count_bits == 4:
                if cnt != ct_max:
                    cnt += 1
                    if not (cnt & ct_max) < min_occurrence:
                        cnt |= ct_max
                    ent[1] = cnt
            else:
                if cnt < ct_max:
                    ent[1] = cnt + 1
    order = np.flatnonzero(key_at != -1)
    keys = key_at[order].astype(np.uint64)
    counts = np.array([table[int(k)][1] for k in keys], dtype=np.uint32)
    if count_bits == 4:
        passed = counts == ct_max
        return keys[passed], counts[passed]
    return keys, counts


def dedup_sorted(codes: np.ndarray, uniq: bool = False) -> np.ndarray:
    """Fast order-invariant dedup (ascending): the TPU-native default.

    Same set as dedup_slot_order (drtuple 0 dropped; uniq keeps
    singletons only); only the on-disk ordering differs.
    """
    vals, counts = np.unique(codes, return_counts=True)
    if uniq:
        vals = vals[counts == 1]
    return vals[vals != 0]


def dedup_counts_sorted(
    codes: np.ndarray, count_bits: int, min_occurrence: int = 1
) -> tuple[np.ndarray, np.ndarray]:
    """Fast order-invariant counted dedup (ascending codes + counts)."""
    ct_max = (1 << count_bits) - 1
    vals, counts = np.unique(codes, return_counts=True)
    counts = np.minimum(counts, ct_max).astype(np.uint32)
    if count_bits == 4:
        passed = counts >= min_occurrence
        return vals[passed], counts[passed]
    return vals, counts
