"""The port's counting and index modules against the JAX package's, on
the CPU: random CSR indexes with planted hits through
``public_kssd_tpu.ops.count.count_shared`` and ``count_shared_weighted``
(device path on the CPU backend, and the numpy oracle) and through the
port's plain versions. Exact equality: the counts are integers.
"""

import numpy as np
import pytest
import torch

from public_kssd_tpu import index as jax_index
from public_kssd_tpu.ops import count as jax_count
from public_kssd_tpu_torch import index as torch_index
from public_kssd_tpu_torch.ops import count

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _csr(n_ref, sketch_sz, seed, space=1 << 28, hot=0):
    """Sparse index over n_ref random sketches (codes unique within a
    sketch) plus the per-genome codes. ``hot`` > 0 plants one code into
    that many genomes: a very long postings list."""
    rng = np.random.default_rng(seed)
    ref = [
        np.unique(rng.integers(0, space, size=sketch_sz, dtype=np.uint64))
        for _ in range(n_ref)
    ]
    hot_code = np.uint64(space - 7)
    for g in range(min(hot, n_ref)):
        ref[g] = np.union1d(ref[g], [hot_code])
    codes = np.concatenate(ref).astype(np.uint32)
    idx = np.zeros(n_ref + 1, np.uint64)
    np.cumsum([r.size for r in ref], out=idx[1:])
    sp = jax_index.build_component_index(codes, idx, n_ref)
    return sp, ref, int(hot_code)


def _queries(ref, n_qry, sketch_sz, seed, space=1 << 28, extra=()):
    """Queries: random codes with ~30% planted hits; query 1 is empty;
    ``extra`` codes are appended to query 0."""
    rng = np.random.default_rng(seed + 1000)
    flat = np.concatenate(ref)
    qs = []
    for q in range(n_qry):
        if q == 1:
            qs.append(np.zeros(0, np.uint64))
            continue
        c = rng.integers(0, space, size=sketch_sz, dtype=np.uint64)
        hit = rng.random(c.size) < 0.3
        c[hit] = flat[rng.integers(0, flat.size, size=int(hit.sum()))]
        if q == 0:
            c = np.concatenate([c, np.asarray(extra, np.uint64)])
        qs.append(c)
    qidx = np.zeros(n_qry + 1, np.uint64)
    np.cumsum([q.size for q in qs], out=qidx[1:])
    return np.concatenate(qs).astype(np.uint32), qidx


@pytest.mark.parametrize(
    "n_ref,n_qry,sketch_sz,seed,space,hot",
    [
        (40, 9, 300, 1, 1 << 28, 0),
        (200, 17, 150, 2, 1 << 20, 150),  # dense hits + a long postings list
        (64, 5, 500, 3, 1 << 32, 30),  # codes >= 2^31
    ],
)
def test_count_shared_torch_matches_jax(n_ref, n_qry, sketch_sz, seed, space, hot):
    sp, ref, hot_code = _csr(n_ref, sketch_sz, seed, space, hot)
    absent = int(space - 3)  # not in any sketch (space-7 is the hot code)
    assert not np.isin(absent, sp.uniq_codes)
    extra = [absent, hot_code] if hot else [absent]
    qc, qidx = _queries(ref, n_qry, sketch_sz, seed, space, extra)

    want_np = jax_count.count_shared(qc, qidx, sp, n_qry, use_device=False)
    want_dev = jax_count.count_shared(qc, qidx, sp, n_qry, use_device=True)
    np.testing.assert_array_equal(want_dev, want_np)

    index = count.DeviceIndex.from_sparse(sp, CPU)
    got = count.count_shared_torch(
        count._u32_view(qc), torch.from_numpy(count.query_ids(qidx, qc.size)),
        index, n_qry,
    )
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want_np)
    np.testing.assert_array_equal(
        count.count_shared(qc, qidx, sp, n_qry, CPU), want_np
    )
    np.testing.assert_array_equal(
        count.count_shared(qc, qidx, sp, n_qry, None), want_np
    )
    assert not want_np[1].any()  # the empty query
    assert want_np.sum() > 0
    if hot:
        assert want_np[0, :hot].min() >= 1


def test_count_np_copy_matches_jax():
    sp, ref, _ = _csr(30, 200, 7)
    qc, qidx = _queries(ref, 6, 200, 7)
    args = (qc, qidx, sp.uniq_codes, sp.offsets, sp.gids, 6, 30)
    np.testing.assert_array_equal(
        count.count_shared_np(*args), jax_count.count_shared_np(*args)
    )


def test_device_index_from_jax_sparse_index():
    """A SparseIndex built by the JAX package carries over: the port's
    device-resident form gives the same counts, and is cached."""
    sp, ref, _ = _csr(50, 250, 11, hot=20)
    qc, qidx = _queries(ref, 8, 250, 11)
    dev = count.DeviceIndex.from_sparse(sp, CPU)
    assert count.DeviceIndex.from_sparse(sp, "cpu") is dev
    assert dev.uniq.dtype == torch.int32 and dev.gids.dtype == torch.int32
    assert dev.offsets.dtype == torch.int64
    np.testing.assert_array_equal(
        dev.uniq.numpy().view(np.uint32), sp.uniq_codes
    )
    np.testing.assert_array_equal(dev.offsets.numpy(), sp.offsets.astype(np.int64))
    got = count.count_shared_kernel(
        count._u32_view(qc), torch.from_numpy(count.query_ids(qidx, qc.size)),
        dev, 8,
    )
    np.testing.assert_array_equal(
        got.numpy().view(np.uint32),
        jax_count.count_shared(qc, qidx, sp, 8, use_device=True),
    )


def _ptr(a: np.ndarray) -> int:
    return a.__array_interface__["data"][0]


@pytest.mark.parametrize(
    "offs_dtype,gids_dtype,shared",
    [
        ("<u8", "<u4", True),  # the index files' dtypes
        ("<i8", "<u4", True),  # a mesh shard's offsets (parallel/sharded_search)
        ("<i8", "<i4", True),
        ("<u4", "<i8", False),  # other widths are converted
    ],
)
def test_device_index_views_host_memory(offs_dtype, gids_dtype, shared):
    """from_arrays uploads 8-byte offsets and 4-byte genome ids through
    zero-copy views (on the CPU the index then shares their memory), and
    converts other dtypes; the counts equal the JAX package's."""
    sp, ref, _ = _csr(50, 250, 13, hot=20)
    qc, qidx = _queries(ref, 8, 250, 13)
    offs, gids = sp.offsets.astype(offs_dtype), sp.gids.astype(gids_dtype)
    idx = count.DeviceIndex.from_arrays(sp.uniq_codes, offs, gids, sp.n_genomes, CPU)
    assert idx.offsets.dtype == torch.int64 and idx.gids.dtype == torch.int32
    assert (idx.offsets.data_ptr() == _ptr(offs)) == shared
    assert (idx.gids.data_ptr() == _ptr(gids)) == shared
    assert idx.uniq.data_ptr() == _ptr(sp.uniq_codes)
    got = count.count_shared_kernel(
        count._u32_view(qc), torch.from_numpy(count.query_ids(qidx, qc.size)),
        idx, 8,
    )
    want = jax_count.count_shared(qc, qidx, sp, 8, use_device=False)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert want.sum() > 0


@pytest.mark.parametrize(
    "case", ["offsets_2^63", "gids_2^31_u4", "gids_2^32_i8", "gids_negative_i4"],
)
def test_device_index_refuses_out_of_range(case):
    """Postings totals past int64 and genome ids past int32 are refused,
    whether the ids come up as views (4 bytes) or are narrowed (8 bytes:
    2^32 would narrow to 0)."""
    sp, _, _ = _csr(10, 50, 17)
    offs, gids = sp.offsets.copy(), sp.gids.astype("<u4")
    if case == "offsets_2^63":
        offs[-1] = np.uint64(1 << 63)
    elif case == "gids_2^31_u4":
        gids[3] = np.uint32(1 << 31)
    elif case == "gids_2^32_i8":
        gids = gids.astype(np.int64)
        gids[3] = 1 << 32
    else:
        gids = gids.astype(np.int32)
        gids[3] = -1
    with pytest.raises(ValueError, match="postings total" if "offsets" in case
                       else "genome ids"):
        count.DeviceIndex.from_arrays(sp.uniq_codes, offs, gids, sp.n_genomes, CPU)


@pytest.mark.parametrize("koc", [False, True])
@pytest.mark.parametrize("device", [CPU, None])
@pytest.mark.parametrize("empty", [False, True])
def test_count_shared_tensors_matches_jax(koc, device, empty):
    """One component's counts left as tensors (int32 / int64 bit views)
    equal the JAX package's uint32 counts and uint64 weighted sums; no
    query codes give zeros of both dtypes."""
    sp, ref, _ = _csr(40, 200, 19, hot=10)
    qc, qidx = _queries(ref, 6, 200, 19)
    if empty:
        qc, qidx = qc[:0], np.zeros(7, np.uint64)
    w = _weights(qc.size, 19)
    got = count.count_shared_tensors(qc, qidx, sp, 6, device, w if koc else None)
    assert [t.dtype for t in got] == [torch.int32, torch.int64][:1 + koc]
    assert all(t.shape == (6, 40) and t.device == CPU for t in got)
    want = jax_count.count_shared(qc, qidx, sp, 6, use_device=False)
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32), want)
    if koc:
        np.testing.assert_array_equal(
            got[1].numpy().view(np.uint64),
            jax_count.count_shared_weighted(qc, qidx, w, sp, 6, use_device=False),
        )
    assert (want.sum() == 0) == empty


def test_sort_u64_sign_safe():
    """Keys code<<32|gid with codes >= 2^31 sort as unsigned."""
    rng = np.random.default_rng(5)
    key = rng.integers(0, 1 << 64, size=5000, dtype=np.uint64)
    key[:10] = [0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1, 1 << 31 << 32,
                (1 << 32) - 1, 1 << 32, 5, (1 << 63) + 1]
    np.testing.assert_array_equal(torch_index.sort_u64(key, CPU), np.sort(key))


@pytest.mark.parametrize("space", [1 << 28, 1 << 32])
def test_build_component_index_device_sort(space):
    """The port's stage II inversion with the device sort equals the JAX
    package's host build."""
    rng = np.random.default_rng(9)
    ref = [np.unique(rng.integers(0, space, 400, dtype=np.uint64)) for _ in range(25)]
    codes = np.concatenate(ref).astype(np.uint32)
    idx = np.zeros(26, np.uint64)
    np.cumsum([r.size for r in ref], out=idx[1:])
    want = jax_index.build_component_index(codes, idx, 25)
    for device in (None, CPU):
        got = torch_index.build_component_index(codes, idx, 25, device=device)
        for name in ("uniq_codes", "offsets", "gids"):
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


# ---------------------------------------------------------------- koc


def _weights(n, seed, planted=()):
    """uint32 abundances 1..65535; ``planted`` positions get 2^32 - 1."""
    w = np.random.default_rng(seed + 2000).integers(1, 1 << 16, n).astype(np.uint32)
    w[list(planted)] = (1 << 32) - 1
    return w


def _koc_all(qc, qidx, w, sp, n_qry):
    """The port's koc counts four ways (plain tensors, the CPU wrapper,
    the host entry on the CPU and the host oracle), each checked equal,
    plus the JAX package's device and host weighted counts."""
    want = jax_count.count_shared_weighted(qc, qidx, w, sp, n_qry, use_device=False)
    np.testing.assert_array_equal(
        jax_count.count_shared_weighted(qc, qidx, w, sp, n_qry, use_device=True),
        want,
    )
    want_plain = jax_count.count_shared_np(
        qc, qidx, sp.uniq_codes, sp.offsets, sp.gids, n_qry, sp.n_genomes
    )
    index = count.DeviceIndex.from_sparse(sp, CPU)
    args = (count._u32_view(qc), torch.from_numpy(count.query_ids(qidx, qc.size)),
            count._u32_view(w), index, n_qry)
    for c, wt in (count.count_shared_koc_torch(*args),
                  count.count_shared_koc_kernel(*args)):
        assert c.dtype == torch.int32 and wt.dtype == torch.int64
        np.testing.assert_array_equal(c.numpy().view(np.uint32), want_plain)
        np.testing.assert_array_equal(wt.numpy().view(np.uint64), want)
    for device in (CPU, None):
        c, wt = count.count_shared_koc(qc, qidx, w, sp, n_qry, device)
        assert c.dtype == np.uint32 and wt.dtype == np.uint64
        np.testing.assert_array_equal(c, want_plain)
        np.testing.assert_array_equal(wt, want)
        np.testing.assert_array_equal(
            count.count_shared_weighted(qc, qidx, w, sp, n_qry, device), want
        )
    return want, want_plain


@pytest.mark.parametrize(
    "n_ref,n_qry,sketch_sz,seed,space,hot",
    [
        (40, 9, 300, 1, 1 << 28, 0),
        (200, 17, 150, 2, 1 << 20, 150),  # dense hits + a long postings list
        (64, 5, 500, 3, 1 << 32, 30),  # codes >= 2^31
    ],
)
def test_count_shared_weighted_matches_jax(n_ref, n_qry, sketch_sz, seed, space, hot):
    """Random CSRs with planted hits; query 0 repeats the hot code (or a
    hit code) with weight 2^32 - 1, so one cell passes 2^32."""
    sp, ref, hot_code = _csr(n_ref, sketch_sz, seed, space, hot)
    rep = hot_code if hot else int(ref[0][0])
    qc, qidx = _queries(ref, n_qry, sketch_sz, seed, space, [rep] * 3)
    w = _weights(qc.size, seed, planted=range(int(qidx[1]) - 3, int(qidx[1])))
    want, want_plain = _koc_all(qc, qidx, w, sp, n_qry)
    assert int(want[0, 0]) > 1 << 32 and want_plain.sum() > 0
    assert not want[1].any()  # the empty query
    assert (want >= want_plain).all()


def test_count_shared_weighted_golden_koc(golden7):
    """The reference's own -A sketches (golden fq_koc and deep_koc, .a
    abundances) against the golden ref_co sketches."""
    from public_kssd_tpu_torch import formats

    codes, idx = formats.read_combco(f"{golden7}/ref_co", 0)
    sp = jax_index.build_component_index(
        codes, idx, formats.read_co_stat(f"{golden7}/ref_co").infile_num
    )
    for qdir in ("fq_koc", "deep_koc"):
        qc, qidx, ab = formats.read_combco(f"{golden7}/{qdir}", 0, with_abund=True)
        n_qry = formats.read_co_stat(f"{golden7}/{qdir}").infile_num
        want, want_plain = _koc_all(qc, qidx, ab.astype(np.uint32), sp, n_qry)
        assert want_plain.sum() > 0 and (want > want_plain).any()


# ------------------------------------------------- bucket directory


def _directory_want(keys: np.ndarray, bits: int, width: int):
    """np.searchsorted of every bucket boundary b << shift (unsigned),
    shift = max(bit_length(max key) - bits, 0); and that shift."""
    top = int(keys.max()).bit_length() if keys.size else 0
    shift = max(top - bits, 0)
    bounds = [b << shift for b in range(1 << bits)]
    want = np.searchsorted(keys, np.array(bounds, dtype=keys.dtype))
    assert width == 64 or all(b < 1 << width for b in bounds)
    return np.append(want, keys.size).astype(np.int64), shift


def _find_via_directory(keys, directory, shift, codes):
    """The count kernel's lookup, in numpy: one directory read, then a
    lower bound within the bucket; -1 where the code is absent."""
    out = np.full(codes.size, -1, np.int64)
    n_buckets = directory.size - 1
    for i, c in enumerate(codes.tolist()):
        b = c >> shift if shift < 64 else 0
        if b >= n_buckets:
            continue
        lo, hi = int(directory[b]), int(directory[b + 1])
        r = lo + int(np.searchsorted(keys[lo:hi], keys.dtype.type(c)))
        if r < hi and int(keys[r]) == c:
            out[i] = r
    return out


def _dir_keys(case):
    rng = np.random.default_rng(17)
    if case == "28-bit":
        k = rng.integers(0, 1 << 28, 5000, dtype=np.uint64)
        return np.unique(k).astype(np.uint32), None
    if case == "32-bit":
        k = np.unique(rng.integers(0, 1 << 32, 5000, dtype=np.uint64))
        k[-1] = (1 << 32) - 1
        return np.unique(k).astype(np.uint32), None
    if case == "64-bit":
        k = rng.integers(0, 1 << 64, 5000, dtype=np.uint64)
        k[:3] = [0, (1 << 63) - 1, (1 << 64) - 1]
        return np.unique(k), None
    if case == "empty":
        return np.zeros(0, np.uint32), None
    if case == "empty buckets":  # keys in two clusters, 2^10 buckets
        k = np.concatenate([rng.integers(0, 1000, 300),
                            rng.integers(1 << 30, (1 << 30) + 999, 300)])
        return np.unique(k.astype(np.uint64)).astype(np.uint32), 10
    if case == "one bucket":  # every key >= 2^63 and within one top-4-bit bucket
        k = (np.uint64(1) << np.uint64(63)) + rng.integers(0, 1 << 40, 2000, dtype=np.uint64)
        return np.unique(k), 4
    raise ValueError(case)


@pytest.mark.parametrize(
    "case", ["28-bit", "32-bit", "64-bit", "empty", "empty buckets", "one bucket"]
)
def test_bucket_directory_matches_numpy(case):
    """Exact: the directory equals np.searchsorted of every bucket
    boundary, and a lookup through it finds what a search of the whole
    index finds (also for query codes above the largest key)."""
    keys, bits = _dir_keys(case)
    t = count._key_view(keys)
    directory, shift = count.bucket_directory(
        t, int(keys[-1]) if keys.size else 0, bits
    )
    if bits is None:  # the default: 8-16 keys a bucket on average
        bits = (directory.numel() - 1).bit_length() - 1
        assert keys.size == 0 or 8 <= keys.size >> bits < 16
    want, want_shift = _directory_want(keys, bits, keys.dtype.itemsize * 8)
    assert shift == want_shift and directory.dtype == torch.int64
    np.testing.assert_array_equal(directory.numpy(), want)
    if case == "one bucket":
        assert int((np.diff(want) == keys.size).sum()) == 1
    if case == "empty buckets":
        assert (np.diff(want) == 0).sum() > (1 << bits) // 2
    rng = np.random.default_rng(3)
    top = 1 << (keys.dtype.itemsize * 8)
    probe = rng.integers(0, top, 500, dtype=np.uint64).astype(keys.dtype)
    if keys.size:
        probe = np.concatenate([probe, keys[:: max(keys.size // 300, 1)], keys[-1:]])
    got = _find_via_directory(keys, directory.numpy(), shift, probe)
    full = np.searchsorted(keys, probe)
    hit = np.isin(probe, keys)
    np.testing.assert_array_equal(got, np.where(hit, full, -1))
    assert keys.size == 0 or hit.any()


def test_device_index_carries_directory():
    """DeviceIndex.from_arrays builds the directory of its keys."""
    sp, _, _ = _csr(40, 300, 2)
    dev = count.DeviceIndex.from_sparse(sp, CPU)
    directory, shift = count.bucket_directory(dev.uniq, int(sp.uniq_codes[-1]))
    assert torch.equal(dev.dir, directory) and dev.dir_shift == shift
    assert int(dev.dir[-1]) == dev.uniq.numel()


def test_query_segments_and_grouping():
    """Segments of ascending query ids (negative ids first, empty
    queries) equal numpy's; an unsorted order is regrouped stably."""
    qid = np.array([-1, -1, 0, 0, 0, 2, 2, 4], np.int32)
    seg = count.query_segments(torch.from_numpy(qid), 6)
    np.testing.assert_array_equal(
        seg.numpy(), np.searchsorted(qid, np.arange(7), "left")
    )
    np.testing.assert_array_equal(seg.numpy(), [2, 5, 5, 7, 7, 8, 8])
    shuffled = np.array([2, 0, -1, 4, 0, 2, 0, -1], np.int32)
    codes = np.arange(8, dtype=np.int32)
    weights = codes * 10
    q, c, w = count._grouped(torch.from_numpy(shuffled), torch.from_numpy(codes),
                             torch.from_numpy(weights))
    order = np.argsort(shuffled, kind="stable")
    np.testing.assert_array_equal(q.numpy(), shuffled[order])
    np.testing.assert_array_equal(c.numpy(), codes[order])
    np.testing.assert_array_equal(w.numpy(), weights[order])
    q2, c2, w2 = count._grouped(torch.from_numpy(qid), torch.from_numpy(codes), None)
    assert q2.numpy().tolist() == qid.tolist() and c2.numpy().tolist() == list(range(8))
    assert w2 is None


@pytest.mark.parametrize("koc,limit", [(False, 58_112), (True, 19_370)])
def test_count_variant_by_row_size(koc, limit):
    """The shared-memory row variant up to the row that fits 227 KB."""
    assert count.count_variant(limit, koc) == "shared"
    assert count.count_variant(limit + 1, koc) == "global"
    assert count.count_variant(10_000, koc) == "shared"
    assert count.count_variant(65_702, koc) == "global"
