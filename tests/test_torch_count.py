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
