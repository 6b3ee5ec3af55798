"""The port's sketch module (public_kssd_tpu_torch.ops.sketch) against the
JAX package's, on the CPU: same seeded numpy inputs through both, exact
equality (everything is integer arithmetic).

On the CPU the kernel wrapper ``sketch_windows_kept`` runs its plain
PyTorch version; the CUDA kernels themselves are compared with that
version on the card by chip_smoke.py.

Wide geometries (k - l >= 8: 32..60-bit codes, int64 dense output) run
the same functions; at k = 16 the window value fills all 64 bits, which
the plain version must handle sign-safe in int64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from public_kssd_tpu import shufspace as jax_shufspace
from public_kssd_tpu.config import SketchParams as JaxParams
from public_kssd_tpu.ops import pallas_sketch, sketch as jax_sketch
from public_kssd_tpu_torch import kernels, shufspace
from public_kssd_tpu_torch.config import SketchParams
from public_kssd_tpu_torch.ops import sketch, staging
from public_kssd_tpu_torch.seqio import BREAK

torch.set_num_threads(1)

CPU = torch.device("cpu")
GEOMETRIES = [(10, 6, 3), (8, 5, 2), (7, 5, 2), (6, 5, 1)]
# the wide geometries of tests/test_pallas_sketch.py (32, 36, 48, 56 bits)
WIDE_PALLAS = [(10, 6, 2), (12, 6, 3), (15, 7, 3), (15, 7, 1)]


def _params(k, s, l):
    return (
        SketchParams(id=77, half_ctx_len=k, half_subctx_len=s, drlevel=l),
        JaxParams(id=77, half_ctx_len=k, half_subctx_len=s, drlevel=l),
    )


def _shufs(p, mode, seed):
    """(port shuffle space, JAX shuffle space) for one mode: the Feistel
    space, or a seeded Fisher-Yates table as a foreign .shuf holds."""
    if mode == "feistel":
        return (
            shufspace.ComputedShuf(p.id, p.half_subctx_len),
            jax_shufspace.ComputedShuf(p.id, p.half_subctx_len),
        )
    table = np.random.default_rng(seed).permutation(p.dim_shuf_len)
    table = table.astype(np.int32)
    return sketch.as_shuf(table, CPU), table


def _symbols(n, seed, n_breaks=40):
    rng = np.random.default_rng(seed)
    sym = rng.integers(0, 4, size=n).astype(np.uint8)
    sym[rng.integers(0, n, size=n_breaks)] = BREAK
    return sym


def _n_symbols(l):
    """Enough symbols for a few hundred kept windows (1 in 16^min(l, 3))."""
    return 1 << 20 if l >= 3 else 1 << 16


def _jax_dense(sym, jshuf, jp):
    """JAX dense form: one code per window start (uint32 for narrow
    geometries, uint64 for wide ones), all ones where dropped (including
    the last W-1 positions)."""
    table, computed = jax_sketch._norm_shuf(jshuf)
    dr, keep = jax_sketch.sketch_windows(sym, table, jp, computed)
    dr, keep = np.asarray(dr), np.asarray(keep)
    if jp.drtuple_bits > 31:
        sentinel, dtype = jax_sketch.SENTINEL, np.uint64
    else:
        sentinel, dtype = jax_sketch.SENTINEL32, np.uint32
    dense = np.full(sym.size, sentinel, dtype)
    dense[: dr.size] = np.where(keep, dr, sentinel)
    return dense


def _as_unsigned(dense: torch.Tensor) -> np.ndarray:
    """The port's int32/int64 dense codes as the uint32/uint64 bits."""
    a = dense.numpy()
    return a.view(np.uint64 if a.dtype == np.int64 else np.uint32)


def _check_math(k, s, l, mode, n):
    p, jp = _params(k, s, l)
    shuf, jshuf = _shufs(p, mode, seed=k)
    sym = _symbols(n, seed=k)
    table, computed = sketch._norm_shuf(shuf)
    dr, keep = sketch.sketch_windows_math(torch.from_numpy(sym), table, p, computed)
    jtable, jcomputed = jax_sketch._norm_shuf(jshuf)
    jdr, jkeep = jax_sketch.sketch_windows(sym, jtable, jp, jcomputed)
    jdr, jkeep = np.asarray(jdr), np.asarray(jkeep)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    np.testing.assert_array_equal(dr.numpy().view(np.uint64)[jkeep], jdr[jkeep])
    return int(jkeep.sum())


@pytest.mark.parametrize("mode", ["feistel", "table"])
@pytest.mark.parametrize("k,s,l", GEOMETRIES)
def test_sketch_windows_math_matches_jax(k, s, l, mode):
    assert _check_math(k, s, l, mode, 1 << 16) > 0


@pytest.mark.parametrize(
    "k,s,l,mode",
    [(*g, "feistel") for g in WIDE_PALLAS + [(16, 7, 3), (16, 6, 1)]]
    + [(12, 6, 3, "table"), (16, 6, 1, "table")],
)
def test_sketch_windows_math_wide_matches_jax(k, s, l, mode):
    """32..64-bit codes; at k = 16 (W = 32) a signed int64 minimum or an
    arithmetic right shift picks other canonical k-mers than the JAX
    package's uint64 math."""
    assert _check_math(k, s, l, mode, _n_symbols(l)) >= 200


@pytest.mark.parametrize("k,s,l", GEOMETRIES)
def test_dense_math_matches_pallas_interpret(k, s, l):
    """The plain dense form equals the Pallas kernel (interpret mode),
    run as tests/test_pallas_sketch.py runs it."""
    p, jp = _params(k, s, l)
    comp, jcomp = _shufs(p, "feistel", seed=0)
    sym = _symbols(8192, seed=k)
    want = np.asarray(
        pallas_sketch.sketch_windows_pallas(sym, jp, jcomp.seed, interpret=True)
    )
    got = sketch.sketch_windows_dense_math(torch.from_numpy(sym), comp, p)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("k,s,l", WIDE_PALLAS)
def test_wide_dense_math_matches_pallas_interpret(k, s, l):
    """The wide plain dense form (int64, -1 where dropped) equals the wide
    Pallas kernel (two uint32 planes combined to uint64, all ones where
    dropped) in interpret mode."""
    p, jp = _params(k, s, l)
    comp, jcomp = _shufs(p, "feistel", seed=0)
    sym = _symbols(1 << 18 if l >= 3 else 1 << 16, seed=k + 50)
    want = np.asarray(
        pallas_sketch.sketch_windows_pallas_wide(sym, jp, jcomp.seed, interpret=True)
    )
    got = sketch.sketch_windows_dense_math(torch.from_numpy(sym), comp, p)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(_as_unsigned(got), want)
    assert int((got != sketch.SENTINEL).sum()) >= 50


def _jax_kept(words, n_valid, jshuf, jp):
    """The JAX package's kept windows of packed words as (positions,
    uint64 codes): its row compaction (sketch_windows_rows, one row of
    2048 windows per 2048 slots, so nothing overflows) for narrow
    geometries, its dense window math for wide ones; windows past
    n_valid dropped, as its packed callers drop them."""
    W = jp.TL
    table, computed = jax_sketch._norm_shuf(jshuf)
    if jp.drtuple_bits <= 31:
        rows = np.asarray(jax_sketch.sketch_windows_rows(
            jnp.asarray(words.view(np.uint32)), table, jp, B=2048, C=2048,
            computed=computed, packed=True,
        )).ravel()
        rows = rows[rows != -1]
        pos, codes = rows >> 32, (rows & 0xFFFFFFFF).astype(np.uint64)
    else:
        sym = np.asarray(jax_sketch._unpack2(jnp.asarray(words.view(np.uint32))))
        dense = _jax_dense(sym, jshuf, jp)
        pos = np.flatnonzero(dense != jax_sketch.SENTINEL)
        codes = dense[pos]
    keep = pos + W <= n_valid
    return pos[keep].astype(np.int64), codes[keep]


def _check_kept(words_np, n_valid, shuf, jshuf, p, jp):
    """sketch_windows_kept on CPU tensors equals the JAX package's kept
    windows, position for position; returns the survivor count."""
    words = torch.from_numpy(words_np.view(np.int32))
    pos, code = sketch.sketch_windows_kept(words, n_valid, shuf, p)
    assert pos.dtype == torch.int64 and code.dtype == sketch.dense_dtype(p)
    want_pos, want_codes = _jax_kept(words_np, n_valid, jshuf, jp)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    np.testing.assert_array_equal(_as_unsigned(code), want_codes)
    for kern in kernels.ALL:  # CPU: plain version only
        assert kern.launches == 0
    return pos.numel()


def _check_dense_wrapper(k, s, l, mode):
    """The kernel wrapper on CPU tensors: packed words, windows past
    n_valid dropped, no BREAK reaching the device."""
    p, jp = _params(k, s, l)
    shuf, jshuf = _shufs(p, mode, seed=k + 1)
    n = _n_symbols(l) >> 2
    sym = np.random.default_rng(k).integers(0, 4, size=n).astype(np.uint8)
    assert _check_kept(sketch.pack2(sym, n), n - 1000, shuf, jshuf, p, jp) > 0


@pytest.mark.parametrize("mode", ["feistel", "table"])
@pytest.mark.parametrize("k,s,l", [(10, 6, 3), (8, 5, 2), (6, 5, 1)])
def test_dense_wrapper_on_cpu_matches_jax(k, s, l, mode):
    _check_dense_wrapper(k, s, l, mode)


@pytest.mark.parametrize(
    "k,s,l,mode",
    [(12, 6, 3, "feistel"), (12, 6, 3, "table"), (15, 7, 1, "feistel"),
     (16, 6, 1, "feistel"), (16, 6, 1, "table")],
)
def test_wide_dense_wrapper_on_cpu_matches_jax(k, s, l, mode):
    """int64 codes, uint64 bits equal to the JAX package's."""
    assert sketch.dense_dtype(_params(k, s, l)[0]) == torch.int64
    _check_dense_wrapper(k, s, l, mode)


def _kept_at_zero(k, s, l):
    """(port, JAX) params whose Feistel space keeps the inner value 0, so
    that every window of a poly-A run (canonical k-mer 0) is kept: the
    first .shuf id from 0 whose rank of 0 falls below dim_end."""
    p, _ = _params(k, s, l)
    for seed in range(1 << 20):
        rank = jax_shufspace.feistel(np, np.zeros(1, np.uint32), seed, s)
        if int(rank[0]) < p.dim_end:
            return (
                SketchParams(id=seed, half_ctx_len=k, half_subctx_len=s, drlevel=l),
                JaxParams(id=seed, half_ctx_len=k, half_subctx_len=s, drlevel=l),
            )
    raise AssertionError("no seed keeps the inner value 0")


@pytest.mark.parametrize(
    "k,s,l,mode",
    [(10, 6, 3, "feistel"), (8, 5, 2, "table"), (12, 6, 3, "feistel"),
     (16, 6, 1, "table")],
)
def test_sketch_windows_kept_homopolymer_all_kept(k, s, l, mode):
    """A poly-A run of 40,000 bases inside random sequence, in a space
    that keeps the run's k-mer: every window of the run is kept, in
    order, equal to the JAX package's kept windows and to its streaming
    path (sketch_codes_stream)."""
    if mode == "feistel":
        p, jp = _kept_at_zero(k, s, l)
        shuf, jshuf = _shufs(p, mode, seed=0)
    else:
        p, jp = _params(k, s, l)
        table = np.random.default_rng(k).permutation(p.dim_shuf_len).astype(np.int32)
        j = int(np.flatnonzero(table == 0)[0])
        table[[0, j]] = table[[j, 0]]  # rank 0 (kept) for the inner value 0
        shuf, jshuf = sketch.as_shuf(table, CPU), table
    n, run = 1 << 17, (10_000, 50_000)
    sym = np.random.default_rng(k + 7).integers(0, 4, size=n).astype(np.uint8)
    sym[run[0]:run[1]] = 0
    kept = _check_kept(sketch.pack2(sym, n), n, shuf, jshuf, p, jp)
    codes, pos = sketch.sketch_codes_stream(sym, shuf, p, block=1 << 16, device=CPU)
    jcodes, jpos = jax_sketch.sketch_codes_stream(sym, jshuf, jp, block=1 << 16)
    np.testing.assert_array_equal(codes, jcodes)
    np.testing.assert_array_equal(pos, jpos)
    in_run = np.arange(run[0], run[1] - p.TL + 1)
    assert np.isin(in_run, pos).all() and kept >= in_run.size


def test_pack2_unpack2_roundtrip():
    sym = np.random.default_rng(5).integers(0, 4, size=1000).astype(np.uint8)
    words = sketch.pack2(sym, 1024)
    np.testing.assert_array_equal(words, jax_sketch.pack2(sym, 1024))
    back = sketch.unpack2(torch.from_numpy(words.view(np.int32))).numpy()
    np.testing.assert_array_equal(back[:1000], sym)
    assert not back[1000:].any()


@pytest.mark.parametrize("s", [3, 5])
def test_feistel_torch_matches_numpy(s):
    """The int64 Feistel twin over the whole 16^s domain."""
    seed = 0x5EED + s
    inner = np.arange(1 << (4 * s), dtype=np.uint32)
    want = jax_shufspace.feistel(np, inner, seed, s)
    got = shufspace.feistel_torch(torch.from_numpy(inner.astype(np.int64)), seed, s)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize(
    "k,s,l,mode,block",
    [
        (8, 5, 2, "feistel", 65536),
        (10, 6, 3, "table", 65536),
        (10, 6, 3, "feistel", 1 << 24),
        (12, 6, 3, "feistel", 65536),
        (12, 6, 3, "table", 65536),
        (16, 6, 1, "feistel", 65536),
    ],
)
def test_sketch_codes_stream_matches_jax(k, s, l, mode, block):
    """Chunked blocks (overlapping by W-1), breaks and the tail filter;
    the wide cases against the JAX package's top_k compaction path."""
    p, jp = _params(k, s, l)
    shuf, jshuf = _shufs(p, mode, seed=3)
    n = 1 << 20 if (k, l) == (12, 3) else 300_000
    sym = _symbols(n, seed=11, n_breaks=500)
    codes, pos = sketch.sketch_codes_stream(sym, shuf, p, block=block, device=CPU)
    jcodes, jpos = jax_sketch.sketch_codes_stream(sym, jshuf, jp, block=block)
    np.testing.assert_array_equal(codes, jcodes)
    np.testing.assert_array_equal(pos, jpos)
    assert codes.dtype == np.uint64 and codes.size > 0


def test_sketch_codes_stream_homopolymer_burst():
    """A burst of survivors (one kept k-mer tiled over 20 kb): every
    survivor comes back in order (tests/test_pallas_sketch.py:72-95)."""
    p, jp = _params(10, 6, 3)
    comp, jcomp = _shufs(p, "feistel", seed=0)
    rng = np.random.default_rng(3)
    sym = rng.integers(0, 4, size=65536).astype(np.uint8)
    probe = rng.integers(0, 4, size=p.TL).astype(np.uint8)
    tries = 0
    while jax_sketch.sketch_codes_host(probe, jcomp, jp).size == 0:
        tries += 1
        probe = rng.integers(0, 4, size=p.TL).astype(np.uint8)
        assert tries < 100_000
    sym[10_000:30_000] = np.tile(probe, 20_000 // p.TL)[:20_000]
    codes, pos = sketch.sketch_codes_stream(sym, comp, p, device=CPU)
    jcodes, jpos = jax_sketch.sketch_codes_stream(sym, jcomp, jp)
    np.testing.assert_array_equal(codes, jcodes)
    np.testing.assert_array_equal(pos, jpos)
    assert codes.size > jax_sketch._row_cap(jp)


def _check_multi(k, s, l, mode, size):
    """Many streams in one pass, one of them a lazy piece iterator, one
    shorter than a window, across several chunked blocks."""
    p, jp = _params(k, s, l)
    shuf, jshuf = _shufs(p, mode, seed=9)
    rng = np.random.default_rng(21)
    streams = [_symbols(int(n), seed=int(n)) for n in rng.integers(5, size, 12)]
    streams[3] = streams[3][:7]

    def with_iterator():
        out = list(streams)
        big = out[5]
        out[5] = iter([big[:1000], big[1000:]])
        return out

    got = sketch.sketch_codes_multi(
        with_iterator(), shuf, p, block=65536, device=CPU
    )
    want = jax_sketch.sketch_codes_multi(with_iterator(), jshuf, jp, block=65536)
    assert len(got) == len(want) == len(streams)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert sum(g.size for g in got) > 0


@pytest.mark.parametrize("mode", ["feistel", "table"])
def test_sketch_codes_multi_matches_jax(mode):
    _check_multi(8, 5, 2, mode, 60_000)


@pytest.mark.parametrize("mode", ["feistel", "table"])
def test_sketch_codes_multi_wide_matches_jax(mode):
    """32-bit codes at (11,6,3): the JAX package materialises the lazy
    stream and takes its wide top_k path; the port streams it through
    the packed path."""
    _check_multi(11, 6, 3, mode, 300_000)


def _check_reads(k, s, l, n_reads):
    p, jp = _params(k, s, l)
    comp, jcomp = _shufs(p, "feistel", seed=0)
    rng = np.random.default_rng(4)
    reads = [_symbols(int(n), seed=int(n), n_breaks=1)
             for n in rng.integers(1, 400, n_reads)]
    codes, rid = sketch.sketch_codes_reads(reads, comp, p, device=CPU)
    jcodes, jrid = jax_sketch.sketch_codes_reads(reads, jcomp, jp)
    np.testing.assert_array_equal(codes, jcodes)
    np.testing.assert_array_equal(rid, jrid)
    assert codes.size > 0


def test_sketch_codes_reads_matches_jax():
    _check_reads(8, 5, 2, 300)


def test_sketch_codes_reads_wide_matches_jax():
    _check_reads(11, 6, 3, 6000)


# ------------------------------------------- the stream's chunks and edges

def _edge_geometry(geom):
    """(port params, JAX params, port shuf, JAX shuf): narrow int32 codes
    at (8,5,2), wide int64 codes at (12,6,2); both keep 1 window in 256."""
    k, s, l = {"narrow": (8, 5, 2), "wide": (12, 6, 2)}[geom]
    p, jp = _params(k, s, l)
    shuf, jshuf = _shufs(p, "feistel", seed=0)
    return p, jp, shuf, jshuf


def _chunk_starts(n, block, W):
    """Where the stream's chunks start when block <= 4M symbols."""
    return list(range(0, n, block - (W - 1)))


def _edge_case(case, block, W):
    """(kind, data) of one stream edge case: kind "stream" (one array for
    sketch_codes_stream), "multi" (streams for sketch_codes_multi: an
    array, or a list of pieces given as an iterator) or "reads"."""
    rng = np.random.default_rng(block + W)

    def sym(n, n_breaks=0):
        return _symbols(n, seed=int(rng.integers(1 << 30)), n_breaks=n_breaks)

    n = 4 * block
    if case == "piece_larger_than_block":
        return "multi", [[sym(3 * block + 17), sym(2 * block + 5), sym(100)],
                         sym(5 * block, 30)]
    if case == "one_symbol_pieces":
        ones = sym(3000)
        return "multi", [list(ones[:, None]), sym(block + 3),
                         [p for i in range(0, 2000, 7)
                          for p in (ones[i:i + 1], sym(50 + i))]]
    if case == "break_at_chunk_first_symbol":
        a = sym(n)
        a[_chunk_starts(n, block, W)] = BREAK
        return "stream", a
    if case == "break_at_chunk_last_symbol":
        a = sym(n)
        a[[min(s + block - 1, n - 1) for s in _chunk_starts(n, block, W)]] = BREAK
        return "stream", a
    if case == "n_run_straddling_chunk_edge":
        a = sym(n)
        a[block - 40:block + 40] = BREAK
        edge = _chunk_starts(n, block, W)[2] + block  # chunk 2's end
        a[edge - 3:edge + 10] = BREAK
        return "stream", a
    if case == "shorter_than_W":
        return "multi", [sym(W - 1), sym(1), sym(0), sym(2 * block), sym(W - 1),
                         [sym(W - 2), sym(0)]]
    if case == "empty_pieces":
        return "multi", [sym(0), [sym(0), sym(block + 9), sym(0)], [],
                         [sym(0), sym(0)], sym(3 * block), [sym(7), sym(0), sym(block)]]
    if case == "reads":
        return "reads", [sym(int(m), 1) for m in rng.integers(1, 3 * W, 2000)]
    raise AssertionError(case)


EDGE_CASES = ["piece_larger_than_block", "one_symbol_pieces",
              "break_at_chunk_first_symbol", "break_at_chunk_last_symbol",
              "n_run_straddling_chunk_edge", "shorter_than_W", "empty_pieces",
              "reads"]


def _run_edge(kind, data, p, jp, shuf, jshuf, block):
    """The port's and the JAX package's arrays for one edge case."""
    if kind == "stream":
        got = sketch.sketch_codes_stream(data, shuf, p, block=block, device=CPU)
        want = jax_sketch.sketch_codes_stream(data, jshuf, jp, block=block)
        return list(got), list(want)
    if kind == "reads":
        got = sketch.sketch_codes_reads(data, shuf, p, block, device=CPU)
        return list(got), list(jax_sketch.sketch_codes_reads(data, jshuf, jp))

    def streams():
        return [s if isinstance(s, np.ndarray) else iter(s) for s in data]

    got = sketch.sketch_codes_multi(streams(), shuf, p, block=block, device=CPU)
    want = jax_sketch.sketch_codes_multi(streams(), jshuf, jp, block=block)
    assert len(got) == len(want) == len(data)
    return got, want


@pytest.mark.parametrize("block", [1 << 12, 1 << 16])
@pytest.mark.parametrize("geom", ["narrow", "wide"])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_stream_edge_cases_match_jax(case, geom, block):
    """sketch_codes_stream / _multi / _reads across many chunks of a small
    block: pieces larger than a block, one-symbol pieces, a BREAK at each
    chunk's first or last symbol, an N run over a chunk edge, streams
    shorter than a window, empty pieces and streams, reads; the port's
    arrays equal the JAX package's."""
    p, jp, shuf, jshuf = _edge_geometry(geom)
    kind, data = _edge_case(case, block, p.TL)
    got, want = _run_edge(kind, data, p, jp, shuf, jshuf, block)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    if case != "shorter_than_W":
        assert sum(g.size for g in got) > 0


@pytest.mark.parametrize("geom", ["narrow", "wide"])
def test_stream_ignores_garbage_in_the_staging_tail(geom):
    """The staging buffers are reused between streams: filled with
    random bytes (bases and BREAKs) before a stream, they still give the
    JAX package's arrays, whose chunks end mid-buffer."""
    p, jp, shuf, jshuf = _edge_geometry(geom)
    block = 1 << 12
    rng = np.random.default_rng(77)
    with staging.borrow(CPU, block) as st:
        for buf in st.host:
            buf[:] = rng.integers(0, 256, buf.size, dtype=np.uint8)
        mine = st
    streams = [_symbols(int(n), seed=int(n), n_breaks=3)
               for n in rng.integers(10, 3 * block, 25)]
    got = sketch.sketch_codes_multi(iter(streams), shuf, p, block=block, device=CPU)
    with staging.borrow(CPU, block) as st:
        assert st is mine  # the run above used the garbage-filled set
    want = jax_sketch.sketch_codes_multi(iter(streams), jshuf, jp, block=block)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    assert sum(g.size for g in got) > 0


@pytest.mark.parametrize("block,sizes", [
    (1 << 12, [5000, 1, 0, 4096, 3]),
    (1 << 16, [70_000, 200_000, 17]),
    (1 << 24, [5_000_000, 4_194_300, 12_000_000]),
])
def test_assemble_chunks_equal_the_jax_iter_chunks(block, sizes):
    """The staging assembly yields the JAX package's _iter_chunks chunks:
    the same global starts, sizes (the 4M -> 8M -> ... -> block ramp) and
    symbols, one piece copied into as many buffers as it spans."""
    W = 20
    rng = np.random.default_rng(len(sizes))
    pieces = [rng.integers(0, 5, n).astype(np.uint8) for n in sizes]
    want = list(jax_sketch._iter_chunks(iter(pieces), block, W))
    with staging.borrow(CPU, block) as st:
        got = [(g, st.host[slot][:n].copy())
               for g, n, slot in sketch._assemble(iter(pieces), block, W, st)]
    assert [g for g, _ in got] == [g for g, _ in want]
    for (_, a), (_, b) in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,total", [(1, 16), (1000, 1024), (4096, 4096),
                                     (70_001, 1 << 17)])
def test_pack2_torch_matches_pack2(n, total):
    """The device packer (run here on CPU tensors) gives the host
    packer's words: BREAK as code 0, zeros past n."""
    sym = np.random.default_rng(n).integers(0, 5, n).astype(np.uint8)
    got = sketch.pack2_torch(torch.from_numpy(sym), total)
    assert got.dtype == torch.int32 and got.numel() == total // 16
    np.testing.assert_array_equal(got.numpy(), sketch.pack2(sym, total).view(np.int32))
