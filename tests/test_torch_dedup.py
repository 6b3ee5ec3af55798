"""The port's stage I host path around the sketch kernel, against the JAX
package and the pure-Python oracles, exactly:

* compat-order dedup (``hashdedup.dedup_slot_order`` and
  ``dedup_counts_slot_order``), which runs the sparse twins of
  ``native/kssd_dedup.c`` over a map of the filled slots only: from one
  distinct code to a table at its load limit, the crowded-table error,
  calls in a row and on several threads at once;
* the Feistel detection of a ``.shuf`` table on a device
  (``shufspace._matches_feistel_torch``), here on the CPU at s = 4."""

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from public_kssd_tpu import hashdedup as jax_hashdedup
from public_kssd_tpu import shufspace as jax_shufspace
from public_kssd_tpu_torch import formats, hashdedup, native, shufspace
from public_kssd_tpu_torch.config import SketchParams

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    native.get_lib() is None, reason="native toolchain unavailable"
)

# (k, l): hashsize 2,097,143 (L3K10), 536,870,909 (L3K12) and 509, a
# small prime whose table fills to its 0.6 load limit with long probe
# chains
GEOMS = {"L3K10": (10, 3), "L3K12": (12, 3), "prime509": (7, 3)}


def _params(geom: str) -> SketchParams:
    k, l = GEOMS[geom]
    return SketchParams.create(k=k, drlevel=l, id=7)


def _stream(params: SketchParams, distinct: int, seed: int) -> np.ndarray:
    """``distinct`` different nonzero codes of the geometry's width, a third
    of them repeated up to three times, and a few zeros (the reference's
    code-0 quirk), shuffled."""
    rng = np.random.default_rng(seed)
    top = 1 << params.drtuple_bits
    codes = np.unique(rng.integers(1, top, size=2 * distinct + 64, dtype=np.uint64))
    codes = rng.permutation(codes)[:distinct]
    assert codes.size == distinct
    reps = [codes, np.zeros(3, np.uint64)]
    for r in (1, 2, 3):
        reps.append(codes[rng.random(distinct) < 1 / 3 / r])
    return rng.permutation(np.concatenate(reps))


def _distinct(params: SketchParams, fill: str) -> int:
    """Distinct nonzero codes (= filled slots) of a fill level: one; a
    genome's ~1,500 at L3K10 and L3K12 (7 in 509 slots); 100,000 at L3K10
    (reads: 4.8% of the table); the small table at its load limit, where
    the stream's 3 zeros count too."""
    return {"one": 1, "genome": min(1500, params.hashsize // 64),
            "crowd": 100_000, "full": params.hashlimit - 3}[fill]


CASES = [
    ("L3K10", "one"), ("L3K10", "genome"), ("L3K10", "crowd"),
    ("L3K12", "genome"),
    ("prime509", "one"), ("prime509", "genome"), ("prime509", "full"),
]


@pytest.mark.parametrize("uniq", [False, True])
@pytest.mark.parametrize("geom,fill", CASES)
def test_slot_order_equals_jax_and_oracle(geom, fill, uniq):
    params = _params(geom)
    distinct = _distinct(params, fill)
    codes = _stream(params, distinct, seed=len(geom) + distinct)
    got = hashdedup.dedup_slot_order(codes, params, uniq=uniq)
    want = jax_hashdedup.dedup_slot_order(codes, params, uniq=uniq)
    assert got.dtype == want.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    if geom != "L3K12" or not uniq:  # the oracle holds hashsize bools a mask
        np.testing.assert_array_equal(
            got, hashdedup.dedup_slot_order_py(codes, params, uniq=uniq))


@pytest.mark.parametrize("count_bits,min_occ", [(4, 1), (4, 2), (16, 1)])
@pytest.mark.parametrize("geom,fill", [c for c in CASES if c[1] != "one"])
def test_counts_equal_jax(geom, fill, count_bits, min_occ):
    params = _params(geom)
    distinct = _distinct(params, fill)  # code 0 fills a slot here
    codes = _stream(params, distinct, seed=3 + distinct)
    got = hashdedup.dedup_counts_slot_order(codes, params, count_bits, min_occ)
    want = jax_hashdedup.dedup_counts_slot_order(codes, params, count_bits, min_occ)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    if geom != "L3K12":  # the oracle holds hashsize int64 keys
        for g, w in zip(got, hashdedup.dedup_counts_slot_order_py(
                codes, params, count_bits, min_occ)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("zeros", [False, True])
def test_crowded_error_in_both_packages(zeros):
    """hashlimit + 1 distinct codes (or, with ``zeros``, as many code-0
    occurrences after hashlimit - 5 codes) raise in both packages."""
    params = _params("prime509")
    limit = params.hashlimit
    ok = _stream(params, limit - 5, seed=11)
    ok = np.unique(ok[ok != 0])  # limit - 5 distinct, no zeros
    extra = (np.zeros(6, np.uint64) if zeros
             else np.setdiff1d(np.arange(1, 2 * limit, dtype=np.uint64), ok)[:6])
    crowded = np.concatenate([ok, extra])
    for pkg in (hashdedup, jax_hashdedup):
        with pytest.raises(pkg.HashCrowdedError):
            pkg.dedup_slot_order(crowded, params)
        np.testing.assert_array_equal(  # one fewer fits
            pkg.dedup_slot_order(crowded[:-1], params),
            hashdedup.dedup_slot_order_py(crowded[:-1], params))


@pytest.mark.parametrize("geom", ["L3K10", "prime509"])
def test_calls_in_a_row_equal_fresh_calls(geom):
    """A run of calls with crowded ones between them gives what fresh
    calls give: no call leaves state for the next."""
    params = _params(geom)
    streams = [_stream(params, d, seed=d) for d in (5, 40, 200, 7, 1)]
    crowded = np.arange(1, params.hashlimit + 2, dtype=np.uint64) * 3
    got = []
    for i, codes in enumerate(streams):
        got.append(hashdedup.dedup_slot_order(codes, params, uniq=i % 2 == 1))
        with pytest.raises(hashdedup.HashCrowdedError):
            hashdedup.dedup_slot_order(crowded, params)
        got.append(hashdedup.dedup_counts_slot_order(codes, params, 16)[0])
    for i, codes in enumerate(streams):
        np.testing.assert_array_equal(
            got[2 * i], hashdedup.dedup_slot_order_py(codes, params, uniq=i % 2 == 1))
        np.testing.assert_array_equal(
            got[2 * i + 1], hashdedup.dedup_counts_slot_order_py(codes, params, 16)[0])


def test_threads_at_once():
    """Four threads deduping at once, each many times, give the oracle's
    codes: the native calls share no state."""
    params = _params("L3K10")
    streams = [_stream(params, 150 + i, seed=i) for i in range(4)]
    want = [hashdedup.dedup_slot_order_py(codes, params) for codes in streams]
    barrier = threading.Barrier(4)

    def run(i):
        barrier.wait(timeout=60)  # four threads, all in flight together
        return [hashdedup.dedup_slot_order(streams[i], params) for _ in range(50)]

    with ThreadPoolExecutor(4) as ex:
        results = list(ex.map(run, range(4), timeout=120))
    for w, runs in zip(want, results):
        for got in runs:
            np.testing.assert_array_equal(got, w)


def test_empty_stream():
    params = _params("L3K10")
    empty = np.zeros(0, np.uint64)
    assert hashdedup.dedup_slot_order(empty, params).size == 0
    codes, counts = hashdedup.dedup_counts_slot_order(empty, params, 16)
    assert codes.size == counts.size == 0


# --- Feistel detection on a device -----------------------------------------

S4 = SketchParams.create(k=6, drlevel=1, subk=4, id=4242)  # 16^4 entries
CPU = torch.device("cpu")


def _swapped(table: np.ndarray) -> np.ndarray:
    """Two entries swapped between the spot-check's probes (every
    n // 64-th index)."""
    out = table.copy()
    out[[1, 2]] = out[[2, 1]]
    return out


TABLES = {
    "feistel": lambda: shufspace.make_feistel_dim(S4),
    "swapped": lambda: _swapped(shufspace.make_feistel_dim(S4)),
    "shuffled": lambda: formats.make_shuffled_dim(S4, seed=5),
}


@pytest.mark.parametrize("name", sorted(TABLES))
def test_torch_comparison_gives_numpys_verdict(name):
    table = TABLES[name]()
    cand = shufspace.ComputedShuf(S4.id, S4.half_subctx_len)
    numpy_verdict = np.array_equal(table, shufspace.make_feistel_dim(S4))
    assert numpy_verdict == (name == "feistel")
    assert shufspace._matches_feistel_torch(table, cand, CPU) == numpy_verdict
    # detect on the CPU keeps the numpy comparison: the JAX package's verdict
    want = jax_shufspace.detect(S4, table)
    for device in (None, CPU):
        assert shufspace.detect(S4, table, device) == want
    assert (want is not None) == numpy_verdict


@pytest.mark.parametrize("name", sorted(TABLES))
def test_detect_sends_the_full_check_to_a_card(name, monkeypatch):
    """On a CUDA device the full comparison is _matches_feistel_torch's,
    reached only past the spot-check; a table the probes reject never
    gets there."""
    table = TABLES[name]()
    calls = []
    compare = shufspace._matches_feistel_torch

    def on_card(tab, cand, device):
        calls.append(device)
        return compare(tab, cand, CPU)

    monkeypatch.setattr(shufspace, "_matches_feistel_torch", on_card)
    cuda = torch.device("cuda", 0)
    got = shufspace.detect(S4, table, cuda)
    assert got == jax_shufspace.detect(S4, table)
    assert calls == ([] if name == "shuffled" else [cuda])


def test_torch_comparison_refuses_a_table_of_another_size():
    cand = shufspace.ComputedShuf(S4.id, S4.half_subctx_len)
    table = shufspace.make_feistel_dim(S4)
    assert not shufspace._matches_feistel_torch(table[:-1], cand, CPU)
    assert not shufspace._matches_feistel_torch(
        np.concatenate([table, table[:1]]), cand, CPU)
