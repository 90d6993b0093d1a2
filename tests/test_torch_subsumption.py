"""Predicate subsumption in the port's semantic cache, on the CPU.

Ports all of ``tests/test_subsumption_differential.py``: a narrower range
served by refining a cached superset bitmap must be bit-identical to the
naive oracle (``optimized=False``, which never touches the cache) and to
a cold optimized run, and must report a subsumption hit exactly when the
cost model prices refinement below rescanning the column.  Boundaries
(closed intervals, ``lo == hi``, empty and inverted ranges) are where
wrong answers hide, so the distributions include constant blocks with
values on the bounds and bands that leave most queries empty.  The refined
index list also equals a from-scratch selection (``engine.select_range``)
in dtype and order.  Last, ``refine_wins`` gives the reference's verdict
on a grid of (cached_rows, base_rows).
"""
import numpy as np
import pytest
import torch

from _hyp import given, settings, st

from repro.query import CostModel as RCostModel

from repro_torch.columnar import engine
from repro_torch.convert import catalog_from_arrays
from repro_torch.query import (
    CostModel, Executor, Q, SemanticCache, fingerprint, selection_interval,
    subsumption_key,
)

N_ROWS = 2048
DOMAIN = 1000


def _values(seed: int, dist: int, n: int = N_ROWS) -> np.ndarray:
    r = np.random.default_rng(seed)
    if dist == 0:        # uniform over the whole domain
        v = r.integers(0, DOMAIN, size=n)
    elif dist == 1:      # zipf-skewed duplicates, clipped into the domain
        v = np.minimum(r.zipf(1.3, size=n), DOMAIN - 1)
    elif dist == 2:      # constant blocks + values exactly on the bounds
        block = np.repeat(r.integers(0, DOMAIN, size=8), n // 8)
        v = np.concatenate([block, r.integers(0, DOMAIN,
                                              size=n - block.size)])
        v[:: max(n // 64, 1)] = r.integers(0, 4) * (DOMAIN // 4)
    else:                # a narrow band: most predicates select nothing
        v = r.integers(DOMAIN // 2, DOMAIN // 2 + 20, size=n)
    return v.astype(np.int32)


def _arrays(seed: int, dist: int):
    r = np.random.default_rng(seed + 1)
    return {"t": {"v": _values(seed, dist),
                  "w": r.integers(1, 50, size=N_ROWS).astype(np.int32),
                  "k": r.integers(0, 100, size=N_ROWS).astype(np.int32)}}


def _catalog(seed: int, dist: int):
    arrays = _arrays(seed, dist)
    return catalog_from_arrays(arrays, "cpu"), arrays["t"]


def _ex(cat, **kw):
    return Executor(cat, device="cpu", **kw)


def _assert_tables_equal(a, b):
    assert set(a.columns) == set(b.columns)
    for c in a.columns:
        x, y = a.column(c), b.column(c)
        assert x.dtype == y.dtype and torch.equal(x, y), c


def _proj(lo, hi):
    return Q.scan("t").filter("v", lo, hi).project("k", "w")


@pytest.mark.requires_cache
@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2 ** 16), dist=st.integers(0, 3),
       lo_w=st.integers(0, 600), width_w=st.integers(40, 280),
       off=st.integers(0, 200), width_n=st.integers(0, 150))
def test_warm_narrower_range_bit_identical(seed, dist, lo_w, width_w, off,
                                           width_n):
    """The warm path (the narrow range served through a seeded superset)
    equals the oracle and the cold run, and reports a subsumption hit
    exactly when the model prices refinement as the winner."""
    hi_w = lo_w + width_w
    lo_n = min(lo_w + off, hi_w)
    hi_n = min(lo_n + width_n, hi_w)
    cat, _ = _catalog(seed, dist)
    oracle = _ex(cat).execute(_proj(lo_n, hi_n), optimized=False).value
    cold = _ex(cat, cache_bytes=32 << 20).execute(_proj(lo_n, hi_n)).value
    warm_ex = _ex(cat, cache_bytes=32 << 20)
    warm_ex.execute(_proj(lo_w, hi_w))
    seeded = warm_ex.cache.peek(("bitmap", "t", 0, "v", lo_w, hi_w))
    assert seeded is not None, "the wide run must admit its bitmap"
    warm = warm_ex.execute(_proj(lo_n, hi_n)).value
    _assert_tables_equal(oracle, cold)
    _assert_tables_equal(oracle, warm)
    want_hit = warm_ex.cost_model.refine_wins(int(seeded.value.shape[0]),
                                              N_ROWS)
    assert (warm_ex.subsumption_hits == 1) == want_hit


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 2 ** 16), dist=st.integers(0, 3),
       lo=st.integers(0, 900), width=st.integers(0, 300))
def test_cold_optimized_matches_oracle_any_distribution(seed, dist, lo,
                                                        width):
    """Cache-independent (it runs under REPRO_CACHE=0 too): optimized
    execution equals the naive oracle and numpy on every distribution."""
    cat, t = _catalog(seed, dist)
    q = Q.scan("t").filter("v", lo, lo + width).project("k", "w")
    ex = _ex(cat)
    got = ex.execute(q).value
    _assert_tables_equal(got, ex.execute(q, optimized=False).value)
    m = (t["v"] >= lo) & (t["v"] <= lo + width)
    np.testing.assert_array_equal(got.column("w").numpy(), t["w"][m])


# --------------------------------------------------------------------------- #
# boundary semantics

@pytest.mark.requires_cache
def test_closed_interval_boundaries_survive_refinement():
    v = np.asarray([10, 50, 50, 100, 150, 200, 200, 250], np.int32)
    cat = catalog_from_arrays({"t": {"v": v,
                                     "w": np.arange(8, dtype=np.int32),
                                     "k": np.arange(8, dtype=np.int32)}},
                              "cpu")
    ex = _ex(cat, cache_bytes=32 << 20)
    ex.execute(_proj(0, 400))
    closed = ex.execute(_proj(50, 200)).value
    np.testing.assert_array_equal(closed.column("w").numpy(),
                                  [1, 2, 3, 4, 5, 6])
    open_ = ex.execute(_proj(51, 199)).value
    np.testing.assert_array_equal(open_.column("w").numpy(), [3, 4])
    oracle = _ex(cat)
    _assert_tables_equal(closed, oracle.execute(_proj(50, 200),
                                                optimized=False).value)
    _assert_tables_equal(open_, oracle.execute(_proj(51, 199),
                                               optimized=False).value)


@pytest.mark.requires_cache
@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 2 ** 16), dist=st.integers(0, 3),
       point=st.integers(0, 999))
def test_lo_equals_hi_point_query(seed, dist, point):
    cat, t = _catalog(seed, dist)
    ex = _ex(cat, cache_bytes=32 << 20)
    ex.execute(_proj(max(point - 60, 0), point + 60))
    got = ex.execute(_proj(point, point)).value
    _assert_tables_equal(got, _ex(cat).execute(_proj(point, point),
                                               optimized=False).value)
    assert got.num_rows == int((t["v"] == point).sum())


@pytest.mark.requires_cache
def test_empty_and_inverted_ranges():
    r = np.random.default_rng(7)
    v = np.where(np.arange(N_ROWS) % 8 == 0,
                 np.where(np.arange(N_ROWS) % 16 == 0, 420, 680),
                 r.integers(0, 300, size=N_ROWS)).astype(np.int32)
    cat = catalog_from_arrays({"t": {
        "v": v, "w": r.integers(1, 50, size=N_ROWS).astype(np.int32),
        "k": r.integers(0, 100, size=N_ROWS).astype(np.int32)}}, "cpu")
    ex = _ex(cat, cache_bytes=32 << 20)
    ex.execute(_proj(400, 700))                   # superset: both bands
    empty = ex.execute(_proj(500, 600)).value     # the gap: no rows
    assert empty.num_rows == 0
    assert ex.subsumption_hits == 1
    inverted = ex.execute(_proj(650, 450)).value  # lo > hi
    assert inverted.num_rows == 0
    _assert_tables_equal(inverted, _ex(cat).execute(
        _proj(650, 450), optimized=False).value)


# --------------------------------------------------------------------------- #
# the lookup contract

def test_tightest_superset_rule_unit():
    cache = SemanticCache(1 << 20, model=CostModel(1), device="cpu")
    for key, (lo, hi) in {"wide": (0, 500), "mid": (100, 300),
                          "off": (400, 900)}.items():
        cache.put(key, key, kind="bitmap", n_bytes=8, recompute_s=1.0,
                  tables=("t",), interval=("t", "v", 0, lo, hi))
    entry, bounds = cache.lookup_superset("t", "v", 0, 150, 250)
    assert entry.key == "mid" and bounds == (100, 300)
    assert cache.lookup_superset("t", "v", 0, 50, 450)[0].key == "wide"
    assert cache.lookup_superset("t", "v", 0, 450, 600)[0].key == "off"
    assert cache.lookup_superset("t", "v", 1, 150, 250) is None
    assert cache.lookup_superset("t", "w", 0, 150, 250) is None
    assert cache.lookup_superset("t", "v", 0, 0, 901) is None
    assert cache.lookup_superset("t", "v", 0, 9, 3)[0].key == "mid"
    cache.invalidate_table("t")
    assert cache.lookup_superset("t", "v", 0, 150, 250) is None
    assert cache.stats_dict()["semantic_cache_interval_buckets"] == 0


@pytest.mark.requires_cache
def test_executor_refines_from_tightest_superset():
    cat, _ = _catalog(3, 0)
    ex = _ex(cat, cache_bytes=32 << 20)
    ex.execute(_proj(0, 320))
    ex.execute(_proj(100, 300))
    assert ex.subsumption_hits == 1
    before = ex.refine_bytes_streamed
    ex.execute(_proj(150, 250))
    assert ex.subsumption_hits == 2
    mid = ex.cache.peek(("bitmap", "t", 0, "v", 100, 300))
    wide = ex.cache.peek(("bitmap", "t", 0, "v", 0, 320))
    assert mid.hits >= 1
    streamed = ex.refine_bytes_streamed - before
    nbytes = lambda e: e.value.numel() * e.value.element_size()  # noqa: E731
    assert streamed == 3 * nbytes(mid)
    assert streamed < 3 * nbytes(wide)


def test_subsumption_key_family():
    a = _proj(10, 20).node
    b = _proj(400, 900).node
    assert subsumption_key(a) == subsumption_key(b)
    assert fingerprint(a) != fingerprint(b)
    c = Q.scan("t").filter("v", 10, 20).project("k").node
    assert subsumption_key(a) != subsumption_key(c)
    d = Q.scan("t").filter("w", 10, 20).project("k", "w").node
    assert subsumption_key(a) != subsumption_key(d)
    assert subsumption_key(a, {"t": 1}) != subsumption_key(a, {"t": 0})
    assert subsumption_key(Q.scan("t").sum("w").node) is None
    si = selection_interval(a)
    assert (si.table, si.column, si.lo, si.hi) == ("t", "v", 10, 20)
    assert si.contains(12, 18) and si.contains(10, 20)
    assert not si.contains(9, 18) and si.contains(19, 12)


# --------------------------------------------------------------------------- #
# refinement variants and the pricing gate

@pytest.mark.requires_cache
@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 2 ** 16), chunk=st.integers(1, 50))
def test_chunked_refine_variant_bit_identical(seed, chunk):
    """Refinement in bounded slices of the cached index equals the one-
    gather refinement and a from-scratch selection, for every chunk
    size."""
    cat, _ = _catalog(seed, 0)
    ex = _ex(cat, cache_bytes=32 << 20)
    ex.execute(_proj(0, 400))
    entry = ex.cache.peek(("bitmap", "t", 0, "v", 0, 400))
    table = cat.tables["t"]
    col = table.column("v")
    whole = ex._refine_bitmap(col, entry.value, 100, 300)
    sliced = ex._refine_bitmap(col, entry.value, 100, 300,
                               chunk_rows=chunk)
    fresh = engine.select_range(table.place(ex.plans["partitioned"]), "v",
                                100, 300).column("idx")
    for got in (whole, sliced):
        assert got.dtype == fresh.dtype and torch.equal(got, fresh)


@pytest.mark.requires_cache
def test_refinement_writes_nothing_it_was_given():
    """The cached index and the column stay as they were: a refined
    bitmap is a new tensor, never a view written in place."""
    cat, _ = _catalog(21, 0)
    ex = _ex(cat, cache_bytes=32 << 20)
    ex.execute(_proj(0, 300))
    entry = ex.cache.peek(("bitmap", "t", 0, "v", 0, 300))
    before = entry.value.clone()
    col = cat.tables["t"].column("v")
    col_before = col.clone()
    out = ex._refine_bitmap(col, entry.value, 50, 200, chunk_rows=7)
    out[:] = -1
    assert torch.equal(entry.value, before) and torch.equal(col, col_before)


@pytest.mark.requires_cache
def test_capacity_posture_refines_in_chunks():
    cat, _ = _catalog(11, 0)
    # the port spills when a query's whole working set is over the device
    # budget (the reference: when one column is), so the budget holds the
    # three columns the query reads and the selection runs eagerly
    cap = 3 * N_ROWS * 4
    ex = _ex(cat, cache_bytes=32 << 20, placement_capacity_bytes=cap)
    assert ex._refine_chunk() == cap // 8
    ex.execute(_proj(0, 320))
    got = ex.execute(_proj(100, 300)).value
    assert ex.subsumption_hits == 1
    _assert_tables_equal(got, _ex(cat).execute(_proj(100, 300),
                                               optimized=False).value)


@pytest.mark.requires_cache
def test_refine_only_when_priced_cheaper():
    cat, _ = _catalog(13, 0)
    ex = _ex(cat, cache_bytes=32 << 20)
    ex.execute(_proj(0, DOMAIN))
    entry = ex.cache.peek(("bitmap", "t", 0, "v", 0, DOMAIN))
    assert not ex.cost_model.refine_wins(int(entry.value.shape[0]), N_ROWS)
    got = ex.execute(_proj(100, 300)).value
    assert ex.subsumption_hits == 0
    _assert_tables_equal(got, _ex(cat).execute(_proj(100, 300),
                                               optimized=False).value)


@pytest.mark.requires_cache
def test_aggregate_routed_onto_warmed_bitmap():
    cat, t = _catalog(17, 0)
    ex = _ex(cat, cache_bytes=32 << 20)
    q = Q.scan("t").filter("v", 120, 280).sum("w")
    fused = ex.execute(q).value
    assert ex.subsumption_hits == 0
    ex.execute(_proj(100, 300))
    q2 = Q.scan("t").filter("v", 130, 270).sum("w")
    routed = ex.execute(q2).value
    assert ex.subsumption_hits == 1 and ex.refine_routed == 1
    oracle = _ex(cat)
    assert routed == oracle.execute(q2, optimized=False).value
    assert fused == oracle.execute(q, optimized=False).value
    m = (t["v"] >= 130) & (t["v"] <= 270)
    assert routed == int(t["w"][m].sum())


@pytest.mark.requires_cache
def test_mutation_unreaches_supersets():
    cat, _ = _catalog(19, 0)
    ex = _ex(cat, cache_bytes=32 << 20)
    ex.execute(_proj(0, 400))
    cat.update_column("t", "v", _values(999, 0))
    got = ex.execute(_proj(100, 300)).value
    assert ex.subsumption_hits == 0
    _assert_tables_equal(got, _ex(cat).execute(_proj(100, 300)).value)
    assert ex.cache.lookup_superset("t", "v", 0, 100, 300) is None


# --------------------------------------------------------------------------- #
# the pricing verdict against the reference's

@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_refine_wins_equals_the_reference_on_a_grid(impl):
    """Both models reduce to 3 * cached < base, whatever the impl label
    or the calibrated efficiency: the same verdict on every pair,
    including the ones either side of the boundary."""
    port = CostModel(1, impl=impl)
    ref = RCostModel(1, calibration=None)
    bases = [1, 2, 3, 7, 100, 1023, 2048, 4096, 59_986_214]
    for base in bases:
        cands = {0, 1, base // 3 - 1, base // 3, base // 3 + 1,
                 (base + 2) // 3, base // 2, base, base * 2}
        for cached in sorted(c for c in cands if c >= 0):
            want = ref.refine_wins(cached, base)
            assert port.refine_wins(cached, base) == want, (cached, base)
            assert want == (3 * cached < max(base, 1))
    port.apply_calibration({"backends": {impl: {"stream_eff": 0.07,
                                                "call_overhead_s": 3e-5}}})
    for base in bases:
        for cached in (base // 3 - 1, base // 3 + 1):
            if cached >= 0:
                assert port.refine_wins(cached, base) \
                    == ref.refine_wins(cached, base)
