"""The port's semantic cache against the JAX reference, on the CPU.

Ports the executor- and cache-level cases of ``tests/test_semantic_cache.py``
(fingerprints, result reuse, invalidation, priced eviction, subplan
reuse, the prefetch thread's bit-identity), all of ``tests/test_cache_concurrency.py``, the executor cases of
``tests/test_shared_cache.py`` and the model-cache cases of
``tests/test_glm_query.py``; the server cases wait for the port's
``serve.py``.  Then parity: one seeded sequence of cache operations gives
the port's and the reference's ``SemanticCache`` equal ``stats_dict()``
after every operation, and executor query sequences (an SSB-shaped scan-
filter-join-sum, a subsumption ladder, TrainGLM then ScoreGLM, a mutation
in the middle) give the reference's values, result hits and hit
counters.  Cached results equal cache-disabled ones bit for bit in every
mode, spilled and traced too, GLM weights and scores included.  Every
value served from the host tier goes through the cache's ``_to_device``.
Last, the stale-state fault: after a mutation no placement, build, plan
or cache entry of the old table version stays behind.  The reference runs
on an Auto-axis mesh.
"""
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from repro.columnar.table import Table as RTable
from repro.core.sgd_glm import HyperParams as RHyperParams
from repro.query import Catalog as RCatalog, CostModel as RCostModel
from repro.query import Executor as RExecutor, Q as RQ
from repro.query import SemanticCache as RSemanticCache

from repro_torch.convert import catalog_from_arrays
from repro_torch.query import (
    CostModel, Executor, HyperParams, Q, SemanticCache, Telemetry,
    TierBudgets, common_subplans, fingerprint, optimize,
)
from repro_torch.query import cache as cache_mod
from repro_torch.query.cost import CHANNEL_KEYS

MODES = ("batch", "stream", "eager")
FEATS = ("f0", "f1", "f2")
GRID = (HyperParams(0.1, 0.0), HyperParams(0.05, 0.01))
R_GRID = tuple(RHyperParams(g.lr, g.l2) for g in GRID)
W_TOL = dict(rtol=1e-5, atol=1e-6)      # test_torch_glm_query's tolerance


def _auto_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()).reshape(1, -1),
                             ("data", "model"))


def _arrays(seed=0, n=4096, n_small=512, vmax=100):
    r = np.random.default_rng(seed)
    return {
        "big": {"k": r.integers(0, 1000, size=n).astype(np.int32),
                "v": r.integers(0, vmax, size=n).astype(np.int32),
                "w": r.integers(1, 50, size=n).astype(np.int32)},
        "small": {"k": np.asarray(r.choice(1000, size=n_small,
                                           replace=False), np.int32),
                  "x": r.integers(0, 9, size=n_small).astype(np.int32)},
    }


def _cat(arrays):
    return catalog_from_arrays(arrays, "cpu")


def _ex(cat, **kw):
    return Executor(cat, device="cpu", **kw)


def _ref_ex(arrays, **kw):
    return RExecutor(RCatalog.from_tables(*(RTable.from_arrays(t, c)
                                            for t, c in arrays.items())),
                     mesh=_auto_mesh(),
                     cost_model=RCostModel(1, calibration=None), **kw)


def _join_sum(Qc=Q, lo=30, hi=49):
    return (Qc.scan("big").join(Qc.scan("small"), on="k")
              .filter("v", lo, hi).sum("w"))


def _join_oracle(arrays, lo, hi, w=None):
    b = arrays["big"]
    w = b["w"] if w is None else w
    m = (b["v"] >= lo) & (b["v"] <= hi) & np.isin(b["k"],
                                                  arrays["small"]["k"])
    return int(w[m].astype(np.int64).sum())


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_values_equal(a, b):
    """Bit-for-bit equality of two results of the port: scalars, tensors,
    tuples of tensors (GLM weights, losses) or Tables."""
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_values_equal(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)
    elif hasattr(a, "columns"):
        assert set(a.columns) == set(b.columns)
        for c in a.columns:
            _assert_values_equal(a.column(c), b.column(c))
    else:
        assert type(a) is type(b) and a == b, (a, b)


# --------------------------------------------------------------------------- #
# fingerprints (test_semantic_cache.py:41-106)

def test_equal_spellings_collide():
    a = Q.scan("big").filter("v", 0, 10).filter("w", 1, 5).sum("k").node
    b = Q.scan("big").filter("w", 1, 5).filter("v", 0, 10).sum("k").node
    assert fingerprint(a) == fingerprint(b)
    ja = (Q.scan("big", ["k", "v"]).join(Q.scan("small", ["k"]), on="k")
           .sum("v").node)
    jb = (Q.scan("small", ["k"]).join(Q.scan("big", ["k", "v"]), on="k")
           .sum("v").node)
    assert fingerprint(ja) == fingerprint(jb)


def test_join_swap_with_overlapping_columns_never_collides():
    arrays = {"a": {"k": np.arange(8, dtype=np.int32),
                    "x": np.full(8, 1, np.int32)},
              "b": {"k": np.arange(8, dtype=np.int32),
                    "x": np.full(8, 100, np.int32)}}
    cat = _cat(arrays)
    q1 = Q.scan("a").join(Q.scan("b"), on="k").sum("x")
    q2 = Q.scan("b").join(Q.scan("a"), on="k").sum("x")
    ex = _ex(cat, cache_bytes=32 << 20)
    v1 = ex.execute(q1).value
    r2 = ex.execute(q2)
    plain = _ex(cat)
    assert v1 == plain.execute(q1).value
    assert r2.value == plain.execute(q2).value
    assert v1 != r2.value
    assert not r2.result_cache_hit
    assert ex.fingerprint_of(q1.node) != ex.fingerprint_of(q2.node)
    ia = Q.scan("a").join(Q.scan("b"), on="k").count("k").node
    ib = Q.scan("b").join(Q.scan("a"), on="k").count("k").node
    assert fingerprint(ia) != fingerprint(ib)


def test_different_semantics_never_collide():
    pa = Q.scan("big").join(Q.scan("small"), on="k").project("k", "v").node
    pb = Q.scan("small").join(Q.scan("big"), on="k").project("k", "v").node
    assert fingerprint(pa) != fingerprint(pb)
    f = Q.scan("big").filter("v", 10, 20).sum("w")
    for other in (Q.scan("big").filter("v", 20, 10).sum("w"),
                  Q.scan("big").filter("v", 10, 21).sum("w"),
                  Q.scan("big").filter("w", 10, 20).sum("w"),
                  Q.scan("big").filter("v", 10, 20).count("w"),
                  Q.scan("big").filter("v", 10, 20).mean("w")):
        assert fingerprint(f.node) != fingerprint(other.node)


def test_fingerprint_embeds_table_versions():
    n = Q.scan("big").filter("v", 0, 10).sum("w").node
    assert fingerprint(n, {"big": 0}) != fingerprint(n, {"big": 1})
    assert fingerprint(n, {"big": 0}) == fingerprint(n, {"big": 0,
                                                         "other": 7})


def test_executor_fingerprints_equal_the_reference():
    """The result-cache key of every query equals the reference's, so a
    hit sequence can only differ through the paths, never the keys."""
    arrays = _arrays(1)
    ref, port = _ref_ex(arrays), _ex(_cat(arrays))
    for Qp, Qr in ((_join_sum(Q), _join_sum(RQ)),
                   (Q.scan("big").filter("v", 5, 25).project("k", "w"),
                    RQ.scan("big").filter("v", 5, 25).project("k", "w"))):
        assert port.fingerprint_of(Qp.node) == ref.fingerprint_of(Qr.node)


# --------------------------------------------------------------------------- #
# result reuse and invalidation (test_semantic_cache.py:118-184)

@pytest.mark.requires_cache
def test_result_cache_hit_skips_execution():
    cat = _cat(_arrays())
    ex = _ex(cat, cache_bytes=32 << 20)
    q = _join_sum()
    r1 = ex.execute(q)
    assert not r1.result_cache_hit
    r2 = ex.execute(q)
    assert r2.result_cache_hit and r2.value == r1.value
    r3 = ex.execute(q, mode="stream")
    assert r3.result_cache_hit and r3.value == r1.value
    assert ex.result_hits == 2


@pytest.mark.requires_cache
def test_mutation_invalidates_differential():
    arrays = _arrays()
    cat = _cat(arrays)
    ex = _ex(cat, cache_bytes=32 << 20)
    q = _join_sum()
    stale = ex.execute(q).value
    assert ex.execute(q).result_cache_hit
    new_w = np.random.default_rng(5).integers(
        51, 99, size=4096).astype(np.int32)
    cat.update_column("big", "w", new_w)
    res = ex.execute(q)
    assert not res.result_cache_hit
    plain = _ex(cat).execute(q).value
    want = _join_oracle(arrays, 30, 49, w=new_w)
    assert res.value == plain == want
    assert res.value != stale
    assert ex.cache.invalidated > 0


def test_mutation_invalidates_join_build():
    arrays = _arrays()
    cat = _cat(arrays)
    ex = _ex(cat, cache_bytes=32 << 20)
    q = _join_sum(lo=0, hi=99)
    ex.execute(q)
    cat.update_column("small", "k", np.asarray(
        np.random.default_rng(6).choice(1000, size=512, replace=False),
        np.int32))
    got = ex.execute(q)
    assert not got.result_cache_hit
    assert got.value == _ex(cat).execute(q).value


def test_stale_entries_unreachable_even_without_sweep():
    cat = _cat(_arrays())
    ex = _ex(cat, cache_bytes=32 << 20)
    q = Q.scan("big").filter("v", 10, 60).sum("w")
    ex.execute(q)
    fp_before = ex.fingerprint_of(q.node)
    # a direct mutation of the catalog's table, bypassing the catalog
    cat.tables["big"].update_column(
        "w", np.random.default_rng(7).integers(1, 50, 4096).astype(np.int32))
    assert ex.fingerprint_of(q.node) != fp_before


# --------------------------------------------------------------------------- #
# priced admission and eviction (test_semantic_cache.py:189-240)

def test_eviction_respects_budget_and_value_density():
    cache = SemanticCache(budget_bytes=1000, model=CostModel(4),
                          device="cpu")
    assert cache.put("gold", "g", kind="result", n_bytes=200,
                     recompute_s=1.0, tables=("t",))
    assert cache.put("bulk", "b", kind="subplan", n_bytes=800,
                     recompute_s=1e-6, tables=("t",))
    assert cache.used_bytes == 1000
    assert cache.put("mid", "m", kind="result", n_bytes=500,
                     recompute_s=0.1, tables=("t",))
    assert "gold" in cache and "mid" in cache and "bulk" not in cache
    assert cache.used_bytes <= 1000
    assert cache.evicted == 1
    assert not cache.put("junk", "j", kind="subplan", n_bytes=900,
                         recompute_s=1e-9, tables=("t",))
    assert "junk" not in cache and cache.rejected >= 1
    assert not cache.put("huge", "h", kind="result", n_bytes=2000,
                         recompute_s=9.0, tables=("t",))
    assert "gold" in cache and "mid" in cache


def test_invalidate_table_sweeps_dependents():
    cache = SemanticCache(1 << 20, model=CostModel(1), device="cpu")
    cache.put("a", 1, kind="result", n_bytes=10, recompute_s=1.0,
              tables=("big", "small"))
    cache.put("b", 2, kind="result", n_bytes=10, recompute_s=1.0,
              tables=("small",))
    cache.put("c", 3, kind="result", n_bytes=10, recompute_s=1.0,
              tables=("other",))
    assert cache.invalidate_table("small") == 2
    assert "c" in cache and cache.used_bytes == 10


@pytest.mark.requires_cache
def test_executor_under_tight_budget_stays_correct():
    arrays = _arrays()
    ex = _ex(_cat(arrays), cache_bytes=256)
    v, w = arrays["big"]["v"], arrays["big"]["w"]
    for lo in (0, 10, 20, 30, 40, 0, 10, 20):
        got = ex.execute(Q.scan("big").filter("v", lo, lo + 9)
                         .sum("w")).value
        m = (v >= lo) & (v <= lo + 9)
        assert got == int(w[m].sum())
    assert ex.cache.used_bytes <= 256


# --------------------------------------------------------------------------- #
# subplan reuse (test_semantic_cache.py:246-278)

def test_common_subplans_extraction():
    cat = _cat(_arrays())
    qs = [(Q.scan("big").join(Q.scan("small"), on="k")
            .filter("v", 10, 60).sum("w")).node,
          (Q.scan("big").join(Q.scan("small"), on="k")
            .filter("v", 10, 60).mean("w")).node]
    shared = common_subplans([optimize(n, cat.stats) for n in qs])
    assert shared and all(c >= 2 for c in shared.values())
    assert not common_subplans([
        Q.scan("big").filter("v", 0, 9).sum("w").node,
        Q.scan("big").filter("w", 1, 5).count("k").node])


@pytest.mark.requires_cache
def test_eager_subplan_reuse_across_different_roots():
    ex = _ex(_cat(_arrays()), cache_bytes=64 << 20)
    q1 = (Q.scan("big").join(Q.scan("small"), on="k")
           .filter("v", 0, 50).project("k", "w"))
    q2 = (Q.scan("big").join(Q.scan("small"), on="k")
           .filter("v", 0, 50).project("k", "w", "x"))
    t1 = ex.execute(q1).value
    before = ex.subplan_hits
    t2 = ex.execute(q2).value
    assert ex.subplan_hits > before
    assert set(t2.columns) == {"k", "w", "x"}
    assert torch.equal(t1.column("w"), t2.column("w"))


def test_overlap_thread_bit_identical():
    """test_semantic_cache.py:389: the prefetch thread and the one-thread
    loop fold morsels in the same order, so streamed results are equal
    at every morsel size."""
    cat = _cat(_arrays())
    q = _join_sum(lo=10, hi=60)
    on = _ex(cat, overlap_transfers=True)
    off = _ex(cat, overlap_transfers=False)
    for mr in (256, 1000, 4096):
        assert on.execute(q, mode="stream", morsel_rows=mr).value \
            == off.execute(q, mode="stream", morsel_rows=mr).value


# --------------------------------------------------------------------------- #
# the shared cache (test_shared_cache.py:57, :70, :88)

def _shared_arrays():
    return _arrays(0, vmax=1000)


def _cache_consistent(cache):
    with cache._lock:
        assert cache.used_bytes == sum(e.n_bytes
                                       for e in cache._entries.values())
        assert cache.used_bytes <= cache.budget_bytes
        for bucket in cache._intervals.values():
            for key in bucket:
                assert key in cache._entries


@pytest.mark.requires_cache
def test_cross_executor_result_hit():
    cat = _cat(_shared_arrays())
    shared = SemanticCache(32 << 20, model=CostModel(1))
    a = _ex(cat, semantic_cache=shared)
    b = _ex(cat, semantic_cache=shared)
    assert shared.device == torch.device("cpu")     # the installer's
    q = _join_sum()
    warm = a.execute(q)
    assert not warm.result_cache_hit
    hit = b.execute(q)
    assert hit.result_cache_hit and hit.value == warm.value
    assert b.result_hits == 1 and shared.hits >= 1


@pytest.mark.requires_cache
def test_cross_executor_subsumption_refinement():
    cat = _cat(_shared_arrays())
    shared = SemanticCache(32 << 20, model=CostModel(1), device="cpu")
    a = _ex(cat, semantic_cache=shared)
    b = _ex(cat, semantic_cache=shared)
    wide = Q.scan("big").filter("v", 0, 300).project("k", "w")
    narrow = Q.scan("big").filter("v", 100, 250).project("k", "w")
    a.execute(wide)
    got = b.execute(narrow).value
    assert b.subsumption_hits == 1 and a.subsumption_hits == 0
    _assert_values_equal(got, _ex(cat).execute(narrow,
                                               optimized=False).value)


@pytest.mark.requires_cache
def test_mutation_by_one_executor_invalidates_everyone():
    arrays = _shared_arrays()
    cat = _cat(arrays)
    shared = SemanticCache(32 << 20, model=CostModel(1), device="cpu")
    a = _ex(cat, semantic_cache=shared)
    b = _ex(cat, semantic_cache=shared)
    q = _join_sum()
    wide = Q.scan("big").filter("v", 0, 300).project("k", "w")
    stale_val = a.execute(q).value
    a.execute(wide)
    assert b.execute(q).result_cache_hit
    cat.update_column("big", "w", np.random.default_rng(99).integers(
        51, 99, size=4096).astype(np.int32))
    res_a = a.execute(q)
    assert not res_a.result_cache_hit
    plain = _ex(cat).execute(q).value
    assert res_a.value == plain != stale_val
    assert b.execute(q).value == plain
    assert shared.invalidated > 0
    assert shared.lookup_superset("big", "v", 0, 100, 250) is None
    _cache_consistent(shared)


# --------------------------------------------------------------------------- #
# cached models (test_glm_query.py:142, :160, :173, :190)

def _glm_arrays(m=512, seed=0):
    r = np.random.default_rng(seed)
    a = r.normal(size=(m, len(FEATS))).astype(np.float32)
    y = (1.0 / (1.0 + np.exp(-(a @ np.array([1.0, -2.0, 0.5]))))
         > 0.5).astype(np.float32)
    cols = {f: a[:, i] for i, f in enumerate(FEATS)}
    cols["y"] = y
    cols["k"] = np.arange(m, dtype=np.int32)
    return {"train": cols}


def train_q(Qc=Q, grid=GRID, epochs=3):
    return Qc.scan("train").train_glm(list(FEATS), "y", list(grid),
                                      epochs=epochs)


@pytest.mark.requires_cache
def test_score_after_train_hits_cached_model():
    arrays = _glm_arrays()
    ex = _ex(_cat(arrays), cache_bytes=1 << 24)
    q = train_q()
    xs, losses = ex.execute(q).value
    r = ex.execute(Q.scan("train").score_glm(q))
    assert ex.model_hits == 1
    x = xs[int(torch.argmin(losses))].numpy().astype(np.float64)
    feats = np.stack([arrays["train"][f] for f in FEATS], axis=1)
    np.testing.assert_allclose(r.value.column("score").numpy(),
                               1.0 / (1.0 + np.exp(-(feats @ x))),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.requires_cache
def test_score_without_train_trains_then_serves():
    ex = _ex(_cat(_glm_arrays()), cache_bytes=1 << 24)
    r1 = ex.execute(Q.scan("train").filter("k", 100, 400)
                    .score_glm(train_q()))
    assert ex.model_hits == 0
    ex.execute(Q.scan("train").filter("k", 0, 50).score_glm(train_q()))
    assert ex.model_hits == 1
    assert r1.value.num_rows == 301


@pytest.mark.requires_cache
def test_mutation_invalidates_cached_model():
    cat = _cat(_glm_arrays())
    ex = _ex(cat, cache_bytes=1 << 24)
    q = train_q()
    ex.execute(q)
    score = Q.scan("train").score_glm(q)
    ex.execute(score)
    assert ex.model_hits == 1
    y = cat.tables["train"].column("y")
    cat.update_column("train", "y", (1.0 - y).numpy())
    r = ex.execute(score)
    assert ex.model_hits == 1
    oracle = ex.execute(score, optimized=False)
    assert torch.equal(r.value.column("score"),
                       oracle.value.column("score"))


def test_score_raw_fingerprint_requires_cached_model():
    ex = _ex(_cat(_glm_arrays()), cache_bytes=1 << 24)
    with pytest.raises(KeyError):
        ex.execute(Q.scan("train").score("deadbeef", list(FEATS)))


@pytest.mark.requires_cache
def test_score_by_raw_fingerprint_serves_the_cached_model():
    """The raw-fingerprint spelling finds the model the train admitted
    and launches no training: its scores equal the train-plan score's."""
    ex = _ex(_cat(_glm_arrays()), cache_bytes=1 << 24)
    q = train_q()
    ex.execute(q)
    by_plan = ex.execute(Q.scan("train").score_glm(q)).value
    fp = ex.fingerprint_of(q.node)
    by_fp = ex.execute(Q.scan("train").score(fp, list(FEATS))).value
    assert ex.model_hits == 2
    assert torch.equal(by_fp.column("score"), by_plan.column("score"))
    assert ex.cache.stats_dict()["semantic_cache_bytes_by_kind"]["model"] \
        > 0


# --------------------------------------------------------------------------- #
# concurrency (test_cache_concurrency.py)

N_THREADS = 4
N_OPS = 300


def _stress(cache, n_threads=N_THREADS, n_tables=3, seed=0):
    start = threading.Barrier(n_threads)
    errors = []

    def worker(wid):
        rng = np.random.default_rng(seed + wid)
        start.wait()
        try:
            for i in range(N_OPS):
                t = f"t{rng.integers(n_tables)}"
                lo = int(rng.integers(0, 50))
                hi = lo + int(rng.integers(1, 50))
                op = i % 3
                if op == 0:
                    cache.put(("bitmap", t, 0, "v", lo, hi, wid, i),
                              torch.arange(8), kind="bitmap",
                              n_bytes=int(rng.integers(16, 256)),
                              recompute_s=float(rng.random() + 0.01),
                              tables=(t,), interval=(t, "v", 0, lo, hi))
                elif op == 1:
                    found = cache.lookup_superset(
                        t, "v", 0, lo + 5, max(lo + 5, hi - 5))
                    if found is not None:
                        entry, (clo, chi) = found
                        assert clo <= lo + 5 and chi >= max(lo + 5, hi - 5)
                        assert entry.n_bytes >= 0
                else:
                    cache.invalidate_table(t)
        except Exception as exc:                     # pragma: no cover
            errors.append((wid, exc))

    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
        assert not th.is_alive()
    return errors


def _reconcile(cache):
    with cache._lock:
        cache.check_invariants()
        resident = {e.key for e in cache._entries.values()
                    if e.interval is not None}
        indexed = {k for bucket in cache._intervals.values() for k in bucket}
        assert indexed == resident


def test_concurrent_invalidate_vs_put_and_lookup():
    cache = SemanticCache(1 << 20, device="cpu")
    assert not _stress(cache)
    _reconcile(cache)
    cache.put(("bitmap", "t0", 0, "v", 0, 99), torch.arange(4),
              kind="bitmap", n_bytes=16, recompute_s=1.0, tables=("t0",),
              interval=("t0", "v", 0, 0, 99))
    assert cache.lookup_superset("t0", "v", 0, 10, 20) is not None


def test_concurrent_stress_with_demotion_tier():
    cache = SemanticCache(2048, host_budget_bytes=4096, device="cpu")
    assert not _stress(cache, seed=7)
    _reconcile(cache)
    st = cache.stats_dict()
    assert st["semantic_cache_used_bytes"] <= 2048
    assert st["semantic_cache_host_used_bytes"] <= 4096


def test_concurrent_stress_more_threads_than_cores_fast_switching():
    """More workers than cores, switching every microsecond: a lost
    update in the byte books or the index shows in the reconciliation."""
    import os
    cache = SemanticCache(2048, host_budget_bytes=4096, device="cpu")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        errors = _stress(cache, n_threads=(os.cpu_count() or 4) + 2,
                         seed=11)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    _reconcile(cache)


def test_concurrent_clear_vs_put():
    cache = SemanticCache(1 << 16, device="cpu")
    start = threading.Barrier(2)
    errors = []

    def putter():
        start.wait()
        try:
            for i in range(N_OPS):
                cache.put(("bitmap", "t", 0, "v", i, i + 10),
                          torch.arange(4), kind="bitmap", n_bytes=16,
                          recompute_s=0.5, tables=("t",),
                          interval=("t", "v", 0, i, i + 10))
        except Exception as exc:                     # pragma: no cover
            errors.append(exc)

    def clearer():
        start.wait()
        try:
            for _ in range(N_OPS // 10):
                cache.clear()
        except Exception as exc:                     # pragma: no cover
            errors.append(exc)

    threads = [threading.Thread(target=putter),
               threading.Thread(target=clearer)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    assert not errors
    _reconcile(cache)


# --------------------------------------------------------------------------- #
# parity with the reference's cache

def _equal_models():
    """The two cost models with every channel constant set equal."""
    port, ref = CostModel(1), RCostModel(1, calibration=None)
    for k in CHANNEL_KEYS:
        setattr(ref, k, getattr(port, k))
    return port, ref


@pytest.mark.parametrize("seed,host", [(0, 0), (1, 3000), (2, 1500)])
def test_cache_stats_equal_the_reference_after_every_operation(seed, host):
    """One seeded sequence of put / get / lookup_superset /
    invalidate_table / sync_versions / set_tenant_shares / peek_superset
    drives both caches (a host tier where ``host`` > 0): equal n_bytes and
    recompute_s, equal models, so every decision and every stats_dict()
    must match after every operation."""
    pm, rm = _equal_models()
    port = SemanticCache(2000, model=pm, host_budget_bytes=host,
                         device="cpu")
    ref = RSemanticCache(2000, model=rm, host_budget_bytes=host)
    r = np.random.default_rng(seed)
    keys = []
    for i in range(400):
        op = r.integers(0, 10)
        t = f"t{r.integers(3)}"
        if op <= 3:
            lo = int(r.integers(0, 60))
            hi = lo + int(r.integers(-2, 40))
            key = ("bitmap", t, 0, "v", lo, hi)
            n = int(r.integers(8, 900))
            rec = float(r.random() * 2 + 1e-3)
            tenant = [None, "a", "b"][int(r.integers(3))]
            kw = dict(kind="bitmap", n_bytes=n, recompute_s=rec,
                      tables=(t,), interval=(t, "v", 0, lo, hi),
                      tenant=tenant)
            got = port.put(key, torch.arange(4), **kw)
            assert got == ref.put(key, np.arange(4), **kw)
            keys.append(key)
        elif op <= 5 and keys:
            key = keys[int(r.integers(len(keys)))]
            assert (port.get(key) is None) == (ref.get(key) is None)
        elif op == 6:
            lo = int(r.integers(0, 60))
            hi = lo + int(r.integers(-3, 20))
            a = port.lookup_superset(t, "v", 0, lo, hi)
            b = ref.lookup_superset(t, "v", 0, lo, hi)
            assert (a is None) == (b is None)
            if a is not None:
                assert a[0].key == b[0].key and a[1] == b[1]
        elif op == 7:
            assert port.invalidate_table(t) == ref.invalidate_table(t)
        elif op == 8:
            v = {f"t{j}": int(r.integers(0, 2)) for j in range(3)}
            assert port.sync_versions(v) == ref.sync_versions(v)
        else:
            shares = {"a": float(r.integers(1, 4)),
                      "b": float(r.integers(1, 4))} \
                if r.random() < 0.7 else {}
            port.set_tenant_shares(shares)
            ref.set_tenant_shares(shares)
        assert port.stats_dict() == ref.stats_dict(), i
    assert port.stats_dict()["semantic_cache_admitted"] > 0


# --------------------------------------------------------------------------- #
# executor sequences against the reference's

def _ssb_arrays(seed=2, n=4096):
    r = np.random.default_rng(seed)
    dates = np.arange(19920101, 19920101 + 300, dtype=np.int32)
    return {
        "lineorder": {
            "orderdate": r.choice(dates, n).astype(np.int32),
            "quantity": r.integers(1, 51, n, dtype=np.int32),
            "discount": r.integers(0, 11, n, dtype=np.int32),
            "extendedprice": r.integers(1000, 90000, n, dtype=np.int32)},
        "date": {"orderdate": dates[::2].copy()},
    }


def _ssb_q(Qc, qlo=1, qhi=24):
    return (Qc.scan("lineorder").filter("orderdate", 19920120, 19920300)
              .filter("discount", 1, 3).filter("quantity", qlo, qhi)
              .join(Qc.scan("date"), on="orderdate").sum("extendedprice"))


COUNTERS = ("result_hits", "subplan_hits", "build_hits", "model_hits",
            "subsumption_hits")


def _run_both(ref, port, steps):
    """``steps``: (port query, reference query, mode) triples, or a
    callable ``f(catalog, catalog)`` that mutates both catalogs.  Values,
    each query's result hit and the executors' counters must agree."""
    for step in steps:
        if callable(step):
            step(ref.catalog, port.catalog)
            continue
        qp, qr, mode = step
        a, b = port.execute(qp, mode=mode), ref.execute(qr, mode=mode)
        assert a.result_cache_hit == b.result_cache_hit, (qp, mode)
        if isinstance(a.value, tuple):
            for x, y in zip(a.value, b.value):
                np.testing.assert_allclose(_np(x), np.asarray(y), **W_TOL)
        elif hasattr(a.value, "columns"):
            for c in a.value.columns:
                got, want = _np(a.value.column(c)), \
                    np.asarray(b.value.column(c))
                if got.dtype.kind == "f":
                    np.testing.assert_allclose(got, want, **W_TOL)
                else:
                    np.testing.assert_array_equal(got, want)
        else:
            assert a.value == b.value, (qp, mode)
        for c in COUNTERS:
            assert getattr(port, c) == getattr(ref, c), (c, qp, mode)


@pytest.mark.requires_cache
def test_ssb_sequence_equals_the_reference():
    arrays = _ssb_arrays()
    ref = _ref_ex(arrays, cache_bytes=64 << 20)
    port = _ex(_cat(arrays), cost_model=CostModel(1), cache_bytes=64 << 20)
    new_disc = np.random.default_rng(9).integers(
        0, 11, 4096, dtype=np.int32)

    def mutate(rcat, pcat):
        rcat.update_column("lineorder", "discount", new_disc)
        pcat.update_column("lineorder", "discount", new_disc)

    steps = [(_ssb_q(Q), _ssb_q(RQ), m) for m in MODES]
    steps += [(_ssb_q(Q, 5, 20), _ssb_q(RQ, 5, 20), m) for m in MODES]
    steps += [mutate] + [(_ssb_q(Q), _ssb_q(RQ), m) for m in MODES]
    _run_both(ref, port, steps)
    assert port.result_hits > 0 and port.build_hits > 0


@pytest.mark.requires_cache
def test_subsumption_ladder_equals_the_reference():
    arrays = _arrays(3, vmax=1000)
    ref = _ref_ex(arrays, cache_bytes=64 << 20)
    port = _ex(_cat(arrays), cost_model=CostModel(1), cache_bytes=64 << 20)

    def proj(Qc, lo, hi):
        return Qc.scan("big").filter("v", lo, hi).project("k", "w")

    def agg(Qc, lo, hi):
        return Qc.scan("big").filter("v", lo, hi).sum("w")

    def mutate(rcat, pcat):
        v = np.random.default_rng(4).integers(0, 1000, 4096).astype(
            np.int32)
        rcat.update_column("big", "v", v)
        pcat.update_column("big", "v", v)

    ladder = [(0, 320), (100, 300), (150, 250), (160, 200), (0, 999),
              (10, 20)]
    steps = [(proj(Q, lo, hi), proj(RQ, lo, hi), "batch")
             for lo, hi in ladder]
    steps += [(agg(Q, 170, 190), agg(RQ, 170, 190), "batch"),
              (agg(Q, 120, 280), agg(RQ, 120, 280), "eager"),
              mutate,
              (proj(Q, 100, 300), proj(RQ, 100, 300), "batch"),
              (proj(Q, 150, 250), proj(RQ, 150, 250), "eager")]
    _run_both(ref, port, steps)
    assert port.subsumption_hits > 0
    assert port.metrics.value("exec.refine_routed") \
        == ref.metrics.value("exec.refine_routed") > 0


@pytest.mark.requires_cache
def test_train_then_score_equals_the_reference():
    arrays = _glm_arrays()
    ref = _ref_ex(arrays, cache_bytes=1 << 24)
    port = _ex(_cat(arrays), cost_model=CostModel(1), cache_bytes=1 << 24)

    def score(Qc, grid, lo, hi):
        return Qc.scan("train").filter("k", lo, hi).score_glm(
            train_q(Qc, grid))

    def mutate(rcat, pcat):
        y = 1.0 - arrays["train"]["y"]
        rcat.update_column("train", "y", y)
        pcat.update_column("train", "y", y)

    steps = [(train_q(Q), train_q(RQ, R_GRID), "batch"),
             (score(Q, GRID, 0, 255), score(RQ, R_GRID, 0, 255), "batch"),
             (score(Q, GRID, 10, 99), score(RQ, R_GRID, 10, 99), "eager"),
             (train_q(Q), train_q(RQ, R_GRID), "stream"),
             mutate,
             (score(Q, GRID, 0, 255), score(RQ, R_GRID, 0, 255), "batch")]
    _run_both(ref, port, steps)
    assert port.model_hits == 2


# --------------------------------------------------------------------------- #
# cached == uncached, bit for bit

def _workload():
    return [Q.scan("big").filter("v", 10, 60).sum("w"),
            _join_sum(),
            _join_sum(lo=35, hi=45),
            Q.scan("big").filter("v", 0, 25).project("k", "w"),
            Q.scan("big").filter("v", 5, 20).project("k", "w"),
            Q.scan("big").filter("v", 0, 25).project("k"),
            Q.scan("big").filter("v", 10, 30).mean("w"),
            Q.scan("big").join(Q.scan("small"), on="k")
             .filter("v", 30, 49).mean("w"),
            Q.scan("big").join(Q.scan("small"), on="k").count("k")]


def _glm_workload():
    q = Q.scan("train").train_glm(list(FEATS), "y", list(GRID), epochs=2)
    return [q, Q.scan("train").score_glm(q),
            Q.scan("train").filter("k", 0, 300).score_glm(q), q]


def _compare_cached(make_ex, workload, modes=MODES):
    """Each mode on a fresh cached and cache-disabled executor pair, the
    workload twice: every value bit for bit (GLM losses too, which each
    mode folds in its own order).  Returns the summed hit counters."""
    hits = dict.fromkeys(COUNTERS, 0)
    for mode in modes:
        plain, cached = make_ex(None), make_ex(64 << 20)
        for _ in range(2):
            for q in workload:
                _assert_values_equal(cached.execute(q, mode=mode).value,
                                     plain.execute(q, mode=mode).value)
        for c in COUNTERS:
            hits[c] += getattr(cached, c)
        hits["spilled_columns"] = cached.stats_dict()["spilled_columns"]
        hits["ledger_rows"] = len(cached.tel.ledger.rows)
    return hits


@pytest.mark.requires_cache
@pytest.mark.parametrize("traced", [False, True])
def test_cached_equals_uncached_in_every_mode(traced):
    arrays = _arrays(8)

    def make(cache_bytes):
        tel = Telemetry(enabled=True) if traced else None
        return _ex(_cat(arrays), cache_bytes=cache_bytes, telemetry=tel)

    hits = _compare_cached(make, _workload())
    assert hits["result_hits"] > 0 and hits["subsumption_hits"] > 0
    assert hits["subplan_hits"] > 0 and hits["build_hits"] > 0
    if traced:
        assert hits["ledger_rows"] > 0


@pytest.mark.requires_cache
@pytest.mark.parametrize("host", [0, 1 << 20])
def test_cached_equals_uncached_under_tight_budgets(host):
    """A device budget of a few bitmaps forces evictions (and, with a host
    tier, demotions and host hits) in every mode; every value stays the
    cache-disabled run's and the books reconcile."""
    arrays = _arrays(11)
    caches = []

    def make(cache_bytes):
        if cache_bytes is None:
            return _ex(_cat(arrays))
        caches.append(SemanticCache(12_000, host_budget_bytes=host,
                                    device="cpu"))
        return _ex(_cat(arrays), semantic_cache=caches[-1])

    _compare_cached(make, _workload())
    assert sum(c.evicted + c.demoted for c in caches) > 0
    if host:
        assert sum(c.demoted for c in caches) > 0
    for c in caches:
        c.check_invariants()


@pytest.mark.requires_cache
def test_cached_equals_uncached_glm_weights_and_scores():
    arrays = _glm_arrays(300, seed=4)
    hits = _compare_cached(
        lambda cb: _ex(_cat(arrays), cache_bytes=cb), _glm_workload())
    assert hits["model_hits"] > 0 and hits["result_hits"] > 0


@pytest.mark.requires_cache
def test_cached_equals_uncached_spilled(tmp_path, monkeypatch):
    """Under a device budget that holds one column (a spill plan demotes
    the rest to host and disk) the cached runs equal the uncached ones,
    the spilled project root and the GLM search included."""
    monkeypatch.setenv("REPRO_SPILL_DIR", str(tmp_path))
    arrays = _arrays(9)
    budgets = TierBudgets(device=4096 * 4, host=4096 * 4, disk=1 << 24)
    hits = _compare_cached(
        lambda cb: _ex(_cat(arrays), tier_budgets=budgets, cache_bytes=cb),
        _workload(), modes=("batch",))
    assert hits["spilled_columns"] > 0 and hits["result_hits"] > 0
    glm = _glm_arrays(512, seed=5)
    gb = TierBudgets(device=512 * 4, host=1 << 20, disk=1 << 24)
    hits = _compare_cached(
        lambda cb: _ex(_cat(glm), tier_budgets=gb, cache_bytes=cb),
        _glm_workload(), modes=("batch",))
    assert hits["spilled_columns"] > 0 and hits["model_hits"] > 0


# --------------------------------------------------------------------------- #
# host-tier hits reach the executor's device

@pytest.mark.requires_cache
def test_every_host_tier_hit_goes_through_to_device(monkeypatch):
    """A device budget of a few bitmaps and a roomy host tier: the
    ladder's bitmaps and results demote, and every hit the executor
    serves from a host-tier entry (promoted or not) passes that host
    value through the cache's ``_to_device``.  Values equal the cache-
    disabled run's."""
    moved, host_hits = [], []
    real_to_device = cache_mod._to_device
    real_get = SemanticCache.get

    def to_device(value, device):
        moved.append(id(value))
        return real_to_device(value, device)

    def get(self, key):
        e = self.peek(key)
        host_value = e.value if e is not None and e.tier == "host" \
            else None
        out = real_get(self, key)
        if host_value is not None:
            host_hits.append(id(host_value))
        return out

    monkeypatch.setattr(cache_mod, "_to_device", to_device)
    monkeypatch.setattr(SemanticCache, "get", get)
    arrays = _arrays(10, vmax=1000)
    cache = SemanticCache(20_000, host_budget_bytes=1 << 22, device="cpu")
    ex = _ex(_cat(arrays), semantic_cache=cache)
    plain = _ex(_cat(arrays))
    qs = [Q.scan("big").filter("v", lo, hi).project("k", "w")
          for lo, hi in ((0, 300), (400, 700), (0, 300), (100, 250),
                         (400, 700), (450, 650))]
    for q in qs * 2:
        _assert_values_equal(ex.execute(q).value, plain.execute(q).value)
    assert cache.demoted > 0 and host_hits
    assert set(host_hits) <= set(moved)
    cache.check_invariants()


# --------------------------------------------------------------------------- #
# the stale-state fault: nothing of the old version stays behind

@pytest.mark.parametrize("cache_bytes", [None, 32 << 20])
def test_mutation_leaves_no_state_of_the_old_version(cache_bytes):
    """On the parent tree ``_placed`` kept ('k', 0) and ('v', 0) beside
    ('k', 1) and ('v', 1), and ``_planned`` grew from 1 to 2 entries:
    every mutation of a column kept its old placements alive."""
    r = np.random.default_rng(12)
    arrays = {"t": {"k": r.integers(0, 100, 4096).astype(np.int32),
                    "v": r.integers(0, 100, 4096).astype(np.int32)},
              "d": {"k": np.arange(0, 100, 2, dtype=np.int32)}}
    cat = _cat(arrays)
    ex = _ex(cat, cache_bytes=cache_bytes)
    q = Q.scan("t").filter("v", 10, 60).join(Q.scan("d"), on="k").sum("v")
    for mode in ("batch", "eager"):
        ex.execute(q, mode=mode)
    old_keys = set(ex.cache._entries) if ex.cache is not None else set()
    cat.update_column("t", "v", r.integers(0, 100, 4096).astype(np.int32))
    for mode in ("batch", "eager"):
        got = ex.execute(q, mode=mode)
        assert got.value == _ex(cat).execute(q, mode=mode).value
    now = cat.versions()
    assert {k[3] for k in ex._placed if k[0] == "t"} == {now["t"]}
    assert all(k[1] == cat.tables[k[0].table].version for k in ex._builds)
    assert all(dict(k[1]) == now for k in ex._planned)
    assert len(ex._planned) == 1
    if ex.cache is not None:
        assert ex.cache.invalidated > 0
        assert not {k for k in old_keys if k in ex.cache._entries
                    and "t" in ex.cache._entries[k].tables}
        for e in ex.cache._entries.values():
            if e.kind in ("bitmap", "build") and e.key[1] == "t":
                assert e.key[2] == now["t"]
