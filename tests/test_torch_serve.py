"""The port's query server against the JAX reference, on the CPU.

Ports the reference's server cases: all of ``tests/test_query_serve.py``,
``test_streaming_differential.py:276`` and ``:306``,
``test_adaptive_replan.py:213-444``, ``test_semantic_cache.py:282-451``
(less the overlap case, which ``test_torch_cache.py`` holds),
``test_shared_cache.py:116``, ``:134`` and ``:155``,
``test_glm_query.py:198``, ``test_tiering.py:385`` and the sojourn cases
``test_telemetry.py:264`` and ``:292``, each on the same seeded numpy
data.  Then parity: one seeded sequence of submissions and pumps goes
through the port's and the reference's servers, in both disciplines, with
and without a cache, and gives the same value (integers bit for bit,
float means within 1e-6 relative), path and counters per query; a
streaming group of four join members probes once a morsel; the group step
equals the lone step lane by lane; ``record_plan(scale=)`` and the serving
ledger rows equal the reference's.  The reference runs on an Auto-axis
mesh.
"""
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.columnar.table import Table as RTable
from repro.query import (
    Catalog as RCatalog, CostModel as RCostModel, Executor as RExecutor,
    Q as RQ, QueryServer as RQueryServer, TenantSpec as RTenantSpec,
)
from repro.query import telemetry as rtm

from repro_torch.columnar import engine
from repro_torch.convert import catalog_from_arrays
from repro_torch.kernels.join import join as join_kernels
from repro_torch.query import (
    AdaptivePolicy, CostModel, Executor, HyperParams, Q, QueryServer,
    SemanticCache, TenantSpec, analyze_project, optimize,
)
from repro_torch.query import exec as pexec
from repro_torch.query import logical as L
from repro_torch.query import pipeline as pl
from repro_torch.query import serve as serve_mod
from repro_torch.query import telemetry as tm

MEAN_RTOL = 1e-6       # f32 sums of integers below 2**24 are exact


def _auto_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()).reshape(1, -1),
                             ("data", "model"))


def _cat(arrays):
    return catalog_from_arrays(arrays, "cpu")


def _ex(cat, **kw):
    return Executor(cat, device="cpu", **kw)


def _ref_ex(arrays, **kw):
    return RExecutor(RCatalog.from_tables(*(RTable.from_arrays(t, c)
                                            for t, c in arrays.items())),
                     mesh=_auto_mesh(),
                     cost_model=RCostModel(1, calibration=None), **kw)


def _serve_arrays(seed=0, n=4096):
    """``tests/test_query_serve.py``'s tables, drawn in its order."""
    r = np.random.default_rng(seed)
    big = {"v": r.integers(0, 100, size=n).astype(np.int32),
           "w": r.integers(1, 50, size=n).astype(np.int32),
           "k": r.integers(0, 1000, size=n).astype(np.int32)}
    return {"big": big, "small": {"k": np.arange(0, 1000, 2,
                                                 dtype=np.int32)}}


def _kvw_arrays(seed=0, n=4096, n_small=512, vmax=100, x=False, dup=False):
    """The k / v / w tables of the streaming, adaptive and cache suites,
    drawn in their order (``x``: small's payload column, ``dup``: the
    streaming suite's duplicate-keyed table)."""
    r = np.random.default_rng(seed)
    big = {"k": r.integers(0, 1000, size=n).astype(np.int32),
           "v": r.integers(0, vmax, size=n).astype(np.int32),
           "w": r.integers(1, 50, size=n).astype(np.int32)}
    small = {"k": np.asarray(r.choice(1000, size=n_small, replace=False),
                             np.int32)}
    if x:
        small["x"] = r.integers(0, 9, size=n_small).astype(np.int32)
    out = {"big": big, "small": small}
    if dup:
        out["dup"] = {"k": r.integers(0, 50, size=256).astype(np.int32)}
    return out


def _sum_where(a, lo, hi, isin=None):
    m = (a["v"] >= lo) & (a["v"] <= hi)
    if isin is not None:
        m &= isin
    return int(a["w"][m].astype(np.int64).sum())


def _isin(arrays):
    return np.isin(arrays["big"]["k"], arrays["small"]["k"])


def _join_sum(Qc=Q, lo=30, hi=49):
    return (Qc.scan("big").join(Qc.scan("small"), on="k")
              .filter("v", lo, hi).sum("w"))


def _assert_same_value(got, want):
    """A port value against a port or numpy value: bit for bit."""
    if hasattr(got, "columns"):
        assert set(got.columns) == set(want.columns)
        for c in got.columns:
            assert torch.equal(got.column(c), want.column(c)), c
    else:
        assert type(got) is type(want) and got == want, (got, want)


# --------------------------------------------------------------------------- #
# tests/test_query_serve.py

def test_identical_queries_dedup():
    a = _serve_arrays()
    srv = QueryServer(_ex(_cat(a)))
    q = Q.scan("big").filter("v", 10, 30).sum("w")
    qids = [srv.submit(q) for _ in range(5)]
    res = srv.drain()
    assert all(res[i] == _sum_where(a["big"], 10, 30) for i in qids)
    assert srv.n_deduped == 4


def test_compatible_selections_microbatch():
    a = _serve_arrays()
    srv = QueryServer(_ex(_cat(a)))
    bounds = [(0, 9), (10, 19), (20, 29), (30, 39), (40, 49)]
    qids = [srv.submit(Q.scan("big").filter("v", lo, hi).sum("w"))
            for lo, hi in bounds]
    res = srv.drain()
    for qid, (lo, hi) in zip(qids, bounds):
        assert res[qid] == _sum_where(a["big"], lo, hi)
    assert srv.n_microbatched == 5
    assert srv.n_batches == 1           # one pass served all 5


def test_batched_kernel_cache_hits_across_drains():
    srv = QueryServer(_ex(_cat(_serve_arrays())))
    for _ in range(3):
        for lo in (0, 20, 40, 60):      # the same size bucket every round
            srv.submit(Q.scan("big").filter("v", lo, lo + 9).sum("w"))
        srv.drain()
    assert srv.n_batches == 3
    assert srv.batched_cache_hits == 2  # built once, reused twice


def test_mixed_batch_routes_each_query_correctly():
    a = _serve_arrays()
    b = a["big"]
    srv = QueryServer(_ex(_cat(a)))
    q_join = (Q.scan("big").join(Q.scan("small"), on="k")
               .filter("v", 0, 60).sum("w"))
    ids_sel = [srv.submit(Q.scan("big").filter("v", lo, lo + 9).sum("w"))
               for lo in (0, 30)]
    id_join = srv.submit(q_join)
    id_dup = srv.submit(q_join)
    res = srv.drain()
    for qid, lo in zip(ids_sel, (0, 30)):
        assert res[qid] == _sum_where(b, lo, lo + 9)
    assert res[id_join] == _sum_where(b, 0, 60, _isin(a))
    assert res[id_dup] == res[id_join]
    s = srv.stats()
    assert s["n_queries"] == 4
    assert s["n_deduped"] == 1
    assert s["n_microbatched"] == 2
    assert s["queries_per_s"] > 0
    assert s["latency_mean_s"] > 0


def test_count_and_mean_microbatch():
    a = _serve_arrays()
    v = a["big"]["v"]
    srv = QueryServer(_ex(_cat(a)))
    ids = [srv.submit(Q.scan("big").filter("v", lo, lo + 19).count("w"))
           for lo in (0, 40)]
    res = srv.drain()
    for qid, lo in zip(ids, (0, 40)):
        assert res[qid] == int(((v >= lo) & (v <= lo + 19)).sum())


# --------------------------------------------------------------------------- #
# tests/test_streaming_differential.py:276, :306

def test_streaming_server_matches_batch_server():
    a = _kvw_arrays(dup=True)
    isin = _isin(a)
    srv = QueryServer(_ex(_cat(a)), streaming=True, morsel_rows=512)
    bounds = [(0, 9), (10, 40), (20, 60), (0, 99)]
    qids = [srv.submit(_join_sum(Q, lo, hi)) for lo, hi in bounds]
    for _ in range(2):
        srv.pump()                      # the stream in flight...
    late = srv.submit(_join_sum(Q, 5, 15))          # ...joins mid-circle
    dup = srv.submit(_join_sum(Q, 0, 9))            # dedup in flight
    res = srv.drain()
    for qid, (lo, hi) in zip(qids + [late], bounds + [(5, 15)]):
        assert res[qid] == _sum_where(a["big"], lo, hi, isin)
    assert res[dup] == res[qids[0]]
    s = srv.stats()
    assert s["n_deduped"] == 1
    assert s["n_streamed"] == 5
    assert len(res) == 6


def test_mid_flight_group_join_keeps_lone_member_carry():
    """A query streaming alone in its group keeps its carry when a second
    compatible query attaches mid-flight."""
    a = _kvw_arrays(dup=True)
    isin = _isin(a)
    srv = QueryServer(_ex(_cat(a)), streaming=True, morsel_rows=512)
    q1 = srv.submit(_join_sum(Q, 10, 60))
    for _ in range(3):
        srv.pump()                       # q1 accumulates alone
    q2 = srv.submit(_join_sum(Q, 20, 80))           # same group, joins
    res = srv.drain()
    for qid, (lo, hi) in ((q1, (10, 60)), (q2, (20, 80))):
        assert res[qid] == _sum_where(a["big"], lo, hi, isin), (lo, hi)


# --------------------------------------------------------------------------- #
# tests/test_adaptive_replan.py:213-444 (the port's CPU impl is "torch")

def _overlay(eff=0.5, overhead=5e-6):
    return {"backend": "test", "backends": {
        "torch": {"stream_eff": eff, "call_overhead_s": overhead,
                  "achieved_gbps": 1.0}}}


def test_mid_stream_recalibration_differential():
    """In-flight members finish on their pinned pipeline, later admissions
    use the re-costed one, and every answer equals a cache-less oracle's
    bit for bit."""
    a = _kvw_arrays()
    oracle = _ex(_cat(a))
    ex = _ex(_cat(a))
    srv = QueryServer(ex, streaming=True, morsel_rows=512)
    pre = [Q.scan("big").filter("v", 10, 60).sum("w"),
           Q.scan("big").filter("v", 20, 39).mean("w")]
    post = [Q.scan("big").filter("v", 5, 80).sum("w"),
            Q.scan("big").filter("v", 0, 25).count("w")]
    qids = {srv.submit(q): q for q in pre}
    results = {}
    results.update(srv.pump())
    results.update(srv.pump())          # mid-circle
    before = {id(g) for s in srv._streams.values() for g in s.groups.values()}
    ex.recost(_overlay(eff=0.02, overhead=1e-3))
    for q in post:
        qids[srv.submit(q)] = q
    while len(results) < len(qids):
        results.update(srv.pump())
    after = {id(g) for s in srv._streams.values() for g in s.groups.values()}
    assert before <= after and len(after) > len(before)
    for qid, q in qids.items():
        assert results[qid] == oracle.execute(q).value, q.node


def test_stream_respecs_when_idle_after_recost():
    ex = _ex(_cat(_kvw_arrays()))
    srv = QueryServer(ex, streaming=True)
    srv.submit(Q.scan("big").filter("v", 10, 60).sum("w"))
    srv.drain()
    stream = srv._streams["big"]
    assert stream.epoch == 0
    ex.recost(_overlay(eff=1e-3, overhead=5e-3))
    srv.submit(Q.scan("big").filter("v", 5, 50).sum("w"))
    srv.drain()
    assert srv._streams["big"].epoch == ex.cost_epoch
    assert srv._streams["big"] is not stream


def _breaching_rows(ledger, n, drift=3.0):
    for _ in range(n):
        ledger.record(op="filter", impl="torch", placement="partitioned",
                      predicted_bytes=1e6, predicted_s=1e-3,
                      measured_bytes=1e6, measured_s=1e-3 * drift,
                      mode="serve")


def _policy_server():
    ex = _ex(_cat(_kvw_arrays()), telemetry=tm.Telemetry(enabled=True))
    return ex, QueryServer(ex, streaming=True, policy=AdaptivePolicy(
        drift_threshold=0.5, k_windows=2, min_window_rows=2))


def test_drift_trigger_fires_after_k_windows():
    ex, srv = _policy_server()
    _breaching_rows(ex.tel.ledger, 4)
    srv._maybe_recalibrate()            # window 1: breach, streak 1
    assert srv.n_recalibrations == 0 and ex.cost_epoch == 0
    _breaching_rows(ex.tel.ledger, 4)
    srv._maybe_recalibrate()            # window 2: breach -> recalibrate
    assert srv.n_recalibrations == 1
    assert ex.cost_epoch == 1
    assert ex.cost_model.calibrated_from == "ledger"
    assert srv._overlay_start == len(ex.tel.ledger.rows)
    assert srv._breach_streak == 0


def test_drift_trigger_streak_resets_on_clean_window():
    ex, srv = _policy_server()
    _breaching_rows(ex.tel.ledger, 4, drift=3.0)
    srv._maybe_recalibrate()
    _breaching_rows(ex.tel.ledger, 4, drift=1.0)   # a clean window
    srv._maybe_recalibrate()
    _breaching_rows(ex.tel.ledger, 4, drift=3.0)
    srv._maybe_recalibrate()
    assert srv.n_recalibrations == 0 and ex.cost_epoch == 0


def test_serving_streams_feed_ledger():
    ex = _ex(_cat(_kvw_arrays()), telemetry=tm.Telemetry(enabled=True))
    srv = QueryServer(ex, streaming=True, morsel_rows=1024)
    srv.submit(Q.scan("big").filter("v", 10, 60).sum("w"))
    srv.drain()
    serve_rows = [r for r in ex.tel.ledger.rows if r.mode == "serve"]
    assert serve_rows
    # predictions are scaled to one morsel
    assert all(r.predicted_s < 1.0 for r in serve_rows)


def test_priority_ordering_under_saturation():
    srv = QueryServer(_ex(_cat(_kvw_arrays())))
    srv.register_tenant(TenantSpec("hi", priority=10, slo_p95_s=5.0))
    srv.register_tenant(TenantSpec("lo", priority=0))
    for i in range(8):
        srv.submit(Q.scan("big").filter("v", i, 60 + i).sum("w"),
                   tenant="lo")
        srv.submit(Q.scan("big").filter("v", i, 61 + i).sum("w"),
                   tenant="hi")
    srv.drain()
    hi = [r for r in srv.history if r.tenant == "hi"]
    lo = [r for r in srv.history if r.tenant == "lo"]
    assert max(r.t_complete for r in hi) <= max(r.t_complete for r in lo)
    st = srv.stats()["tenants"]
    assert st["hi"]["latency_p95_s"] <= st["lo"]["latency_p95_s"]


def test_deadline_breaks_priority_ties():
    recs = [type("R", (), {"priority": 1, "deadline": d, "t_submit": i})()
            for i, d in enumerate([3.0, 1.0, 2.0])]
    out = QueryServer._admission_order(recs)
    assert [r.deadline for r in out] == [1.0, 2.0, 3.0]


def test_backpressure_defers_best_effort_only():
    a = _kvw_arrays()
    oracle = _ex(_cat(a))
    srv = QueryServer(_ex(_cat(a)), streaming=True, morsel_rows=1024)
    srv.register_tenant(TenantSpec("hi", priority=10, slo_p95_s=1e-9))
    srv.register_tenant(TenantSpec("lo", priority=0))
    srv.submit(Q.scan("big").filter("v", 40, 50).sum("w"), tenant="hi")
    srv.drain()                          # seeds the recent sojourns
    qids = {}
    for i in range(3):
        qids[srv.submit(Q.scan("big").filter("v", i, 70 + i).sum("w"),
                        tenant="lo")] = i
        qids[srv.submit(Q.scan("big").filter("v", i, 71 + i).sum("w"),
                        tenant="hi")] = i
    out = srv.drain()
    assert srv.n_backpressured > 0
    for rec in srv.history:
        assert rec.result == oracle.execute(rec.node).value
    assert set(qids) <= set(out)
    assert all(r.n_deferred == 0 for r in srv.history if r.tenant == "hi")


@pytest.mark.requires_cache
def test_register_tenant_pushes_shares_to_shared_cache():
    cache = SemanticCache(budget_bytes=8_000)
    ex = _ex(_cat(_kvw_arrays()), tenant="hi", semantic_cache=cache)
    srv = QueryServer(ex, semantic_cache=cache)
    srv.register_tenant(TenantSpec("hi", priority=1, cache_share=3.0))
    srv.register_tenant(TenantSpec("lo", priority=0, cache_share=1.0))
    assert cache.tenant_cap_bytes("hi") == int(8_000 * 3 / 5)
    srv.submit(Q.scan("big").filter("v", 10, 60).sum("w"), tenant="hi")
    srv.drain()
    tb = cache.stats_dict()["semantic_cache_tenant_bytes"]
    assert tb.get("hi", 0) > 0


# --------------------------------------------------------------------------- #
# tests/test_semantic_cache.py:282-451

@pytest.mark.requires_cache
def test_server_serves_cached_and_hints_shared():
    srv = QueryServer(_ex(_cat(_kvw_arrays(x=True)), cache_bytes=32 << 20))
    q = _join_sum()
    first = srv.query(q)
    second = srv.query(q)                      # a separate drain
    assert first == second
    assert srv.n_cached == 1
    assert any(r.path == "cached" for r in srv.history)
    srv.submit(Q.scan("big").filter("v", 5, 25).sum("w"))
    srv.submit(Q.scan("big").filter("v", 5, 25).count("w"))
    srv.drain()
    assert srv.n_subplan_shared > 0


@pytest.mark.requires_cache
def test_streamed_completion_feeds_result_cache():
    srv = QueryServer(_ex(_cat(_kvw_arrays(x=True)), cache_bytes=32 << 20),
                      streaming=True, morsel_rows=512)
    q = _join_sum(Q, 10, 60)
    first = srv.query(q)
    assert srv.n_streamed == 1
    second = srv.query(q)
    assert second == first
    assert srv.n_cached == 1 and srv.n_streamed == 1


def test_mid_flight_mutation_restarts_member():
    a = _kvw_arrays(x=True)
    cat = _cat(a)
    srv = QueryServer(_ex(cat, cache_bytes=32 << 20), streaming=True,
                      morsel_rows=512)
    q = _join_sum(Q, 0, 99)
    qid = srv.submit(q)
    srv.pump()
    srv.pump()                                 # mid-circle
    r = np.random.default_rng(1)
    cat.update_column("big", "w", r.integers(51, 99, size=4096)
                      .astype(np.int32))
    dup = srv.submit(q)                        # a post-mutation duplicate
    res = srv.drain()
    want = _ex(cat).execute(q).value
    assert res[qid] == want
    assert res[dup] == want
    assert srv.query(q) == want


@pytest.mark.parametrize("cache_bytes", [32 << 20, None])
def test_build_side_mutation_on_streaming_server(cache_bytes):
    a = _kvw_arrays(x=True)
    cat = _cat(a)
    srv = QueryServer(_ex(cat, cache_bytes=cache_bytes), streaming=True,
                      morsel_rows=512)
    q = _join_sum(Q, 0, 99)
    qid = srv.submit(q)
    srv.pump()
    srv.pump()                                 # mid-circle
    r = np.random.default_rng(2)
    cat.update_column("small", "k", np.asarray(
        r.choice(1000, size=512, replace=False), np.int32))
    res = srv.drain()
    want = _ex(cat).execute(q).value
    assert res[qid] == want
    assert srv.query(q) == want                # fresh builds


@pytest.mark.requires_cache
def test_streaming_server_dedups_by_fingerprint():
    a = _kvw_arrays(x=True)
    b = a["big"]
    srv = QueryServer(_ex(_cat(a), cache_bytes=32 << 20), streaming=True,
                      morsel_rows=512)
    qa = (Q.scan("big").join(Q.scan("small"), on="k")
           .filter("v", 10, 30).filter("w", 1, 20).sum("w"))
    qb = (Q.scan("big").join(Q.scan("small"), on="k")
           .filter("w", 1, 20).filter("v", 10, 30).sum("w"))
    ia = srv.submit(qa)
    srv.pump()
    ib = srv.submit(qb)                        # joins as a dedup rider
    res = srv.drain()
    assert res[ia] == res[ib]
    assert srv.n_deduped == 1
    m = ((b["v"] >= 10) & (b["v"] <= 30) & (b["w"] >= 1) & (b["w"] <= 20)
         & _isin(a))
    assert res[ia] == int(b["w"][m].sum())


def test_project_rooted_streaming_serve():
    """A Project-rooted member that joins mid-circle reassembles its
    device chunks in table order, equal to the eager materialization bit
    for bit."""
    a = _kvw_arrays(x=True)
    cat = _cat(a)
    srv = QueryServer(_ex(cat, cache_bytes=32 << 20), streaming=True,
                      morsel_rows=512)
    qp = (Q.scan("big").join(Q.scan("small"), on="k")
           .filter("v", 10, 60).project("k", "w", "x"))
    i_agg = srv.submit(_join_sum(Q, 10, 60))
    srv.pump()
    srv.pump()
    i_proj = srv.submit(qp)                    # joins mid-circle
    res = srv.drain()
    eager = _ex(cat).execute(qp, mode="eager").value
    got = res[i_proj]
    assert set(got.columns) == {"k", "w", "x"}
    _assert_same_value(got, eager)
    assert res[i_agg] == _sum_where(a["big"], 10, 60, _isin(a))
    assert srv.stats()["n_streamed"] == 2


def test_project_streaming_rejects_duplicate_builds():
    r = np.random.default_rng(0)
    a = {"big": {"k": r.integers(0, 40, size=1024).astype(np.int32),
                 "v": r.integers(0, 100, size=1024).astype(np.int32)},
         "dup": {"k": r.integers(0, 40, size=256).astype(np.int32),
                 "x": r.integers(1, 9, size=256).astype(np.int32)}}
    cat = _cat(a)
    node = (Q.scan("big").join(Q.scan("dup"), on="k")
             .project("k", "x")).node
    assert analyze_project(optimize(node, cat.stats), cat.stats) is None
    srv = QueryServer(_ex(cat), streaming=True, morsel_rows=512)
    qid = srv.submit(node)
    res = srv.drain()
    assert res[qid].num_rows == _ex(cat).execute(node).value.num_rows


# --------------------------------------------------------------------------- #
# tests/test_shared_cache.py:116, :134, :155

def _shared_arrays():
    return _kvw_arrays(vmax=1000, x=True)


@pytest.mark.requires_cache
def test_server_accepts_external_shared_cache():
    cat = _cat(_shared_arrays())
    shared = SemanticCache(32 << 20, model=CostModel(1))
    srv_a = QueryServer(_ex(cat), semantic_cache=shared)
    srv_b = QueryServer(_ex(cat), semantic_cache=shared)
    assert srv_a.executor.cache is shared
    assert srv_b.executor.cache is shared
    q = _join_sum(Q, 10, 60)
    assert srv_a.query(q) == srv_b.query(q)
    assert srv_b.n_cached == 1
    assert any(rec.path == "cached" for rec in srv_b.history)


@pytest.mark.requires_cache
def test_streaming_server_cross_tenant_build_reuse():
    cat = _cat(_shared_arrays())
    shared = SemanticCache(32 << 20, model=CostModel(1))
    a = _ex(cat, semantic_cache=shared)
    b = _ex(cat, semantic_cache=shared)
    q = _join_sum(Q, 5, 80)
    qc = (Q.scan("big").join(Q.scan("small"), on="k")
           .filter("v", 5, 80).count("w"))
    va = a.execute(q, mode="stream").value
    assert b.build_hits == 0
    vb = b.execute(qc, mode="stream").value
    assert b.build_hits == 1                      # the build phase skipped
    plain = _ex(cat)
    assert va == plain.execute(q).value
    assert vb == plain.execute(qc).value


def _cache_consistent(cache):
    with cache._lock:
        assert cache.used_bytes == sum(e.n_bytes
                                       for e in cache._entries.values())
        assert cache.used_bytes <= cache.budget_bytes
        for bucket in cache._intervals.values():
            for key in bucket:
                assert key in cache._entries


@pytest.mark.requires_cache
def test_threaded_pump_no_torn_reads_at_eviction():
    """A streaming server pumps while another thread churns the shared
    cache with high-score admissions, evicting the builds and bitmaps the
    groups hold; every result equals the oracle and the accounting ends
    consistent."""
    cat = _cat(_shared_arrays())
    shared = SemanticCache(1 << 20, model=CostModel(1))   # tight: churns
    srv = QueryServer(_ex(cat, semantic_cache=shared), streaming=True,
                      morsel_rows=512)
    queries = [_join_sum(Q, lo, lo + 37) for lo in range(0, 160, 10)]
    plain = _ex(cat)
    want = {i: plain.execute(q).value for i, q in enumerate(queries)}
    stop = threading.Event()
    errors = []

    def churn():
        i = 0
        try:
            while not stop.is_set():
                shared.put(("noise", i % 7),
                           torch.zeros(4096, dtype=torch.int32),
                           kind="result", n_bytes=16384, recompute_s=100.0,
                           tables=())
                shared.lookup_superset("big", "v", 0, 10, 20)
                shared.peek_superset("big", "v", 0, 10, 20)
                i += 1
        except Exception as e:                     # noqa: BLE001
            errors.append(e)

    t = threading.Thread(target=churn, daemon=True)
    t.start()
    try:
        qids, results = {}, {}
        for i, q in enumerate(queries):
            qids[srv.submit(q)] = i
            results.update(srv.pump())
        while srv._inflight():
            results.update(srv.pump())
    finally:
        stop.set()
        t.join(timeout=10)
    assert not errors, errors
    assert not t.is_alive()
    for qid, i in qids.items():
        assert results[qid] == want[i], i
    _cache_consistent(shared)


# --------------------------------------------------------------------------- #
# tests/test_glm_query.py:198, tests/test_tiering.py:385

FEATS = ("f0", "f1", "f2")
GRID = (HyperParams(0.1, 0.0), HyperParams(0.05, 0.01))


def _glm_arrays(m=512, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(m, len(FEATS))).astype(np.float32)
    w = np.array([1.0, -2.0, 0.5], np.float32)
    y = (1.0 / (1.0 + np.exp(-(a @ w))) > 0.5).astype(np.float32)
    cols = {f: a[:, i] for i, f in enumerate(FEATS)}
    cols["y"] = y
    cols["k"] = np.arange(m, dtype=np.int32)
    return {"train": cols}


@pytest.mark.requires_cache
def test_served_dashboard_reports_model_hits():
    ex = _ex(_cat(_glm_arrays()), cache_bytes=1 << 24)
    srv = QueryServer(ex)
    q = Q.scan("train").train_glm(list(FEATS), "y", list(GRID),
                                  kind="logreg", epochs=3)
    srv.submit(q)
    srv.drain()
    srv.submit(Q.scan("train").filter("k", 0, 255).score_glm(q))
    out = srv.drain()
    assert srv.stats()["n_model_hits"] == 1
    assert next(iter(out.values())).num_rows == 256
    assert ex.cache.stats_dict()[
        "semantic_cache_bytes_by_kind"].get("model", 0) > 0


@pytest.mark.requires_cache
def test_query_server_warm_start_roundtrip(tmp_path):
    path = str(tmp_path / "server.npz")
    cat = _cat(_kvw_arrays())
    q = Q.scan("big").filter("v", 10, 60).sum("w")
    srv = QueryServer(_ex(cat), persist_path=path,
                      semantic_cache=SemanticCache(
                          1 << 20, host_budget_bytes=1 << 20))
    srv.submit(q)
    srv.drain()
    want = srv.history[-1].result
    assert srv.save_state()["saved"] >= 1
    srv2 = QueryServer(_ex(cat), persist_path=path,
                       semantic_cache=SemanticCache(
                           1 << 20, host_budget_bytes=1 << 20))
    assert srv2.warm_started is not None
    assert srv2.warm_started["restored"] >= 1
    srv2.submit(q)
    srv2.drain()
    assert srv2.history[-1].result == want
    assert srv2.history[-1].path == "cached"
    assert srv2.executor.cache.hits >= 1


# --------------------------------------------------------------------------- #
# tests/test_telemetry.py:264, :292

def _exact_arrays(n=1 << 14, domain=128):
    return {"t": {"v": (np.arange(n) % domain).astype(np.int32),
                  "w": np.ones(n, np.int32)}}


def _scan_filter_sum(lo=10, hi=41):
    return Q.scan("t", ("v", "w")).filter("v", lo, hi).sum("w")


def test_server_sojourn_includes_queue_wait():
    ex = _ex(_cat(_exact_arrays(1 << 12)),
             telemetry=tm.Telemetry(enabled=False))
    srv = QueryServer(ex)
    wait = 0.05
    srv.submit(_scan_filter_sum(1, 10))
    srv.submit(_scan_filter_sum(2, 20))
    srv.submit(Q.scan("t", ("v", "w")).filter("v", 0, 5)
               .aggregate("count", "v"))
    time.sleep(wait)
    srv.drain()
    assert len(srv.history) == 3
    for rec in srv.history:
        assert rec.t_complete > rec.t_submit > 0.0
        assert rec.latency_s >= wait
        assert rec.latency_s == pytest.approx(rec.t_complete - rec.t_submit)
    assert {r.path for r in srv.history} == {"microbatch", "exec"}
    snap = ex.metrics_snapshot()
    assert snap["serve.sojourn_s.count"] == 3
    assert snap["serve.sojourn_s.p50"] >= wait
    assert snap["serve.batch_size.max"] == 3


def test_streaming_server_sojourns_are_stamped():
    ex = _ex(_cat(_exact_arrays()), telemetry=tm.Telemetry(enabled=False))
    srv = QueryServer(ex, streaming=True, morsel_rows=1 << 12)
    srv.submit(_scan_filter_sum(5, 60))
    srv.submit(_scan_filter_sum(5, 60))      # a dedup rider
    out = srv.drain()
    assert len(out) == 2
    for rec in srv.history:
        assert rec.t_complete > rec.t_submit
        assert rec.latency_s == pytest.approx(rec.t_complete - rec.t_submit)
    assert {r.path for r in srv.history} == {"stream", "dedup"}


# --------------------------------------------------------------------------- #
# parity: the same seeded sequence through the port's and the reference's
# servers

def _parity_arrays(seed=3):
    a = _kvw_arrays(seed=seed, x=True)
    a["dup"] = {"k": np.random.default_rng(seed + 1).integers(
        0, 1000, size=600).astype(np.int32)}
    return a


def _query_pool(Qc):
    """Every shape the server routes differently: micro-batchable single
    filters (sum / count / mean), unique and duplicate-keyed joins, two
    filters, and a Project root (at one range)."""
    def pool(kind, lo, hi):
        if kind == 0:
            return Qc.scan("big").filter("v", lo, hi).sum("w")
        if kind == 1:
            return Qc.scan("big").filter("v", lo, hi).count("w")
        if kind == 2:
            return Qc.scan("big").filter("v", lo, hi).mean("w")
        if kind == 3:
            return _join_sum(Qc, lo, hi)
        if kind == 4:
            return (Qc.scan("big").join(Qc.scan("dup"), on="k")
                      .filter("v", lo, hi).sum("w"))
        if kind == 5:
            return (Qc.scan("big").join(Qc.scan("small"), on="k")
                      .filter("v", lo, hi).filter("w", 5, 40).mean("w"))
        # one range: each distinct output size is a fresh compilation of
        # the reference's eager path
        return (Qc.scan("big").join(Qc.scan("small"), on="k")
                  .filter("v", 10, 60).project("k", "w", "x"))
    return pool


def _script(seed=5, rounds=4, per_round=5):
    """(kind, lo, hi, tenant) submissions by round; each round repeats
    one earlier submission, so dedup and cached paths are exercised."""
    r = np.random.default_rng(seed)
    out, seen = [], []
    for _ in range(rounds):
        batch = []
        for _ in range(per_round):
            lo = int(r.integers(0, 60))
            item = (int(r.integers(0, 7)), lo, lo + int(r.integers(5, 40)),
                    "hi" if r.random() < 0.3 else "lo")
            batch.append(item)
            seen.append(item)
        batch.append(seen[int(r.integers(0, len(seen)))])
        out.append(batch)
    return out


def _run_script(srv, Qc, tenants, streaming):
    pool = _query_pool(Qc)
    for spec in tenants:
        srv.register_tenant(spec)
    # one query first seeds the recent sojourns, so the strict SLO is
    # breached from the first round on
    srv.submit(pool(0, 0, 99), tenant="hi")
    srv.drain()
    results, qids = {}, []
    for batch in _script():
        for kind, lo, hi, tenant in batch:
            qids.append(srv.submit(pool(kind, lo, hi), tenant=tenant))
        if streaming:
            results.update(srv.pump())
            results.update(srv.pump())
        else:
            results.update(srv.drain())
    results.update(srv.drain())
    paths = {rec.qid: rec.path for rec in srv.history}
    return [results[q] for q in qids], [paths[q] for q in qids], srv.stats()


PARITY_COUNTERS = ("n_deduped", "n_microbatched", "n_streamed", "n_cached",
                   "n_subplan_shared", "n_microbatches",
                   "batched_kernel_cache_hits", "n_backpressured")


@pytest.mark.parametrize("cache_bytes", [32 << 20, None])
@pytest.mark.parametrize("streaming", [False, True])
def test_server_sequence_equals_the_reference(streaming, cache_bytes):
    a = _parity_arrays()
    kw = dict(streaming=streaming, morsel_rows=512)
    cache_kw = {"cache_bytes": cache_bytes} if cache_bytes else {}
    port = QueryServer(_ex(_cat(a), cost_model=CostModel(1), **cache_kw),
                       **kw)
    ref = RQueryServer(_ref_ex(a, **cache_kw), **kw)
    # backpressure, which only the streaming pump applies, is part of
    # the sequence: the strict SLO is always breached once a query ran
    got, got_paths, got_stats = _run_script(
        port, Q, [TenantSpec("hi", priority=5, slo_p95_s=1e-9),
                  TenantSpec("lo")], streaming)
    want, want_paths, want_stats = _run_script(
        ref, RQ, [RTenantSpec("hi", priority=5, slo_p95_s=1e-9),
                  RTenantSpec("lo")], streaming)
    assert got_paths == want_paths
    for g, w in zip(got, want):
        if hasattr(g, "columns"):
            assert set(g.columns) == set(w.columns)
            for c in g.columns:
                np.testing.assert_array_equal(g.column(c).numpy(),
                                              np.asarray(w.column(c)))
        elif isinstance(g, float):
            assert g == pytest.approx(float(w), rel=MEAN_RTOL)
        else:
            assert isinstance(g, int) and g == int(w), (g, w)
    for k in PARITY_COUNTERS:
        assert got_stats[k] == want_stats[k], k
    assert got_stats["n_streamed"] > 0 if streaming \
        else got_stats["n_microbatches"] > 0
    if streaming:
        assert got_stats["n_backpressured"] > 0


# --------------------------------------------------------------------------- #
# the group step: one probe a morsel, lanes equal to the lone step

def test_streaming_group_probes_once_a_morsel(monkeypatch):
    a = _kvw_arrays()
    calls = []
    real = join_kernels.probe_counts

    def counted(s_sorted, keys):
        calls.append(keys.shape[0])
        return real(s_sorted, keys)

    monkeypatch.setattr(join_kernels, "probe_counts", counted)
    srv = QueryServer(_ex(_cat(a)), streaming=True, morsel_rows=512)
    bounds = [(0, 20), (10, 50), (30, 90), (5, 6)]
    qids = [srv.submit(_join_sum(Q, lo, hi)) for lo, hi in bounds]
    per_pump = []
    while srv._inflight() or not per_pump:
        before = len(calls)
        srv.pump()
        per_pump.append(len(calls) - before)
    stream = srv._streams["big"]
    assert per_pump == [1] * stream.spec.n_morsels == [1] * 8
    res = {r.qid: r.result for r in srv.history}
    for qid, (lo, hi) in zip(qids, bounds):
        assert res[qid] == _sum_where(a["big"], lo, hi, _isin(a))


def _lane_arrays(seed=4, n=3000):
    r = np.random.default_rng(seed)
    return {"big": {"k": r.integers(0, 60, size=n).astype(np.int32),
                    "v": r.integers(-50, 50, size=n).astype(np.int32),
                    "f": r.normal(size=n).astype(np.float32)},
            "small": {"k": np.arange(0, 60, 3, dtype=np.int32)},
            "dup": {"k": r.integers(0, 60, size=200).astype(np.int32),
                    "y": r.integers(1, 9, size=200).astype(np.int32)}}


@pytest.mark.parametrize("build", ["small", "dup"])
@pytest.mark.parametrize("op", ["sum", "count", "mean"])
def test_group_step_lanes_equal_the_lone_step(op, build):
    """Each lane of ``group_step`` equals ``step`` on that query alone, bit
    for bit, float means included, with bounds past int32 and empty
    ranges among the lanes."""
    a = _lane_arrays()
    ex = _ex(_cat(a))
    col = "f" if op == "mean" else ("y" if build == "dup" else "f")
    bounds = [(-10, 10), (-2 ** 40, 3), (20, 2 ** 35), (5, -5), (0, 0),
              (-50, 49), (7, 30)]
    qs = [Q.scan("big").join(Q.scan(build), on="k").filter("v", lo, hi)
          .aggregate(op, col) for lo, hi in bounds]
    node, phys = ex.plan(qs[0].node)
    splan = pl.analyze(node, ex.catalog.stats)
    spec = ex.morsel_spec("big", 1024)
    cp, builds, _ = ex.stream_pipeline(node, phys, splan, spec)
    lits = [L.literals(ex.plan(q.node)[0]) for q in qs]
    lone = [cp.init_carry() for _ in qs]
    group = serve_mod._stack([cp.init_carry() for _ in qs])
    glits = serve_mod._lits_tensor(lits, ex.device)
    for i in range(spec.n_morsels):
        arrays, n_valid = ex._stream_morsel("big", cp.stream_cols, spec, i)
        lone = [cp.step(li, c, n_valid, *builds, *arrays)
                for li, c in zip(lits, lone)]
        group = cp.group_step(glits, group, n_valid, *builds, *arrays)
    for j, q in enumerate(qs):
        got = cp.finalize(serve_mod._lane(group, j))
        want = cp.finalize(lone[j])
        assert type(got) is type(want) and got == want, (bounds[j], got, want)
        assert want == ex.execute(q, mode="stream", morsel_rows=1024).value


def test_group_ranges_normalize_like_a_pair():
    r = np.random.default_rng(6)
    ints = torch.from_numpy(r.integers(-2 ** 31, 2 ** 31 - 1, size=500,
                                       dtype=np.int64).astype(np.int32))
    ints[:4] = torch.tensor([-2 ** 31, 2 ** 31 - 1, 0, -1],
                            dtype=torch.int32)
    floats = torch.from_numpy(r.normal(scale=1e3, size=500)
                              .astype(np.float32))
    pairs = [(-2 ** 40, 2 ** 40), (2 ** 31 - 1, 2 ** 33), (-2 ** 33,
                                                          -2 ** 31),
             (5, -5), (2 ** 32, 2 ** 34), (-2 ** 34, -2 ** 32), (0, 0),
             (-7, 700), (-2 ** 31, -2 ** 31)]
    lo = torch.tensor([[p[0]] for p in pairs], dtype=torch.int64)
    hi = torch.tensor([[p[1]] for p in pairs], dtype=torch.int64)
    for col in (ints, floats):
        got = engine.in_ranges(col, lo, hi)
        for j, (a, b) in enumerate(pairs):
            assert torch.equal(got[j], engine.in_range(col, a, b)), (a, b)


def test_microbatch_in_row_chunks_equals_execute(monkeypatch):
    """The micro-batch reduces in row chunks; its integer sums and counts
    equal the fused pipeline's, and a mean over a float column equals it
    bit for bit (one lane at a time, the pipeline's summation order)."""
    monkeypatch.setattr(serve_mod, "MIN_CHUNK_ROWS", 64)
    a = _lane_arrays()
    ex = _ex(_cat(a))
    srv = QueryServer(ex)
    bounds = [(-10, 10), (-2 ** 40, 3), (20, 2 ** 35), (5, -5), (0, 0)]
    qs = [Q.scan("big").filter("v", lo, hi).aggregate(op, c)
          for op, c in (("sum", "k"), ("count", "k"), ("mean", "f"),
                        ("sum", "f"))
          for lo, hi in bounds]
    qids = [srv.submit(q) for q in qs]
    res = srv.drain()
    assert srv.n_microbatched == len(qs) and srv.n_batches == 4
    for qid, q in zip(qids, qs):
        want = ex.execute(q).value
        assert type(res[qid]) is type(want) and res[qid] == want, q.node


# --------------------------------------------------------------------------- #
# record_plan(scale=) and the serving ledger against the reference

def test_record_plan_scale_and_serve_rows_equal_the_reference():
    a = _kvw_arrays()
    q, rq = _join_sum(Q, 10, 60), _join_sum(RQ, 10, 60)
    ex = _ex(_cat(a), cost_model=CostModel(1),
             telemetry=tm.Telemetry(enabled=True))
    rex = _ref_ex(a, telemetry=rtm.Telemetry(enabled=True))
    phys, rphys = ex.plan(q.node)[1], rex.plan(rq.node)[1]
    for led, p in ((ex.tel.ledger, phys), (rex.tel.ledger, rphys)):
        led.clear()
        led.record_plan(p, 0.5, 4e6, mode="serve", scale=0.125)
        led.record_plan(p, 0.5, 4e6, mode="serve")
    rows, rrows = ex.tel.ledger.rows, rex.tel.ledger.rows
    key = [(r.op, r.mode, r.attributed, r.predicted_bytes, r.measured_bytes,
            r.table, r.column) for r in rows]
    assert key == [(r.op, r.mode, r.attributed, r.predicted_bytes,
                    r.measured_bytes, r.table, r.column) for r in rrows]
    n = len(rows) // 2
    for scaled, whole in zip(rows[:n], rows[n:]):
        assert scaled.predicted_bytes == whole.predicted_bytes * 0.125
        assert scaled.predicted_s == whole.predicted_s * 0.125
    assert sum(r.measured_s for r in rows[:n]) == pytest.approx(0.5)
    # a streaming server's feed: the same rows, one set a warm advance
    ex.tel.ledger.clear()
    rex.tel.ledger.clear()
    for srv, Qc in ((QueryServer(ex, streaming=True, morsel_rows=512), Q),
                    (RQueryServer(rex, streaming=True, morsel_rows=512), RQ)):
        srv.submit(_join_sum(Qc, 10, 60))
        srv.submit(_join_sum(Qc, 0, 30))
        srv.drain()
    serve = [(r.op, r.predicted_bytes) for r in ex.tel.ledger.rows
             if r.mode == "serve"]
    assert serve and serve == [(r.op, r.predicted_bytes)
                               for r in rex.tel.ledger.rows
                               if r.mode == "serve"]


# --------------------------------------------------------------------------- #
# the device rule, failures, fences, tiers

def test_server_runs_on_the_executor_device():
    """The server adds no device knob: without a card an executor that
    names no device refuses, and one given the CPU serves there."""
    a = _kvw_arrays()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            QueryServer(Executor(_cat(a)))
    srv = QueryServer(_ex(_cat(a)), streaming=True, morsel_rows=1024)
    srv.submit(_join_sum())
    (value,) = srv.drain().values()
    assert value == _sum_where(a["big"], 30, 49, _isin(a))


def test_a_failing_group_step_makes_the_pump_raise(monkeypatch):
    def broken(s_sorted, keys):
        raise RuntimeError("probe failed")

    srv = QueryServer(_ex(_cat(_kvw_arrays())), streaming=True,
                      morsel_rows=512)
    srv.submit(_join_sum(Q, 0, 10))
    srv.submit(_join_sum(Q, 20, 30))
    monkeypatch.setattr(join_kernels, "probe_counts", broken)
    with pytest.raises(RuntimeError, match="probe failed"):
        srv.pump()


def test_serving_fences_only_with_telemetry(monkeypatch):
    calls = []
    monkeypatch.setattr(pexec, "_fence", calls.append)
    for enabled in (False, True):
        ex = _ex(_cat(_kvw_arrays()),
                 telemetry=tm.Telemetry(enabled=enabled))
        srv = QueryServer(ex, streaming=True, morsel_rows=512)
        srv.submit(_join_sum(Q, 10, 60))
        srv.submit(Q.scan("big").filter("v", 3, 9).project("k", "w"))
        srv.drain()
        assert bool(calls) == enabled


def test_streaming_from_the_host_tier_counts_promotions(tmp_path):
    a = _kvw_arrays()
    cat = _cat(a)
    cat.tables["big"].demote_column("w", "host", str(tmp_path))
    cat.tables["big"].demote_column("v", "disk", str(tmp_path))
    ex = _ex(cat, telemetry=tm.Telemetry(enabled=True))
    srv = QueryServer(ex, streaming=True, morsel_rows=1000)
    srv.submit(_join_sum(Q, 10, 60))
    srv.submit(_join_sum(Q, 5, 15))
    res = srv.drain()
    assert sorted(res.values()) == sorted(
        [_sum_where(a["big"], 10, 60, _isin(a)),
         _sum_where(a["big"], 5, 15, _isin(a))])
    st = ex.stats_dict()
    assert st["promote_bytes_host"] == st["promote_bytes_disk"] == 4096 * 4
