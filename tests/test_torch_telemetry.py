"""The port's query telemetry against the JAX reference, on the CPU.

Ports the invariants of ``tests/test_telemetry.py`` (the server sojourn
cases wait for the port's ``serve.py``): the disabled path records and
fences nothing, the Chrome trace's schema and nesting, ``drift_bytes``
of 1.0 on every eager operator of a plan whose estimates are exact, the
fused / streamed ledger and the morsel metrics, the calibration overlay
keyed by the port's impl labels, and the executor's consolidated
counters.  Then parity: on the same numpy columns the port's eager ledger
rows (op, predicted and measured bytes, drift, mode, attribution) equal
the reference's exactly, its fused and streamed rows match in count and
attribution, and the selectivity corrections ``recost`` folds in, with
the estimates they lead to, equal the reference's.  Traced results equal
untraced ones bit for bit in every mode, spilled too.  Last, the UDF
registry and ``sql_like_query`` against the reference's.  The reference
runs on an Auto-axis mesh.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.columnar import udf as rudf
from repro.columnar.table import Table as RTable
from repro.core.sgd_glm import HyperParams as RHyperParams
from repro.query import Catalog as RCatalog, CostModel as RCostModel
from repro.query import Executor as RExecutor, Q as RQ
from repro.query import cost as rcost
from repro.query import telemetry as rtm

from repro_torch.columnar import engine, udf
from repro_torch.convert import catalog_from_arrays
from repro_torch.query import (
    CostModel, Executor, HyperParams, Q, TierBudgets, estimate_rows,
)
from repro_torch.query import cost
from repro_torch.query import exec as pexec
from repro_torch.query import telemetry as tm

MODES = ("batch", "stream", "eager")


def _auto_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()).reshape(1, -1),
                             ("data", "model"))


def _exact_arrays(n=1 << 14, domain=128):
    """``v`` cycles 0..domain-1, every value equally frequent (n a multiple
    of the domain), so a range predicate's uniform-domain estimate is
    exact and every eager operator's drift_bytes is 1.0."""
    return {"t": {"v": (np.arange(n) % domain).astype(np.int32),
                  "w": np.ones(n, np.int32)}}


def _port(arrays, tel=None, **kw):
    return Executor(catalog_from_arrays(arrays, "cpu"), device="cpu",
                    cost_model=CostModel(1),
                    telemetry=tel if tel is not None
                    else tm.Telemetry(enabled=False), **kw)


def _ref(arrays, tel):
    return RExecutor(RCatalog.from_tables(*(RTable.from_arrays(t, c)
                                            for t, c in arrays.items())),
                     mesh=_auto_mesh(),
                     cost_model=RCostModel(1, calibration=None),
                     telemetry=tel)


def _scan_filter_sum(Qc=Q, lo=10, hi=41):
    return Qc.scan("t", ("v", "w")).filter("v", lo, hi).sum("w")


def _walk(p):
    yield p
    for c in p.children:
        yield from _walk(c)


# --------------------------------------------------------------------------- #
# the disabled path

def test_disabled_records_nothing():
    tel = tm.Telemetry(enabled=False)
    ex = _port(_exact_arrays(1 << 12), tel)
    for _ in range(3):
        for mode in MODES:
            ex.execute(_scan_filter_sum(), mode=mode)
    assert tel.tracer.events == []
    assert tel.ledger.rows == []
    assert tel.tracer.dropped == 0


def test_disabled_span_is_shared_singleton():
    tel = tm.Telemetry(enabled=False)
    spans = {id(tel.span("a")), id(tel.span("b", k=1)), id(tm.NULL_SPAN)}
    assert len(spans) == 1


def test_disabled_no_container_growth():
    tel = tm.Telemetry(enabled=False)
    ex = _port(_exact_arrays(1 << 12), tel)
    ex.execute(_scan_filter_sum())
    sizes = (len(tel.tracer.events), len(tel.ledger.rows))
    for i in range(10):
        ex.execute(_scan_filter_sum(lo=1, hi=20 + i))
    assert (len(tel.tracer.events), len(tel.ledger.rows)) == sizes


def _glm_arrays(m=600, d=6, seed=3):
    r = np.random.default_rng(seed)
    cols = {f"f{j}": (r.random(m) * (r.random(m) < 0.4)).astype(np.float32)
            for j in range(d)}
    cols["y"] = (r.random(m) < 0.4).astype(np.float32)
    cols["k"] = np.arange(m, dtype=np.int32)
    return {"train": cols}


def _train_q(Qc=Q, HP=HyperParams, lo=None, hi=None, d=6):
    q = Qc.scan("train")
    if lo is not None:
        q = q.filter("k", lo, hi)
    return q.train_glm([f"f{j}" for j in range(d)], "y",
                       [HP(0.05, 0.0), HP(0.01, 0.001)], epochs=2)


def _join_arrays(seed=4, n=4096):
    r = np.random.default_rng(seed)
    return {"big": {"k": r.integers(0, 1000, size=n).astype(np.int32),
                    "v": r.integers(0, 100, size=n).astype(np.int32),
                    "w": r.integers(1, 50, size=n).astype(np.int32)},
            "small": {"k": np.asarray(r.choice(1000, size=512,
                                               replace=False), np.int32)},
            "dup": {"k": r.integers(0, 50, size=256).astype(np.int32)}}


def _fence_sites(spill_dir):
    """(executor, query, execute kwargs) for every path that fences when
    traced: batch, stream, eager, streamed and eager training, and a
    spilled aggregate and project root (promotions)."""
    glm = _glm_arrays()
    arrays = _join_arrays()
    budget = TierBudgets(device=arrays["big"]["k"].nbytes)
    return [
        (lambda tel: _port(arrays, tel),
         Q.scan("big").filter("v", 5, 60).join(Q.scan("small"), on="k")
         .sum("w"), kw) for kw in ({"mode": "batch"}, {"mode": "stream"},
                                   {"mode": "eager"})
    ] + [
        (lambda tel: _port(glm, tel), _train_q(), {"mode": m})
        for m in ("batch", "eager")
    ] + [
        (lambda tel: _port(glm, tel), _train_q(lo=10, hi=400),
         {"mode": "stream"}),
        (lambda tel: _port(arrays, tel, tier_budgets=budget),
         Q.scan("big").filter("v", 5, 60).sum("w"), {}),
        (lambda tel: _port(arrays, tel, tier_budgets=budget),
         Q.scan("big").filter("v", 5, 60).project("k", "w"), {}),
    ]


def test_disabled_path_never_fences(monkeypatch, tmp_path):
    """With telemetry off the fence helper (made to raise) is never
    reached on any path; with it on, every path reaches it — so the
    helper patched is the one the executor calls."""
    monkeypatch.setenv("REPRO_SPILL_DIR", str(tmp_path))
    calls = []

    def fence(device):
        if not calls:
            raise AssertionError("fenced with telemetry disabled")
        calls.append(device)

    monkeypatch.setattr(pexec, "_fence", fence)
    for make, q, kw in _fence_sites(tmp_path):
        make(tm.Telemetry(enabled=False)).execute(q, **kw)
    calls.append(None)
    for make, q, kw in _fence_sites(tmp_path):
        before = len(calls)
        make(tm.Telemetry(enabled=True)).execute(q, **kw)
        assert len(calls) > before, (q.node, kw)


# --------------------------------------------------------------------------- #
# the Chrome trace

def _interval(e):
    return e["ts"], e["ts"] + e["dur"]


def _contains(outer, inner, slack=1.0):
    o0, o1 = _interval(outer)
    i0, i1 = _interval(inner)
    return o0 - slack <= i0 and i1 <= o1 + slack


def test_chrome_trace_schema_and_nesting(tmp_path):
    tel = tm.Telemetry(enabled=True)
    ex = _port(_exact_arrays(1 << 12), tel)
    ex.execute(_scan_filter_sum())
    ex.execute(_scan_filter_sum(lo=3), mode="eager")
    path = tel.export_chrome(str(tmp_path / "trace.json"))
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    assert doc["displayTimeUnit"] == "ms"
    assert events
    for e in events:
        assert set(("name", "ph", "pid", "tid", "ts")) <= set(e)
        assert e["ph"] in ("X", "i")
        if e["ph"] == "X":
            assert e["dur"] >= 0.0
    by_name = {}
    for e in events:
        by_name.setdefault(e["name"], []).append(e)
    execute = by_name["exec.execute"][0]
    plan = by_name["exec.plan"][0]
    for name in ("exec.optimize", "exec.cost_physical"):
        assert _contains(plan, by_name[name][0])
    assert _contains(execute, plan)
    assert execute["args"]["path"] == "batch"
    assert _contains(execute, by_name["exec.run_fused"][0])
    eager = by_name["exec.execute"][1]
    assert eager["args"]["path"] == "eager"
    ops = [e for e in events if e["name"].startswith("op.")]
    assert sorted(e["name"] for e in ops) \
        == ["op.aggregate", "op.filter", "op.scan"]
    assert all(_contains(eager, e) for e in ops)


def test_trace_bounded_by_max_events():
    tel = tm.Telemetry(enabled=True)
    tel.tracer.max_events = 10
    for i in range(25):
        tel.instant("e", i=i)
    assert len(tel.tracer.events) == 10
    assert tel.tracer.dropped == 15
    assert tel.tracer.chrome_trace()["otherData"]["dropped_events"] == 15


# --------------------------------------------------------------------------- #
# the bandwidth ledger

def test_eager_ledger_drift_bytes_exact():
    """On exact-estimate data every costed operator's eager row has
    drift_bytes == 1.0 (the reference test's table: scan 131,072 bytes,
    filter 81,920, aggregate 16,384)."""
    tel = tm.Telemetry(enabled=True)
    arrays = _exact_arrays()
    ex = _port(arrays, tel)
    q = _scan_filter_sum()
    r = ex.execute(q, mode="eager")
    v = arrays["t"]["v"]
    assert r.value == int(((v >= 10) & (v <= 41)).sum())
    phys_ops = sorted(p.op for p in _walk(ex.plan(q.node)[1]))
    assert sorted(row.op for row in tel.ledger.rows) == phys_ops
    assert {row.op: row.measured_bytes for row in tel.ledger.rows} \
        == {"scan": 131072.0, "filter": 81920.0, "aggregate": 16384.0}
    for row in tel.ledger.rows:
        assert row.mode == "eager" and not row.attributed
        assert row.drift_bytes == pytest.approx(1.0, rel=1e-6), row.op
        assert row.measured_s >= 0.0
        assert row.predicted_s > 0.0


def test_fused_ledger_covers_every_costed_operator():
    tel = tm.Telemetry(enabled=True)
    ex = _port(_exact_arrays(1 << 12), tel)
    q = _scan_filter_sum()
    ex.execute(q)
    n_ops = len(list(_walk(ex.plan(q.node)[1])))
    fused = [r for r in tel.ledger.rows if r.mode == "fused"]
    assert len(fused) == n_ops
    assert all(r.attributed for r in fused)
    assert all(r.measured_bytes > 0 for r in fused)
    # the pipeline moved both columns once: the rows share it out
    assert sum(r.measured_bytes for r in fused) \
        == pytest.approx(2 * 4 * (1 << 12))


def test_stream_ledger_and_morsel_metrics():
    tel = tm.Telemetry(enabled=True)
    arrays = _exact_arrays()
    ex = _port(arrays, tel)
    r = ex.execute(_scan_filter_sum(lo=0, hi=63), mode="stream",
                   morsel_rows=1 << 12)
    v = arrays["t"]["v"]
    assert r.value == int(((v >= 0) & (v <= 63)).sum())
    assert r.mode == "stream"
    streamed = [row for row in tel.ledger.rows
                if row.mode == "stream" and row.op != "promote"]
    assert streamed and all(row.attributed for row in streamed)
    snap = ex.metrics_snapshot()
    assert snap["pipeline.morsels"] == 4
    assert snap["pipeline.transfer_wait_s"] >= 0.0
    assert snap["pipeline.compute_s"] > 0.0
    assert snap["pipeline.morsel_step_s.count"] == 4
    names = {e["name"] for e in tel.tracer.events}
    assert {"pipeline.morsel_wait", "pipeline.morsel_step",
            "exec.run_stream"} <= names


def test_calibration_overlay_feeds_cost_model():
    """The overlay is keyed by the port's impl label, so the model it is
    applied to takes it (an ``xla`` key would be skipped silently)."""
    tel = tm.Telemetry(enabled=True)
    ex = _port(_exact_arrays(1 << 12), tel)
    ex.execute(_scan_filter_sum(), mode="eager")
    overlay = tel.ledger.calibration_overlay(ex.cost_model)
    assert overlay["backend"] == "ledger"
    assert set(overlay["backends"]) == {"torch"}
    b = overlay["backends"]["torch"]
    assert 0.0 < b["stream_eff"] <= 1.0
    model = CostModel(ex.cost_model.n_engines, calibration=overlay)
    assert model.calibrated_from == "ledger"
    assert model.stream_eff["torch"] == pytest.approx(b["stream_eff"])
    epoch = ex.cost_epoch
    assert ex.recost(overlay) == epoch + 1
    assert ex.cost_model.stream_eff["torch"] == pytest.approx(
        b["stream_eff"])
    prices = [p.cost_s for p in _walk(ex.plan(_scan_filter_sum().node)[1])]
    ex.recost(overlay)
    assert [p.cost_s for p in _walk(ex.plan(_scan_filter_sum().node)[1])] \
        == prices
    assert ex.stats_dict()["recost_count"] == 2
    assert ex.metrics.value("exec.cost_epoch") == epoch + 2


def test_drift_report_and_top_drift():
    tel = tm.Telemetry(enabled=True)
    ex = _port(_exact_arrays(1 << 12), tel)
    ex.execute(_scan_filter_sum(), mode="eager")
    rep = tel.ledger.report()
    for op in ("scan", "filter", "aggregate"):
        assert op in rep
    top = tel.ledger.top_drift(2)
    assert len(top) == 2
    assert abs(top[0]["drift_time"] - 1.0) >= \
        abs(top[1]["drift_time"] - 1.0)
    assert tm.Telemetry(enabled=True).ledger.report() \
        == "bandwidth ledger: no measurements recorded"


def test_window_drift_and_bytes_by_tier(monkeypatch, tmp_path):
    """A spilled run's promotions get op="promote" rows from the host
    tier whose bytes are the demoted columns' (the padded tail of the
    last morsel is not promoted data), and the overlay turns them into
    ``h2d_gbps``; ``window_drift`` advances its cursor."""
    monkeypatch.setenv("REPRO_SPILL_DIR", str(tmp_path))
    tel = tm.Telemetry(enabled=True)
    arrays = _join_arrays()
    col = arrays["big"]["k"].nbytes
    ex = _port(arrays, tel, tier_budgets=TierBudgets(device=col))
    q = Q.scan("big").filter("v", 5, 60).sum("w")
    ex.reset_metrics()
    ex.execute(q, morsel_rows=1000)
    host = sum(1 for t in ex.last_spill.tiers.values() if t == "host")
    assert host >= 1
    promoted = [r for r in tel.ledger.rows if r.op == "promote"]
    assert [r.tier for r in promoted] == ["host"]
    assert promoted[0].measured_bytes == host * col
    assert ex.stats_dict()["promote_bytes_host"] == host * col
    assert ex.stats_dict()["spilled_columns"] == host
    tiers = tel.ledger.bytes_by_tier()
    assert tiers["host"]["bytes"] == host * col
    assert tiers["host"]["n"] == 1
    overlay = tel.ledger.calibration_overlay(ex.cost_model)
    assert overlay["h2d_gbps"] > 0
    agg, cursor = tel.ledger.window_drift(0)
    assert cursor == len(tel.ledger.rows) and "torch" in agg
    assert tel.ledger.window_drift(cursor) == (None, cursor)


# --------------------------------------------------------------------------- #
# the executor's counters

def test_counters_consolidated_with_backcompat_names():
    tel = tm.Telemetry(enabled=False)
    ex = _port(_exact_arrays(1 << 12), tel)
    q = _scan_filter_sum()
    ex.execute(q)
    ex.execute(q)
    assert ex.cache_misses == 1 and ex.cache_hits == 1
    assert ex.trace_count == 1
    assert ex.metrics.value("exec.plan_cache_misses") == 1
    assert ex.metrics.value("exec.plan_cache_hits") == 1
    ex.cache_hits += 1
    assert ex.metrics.value("exec.plan_cache_hits") == 2
    snap = ex.metrics_snapshot()
    assert snap["exec.plan_cache_hits"] == 2
    ex.reset_metrics()
    assert ex.cache_hits == 0 and ex.cache_misses == 0
    sd = ex.stats_dict()
    assert sd["plan_cache_hits"] == 0
    assert "trace_count" in sd and sd["cost_epoch"] == 0


def test_private_registries_do_not_mix():
    arrays = _exact_arrays(1 << 12)
    tel = tm.Telemetry(enabled=False)
    ex1, ex2 = _port(arrays, tel), _port(arrays, tel)
    ex1.execute(_scan_filter_sum())
    assert ex1.cache_misses == 1
    assert ex2.cache_misses == 0


def test_metrics_registry_snapshot_and_histograms():
    m = tm.MetricsRegistry()
    m.inc("a")
    m.inc("a", 4)
    m.set("g", 7)
    for x in (1.0, 2.0, 3.0, 4.0):
        m.observe("h", x)
    snap = m.snapshot()
    assert snap["a"] == 5 and snap["g"] == 7
    assert snap["h.count"] == 4
    assert snap["h.mean"] == pytest.approx(2.5)
    assert snap["h.max"] == 4.0
    m.reset()
    assert m.snapshot() == {}


def test_global_telemetry_swap(monkeypatch):
    tel = tm.Telemetry(enabled=True)
    tm.set_global(tel)
    try:
        assert tm.get() is tel
        ex = Executor(catalog_from_arrays(_exact_arrays(1 << 12), "cpu"),
                      device="cpu")
        assert ex.tel is tel
    finally:
        tm.set_global(None)
    monkeypatch.setenv("REPRO_TRACE", "1")
    assert tm.get().enabled and tm.trace_enabled()
    tm.set_global(None)
    monkeypatch.setenv("REPRO_TRACE", "0")
    assert not tm.get().enabled
    tm.set_global(None)


# --------------------------------------------------------------------------- #
# parity with the reference

def _parity_cases():
    """(arrays, port query, reference query): the four eager shapes."""
    big = _join_arrays()
    return {
        "scan_filter_sum": (_exact_arrays(), _scan_filter_sum(),
                            _scan_filter_sum(RQ)),
        "join_unique": (big, *[Qc.scan("big").filter("v", 5, 60)
                               .join(Qc.scan("small"), on="k").sum("w")
                               for Qc in (Q, RQ)]),
        "join_duplicate": (big, *[Qc.scan("big").filter("v", 5, 60)
                                  .join(Qc.scan("dup"), on="k").sum("w")
                                  for Qc in (Q, RQ)]),
        "train_glm": (_glm_arrays(), _train_q(),
                      _train_q(RQ, RHyperParams)),
    }


def _both(name, mode):
    arrays, q, rq = _parity_cases()[name]
    tel, rtel = tm.Telemetry(enabled=True), rtm.Telemetry(enabled=True)
    port, ref = _port(arrays, tel), _ref(arrays, rtel)
    got = port.execute(q, mode=mode).value
    want = ref.execute(rq, mode=mode).value
    return tel.ledger.rows, rtel.ledger.rows, got, want


def _values_equal(got, want):
    if isinstance(got, tuple):               # GLM (weights, losses)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-5, atol=1e-6)
    else:
        assert got == want


@pytest.mark.parametrize("name", ["scan_filter_sum", "join_unique",
                                  "join_duplicate", "train_glm"])
def test_eager_ledger_rows_equal_reference(name):
    rows, rrows, got, want = _both(name, "eager")
    _values_equal(got, want)

    def key(r):
        return (r.op, r.predicted_bytes, r.measured_bytes, r.drift_bytes,
                r.mode, r.attributed)

    assert rows and [key(r) for r in rows] == [key(r) for r in rrows]
    if name == "scan_filter_sum":
        assert all(r.drift_bytes == 1.0 for r in rows)


@pytest.mark.parametrize("mode", ["batch", "stream"])
@pytest.mark.parametrize("name", ["scan_filter_sum", "join_unique",
                                  "join_duplicate", "train_glm"])
def test_pipeline_ledger_rows_match_reference(name, mode):
    rows, rrows, got, want = _both(name, mode)
    _values_equal(got, want)
    assert [(r.op, r.mode, r.attributed, r.predicted_bytes)
            for r in rows] == [(r.op, r.mode, r.attributed,
                                r.predicted_bytes) for r in rrows]
    assert all(r.attributed for r in rows)


def _skewed_arrays(n=8192, seed=11):
    """90% of ``v`` in 0..9 of a 0..999 domain: the uniform estimate of a
    range over the dense head is far off."""
    r = np.random.default_rng(seed)
    v = np.where(r.random(n) < 0.9, r.integers(0, 10, n),
                 r.integers(0, 1000, n)).astype(np.int32)
    return {"t": {"v": v, "w": r.integers(1, 9, n).astype(np.int32)}}


@pytest.mark.parametrize("mode", ["batch", "stream"])
def test_selectivity_corrections_and_recost_match_reference(mode):
    arrays = _skewed_arrays()
    tel, rtel = tm.Telemetry(enabled=True), rtm.Telemetry(enabled=True)
    port, ref = _port(arrays, tel), _ref(arrays, rtel)
    for lo, hi in ((0, 9), (0, 99)):
        assert port.execute(_scan_filter_sum(Q, lo, hi), mode=mode).value \
            == ref.execute(_scan_filter_sum(RQ, lo, hi), mode=mode).value
    corr = tel.ledger.selectivity_corrections()
    rcorr = rtel.ledger.selectivity_corrections()
    assert set(corr) == set(rcorr) == {("t", "v")}
    for k in corr:
        assert corr[k] == pytest.approx(rcorr[k], rel=1e-12)
    assert port.recost({}) == ref.recost({}) == 1
    assert port.cost_model.sel_corrections.keys() \
        == ref.cost_model.sel_corrections.keys()
    for lo, hi in ((0, 9), (0, 99), (500, 999)):
        node = _scan_filter_sum(Q, lo, hi).node.child
        rnode = _scan_filter_sum(RQ, lo, hi).node.child
        got = estimate_rows(node, port.catalog.stats,
                            port.cost_model.sel_corrections)
        want = rcost.estimate_rows(rnode, ref.catalog.stats,
                                   ref.cost_model.sel_corrections)
        assert got == pytest.approx(want, rel=1e-12)
        assert got != estimate_rows(node, port.catalog.stats)
        # and the next plan is priced with the corrected estimate
        assert port.plan(node)[1].est_rows_out == pytest.approx(got,
                                                                rel=1e-12)


@pytest.mark.parametrize("factor", [0.01, 0.25, 0.7, 1.0, 3.0, 4.0, 50.0])
def test_clamped_correction_matches_reference(factor):
    assert cost.SEL_CORRECTION_CLAMP == rcost.SEL_CORRECTION_CLAMP
    assert cost.clamp_correction(factor) == rcost.clamp_correction(factor)
    arrays = _skewed_arrays()
    port = _port(arrays)
    ref = _ref(arrays, rtm.Telemetry(enabled=False))
    corrections = {("t", "v"): factor}
    got = estimate_rows(_scan_filter_sum(Q, 0, 99).node.child,
                        port.catalog.stats, corrections)
    want = rcost.estimate_rows(_scan_filter_sum(RQ, 0, 99).node.child,
                               ref.catalog.stats, corrections)
    assert got == pytest.approx(want, rel=1e-12)


# --------------------------------------------------------------------------- #
# tracing changes no result

def _untraced_and_traced(make, q, **kw):
    off = make(tm.Telemetry(enabled=False)).execute(q, **kw).value
    tel = tm.Telemetry(enabled=True)
    on = make(tel).execute(q, **kw).value
    assert tel.ledger.rows
    return off, on


@pytest.mark.parametrize("mode", MODES)
def test_traced_results_equal_untraced(mode):
    arrays = _join_arrays()
    for q in (Q.scan("big").filter("v", 5, 60).join(Q.scan("dup"), on="k")
              .sum("w"),
              Q.scan("big").filter("v", 5, 60).join(Q.scan("small"), on="k")
              .mean("w")):
        off, on = _untraced_and_traced(lambda t: _port(arrays, t), q,
                                       mode=mode)
        assert off == on and type(off) is type(on)
    glm = _glm_arrays()
    for q in (_train_q(), _train_q(lo=10, hi=400)):
        off, on = _untraced_and_traced(lambda t: _port(glm, t), q,
                                       mode=mode)
        assert torch.equal(off[0], on[0]) and torch.equal(off[1], on[1])


def test_traced_spilled_results_equal_untraced(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_SPILL_DIR", str(tmp_path))
    arrays = _join_arrays()
    budget = TierBudgets(device=arrays["big"]["k"].nbytes,
                         host=arrays["big"]["k"].nbytes)
    for q in (Q.scan("big").filter("v", 5, 60).join(Q.scan("small"), on="k")
              .sum("w"),
              Q.scan("big").filter("v", 5, 60).project("k", "w")):
        off, on = _untraced_and_traced(
            lambda t: _port(arrays, t, tier_budgets=budget), q)
        if isinstance(off, int):
            assert off == on
        else:
            for c in ("k", "w"):
                assert torch.equal(off.column(c), on.column(c))
    glm = _glm_arrays()
    col = glm["train"]["f0"].nbytes
    tel = tm.Telemetry(enabled=True)
    spilled = _port(glm, tel, tier_budgets=TierBudgets(device=3 * col,
                                                       host=2 * col))
    xs, _ = spilled.execute(_train_q()).value
    assert torch.equal(xs, _port(glm).execute(_train_q()).value[0])
    tiers = set(spilled.last_spill.tiers.values())
    assert tiers == {"device", "host", "disk"}
    promoted = {r.tier: r.measured_bytes for r in tel.ledger.rows
                if r.op == "promote"}
    assert set(promoted) == {"host", "disk"}
    stats = spilled.stats_dict()
    assert stats["promote_bytes_host"] == promoted["host"] > 0
    assert stats["promote_bytes_disk"] == promoted["disk"] > 0


def test_train_ledger_row_counts_the_epochs_bytes():
    tel = tm.Telemetry(enabled=True)
    glm = _glm_arrays()
    ex = _port(glm, tel)
    ex.execute(_train_q(), mode="stream", morsel_rows=128)
    row = next(r for r in tel.ledger.rows if r.op == "train_glm")
    assert row.mode == "stream" and row.attributed
    names = [e["name"] for e in tel.tracer.events]
    assert "exec.run_train" in names
    span = next(e for e in tel.tracer.events
                if e["name"] == "exec.run_train")
    # rows x 4 bytes x (6 features + label) x 2 epochs x 2 jobs
    assert span["args"]["measured_bytes"] == 600 * 4 * 7 * 2 * 2


# --------------------------------------------------------------------------- #
# the UDF entry point

def test_udf_registry_matches_reference():
    assert udf.registered() == rudf.registered()


def _udf_arrays(seed=5, n=4096, n_small=512):
    r = np.random.default_rng(seed)
    return {"big": {"k": r.integers(0, 1000, size=n).astype(np.int32),
                    "v": r.integers(0, 100, size=n).astype(np.int32),
                    "w": r.integers(1, 50, size=n).astype(np.int32)},
            "small": {"k": np.asarray(r.choice(1000, size=n_small,
                                               replace=False), np.int32)}}


def test_sql_like_query_matches_reference():
    arrays = _udf_arrays()
    port, ref = _port(arrays), _ref(arrays, rtm.Telemetry(enabled=False))
    got = udf.call("sql_like_query", port,
                   Q.scan("big").filter("v", 5, 25).sum("w"))
    want = rudf.call("sql_like_query", ref,
                     RQ.scan("big").filter("v", 5, 25).sum("w"))
    v, w = arrays["big"]["v"], arrays["big"]["w"]
    assert got == want == int(w[(v >= 5) & (v <= 25)].sum())
    assert udf.call("sql_like_query", port,
                    Q.scan("big").filter("v", 5, 25).sum("w"),
                    mode="eager") == want


def test_handwritten_engine_sequence_matches_reference():
    """The DSL query, the hand-written UDF sequence of
    ``examples/analytics_pipeline.py`` and the reference agree."""
    arrays = _udf_arrays(6)
    port, ref = _port(arrays), _ref(arrays, rtm.Telemetry(enabled=False))
    q = (Q.scan("big").join(Q.scan("small"), on="k")
         .filter("v", 30, 49).sum("w"))
    rq = (RQ.scan("big").join(RQ.scan("small"), on="k")
          .filter("v", 30, 49).sum("w"))
    want = ref.execute(rq).value
    p = port.plans["partitioned"]
    placed = port.catalog.tables["big"].place(p)
    sel = udf.call("select_range", placed, "v", 30, 49)
    filtered = engine.gather(placed, sel.column("idx"), ["k", "w"],
                             name="filtered").place(p)
    j = udf.call("join", filtered, port.catalog.tables["small"], "k")
    proj = engine.gather(filtered, j.column("l_idx"), ["w"])
    assert port.execute(q).value == want \
        == udf.call("aggregate_sum", proj, "w")
