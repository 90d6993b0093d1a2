"""The port's memory tiers and spill execution against the JAX reference,
on the CPU.

Mirrors the invariants of ``tests/test_tiering.py``: the spill planner
fills the tiers in order, hottest first, after the reserved build bytes,
and reports overflow; tier pricing is monotone down the hierarchy; an
over-budget working set is demoted to host and to disk and streamed
back, and every spilled aggregate, project root and training set equals
the unspilled run and the reference bit for bit, across a repeat and a
mutation; the whole-hierarchy overflow and the capacity error say what
is wrong.  ``plan_spill``'s assignments and prices are held against the
reference's with both cost models given one overlay through
``repro_torch.convert``.  The reference runs on an Auto-axis mesh.
"""
import os
import threading

import jax
import numpy as np
import pytest
import torch

from repro.columnar.table import Table as RTable
from repro.core.sgd_glm import HyperParams as RHyperParams
from repro.query import Catalog as RCatalog, CostModel as RCostModel
from repro.query import Executor as RExecutor, Q as RQ
from repro.query import TierBudgets as RTierBudgets, plan_spill as r_plan_spill

from repro_torch import convert
from repro_torch.columnar.table import Table
from repro_torch.convert import catalog_from_arrays
from repro_torch.query import (
    TIERS, CostModel, Executor, HyperParams, PlacementCapacityError, Q,
    TierBudgets, plan_spill,
)
from repro_torch.query import pipeline as pl


def _auto_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()).reshape(1, -1),
                             ("data", "model"))


def _arrays(seed=0xA11, n=4096):
    r = np.random.default_rng(seed)
    return {"big": {"k": r.integers(0, 1000, size=n).astype(np.int32),
                    "v": r.integers(0, 100, size=n).astype(np.int32),
                    "w": r.integers(1, 50, size=n).astype(np.int32)},
            "small": {"k": np.asarray(r.choice(1000, size=512,
                                               replace=False), np.int32)}}


def _ref(arrays, **kw):
    return RExecutor(RCatalog.from_tables(*(RTable.from_arrays(t, c)
                                            for t, c in arrays.items())),
                     mesh=_auto_mesh(),
                     cost_model=RCostModel(1, calibration=None), **kw)


def _port(arrays, **kw):
    return Executor(catalog_from_arrays(arrays, "cpu"), device="cpu",
                    cost_model=CostModel(1), **kw)


@pytest.fixture
def spill_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_SPILL_DIR", str(tmp_path))
    return tmp_path


# ---- the spill planner, against the reference --------------------------- #

_OVERLAY = {"backend": "test", "h2d_gbps": 12.0, "disk_gbps": 1.25,
            "backends": {"xla": {"stream_eff": 0.5}}}

_SPILL_CASES = [
    # (columns with bytes, budgets (device, host, disk), reserved, heat)
    ([("a", 100), ("b", 100), ("c", 100)], (100, 100, None), 0, None),
    ([("a", 1 << 30)], (None, None, None), 0, None),
    ([("cold", 100), ("hot", 100)], (100, None, None), 0, {"hot": 5.0}),
    ([("a", 80)], (100, None, None), 50, None),
    ([("a", 100)], (10, 10, 10), 0, None),
    ([("a", 300), ("b", 70), ("c", 200), ("d", 5)], (260, 280, None), 4,
     {"d": 1.0}),
    ([(f"c{i}", 240_000) for i in range(12)], (1 << 20, 1 << 20, None),
     0, None),
]


@pytest.mark.parametrize("cols,budgets,reserved,heat", _SPILL_CASES)
def test_plan_spill_matches_reference(cols, budgets, reserved, heat):
    rm = RCostModel(1, calibration=_OVERLAY)
    pm = CostModel(1, impl="cuda", calibration=convert.
                   calibration_from_reference(rm.calibration_snapshot()))
    sizes = [(("t", c), n) for c, n in cols]
    heat = {("t", c): h for c, h in (heat or {}).items()}
    want = r_plan_spill(sizes, RTierBudgets(*budgets), rm,
                        reserved_device=reserved, heat=heat)
    got = plan_spill(sizes, TierBudgets(*budgets), pm,
                     reserved_device=reserved, heat=heat)
    assert got.tiers == want.tiers
    assert got.bytes_by_tier == want.bytes_by_tier
    assert got.overflow_bytes == want.overflow_bytes
    assert got.promote_s_per_exec == want.promote_s_per_exec
    assert got.spilled == want.spilled
    assert got.describe() == want.describe()


def test_plan_spill_fills_tiers_in_order_and_reports_overflow():
    model = CostModel(1)
    cols = [(("t", "a"), 100), (("t", "b"), 100), (("t", "c"), 100)]
    plan = plan_spill(cols, TierBudgets(device=100, host=100), model)
    assert sorted(plan.tiers.values()) == ["device", "disk", "host"]
    assert plan.spilled and plan.promote_s_per_exec > 0
    plan = plan_spill([(("t", "a"), 100)], TierBudgets(10, 10, 10), model)
    assert plan.overflow_bytes == 100 and "OVERFLOW" in plan.describe()
    plan = plan_spill([(("t", "a"), 80)], TierBudgets(device=100), model,
                      reserved_device=50)
    assert plan.tier_of(("t", "a")) == "host"


def test_tier_budgets_read_the_reference_environment(monkeypatch):
    monkeypatch.setenv("REPRO_PLACEMENT_CAP", "4096")
    monkeypatch.setenv("REPRO_HOST_CAP", "8192")
    monkeypatch.setenv("REPRO_DISK_CAP", "nonsense")
    assert TierBudgets.from_env() == TierBudgets(4096, 8192, None)
    assert TierBudgets.from_env(device=7).device == 7


# ---- tier pricing --------------------------------------------------------- #

@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_tier_pricing_monotone_down_the_hierarchy(impl):
    model = CostModel(1, impl=impl)
    n = float(1 << 20)
    assert model.promotion_cost(n, "device") == 0.0
    assert 0 < model.promotion_cost(n, "host") \
        < model.promotion_cost(n, "disk")
    assert model.demotion_cost(n, "device") == 0.0
    assert 0 < model.demotion_cost(n, "host") <= model.demotion_cost(n,
                                                                     "disk")
    s = [model.tier_score(1e-3, n, tier=t) for t in TIERS]
    assert s[0] == model.cache_score(1e-3, n)
    assert s[0] >= s[1] >= s[2] >= 0.0
    assert model.bandwidth_gbps("disk") < model.bandwidth_gbps("host") \
        < model.bandwidth_gbps("partitioned")


def test_morsel_cost_src_tier_defaults_to_h2d():
    model = CostModel(1)
    base = model.morsel_cost(1 << 16, 4096, 3)
    assert model.morsel_cost(1 << 16, 4096, 3, src_tier="host") == base
    assert model.morsel_cost(1 << 16, 4096, 3, src_tier="disk") > base
    # disk promotion pushes the granularity up, never down
    assert model.choose_morsel_rows(1 << 22, 3, src_tier="disk") \
        >= model.choose_morsel_rows(1 << 22, 3, src_tier="host")


def test_morsel_pricing_matches_reference_under_one_overlay():
    rm = RCostModel(1, calibration=_OVERLAY)
    pm = CostModel(1, calibration=convert.calibration_from_reference(
        rm.calibration_snapshot()))
    # the transfer term alone (no compute): equal prices
    for tier in ("host", "disk"):
        t_p = pm.promotion_cost(4096 * 12, tier) + pm.stage_overhead_s
        t_r = rm.promotion_cost(4096 * 12, tier) + rm.stage_overhead_s
        assert t_p == t_r


# ---- tier moves ---------------------------------------------------------- #

def test_disk_column_is_a_read_only_memmap_with_unchanged_values(tmp_path):
    a = np.arange(-5, 995, dtype=np.int32)
    t = Table.from_arrays("t", {"a": a, "b": a * 2}, "cpu")
    t.demote_column("a", "host")
    assert t.column_tier("a") == "host" and t.version == 0
    t.demote_column("a", "disk", str(tmp_path))
    col = t.column("a")
    assert isinstance(col, np.memmap) and not col.flags.writeable
    np.testing.assert_array_equal(col, a)
    assert t.version == 0 and t.columns["a"].nbytes == a.nbytes
    t.promote_column("a", "cpu")
    assert t.column_tier("a") == "device" and t.version == 0
    np.testing.assert_array_equal(t.column("a").numpy(), a)


def test_disk_demotions_of_same_named_tables_keep_their_own_data(tmp_path):
    """Two tables of one name and version demoted into one directory: the
    reference names the file by table, column and version alone and
    reuses an existing one, which would hand the second table the first
    one's data.  The port writes a file per demotion."""
    first = Table.from_arrays("t", {"a": np.arange(8, dtype=np.int32)},
                              "cpu")
    second = Table.from_arrays("t", {"a": np.arange(8, 16, dtype=np.int32)},
                               "cpu")
    first.demote_column("a", "disk", str(tmp_path))
    second.demote_column("a", "disk", str(tmp_path))
    np.testing.assert_array_equal(first.column("a"), np.arange(8))
    np.testing.assert_array_equal(second.column("a"), np.arange(8, 16))


# ---- spilled execution, against the unspilled run and the reference ------ #

def _agg_queries(Qc):
    return [Qc.scan("big").join(Qc.scan("small"), on="k")
            .filter("v", 10, 60).sum("w"),
            Qc.scan("big").filter("v", 10, 60).sum("k"),
            Qc.scan("big").filter("v", 20, 39).count("w"),
            Qc.scan("big").filter("v", 20, 39).mean("w")]


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("i", range(4))
def test_spilled_batch_aggregate_to_host_equals_unspilled_and_reference(
        spill_dir, i, overlap):
    arrays = _arrays()
    cap = arrays["big"]["k"].nbytes // 4
    want = _ref(arrays, placement_capacity_bytes=cap).execute(
        _agg_queries(RQ)[i]).value
    unspilled = _port(arrays).execute(_agg_queries(Q)[i]).value
    ex = _port(arrays, placement_capacity_bytes=cap,
               overlap_transfers=overlap)
    got = ex.execute(_agg_queries(Q)[i])
    assert got.value == unspilled == want
    assert got.mode == "stream"
    plan = ex.last_spill
    assert plan.spilled and "host" in plan.tiers.values()
    for (t, c), tier in plan.tiers.items():
        assert ex.catalog.tables[t].column_tier(c) == tier
    assert ("small", "k") not in plan.tiers        # the build side stays


def test_spilled_batch_aggregate_to_disk_equals_unspilled_and_reference(
        spill_dir):
    arrays = _arrays(3)
    budgets = dict(device=2048, host=0, disk=None)
    q, rq = _agg_queries(Q)[1], _agg_queries(RQ)[1]
    want = _ref(arrays, tier_budgets=RTierBudgets(**budgets)).execute(rq)
    ex = _port(arrays, tier_budgets=TierBudgets(**budgets))
    got = ex.execute(q)
    assert got.value == _port(arrays).execute(q).value == want.value
    assert {ex.catalog.tables["big"].column_tier(c)
            for c in ("k", "v")} == {"disk"}
    assert any(f.endswith(".npy") for f in os.listdir(spill_dir))
    # the prefetch thread and the single-threaded loop give the same bits
    ex.overlap_transfers = False
    assert ex.execute(q).value == got.value


def test_spilled_host_and_disk_at_once(spill_dir):
    arrays = _arrays(4)
    n = arrays["big"]["k"].nbytes
    budgets = dict(device=n, host=n)             # one column on each tier
    q = Q.scan("big").filter("v", 5, 80).filter("w", 3, 30).sum("k")
    rq = RQ.scan("big").filter("v", 5, 80).filter("w", 3, 30).sum("k")
    ref = _ref(arrays, tier_budgets=RTierBudgets(**budgets))
    want = ref.execute(rq)
    ex = _port(arrays, tier_budgets=TierBudgets(**budgets))
    assert ex.execute(q).value == want.value
    assert sorted(ex.last_spill.tiers.values()) == ["device", "disk",
                                                   "host"]
    # the reference spills only when one column is over the budget, so it
    # keeps this 3n-byte working set on its n-byte device
    assert {ref.catalog.tables["big"].column_tier(c)
            for c in ("k", "v", "w")} == {"device"}
    assert ex.execute(q, mode="stream", morsel_rows=777).value == want.value


def test_spilled_project_root_equals_unspilled_and_reference(spill_dir):
    arrays = _arrays(5)
    cap = arrays["big"]["k"].nbytes // 4
    for make in (lambda Qc: Qc.scan("big").filter("v", 10, 60)
                 .project("k", "w"),
                 lambda Qc: Qc.scan("big").join(Qc.scan("small"), on="k")
                 .filter("v", 10, 60).project("k", "w")):
        oracle = _ref(arrays).execute(make(RQ)).value
        unspilled = _port(arrays).execute(make(Q)).value
        ex = _port(arrays, placement_capacity_bytes=cap)
        got = ex.execute(make(Q))
        assert got.mode == "stream" and ex.last_spill.spilled
        for c in ("k", "w"):
            np.testing.assert_array_equal(got.value.column(c).numpy(),
                                          np.asarray(oracle.column(c)))
            assert torch.equal(got.value.column(c), unspilled.column(c))


def test_project_pipeline_analysis_matches_reference():
    from repro.query import pipeline as rpl
    arrays = _arrays(6)
    ref, port = _ref(arrays), _port(arrays)
    for make in (lambda Qc: Qc.scan("big").filter("v", 1, 9)
                 .project("k", "w"),
                 lambda Qc: Qc.scan("big").join(Qc.scan("small"), on="k")
                 .project("k", "v"),
                 lambda Qc: Qc.scan("big").filter("v", 1, 9).sum("w")):
        ropt, _ = ref.plan(make(RQ).node)
        popt, _ = port.plan(make(Q).node)
        want = rpl.analyze_project(ropt, ref.catalog.stats)
        got = pl.analyze_project(popt, port.catalog.stats)
        assert (got is None) == (want is None)
        if got is not None:
            assert got.stream_cols == want.stream_cols
            assert got.out_cols == want.out_cols
            assert [(b.table, b.on, b.value_cols) for b in got.breakers] \
                == [(b.table, b.on, b.value_cols) for b in want.breakers]


def test_spill_survives_repeat_and_mutation(spill_dir):
    arrays = _arrays(7)
    q = Q.scan("big").filter("v", 10, 60).sum("w")
    ex = _port(arrays, placement_capacity_bytes=arrays["big"]["k"].nbytes
               // 4)
    first = ex.execute(q).value
    assert ex.execute(q).value == first
    tab = ex.catalog.tables["big"]
    w2 = (np.asarray(arrays["big"]["w"]) + 1).astype(np.int32)
    ex.catalog.update_column("big", "w", w2)
    assert tab.version == 1
    changed = {**arrays, "big": {**arrays["big"], "w": w2}}
    want = _ref(changed).execute(RQ.scan("big").filter("v", 10, 60)
                                 .sum("w")).value
    got = ex.execute(q)
    assert got.value == want != first
    assert ex.last_spill.spilled


def test_overflow_of_the_whole_hierarchy_raises(spill_dir):
    ex = _port(_arrays(), tier_budgets=TierBudgets(device=2048, host=0,
                                                   disk=0))
    with pytest.raises(PlacementCapacityError,
                       match="overflows the whole tier hierarchy"):
        ex.execute(Q.scan("big").filter("v", 10, 60).sum("k"))


def test_capacity_error_reports_bytes_budget_and_remedy():
    arrays = _arrays()
    cap = 1024
    ex = _port(arrays, placement_capacity_bytes=cap)
    with pytest.raises(PlacementCapacityError) as ei:
        ex.execute(Q.scan("big").filter("v", 10, 60).sum("k"),
                   optimized=False)
    msg = str(ei.value)
    assert str(cap) in msg and str(arrays["big"]["k"].nbytes) in msg
    assert 'mode="stream"' in msg and "morsel_rows" in msg
    # an explicit morsel over the budget is refused too
    with pytest.raises(PlacementCapacityError, match="one morsel"):
        _port(arrays, placement_capacity_bytes=cap).execute(
            Q.scan("big").filter("v", 10, 60).sum("k"), mode="stream",
            morsel_rows=4096)


def test_env_budget_spills_without_hard_gates(spill_dir, monkeypatch):
    monkeypatch.setenv("REPRO_PLACEMENT_CAP", "4096")
    arrays = _arrays(8)
    q = Q.scan("big").filter("v", 10, 60).sum("k")
    want = _ref(arrays).execute(RQ.scan("big").filter("v", 10, 60)
                                .sum("k")).value
    ex = _port(arrays)
    assert ex.placement_capacity_bytes == 4096
    for kw in ({}, {"optimized": False}, {"mode": "eager"}):
        assert ex.execute(q, **kw).value == want


# ---- spilled training ----------------------------------------------------- #

def _glm_arrays(seed=9, m=1000, d=12):
    r = np.random.default_rng(seed)
    cols = {f"f{j}": (r.random(m) * (r.random(m) < 0.3)).astype(np.float32)
            for j in range(d)}
    cols["y"] = (r.random(m) < 0.4).astype(np.float32)
    return {"train": cols}


@pytest.mark.parametrize("kind", ["logreg", "ridge"])
def test_spilled_training_equals_resident_weights_bitwise(spill_dir, kind):
    arrays = _glm_arrays()
    feats = [f"f{j}" for j in range(12)]
    grid = [HyperParams(0.05, 0.0), HyperParams(0.01, 0.001)]
    q = Q.scan("train").train_glm(feats, "y", grid, kind=kind, epochs=2)
    resident = _port(arrays).execute(q).value
    col_bytes = arrays["train"]["f0"].nbytes
    ex = _port(arrays, tier_budgets=TierBudgets(device=4 * col_bytes,
                                                host=4 * col_bytes))
    xs, losses = ex.execute(q).value
    assert sorted(set(ex.last_spill.tiers.values())) == ["device", "disk",
                                                        "host"]
    assert torch.equal(xs, resident[0])
    # the loss pass sums per morsel, so its float32 sum is taken in
    # another order than the resident run's one morsel
    np.testing.assert_allclose(losses.numpy(), resident[1].numpy(),
                               rtol=1e-6, atol=1e-7)
    rq = RQ.scan("train").train_glm(
        feats, "y", [RHyperParams(g.lr, g.l2) for g in grid], kind=kind,
        epochs=2)
    want = _ref(arrays).execute(rq).value
    np.testing.assert_allclose(xs.numpy(), np.asarray(want[0]), rtol=1e-5,
                               atol=1e-6)


# ---- the prefetch thread -------------------------------------------------- #

def test_prefetch_failure_propagates_and_leaks_no_thread():
    before = threading.active_count()

    def get(i):
        if i == 3:
            raise OSError("disk read failed")
        return [np.arange(4, dtype=np.int32) + i], 4

    seen = []
    with pytest.raises(OSError, match="disk read failed"):
        for arrays, n_valid in pl.staged_morsels(6, get,
                                                 torch.device("cpu")):
            seen.append(int(arrays[0][0]))
    assert seen == [0, 1, 2]
    assert threading.active_count() == before


def test_consumer_failure_stops_the_prefetch_thread():
    before = threading.active_count()
    gen = pl.staged_morsels(50, lambda i: ([np.zeros(4, np.int32)], 4),
                            torch.device("cpu"))
    next(gen)
    gen.close()
    assert threading.active_count() == before
