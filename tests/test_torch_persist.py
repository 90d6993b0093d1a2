"""The port's cache host tier and warm-start persistence, on the CPU.

Ports the host-tier cases of ``tests/test_tiering.py`` (:235-333: a
device victim is demoted instead of evicted and still hits, a host hit is
promoted when room allows, demotion beats evict-only on a thrashing key
cycle, per-tier tenant books reconcile, a zero host budget is the evict-
only cache) and its persistence cases (:334-384: a snapshot round trip
restores into the host tier with the calibration and the subsumption
index, stale tables are dropped entry by entry, corrupt and wrong-format
files load as None); the server's warm start waits for the port's
``serve.py``.  Beyond them: the stats of the host-tier cases equal the
reference cache's, a demoted value comes back in the dtype and bits it
left with, and an executor warm-started from another's snapshot serves
its queries as hits equal to the cold runs.
"""
import json

import numpy as np
import pytest
import torch

from repro.query import CostModel as RCostModel
from repro.query import SemanticCache as RSemanticCache

from repro_torch.convert import catalog_from_arrays
from repro_torch.query import CostModel, Executor, Q, SemanticCache
from repro_torch.query import persist


def _cache(budget, host=0):
    return SemanticCache(budget, host_budget_bytes=host, device="cpu")


# --------------------------------------------------------------------------- #
# the host tier (test_tiering.py:235-333)

def _demote_then_promote(cache, value):
    cache.put("a", value, kind="result", n_bytes=600, recompute_s=1.0)
    cache.put("b", value, kind="result", n_bytes=600, recompute_s=5.0)
    tiers = (cache.peek("a").tier, cache.peek("b").tier)
    st = cache.stats_dict()
    hit = cache.get("a") is not None
    cache.invalidate_table("nope")
    cache.put("b2", 1, kind="result", n_bytes=1, recompute_s=9.0)
    with cache._lock:
        cache._drop(cache.peek("b"))
    return tiers, st, hit, cache.get("a").tier, cache.stats_dict()


def test_cache_demotes_then_serves_and_promotes():
    tiers, st, hit, tier_after, st_after = _demote_then_promote(
        _cache(1000, 4000), torch.arange(100))
    assert tiers == ("host", "device")
    assert st["semantic_cache_demoted"] == 1
    assert st["semantic_cache_evicted"] == 0
    assert hit and tier_after == "device"
    assert st_after["semantic_cache_promoted"] == 1
    # the reference cache takes the same decisions
    ref = RSemanticCache(1000, model=RCostModel(1, calibration=None),
                         host_budget_bytes=4000)
    r_tiers, r_st, r_hit, r_after, r_st_after = _demote_then_promote(
        ref, np.arange(100))
    assert (tiers, st, hit, tier_after, st_after) \
        == (r_tiers, r_st, r_hit, r_after, r_st_after)


def test_demoted_value_comes_back_in_its_dtype_and_bits():
    """A demoted tensor, tuple or Table is copied to host memory (the
    entry drops its own reference) and a hit, promoted or not, hands the
    consumer the value it was admitted with."""
    c = _cache(1000, 1 << 20)
    r = torch.Generator().manual_seed(0)
    values = {"t": torch.randint(-2 ** 31, 2 ** 31 - 1, (50,),
                                 dtype=torch.int32, generator=r),
              "pair": (torch.rand(3, 5, generator=r),
                       torch.rand(3, generator=r).double()),
              "tab": catalog_from_arrays(
                  {"x": {"a": np.arange(7, dtype=np.int32),
                         "b": np.linspace(0, 1, 7).astype(np.float32)}},
                  "cpu").tables["x"]}
    for i, (k, v) in enumerate(values.items()):
        assert c.put(k, v, kind="result", n_bytes=900, recompute_s=1.0 + i)
    assert c.peek("t").tier == "host" and c.peek("pair").tier == "host"
    assert c.peek("pair").value[0].device.type == "cpu"
    for k, v in values.items():
        e = c.get(k)
        got = c.device_value(e, torch.device("cpu"))
        if k == "tab":
            for col in ("a", "b"):
                x, y = got.column(col), v.column(col)
                assert isinstance(x, torch.Tensor)
                assert x.dtype == y.dtype and torch.equal(x, y)
        elif k == "pair":
            for x, y in zip(got, v):
                assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert got.dtype == v.dtype and torch.equal(got, v)
    c.check_invariants()


def test_demote_beats_evict_only_hit_rate():
    device = 1000

    def run(cache):
        for _ in range(5):
            for i, k in enumerate(("k0", "k1", "k2")):
                if cache.get(k) is None:
                    cache.put(k, torch.arange(200), kind="result",
                              n_bytes=800, recompute_s=float(i + 1))
        return cache.stats_dict()["semantic_cache_hit_rate"]

    evict_only = run(_cache(device))
    demoting = run(_cache(device, 3 * device))
    assert demoting > evict_only


def test_tenant_share_reconciles_after_invalidate():
    """Per-tenant byte books equal exact per-tier sums over the resident
    entries after puts, a demotion and an invalidation; the reference
    cache ends in the same stats."""
    def run(c):
        c.set_tenant_shares({"a": 1.0, "b": 1.0})
        c.put("r1", 1, kind="result", n_bytes=900, recompute_s=1.0,
              tables=("t1",), tenant="a")
        c.put("r2", 2, kind="result", n_bytes=900, recompute_s=2.0,
              tables=("t2",), tenant="b")
        c.put("r3", 3, kind="result", n_bytes=900, recompute_s=3.0,
              tables=("t1",), tenant="a")    # displaces r1 to the host
        st1 = c.stats_dict()
        resident = {"device": 0, "host": 0}
        with c._lock:
            for e in c._entries.values():
                resident[e.tier] += e.n_bytes
        c.invalidate_table("t1")
        return st1, resident, c.stats_dict()

    c = _cache(2000, 4000)
    st, resident, st2 = run(c)
    assert st["semantic_cache_demoted"] == 1
    assert st["semantic_cache_used_bytes"] == resident["device"]
    assert st["semantic_cache_host_used_bytes"] == resident["host"] == 900
    assert "a" not in st2["semantic_cache_tenant_bytes"]
    assert "a" not in st2["semantic_cache_tenant_bytes_host"]
    assert st2["semantic_cache_tenant_bytes"] == {"b": 900}
    c.check_invariants()
    ref = RSemanticCache(2000, model=RCostModel(1, calibration=None),
                         host_budget_bytes=4000)
    assert (st, resident, st2) == run(ref)


def test_host_budget_zero_is_exact_legacy():
    c = _cache(1000)
    c.put("a", 1, kind="result", n_bytes=600, recompute_s=1.0)
    c.put("b", 2, kind="result", n_bytes=600, recompute_s=5.0)
    assert "a" not in c and "b" in c
    st = c.stats_dict()
    assert st["semantic_cache_evicted"] == 1
    assert st["semantic_cache_demoted"] == 0
    assert st["semantic_cache_host_used_bytes"] == 0


# --------------------------------------------------------------------------- #
# persistence (test_tiering.py:334-384)

def _snapshot_cache():
    c = _cache(1 << 20, 1 << 20)
    c.put(("result", "fp-1"), 41.5, kind="result", n_bytes=16,
          recompute_s=2.0, tables=("t1",))
    c.put(("bitmap", "t1", 0, "v", 1, 5), torch.arange(9, dtype=torch.int32),
          kind="bitmap", n_bytes=36, recompute_s=1.0, tables=("t1",),
          interval=("t1", "v", 0, 1, 5))
    c.put(("result", "fp-tab"), catalog_from_arrays(
        {"proj": {"x": np.arange(6, dtype=np.int32)}}, "cpu").tables["proj"],
        kind="result", n_bytes=24, recompute_s=3.0, tables=("t2",))
    c.put(("model", "fp-m"), (torch.rand(2, 3), torch.rand(2)),
          kind="model", n_bytes=32, recompute_s=4.0, tables=("t2",))
    return c


def test_persist_roundtrip_restores_into_host_tier(tmp_path):
    path = str(tmp_path / "snap.npz")
    model = CostModel(1)
    model.apply_calibration({"backend": "test", "backends": {},
                             "h2d_gbps": 7.5})
    src = _snapshot_cache()
    summary = persist.save_state(path, src, cost_model=model,
                                 table_versions={"t1": 0, "t2": 0})
    assert summary["saved"] == 4 and summary["skipped"] == 0
    c2 = _cache(1 << 20, 1 << 20)
    m2 = CostModel(1)
    r = persist.warm_start(path, c2, cost_model=m2,
                           table_versions={"t1": 0, "t2": 0})
    assert r["restored"] == 4 and r["calibrated"] and r["stale"] == 0
    assert m2.h2d_gbps == 7.5
    assert all(e.tier == "host" for e in c2._entries.values())
    assert c2.get(("result", "fp-1")).value == pytest.approx(41.5)
    assert c2.lookup_superset("t1", "v", 0, 2, 4) is not None
    idx = c2.device_value(c2.get(("bitmap", "t1", 0, "v", 1, 5)))
    assert idx.dtype == torch.int32 and torch.equal(
        idx, torch.arange(9, dtype=torch.int32))
    tab = c2.device_value(c2.peek(("result", "fp-tab")))
    assert torch.equal(tab.column("x"), torch.arange(6, dtype=torch.int32))
    xs, losses = c2.device_value(c2.peek(("model", "fp-m")))
    want = src.peek(("model", "fp-m")).value
    assert torch.equal(xs, want[0]) and torch.equal(losses, want[1])
    c2.stats_dict()


def test_persist_rejects_stale_table_versions(tmp_path):
    path = str(tmp_path / "snap.npz")
    persist.save_state(path, _snapshot_cache(),
                       table_versions={"t1": 0, "t2": 0})
    c2 = _cache(1 << 20, 1 << 20)
    r = persist.warm_start(path, c2, table_versions={"t1": 3, "t2": 0})
    assert r["restored"] == 2            # the two t2-dependent entries
    assert r["stale"] == 2
    assert c2.peek(("result", "fp-1")) is None
    r = persist.warm_start(path, _cache(1 << 20, 1 << 20),
                           table_versions={"t1": 0})      # t2 is gone
    assert r["restored"] == 2 and r["stale"] == 2


def test_persist_rejects_corrupt_and_wrong_format(tmp_path):
    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"not an archive")
    assert persist.load_state(str(bad)) is None
    assert persist.load_state(str(tmp_path / "missing.npz")) is None
    path = str(tmp_path / "v999.npz")
    manifest = json.dumps({"format": 999, "entries": []}).encode()
    np.savez(path, manifest=np.frombuffer(manifest, dtype=np.uint8))
    assert persist.load_state(path) is None
    r = persist.warm_start(str(bad), _cache(1000))
    assert r == {"restored": 0, "stale": 0, "calibrated": False,
                 "loaded": False}


def test_unserializable_entries_are_skipped(tmp_path):
    c = _cache(1 << 20)
    c.put(("result", "fp"), 1, kind="result", n_bytes=16, recompute_s=1.0)
    c.put(object(), 2, kind="result", n_bytes=16, recompute_s=1.0)
    c.put(("result", "bf16"), torch.ones(4, dtype=torch.bfloat16),
          kind="result", n_bytes=8, recompute_s=1.0)
    got = persist.save_state(str(tmp_path / "s.npz"), c)
    assert got["saved"] == 1 and got["skipped"] == 2


# --------------------------------------------------------------------------- #
# an executor warm-started from another's snapshot

def _arrays(n=4096, seed=3):
    r = np.random.default_rng(seed)
    return {"big": {"k": r.integers(0, 1000, n).astype(np.int32),
                    "v": r.integers(0, 1000, n).astype(np.int32),
                    "w": r.integers(1, 50, n).astype(np.int32)},
            "small": {"k": np.asarray(r.choice(1000, 512, replace=False),
                                      np.int32)}}


def _queries():
    return [Q.scan("big").filter("v", 10, 600).sum("w"),
            Q.scan("big").join(Q.scan("small"), on="k")
             .filter("v", 0, 300).sum("w"),
            Q.scan("big").filter("v", 0, 250).project("k", "w")]


@pytest.mark.requires_cache
def test_executor_warm_start_serves_hits_equal_to_cold_runs(tmp_path):
    path = str(tmp_path / "exec.npz")
    cat = catalog_from_arrays(_arrays(), "cpu")
    cold = Executor(cat, device="cpu", cache_bytes=1 << 24)
    want = [cold.execute(q).value for q in _queries()]
    saved = persist.save_state(path, cold.cache, cost_model=cold.cost_model,
                               table_versions=cat.versions())
    assert saved["saved"] >= len(_queries())
    warm = Executor(cat, device="cpu", semantic_cache=SemanticCache(
        1 << 24, host_budget_bytes=1 << 24))
    assert warm.cache.device == torch.device("cpu")
    r = persist.warm_start(path, warm.cache, cost_model=warm.cost_model,
                           table_versions=cat.versions())
    assert r["restored"] == saved["saved"] and r["stale"] == 0
    for q, v in zip(_queries(), want):
        got = warm.execute(q)
        assert got.result_cache_hit
        if hasattr(v, "columns"):
            for c in v.columns:
                assert torch.equal(got.value.column(c), v.column(c))
        else:
            assert got.value == v
    narrow = Q.scan("big").filter("v", 50, 200).project("k", "w")
    assert torch.equal(warm.execute(narrow).value.column("w"),
                       cold.execute(narrow, optimized=False).value
                       .column("w"))
    assert warm.subsumption_hits == 1
    cat.update_column("big", "w", np.ones(4096, np.int32))
    after = persist.warm_start(path, SemanticCache(1 << 24,
                                                   host_budget_bytes=1 << 24,
                                                   device="cpu"),
                               table_versions=cat.versions())
    # the entries of ``big`` are stale; the build of ``small`` is not
    assert after["stale"] > 0
    assert after["restored"] + after["stale"] == saved["saved"]
