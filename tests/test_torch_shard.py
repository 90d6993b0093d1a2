"""The port's sharded query execution against the JAX reference, on the CPU.

``Executor(shards=N)`` runs N contiguous slices of every sharded column on
one device.  The sizes are ``tests/test_shard_differential.py``'s: 4,096
and 4,097 probe rows, 512 build rows, key domain 200.  The shuffle join's
building blocks are held in ``test_torch_shard_join.py``.

* ``Executor(shards=n)`` for n in 2, 3, 8, in every mode, over the
  reference differential's queries, its non-dividing rows, its filtered
  build side, its projected row order and ``optimized=False``: equal to
  ``shards=None`` and to the reference's Auto-mesh executor.
* fingerprints against the reference's ``fingerprint(layout=)``, the
  byte-identical ``shards=None`` / ``shards=1`` executor, the shard
  pricing (crossover, one-shard models), ``record_plan(shards=)``, TrainGLM
  under ``shard/replicated`` and a sharded streaming server.
* one test reaches the reference's sharded executor itself, which needs
  several JAX devices: a subprocess with four host devices runs
  ``Executor(shards=4)`` and writes its values, its shuffle pairs and its
  per-shard ledger rows, which the port's ``Executor(shards=4)`` must
  equal.  (The reference's own sharded tests also build a one-device
  oracle, which fails on an Explicit-axis mesh when devices are forced,
  so the subprocess runs only ``shards=4`` executors.)
"""
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.columnar.table import Table as RTable
from repro.distributed import sharding as r_sharding
from repro.query import Catalog as RCatalog, CostModel as RCostModel
from repro.query import Executor as RExecutor, Q as RQ
from repro.query import logical as RL

from repro_torch.columnar import engine
from repro_torch.columnar.table import Table
from repro_torch.convert import catalog_from_arrays
from repro_torch.core import join as join_core
from repro_torch.distributed import sharding
from repro_torch.query import (
    CostModel, Executor, HyperParams, Q, QueryServer, plan_physical,
)
from repro_torch.query import logical as L
from repro_torch.query import pipeline as pl
from repro_torch.query import telemetry as tm
from repro_torch.query.cost import ColumnStats, TableStats

ROOT = Path(__file__).resolve().parents[1]
SHARDS = (2, 3, 8)
MEAN_RTOL = 1e-6       # one float32 ulp, for the reference's sharded mean
MODES = ("batch", "stream", "eager")


def _auto_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()).reshape(1, -1),
                             ("data", "model"))


def _arrays(seed=0, n=4096, m=512, dom=200):
    """``test_shard_differential._tables``' columns, drawn in its order."""
    r = np.random.default_rng(seed)
    li = {"qty": r.integers(0, 50, n).astype(np.int32),
          "price": r.integers(1, 100, n).astype(np.int32),
          "pk": r.integers(0, dom, n).astype(np.int32)}
    part = {"pk": r.integers(0, dom, m).astype(np.int32),
            "w": r.integers(1, 10, m).astype(np.int32)}
    return {"lineitem": li, "part": part}


def _queries(Qc):
    """``test_shard_differential.QUERIES``."""
    return (
        Qc.scan("lineitem").filter("qty", 10, 39).sum("price"),
        Qc.scan("lineitem").filter("qty", 0, 25).mean("price"),
        Qc.scan("lineitem").join(Qc.scan("part"), "pk")
          .filter("qty", 5, 44).sum("w"),
        Qc.scan("lineitem").filter("qty", 10, 19).count("price"),
    )


def _ex(arrays, **kw):
    return Executor(catalog_from_arrays(arrays, "cpu"), device="cpu", **kw)


def _ref_ex(arrays):
    return RExecutor(RCatalog.from_tables(*(RTable.from_arrays(t, c)
                                            for t, c in arrays.items())),
                     mesh=_auto_mesh(),
                     cost_model=RCostModel(1, calibration=None))


@functools.lru_cache(maxsize=None)
def _reference_planner():
    return _ref_ex(_arrays(0))


@functools.lru_cache(maxsize=None)
def _ref_values(seed, n, mode):
    """The reference's values of the differential's queries in one mode
    (once per table: every reference executor compiles its own steps)."""
    ref = _ref_ex(_arrays(seed, n=n))
    return tuple(ref.execute(q, mode=mode).value for q in _queries(RQ))


def _np(t):
    return np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor) else t)


# --------------------------------------------------------------------------- #
# the sharded executor against shards=None and the reference


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("mode", MODES)
def test_sharded_matches_unsharded_and_reference(n_shards, mode):
    a = _arrays(0)
    ex1, exn = _ex(a), _ex(a, shards=n_shards)
    for pq, want in zip(_queries(Q), _ref_values(0, 4096, mode)):
        got = exn.execute(pq, mode=mode).value
        assert got == ex1.execute(pq, mode=mode).value == want, (pq, mode)
        assert type(got) is type(want)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_non_dividing_rows(n_shards):
    """4,097 rows: a batch step falls back to the unsharded one (the
    model-chosen stream morsels are aligned, so they shard); the same
    answers in every mode."""
    a = _arrays(1, n=4097)
    ex1, exn = _ex(a), _ex(a, shards=n_shards)
    for pq, want in zip(_queries(Q), _ref_values(1, 4097, "batch")):
        for mode in MODES:
            assert exn.execute(pq, mode=mode).value \
                == ex1.execute(pq, mode=mode).value == want
    q = _queries(Q)[0]
    node, phys = exn.plan(q.node)
    splan = pl.analyze(node, exn.catalog.stats)
    assert exn._pipeline(node, phys, splan, rows=None)[0].shard is None
    spec = exn.morsel_spec("lineitem", None, n_cols=3)
    assert spec.rows % n_shards == 0
    assert exn._pipeline(node, phys, splan,
                         rows=spec.rows)[0].shard is not None


def _filtered_build_arrays():
    r = np.random.default_rng(8)
    n, m, dom = 4096, 8192, 512
    return {"t": {"v": r.integers(0, 100, n).astype(np.int32),
                  "pk": r.integers(0, dom, n).astype(np.int32)},
            "s": {"pk": r.integers(0, dom, m).astype(np.int32),
                  "u": r.integers(1, 10, m).astype(np.int32)}}


@functools.lru_cache(maxsize=None)
def _filtered_build_reference():
    return _ref_ex(_filtered_build_arrays()).execute(
        RQ.scan("t").join(RQ.scan("s"), "pk").filter("v", 10, 89)
          .sum("u")).value


@functools.lru_cache(maxsize=None)
def _project_reference():
    t = _ref_ex(_arrays(2)).execute(
        RQ.scan("lineitem").join(RQ.scan("part"), "pk")
          .filter("qty", 5, 44).project("price", "w"), mode="eager").value
    return {c: np.asarray(t.column(c)) for c in ("price", "w")}


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_filtered_build_side_join(n_shards):
    """The filtered table is the smaller join input, so it becomes the
    build side and its selection runs under the replicated plan: it must
    stay exact on a sharded executor (the reference's regression)."""
    a = _filtered_build_arrays()
    ex1, exn = _ex(a), _ex(a, shards=n_shards)
    q = Q.scan("t").join(Q.scan("s"), "pk").filter("v", 10, 89).sum("u")
    q_cnt = Q.scan("t").filter("v", 10, 89).count("pk")
    v = a["t"]["v"]
    assert exn.execute(q_cnt, mode="eager").value \
        == int(((v >= 10) & (v <= 89)).sum())
    want = _filtered_build_reference()
    for mode in ("eager", "batch", "stream"):
        assert exn.execute(q, mode=mode).value \
            == ex1.execute(q, mode=mode).value == want


@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_project_row_order_bit_identical(n_shards):
    """Materialized rows: the shuffle join's pairs are put back in probe-
    row order, so the projected row order equals the one-engine
    executor's and the reference's, duplicates included."""
    a = _arrays(2)
    ex1, exn = _ex(a), _ex(a, shards=n_shards)
    q = Q.scan("lineitem").join(Q.scan("part"), "pk") \
         .filter("qty", 5, 44).project("price", "w")
    t1 = ex1.execute(q, mode="eager").value
    tn = exn.execute(q, mode="eager").value
    for c in ("price", "w"):
        np.testing.assert_array_equal(_np(tn.column(c)), _np(t1.column(c)))
        np.testing.assert_array_equal(_np(tn.column(c)),
                                      _project_reference()[c])
    # a unique-keyed project root streams: its sharded step concatenates
    # the shards' blocks back into row order
    a["dim"] = {"pk": np.arange(0, 200, 2, dtype=np.int32),
                "d": np.arange(100, dtype=np.int32)}
    ex1, exn = _ex(a), _ex(a, shards=n_shards)
    qs = Q.scan("lineitem").filter("qty", 5, 44) \
          .join(Q.scan("dim"), "pk").project("price", "d")
    want = ex1.execute(qs, mode="eager").value
    node, phys = exn.plan(qs.node)
    pplan = pl.analyze_project(node, exn.catalog.stats)
    assert pplan is not None
    spec = exn.morsel_spec("lineitem", 1000, n_cols=3)
    cpj, _ = exn.project_pipeline(node, phys, pplan, spec)
    assert cpj.shard is not None and spec.rows % n_shards == 0
    got = exn._run_stream_project(node, phys, pplan, 1000)
    for c in ("price", "d"):
        np.testing.assert_array_equal(_np(got.column(c)),
                                      _np(want.column(c)))


@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_results_equal_naive_oracle(n_shards):
    a = _arrays(3)
    exn = _ex(a, shards=n_shards)
    for q in _queries(Q):
        assert exn.execute(q).value == exn.execute(q, optimized=False).value


def test_float_sum_within_tolerance():
    """A float column's sum is added in shard order, as the reference's
    psum reorders it: within 1e-5 relative of the unsharded sum."""
    r = np.random.default_rng(9)
    a = {"t": {"f": r.normal(size=4096).astype(np.float32),
               "v": r.integers(0, 100, 4096).astype(np.int32)}}
    q = Q.scan("t").filter("v", 10, 80).sum("f")
    want = _ex(a).execute(q).value
    for n_shards in SHARDS:
        for mode in MODES:
            got = _ex(a, shards=n_shards).execute(q, mode=mode).value
            assert got == pytest.approx(want, rel=1e-5, abs=1e-4)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_fingerprints_match_the_reference_layout(n_shards):
    """``fingerprint_of`` on a sharded executor is the reference's
    ``fingerprint(opt, versions, layout=ShardLayout(n).key())``."""
    a = _arrays(0)
    exn, ref = _ex(a, shards=n_shards), _reference_planner()
    lay = r_sharding.ShardLayout(n_shards).key()
    for pq, rq in zip(_queries(Q), _queries(RQ)):
        opt, _ = ref.plan(rq.node)
        want = RL.fingerprint(opt, ref.catalog.versions(), layout=lay)
        assert exn.fingerprint_of(pq.node) == want
        assert L.fingerprint(exn.plan(pq.node)[0], exn.catalog.versions(),
                             layout=lay) == want


def test_mesh1_degenerate_is_byte_identical():
    """shards=1 and shards=None: the same plans, fingerprints, cache keys
    and EXPLAIN output, and no layout anywhere."""
    a = _arrays(0)
    exa, exb = _ex(a), _ex(a, shards=1)
    assert exa.shard_layout is None and exb.shard_layout is None
    assert exa.n_shards == exb.n_shards == 1
    assert "sharded" not in exb.plans
    for q in _queries(Q):
        assert exa.fingerprint_of(q.node) == exb.fingerprint_of(q.node)
        na, pa = exa.plan(q.node)
        nb, pb = exb.plan(q.node)
        assert exa._cache_key(na, pa) == exb._cache_key(nb, pb)
        assert exa.explain(q) == exb.explain(q)
        assert "strategy=" not in exa.explain(q)
        assert "sharded" not in exa.explain(q)
    node = _queries(Q)[0].node
    assert L.fingerprint(node) == L.fingerprint(node, layout=None)
    assert L.fingerprint(node) != L.fingerprint(node,
                                                layout=("shard_layout", 8))
    assert exb.stats_dict()["n_shards"] == 1


@pytest.mark.parametrize("n_shards", SHARDS)
def test_shard_layout_splits_fingerprint_and_cache_key(n_shards):
    a = _arrays(0)
    exa, exn = _ex(a), _ex(a, shards=n_shards)
    q = _queries(Q)[0]
    assert exa.fingerprint_of(q.node) != exn.fingerprint_of(q.node)
    na, pa = exa.plan(q.node)
    nn, pn = exn.plan(q.node)
    assert exa._cache_key(na, pa) != exn._cache_key(nn, pn)
    assert exn._cache_key(nn, pn)[-1] == ("shard_layout", n_shards, "shard")
    assert "placement=sharded" in exn.explain(q)
    assert exn.stats_dict()["n_shards"] == n_shards
    assert exn.plans["sharded"].n_engines == n_shards


# --------------------------------------------------------------------------- #
# shard pricing


def _join_stats(probe: int, build: int):
    return {
        "l": TableStats(probe, ("pk", "v"),
                        {"pk": ColumnStats(0, build - 1,
                                           min(build, probe)),
                         "v": ColumnStats(0, 99, 100)}),
        "s": TableStats(build, ("pk", "w"),
                        {"pk": ColumnStats(0, build - 1,
                                           max(build // 2, 1)),
                         "w": ColumnStats(0, 9, 10)}),
    }


@pytest.mark.parametrize("n_shards", SHARDS)
def test_shuffle_broadcast_crossover_follows_cost_model(n_shards):
    """The planner takes the shuffle exactly where the port's own priced
    alternatives cross, and both strategies win somewhere in the sweep."""
    model = CostModel(1, n_shards=n_shards)
    q = L.Aggregate(L.Join(L.Scan("l", ("pk", "v")),
                           L.Scan("s", ("pk", "w")), "pk"), "sum", "v")
    seen = set()
    for build in (256, 1024, 4096, 8192, 16384, 65536, 262144):
        j = plan_physical(q, _join_stats(1 << 16, build), model).children[0]
        assert j.placement == "sharded"
        alt_b = j.alternatives["shard/broadcast"]
        alt_s = j.alternatives["shard/shuffle"]
        expect = "shuffle" if alt_s < alt_b else "broadcast"
        assert j.shard_strategy == expect, (build, alt_b, alt_s)
        assert j.cost_s == min(alt_b, alt_s)
        if expect == "shuffle":
            assert j.n_passes == max(-(-(build // n_shards)
                                       // join_core.HT_CAPACITY), 1)
        assert f"strategy={expect}" in j.describe()
        seen.add(j.shard_strategy)
    assert seen == {"broadcast", "shuffle"}


def test_shard_pricing_is_the_cards_memory():
    """On one card the repartition moves bytes through the card's own
    memory: both terms price at the H100's HBM rate, and the sharded
    placement streams at the card's rate, not n times it."""
    from repro_torch.core.channels import H100_HBM_GBPS
    m = CostModel(1, n_shards=4)
    assert m.shuffle_cost(3350e6) == pytest.approx(
        3350e6 * 3 / 4 / (H100_HBM_GBPS * 1e9))
    assert m.shard_broadcast_cost(3350e6) == pytest.approx(
        3350e6 * 3 / (H100_HBM_GBPS * 1e9))
    assert m.bandwidth_gbps("sharded") == m.bandwidth_gbps("partitioned") \
        == H100_HBM_GBPS
    one = CostModel(1)
    assert one.shuffle_cost(1e9) == one.shard_broadcast_cost(1e9) == 0.0


def test_mesh1_never_prices_shard_strategies():
    model = CostModel(4)                # n_shards defaults to 1
    q = L.Aggregate(L.Join(L.Scan("l", ("pk", "v")),
                           L.Scan("s", ("pk", "w")), "pk"), "sum", "v")
    j = plan_physical(q, _join_stats(1 << 16, 4096), model).children[0]
    assert j.shard_strategy is None
    assert "shard/broadcast" not in j.alternatives
    assert "shard/shuffle" not in j.alternatives
    t = L.TrainGLM(L.Scan("l", ("pk", "v")), ("pk",), "v",
                   (HyperParams(0.1, 0.0),), "ridge", 2)
    p = plan_physical(t, _join_stats(1 << 16, 4096), model)
    assert "shard/replicated" not in p.alternatives
    assert p.shard_strategy is None


@pytest.mark.parametrize("n_engines,n_shards", [(1, 3), (2, 3), (4, 8)])
def test_morsels_align_to_engines_and_shards(n_engines, n_shards):
    """One morsel must cut evenly across the engines and the shards: the
    model's choice and the executor's specs are multiples of their lcm."""
    model = CostModel(n_engines, n_shards=n_shards)
    q = L.Aggregate(L.Filter(L.Scan("l", ("pk", "v")), "v", 0, 9),
                    "sum", "v")
    p = plan_physical(q, _join_stats(1 << 20, 64), model)
    assert p.morsel_rows % math.lcm(n_engines, n_shards) == 0
    a = _arrays(0, n=4097)
    ex = _ex(a, shards=n_shards, n_engines=n_engines)
    for target in (None, 1000, 4097):
        spec = ex.morsel_spec("lineitem", target)
        assert spec.rows % math.lcm(n_engines, n_shards) == 0


# --------------------------------------------------------------------------- #
# the ledger, training and serving under a layout


@pytest.mark.parametrize("n_shards", SHARDS)
def test_record_plan_splits_sharded_ops_per_shard(n_shards):
    a = _arrays(0)
    ex = _ex(a, shards=n_shards)
    _, phys = ex.plan(_queries(Q)[2].node)
    one, split = tm.BandwidthLedger(True), tm.BandwidthLedger(True)
    one.record_plan(phys, 0.5, 1e6, mode="fused")
    split.record_plan(phys, 0.5, 1e6, mode="fused", shards=n_shards)
    ops = list(tm._walk(phys))
    n_sharded = sum(p.placement == "sharded" for p in ops)
    assert len(split.rows) == len(ops) + (n_shards - 1) * n_sharded
    for op in {p.op for p in ops}:
        for field in ("predicted_bytes", "predicted_s", "measured_bytes",
                      "measured_s"):
            total = sum(getattr(r, field) for r in one.rows if r.op == op)
            assert sum(getattr(r, field) for r in split.rows
                       if r.op == op) == pytest.approx(total)
    for p in ops:
        rows = [r for r in split.rows if r.op == p.op
                and r.placement == p.placement]
        if p.placement == "sharded":
            assert sorted(r.shard for r in rows) == list(range(n_shards))
        else:
            assert all(r.shard == -1 for r in rows)
    assert all(r.shard == -1 for r in one.rows)
    # the executor's own fused and streamed rows carry the shard ids
    tel = tm.Telemetry(enabled=True)
    ex = _ex(a, shards=n_shards, telemetry=tel)
    ex.execute(_queries(Q)[2])
    ex.execute(_queries(Q)[2], mode="stream")
    for mode in ("fused", "stream"):
        ids = sorted({r.shard for r in tel.ledger.rows if r.mode == mode
                      and r.placement == "sharded"})
        assert ids == list(range(n_shards))


class _ShardFavouring(CostModel):
    """A model under which a sharded replica streams n times faster, as
    the reference's TPU model prices it: it picks ``shard/replicated``
    for TrainGLM, which the port's one-card pricing never does."""

    def bandwidth_gbps(self, placement):
        bw = super().bandwidth_gbps(placement)
        return bw * self.n_shards if placement == "sharded" else bw


def _glm_arrays(n=2048, d=5, seed=0):
    r = np.random.default_rng(seed)
    cols = {f"x{i}": r.normal(size=n).astype(np.float32) for i in range(d)}
    cols["y"] = (r.random(n) < 0.5).astype(np.float32)
    cols["g"] = r.integers(0, 10, n).astype(np.int32)
    return {"d": cols}


@pytest.mark.parametrize("n_shards", SHARDS)
def test_train_glm_under_shard_replicated_is_bit_identical(n_shards):
    """TrainGLM's ``shard/replicated`` deals the jobs over the shards'
    engines; each job trains alone, so the weights equal ``shards=None``'s
    bit for bit in every mode, filtered or not."""
    a = _glm_arrays()
    feats = [f"x{i}" for i in range(5)]
    grid = [HyperParams(lr, l2) for lr in (0.05, 0.1, 0.2)
            for l2 in (0.0, 1e-3)]
    plain = _ex(a, shards=n_shards)
    fav = _ex(a, shards=n_shards,
              cost_model=_ShardFavouring(1, n_shards=n_shards))
    ex1 = _ex(a)
    for q in (Q.scan("d").train_glm(feats, "y", grid, kind="logreg",
                                    epochs=2),
              Q.scan("d").filter("g", 2, 7).train_glm(
                  feats, "y", grid, kind="ridge", epochs=2)):
        _, phys = fav.plan(q.node)
        assert (phys.placement, phys.shard_strategy) == ("sharded",
                                                          "replicated")
        assert "shard/replicated" in plain.plan(q.node)[1].alternatives
        assert plain.plan(q.node)[1].shard_strategy is None
        for mode in MODES:
            xs1, l1 = ex1.execute(q, mode=mode).value
            xsn, ln = fav.execute(q, mode=mode).value
            assert torch.equal(xs1, xsn), mode
            assert torch.equal(l1, ln), mode


@pytest.mark.parametrize("n_shards", [2, 3])
def test_sharded_streaming_server_equals_unsharded(n_shards, monkeypatch):
    """A streaming server on a sharded executor: the values of the
    unsharded server, one probe per shard per join per group a morsel,
    and serve ledger rows with the shard ids."""
    a = _arrays(4)
    calls = []
    real = pl.join_kernels.probe_counts

    def counted(s_sorted, keys):
        calls.append(keys.shape[0])
        return real(s_sorted, keys)

    bounds = [(0, 9), (10, 40), (20, 49), (3, 30)]

    def serve(**kw):
        tel = tm.Telemetry(enabled=True)
        srv = QueryServer(_ex(a, telemetry=tel, **kw), streaming=True,
                          morsel_rows=510)
        qids = [srv.submit(Q.scan("lineitem").join(Q.scan("part"), "pk")
                           .filter("qty", lo, hi).sum("w"))
                for lo, hi in bounds]
        qids.append(srv.submit(Q.scan("lineitem").filter("qty", 3, 30)
                               .mean("price")))
        res = srv.drain()
        return [res[q] for q in qids], srv, tel

    want, _, _ = serve()
    monkeypatch.setattr(pl.join_kernels, "probe_counts", counted)
    got, srv, tel = serve(shards=n_shards)
    assert got == want
    stream = srv._streams["lineitem"]
    assert stream.spec.rows % n_shards == 0
    assert set(calls) == {stream.spec.rows // n_shards}
    ids = {r.shard for r in tel.ledger.rows if r.mode == "serve"
           and r.placement == "sharded"}
    assert ids == set(range(n_shards))


# --------------------------------------------------------------------------- #
# the reference's own sharded executor, in a subprocess

_REFERENCE_SCRIPT = r'''
import json, sys
import numpy as np
from repro.columnar import engine
from repro.columnar.table import Table
from repro.distributed.sharding import ShardLayout
from repro.query import Catalog, CostModel, Executor, Q
from repro.query import telemetry as tm

out = sys.argv[1]
a = np.load(out + "/arrays.npz")
li = Table.from_arrays("lineitem",
                       {c: a["lineitem." + c] for c in ("qty", "price", "pk")})
part = Table.from_arrays("part", {c: a["part." + c] for c in ("pk", "w")})
queries = (
    Q.scan("lineitem").filter("qty", 10, 39).sum("price"),
    Q.scan("lineitem").filter("qty", 0, 25).mean("price"),
    Q.scan("lineitem").join(Q.scan("part"), "pk").filter("qty", 5, 44).sum("w"),
    Q.scan("lineitem").filter("qty", 10, 19).count("price"),
)
tel = tm.Telemetry(enabled=True)
ex = Executor(Catalog.from_tables(li, part), shards=4, telemetry=tel,
              cost_model=CostModel(4, n_shards=4, calibration=None))
res = {"values": {m: [ex.execute(q, mode=m).value for q in queries]
                  for m in ("batch", "stream", "eager")},
       "ledger": [[r.op, r.placement, r.shard, r.mode]
                  for r in tel.ledger.rows]}
pairs = engine.join_shuffle(li, part, "pk", ShardLayout(4))
proj = ex.execute(Q.scan("lineitem").join(Q.scan("part"), "pk")
                  .filter("qty", 5, 44).project("price", "w"),
                  mode="eager").value
np.savez(out + "/pairs.npz", l=np.asarray(pairs.column("l_idx")),
         r=np.asarray(pairs.column("r_idx")),
         price=np.asarray(proj.column("price")),
         w=np.asarray(proj.column("w")))
json.dump(res, open(out + "/ref.json", "w"))
'''


def test_port_matches_the_reference_sharded_executor(tmp_path):
    a = _arrays(5)
    np.savez(tmp_path / "arrays.npz",
             **{f"{t}.{c}": v for t, cols in a.items()
                for c, v in cols.items()})
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    env.pop("REPRO_TRACE", None)
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE_SCRIPT, str(tmp_path)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = json.loads((tmp_path / "ref.json").read_text())
    ref_np = np.load(tmp_path / "pairs.npz")

    tel = tm.Telemetry(enabled=True)
    ex = _ex(a, shards=4, telemetry=tel)
    for mode in MODES:
        got = [ex.execute(q, mode=mode).value for q in _queries(Q)]
        for g, w in zip(got, ref["values"][mode]):
            if isinstance(g, int):
                assert g == w, mode
            else:
                # the reference's eager mean over a 4-device array is the
                # sum times 1/count, 1 ulp off the quotient that its (and
                # the port's) one-device mean and the carries give
                assert g == pytest.approx(w, rel=MEAN_RTOL), mode
    rows = [[r.op, r.placement, r.shard, r.mode] for r in tel.ledger.rows]
    assert rows == ref["ledger"]
    assert {r[2] for r in rows if r[3] != "eager"
            and r[1] == "sharded"} == {0, 1, 2, 3}

    t_l = Table.from_arrays("l", a["lineitem"], "cpu")
    t_s = Table.from_arrays("s", a["part"], "cpu")
    pairs = engine.join_shuffle(t_l, t_s, "pk", sharding.ShardLayout(4))
    np.testing.assert_array_equal(_np(pairs.column("l_idx")), ref_np["l"])
    np.testing.assert_array_equal(_np(pairs.column("r_idx")), ref_np["r"])
    proj = ex.execute(Q.scan("lineitem").join(Q.scan("part"), "pk")
                      .filter("qty", 5, 44).project("price", "w"),
                      mode="eager").value
    for c in ("price", "w"):
        np.testing.assert_array_equal(_np(proj.column(c)), ref_np[c])


def test_shard_strategy_reaches_the_eager_join(monkeypatch):
    """A join priced shuffled runs ``engine.join_shuffle`` in the eager
    lowering; a broadcast one the engines' shared build."""
    a = _arrays(6)
    used = []
    real = engine.join_shuffle

    def spy(*args, **kw):
        used.append("shuffle")
        return real(*args, **kw)

    monkeypatch.setattr(engine, "join_shuffle", spy)
    q = _queries(Q)[2]
    for n_shards in SHARDS:
        ex = _ex(a, shards=n_shards)
        _, phys = ex.plan(q.node)
        j = next(p for p in tm._walk(phys) if p.op.startswith("join"))
        used.clear()
        value = ex.execute(q, mode="eager").value
        assert used == (["shuffle"] if j.shard_strategy == "shuffle"
                        else [])
        assert value == _ex(a).execute(q, mode="eager").value
        forced = dataclasses.replace(j, shard_strategy="broadcast")
        assert forced.describe().endswith("strategy=broadcast")
