"""Physical executor: lowers optimized plans onto the columnar engine.

Three lowering paths, as in the reference (TrainGLM roots take a fourth,
below):

* **batch** — an aggregate-rooted select/join pipeline runs as one
  whole-table morsel: filters are masks, join probes binary-search cached
  sorted-bucket builds (the counts kernel on the card), and nothing
  compacted is materialized.  Pipelines are cached by plan signature
  (structure + shapes + physical decisions, predicate constants masked).
* **stream** — the same pipeline driven morsel by morsel
  (``query/pipeline.py``); falls back to batch when the plan has no
  streamable spine.
* **eager** — step-by-step lowering onto ``columnar/engine.py`` operators,
  materializing BAT-style intermediates: the selection kernel for every
  filter, the hash-probe kernel for unique-key joins and the counts kernel
  for duplicate-keyed ones.

TrainGLM roots (the paper's workload 3) lower in batch and stream modes
onto the morsel-streamed trainer (``engine.train_glm_stream``), whose
weights equal the eager whole-column trainer's (``engine.train_glm``) bit
for bit; both train through the SGD kernel on the card.  ScoreGLM roots score
with the model the semantic cache holds under the train plan's
fingerprint, or train it fresh through ``execute`` (which admits it).

A working set over the device budget (``placement_capacity_bytes`` or
``tier_budgets``, or the reference's ``REPRO_PLACEMENT_CAP`` /
``REPRO_HOST_CAP`` / ``REPRO_DISK_CAP`` environment) gets a spill plan
(``query/tiering.py``): its stream columns are demoted to host DRAM and
disk, priced by the cost model's tier channels, and batch-mode aggregate,
project and training plans stream them back morsel by morsel, bit-
identical to the unspilled run.  ``recost`` applies a calibration
measured on the card and the bandwidth ledger's selectivity corrections.

Telemetry (``query/telemetry.py``; ``REPRO_TRACE=1`` or an explicit
``Telemetry(enabled=True)``) records nested spans, per-executor counters
and a bandwidth ledger: the fused and streamed paths fence the pipeline
and attribute its time across the plan's operators, the eager path fences
every operator and measures its bytes with the cost model's formulas at
actual cardinalities, and spill promotions and streamed training get rows
of their own.  Disabled, no path fences and nothing is recorded.

The semantic cache (``query/cache.py``) is opt-in: ``cache_bytes=`` or a
``semantic_cache=`` shared with other executors (``REPRO_CACHE=0`` turns
it off everywhere).  With one installed, whole results short-circuit by
fingerprint, join builds live in it under their table version, eager
Filter / FilterProject / Join outputs and selection bitmaps are reused,
a narrower range refines the tightest cached superset bitmap when the
cost model prices that below rescanning the column (a fused aggregate is
then routed onto the eager path), and trained GLM weights serve ScoreGLM.
Every hit's value reaches the consumer on the executor's device, from the
host tier too.  Without one, every path runs as before.  Table mutations
are noticed at the top of ``execute`` and ``plan``: the stale version's
placements, builds, plans and fingerprints are purged, and the cache's
dependent entries swept.

Callers that advance morsels themselves reuse the streamed path:
``stream_pipeline`` / ``project_pipeline`` hand out the compiled step and
its join builds at a morsel granularity, and ``_stream_morsel`` fetches
one morsel of a union of columns.  The query server (``query/serve.py``)
advances its shared morsel streams through them.

The executor runs on the CUDA card unless constructed with a ``device``;
the kernels run exactly when that device is CUDA, because every kernel
wrapper launches on CUDA tensors and takes its plain version on CPU ones.

``shards=N`` (N > 1) runs the plans under a shard layout
(``distributed/sharding.py``): N contiguous slices of every sharded column
on the one card, run one after another.  Streams take the ``sharded``
placement, whose plan has N engines; a fused or streamed step evaluates
each shard's slice of a morsel whose rows N divides (other row counts
take the unsharded step) and adds the shards' partial carries in shard
order; the eager lowering selects and probes per shard, and a join the
cost model prices cheaper shuffled (``shard_strategy == "shuffle"``) runs
``engine.join_shuffle``.  The layout joins fingerprints and compiled-plan
keys, so a sharded plan never aliases an unsharded one; ``shards=None``
and ``shards=1`` are the unsharded executor byte for byte.  Integer
results equal the unsharded ones bit for bit; float sums are added in
shard order.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.columnar import engine
from repro_torch.columnar.table import Column, MorselSpec, Table
from repro_torch.core.channels import ChannelPlan
from repro_torch.device import DeviceLike, resolve
from repro_torch.distributed.sharding import ShardLayout
from repro_torch.query import logical as L
from repro_torch.query import pipeline as pl
from repro_torch.query import telemetry as tm
from repro_torch.query.cache import SemanticCache, cache_disabled
from repro_torch.query.cost import (
    BYTES_PER_VALUE, TIERS, ColumnStats, CostModel, PhysNode, TableStats,
    column_placements, key_is_unique, load_calibration, plan_physical,
)
from repro_torch.query.optimize import optimize
from repro_torch.query.tiering import (
    SpillPlan, TierBudgets, default_spill_dir, plan_spill,
)

MODES = ("batch", "stream", "eager")


class PlacementCapacityError(RuntimeError):
    """A placement exceeds the configured device budget (the paper's
    256 MiB pseudo-channel budget).  Optimized plans with a streamable
    spine do not fail here — the executor spills them to host and disk —
    so this survives only where spilling cannot help: the naive oracle
    and forced-eager paths under an explicit capacity, a single explicit
    morsel larger than the budget, and working sets that overflow even
    the disk tier."""


class Catalog:
    """Named tables on one device + the statistics the optimizer uses."""

    def __init__(self, device: DeviceLike = None):
        self.device = resolve(device)
        self.tables: Dict[str, Table] = {}
        self.stats: Dict[str, TableStats] = {}

    def register(self, table: Table) -> "Catalog":
        """Add (or refresh) a table: device columns move to the catalog's
        device, and min / max / distinct counts of integer columns become
        its statistics."""
        cols = {}
        for name, col in table.columns.items():
            if col.tier == "device" and col.data.device != self.device:
                col = Column(col.data.to(self.device), name)
            cols[name] = col
        table = Table(table.name, cols, table.plan, table.version)
        self.tables[table.name] = table
        ranges = {}
        for name, col in cols.items():
            data = col.data
            if isinstance(data, torch.Tensor):
                if data.dtype.is_floating_point or data.dtype == torch.bool:
                    continue
                if data.numel():
                    ranges[name] = ColumnStats(
                        int(data.min()), int(data.max()),
                        int(torch.unique(data).numel()))
            elif np.issubdtype(data.dtype, np.integer) and data.size:
                ranges[name] = ColumnStats(int(data.min()), int(data.max()),
                                           int(np.unique(data).size))
        self.stats[table.name] = TableStats(table.num_rows,
                                            tuple(table.columns), ranges)
        return self

    @staticmethod
    def from_tables(*tables: Table, device: DeviceLike = None) -> "Catalog":
        cat = Catalog(device)
        for t in tables:
            cat.register(t)
        return cat

    def update_column(self, table: str, column: str, data) -> None:
        """Replace a base column, bump the table's version and refresh the
        statistics the optimizer plans against."""
        self.tables[table].update_column(column, data, self.device)
        self.register(self.tables[table])

    def versions(self) -> Dict[str, int]:
        return {name: t.version for name, t in self.tables.items()}


@dataclasses.dataclass
class Result:
    value: object
    physical: Optional[PhysNode]
    cache_hit: bool                     # compiled-pipeline cache hit
    wall_s: float
    mode: str = "batch"
    result_cache_hit: bool = False      # served from the semantic cache

    def explain(self) -> str:
        if self.physical is None:
            return "(naive: no physical plan)"
        return _explain(self.physical)


def _explain(p: PhysNode, indent: int = 0) -> str:
    lines = [f"{'  ' * indent}{p.op}: {p.describe()}"]
    for c in p.children:
        lines.append(_explain(c, indent + 1))
    return "\n".join(lines)


def _walk_phys(p: PhysNode):
    yield p
    for c in p.children:
        yield from _walk_phys(c)


def _counter(name: str, doc: str):
    """An attribute that reads and writes the executor's MetricsRegistry
    counter ``name`` (``ex.cache_hits`` reads ``exec.plan_cache_hits``)."""

    def fget(self):
        return int(self.metrics.value(name))

    def fset(self, value):
        self.metrics.set(name, value)

    return property(fget, fset, doc=doc)


class Executor:
    """optimize -> cost -> lower -> run, with a compiled-pipeline cache."""

    cache_hits = _counter("exec.plan_cache_hits",
                          "compiled-pipeline cache hits")
    cache_misses = _counter("exec.plan_cache_misses",
                            "compiled-pipeline cache misses")
    trace_count = _counter("exec.trace_count",
                           "pipeline steps built (one per cache miss)")
    result_hits = _counter("exec.result_cache_hits",
                           "semantic cache: whole results")
    subplan_hits = _counter("exec.subplan_cache_hits",
                            "semantic cache: eager intermediates")
    build_hits = _counter("exec.build_cache_hits",
                          "semantic cache: join builds")
    model_hits = _counter("exec.model_cache_hits",
                          "semantic cache: trained GLM weights")
    subsumption_hits = _counter("exec.subsumption_hits",
                                "selections served by refinement")
    refine_bytes_streamed = _counter(
        "exec.refine_bytes_streamed", "bitmap bytes the refine path read")
    refine_bytes_avoided = _counter(
        "exec.refine_bytes_avoided",
        "base-column bytes refinement did not read")
    refine_routed = _counter(
        "exec.refine_routed",
        "fused aggregates routed onto a cached bitmap's eager path")

    _COUNTERS = ("exec.plan_cache_hits", "exec.plan_cache_misses",
                 "exec.trace_count", "exec.result_cache_hits",
                 "exec.subplan_cache_hits", "exec.build_cache_hits",
                 "exec.model_cache_hits", "exec.subsumption_hits",
                 "exec.refine_bytes_streamed", "exec.refine_bytes_avoided",
                 "exec.refine_routed")

    def __init__(self, catalog: Catalog, device: DeviceLike = None, *,
                 n_engines: int = 1,
                 cost_model: Optional[CostModel] = None,
                 placement_capacity_bytes: Optional[int] = None,
                 tier_budgets: Optional[TierBudgets] = None,
                 overlap_transfers: Optional[bool] = None,
                 telemetry: Optional[tm.Telemetry] = None,
                 cache_bytes: Optional[int] = None,
                 semantic_cache: Optional[SemanticCache] = None,
                 tenant: Optional[str] = None,
                 shards: Optional[int] = None):
        self.catalog = catalog
        self.device = resolve(device)
        # the shard layout: None (shards None or 1) keeps every plan,
        # fingerprint and key byte-identical to the unsharded executor
        n_sh = max(int(shards), 1) if shards else 1
        self.shard_layout: Optional[ShardLayout] = \
            ShardLayout(n_sh) if n_sh > 1 else None
        # the tenant every semantic-cache admission is charged to (its
        # share of a shared cache, when shares are set)
        self.tenant = tenant
        # spans and the bandwidth ledger are shared (default: the process
        # global, REPRO_TRACE-gated); the metrics registry is private, so
        # two executors' counters never mix
        self.tel = telemetry if telemetry is not None else tm.get()
        self.metrics = tm.MetricsRegistry()
        self.reset_metrics()
        # the default model overlays the card's calibration when
        # BENCH_calibration_torch.json is in the working directory
        self.cost_model = cost_model or CostModel(
            n_engines, impl="cuda" if self.device.type == "cuda" else "torch",
            calibration=load_calibration(), n_shards=n_sh)
        if self.shard_layout is not None \
                and self.cost_model.n_shards != n_sh:
            # a caller's model prices what this executor runs
            self.cost_model.n_shards = n_sh
        # bumped by every recost(); part of every compiled-pipeline key
        self.cost_epoch = 0
        # tier budgets: the device budget routes over-budget plans onto a
        # spill plan.  The hard gates (placed(), one explicit morsel) hold
        # only for an explicit capacity; a budget from the environment
        # only spills
        self._cap_explicit = placement_capacity_bytes is not None \
            or (tier_budgets is not None and tier_budgets.device is not None)
        self.tier_budgets = tier_budgets if tier_budgets is not None \
            else TierBudgets.from_env(placement_capacity_bytes)
        self.placement_capacity_bytes = self.tier_budgets.device
        self._spill_dir: Optional[str] = None
        self.last_spill: Optional[SpillPlan] = None
        # a thread stages the next host or disk morsel while the current
        # one computes; False (or REPRO_OVERLAP=0) stages on the calling
        # thread, with bit-identical results
        if overlap_transfers is None:
            overlap_transfers = os.environ.get(
                "REPRO_OVERLAP", "1").lower() not in ("0", "off", "no")
        self.overlap_transfers = overlap_transfers
        self.plans: Dict[str, ChannelPlan] = {
            p: ChannelPlan(p, int(n_engines), self.device)
            for p in ("partitioned", "replicated", "congested")}
        if self.shard_layout is not None:
            # one engine per shard: the sharded plan partitions over them
            self.plans["sharded"] = ChannelPlan("partitioned", n_sh,
                                                self.device)
        self._compiled: Dict[tuple, tuple] = {}
        self._planned: Dict[tuple, tuple] = {}
        self._placed: Dict[tuple, torch.Tensor] = {}
        self._builds: Dict[tuple, tuple] = {}
        self._fps: Dict[L.Node, str] = {}
        # plan -> its extracted SelectionInterval (or None): version-free,
        # so never purged; the fused-path router reads it per execution
        self._sints: Dict[L.Node, Optional[L.SelectionInterval]] = {}
        self._seen_versions: Dict[str, int] = catalog.versions()
        # the semantic cache is opt-in: a byte budget, or an instance
        # shared with other executors over the same catalog
        self.cache: Optional[SemanticCache] = None
        if semantic_cache is not None:
            self.install_cache(semantic_cache)
        elif cache_bytes:
            self.install_cache(SemanticCache(cache_bytes,
                                             model=self.cost_model,
                                             telemetry=self.tel,
                                             device=self.device))

    # -- metrics ------------------------------------------------------------ #

    def reset_metrics(self) -> None:
        """Zero every counter and histogram (the registry keeps its
        identity, so held references stay valid)."""
        self.metrics.reset()
        for name in self._COUNTERS:
            self.metrics.set(name, 0)

    def metrics_snapshot(self) -> dict:
        """Flat snapshot of the executor's registry: counters verbatim,
        histograms as ``name.{count,mean,p50,p95,max}``, plus the semantic
        cache's accounting when one is installed."""
        out = self.metrics.snapshot()
        if self.cache is not None:
            out.update(self.cache.stats_dict())
        return out

    def stats_dict(self) -> dict:
        total = self.cache_hits + self.cache_misses
        out = {
            "plan_cache_hits": self.cache_hits,
            "plan_cache_misses": self.cache_misses,
            "plan_cache_hit_rate": self.cache_hits / total if total else 0.0,
            "trace_count": self.trace_count,
            "placed_columns": len(self._placed),
            "cached_builds": len(self._builds),
            "cost_model_calibrated_from": self.cost_model.calibrated_from,
            "cost_epoch": self.cost_epoch,
            "n_shards": self.n_shards,
            "recost_count": int(self.metrics.value("exec.recost_count")),
            "spilled_columns": int(
                self.metrics.value("exec.spilled_columns")),
            "promote_bytes_host": int(
                self.metrics.value("exec.promote_bytes.host")),
            "promote_bytes_disk": int(
                self.metrics.value("exec.promote_bytes.disk")),
            "tier_budgets": {"device": self.tier_budgets.device,
                             "host": self.tier_budgets.host,
                             "disk": self.tier_budgets.disk},
            "result_cache_hits": self.result_hits,
            "subplan_cache_hits": self.subplan_hits,
            "build_cache_hits": self.build_hits,
            "model_cache_hits": self.model_hits,
            "subsumption_hits": self.subsumption_hits,
            "refine_bytes_streamed": self.refine_bytes_streamed,
            "refine_bytes_avoided": self.refine_bytes_avoided,
        }
        if self.cache is not None:
            out.update(self.cache.stats_dict())
        return out

    # -- semantic cache and versions ---------------------------------------- #

    def install_cache(self, cache: Optional[SemanticCache]) -> None:
        """Attach a semantic cache, possibly one shared with other
        executors over the same catalog; a cache whose device was left
        unset takes this executor's.  A no-op under ``REPRO_CACHE=0``, so
        no caller can re-enable caching around the switch."""
        if cache is None or cache_disabled():
            return
        if not cache.device_set:
            cache.device = self.device
        self.cache = cache
        # the current versions are the cache's drift baseline: a later
        # mutation sweeps shared entries whichever executor notices it
        cache.sync_versions(self.catalog.versions())

    def _sync_versions(self) -> None:
        """Notice table mutations since the last call and purge the state
        derived from the stale version: placements, join builds, memoized
        plans (the statistics changed) and fingerprints, and the semantic
        cache's dependent entries.  Keys embed versions, so nothing stale
        could be served; the purge frees device memory and bytes."""
        drifted = False
        for name, t in list(self.catalog.tables.items()):
            if self._seen_versions.get(name) == t.version:
                continue
            drifted = True
            if name in self._seen_versions:
                self.catalog.register(t)           # refresh statistics
                self._placed = {k: v for k, v in self._placed.items()
                                if k[0] != name}
                self._builds = {k: v for k, v in self._builds.items()
                                if k[0].table != name}
                self._planned.clear()              # stats feed every plan
                self._fps.clear()
            self._seen_versions[name] = t.version
        # gated on local drift so the hot path never takes the shared
        # cache's lock; install_cache registered the baseline
        if drifted and self.cache is not None:
            self.cache.sync_versions(self.catalog.versions())

    # -- shard layout ------------------------------------------------------- #

    @property
    def n_shards(self) -> int:
        return self.shard_layout.n_shards if self.shard_layout else 1

    def _layout_key(self) -> Optional[tuple]:
        """The shard layout's element of every plan-derived key: None on
        an unsharded executor, so its keys stay as they were."""
        return self.shard_layout.key() if self.shard_layout else None

    def fingerprint_of(self, node: L.Node) -> str:
        """Semantic fingerprint of the optimized form of ``node`` against
        the current table versions and the shard layout: the result-cache
        key (memoized; the memo is purged whenever a version moves)."""
        self._sync_versions()
        fp = self._fps.get(node)
        if fp is None:
            opt, _ = self.plan(node)
            fp = L.fingerprint(opt, self.catalog.versions(),
                               layout=self._layout_key())
            self._fps[node] = fp
        return fp

    def _served(self, entry):
        """A cache hit's value on this executor's device: promoted or not,
        a host-tier value is copied up, since torch operations do not mix
        devices."""
        return self.cache.device_value(entry, self.device)

    # -- re-costing --------------------------------------------------------- #

    def recost(self, calibration: Optional[dict] = None) -> int:
        """Apply a calibration overlay to the cost model (``None`` re-reads
        ``BENCH_calibration_torch.json``; usually
        ``ledger.calibration_overlay(model)``), fold the ledger's per-
        (table, column) selectivity corrections into
        ``cost_model.sel_corrections`` (clamped where ``estimate_rows``
        applies them), and bump the cost epoch: every memoized plan is
        re-derived, and the epoch in ``_cache_key`` keeps compiled
        pipelines from crossing the boundary.  Application is idempotent
        (the model re-baselines), so the same overlay twice changes no
        price.  Returns the new epoch."""
        if calibration is None:
            calibration = load_calibration()
        if calibration:
            self.cost_model.apply_calibration(calibration)
        corrections = self.tel.ledger.selectivity_corrections()
        if corrections:
            self.cost_model.sel_corrections.update(corrections)
        self.cost_epoch += 1
        self._planned.clear()
        self._fps.clear()
        self.metrics.inc("exec.recost_count")
        self.metrics.set("exec.cost_epoch", self.cost_epoch)
        self.tel.instant("exec.recost", epoch=self.cost_epoch,
                         calibrated_from=self.cost_model.calibrated_from)
        return self.cost_epoch

    # -- placement ---------------------------------------------------------- #

    def placed(self, table: str, column: str, placement: str
               ) -> torch.Tensor:
        """Column tensor under a placement on this executor's device,
        cached per table version.  Under an explicit capacity a column
        larger than it is refused."""
        t = self.catalog.tables[table]
        key = (table, column, placement, t.version)
        if key not in self._placed:
            n_bytes = t.columns[column].nbytes
            cap = self.placement_capacity_bytes if self._cap_explicit \
                else None
            if cap is not None and n_bytes > cap:
                n_eng = self.plans["partitioned"].n_engines
                suggest = max((int(cap) // (BYTES_PER_VALUE * 3))
                              // n_eng * n_eng, n_eng)
                raise PlacementCapacityError(
                    f"working set over placement budget: column "
                    f"{table}.{column} ({placement}) is {n_bytes} bytes "
                    f"against the {int(cap)}-byte placement capacity "
                    f"({n_bytes / cap:.1f}x over).  Remedy: execute with "
                    f'mode="stream" and morsel_rows <= capacity // '
                    f"(4 * n_stream_cols) — e.g. morsel_rows={suggest} "
                    f"for a 3-column stream — so each morsel fits one "
                    "placement; or configure host/disk tier budgets "
                    "(TierBudgets / REPRO_HOST_CAP / REPRO_DISK_CAP) so "
                    "the spill planner can demote it.  Build/replicated "
                    "columns and eagerly-lowered plans need every placed "
                    "column to fit one placement")
            self._placed[key] = self.plans[placement].place(t.column(column))
        return self._placed[key]

    def _placed_table(self, node: L.Scan, placement: str) -> Table:
        cols = node.columns or tuple(self.catalog.tables[node.table].columns)
        return Table(node.table,
                     {c: Column(self.placed(node.table, c, placement), c)
                      for c in cols},
                     self.plans[placement])

    # -- entry points ------------------------------------------------------- #

    def execute(self, q, *, optimized: bool = True, mode: str = "batch",
                morsel_rows: Optional[int] = None) -> Result:
        """Run a logical plan.  ``mode="batch"``: the whole-column fused
        pipeline (eager lowering when the plan does not stream);
        ``"stream"``: the same pipeline morsel by morsel; ``"eager"``: the
        step-by-step engine lowering under the same physical plan.
        ``optimized=False`` is the naive differential oracle (eager, no
        optimizer)."""
        node = q.node if isinstance(q, L.Q) else q
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        t0 = time.perf_counter()
        with self.tel.span("exec.execute", mode=mode,
                           optimized=optimized) as sp:
            self._sync_versions()      # every path, the naive oracle too
            if not optimized:
                if mode == "stream":
                    raise ValueError("mode='stream' lowers through the "
                                     "optimizer's physical plan; it cannot "
                                     "combine with optimized=False")
                # the differential oracle never reads or feeds the cache
                sp.set(path="naive")
                return Result(self._run_eager(node, None), None, False,
                              time.perf_counter() - t0, mode="eager")
            orig = node
            node, phys = self.plan(node)
            if self.cache is not None:
                entry = self.cache.get(("result", self.fingerprint_of(orig)))
                if entry is not None:
                    self.metrics.inc("exec.result_cache_hits")
                    sp.set(path="result_cache", outcome="hit",
                           reason="fingerprint_match")
                    return Result(self._served(entry), phys, True,
                                  time.perf_counter() - t0, mode=mode,
                                  result_cache_hit=True)
                sp.set(outcome="miss")
            # an over-budget working set is demoted to host/disk by a
            # spill plan, and a batch plan with a streamable spine streams
            # it back
            spill = self._maybe_spill(node)
            # TrainGLM roots stream the training set epoch by epoch with
            # the model weights as the only cross-morsel carry — bit-
            # identical to the whole-column eager path, the oracle
            if mode != "eager":
                tplan = pl.analyze_train(node, self.catalog.stats)
                if tplan is not None:
                    sp.set(path="train_stream")
                    value = self._run_train(node, phys, tplan, morsel_rows)
                    self._admit_result(orig, node, phys, value)
                    return Result(value, phys, False,
                                  time.perf_counter() - t0, mode="stream")
            if mode == "batch" and spill is not None:
                splan = pl.analyze(node, self.catalog.stats)
                if splan is not None:
                    sp.set(path="spill_stream")
                    value, hit = self._run_stream(node, phys, splan,
                                                  morsel_rows, spill=spill)
                    self._admit_result(orig, node, phys, value)
                    return Result(value, phys, hit,
                                  time.perf_counter() - t0, mode="stream")
                pplan = pl.analyze_project(node, self.catalog.stats)
                if pplan is not None:
                    sp.set(path="spill_stream_project")
                    value = self._run_stream_project(node, phys, pplan,
                                                     morsel_rows,
                                                     spill=spill)
                    self._admit_result(orig, node, phys, value)
                    return Result(value, phys, False,
                                  time.perf_counter() - t0, mode="stream")
            if mode == "stream":
                splan = pl.analyze(node, self.catalog.stats)
                if splan is not None:
                    sp.set(path="stream")
                    value, hit = self._run_stream(node, phys, splan,
                                                  morsel_rows, spill=spill)
                    self._admit_result(orig, node, phys, value)
                    return Result(value, phys, hit,
                                  time.perf_counter() - t0, mode="stream")
                sp.set(reason="no_streamable_spine")
            if mode == "eager":
                sp.set(path="eager")
                value = self._run_eager(node, phys)
                self._admit_result(orig, node, phys, value)
                return Result(value, phys, False, time.perf_counter() - t0,
                              mode="eager")
            sp.set(path="batch")
            value, hit = self._run(node, phys)
            self._admit_result(orig, node, phys, value)
            return Result(value, phys, hit, time.perf_counter() - t0)

    def _admit_result(self, orig: L.Node, opt: L.Node, phys: PhysNode,
                      value) -> None:
        """Offer a finished result to the semantic cache, priced by the
        physical plan's modeled recompute cost.  A TrainGLM result is
        also admitted as a servable model under the same fingerprint,
        which embeds the training tables' versions: a mutation strands
        it and the next score retrains."""
        if self.cache is None:
            return
        fp = self.fingerprint_of(orig)
        for kind in ("result", "model") if isinstance(opt, L.TrainGLM) \
                else ("result",):
            self.cache.put((kind, fp), value, kind=kind,
                           n_bytes=_value_nbytes(value),
                           recompute_s=phys.total_cost_s,
                           tables=L.tables_of(opt), tenant=self.tenant)

    def plan(self, node: L.Node):
        """optimize + plan_physical, memoized per node and table versions
        (a mutation noticed first purges the memo)."""
        self._sync_versions()
        key = (node, tuple(sorted(self.catalog.versions().items())))
        if key not in self._planned:
            with self.tel.span("exec.plan") as sp:
                with self.tel.span("exec.optimize"):
                    opt = optimize(node, self.catalog.stats, self.cost_model)
                with self.tel.span("exec.cost_physical"):
                    phys = plan_physical(opt, self.catalog.stats,
                                         self.cost_model)
                sp.set(predicted_s=phys.total_cost_s)
            self._planned[key] = (opt, phys)
        return self._planned[key]

    def explain(self, q) -> str:
        node = q.node if isinstance(q, L.Q) else q
        return _explain(self.plan(node)[1])

    # -- fused path (single-morsel pipeline) -------------------------------- #

    def _run(self, node: L.Node, phys: PhysNode):
        """Aggregate-rooted pipelines run as one whole-table morsel."""
        splan = pl.analyze(node, self.catalog.stats)
        if splan is None:
            return self._run_eager(node, phys), False
        if self._route_to_refine(node, splan):
            # a cached (superset) bitmap makes the eager gather path
            # cheaper than the fused full-column scan
            self.metrics.inc("exec.refine_routed")
            self.tel.instant("exec.route_refine",
                             reason="cached_bitmap_priced_below_scan")
            return self._run_eager(node, phys), False
        cp, specs, hit = self._pipeline(node, phys, splan, rows=None)
        arrays = [self.placed(t, c, p) for t, c, p in specs]
        builds = self._breaker_arrays(splan.breakers)
        lits = L.literals(node)
        if not self.tel.enabled:
            carry = cp.step(lits, cp.init_carry(), cp.rows, *builds,
                            *arrays)
            return cp.finalize(carry), hit
        # settle the placements first, then time the step to completion:
        # the one measurement the ledger apportions across the operators
        with self.tel.span("exec.run_fused", compiled_hit=hit) as sp:
            _fence(self.device)
            t0 = time.perf_counter()
            carry = cp.step(lits, cp.init_carry(), cp.rows, *builds,
                            *arrays)
            _fence(self.device)
            dt = time.perf_counter() - t0
            moved = sum(a.nbytes for a in arrays) \
                + sum(b.nbytes for b in builds)
            sp.set(measured_s=dt, measured_bytes=moved)
            self.tel.ledger.record_plan(phys, dt, moved, mode="fused",
                                        shards=self.n_shards)
            return cp.finalize(carry), hit

    def _route_to_refine(self, node: L.Node, splan: pl.StreamPlan) -> bool:
        """Whether a breaker-free aggregate pipeline should leave its
        fused full-column scan for the eager path because the semantic
        cache holds a selection bitmap (exact or superset) that the cost
        model prices below the scan.  A performance decision only: both
        paths give the same bits, and the eager lowering makes the real
        (exact first, then tightest superset) lookup."""
        if self.cache is None or splan.breakers:
            return False
        if node not in self._sints:
            self._sints[node] = L.selection_interval(node)
        si = self._sints[node]
        if si is None or si.table not in self.catalog.tables:
            return False
        version = self.catalog.tables[si.table].version
        gate = self._refine_gate(self.catalog.stats[si.table].num_rows)
        exact = self.cache.peek(("bitmap", si.table, version, si.column,
                                 si.lo, si.hi))
        if exact is not None:
            # serving the exact bitmap streams only the selected rows;
            # it is priced as refinement is
            return gate(exact)
        return self.cache.peek_superset(si.table, si.column, version,
                                        si.lo, si.hi, accept=gate) \
            is not None

    def _cache_key(self, node: L.Node, phys: PhysNode) -> tuple:
        shapes = tuple(sorted(
            (t, self.catalog.stats[t].num_rows)
            for t in {n.table for n in L.walk(node)
                      if isinstance(n, L.Scan)}))
        decisions = tuple(
            (p.op, p.impl, p.placement, p.n_passes, p.shard_strategy)
            for p in _walk_phys(phys)) if phys else ()
        # the layout keeps a sharded and an unsharded plan apart
        return (L.signature(node), shapes, decisions,
                self.cost_model.n_engines, self.cost_epoch,
                self._layout_key())

    def _pipeline(self, node: L.Node, phys: PhysNode,
                  splan: pl.StreamPlan, *, rows: Optional[int]):
        """The cached pipeline for this plan shape at one granularity
        (``rows=None``: the whole base table) plus its stream-column
        placements."""
        key = (rows,) + self._cache_key(node, phys)
        hit = key in self._compiled
        if hit:
            self.metrics.inc("exec.plan_cache_hits")
        else:
            self.metrics.inc("exec.plan_cache_misses")
            self.metrics.inc("exec.trace_count")
            placements = column_placements(phys)
            table = splan.base_scan.table
            specs = tuple(
                (table, c, placements.get((table, c),
                                          placements.get((table, "*"),
                                                         "partitioned")))
                for c in splan.stream_cols)
            cp = pl.compile_pipeline(
                splan, rows or self.catalog.stats[table].num_rows,
                self._agg_dtype(splan), self.device,
                shard=self.shard_layout)
            self._compiled[key] = (cp, specs)
        cp, specs = self._compiled[key]
        return cp, specs, hit

    def _agg_dtype(self, splan: pl.StreamPlan) -> torch.dtype:
        name = splan.node.column
        for t in (splan.base_scan.table, *(b.table for b in splan.breakers)):
            cols = self.catalog.tables[t].columns
            if name in cols:
                dt = cols[name].dtype
                return dt if isinstance(dt, torch.dtype) \
                    else torch.from_numpy(np.zeros(0, dt)).dtype
        return torch.int32

    def _breaker_arrays(self, breakers) -> list:
        """Flattened join-build state (the pipeline breakers), per build
        table version.  With a semantic cache the builds live there, byte-
        budgeted (an evicted build is rebuilt) and shared with every
        executor of the cache; without one, in a private dict."""
        flat: list = []
        for b in breakers:
            version = self.catalog.tables[b.table].version
            if self.cache is not None:
                ckey = ("build", b.table, version, b.on, b.value_cols,
                        b.unique)
                entry = self.cache.get(ckey)
                if entry is not None:
                    self.metrics.inc("exec.build_cache_hits")
                    flat.extend(self._served(entry))
                    continue
                arrays = self._make_build(b)
                self.cache.put(
                    ckey, arrays, kind="build",
                    n_bytes=_value_nbytes(arrays),
                    recompute_s=self.cost_model.build_price(
                        self.catalog.stats[b.table].num_rows,
                        len(b.value_cols)),
                    tables=(b.table,), tenant=self.tenant)
                flat.extend(arrays)
                continue
            key = (b, version)
            if key not in self._builds:
                self._builds[key] = self._make_build(b)
            flat.extend(self._builds[key])
        return flat

    def _make_build(self, b: pl.BreakerSpec) -> tuple:
        cols = {c: Column(self.placed(b.table, c, "replicated"), c)
                for c in (b.on, *b.value_cols)}
        return engine.join_build(Table(b.table, cols), b.on, b.value_cols,
                                 unique=b.unique).flat()

    # -- tiered spill ------------------------------------------------------- #

    def _maybe_spill(self, node: L.Node) -> Optional[SpillPlan]:
        """A tier assignment for ``node``'s streamed working set when it
        (with the build sides it keeps on the device) exceeds the device
        budget; None when it fits, or there is no budget, or no
        streamable spine.  The reference spills only when one column is
        over the budget, so several columns each under it but over it
        together stay on its device; the port counts them together.
        Columns the plan sends down are demoted in the catalog (host
        numpy, disk memmap; values unchanged, so table versions do not
        move) and their cached device placements dropped.  Raises only
        when the working set overflows even the disk budget."""
        self.last_spill = None
        budget = self.tier_budgets.device
        if budget is None:
            return None
        splan = pl.analyze(node, self.catalog.stats)
        if splan is None:
            splan = pl.analyze_project(node, self.catalog.stats)
        if splan is not None:
            table, cols = splan.base_scan.table, splan.stream_cols
            breakers = splan.breakers
        else:
            # scan-rooted training sets spill too: epochs stream morsels
            # straight off the demoted catalog columns.  A filtered train
            # materializes a compacted (smaller) set first
            tplan = pl.analyze_train(node, self.catalog.stats)
            if tplan is None or tplan.filtered:
                return None
            table, cols, breakers = (tplan.base_scan.table,
                                     tplan.stream_cols, ())
        tab = self.catalog.tables[table]
        sizes = [((table, c), tab.columns[c].nbytes) for c in cols]
        # build sides stay on the device: carve them out of its budget
        reserved = sum(self.catalog.tables[b.table].columns[c].nbytes
                       for b in breakers for c in (b.on, *b.value_cols))
        total = sum(n for _, n in sizes)
        if total + reserved <= budget:
            return None
        plan = plan_spill(sizes, self.tier_budgets, self.cost_model,
                          reserved_device=reserved)
        if plan.overflow_bytes:
            raise PlacementCapacityError(
                f"working set of {total} bytes over table '{table}' "
                f"overflows the whole tier hierarchy: {plan.describe()} "
                f"(budgets device={self.tier_budgets.device} "
                f"host={self.tier_budgets.host} "
                f"disk={self.tier_budgets.disk}, "
                f"{plan.overflow_bytes} bytes have no tier).  Raise a "
                "tier budget or reduce the query's streamed column set")
        if self._spill_dir is None:
            self._spill_dir = default_spill_dir()
        demoted = set()
        for (t, c), tier in plan.tiers.items():
            if tier != "device":
                self.catalog.tables[t].demote_column(c, tier, self._spill_dir)
                demoted.add((t, c))
        self._placed = {k: v for k, v in self._placed.items()
                        if k[:2] not in demoted}
        self.last_spill = plan
        self.metrics.set("exec.spilled_columns", sum(
            1 for t in plan.tiers.values() if t != "device"))
        self.tel.instant("exec.spill", table=table, plan=plan.describe())
        return plan

    @staticmethod
    def _spill_src_tier(spill: Optional[SpillPlan]) -> str:
        """The slowest tier a spill plan streams from, which prices the
        per-morsel promotion when the model chooses the granularity."""
        if spill is None:
            return "host"
        worst = max(spill.tiers.values(), key=TIERS.index)
        return worst if worst != "device" else "host"

    def _clamp_spec(self, spec: MorselSpec, n_cols: int,
                    cap: int) -> MorselSpec:
        """Shrink a model-chosen morsel spec until one morsel's bytes fit
        the device budget, floor-aligned to the engine count."""
        if spec.rows * BYTES_PER_VALUE * n_cols <= cap:
            return spec
        n_eng = self.plans["partitioned"].n_engines
        rows = max((int(cap) // (BYTES_PER_VALUE * max(n_cols, 1)))
                   // n_eng * n_eng, n_eng)
        return MorselSpec(spec.total_rows, rows)

    def _stream_spec(self, table: str, n_cols: int,
                     target: Optional[int], morsel_rows: Optional[int],
                     spill: Optional[SpillPlan]) -> MorselSpec:
        """The morsel spec of a stream over ``table``: ``target`` (or the
        model's choice), clamped under the device budget when the model
        chose it.  Under an explicit capacity an explicit ``morsel_rows``
        whose one morsel is over it is refused."""
        cap = self.placement_capacity_bytes
        spec = self.morsel_spec(table, target, n_cols=n_cols,
                                src_tier=self._spill_src_tier(spill))
        if cap is None:
            return spec
        if morsel_rows is None:
            return self._clamp_spec(spec, n_cols, cap)
        m_bytes = spec.rows * BYTES_PER_VALUE * n_cols
        if self._cap_explicit and m_bytes > cap:
            fit = self._clamp_spec(spec, n_cols, cap).rows
            raise PlacementCapacityError(
                f"one morsel ({spec.rows} rows x {n_cols} cols = {m_bytes} "
                f"bytes) exceeds the {int(cap)}-byte placement capacity: "
                f"lower morsel_rows to <= {fit}")
        return spec

    def _prefetch(self, table: str, cols) -> bool:
        """Stage morsels on the prefetch thread only when a streamed
        column lives below the device.  A device-resident morsel is a
        slice, with no transfer to overlap, and the thread then only
        contends for the interpreter lock: SSB Q1.1 at SF 10 in stream
        mode on an H100 took a median 20.2 ms with it and 11.6 ms
        without."""
        tab = self.catalog.tables[table]
        return self.overlap_transfers and any(
            tab.columns[c].tier != "device" for c in cols)

    def _morsel_getter(self, table: str, spec: MorselSpec, cols):
        """Morsel ``i`` of ``cols`` as (arrays in ``cols`` order, valid
        rows); host and disk columns come back as numpy for the morsel
        loop to stage."""
        tab = self.catalog.tables[table]

        def get(i):
            data, n_valid = tab.morsel(spec, i, cols)
            return [data[c] for c in cols], n_valid

        return get

    def _promotion_observer(self, table: str, cols,
                            promote: Dict[str, list]):
        """``staged_morsels``' ``on_staged`` hook when telemetry is on and
        a streamed column lives below the device, else None: it counts
        each morsel's promoted bytes (the valid rows of the numpy slices
        from host and disk; the zero pad of the last morsel was read from
        nowhere) with their share of the fenced fetch time.  It runs on
        the prefetch thread; the registry takes its lock."""
        tiers = [self.catalog.tables[table].columns[c].tier for c in cols]
        if not self.tel.enabled or all(t == "device" for t in tiers):
            return None

        def observe(arrays, n_valid, seconds):
            moved: Dict[str, int] = {}
            for a, tier in zip(arrays, tiers):
                if tier != "device":
                    moved[tier] = moved.get(tier, 0) \
                        + int(a[:n_valid].nbytes)
            total = sum(moved.values())
            for tier, n in moved.items():
                self._count_promotion(promote, n, seconds * n / total, tier)

        return observe

    def _count_promotion(self, promote: Dict[str, list], n_bytes: int,
                         seconds: float, tier: str) -> None:
        """Add one promotion from ``tier`` to ``promote`` (tier -> [bytes,
        seconds]) and to ``exec.promote_bytes.<tier>``; device-resident
        bytes were not promoted and count nowhere."""
        if tier == "device":
            return
        acc = promote.setdefault(tier, [0, 0.0])
        acc[0] += n_bytes
        acc[1] += seconds
        self.metrics.inc(f"exec.promote_bytes.{tier}", n_bytes)

    def _record_promotions(self, promote: Dict[str, list]) -> None:
        """Ledger rows for spill-promotion traffic: op="promote" per
        source tier, measured in the morsel fetch, predicted by the
        model's tier channel — the pair the recalibration loop folds back
        into h2d/disk bandwidth."""
        for tier, (n_bytes, seconds) in promote.items():
            self.tel.ledger.record(
                op="promote", impl="promote", placement=tier,
                predicted_bytes=float(n_bytes),
                predicted_s=self.cost_model.promotion_cost(
                    float(n_bytes), tier),
                measured_bytes=float(n_bytes), measured_s=seconds,
                mode="stream", tier=tier)

    # -- streaming path (morsel-driven pipeline) ---------------------------- #

    def _run_stream(self, node: L.Node, phys: PhysNode,
                    splan: pl.StreamPlan, morsel_rows: Optional[int],
                    spill: Optional[SpillPlan] = None):
        """Drive the pipeline morsel by morsel.  Without a device budget
        the granularity is ``morsel_rows`` or the model's choice for a
        device-resident source; with one, the plan's priced morsel size,
        clamped under the budget.  Host and disk columns are promoted
        morsel by morsel through the prefetch thread."""
        table = splan.base_scan.table
        n_cols = len(splan.stream_cols)
        target = morsel_rows or (
            phys.morsel_rows if phys is not None
            and self.placement_capacity_bytes is not None else None)
        spec = self._stream_spec(table, n_cols, target, morsel_rows, spill)
        cp, _, hit = self._pipeline(node, phys, splan, rows=spec.rows)
        builds = self._breaker_arrays(splan.breakers)
        get = self._morsel_getter(table, spec, cp.stream_cols)
        prefetch = self._prefetch(table, cp.stream_cols)
        if not self.tel.enabled:
            carry = pl.drive(cp, spec.n_morsels, get, builds,
                             L.literals(node), self.device,
                             prefetch=prefetch)
            return cp.finalize(carry), hit
        promote: Dict[str, list] = {}
        with self.tel.span("exec.run_stream", n_morsels=spec.n_morsels,
                           morsel_rows=spec.rows, compiled_hit=hit) as sp:
            _fence(self.device)
            t0 = time.perf_counter()
            carry = pl.drive(
                cp, spec.n_morsels, get, builds, L.literals(node),
                self.device, prefetch=prefetch, telemetry=self.tel,
                metrics=self.metrics,
                on_staged=self._promotion_observer(table, cp.stream_cols,
                                                   promote))
            _fence(self.device)
            dt = time.perf_counter() - t0
            moved = self.catalog.stats[table].num_rows * BYTES_PER_VALUE \
                * len(cp.stream_cols) + sum(b.nbytes for b in builds)
            sp.set(measured_s=dt, measured_bytes=moved)
            self.tel.ledger.record_plan(phys, dt, moved, mode="stream",
                                        shards=self.n_shards)
            self._record_promotions(promote)
            return cp.finalize(carry), hit

    def _run_stream_project(self, node: L.Node, phys: Optional[PhysNode],
                            pplan: pl.ProjectStreamPlan,
                            morsel_rows: Optional[int],
                            spill: Optional[SpillPlan] = None) -> Table:
        """Project-rooted spilled execution: each morsel's survivors are
        compacted on the device and the chunks concatenated in morsel
        order (= table order), so the result equals the eager
        materialization bit for bit."""
        table = pplan.base_scan.table
        spec = self._stream_spec(table, len(pplan.stream_cols), morsel_rows,
                                 morsel_rows, spill)
        cpj = self._project_compiled(node, phys, pplan, spec.rows)
        builds = self._breaker_arrays(pplan.breakers)
        lits = L.literals(node)
        chunks = {c: [] for c in cpj.out_cols}
        promote: Dict[str, list] = {}
        if self.tel.enabled:
            _fence(self.device)
        t0 = time.perf_counter()
        morsels = pl.staged_morsels(
            spec.n_morsels, self._morsel_getter(table, spec,
                                                cpj.stream_cols),
            self.device, prefetch=self._prefetch(table, cpj.stream_cols),
            on_staged=self._promotion_observer(table, cpj.stream_cols,
                                               promote))
        with contextlib.closing(morsels):
            for arrays, n_valid in morsels:
                mask, outs = cpj.step(lits, n_valid, *builds, *arrays)
                for c, a in zip(cpj.out_cols, outs):
                    chunks[c].append(a[mask])
        value = Table("proj", {c: Column(torch.cat(chunks[c]), c)
                               for c in cpj.out_cols})
        if self.tel.enabled:
            _fence(self.device)
            dt = time.perf_counter() - t0
            moved = self.catalog.stats[table].num_rows * BYTES_PER_VALUE \
                * len(cpj.stream_cols) + sum(b.nbytes for b in builds)
            self.tel.ledger.record_plan(phys, dt, moved, mode="stream",
                                        shards=self.n_shards)
            self._record_promotions(promote)
        return value

    def _project_compiled(self, node: L.Node, phys: Optional[PhysNode],
                          pplan: pl.ProjectStreamPlan,
                          rows: int) -> pl.CompiledProject:
        """The cached Project-rooted step for this plan shape at one
        granularity."""
        key = ("proj", rows) + self._cache_key(node, phys)
        if key in self._compiled:
            self.metrics.inc("exec.plan_cache_hits")
        else:
            self.metrics.inc("exec.plan_cache_misses")
            self.metrics.inc("exec.trace_count")
            self._compiled[key] = pl.compile_project_pipeline(
                pplan, rows, self.device, shard=self.shard_layout)
        return self._compiled[key]

    # -- the query server's shared morsel streams --------------------------- #

    def stream_pipeline(self, node: L.Node, phys: Optional[PhysNode],
                        splan: pl.StreamPlan, spec: MorselSpec):
        """The compiled per-morsel step and the join builds of one plan at
        one granularity, for a caller that advances the morsels itself.
        Returns (pipeline, build arrays, compiled hit).  Under an explicit
        capacity a morsel over it is refused."""
        key = ("stream", spec.rows) + self._cache_key(node, phys)
        hit = key in self._compiled
        if hit:
            self.metrics.inc("exec.plan_cache_hits")
        else:
            self.metrics.inc("exec.plan_cache_misses")
            self.metrics.inc("exec.trace_count")
            self._compiled[key] = pl.compile_pipeline(
                splan, spec.rows, self._agg_dtype(splan), self.device,
                shard=self.shard_layout)
        cp = self._compiled[key]
        builds = self._breaker_arrays(splan.breakers)
        # the one-morsel gate holds only under an explicit capacity; a
        # budget from the environment clamps model-chosen specs instead
        cap = self.placement_capacity_bytes if self._cap_explicit else None
        if cap is not None:
            n_cols = len(cp.stream_cols)
            m_bytes = spec.rows * BYTES_PER_VALUE * n_cols
            if m_bytes > cap:
                fit = self._clamp_spec(spec, n_cols, cap).rows
                raise PlacementCapacityError(
                    f"one morsel ({spec.rows} rows x {n_cols} cols = "
                    f"{m_bytes} bytes) exceeds the {int(cap)}-byte "
                    f"placement capacity: lower morsel_rows to <= {fit}")
        return cp, builds, hit

    def project_pipeline(self, node: L.Node, phys: Optional[PhysNode],
                         pplan: pl.ProjectStreamPlan, spec: MorselSpec):
        """The compiled Project-rooted step and its join builds at one
        granularity: each morsel yields the mask and the output columns,
        which the caller compacts into a chunk."""
        cpj = self._project_compiled(node, phys, pplan, spec.rows)
        return cpj, self._breaker_arrays(pplan.breakers)

    def _stream_morsel(self, table: str, cols: Tuple[str, ...],
                       spec: MorselSpec, i: int,
                       promote: Optional[Dict[str, list]] = None):
        """Morsel ``i`` of ``cols`` on this executor's device, as (arrays
        in ``cols`` order, valid rows as a Python int, so a morsel costs
        no device round trip).  A device-resident column's morsel is a
        slice of it.  Host and disk columns are read here and sent from
        pinned memory on the current stream, so the step that follows is
        ordered after the copy.  With telemetry on, ``promote`` counts
        their valid bytes and fenced fetch time (``_count_promotion``)."""
        tab = self.catalog.tables[table]
        tiers = [tab.columns[c].tier for c in cols]
        below = any(t != "device" for t in tiers)
        counted = below and promote is not None and self.tel.enabled
        t0 = time.perf_counter() if counted else 0.0
        data, n_valid = tab.morsel(spec, i, cols)
        arrays = [data[c] for c in cols]
        if not below:
            return tuple(arrays), int(n_valid)
        on_card = self.device.type == "cuda"
        staged = pl._stage(arrays, self.device,
                           torch.cuda.current_stream(self.device)
                           if on_card else None)
        if counted:
            _fence(self.device)
            seconds = time.perf_counter() - t0
            moved: Dict[str, int] = {}
            for a, tier in zip(arrays, tiers):
                if tier != "device":
                    moved[tier] = moved.get(tier, 0) \
                        + int(a[:n_valid].nbytes)
            total = sum(moved.values()) or 1
            for tier, n in moved.items():
                self._count_promotion(promote, n, seconds * n / total, tier)
        return tuple(staged), int(n_valid)

    def morsel_spec(self, table: str, target: Optional[int] = None,
                    n_cols: int = 2, src_tier: str = "host") -> MorselSpec:
        """Morsel granularity for a stream over ``table``: ``target``, or
        the cost model's choice — priced with the per-morsel promotion
        from ``src_tier`` under a device budget, as a device-resident
        source otherwise — aligned by the partitioned plan (under a shard
        layout, to the engines and the shards at once, so every morsel
        splits into the shards' slices)."""
        total = self.catalog.stats[table].num_rows
        plan = self.plans["partitioned"]
        if self.shard_layout is not None:
            plan = dataclasses.replace(plan, n_engines=math.lcm(
                plan.n_engines, self.n_shards))
        if target is None:
            target = self.cost_model.choose_morsel_rows(
                total, max(n_cols, 1),
                include_transfer=self.placement_capacity_bytes is not None,
                src_tier=src_tier)
        return MorselSpec.for_plan(total, target, plan)

    # -- GLM training (morsel-streamed epochs) ------------------------------ #

    def _run_train(self, node: L.TrainGLM, phys: Optional[PhysNode],
                   tplan: pl.TrainStreamPlan, morsel_rows: Optional[int]):
        """TrainGLM-rooted streamed execution (paper §VI, workload 3):
        every epoch streams the training set morsel by morsel through the
        K-model SGD kernel with the weights as the only cross-morsel
        carry.  A filter under the train root materializes the selected
        rows once (the pipeline breaker: streamed compaction would make
        minibatch boundaries data-dependent) and epochs stream off that
        transient table; a bare scan streams straight off the catalog
        table, tier-aware, so a training set that a spill plan demoted
        trains out of core, its morsels clamped under the device
        budget."""
        if tplan.filtered:
            child_phys = phys.children[0] if phys and phys.children \
                else None
            source = self._run_eager(node.child, child_phys)
        else:
            source = self.catalog.tables[tplan.base_scan.table]
        cap = self.placement_capacity_bytes
        target = morsel_rows or (phys.morsel_rows if phys else None)
        if target is not None and morsel_rows is None and cap is not None:
            target = self._clamp_spec(MorselSpec(source.num_rows, target),
                                      len(tplan.stream_cols), cap).rows
        cplan = self.plans.get(phys.placement if phys else "partitioned",
                               self.plans["partitioned"])
        if not self.tel.enabled:
            return engine.train_glm_stream(
                source, list(node.features), node.label, list(node.grid),
                cplan, kind=node.kind, epochs=node.epochs,
                morsel_rows=target)
        promote: Dict[str, list] = {}
        with self.tel.span("exec.run_train", epochs=node.epochs,
                           k=len(node.grid),
                           morsel_rows=target or source.num_rows) as sp:
            _fence(self.device)
            t0 = time.perf_counter()
            value = engine.train_glm_stream(
                source, list(node.features), node.label, list(node.grid),
                cplan, kind=node.kind, epochs=node.epochs,
                morsel_rows=target,
                on_morsel=functools.partial(self._count_promotion, promote))
            _fence(self.device)
            dt = time.perf_counter() - t0
            # the cost formula at the actual cardinality (as in
            # _eager_measured_bytes): drift isolates estimation error
            moved = source.num_rows * BYTES_PER_VALUE \
                * len(tplan.stream_cols) * node.epochs * len(node.grid)
            sp.set(measured_s=dt, measured_bytes=moved)
            self.tel.ledger.record_plan(phys, dt, moved, mode="stream",
                                        shards=self.n_shards)
            self._record_promotions(promote)
            return value

    def _resolve_model(self, n: L.ScoreGLM, phys: Optional[PhysNode]):
        """Weights for a ScoreGLM: the semantic cache's model under the
        train plan's fingerprint (or the raw ``model_fp``), else a fresh
        train through ``execute``, which admits the model for the next
        score.  Without a cache, or with no entry, it trains fresh; a raw
        fingerprint with no entry raises.  The naive oracle (``phys is
        None``) neither reads nor feeds the cache: it trains inline."""
        fp = n.model_fp or (self.fingerprint_of(n.train)
                            if n.train is not None else "")
        if phys is not None and self.cache is not None and fp:
            entry = self.cache.get(("model", fp))
            if entry is not None:
                self.metrics.inc("exec.model_cache_hits")
                self.tel.instant("exec.model_hit", fingerprint=fp[:16])
                return self._served(entry)
        if n.train is None:
            raise KeyError(
                f"score_glm: no cached model under fingerprint {fp!r} "
                "and no defining train plan to fall back to — train first "
                "(with a semantic cache installed) or score with the "
                "TrainGLM plan instead of a raw fingerprint")
        if phys is None:
            return self._run_eager(n.train, None)
        return self.execute(n.train).value

    # -- eager path (engine operators, BAT-style intermediates) ------------- #

    def _run_eager(self, node: L.Node, phys: Optional[PhysNode]):
        placements = column_placements(phys) if phys else {}
        decisions = {p.logical: p for p in _walk_phys(phys)} if phys \
            else {}
        # the bandwidth ledger's per-operator rows: the eager lowering is
        # the one path where every operator can be fenced alone.  Each
        # evaluated node gets a frame; its exclusive time is its
        # inclusive (fenced) time minus its children's, and its measured
        # bytes are the cost model's formulas at actual cardinalities, so
        # drift_bytes isolates estimation error and drift_time the
        # bandwidth model's
        ledger_on = self.tel.enabled and phys is not None
        frames: list = []        # per live node: [child_incl_s, child_outs]
        versions = self.catalog.versions() if self.cache is not None \
            else None

        def traced_eval(n):
            if not ledger_on:
                return eval_node(n)
            frames.append([0.0, []])
            _fence(self.device)
            t0 = time.perf_counter()
            out = eval_node(n)
            _fence(self.device)
            incl = time.perf_counter() - t0
            child_s, child_outs = frames.pop()
            d = decisions.get(n)
            if d is not None:
                self.tel.complete(f"op.{d.op}", t0, incl, impl=d.impl,
                                  placement=d.placement)
                self.tel.ledger.record(
                    op=d.op, impl=d.impl, placement=d.placement,
                    predicted_bytes=d.n_bytes, predicted_s=d.cost_s,
                    measured_bytes=_eager_measured_bytes(d, out,
                                                         child_outs),
                    measured_s=max(incl - child_s, 0.0), mode="eager")
            if frames:
                frames[-1][0] += incl
                frames[-1][1].append((n, out))
            return out

        def scan_placement(n: L.Scan) -> str:
            cols = n.columns or ("*",)
            return placements.get((n.table, cols[0]),
                                  placements.get((n.table, "*"),
                                                 "partitioned"))

        def eval_cached(n):
            # subplan caching (optimized runs only): materialized
            # selections and join products go to the semantic cache under
            # order-sensitive fingerprints (row order is part of a
            # materialized table), priced by the plan's per-operator cost
            if self.cache is None or phys is None or \
                    not isinstance(n, (L.Filter, L.FilterProject, L.Join)):
                return traced_eval(n)
            key = ("subplan", L.fingerprint(n, versions,
                                            order_sensitive=True))
            entry = self.cache.get(key)
            if entry is not None:
                self.metrics.inc("exec.subplan_cache_hits")
                value = self._served(entry)
                # served, not run: no ledger row, but the parent's bytes
                # mirror still needs this child's actual cardinality
                if ledger_on and frames:
                    frames[-1][1].append((n, value))
                return value
            t = traced_eval(n)
            d = decisions.get(n)
            self.cache.put(key, t, kind="subplan", n_bytes=_value_nbytes(t),
                           recompute_s=d.total_cost_s if d is not None
                           else 0.0,
                           tables=L.tables_of(n), tenant=self.tenant)
            return t

        def eval_node(n):
            if isinstance(n, L.Scan):
                return self._placed_table(n, scan_placement(n))
            if isinstance(n, (L.Filter, L.FilterProject)):
                t = eval_cached(n.child)
                keep = n.columns if isinstance(n, L.FilterProject) \
                    else tuple(t.columns)
                return self._filter_table(t, n.column, n.lo, n.hi, keep,
                                          cache_ok=phys is not None)
            if isinstance(n, L.Join):
                lt = eval_cached(n.left)
                rt = eval_cached(n.right)
                d = decisions.get(n)
                if d is not None and d.shard_strategy == "shuffle" \
                        and self.shard_layout is not None:
                    # the costed alternative to broadcasting the build:
                    # both sides repartition by key and each shard joins
                    # its buckets; the pairs come back in the broadcast
                    # join's probe-row order
                    pairs = engine.join_shuffle(lt, rt, n.on,
                                                self.shard_layout)
                else:
                    if lt.plan is None:
                        pname = "partitioned" if lt.num_rows \
                            % self.plans["partitioned"].n_engines == 0 \
                            else "congested"
                        lt = lt.place(self.plans[pname])
                    pairs = engine.join(
                        lt, rt, n.on, unique=key_is_unique(
                            n.right, n.on, self.catalog.stats))
                l_idx, r_idx = pairs.column("l_idx"), pairs.column("r_idx")
                cols = {c: Column(lt.column(c)[l_idx], c)
                        for c in lt.columns}
                for c in rt.columns:
                    if c not in cols:
                        cols[c] = Column(rt.column(c)[r_idx], c)
                return Table("join", cols)
            if isinstance(n, L.Project):
                t = eval_cached(n.child)
                return Table("proj", {c: t.columns[c] for c in n.columns})
            if isinstance(n, L.Aggregate):
                col = eval_cached(n.child).column(n.column)
                if n.op == "sum":
                    return float(col.sum()) if col.dtype.is_floating_point \
                        else int(col.sum(dtype=torch.int64))
                if n.op == "count":
                    return int(col.shape[0])
                if n.op == "mean":
                    if col.shape[0] == 0:   # match the fused path: 0, not NaN
                        return 0.0
                    return float(col.to(torch.float32).mean())
                raise ValueError(n.op)
            if isinstance(n, L.TrainGLM):
                t = eval_cached(n.child)
                # the placement the cost model chose, so explain() and
                # execution agree
                d = decisions.get(n)
                cplan = self.plans.get(
                    d.placement if d is not None else "partitioned",
                    self.plans["partitioned"])
                return engine.train_glm(t, list(n.features), n.label,
                                        list(n.grid), cplan, kind=n.kind,
                                        epochs=n.epochs)
            if isinstance(n, L.ScoreGLM):
                t = eval_cached(n.child)
                xs, losses = self._resolve_model(n, phys)
                idx = int(n.select) if n.select >= 0 \
                    else int(torch.argmin(losses))
                a = torch.stack([t.column(f).to(torch.float32)
                                 for f in n.features], dim=1)
                z = torch.matmul(a, xs[idx])
                s = torch.sigmoid(z) if n.kind == "logreg" else z
                return Table("score", {"score": Column(s, "score")})
            raise TypeError(n)

        return traced_eval(node)

    def _filter_table(self, t: Table, column: str, lo: int, hi: int,
                      keep: Tuple[str, ...], *, block: int = 1024,
                      cache_ok: bool = True) -> Table:
        """Selection -> gather.  A miss goes through ``engine.select_range``
        (the selection kernel on the card): the kernel masks ragged
        blocks, so the reference's guard that sent non-dividing tables
        and unplaced intermediates to a plain mask is gone.
        Intermediates take the partitioned plan; the index list is the
        same either way.

        With a semantic cache, selections over base tables are cacheable
        bitmaps keyed by the table version: an exact hit gathers at once,
        and an exact miss refines the tightest cached superset when the
        cost model prices that below the scan (``_refine_gate``).  Either
        index list is bit-identical to the kernel's.  ``cache_ok=False``
        is the naive oracle, which neither reads nor feeds the cache."""
        bkey = interval = None
        if cache_ok and self.cache is not None \
                and t.name in self.catalog.tables:
            version = self.catalog.tables[t.name].version
            interval = (t.name, column, version, int(lo), int(hi))
            bkey = ("bitmap", t.name, version, column, int(lo), int(hi))
            entry = self.cache.get(bkey)
            if entry is not None:
                self.metrics.inc("exec.subplan_cache_hits")
                return self._gather(t, self._served(entry), keep)
            # predicate subsumption: the pricing gate rides inside the
            # lookup, so a superset too wide to refine is never counted
            # as a hit or touched for recency
            sup = self.cache.lookup_superset(
                t.name, column, version, int(lo), int(hi),
                accept=self._refine_gate(t.num_rows))
            if sup is not None:
                cached_idx = self._served(sup[0])
                idx = self._refine_bitmap(t.column(column), cached_idx,
                                          lo, hi,
                                          chunk_rows=self._refine_chunk())
                self.metrics.inc("exec.subsumption_hits")
                self.metrics.inc("exec.refine_bytes_streamed",
                                 3 * _value_nbytes(cached_idx))
                self.metrics.inc("exec.refine_bytes_avoided",
                                 t.num_rows * BYTES_PER_VALUE)
                self.tel.instant("cache.refine", table=t.name,
                                 column=column,
                                 cached_rows=int(cached_idx.shape[0]))
                # the refined (narrower) bitmap joins the ladder
                self._admit_bitmap(bkey, idx, interval, t)
                return self._gather(t, idx, keep)
        plan = t.plan if t.plan is not None else self.plans["partitioned"]
        sel = engine.select_range(Table(t.name, t.columns, plan), column,
                                  lo, hi, block=block)
        idx = sel.column("idx")
        if bkey is not None:
            self._admit_bitmap(bkey, idx, interval, t)
        return self._gather(t, idx, keep)

    @staticmethod
    def _gather(t: Table, idx: torch.Tensor, keep) -> Table:
        return engine.gather(t, idx, [c for c in keep if c in t.columns],
                             name=f"{t.name}.sel")

    def _refine_gate(self, base_rows: int):
        """The accept predicate of superset lookups: a cached bitmap
        qualifies only when refining it is priced below rescanning the
        base column."""
        return lambda e: self.cost_model.refine_wins(
            int(e.value.shape[0]), base_rows)

    def _admit_bitmap(self, bkey, idx: torch.Tensor, interval,
                      t: Table) -> None:
        """One admission for scanned and refined bitmaps, both priced at
        the full base-column recompute (a refined entry is no cheaper to
        lose: its superset may be gone by rebuild time)."""
        self.cache.put(
            bkey, idx, kind="bitmap", n_bytes=_value_nbytes(idx),
            recompute_s=self.cost_model.stream_cost(
                t.num_rows * BYTES_PER_VALUE, placement="partitioned"),
            tables=(t.name,), interval=interval, tenant=self.tenant)

    def _refine_chunk(self) -> Optional[int]:
        """Refinement granularity: None (one gather) without a device
        budget; under one, slices of the cached index whose index and
        gathered values (8 bytes a row) fit the budget."""
        cap = self.placement_capacity_bytes
        if cap is None:
            return None
        return max(int(cap // 8), 1)

    @staticmethod
    def _refine_bitmap(col: torch.Tensor, cached_idx: torch.Tensor,
                       lo: int, hi: int, *,
                       chunk_rows: Optional[int] = None) -> torch.Tensor:
        """AND a cached superset bitmap with the narrower range: gather
        the predicate column at the cached positions and keep the
        survivors.  ``cached_idx`` is ascending and compaction keeps
        order, so the result is bit-identical to a from-scratch selection,
        order and dtype included.  ``chunk_rows`` refines one bounded
        slice of the cached index at a time; the slices partition the
        ascending index, so their concatenation is the one-gather answer.
        Reads the cached index and writes only new tensors."""
        n = int(cached_idx.shape[0])
        if chunk_rows is None or chunk_rows >= n:
            parts = [cached_idx]
        else:
            parts = [cached_idx[s:s + chunk_rows]
                     for s in range(0, n, chunk_rows)]
        out = []
        for sub in parts:
            mask = engine.in_range(col[sub], lo, hi)
            out.append(sub[engine.compact_positions(mask, int(mask.sum()))])
        return out[0] if len(out) == 1 else torch.cat(out)


def _fence(device: torch.device) -> None:
    """Wait for the card, so a host clock bounds execution and not the
    enqueue of asynchronous launches; nothing to wait for on the CPU.
    Called only with telemetry enabled."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rows_of(value) -> float:
    """Actual output cardinality of an eager operator's materialization."""
    if isinstance(value, Table):
        return float(value.num_rows)
    return 1.0


def _eager_measured_bytes(d: PhysNode, out, child_outs) -> float:
    """Bytes an eager operator moved: ``plan_physical``'s n_bytes formulas
    evaluated with measured cardinalities instead of estimates, so
    drift_bytes is 1.0 exactly when the estimates were exact, whatever the
    bandwidth model (whose error shows in drift_time)."""
    B = BYTES_PER_VALUE
    rows_out = _rows_of(out)
    kids = [_rows_of(v) for _, v in child_outs]
    in_rows = kids[0] if kids else rows_out
    if d.op == "scan":
        n_cols = len(out.columns) if isinstance(out, Table) else 1
        return rows_out * B * n_cols
    if d.op in ("filter", "filter_project"):
        n_out_cols = len(d.logical.columns) if d.op == "filter_project" \
            else 1
        return in_rows * B + rows_out * B * n_out_cols
    if d.op == "join":
        probe = kids[0] if kids else rows_out
        build = kids[1] if len(kids) > 1 else probe
        return probe * B + build * B / d.n_passes
    if d.op == "join_multi":
        probe = max(kids[0] if kids else rows_out, 1.0)
        build = kids[1] if len(kids) > 1 else probe
        chain = max(rows_out / probe, 1.0)
        sort_bytes = build * B * max(math.log2(max(build, 2.0)), 1.0)
        return probe * B * chain \
            + (2 * rows_out * B + sort_bytes) / d.n_passes
    if d.op == "project":
        return rows_out * B * len(d.logical.columns)
    if d.op == "aggregate":
        return in_rows * B
    if d.op == "train_glm":
        n = d.logical
        dataset = in_rows * B * (len(n.features) + 1)
        return dataset * n.epochs * len(n.grid)
    if d.op == "score_glm":
        return in_rows * B * len(d.logical.features) + rows_out * B
    return float(d.n_bytes)     # an op without a formula: the prediction


def _value_nbytes(value) -> int:
    """Residency size of a cached value: the bytes of a tensor, of a
    Table's columns and of a tuple's items; a nominal 16 for a scalar.
    Aggregates come back as Python ``int`` / ``float`` from the fused
    pipeline's ``finalize`` and from the eager lowering alike, so a
    result's size never depends on the path that made it."""
    if isinstance(value, Table):
        return sum(c.nbytes for c in value.columns.values())
    if isinstance(value, (tuple, list)):
        return sum(_value_nbytes(v) for v in value)
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    return int(getattr(value, "nbytes", 16))


def sql_like_query(executor: Executor, q, **kw):
    """UDF surface: run a logical plan through optimize -> cost -> exec."""
    return executor.execute(q, **kw).value
