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
for bit; both train through the SGD kernel on the card.  ScoreGLM roots
score with a model trained fresh through ``execute`` (the port has no
semantic cache yet, so no model is ever served warm).

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

The executor runs on the CUDA card unless constructed with a ``device``;
the kernels run exactly when that device is CUDA, because every kernel
wrapper launches on CUDA tensors and takes its plain version on CPU ones.
The semantic cache and sharding are not ported yet.
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
from repro_torch.query import logical as L
from repro_torch.query import pipeline as pl
from repro_torch.query import telemetry as tm
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

    _COUNTERS = ("exec.plan_cache_hits", "exec.plan_cache_misses",
                 "exec.trace_count")

    def __init__(self, catalog: Catalog, device: DeviceLike = None, *,
                 n_engines: int = 1,
                 cost_model: Optional[CostModel] = None,
                 placement_capacity_bytes: Optional[int] = None,
                 tier_budgets: Optional[TierBudgets] = None,
                 overlap_transfers: Optional[bool] = None,
                 telemetry: Optional[tm.Telemetry] = None):
        self.catalog = catalog
        self.device = resolve(device)
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
            calibration=load_calibration())
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
        self._compiled: Dict[tuple, tuple] = {}
        self._planned: Dict[tuple, tuple] = {}
        self._placed: Dict[tuple, torch.Tensor] = {}
        self._builds: Dict[tuple, tuple] = {}

    # -- metrics ------------------------------------------------------------ #

    def reset_metrics(self) -> None:
        """Zero every counter and histogram (the registry keeps its
        identity, so held references stay valid)."""
        self.metrics.reset()
        for name in self._COUNTERS:
            self.metrics.set(name, 0)

    def metrics_snapshot(self) -> dict:
        """Flat snapshot of the executor's registry: counters verbatim,
        histograms as ``name.{count,mean,p50,p95,max}``."""
        return self.metrics.snapshot()

    def stats_dict(self) -> dict:
        total = self.cache_hits + self.cache_misses
        return {
            "plan_cache_hits": self.cache_hits,
            "plan_cache_misses": self.cache_misses,
            "plan_cache_hit_rate": self.cache_hits / total if total else 0.0,
            "trace_count": self.trace_count,
            "placed_columns": len(self._placed),
            "cached_builds": len(self._builds),
            "cost_model_calibrated_from": self.cost_model.calibrated_from,
            "cost_epoch": self.cost_epoch,
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
        }

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
            if not optimized:
                if mode == "stream":
                    raise ValueError("mode='stream' lowers through the "
                                     "optimizer's physical plan; it cannot "
                                     "combine with optimized=False")
                sp.set(path="naive")
                return Result(self._run_eager(node, None), None, False,
                              time.perf_counter() - t0, mode="eager")
            node, phys = self.plan(node)
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
                    return Result(value, phys, False,
                                  time.perf_counter() - t0, mode="stream")
            if mode == "batch" and spill is not None:
                splan = pl.analyze(node, self.catalog.stats)
                if splan is not None:
                    sp.set(path="spill_stream")
                    value, hit = self._run_stream(node, phys, splan,
                                                  morsel_rows, spill=spill)
                    return Result(value, phys, hit,
                                  time.perf_counter() - t0, mode="stream")
                pplan = pl.analyze_project(node, self.catalog.stats)
                if pplan is not None:
                    sp.set(path="spill_stream_project")
                    value = self._run_stream_project(node, phys, pplan,
                                                     morsel_rows,
                                                     spill=spill)
                    return Result(value, phys, False,
                                  time.perf_counter() - t0, mode="stream")
            if mode == "stream":
                splan = pl.analyze(node, self.catalog.stats)
                if splan is not None:
                    sp.set(path="stream")
                    value, hit = self._run_stream(node, phys, splan,
                                                  morsel_rows, spill=spill)
                    return Result(value, phys, hit,
                                  time.perf_counter() - t0, mode="stream")
                sp.set(reason="no_streamable_spine")
            if mode == "eager":
                sp.set(path="eager")
                value = self._run_eager(node, phys)
                return Result(value, phys, False, time.perf_counter() - t0,
                              mode="eager")
            sp.set(path="batch")
            value, hit = self._run(node, phys)
            return Result(value, phys, hit, time.perf_counter() - t0)

    def plan(self, node: L.Node):
        """optimize + plan_physical, memoized per node and table versions."""
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
            self.tel.ledger.record_plan(phys, dt, moved, mode="fused")
            return cp.finalize(carry), hit

    def _cache_key(self, node: L.Node, phys: PhysNode) -> tuple:
        shapes = tuple(sorted(
            (t, self.catalog.stats[t].num_rows)
            for t in {n.table for n in L.walk(node)
                      if isinstance(n, L.Scan)}))
        decisions = tuple((p.op, p.placement, p.n_passes)
                          for p in _walk_phys(phys))
        return (L.signature(node), shapes, decisions,
                self.cost_model.n_engines, self.cost_epoch)

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
                self._agg_dtype(splan), self.device)
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
        """Flattened join-build state (the pipeline breakers), cached per
        build table version."""
        flat: list = []
        for b in breakers:
            key = (b, self.catalog.tables[b.table].version)
            if key not in self._builds:
                cols = {c: Column(self.placed(b.table, c, "replicated"), c)
                        for c in (b.on, *b.value_cols)}
                self._builds[key] = engine.join_build(
                    Table(b.table, cols), b.on, b.value_cols,
                    unique=b.unique).flat()
            flat.extend(self._builds[key])
        return flat

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
            self.tel.ledger.record_plan(phys, dt, moved, mode="stream")
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
        key = ("project",) + self._cache_key(node, phys)
        if key in self._compiled:
            self.metrics.inc("exec.plan_cache_hits")
        else:
            self.metrics.inc("exec.plan_cache_misses")
            self.metrics.inc("exec.trace_count")
            self._compiled[key] = pl.compile_project_pipeline(pplan,
                                                              self.device)
        cpj = self._compiled[key]
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
            self.tel.ledger.record_plan(phys, dt, moved, mode="stream")
            self._record_promotions(promote)
        return value

    def morsel_spec(self, table: str, target: Optional[int] = None,
                    n_cols: int = 2, src_tier: str = "host") -> MorselSpec:
        """Morsel granularity for a stream over ``table``: ``target``, or
        the cost model's choice — priced with the per-morsel promotion
        from ``src_tier`` under a device budget, as a device-resident
        source otherwise — aligned by the partitioned plan."""
        total = self.catalog.stats[table].num_rows
        if target is None:
            target = self.cost_model.choose_morsel_rows(
                total, max(n_cols, 1),
                include_transfer=self.placement_capacity_bytes is not None,
                src_tier=src_tier)
        return MorselSpec.for_plan(total, target, self.plans["partitioned"])

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
            self.tel.ledger.record_plan(phys, dt, moved, mode="stream")
            self._record_promotions(promote)
            return value

    def _resolve_model(self, n: L.ScoreGLM, phys: Optional[PhysNode]):
        """Weights for a ScoreGLM.  The port has no semantic cache, so it
        trains fresh through ``execute`` (the naive oracle, ``phys is
        None``, trains inline); a raw fingerprint names no model it could
        have, and raises."""
        if n.train is None:
            raise KeyError(
                f"score_glm: no cached model under fingerprint "
                f"{n.model_fp!r} and no defining train plan to fall back "
                "to — score with the TrainGLM plan instead of a raw "
                "fingerprint")
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

        def eval_node(n):
            if isinstance(n, L.Scan):
                return self._placed_table(n, scan_placement(n))
            if isinstance(n, (L.Filter, L.FilterProject)):
                t = traced_eval(n.child)
                keep = n.columns if isinstance(n, L.FilterProject) \
                    else tuple(t.columns)
                return self._filter_table(t, n.column, n.lo, n.hi, keep)
            if isinstance(n, L.Join):
                lt = traced_eval(n.left)
                rt = traced_eval(n.right)
                if lt.plan is None:
                    pname = "partitioned" if lt.num_rows \
                        % self.plans["partitioned"].n_engines == 0 \
                        else "congested"
                    lt = lt.place(self.plans[pname])
                pairs = engine.join(
                    lt, rt, n.on,
                    unique=key_is_unique(n.right, n.on, self.catalog.stats))
                l_idx, r_idx = pairs.column("l_idx"), pairs.column("r_idx")
                cols = {c: Column(lt.column(c)[l_idx], c)
                        for c in lt.columns}
                for c in rt.columns:
                    if c not in cols:
                        cols[c] = Column(rt.column(c)[r_idx], c)
                return Table("join", cols)
            if isinstance(n, L.Project):
                t = traced_eval(n.child)
                return Table("proj", {c: t.columns[c] for c in n.columns})
            if isinstance(n, L.Aggregate):
                col = traced_eval(n.child).column(n.column)
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
                t = traced_eval(n.child)
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
                t = traced_eval(n.child)
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
                      keep: Tuple[str, ...], *, block: int = 1024) -> Table:
        """Selection -> gather.  Every filter goes through
        ``engine.select_range`` (the selection kernel on the card): the
        kernel masks ragged blocks, so the reference's guard
        that sent non-dividing tables and unplaced intermediates to a
        plain mask is gone.  Intermediates take the partitioned plan; the
        index list is the same either way."""
        plan = t.plan if t.plan is not None else self.plans["partitioned"]
        sel = engine.select_range(Table(t.name, t.columns, plan), column,
                                  lo, hi, block=block)
        return engine.gather(t, sel.column("idx"),
                             [c for c in keep if c in t.columns],
                             name=f"{t.name}.sel")


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


def sql_like_query(executor: Executor, q, **kw):
    """UDF surface: run a logical plan through optimize -> cost -> exec."""
    return executor.execute(q, **kw).value
