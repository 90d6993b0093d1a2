"""Query-serving front end: many analysts' queries through one executor.

Two serving disciplines share one ``submit()`` surface:

* **admission batches** (default): ``drain()`` processes the pending set
  as one batch: structurally identical plans are deduplicated,
  compatible selections (one filter over one scan, one aggregate) are
  micro-batched into one pass over their placed columns, and everything
  else goes through the executor (its plan cache and semantic cache
  still apply).  No result is visible until the whole batch finishes.
* **incremental pipeline drain** (``streaming=True``): the server keeps
  one circular morsel stream per base table.  ``pump()`` admits whatever
  is pending (a new query joins the stream at the next morsel boundary)
  and then advances every stream one morsel.  A member completes after
  one full circle over the table (aggregate carries commute, so where it
  started does not matter), so results surface continuously.  Members
  that share a compiled pipeline form a group that takes one step a
  morsel (``CompiledPipeline.group_step``): one fetch of the morsel, one
  probe of each join for the whole group, and ``[G, rows]`` masks for
  the members' different ranges.  On a sharded executor the group step
  is the sharded one: one probe of each join per shard per group, and
  the ledger rows of sharded operators carry shard ids.

Per-query sojourn latency, throughput, the dedup / micro-batch / stream /
cache counters and the executor's statistics come back from ``stats()``.

**Adaptive serving** (``policy=AdaptivePolicy(...)``) closes the measure,
re-cost, re-plan loop: with telemetry on, each advance of a stream is
fenced and recorded in the bandwidth ledger against ``1/n_morsels`` of
every live plan's prediction; ``_maybe_recalibrate`` reads the ledger's
drift window by window and, after ``k_windows`` consecutive breaching
windows, folds ``ledger.calibration_overlay(model)`` into the cost model
through ``Executor.recost()``.  The epoch is part of every compiled key,
so members in flight finish on the pipeline they started with and only
later admissions see the new plans.

**QoS** (``register_tenant(TenantSpec(...))``): admission is ordered by
(priority, deadline, submission) in both disciplines, tenants get
weighted shares of the semantic cache's bytes, and the streaming pump
defers below-top-priority admissions while the recent sojourn p95
breaches the strictest SLO (each record at most 8 times).

**Warm start** (``persist_path=``): a server constructed with a snapshot
path replays it into its executor's cache (host tier) and cost model;
``save_state()`` writes the current state back.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.columnar import engine
from repro_torch.columnar.table import Column, Table
from repro_torch.query import logical as L
from repro_torch.query import exec as qexec
from repro_torch.query import persist
from repro_torch.query import pipeline as pl
from repro_torch.query.exec import Executor
from repro_torch.query.optimize import common_subplans

I64_MIN, I64_MAX = -2 ** 63, 2 ** 63 - 1
# rows of one micro-batch chunk are at least this many: below it the
# per-chunk launches cost more than the temporaries save
MIN_CHUNK_ROWS = 1 << 16


@dataclasses.dataclass
class QueryRecord:
    qid: int
    node: L.Node
    result: object = None
    latency_s: float = 0.0
    path: str = "exec"     # exec | dedup | microbatch | stream | cached
    # monotonic (time.perf_counter) admission and completion stamps; every
    # completion path sets both, and latency_s is always the sojourn
    # t_complete - t_submit, queue wait included
    t_submit: float = 0.0
    t_complete: float = 0.0
    # QoS: the owning tenant, its priority at submission, the absolute
    # deadline (inf = none), and how many pumps backpressure has deferred
    # this record (the starvation guard's input)
    tenant: str = "default"
    priority: int = 0
    deadline: float = float("inf")
    n_deferred: int = 0


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's QoS contract.  ``priority`` orders admission (higher
    first); ``slo_p95_s`` is the sojourn p95 that backpressure defends
    (None = best effort); ``cache_share`` is the tenant's relative weight
    of the shared semantic cache's byte budget."""
    name: str
    priority: int = 0
    slo_p95_s: Optional[float] = None
    cache_share: float = 1.0


@dataclasses.dataclass(frozen=True)
class AdaptivePolicy:
    """When to fold ledger evidence back into the cost model.  A window is
    one ``window_drift`` read with at least ``min_window_rows`` new rows;
    it breaches when any impl's ``|drift_time - 1|`` exceeds
    ``drift_threshold``.  After ``k_windows`` consecutive breaches the
    server re-costs with ``calibration_overlay`` and restarts the evidence
    window, so rows measured against the old model never feed the next
    overlay."""
    drift_threshold: float = 0.5
    k_windows: int = 2
    min_window_rows: int = 8


def _microbatch_key(node: L.Node) -> Optional[tuple]:
    """Aggregate(op, col, Filter(Scan(t), fcol, ?, ?)) -> grouping key."""
    if isinstance(node, L.Aggregate) and isinstance(node.child, L.Filter) \
            and isinstance(node.child.child, L.Scan):
        scan = node.child.child
        return (scan.table, scan.columns, node.child.column, node.op,
                node.column)
    return None


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _lits_tensor(rows, device: torch.device) -> torch.Tensor:
    """Literal rows as a ``[G, n_lits]`` int64 tensor; a bound past int64
    clamps, which selects the same integer rows (every integer path
    clamps into int32 next)."""
    return torch.tensor([[min(max(v, I64_MIN), I64_MAX) for v in r]
                         for r in rows], dtype=torch.int64, device=device)


def _lane(carry, i: int):
    return tuple(x[i] for x in carry) if isinstance(carry, tuple) \
        else carry[i]


def _stack(carries):
    if isinstance(carries[0], tuple):
        return tuple(torch.stack(xs) for xs in zip(*carries))
    return torch.stack(carries)


class _StreamMember:
    """One aggregate query riding a morsel stream.  ``carry`` is the
    member's own only while its group is unstacked; a stacked group holds
    every member's carry in one tensor between pumps."""

    def __init__(self, rec: QueryRecord, lits: Tuple[int, ...],
                 remaining: int, fp: Optional[str] = None,
                 dep_versions: Optional[Dict[str, int]] = None):
        self.rec = rec
        self.lits = lits
        self.carry = None
        self.remaining = remaining
        self.fp = fp                    # semantic fingerprint (dedup key)
        # table versions at attach: a mutation mid-flight makes the
        # partly folded carry meaningless, so the server restarts any
        # member whose snapshot drifts
        self.dep_versions = dep_versions or {}
        self.dups: List[QueryRecord] = []


class _ProjectMember:
    """One Project-rooted query riding a morsel stream: each advance keeps
    the morsel's surviving rows on the device as a chunk keyed by the
    absolute morsel index, so a member that joined mid-circle still
    reassembles its output in table order, equal to the eager
    materialization bit for bit."""

    def __init__(self, rec: QueryRecord, cpj: pl.CompiledProject, builds,
                 lits: Tuple[int, ...], remaining: int, fp: Optional[str],
                 dep_versions: Optional[Dict[str, int]] = None, phys=None):
        self.rec = rec
        self.cpj = cpj
        self.builds = builds
        self.lits = lits
        self.chunks: Dict[int, Dict[str, torch.Tensor]] = {}
        self.remaining = remaining
        self.fp = fp
        self.dep_versions = dep_versions or {}
        self.dups: List[QueryRecord] = []
        self.phys = phys               # the plan its ledger rows price
        self.n_advances = 0            # ledger warm-up gate

    def finalize(self) -> Table:
        order = sorted(self.chunks)
        return Table("proj", {
            c: Column(torch.cat([self.chunks[i][c] for i in order]), c)
            for c in self.cpj.out_cols})


class _Group:
    """Members sharing one compiled pipeline: they differ only in their
    literals and carries, so every advance runs the whole group as one
    ``group_step`` over stacked (lits, carry).  The stacks are rebuilt
    only when membership changes.  The group holds its build tensors, so
    a cache eviction mid-flight drops the cache's reference, never the
    tensors under the group."""

    def __init__(self, cp: pl.CompiledPipeline, builds, phys=None):
        self.cp = cp
        self.builds = builds
        # the physical plan the group was attached under, pinned for its
        # lifetime: a recost compiles new pipelines (the epoch is in the
        # compile key), so later admissions form new groups while this one
        # finishes on its plan and its ledger rows price against it
        self.phys = phys
        self.members: List[_StreamMember] = []
        self.lits = None                  # stacked, padded to a power of 2
        self.carry = None
        self.size = 0
        self.n_advances = 0               # ledger warm-up gate

    def writeback(self):
        """Unstack the group carry into the members before membership
        changes the lane order.  A lone member's live carry is held
        unstacked in ``self.carry`` and is handed back too."""
        if self.carry is not None:
            if self.size == 1:
                self.members[0].carry = self.carry
            else:
                for i, m in enumerate(self.members):
                    m.carry = _lane(self.carry, i)
        self.lits = self.carry = None
        self.size = 0
        # the next advance runs a new group shape: its first step is not
        # warm evidence for the ledger
        self.n_advances = 0

    def restack(self):
        n = len(self.members)
        self.size = max(_next_pow2(n), 1)
        if self.size == 1:
            self.lits = self.members[0].lits
            self.carry = self.members[0].carry
            return
        lanes = self.members + [self.members[-1]] * (self.size - n)
        self.lits = _lits_tensor([m.lits for m in lanes], self.cp.device)
        self.carry = _stack([m.carry for m in lanes])


class _MorselStream:
    """Circular shared scan over one base table: members join at the
    current morsel and complete after one full wrap.  All groups of one
    advance share one fetch of the union of their stream columns."""

    def __init__(self, server: "QueryServer", table: str, spec):
        self.server = server
        self.table = table
        self.spec = spec
        self.pos = 0
        self.epoch = 0                 # cost epoch the spec was priced at
        self.groups: Dict[int, _Group] = {}
        self.proj_members: List[_ProjectMember] = []

    def members(self):
        for g in self.groups.values():
            yield from g.members
        yield from self.proj_members

    def attach(self, rec: QueryRecord, cp, builds, lits,
               fp: Optional[str] = None,
               dep_versions: Optional[Dict[str, int]] = None,
               phys=None) -> _StreamMember:
        g = self.groups.get(id(cp))
        if g is None:
            g = self.groups[id(cp)] = _Group(cp, builds, phys)
        else:
            # the group can outlive a build-side mutation (same compiled
            # pipeline, new version-keyed builds): take the caller's fresh
            # builds; a member folded against the old ones was detached
            # by the restart sweep
            g.builds = builds
        g.writeback()
        m = _StreamMember(rec, lits, self.spec.n_morsels, fp, dep_versions)
        m.carry = cp.init_carry()
        g.members.append(m)
        return m

    def attach_project(self, rec: QueryRecord, cpj, builds, lits,
                       fp: Optional[str],
                       dep_versions: Optional[Dict[str, int]] = None,
                       phys=None) -> _ProjectMember:
        m = _ProjectMember(rec, cpj, builds, lits, self.spec.n_morsels, fp,
                           dep_versions, phys)
        self.proj_members.append(m)
        return m

    def advance(self) -> Dict[int, object]:
        """Process one morsel for every member: one step per group."""
        live = [g for g in self.groups.values() if g.members]
        if not live and not self.proj_members:
            return {}
        ex = self.server.executor
        # the serving stream's ledger feed: fence this advance and record
        # one measured slice against 1/n_morsels of each pinned plan.
        # Only with telemetry on: the disabled path never fences
        ledger_on = ex.tel.enabled
        pipes = live + list(self.proj_members)
        # warm-up gate: an advance that includes a pipeline's first step
        # is not recorded, so one-time costs never read as bandwidth
        warm = all(p.n_advances > 0 for p in pipes)
        live_phys = [p.phys for p in pipes]
        if ledger_on:
            qexec._fence(ex.device)
        t0 = time.perf_counter() if ledger_on else 0.0
        union = tuple(sorted(
            {c for g in live for c in g.cp.stream_cols}
            | {c for m in self.proj_members for c in m.cpj.stream_cols}))
        arrays, n_valid = ex._stream_morsel(self.table, union, self.spec,
                                            self.pos,
                                            {} if ledger_on else None)
        by_col = dict(zip(union, arrays))
        done: Dict[int, object] = {}
        for g in live:
            if g.carry is None:
                g.restack()
            cols = tuple(by_col[c] for c in g.cp.stream_cols)
            step = g.cp.step if g.size == 1 else g.cp.group_step
            g.carry = step(g.lits, g.carry, n_valid, *g.builds, *cols)
            for m in g.members:
                m.remaining -= 1
            if any(m.remaining <= 0 for m in g.members):
                self._complete(g, done)
        still = []
        for m in self.proj_members:
            cols = tuple(by_col[c] for c in m.cpj.stream_cols)
            mask, outs = m.cpj.step(m.lits, n_valid, *m.builds, *cols)
            m.chunks[self.pos] = {c: a[mask]
                                  for c, a in zip(m.cpj.out_cols, outs)}
            m.remaining -= 1
            if m.remaining > 0:
                still.append(m)
            else:
                self._finish_member(m, m.finalize(), done)
        self.proj_members = still
        for p in pipes:
            p.n_advances += 1
        if ledger_on and warm and live_phys:
            qexec._fence(ex.device)
            dt = time.perf_counter() - t0
            moved = sum(a.nbytes for a in arrays)
            # one fenced measurement for the whole advance, split evenly
            # across the pipelines that shared the morsel; each records
            # against its pinned plan
            share = 1.0 / len(live_phys)
            for phys in live_phys:
                ex.tel.ledger.record_plan(
                    phys, dt * share, moved * share, mode="serve",
                    scale=1.0 / self.spec.n_morsels, shards=ex.n_shards)
        self.pos = (self.pos + 1) % self.spec.n_morsels
        return done

    def _complete(self, g: _Group, done: Dict[int, object]):
        g.writeback()
        still = []
        for m in g.members:
            if m.remaining > 0:
                still.append(m)
                continue
            self._finish_member(m, g.cp.finalize(m.carry), done)
        g.members = still

    def _finish_member(self, m, result, done: Dict[int, object]):
        """Completion bookkeeping shared by aggregate and project members:
        stamp latencies, fan the result out to the dedup riders, and offer
        it to the result cache, so the next submission of the query
        finishes at admission.  The fingerprint guard skips the admission
        if a dependency's version moved mid-flight."""
        srv = self.server
        m.rec.result = result
        srv._complete_rec(m.rec, "stream")
        srv.history.append(m.rec)
        srv.n_streamed += 1
        done[m.rec.qid] = result
        for dup in m.dups:
            dup.result = result
            srv._complete_rec(dup)
            srv.history.append(dup)
            done[dup.qid] = result
        ex = srv.executor
        if ex.cache is not None and m.fp == ex.fingerprint_of(m.rec.node):
            opt, phys = ex.plan(m.rec.node)
            ex._admit_result(m.rec.node, opt, phys, result)


class QueryServer:
    """Accepts many concurrent queries; serves them in admission batches
    (default) or as an incremental morsel-pipeline drain
    (``streaming=True``).  It runs on its executor's device."""

    def __init__(self, executor: Executor, *, streaming: bool = False,
                 morsel_rows: Optional[int] = None,
                 semantic_cache=None,
                 policy: Optional[AdaptivePolicy] = None,
                 backpressure_window: int = 64,
                 persist_path: Optional[str] = None):
        self.executor = executor
        # a semantic cache shared with other executors (and their servers)
        # over one catalog is installed on this executor; its version
        # tracking is the drift guard, and install_cache keeps the
        # REPRO_CACHE=0 switch
        executor.install_cache(semantic_cache)
        self.streaming = streaming
        self.morsel_rows = morsel_rows
        self._lock = threading.Lock()       # the pending queue's
        self._pending: List[QueryRecord] = []
        self._next_qid = 0
        self.history: List[QueryRecord] = []
        self.n_submitted = 0
        self.n_deduped = 0
        self.n_microbatched = 0
        self.n_streamed = 0
        self.n_cached = 0               # served whole from the semantic cache
        self.n_subplan_shared = 0       # CSE-hinted shared subtrees
        self.n_batches = 0
        self._batched_fns: Dict[tuple, object] = {}
        self.batched_cache_hits = 0
        self._total_drain_s = 0.0
        self._streams: Dict[str, _MorselStream] = {}
        # -- adaptive re-costing and QoS ------------------------------------ #
        self.policy = policy
        self.tenants: Dict[str, TenantSpec] = {
            "default": TenantSpec("default")}
        self.backpressure_window = int(backpressure_window)
        self._recent: List[float] = []   # sojourns, backpressure window
        self._ledger_pos = 0             # window_drift cursor
        self._overlay_start = 0          # first row measured vs this model
        self._breach_streak = 0
        self.n_recalibrations = 0
        self.n_backpressured = 0
        # -- warm start: a snapshot path makes the server recyclable ------- #
        self.persist_path = persist_path
        self.warm_started: Optional[dict] = None
        if persist_path and os.path.exists(persist_path) \
                and self.executor.cache is not None:
            self.warm_started = self.warm_start(persist_path)

    # -- warm-start persistence --------------------------------------------- #

    def save_state(self, path: Optional[str] = None) -> Optional[dict]:
        """Snapshot the semantic cache and the calibration to ``path``
        (default: the constructor's ``persist_path``).  Returns the save
        summary, or None when there is nothing to persist."""
        path = path or self.persist_path
        ex = self.executor
        if not path or ex.cache is None:
            return None
        return persist.save_state(path, ex.cache, cost_model=ex.cost_model,
                                  table_versions=ex.catalog.versions())

    def warm_start(self, path: str) -> dict:
        """Replay a snapshot into this server's cache (its host tier,
        promoted on first touch) and cost model; entries whose tables
        changed since the snapshot are dropped."""
        ex = self.executor
        summary = persist.warm_start(path, ex.cache,
                                     cost_model=ex.cost_model,
                                     table_versions=ex.catalog.versions())
        if summary.get("restored") and ex.cache is not None:
            # the entries were admitted against the versions this catalog
            # holds now: seed the drift guard with them
            ex.cache.sync_versions(ex.catalog.versions())
        return summary

    def _complete_rec(self, rec: QueryRecord,
                      path: Optional[str] = None) -> None:
        """The one completion stamp of every serving path: monotonic
        t_complete, the sojourn latency (admission to completion, queue
        wait included) and its histogram observation."""
        now = time.perf_counter()
        rec.t_complete = now
        rec.latency_s = now - rec.t_submit
        if path is not None:
            rec.path = path
        self.executor.metrics.observe("serve.sojourn_s", rec.latency_s)
        self._recent.append(rec.latency_s)
        if len(self._recent) > self.backpressure_window:
            del self._recent[:-self.backpressure_window]

    # -- client surface ----------------------------------------------------- #

    def register_tenant(self, spec: TenantSpec) -> None:
        """Install (or replace) a tenant's QoS contract and push every
        tenant's ``cache_share`` into the semantic cache's byte caps."""
        self.tenants[spec.name] = spec
        if self.executor.cache is not None:
            self.executor.cache.set_tenant_shares(
                {t.name: t.cache_share for t in self.tenants.values()})

    def submit(self, q, *, tenant: str = "default",
               deadline_s: Optional[float] = None) -> int:
        node = q.node if isinstance(q, L.Q) else q
        spec = self.tenants.get(tenant) or TenantSpec(tenant)
        now = time.perf_counter()
        deadline = now + deadline_s if deadline_s is not None \
            else float("inf")
        with self._lock:
            qid = self._next_qid
            self._next_qid += 1
            self._pending.append(QueryRecord(
                qid, node, t_submit=now, tenant=tenant,
                priority=spec.priority, deadline=deadline))
            self.n_submitted += 1
            depth = len(self._pending)
        self.executor.metrics.set("serve.queue_depth", depth)
        self.executor.metrics.observe("serve.queue_depth_at_submit", depth)
        return qid

    def query(self, q):
        """Submit one query and drain at once."""
        qid = self.submit(q)
        return self.drain()[qid]

    # -- incremental pipeline drain (streaming mode) ------------------------ #

    def pump(self) -> Dict[int, object]:
        """One serving increment: admit everything pending (dedup against
        members in flight, attach streamable plans to their table's
        stream, execute the rest now), then advance every stream one
        morsel.  Returns the results completed in it."""
        self._restart_stale_members()
        with self._lock:
            batch, self._pending = self._pending, []
        batch = self._admission_order(batch)
        batch = self._apply_backpressure(batch)
        with self.executor.tel.span("serve.pump", admitted=len(batch)):
            done = self._pump_batch(batch)
        self._maybe_recalibrate()
        return done

    @staticmethod
    def _admission_order(batch: List[QueryRecord]) -> List[QueryRecord]:
        """Priority first (descending), earliest deadline next, then
        submission order; the sort is stable, so one tenant stays FIFO."""
        return sorted(batch,
                      key=lambda r: (-r.priority, r.deadline, r.t_submit))

    def _recent_p95(self) -> Optional[float]:
        if not self._recent:
            return None
        lat = sorted(self._recent)
        return lat[int(0.95 * (len(lat) - 1))]

    def _slo_target(self) -> Optional[float]:
        """The strictest registered SLO: the tail backpressure defends."""
        slos = [t.slo_p95_s for t in self.tenants.values()
                if t.slo_p95_s is not None]
        return min(slos) if slos else None

    def _apply_backpressure(self, batch: List[QueryRecord]
                            ) -> List[QueryRecord]:
        """While the recent sojourn p95 breaches the strictest SLO, defer
        every admission whose priority is below the highest in this batch
        (the top class always admits), each record at most 8 times.
        Deferred records go back to the front of the queue and their
        sojourn clock keeps running."""
        slo = self._slo_target()
        if not batch or slo is None:
            return batch
        p95 = self._recent_p95()
        if p95 is None or p95 <= slo:
            return batch
        top = max(r.priority for r in batch)
        keep, defer = [], []
        for r in batch:
            if r.priority >= top or r.n_deferred >= 8:
                keep.append(r)
            else:
                r.n_deferred += 1
                defer.append(r)
        if defer:
            self.n_backpressured += len(defer)
            self.executor.metrics.inc("serve.backpressured", len(defer))
            with self._lock:
                self._pending = defer + self._pending
        return keep

    def _maybe_recalibrate(self) -> None:
        """The drift trigger: one windowed ledger read per pump or drain;
        ``k_windows`` consecutive breaches fold the measured overlay into
        the cost model through ``Executor.recost()``, and the evidence
        window restarts after an actual recost."""
        pol = self.policy
        ex = self.executor
        if pol is None or not ex.tel.enabled:
            return
        agg, nxt = ex.tel.ledger.window_drift(
            self._ledger_pos, min_rows=pol.min_window_rows)
        if agg is None:
            return
        self._ledger_pos = nxt
        worst = max((abs(a["drift_time"] - 1.0) for a in agg.values()
                     if a["predicted_s"] > 0), default=0.0)
        if worst <= pol.drift_threshold:
            self._breach_streak = 0
            return
        self._breach_streak += 1
        if self._breach_streak < pol.k_windows:
            return
        overlay = ex.tel.ledger.calibration_overlay(
            ex.cost_model, start=self._overlay_start)
        if overlay.get("backends") and not self._overlay_is_noop(overlay):
            ex.recost(overlay)
            self.n_recalibrations += 1
            ex.metrics.inc("serve.recalibrations")
            ex.tel.instant("serve.recalibrate", worst_drift=worst,
                           epoch=ex.cost_epoch)
            self._overlay_start = self._ledger_pos
        self._breach_streak = 0

    def _overlay_is_noop(self, overlay: dict) -> bool:
        """Whether ``overlay`` leaves every mentioned backend's efficiency
        within 20% of the live value.  Re-costing on such an overlay would
        churn the epoch (recompiling every plan) without changing a
        decision, and residual drift the model cannot express must not
        trigger forever."""
        eff = self.executor.cost_model.stream_eff
        for impl, meas in overlay.get("backends", {}).items():
            cur = eff.get(impl)
            new = meas.get("stream_eff")
            if cur is None or not new:
                continue
            if abs(new - cur) / max(cur, 1e-12) > 0.2:
                return False
        return True

    def _pump_batch(self, batch: List[QueryRecord]) -> Dict[int, object]:
        t0 = time.perf_counter()
        if batch:
            self.executor.metrics.observe("serve.batch_size", len(batch))
        self._hint_shared(batch)
        done: Dict[int, object] = {}
        ran: Dict[L.Node, QueryRecord] = {}   # dedup of executed queries
        for rec in batch:
            src = self._find_inflight(rec.node)
            if src is not None:
                rec.path = "dedup"
                self.n_deduped += 1
                src.dups.append(rec)
                continue
            prior = ran.get(rec.node)
            if prior is not None:
                self.n_deduped += 1
                rec.result = prior.result
                self._complete_rec(rec, "dedup")
                self.history.append(rec)
                done[rec.qid] = rec.result
                continue
            if self._serve_cached(rec, done):
                continue
            if self._try_attach(rec):
                continue
            rec.result = self.executor.execute(rec.node).value
            self._complete_rec(rec)
            self.history.append(rec)
            done[rec.qid] = rec.result
            ran[rec.node] = rec
        for stream in self._streams.values():
            done.update(stream.advance())
        self._total_drain_s += time.perf_counter() - t0
        return done

    def _serve_cached(self, rec: QueryRecord, done: Dict[int, object]
                      ) -> bool:
        """A whole-result cache hit completes the query at admission.  The
        value reaches the consumer on the executor's device, from the host
        tier too."""
        ex = self.executor
        if ex.cache is None:
            return False
        entry = ex.cache.get(("result", ex.fingerprint_of(rec.node)))
        if entry is None:
            return False
        ex.metrics.inc("exec.result_cache_hits")
        rec.result = ex._served(entry)
        self._complete_rec(rec, "cached")
        self.n_cached += 1
        self.history.append(rec)
        done[rec.qid] = rec.result
        return True

    def _hint_shared(self, batch: List[QueryRecord]) -> None:
        """Optimizer CSE over the admitted batch: subtrees repeated across
        these queries are certain to be reused, so they are hinted to the
        semantic cache before the first member executes."""
        ex = self.executor
        if ex.cache is None or len(batch) < 2:
            return
        opts = [ex.plan(rec.node)[0] for rec in batch]
        # only the node kinds the executor caches as subplans
        shared = [n for n in common_subplans(opts)
                  if isinstance(n, (L.Filter, L.FilterProject, L.Join))]
        if not shared:
            return
        versions = ex.catalog.versions()
        ex.cache.hint(
            ("subplan", L.fingerprint(n, versions, order_sensitive=True))
            for n in shared)
        self.n_subplan_shared += len(shared)

    def _find_inflight(self, node: L.Node):
        """In-flight dedup by semantic fingerprint (with a cache) or
        structure: filter-order permutations and aggregate-rooted join
        swaps share one stream slot."""
        ex = self.executor
        fp = ex.fingerprint_of(node) if ex.cache is not None else None
        for stream in self._streams.values():
            for m in stream.members():
                if m.rec.node == node or (fp is not None and m.fp == fp):
                    return m
        return None

    def _try_attach(self, rec: QueryRecord) -> bool:
        ex = self.executor
        node, phys = ex.plan(rec.node)        # memoized per logical node
        fp = ex.fingerprint_of(rec.node) if ex.cache is not None else None
        versions = ex.catalog.versions()
        deps = {t: versions.get(t, 0) for t in L.tables_of(node)}
        splan = pl.analyze(node, ex.catalog.stats)
        if splan is not None:
            stream = self._stream_for(splan.base_scan.table, phys,
                                      len(splan.stream_cols))
            cp, builds, _ = ex.stream_pipeline(node, phys, splan,
                                               stream.spec)
            stream.attach(rec, cp, builds, L.literals(node), fp, deps,
                          phys=phys)
            return True
        pplan = pl.analyze_project(node, ex.catalog.stats)
        if pplan is None:
            return False
        stream = self._stream_for(pplan.base_scan.table, phys,
                                  len(pplan.stream_cols))
        cpj, builds = ex.project_pipeline(node, phys, pplan, stream.spec)
        stream.attach_project(rec, cpj, builds, L.literals(node), fp, deps,
                              phys=phys)
        return True

    def _restart_stale_members(self) -> None:
        """A table mutation mid-flight invalidates every member whose
        dependency snapshot drifted: its carry mixes pre- and post-mutation
        morsels and its builds are stale.  Such members are detached and
        requeued ahead of the next admission, with their riders, so they
        re-plan, re-attach against fresh builds and restart their
        circle."""
        versions = self.executor.catalog.versions()

        def stale(m) -> bool:
            return any(versions.get(t, 0) != v
                       for t, v in m.dep_versions.items())

        requeue: List[QueryRecord] = []
        for stream in self._streams.values():
            for g in stream.groups.values():
                hit = [m for m in g.members if stale(m)]
                if not hit:
                    continue
                g.writeback()
                for m in hit:
                    g.members.remove(m)
                    requeue.append(m.rec)
                    requeue.extend(m.dups)
            for m in [m for m in stream.proj_members if stale(m)]:
                stream.proj_members.remove(m)
                requeue.append(m.rec)
                requeue.extend(m.dups)
        if requeue:
            with self._lock:
                self._pending = requeue + self._pending

    def _stream_for(self, table: str, phys, n_cols: int) -> _MorselStream:
        ex = self.executor
        stream = self._streams.get(table)
        if stream is not None and stream.epoch != ex.cost_epoch and \
                not any(True for _ in stream.members()):
            # priced under an earlier cost epoch and idle: re-spec it at
            # the re-costed morsel size.  A stream with members in flight
            # keeps its spec, to which their remaining counts are pinned
            stream = None
        if stream is None:
            spec = ex.morsel_spec(table, self.morsel_rows
                                  or (phys.morsel_rows if phys else None),
                                  n_cols=n_cols)
            stream = self._streams[table] = _MorselStream(self, table, spec)
            stream.epoch = ex.cost_epoch
        return stream

    def _inflight(self) -> bool:
        return any(s.proj_members or any(g.members
                                         for g in s.groups.values())
                   for s in self._streams.values())

    def _drain_streaming(self) -> Dict[int, object]:
        out: Dict[int, object] = {}
        while True:
            out.update(self.pump())
            with self._lock:
                idle = not self._pending
            if idle and not self._inflight():
                return out

    # -- serving (admission batches) ---------------------------------------- #

    def drain(self) -> Dict[int, object]:
        """Process every pending query; returns qid -> result."""
        if self.streaming:
            return self._drain_streaming()
        with self._lock:
            batch, self._pending = self._pending, []
        if not batch:
            return {}
        with self.executor.tel.span("serve.drain", batch=len(batch)):
            return self._drain_batch(batch)

    def _drain_batch(self, batch: List[QueryRecord]) -> Dict[int, object]:
        t0 = time.perf_counter()
        # QoS ordering only: drain() completes the whole batch, so
        # deferral is a streaming-pump discipline
        batch = self._admission_order(batch)
        self.executor.metrics.observe("serve.batch_size", len(batch))
        self._hint_shared(batch)

        # 1. dedup identical plans (frozen nodes hash structurally)
        first_of: Dict[L.Node, QueryRecord] = {}
        dups: List[Tuple[QueryRecord, QueryRecord]] = []
        unique: List[QueryRecord] = []
        for rec in batch:
            if rec.node in first_of:
                rec.path = "dedup"
                dups.append((rec, first_of[rec.node]))
                self.n_deduped += 1
            else:
                first_of[rec.node] = rec
                unique.append(rec)

        # 2. micro-batch compatible selections over the same column
        groups: Dict[tuple, List[QueryRecord]] = {}
        singles: List[QueryRecord] = []
        for rec in unique:
            key = _microbatch_key(rec.node)
            if key is None:
                singles.append(rec)
            else:
                groups.setdefault(key, []).append(rec)
        for key, recs in groups.items():
            if len(recs) == 1:
                singles.extend(recs)
                continue
            self._run_microbatch(key, recs)

        # 3. the rest, one executor call each (the plan cache applies; a
        # semantic-cache hit skips execution)
        for rec in singles:
            res = self.executor.execute(rec.node)
            rec.result = res.value
            if res.result_cache_hit:
                rec.path = "cached"
                self.n_cached += 1
            self._complete_rec(rec)

        for rec, src in dups:
            rec.result = src.result
            self._complete_rec(rec)

        self._total_drain_s += time.perf_counter() - t0
        self.history.extend(batch)
        self._maybe_recalibrate()
        return {rec.qid: rec.result for rec in batch}

    def _run_microbatch(self, key: tuple, recs: List[QueryRecord]):
        table, _cols, fcol, op, acol = key
        size = _next_pow2(len(recs))
        fn_key = (key, size)
        if fn_key in self._batched_fns:
            self.batched_cache_hits += 1
        else:
            self._batched_fns[fn_key] = self._build_batched(op)
        fn = self._batched_fns[fn_key]
        fdata = self.executor.placed(table, fcol, "partitioned")
        adata = self.executor.placed(table, acol, "partitioned")
        # the bounds as the fused path takes them (``L.literals``)
        out = fn([int(r.node.child.lo) for r in recs],
                 [int(r.node.child.hi) for r in recs], fdata, adata)
        self.n_batches += 1
        self.executor.metrics.observe("serve.microbatch_size", len(recs))
        for rec, value in zip(recs, out):
            rec.result = value
            # the sojourn, not the batch's amortized time
            self._complete_rec(rec, "microbatch")
            self.n_microbatched += 1

    @staticmethod
    def _build_batched(op: str):
        """One pass of G selections over a placed filter column and
        aggregate column -> G Python values, each equal to what the fused
        pipeline gives the query alone.  Integer aggregates reduce in row
        chunks of ``[G, chunk]`` masks into int64 sums, the temporaries
        near one column's size; a float aggregate (a float ``sum``, every
        ``mean``) is reduced one range at a time over the whole column, in
        the fused pipeline's summation order."""
        if op not in ("sum", "count", "mean"):
            raise ValueError(op)

        def lane(lo, hi, fcol, acol):
            mask = engine.in_range(fcol, lo, hi)
            if op == "sum":
                return float(torch.where(mask, acol, 0)
                             .to(torch.float32).sum())
            s = torch.where(mask, acol, 0).to(torch.float32).sum()
            c = mask.to(torch.float32).sum()
            return float(s / c.clamp(min=1.0))

        def run(los, his, fcol, acol):
            if op == "mean" or (op == "sum"
                                and acol.dtype.is_floating_point):
                return [lane(lo, hi, fcol, acol) for lo, hi in zip(los, his)]
            g, n = len(los), int(fcol.shape[0])
            lo = _lits_tensor([[v] for v in los], fcol.device)
            hi = _lits_tensor([[v] for v in his], fcol.device)
            chunk = max(n // (2 * g), MIN_CHUNK_ROWS)
            acc = torch.zeros(g, dtype=torch.int64, device=fcol.device)
            for s in range(0, n, chunk):
                mask = engine.in_ranges(fcol[s:s + chunk], lo, hi)
                if op == "count":
                    acc += mask.sum(dim=1)
                else:
                    acc += torch.where(mask, acol[s:s + chunk], 0) \
                        .sum(dim=1, dtype=torch.int64)
            return [int(v) for v in acc.tolist()]

        return run

    # -- reporting ---------------------------------------------------------- #

    def stats(self) -> dict:
        lat = sorted(r.latency_s for r in self.history)
        n = len(self.history)
        out = {
            "n_queries": n,
            "n_deduped": self.n_deduped,
            "n_microbatched": self.n_microbatched,
            "n_streamed": self.n_streamed,
            "n_cached": self.n_cached,
            "n_subplan_shared": self.n_subplan_shared,
            "n_microbatches": self.n_batches,
            "batched_kernel_cache_hits": self.batched_cache_hits,
            "total_serve_s": self._total_drain_s,
            "queries_per_s": n / self._total_drain_s
            if self._total_drain_s else 0.0,
            "latency_mean_s": sum(lat) / n if n else 0.0,
            "latency_p50_s": lat[int(0.50 * (n - 1))] if n else 0.0,
            "latency_p95_s": lat[int(0.95 * (n - 1))] if n else 0.0,
            "latency_max_s": lat[-1] if lat else 0.0,
            "n_recalibrations": self.n_recalibrations,
            "n_backpressured": self.n_backpressured,
            # scores answered from cached GLM weights, not a retrain
            "n_model_hits": self.executor.model_hits,
        }
        by_tenant: Dict[str, list] = {}
        for rec in self.history:
            by_tenant.setdefault(rec.tenant, []).append(rec.latency_s)
        out["tenants"] = {}
        for t, ls in by_tenant.items():
            ls.sort()
            k = len(ls)
            spec = self.tenants.get(t)
            out["tenants"][t] = {
                "n": k,
                "latency_mean_s": sum(ls) / k,
                "latency_p95_s": ls[int(0.95 * (k - 1))],
                "priority": spec.priority if spec else 0,
                "slo_p95_s": spec.slo_p95_s if spec else None,
            }
        out.update(self.executor.stats_dict())
        return out
