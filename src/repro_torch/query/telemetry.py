"""Query-stack telemetry: spans, metrics, and the bandwidth ledger.

The cost model prices every plan in bytes moved and seconds spent; this
module checks those predictions against what the card delivers — the
modeled-vs-achieved gap the paper's follow-up work (Shuhai,
"Benchmarking High Bandwidth Memory on FPGAs") exists to close:

* **Tracer** — low-overhead nested spans (plan -> optimize -> physical
  costing -> exec/pipeline) plus instant events, exported as a
  ``chrome://tracing``-loadable JSON.  Nesting is implicit in the Chrome
  model: spans on one thread whose ``[ts, ts+dur]`` intervals contain
  each other render nested.
* **MetricsRegistry** — named counters and bounded-reservoir latency
  histograms with a flat ``snapshot()`` dict.  Each ``Executor`` owns a
  private registry (per-tenant counters stay separable); the tracer and
  ledger are shared through the process-global :class:`Telemetry` so one
  Chrome trace covers every tenant.
* **BandwidthLedger** — per physical operator, the cost model's
  predicted bytes/seconds next to measured bytes and fenced wall time
  (a CUDA synchronisation before and after, so execution is timed, not
  the enqueue of asynchronous launches), with drift ratios per op and a
  calibration overlay in the shape ``query/calibrate.py`` writes and
  ``CostModel.apply_calibration`` consumes, keyed by the port's impl
  labels (``cuda`` / ``torch``) — online recalibration is
  ``model.apply_calibration(ledger.calibration_overlay(model))``.

Everything is env-gated: ``REPRO_TRACE=0`` (the default) makes every
span a shared no-op singleton and every ledger record an early return —
the disabled hot path is one attribute check, no allocation retained,
and no fence.  Standard library only.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

# --------------------------------------------------------------------------- #
# gating

def trace_enabled() -> bool:
    """The REPRO_TRACE gate, parsed in ONE place (mirrors
    ``cache.cache_disabled``): tracing is opt-in, default off."""
    return os.environ.get("REPRO_TRACE", "0").lower() in ("1", "on",
                                                          "yes", "true")


# --------------------------------------------------------------------------- #
# spans

class _NullSpan:
    """Shared no-op span: the entire disabled path.  One module-level
    singleton, so a disabled ``tracer.span(...)`` allocates nothing that
    outlives the call."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class _Span:
    """One live span: records wall-clock bounds on exit and appends the
    finished event to its tracer."""

    __slots__ = ("tracer", "name", "t0", "args", "tid")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self.tracer = tracer
        self.name = name
        self.args = args
        self.tid = threading.get_ident()
        self.t0 = time.perf_counter()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.tracer._finish(self.name, self.t0,
                            time.perf_counter() - self.t0, self.tid,
                            self.args)
        return False

    def set(self, **args) -> "_Span":
        """Attach attributes discovered mid-span (path taken, cache
        outcome, reason strings)."""
        self.args.update(args)
        return self


class Tracer:
    """Span/event recorder.  Thread-safe appends; bounded by
    ``max_events`` so an always-on CI leg can never grow without limit
    (overflow is counted, not silently dropped)."""

    def __init__(self, enabled: bool = False, max_events: int = 200_000):
        self.enabled = enabled
        self.max_events = max_events
        self.events: List[dict] = []
        self.dropped = 0
        self._epoch = time.perf_counter()
        self._lock = threading.Lock()

    # -- recording ---------------------------------------------------------- #

    def span(self, name: str, **args):
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, args)

    def _finish(self, name: str, t0: float, dur: float, tid: int,
                args: dict) -> None:
        self._append({
            "name": name, "ph": "X", "pid": os.getpid(), "tid": tid,
            "ts": (t0 - self._epoch) * 1e6, "dur": dur * 1e6,
            "args": args})

    def complete(self, name: str, t0: float, dur: float, **args) -> None:
        """Record an already-measured interval (the per-morsel loop times
        with its own clock and reports here)."""
        if not self.enabled:
            return
        self._finish(name, t0, dur, threading.get_ident(), args)

    def instant(self, name: str, **args) -> None:
        """Point event (cache admissions/evictions, drift alerts)."""
        if not self.enabled:
            return
        self._append({
            "name": name, "ph": "i", "s": "t", "pid": os.getpid(),
            "tid": threading.get_ident(),
            "ts": (time.perf_counter() - self._epoch) * 1e6,
            "args": args})

    def _append(self, event: dict) -> None:
        with self._lock:
            if len(self.events) >= self.max_events:
                self.dropped += 1
                return
            self.events.append(event)

    # -- export ------------------------------------------------------------- #

    def chrome_trace(self) -> dict:
        """The ``chrome://tracing`` / Perfetto JSON object format."""
        with self._lock:
            events = list(self.events)
        return {"traceEvents": events,
                "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def export_chrome(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path

    def clear(self) -> None:
        with self._lock:
            self.events.clear()
            self.dropped = 0


# --------------------------------------------------------------------------- #
# metrics

_HIST_CAP = 4096                  # bounded reservoir per histogram


class MetricsRegistry:
    """Named counters + bounded latency/size histograms.  Counters are
    ALWAYS live (they replaced the executor's ad-hoc attributes, so
    their cost is one dict add either way); histograms are fed by
    instrumentation sites that gate themselves on the tracer."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._hists: Dict[str, List[float]] = {}

    # -- counters ----------------------------------------------------------- #

    def inc(self, name: str, by: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + by

    def set(self, name: str, value: float) -> None:
        with self._lock:
            self._counters[name] = value

    def value(self, name: str, default: float = 0):
        with self._lock:
            return self._counters.get(name, default)

    # -- histograms --------------------------------------------------------- #

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            h = self._hists.setdefault(name, [])
            if len(h) < _HIST_CAP:
                h.append(float(value))
            else:                      # ring overwrite: keep recent window
                h[int(self._counters.get(f"{name}.n", 0)) % _HIST_CAP] \
                    = float(value)
            self._counters[f"{name}.n"] = \
                self._counters.get(f"{name}.n", 0) + 1

    def hist_size(self, name: str) -> int:
        with self._lock:
            return len(self._hists.get(name, ()))

    # -- reporting ---------------------------------------------------------- #

    def snapshot(self) -> dict:
        """Flat metrics dict: every counter verbatim, every histogram as
        ``name.{count,mean,p50,p95,max}``."""
        with self._lock:
            out = dict(self._counters)
            for name, vals in self._hists.items():
                if not vals:
                    continue
                s = sorted(vals)
                n = len(s)
                out[f"{name}.count"] = int(self._counters.get(f"{name}.n",
                                                              n))
                out[f"{name}.mean"] = sum(s) / n
                out[f"{name}.p50"] = s[int(0.50 * (n - 1))]
                out[f"{name}.p95"] = s[int(0.95 * (n - 1))]
                out[f"{name}.max"] = s[-1]
            return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._hists.clear()


# --------------------------------------------------------------------------- #
# the bandwidth ledger

@dataclasses.dataclass
class LedgerRow:
    """One operator execution: the cost model's prediction next to the
    measurement.  ``attributed=True`` marks rows whose wall time was
    apportioned from a fused pipeline's single fenced measurement
    (per-op fencing inside one pipeline step is impossible) — their
    per-op time drift equals the whole pipeline's."""
    op: str
    impl: str
    placement: str
    predicted_bytes: float
    predicted_s: float
    measured_bytes: float
    measured_s: float
    mode: str = "eager"              # eager | fused | stream
    attributed: bool = False
    shard: int = -1                  # shard id under a sharded placement
                                     # (-1 = not shard-attributed)
    table: str = ""                  # (table, column) a filter row's bytes
    column: str = ""                 # belong to — selectivity feedback key
    tier: str = "device"             # memory tier the bytes streamed FROM
                                     # (op="promote" rows: the source tier
                                     # of a spill promotion)

    @property
    def drift_bytes(self) -> float:
        """measured/predicted bytes — the cardinality-estimate error."""
        return self.measured_bytes / self.predicted_bytes \
            if self.predicted_bytes else 0.0

    @property
    def drift_time(self) -> float:
        """measured/predicted seconds — the bandwidth-model error."""
        return self.measured_s / self.predicted_s \
            if self.predicted_s else 0.0

    @property
    def achieved_gbps(self) -> float:
        return self.measured_bytes / self.measured_s / 1e9 \
            if self.measured_s else 0.0

    @property
    def predicted_gbps(self) -> float:
        return self.predicted_bytes / self.predicted_s / 1e9 \
            if self.predicted_s else 0.0


class BandwidthLedger:
    """Accumulates predicted-vs-measured rows; aggregates drift per op
    and per impl.  Appends are lock-guarded (promotions are recorded on
    the prefetch thread, and executors may share one ledger across
    threads); reads take a snapshot."""

    def __init__(self, enabled: bool = False, max_rows: int = 100_000):
        self.enabled = enabled
        self.max_rows = max_rows
        self.rows: List[LedgerRow] = []
        self.dropped = 0
        self._lock = threading.Lock()

    def record(self, *, op: str, impl: str, placement: str,
               predicted_bytes: float, predicted_s: float,
               measured_bytes: float, measured_s: float,
               mode: str = "eager", attributed: bool = False,
               shard: int = -1, table: str = "", column: str = "",
               tier: str = "device") -> None:
        if not self.enabled:
            return
        row = LedgerRow(op, impl, placement, float(predicted_bytes),
                        float(predicted_s), float(measured_bytes),
                        float(measured_s), mode, attributed, shard, table,
                        column, tier=tier)
        with self._lock:
            if len(self.rows) >= self.max_rows:
                self.dropped += 1
                return
            self.rows.append(row)

    def record_plan(self, phys, measured_s: float, measured_bytes: float,
                    *, mode: str, scale: float = 1.0,
                    shards: int = 1) -> None:
        """Attribute one fused/streamed pipeline's fenced measurement
        across its physical operators, proportional to each op's share
        of the predicted cost (bytes pro-rated the same way).  Every
        costed operator gets a row, so drift is populated plan-wide even
        when only the pipeline boundary is fenceable.  ``scale`` shrinks
        the plan's predictions to the measured slice: the serving
        streams fence one morsel at a time and record against
        ``1/n_morsels`` of the whole-plan prediction.

        ``shards > 1`` splits every sharded-placement op's row into one
        row per shard, bytes and seconds divided evenly (the shards' steps
        are fenced together, so per-shard skew is not observable).  The
        sums are unchanged, which keeps ``window_drift`` and
        ``calibration_overlay`` identical.  Filter rows additionally carry
        their (table, column) so ``selectivity_corrections`` can key the
        cardinality feedback."""
        if not self.enabled or phys is None:
            return
        nodes = list(_walk(phys))
        total_s = sum(p.cost_s for p in nodes) or 1.0
        total_b = sum(p.n_bytes for p in nodes) or 1.0
        for p in nodes:
            table, column = _filter_attribution(p)
            n = shards if (shards > 1 and p.placement == "sharded") else 1
            for k in range(n):
                self.record(
                    op=p.op, impl=p.impl, placement=p.placement,
                    predicted_bytes=p.n_bytes * scale / n,
                    predicted_s=p.cost_s * scale / n,
                    measured_bytes=measured_bytes * (p.n_bytes / total_b)
                    / n,
                    measured_s=measured_s * (p.cost_s / total_s) / n,
                    mode=mode, attributed=True,
                    shard=k if n > 1 else -1, table=table, column=column)

    # -- aggregation --------------------------------------------------------- #

    def _snapshot(self) -> List[LedgerRow]:
        with self._lock:
            return list(self.rows)

    def drift_by_op(self) -> Dict[str, dict]:
        """op -> aggregated predicted/measured totals and drift ratios."""
        agg: Dict[str, dict] = {}
        for r in self._snapshot():
            a = agg.setdefault(r.op, {
                "n": 0, "predicted_bytes": 0.0, "measured_bytes": 0.0,
                "predicted_s": 0.0, "measured_s": 0.0})
            a["n"] += 1
            a["predicted_bytes"] += r.predicted_bytes
            a["measured_bytes"] += r.measured_bytes
            a["predicted_s"] += r.predicted_s
            a["measured_s"] += r.measured_s
        for a in agg.values():
            a["drift_bytes"] = a["measured_bytes"] / a["predicted_bytes"] \
                if a["predicted_bytes"] else 0.0
            a["drift_time"] = a["measured_s"] / a["predicted_s"] \
                if a["predicted_s"] else 0.0
            a["achieved_gbps"] = a["measured_bytes"] / a["measured_s"] \
                / 1e9 if a["measured_s"] else 0.0
        return agg

    def top_drift(self, n: int = 5) -> List[dict]:
        """The operators whose time predictions are furthest off —
        where online re-costing would change plans first."""
        agg = self.drift_by_op()
        rows = [{"op": op, **a} for op, a in agg.items()]
        rows.sort(key=lambda a: abs(a["drift_time"] - 1.0), reverse=True)
        return rows[:n]

    def window_drift(self, start: int, *, min_rows: int = 1
                     ) -> Tuple[Optional[Dict[str, dict]], int]:
        """Per-impl drift aggregated over ``rows[start:]`` — the serving
        layer's WINDOWED view.  Returns ``(agg, next_start)``: the caller
        keeps ``next_start`` as its cursor, so each call sees only rows
        recorded since the last one, and "K consecutive windows over
        threshold" is K consecutive calls whose worst impl drift
        breaches.  When fewer than ``min_rows`` new rows exist the window
        is not ready: returns ``(None, start)`` with the cursor
        unmoved."""
        with self._lock:
            rows = self.rows[start:]
            nxt = len(self.rows)
        if len(rows) < min_rows:
            return None, start
        agg: Dict[str, dict] = {}
        for r in rows:
            a = agg.setdefault(r.impl, {
                "n": 0, "predicted_s": 0.0, "measured_s": 0.0,
                "predicted_bytes": 0.0, "measured_bytes": 0.0})
            a["n"] += 1
            a["predicted_s"] += r.predicted_s
            a["measured_s"] += r.measured_s
            a["predicted_bytes"] += r.predicted_bytes
            a["measured_bytes"] += r.measured_bytes
        for a in agg.values():
            a["drift_time"] = a["measured_s"] / a["predicted_s"] \
                if a["predicted_s"] else 0.0
            a["drift_bytes"] = a["measured_bytes"] / a["predicted_bytes"] \
                if a["predicted_bytes"] else 0.0
        return agg, nxt

    def bytes_by_tier(self, *, start: int = 0) -> Dict[str, dict]:
        """Measured bytes attributed per memory tier — the spill-traffic
        view: tier -> {bytes, seconds, n, gbps}.  Promotion rows
        (op="promote") carry their SOURCE tier, so "host"/"disk" totals
        here are exactly the bytes the streaming pipelines pulled up the
        hierarchy; "device" is everything that streamed in place."""
        with self._lock:
            rows = self.rows[start:]
        agg: Dict[str, dict] = {}
        for r in rows:
            a = agg.setdefault(r.tier, {"bytes": 0.0, "seconds": 0.0,
                                        "n": 0})
            a["bytes"] += r.measured_bytes
            a["seconds"] += r.measured_s
            a["n"] += 1
        for a in agg.values():
            a["gbps"] = a["bytes"] / a["seconds"] / 1e9 \
                if a["seconds"] else 0.0
        return agg

    def selectivity_corrections(self, *, start: int = 0, min_rows: int = 1
                                ) -> Dict[Tuple[str, str], float]:
        """Per-(table, column) measured-over-predicted BYTES ratio across
        the rows that carry a filter attribution: cardinality
        (drift_bytes) feedback into selectivity estimates,
        not just bandwidth constants.  A ratio above 1 means the filter
        passed more rows than the uniform-domain estimate predicted;
        ``Executor.recost`` folds these into
        ``CostModel.sel_corrections``, where ``estimate_rows`` applies
        them CLAMPED (cost.SEL_CORRECTION_CLAMP) so a single bad window
        can never swing a plan by more than the clamp bound."""
        with self._lock:
            rows = self.rows[start:]
        acc: Dict[Tuple[str, str], dict] = {}
        for r in rows:
            if not r.table or not r.column or r.predicted_bytes <= 0:
                continue
            a = acc.setdefault((r.table, r.column),
                               {"p": 0.0, "m": 0.0, "n": 0})
            a["p"] += r.predicted_bytes
            a["m"] += r.measured_bytes
            a["n"] += 1
        return {k: a["m"] / a["p"] for k, a in acc.items()
                if a["n"] >= min_rows and a["p"] > 0}

    def calibration_overlay(self, model, *, start: int = 0) -> dict:
        """Measured achieved bandwidth folded back into the
        calibration-file shape ``CostModel.apply_calibration`` consumes,
        its ``backends`` keyed by the rows' impl labels — the port's
        ``cuda`` / ``torch`` (``cost.IMPLS``), the keys the model
        applies (it skips any other).

        Per-impl stream efficiency is derived from MEASUREMENTS ONLY:
        ``sum(measured_bytes) / sum(raw_bandwidth(placement) *
        measured_s)`` — the achieved fraction of the bandwidth model's
        raw curve.  Anchoring on the raw curve (not on the model's
        current ``stream_eff``) is what makes the online loop stable:
        regenerating the overlay from the same rows after applying it
        yields the SAME overlay, instead of dividing an already-overlaid
        efficiency by a stale drift ratio and compounding toward zero.
        ``start`` restricts the evidence to ``rows[start:]`` so a
        recalibrated caller can exclude rows measured against a previous
        model.  This is the one-liner that makes recalibration online:
        ``model.apply_calibration(ledger.calibration_overlay(model))``.
        """
        by_impl: Dict[str, dict] = {}
        by_tier: Dict[str, dict] = {}
        with self._lock:
            rows = self.rows[start:]
        for r in rows:
            if r.measured_s <= 0 or r.measured_bytes <= 0:
                continue
            if r.op == "promote":
                # spill-promotion traffic calibrates the TIER channels,
                # not a backend's stream efficiency: achieved promotion
                # bandwidth from the source tier feeds the h2d/disk
                # overlay keys below, so drift-triggered recost converges
                # on what the hierarchy actually delivers
                t = by_tier.setdefault(r.tier, {"bytes": 0.0, "s": 0.0})
                t["bytes"] += r.measured_bytes
                t["s"] += r.measured_s
                continue
            a = by_impl.setdefault(r.impl, {"bw_seconds": 0.0,
                                            "measured_s": 0.0,
                                            "measured_bytes": 0.0})
            a["bw_seconds"] += model.bandwidth_gbps(r.placement) * 1e9 \
                * r.measured_s
            a["measured_s"] += r.measured_s
            a["measured_bytes"] += r.measured_bytes
        # call overhead is NOT measured by the ledger, so the overlay
        # reports the model's PRISTINE constant (not the live value): a
        # previously mis-calibrated overhead must re-baseline on the next
        # application, never be frozen in place by the overlay echoing it
        base_over = getattr(model, "_baseline",
                            {"call_overhead": model.call_overhead}
                            )["call_overhead"]
        backends = {}
        for impl, a in by_impl.items():
            if a["bw_seconds"] <= 0:
                continue
            eff = a["measured_bytes"] / a["bw_seconds"]
            backends[impl] = {
                "achieved_gbps": round(a["measured_bytes"]
                                       / a["measured_s"] / 1e9, 4),
                # floor well below any honest efficiency (CPU-emulated
                # streams achieve ~1e-5 of the modeled HBM curve): a
                # floor ABOVE the truth would leave residual drift that
                # re-triggers recalibration forever
                "stream_eff": round(min(max(eff, 1e-6), 1.0), 6),
                "call_overhead_s": base_over.get(impl, 2e-6),
            }
        overlay = {"backend": "ledger", "backends": backends}
        # host promotions measure the H2D staging link end to end; disk
        # promotions are read+stage in series, dominated by (and reported
        # as) the disk channel
        tier_keys = {"host": "h2d_gbps", "disk": "disk_gbps"}
        for tier, t in by_tier.items():
            key = tier_keys.get(tier)
            if key and t["s"] > 0:
                overlay[key] = round(t["bytes"] / t["s"] / 1e9, 4)
        return overlay

    def report(self) -> str:
        """Human-readable drift report."""
        agg = self.drift_by_op()
        if not agg:
            return "bandwidth ledger: no measurements recorded"
        lines = [f"{'op':<14} {'n':>4} {'pred MB':>9} {'meas MB':>9} "
                 f"{'drift(B)':>9} {'pred ms':>9} {'meas ms':>9} "
                 f"{'drift(t)':>9} {'GB/s':>7}"]
        for op in sorted(agg):
            a = agg[op]
            lines.append(
                f"{op:<14} {a['n']:>4} "
                f"{a['predicted_bytes'] / 1e6:>9.2f} "
                f"{a['measured_bytes'] / 1e6:>9.2f} "
                f"{a['drift_bytes']:>9.3f} "
                f"{a['predicted_s'] * 1e3:>9.3f} "
                f"{a['measured_s'] * 1e3:>9.3f} "
                f"{a['drift_time']:>9.3f} "
                f"{a['achieved_gbps']:>7.2f}")
        return "\n".join(lines)

    def clear(self) -> None:
        with self._lock:
            self.rows.clear()
            self.dropped = 0


def _walk(p):
    yield p
    for c in p.children:
        yield from _walk(c)


def _filter_attribution(p) -> Tuple[str, str]:
    """(table, column) a PhysNode's traffic is attributed to, "" for ops
    with no single attributable column.  Filters attribute to their
    predicate column; GLM training to its label column (the training
    set's identity for dashboards); scoring to its emitted "score".
    Walks the logical child chain structurally (child / probe-side left)
    to the base Scan, so telemetry needs no import of the plan DSL."""
    if p.op not in ("filter", "filter_project", "train_glm", "score_glm"):
        return "", ""
    node = getattr(p, "logical", None)
    if p.op == "train_glm":
        column = getattr(node, "label", "") or ""
    elif p.op == "score_glm":
        column = "score"
    else:
        column = getattr(node, "column", "") or ""
    n = getattr(node, "child", None)
    while n is not None and not hasattr(n, "table"):
        n = getattr(n, "child", None) or getattr(n, "left", None)
    return (getattr(n, "table", "") or "", column)


# --------------------------------------------------------------------------- #
# the facade

class Telemetry:
    """One tracer + one ledger + one (shared, process-level) metrics
    registry, gated together.  ``enabled=None`` reads REPRO_TRACE.

    Executors additionally own a PRIVATE MetricsRegistry for their
    consolidated counters (per-tenant accounting must not mix); this
    facade's registry aggregates process-wide observations when no
    narrower registry applies.
    """

    def __init__(self, enabled: Optional[bool] = None):
        if enabled is None:
            enabled = trace_enabled()
        self.enabled = enabled
        self.tracer = Tracer(enabled)
        self.ledger = BandwidthLedger(enabled)
        self.metrics = MetricsRegistry()

    # thin delegates, so instrumentation sites hold one object
    def span(self, name: str, **args):
        if not self.enabled:
            return NULL_SPAN
        return _Span(self.tracer, name, args)

    def instant(self, name: str, **args) -> None:
        if self.enabled:
            self.tracer.instant(name, **args)

    def complete(self, name: str, t0: float, dur: float, **args) -> None:
        if self.enabled:
            self.tracer.complete(name, t0, dur, **args)

    def export_chrome(self, path: str) -> str:
        return self.tracer.export_chrome(path)

    def snapshot(self) -> dict:
        """Flat process-level metrics + tracer/ledger meta."""
        out = self.metrics.snapshot()
        out["trace_events"] = len(self.tracer.events)
        out["trace_dropped"] = self.tracer.dropped
        out["ledger_rows"] = len(self.ledger.rows)
        return out

    def clear(self) -> None:
        self.tracer.clear()
        self.ledger.clear()
        self.metrics.reset()


_GLOBAL: Optional[Telemetry] = None
_GLOBAL_LOCK = threading.Lock()


def get() -> Telemetry:
    """The process-global Telemetry, constructed on first use from the
    REPRO_TRACE gate.  Executors created without an explicit
    ``telemetry=`` share this one, so a single Chrome trace covers the
    whole query stack."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = Telemetry()
        return _GLOBAL


def set_global(telemetry: Optional[Telemetry]) -> None:
    """Swap the process-global instance (None re-reads the env gate on
    next ``get()``) — the test/bench hook for enabling tracing without
    environment surgery."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        _GLOBAL = telemetry
