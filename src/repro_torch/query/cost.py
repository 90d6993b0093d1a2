"""Bandwidth-aware cost model — the optimizer's pricing of physical
alternatives, for the nodes of the select -> join -> aggregate path, the
GLM roots (TrainGLM, ScoreGLM) and the memory tiers below the device.

The paper's lesson (Fig. 2/5) is that placement and access pattern decide
achieved bandwidth.  This module prices each (placement, pass-count)
alternative of every physical operator so the executor can pick the
placement per operator, and prices moving a column between the device,
host DRAM and disk so the spill planner (``query/tiering.py``) can place
an over-budget working set.  Which code runs is not priced: the kernel
wrappers launch the hand-written kernels on a CUDA device and their plain
versions on the CPU, so the model only carries that choice as the label
``impl`` (``cuda`` or ``torch``) that ``explain`` shows; the label picks
which calibrated efficiency and call overhead price the plan.

The bandwidth and the float32 rate are NVIDIA's data-sheet figures for
the H100 (``channels.H100_HBM_GBPS``, ``H100_FP32_FLOPS``).  Every other
constant below is a placeholder until a calibration measured on the card
(``query/calibrate.py``, ``BENCH_calibration_torch.json``) overlays it.

Under a shard layout (``CostModel(n_shards=N)``, N > 1) streams take the
``sharded`` placement, and a join on it prices two ways to co-locate its
build and probe rows: broadcasting the build to every shard, or
shuffling both sides by key (``core/join.join_shuffle_multi``).  The
reference priced the repartition on a TPU's inter-chip links; on one card
the shards are slices of the same HBM, so the "interconnect" is the
card's own memory: the shuffle's and the broadcast's bytes are priced at
``H100_HBM_GBPS``, and the ``sharded`` placement streams at the card's
rate, not N times it.  What the shuffle can win is fewer rescan passes: a
shard builds only its ~1/N of the build side.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, Optional, Tuple

from repro_torch.core.channels import H100_FP32_FLOPS, H100_HBM_GBPS
from repro_torch.core.join import HT_CAPACITY
from repro_torch.query import logical as L

BYTES_PER_VALUE = 4                 # int32/float32 columns

# streaming efficiency and fixed per-call overhead (sec) of each impl:
# placeholders until calibrated on the card
IMPLS = ("torch", "cuda")
STREAM_EFF = 0.70
CALL_OVERHEAD_S = 2e-6

# host -> device staging for per-morsel transfers: PCIe Gen5 x16, one
# direction, data-sheet figure (placeholder until calibrated)
H2D_GBPS = 64.0
# fixed cost of dispatching one morsel's staging transfer (placeholder)
STAGE_OVERHEAD_S = 1.2e-4

# memory-hierarchy tiers below the device (the paper's HBM <-> DDR4
# hierarchy, one rung further to disk), all placeholders: device -> host
# over the same PCIe Gen5 link, one DDR5-4800 channel, and an NVMe PCIe
# Gen4 x4 drive's sequential read; each is a calibration key
D2H_GBPS = 64.0
HOST_DRAM_GBPS = 38.4
DISK_GBPS = 7.0

# tier order, top (fastest, smallest) to bottom: the spill planner fills
# in this order
TIERS = ("device", "host", "disk")

# the port's own calibration file and override, never the reference's
# BENCH_calibration.json / REPRO_CALIBRATION
CALIBRATION_FILE = "BENCH_calibration_torch.json"
CALIBRATION_ENV = "REPRO_TORCH_CALIBRATION"
# the calibration file's channel keys, beside its per-impl "backends"
CHANNEL_KEYS = ("h2d_gbps", "d2h_gbps", "host_gbps", "disk_gbps",
                 "stage_overhead_s")


def load_calibration(path: Optional[str] = None) -> Optional[dict]:
    """The card's measured per-impl stream efficiencies, call overheads
    and tier channels, as ``query/calibrate.py`` writes them.  Returns
    None (the placeholders apply) when the file is absent or unreadable:
    calibration is an overlay, never a requirement.  ``path=None`` reads
    ``BENCH_calibration_torch.json`` in the working directory unless
    ``REPRO_TORCH_CALIBRATION`` names another file, or is ``off``/``0``/
    ``none`` to disable the overlay."""
    if path is None:
        env = os.environ.get(CALIBRATION_ENV, "")
        if env.lower() in ("off", "0", "none"):
            return None
        path = env or os.path.join(os.getcwd(), CALIBRATION_FILE)
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    return data if isinstance(data, dict) and "backends" in data else None


# --------------------------------------------------------------------------- #
# catalog statistics

@dataclasses.dataclass
class ColumnStats:
    lo: int
    hi: int
    n_distinct: Optional[int] = None

    @property
    def domain(self) -> int:
        return max(int(self.hi) - int(self.lo) + 1, 1)


@dataclasses.dataclass
class TableStats:
    num_rows: int
    columns: Tuple[str, ...]
    ranges: Dict[str, ColumnStats]


def selectivity(stats: ColumnStats, lo: int, hi: int) -> float:
    """Uniform-domain estimate of a range predicate's selectivity."""
    span = min(hi, stats.hi) - max(lo, stats.lo) + 1
    return min(max(span, 0) / stats.domain, 1.0)


# measured/predicted selectivity correction factors are clamped so one bad
# ledger window can never swing a plan by more than 4x either way
SEL_CORRECTION_CLAMP = (0.25, 4.0)


def clamp_correction(factor: float) -> float:
    lo, hi = SEL_CORRECTION_CLAMP
    return min(max(float(factor), lo), hi)


def estimate_rows(node: L.Node, stats: Dict[str, TableStats],
                  corrections: Optional[Dict[Tuple[str, str], float]] = None
                  ) -> float:
    """Cardinality estimate — drives build/probe side selection and the
    multi-pass join block count.

    ``corrections`` maps (table, column) to a measured-over-predicted
    bytes ratio from the bandwidth ledger (``Executor.recost`` folds them
    in from ``BandwidthLedger.selectivity_corrections``): the uniform-
    domain selectivity of a filter over that column is scaled by the
    clamped factor."""
    if isinstance(node, L.Scan):
        return float(stats[node.table].num_rows)
    if isinstance(node, (L.Filter, L.FilterProject)):
        base = estimate_rows(node.child, stats, corrections)
        cs = _column_stats(node.child, node.column, stats)
        sel = selectivity(cs, node.lo, node.hi) if cs else 0.33
        if corrections:
            scan = probe_base_scan(node.child)
            f = corrections.get((scan.table, node.column)) if scan else None
            if f is not None:
                sel = min(sel * clamp_correction(f), 1.0)
        return base * sel
    if isinstance(node, L.Join):
        l = estimate_rows(node.left, stats, corrections)
        r = estimate_rows(node.right, stats, corrections)
        cs = _column_stats(node.right, node.on, stats)
        ls = _column_stats(node.left, node.on, stats)
        # expected matches per probe row ~ |build| / |key domain|, over
        # the probe rows whose key lands in the build domain
        matches = r / cs.domain if cs else 0.1
        if cs and ls:
            overlap = min(cs.hi, ls.hi) - max(cs.lo, ls.lo) + 1
            frac = min(max(overlap, 0) / ls.domain, 1.0)
        else:
            frac = 1.0
        return l * matches * frac
    if isinstance(node, (L.Project, L.ScoreGLM)):
        return estimate_rows(node.child, stats, corrections)
    if isinstance(node, (L.Aggregate, L.TrainGLM)):
        return 1.0
    raise TypeError(node)


def _column_stats(node: L.Node, column: str,
                  stats: Dict[str, TableStats]) -> Optional[ColumnStats]:
    for n in L.walk(node):
        if isinstance(n, L.Scan):
            t = stats.get(n.table)
            if t and column in t.ranges:
                return t.ranges[column]
    return None


def key_is_unique(node: L.Node, column: str,
                  stats: Dict[str, TableStats]) -> bool:
    """Whether ``column`` is provably duplicate-free in ``node``'s output:
    provably-unique build keys take the open-addressing fast path (op
    "join"), everything else the multi-match path (op "join_multi").
    Scans check catalog distinct counts; filters/projections preserve
    uniqueness; a join output is treated as non-unique."""
    if isinstance(node, L.Scan):
        t = stats.get(node.table)
        cs = t.ranges.get(column) if t else None
        return bool(cs and cs.n_distinct is not None
                    and cs.n_distinct == t.num_rows)
    if isinstance(node, (L.Filter, L.FilterProject, L.Project)):
        return key_is_unique(node.child, column, stats)
    return False


def expected_chain_length(node: L.Node, column: str,
                          stats: Dict[str, TableStats]) -> float:
    """Average duplicate-chain length of ``column`` in ``node``'s output —
    the multi-match probe's per-row work and output multiplier."""
    rows = max(estimate_rows(node, stats), 1.0)
    cs = _column_stats(node, column, stats)
    if cs is None:
        return 1.0
    distinct = cs.n_distinct if cs.n_distinct else min(rows, cs.domain)
    return max(rows / max(float(distinct), 1.0), 1.0)


# --------------------------------------------------------------------------- #
# the model

class CostModel:
    """Prices one physical operator alternative at a time on one card
    split into ``n_engines`` contiguous shards, under a shard layout of
    ``n_shards`` slices (1: none).  ``impl`` labels the code
    the device runs: ``cuda`` (the kernels) or ``torch`` (plain versions).
    ``calibration`` overlays measured constants (``load_calibration``)."""

    def __init__(self, n_engines: int = 1, *, n_shards: int = 1,
                 impl: str = "torch", calibration: Optional[dict] = None):
        if impl not in IMPLS:
            raise ValueError(f"impl must be 'torch' or 'cuda', got {impl!r}")
        self.n_engines = int(n_engines)
        # shard-layout width; 1 keeps every plan byte-for-byte unsharded
        self.n_shards = max(int(n_shards), 1)
        self.impl = impl
        # (table, column) -> measured/predicted bytes ratio fed back from
        # the bandwidth ledger by Executor.recost (clamped at use)
        self.sel_corrections: Dict[Tuple[str, str], float] = {}
        self.stream_eff = {i: STREAM_EFF for i in IMPLS}
        self.call_overhead = {i: CALL_OVERHEAD_S for i in IMPLS}
        self.h2d_gbps = H2D_GBPS
        self.stage_overhead_s = STAGE_OVERHEAD_S
        self.d2h_gbps = D2H_GBPS
        self.host_gbps = HOST_DRAM_GBPS
        self.disk_gbps = DISK_GBPS
        # the pristine constants: every overlay re-baselines against
        # these, so applying one twice can never compound
        self._baseline = {"stream_eff": dict(self.stream_eff),
                          "call_overhead": dict(self.call_overhead),
                          **{k: getattr(self, k) for k in CHANNEL_KEYS}}
        self.calibrated_from: Optional[str] = None
        self.n_calibrations = 0
        if calibration:
            self.apply_calibration(calibration)

    def apply_calibration(self, calibration: dict) -> None:
        """Overlay measured numbers on the pristine constants.  Idempotent:
        every constant resets to its baseline before the overlay lands,
        so an overlay describes an absolute state, and an impl (or
        channel) the overlay does not mention returns to its placeholder.
        Efficiencies are clamped to (0, 1]."""
        self.stream_eff = dict(self._baseline["stream_eff"])
        self.call_overhead = dict(self._baseline["call_overhead"])
        for key in CHANNEL_KEYS:
            setattr(self, key, self._baseline[key])
        for impl, meas in calibration.get("backends", {}).items():
            if impl not in self.stream_eff:
                continue
            eff = meas.get("stream_eff")
            if eff and eff > 0:
                self.stream_eff[impl] = min(float(eff), 1.0)
            over = meas.get("call_overhead_s")
            if over and over > 0:
                self.call_overhead[impl] = float(over)
        for key in CHANNEL_KEYS:
            v = calibration.get(key)
            if v and v > 0:
                setattr(self, key, float(v))
        self.calibrated_from = calibration.get("backend", "measured")
        self.n_calibrations += 1

    def calibration_snapshot(self) -> dict:
        """The model's current constants in the calibration file's shape."""
        snap = {"backend": self.calibrated_from or "placeholder",
                "backends": {impl: {"stream_eff": self.stream_eff[impl],
                                    "call_overhead_s":
                                        self.call_overhead[impl]}
                             for impl in IMPLS}}
        for key in CHANNEL_KEYS:
            snap[key] = getattr(self, key)
        return snap

    def bandwidth_gbps(self, placement: str) -> float:
        """Every engine and shard streams the same HBM, so all placements
        ("sharded" too) price at the card's rate; a column on a lower tier
        ("host", "disk") streams at that tier's channel."""
        if placement == "host":
            return self.host_gbps
        if placement == "disk":
            return self.disk_gbps
        return H100_HBM_GBPS

    def stream_cost(self, n_bytes: float, *, placement: str,
                    n_passes: int = 1, flops: float = 0.0) -> float:
        """Seconds to stream ``n_bytes`` under ``placement``, roofline-
        combined with any compute the operator does."""
        bw = self.bandwidth_gbps(placement) * 1e9 * self.stream_eff[self.impl]
        t_mem = n_passes * n_bytes / bw
        return max(t_mem, flops / H100_FP32_FLOPS) \
            + n_passes * self.call_overhead[self.impl]

    def broadcast_cost(self, n_bytes: float) -> float:
        """Replicating a build side to every engine: n-1 extra copies
        through the card's memory."""
        if self.n_engines <= 1:
            return 0.0
        return n_bytes * (self.n_engines - 1) \
            / (self.bandwidth_gbps("replicated") * 1e9)

    def shuffle_cost(self, n_bytes: float) -> float:
        """Seconds to hash-repartition ``n_bytes`` across the shards: under
        a uniform hash (n-1)/n of every shard's rows change shards, copied
        through the card's memory."""
        if self.n_shards <= 1:
            return 0.0
        return n_bytes * (self.n_shards - 1) / self.n_shards \
            / (H100_HBM_GBPS * 1e9)

    def shard_broadcast_cost(self, n_bytes: float) -> float:
        """Replicating a build side to every shard: n-1 extra copies
        through the card's memory."""
        if self.n_shards <= 1:
            return 0.0
        return n_bytes * (self.n_shards - 1) / (H100_HBM_GBPS * 1e9)

    # -- tier pricing (device <-> host <-> disk) ---------------------------- #

    def cache_score(self, recompute_s: float, n_bytes: int,
                    hits: int = 0) -> float:
        """Seconds of recompute avoided per resident byte, scaled by
        observed reuse."""
        return max(recompute_s, 0.0) * (1.0 + hits) \
            / max(float(n_bytes), 1.0)

    def promotion_cost(self, n_bytes: float, src_tier: str) -> float:
        """Seconds to move ``n_bytes`` from ``src_tier`` onto the device:
        host pays the staging link, disk the sequential read and the
        staging link (serial within one morsel's fetch)."""
        if src_tier == "device":
            return 0.0
        t = n_bytes / (self.h2d_gbps * 1e9)
        if src_tier == "disk":
            t += n_bytes / (self.disk_gbps * 1e9)
        return t

    def demotion_cost(self, n_bytes: float, dst_tier: str) -> float:
        """Seconds to push ``n_bytes`` down to ``dst_tier`` (the device ->
        host copy, plus the disk write when demoting to disk)."""
        if dst_tier == "device":
            return 0.0
        t = n_bytes / (self.d2h_gbps * 1e9)
        if dst_tier == "disk":
            t += n_bytes / (self.disk_gbps * 1e9)
        return t

    def tier_score(self, recompute_s: float, n_bytes: int,
                   hits: int = 0, tier: str = "device") -> float:
        """``cache_score`` net of the promotion a hit on ``tier`` pays to
        come back up, floored at zero."""
        net = max(recompute_s, 0.0) - self.promotion_cost(
            float(max(n_bytes, 1)), tier)
        return max(net, 0.0) * (1.0 + hits) / max(float(n_bytes), 1.0)

    # -- semantic-cache pricing --------------------------------------------- #

    def refine_price(self, cached_rows: float, *,
                     placement: str = "partitioned") -> float:
        """Seconds to serve a selection by refining a cached superset
        bitmap instead of rescanning the base column: stream the cached
        index, gather the predicate column at those positions and write
        the surviving subset, three bitmap-sized streams."""
        n_bytes = 3.0 * max(float(cached_rows), 0.0) * BYTES_PER_VALUE
        return self.stream_cost(n_bytes, placement=placement)

    def refine_wins(self, cached_rows: float, base_rows: float, *,
                    placement: str = "partitioned") -> bool:
        """Whether refining a ``cached_rows``-entry superset bitmap beats
        rescanning the ``base_rows``-row column.  Both sides are priced
        under one (impl, placement), so efficiency and call overhead
        cancel and the verdict is the reference's: 3 * cached < base."""
        return self.refine_price(cached_rows, placement=placement) \
            < self.stream_cost(max(float(base_rows), 1.0) * BYTES_PER_VALUE,
                               placement=placement)

    def build_price(self, n_rows: float, n_value_cols: int = 0) -> float:
        """Recompute cost of a sorted-bucket join build: the n log n key
        sort and the prefix sums over each carried value column on the
        replicated placement, plus the replication broadcast.  What a
        cached build saves a pipeline."""
        n_rows = max(float(n_rows), 1.0)
        sort_bytes = n_rows * BYTES_PER_VALUE * max(
            math.log2(max(n_rows, 2.0)), 1.0)
        value_bytes = n_rows * BYTES_PER_VALUE * (1 + n_value_cols)
        return (self.stream_cost(sort_bytes + value_bytes,
                                 placement="replicated")
                + self.broadcast_cost(n_rows * BYTES_PER_VALUE
                                      * (2 + n_value_cols)))

    # -- morsel pricing (streaming pipeline) -------------------------------- #

    def morsel_cost(self, total_rows: float, morsel_rows: int, n_cols: int,
                    *, flops_per_row: float = 0.0,
                    include_transfer: bool = True,
                    src_tier: str = "host") -> float:
        """Seconds to stream ``total_rows`` in double-buffered morsels: the
        next morsel's promotion from ``src_tier`` (``promotion_cost`` plus
        the fixed staging overhead) overlaps the current morsel's compute,
        so steady state pays max(transfer, compute) per morsel.
        ``include_transfer=False`` prices device-resident sources."""
        n_morsels = max(-(-int(total_rows) // int(morsel_rows)), 1)
        m_bytes = morsel_rows * BYTES_PER_VALUE * n_cols
        t_x = (self.promotion_cost(m_bytes, src_tier)
               + self.stage_overhead_s) if include_transfer else 0.0
        t_c = self.stream_cost(m_bytes, placement="partitioned",
                               flops=flops_per_row * morsel_rows)
        return n_morsels * max(t_x, t_c) + min(t_x, t_c)

    def choose_morsel_rows(self, total_rows: float, n_cols: int, *,
                           align: Optional[int] = None,
                           flops_per_row: float = 0.0,
                           include_transfer: bool = True,
                           src_tier: str = "host") -> int:
        """argmin of ``morsel_cost`` over power-of-two candidates (and the
        whole input), aligned to the engine count, and under a shard
        layout to the shard count too: one morsel must cut evenly across
        both."""
        align = align or math.lcm(self.n_engines, self.n_shards)
        total = max(int(total_rows), 1)
        best_rows, best_cost = None, math.inf
        candidates = []
        k = 10                                      # start at 1024-ish rows
        while (1 << k) * align < total * 2:
            candidates.append((1 << k) * align)
            k += 1
        candidates.append(-(-total // align) * align)   # whole input
        for rows in candidates:
            c = self.morsel_cost(total, rows, n_cols,
                                 flops_per_row=flops_per_row,
                                 include_transfer=include_transfer,
                                 src_tier=src_tier)
            if c < best_cost:
                best_rows, best_cost = rows, c
        return best_rows


# --------------------------------------------------------------------------- #
# physical planning

@dataclasses.dataclass
class PhysNode:
    """A logical node annotated with the chosen physical alternative."""
    op: str
    logical: L.Node
    impl: str
    placement: str
    n_passes: int
    est_rows_out: float
    cost_s: float
    gbps: float
    alternatives: Dict[str, float]
    children: Tuple["PhysNode", ...] = ()
    morsel_rows: Optional[int] = None     # streaming pipeline granularity
    n_bytes: float = 0.0                  # predicted bytes moved (priced)
    shard_strategy: Optional[str] = None  # under a shard layout: a join's
                                          # "broadcast" | "shuffle", a
                                          # TrainGLM's "replicated"

    @property
    def total_cost_s(self) -> float:
        return self.cost_s + sum(c.total_cost_s for c in self.children)

    def describe(self) -> str:
        morsel = f" morsel={self.morsel_rows}" if self.morsel_rows else ""
        strat = f" strategy={self.shard_strategy}" if self.shard_strategy \
            else ""
        return (f"impl={self.impl} placement={self.placement} "
                f"passes={self.n_passes} est_rows={self.est_rows_out:.0f} "
                f"cost={self.cost_s * 1e6:.1f}us bw={self.gbps:.0f}GB/s"
                f"{morsel}{strat}")


def _choose(model: CostModel, n_bytes: float, placements: Tuple[str, ...],
            *, n_passes: int = 1, flops: float = 0.0):
    """argmin over placements; returns (placement, cost, alts)."""
    alts = {pl: model.stream_cost(n_bytes, placement=pl, n_passes=n_passes,
                                  flops=flops)
            for pl in placements}
    best = min(alts, key=alts.get)
    return best, alts[best], alts


def _stream_placements(model: CostModel) -> Tuple[str, ...]:
    """Stream-role placement alternatives: an active shard layout replaces
    "partitioned" with "sharded" (unsharded plans are unchanged)."""
    if model.n_shards > 1:
        return ("sharded", "congested")
    return ("partitioned", "congested")


def plan_physical(node: L.Node, stats: Dict[str, TableStats],
                  model: CostModel, *, role: str = "stream") -> PhysNode:
    """Annotate a (logically optimized) plan with per-column placement,
    pass counts, costs, and the model's impl label.  ``role="build"`` is
    the build side of a join (replicated to every engine); everything
    else streams.  Filter selectivities take the model's
    ``sel_corrections``."""
    corr = model.sel_corrections or None
    rows = estimate_rows(node, stats, corr)

    if isinstance(node, L.Scan):
        n_cols = len(L.output_columns(node, {t: s.columns
                                             for t, s in stats.items()}))
        n_bytes = stats[node.table].num_rows * BYTES_PER_VALUE * n_cols
        if role == "build":
            # the source column is read once before the replication
            cost = model.broadcast_cost(n_bytes) + model.stream_cost(
                n_bytes, placement="replicated")
            return PhysNode("scan", node, model.impl, "replicated", 1, rows,
                            cost, model.bandwidth_gbps("replicated"),
                            {"replicated": cost}, n_bytes=n_bytes)
        pl, cost, alts = _choose(model, n_bytes, _stream_placements(model))
        return PhysNode("scan", node, model.impl, pl, 1, rows, cost,
                        model.bandwidth_gbps(pl), alts, n_bytes=n_bytes)

    if isinstance(node, (L.Filter, L.FilterProject)):
        child = plan_physical(node.child, stats, model, role=role)
        in_rows = estimate_rows(node.child, stats, corr)
        n_out_cols = len(node.columns) if isinstance(node, L.FilterProject) \
            else 1
        n_bytes = in_rows * BYTES_PER_VALUE + rows * BYTES_PER_VALUE \
            * n_out_cols
        placements = ("replicated",) if role == "build" \
            else _stream_placements(model)
        pl, cost, alts = _choose(model, n_bytes, placements)
        op = "filter_project" if isinstance(node, L.FilterProject) \
            else "filter"
        return PhysNode(op, node, model.impl, pl, 1, rows, cost,
                        model.bandwidth_gbps(pl), alts, (child,),
                        n_bytes=n_bytes)

    if isinstance(node, L.Join):
        left = plan_physical(node.left, stats, model, role="stream")
        right = plan_physical(node.right, stats, model, role="build")
        build_rows = estimate_rows(node.right, stats, corr)
        probe_rows = estimate_rows(node.left, stats, corr)
        n_passes = max(-(-int(build_rows) // HT_CAPACITY), 1)
        unique = key_is_unique(node.right, node.on, stats)
        chain = 1.0 if unique \
            else expected_chain_length(node.right, node.on, stats)
        if unique:
            # open-addressing fast path: one egress line per probe row,
            # plus the one-time table build (divided back out of the
            # per-pass multiplication)
            n_bytes = (probe_rows * BYTES_PER_VALUE
                       + build_rows * BYTES_PER_VALUE / n_passes)
            op = "join"
        else:
            # multi-match probe: per-row work scales with the expected
            # chain length; the pair list and the sorted-bucket build are
            # paid once, so their bytes are divided by n_passes
            sort_bytes = build_rows * BYTES_PER_VALUE * max(
                math.log2(max(build_rows, 2.0)), 1.0)
            n_bytes = (probe_rows * BYTES_PER_VALUE * max(chain, 1.0)
                       + (2 * rows * BYTES_PER_VALUE + sort_bytes)
                       / n_passes)
            op = "join_multi"
        # the probe runs wherever the probe stream already lives
        probe_pl = left.placement if left.placement != "replicated" \
            else _stream_placements(model)[0]
        pl, cost, alts = _choose(model, n_bytes, (probe_pl,),
                                 n_passes=n_passes)
        shard_strategy = None
        if model.n_shards > 1 and pl == "sharded":
            # two ways to co-locate build and probe rows on a shard:
            #   broadcast: copy the build to every shard; each shard
            #     probes against the whole build (ceil(build /
            #     HT_CAPACITY) rescans, n redundant build sorts);
            #   shuffle: repartition both sides by key; each shard builds
            #     only its ~1/n, collapsing the rescans, at the price of
            #     (n-1)/n of every byte changing shards.
            n = float(model.n_shards)
            build_bytes = build_rows * BYTES_PER_VALUE
            probe_bytes = probe_rows * BYTES_PER_VALUE
            passes_sh = max(-(-int(max(build_rows / n, 1.0))
                              // HT_CAPACITY), 1)

            def _strategy_bytes(local_build, passes, n_copies):
                # stream_cost's accounting: one-time build terms are
                # divided by the pass count that multiplies them back up;
                # ``n_copies`` shards redo the build work
                if unique:
                    return (probe_bytes + n_copies * local_build
                            * BYTES_PER_VALUE / passes)
                sort_b = n_copies * local_build * BYTES_PER_VALUE * max(
                    math.log2(max(local_build, 2.0)), 1.0)
                return (probe_bytes * max(chain, 1.0)
                        + (2 * rows * BYTES_PER_VALUE + sort_b) / passes)

            alt_b = model.shard_broadcast_cost(build_bytes) \
                + model.stream_cost(_strategy_bytes(build_rows, n_passes, n),
                                    placement="sharded", n_passes=n_passes)
            alt_s = model.shuffle_cost(probe_bytes + build_bytes) \
                + model.stream_cost(
                    _strategy_bytes(build_rows / n, passes_sh, n),
                    placement="sharded", n_passes=passes_sh)
            alts["shard/broadcast"] = alt_b
            alts["shard/shuffle"] = alt_s
            if alt_s < alt_b:
                shard_strategy, cost, n_passes = "shuffle", alt_s, passes_sh
            else:
                shard_strategy, cost = "broadcast", alt_b
        return PhysNode(op, node, model.impl, pl, n_passes, rows, cost,
                        model.bandwidth_gbps(pl), alts, (left, right),
                        n_bytes=n_bytes, shard_strategy=shard_strategy)

    if isinstance(node, L.Project):
        child = plan_physical(node.child, stats, model, role=role)
        n_bytes = rows * BYTES_PER_VALUE * len(node.columns)
        pl, cost, alts = _choose(model, n_bytes,
                                 _stream_placements(model)[:1])
        return PhysNode("project", node, model.impl, pl, 1, rows, cost,
                        model.bandwidth_gbps(pl), alts, (child,),
                        n_bytes=n_bytes)

    if isinstance(node, L.Aggregate):
        child = plan_physical(node.child, stats, model, role=role)
        n_bytes = estimate_rows(node.child, stats, corr) * BYTES_PER_VALUE
        pl, cost, alts = _choose(model, n_bytes,
                                 _stream_placements(model)[:1])
        # streaming granularity for the pipeline this aggregate roots,
        # priced on the probe-spine base scan (the stream source)
        base = probe_base_scan(node.child)
        morsel_rows = None
        if base is not None and base.table in stats:
            n_cols = len(base.columns) if base.columns is not None \
                else len(stats[base.table].columns)
            morsel_rows = model.choose_morsel_rows(
                stats[base.table].num_rows, max(n_cols, 1))
        return PhysNode("aggregate", node, model.impl, pl, 1, 1.0, cost,
                        model.bandwidth_gbps(pl), alts, (child,),
                        morsel_rows=morsel_rows, n_bytes=n_bytes)

    if isinstance(node, L.TrainGLM):
        child = plan_physical(node.child, stats, model, role="build")
        in_rows = estimate_rows(node.child, stats)
        k = len(node.grid)
        d = len(node.features)
        dataset = in_rows * BYTES_PER_VALUE * (d + 1)
        epoch_bytes = dataset * node.epochs * k
        # replicated: pay the copies once, then every job streams its own
        # replica (Fig. 10a); congested: every job reads the one copy.  On
        # one card both stream the same HBM, so they tie at one engine
        flops = 6.0 * node.epochs * k * in_rows * d
        alts = {
            f"{model.impl}/replicated": model.broadcast_cost(dataset)
            + model.stream_cost(epoch_bytes, placement="partitioned",
                                flops=flops),
            f"{model.impl}/congested": model.stream_cost(
                epoch_bytes, placement="congested", flops=flops),
        }
        shard_strategy = None
        if model.n_shards > 1:
            # Fig. 10a over the shards: copy the training set to every
            # shard once, then each shard's jobs stream its own replica
            alts["shard/replicated"] = model.shard_broadcast_cost(dataset) \
                + model.stream_cost(epoch_bytes, placement="sharded",
                                    flops=flops)
        best = min(alts, key=alts.get)
        pl = best.split("/")[1]
        if best.startswith("shard/"):
            pl, shard_strategy = "sharded", pl
        # streaming granularity for the epoch loop: each epoch re-streams
        # the training set, so the morsel argmin prices the per-pass
        # feature+label bytes with the per-row SGD flops
        base = probe_base_scan(node.child)
        morsel_rows = None
        if base is not None and base.table in stats:
            morsel_rows = model.choose_morsel_rows(
                stats[base.table].num_rows, d + 1,
                flops_per_row=6.0 * k * d)
        return PhysNode("train_glm", node, model.impl, pl, 1, 1.0,
                        alts[best], model.bandwidth_gbps(pl), alts,
                        (child,), morsel_rows=morsel_rows,
                        n_bytes=epoch_bytes, shard_strategy=shard_strategy)

    if isinstance(node, L.ScoreGLM):
        child = plan_physical(node.child, stats, model, role=role)
        d = len(node.features)
        in_rows = estimate_rows(node.child, stats, corr)
        # one pass over the feature columns plus the written score column
        n_bytes = in_rows * BYTES_PER_VALUE * d + rows * BYTES_PER_VALUE
        pl, cost, alts = _choose(model, n_bytes,
                                 _stream_placements(model)[:1],
                                 flops=2.0 * in_rows * d)
        return PhysNode("score_glm", node, model.impl, pl, 1, rows, cost,
                        model.bandwidth_gbps(pl), alts, (child,),
                        n_bytes=n_bytes)

    raise TypeError(node)


def probe_base_scan(node: L.Node) -> Optional[L.Scan]:
    """The Scan feeding a pipeline's probe spine — the stream source the
    morsel driver cuts into slices.  Follows Join.left down to the leaf."""
    while not isinstance(node, L.Scan):
        if isinstance(node, (L.Filter, L.FilterProject, L.Project,
                             L.Aggregate, L.TrainGLM, L.ScoreGLM)):
            node = node.child
        elif isinstance(node, L.Join):
            node = node.left
        else:
            return None
    return node


def join_orientation_cost(join: L.Join, stats: Dict[str, TableStats],
                          model: CostModel) -> float:
    """Total priced cost of one build/probe orientation of ``join``; the
    optimizer compares both orientations with it."""
    return plan_physical(join, stats, model).total_cost_s


def column_placements(phys: PhysNode) -> Dict[Tuple[str, str], str]:
    """(table, column) -> chosen placement, read off the scan leaves."""
    out: Dict[Tuple[str, str], str] = {}

    def visit(p: PhysNode):
        if p.op == "scan":
            node = p.logical
            cols = node.columns or ()
            for c in cols:
                out[(node.table, c)] = p.placement
            if not cols:
                out[(node.table, "*")] = p.placement
        for c in p.children:
            visit(c)

    visit(phys)
    return out
