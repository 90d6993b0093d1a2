"""Bandwidth-aware cost model — the optimizer's pricing of physical
alternatives, for the nodes of the select -> join -> aggregate path and
the GLM roots (TrainGLM, ScoreGLM).

The paper's lesson (Fig. 2/5) is that placement and access pattern decide
achieved bandwidth.  This module prices each (placement, pass-count)
alternative of every physical operator so the executor can pick the
placement per operator.  Which code runs is not priced: the kernel
wrappers launch the hand-written kernels on a CUDA device and their plain
versions on the CPU, so the model only carries that choice as the label
``impl`` (``cuda`` or ``torch``) that ``explain`` shows.

The bandwidth and the float32 rate default to NVIDIA's data-sheet
figures for the H100 (``channels.H100_HBM_GBPS``, ``H100_FP32_FLOPS``),
and the efficiency and per-call overhead are placeholders: all of them
wait for the port's calibration on the card.
Unlike the reference, the port reads no calibration file.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

from repro_torch.core.channels import H100_FP32_FLOPS, H100_HBM_GBPS
from repro_torch.core.join import HT_CAPACITY
from repro_torch.query import logical as L

BYTES_PER_VALUE = 4                 # int32/float32 columns

# streaming efficiency and fixed per-call overhead (sec): the reference's
# defaults for its plain path, placeholders until calibrated on the card
STREAM_EFF = 0.70
CALL_OVERHEAD_S = 2e-6

# host -> device staging for per-morsel transfers: PCIe Gen5 x16, one
# direction, data-sheet figure
H2D_GBPS = 64.0
# fixed cost of dispatching one morsel's staging transfer
STAGE_OVERHEAD_S = 1.2e-4


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


def estimate_rows(node: L.Node, stats: Dict[str, TableStats]) -> float:
    """Cardinality estimate — drives build/probe side selection and the
    multi-pass join block count."""
    if isinstance(node, L.Scan):
        return float(stats[node.table].num_rows)
    if isinstance(node, (L.Filter, L.FilterProject)):
        base = estimate_rows(node.child, stats)
        cs = _column_stats(node.child, node.column, stats)
        return base * (selectivity(cs, node.lo, node.hi) if cs else 0.33)
    if isinstance(node, L.Join):
        l = estimate_rows(node.left, stats)
        r = estimate_rows(node.right, stats)
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
        return estimate_rows(node.child, stats)
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
    split into ``n_engines`` contiguous shards.  ``impl`` labels the code
    the device runs: ``cuda`` (the kernels) or ``torch`` (plain versions)."""

    def __init__(self, n_engines: int = 1, *, impl: str = "torch"):
        if impl not in ("torch", "cuda"):
            raise ValueError(f"impl must be 'torch' or 'cuda', got {impl!r}")
        self.n_engines = int(n_engines)
        self.impl = impl

    def bandwidth_gbps(self, placement: str) -> float:
        """Every engine streams the same HBM, so all placements price at
        the card's rate."""
        del placement
        return H100_HBM_GBPS

    def stream_cost(self, n_bytes: float, *, placement: str,
                    n_passes: int = 1, flops: float = 0.0) -> float:
        """Seconds to stream ``n_bytes`` under ``placement``, roofline-
        combined with any compute the operator does."""
        bw = self.bandwidth_gbps(placement) * 1e9 * STREAM_EFF
        t_mem = n_passes * n_bytes / bw
        return max(t_mem, flops / H100_FP32_FLOPS) \
            + n_passes * CALL_OVERHEAD_S

    def broadcast_cost(self, n_bytes: float) -> float:
        """Replicating a build side to every engine: n-1 extra copies
        through the card's memory."""
        if self.n_engines <= 1:
            return 0.0
        return n_bytes * (self.n_engines - 1) \
            / (self.bandwidth_gbps("replicated") * 1e9)

    # -- morsel pricing (streaming pipeline) -------------------------------- #

    def morsel_cost(self, total_rows: float, morsel_rows: int, n_cols: int,
                    *, flops_per_row: float = 0.0,
                    include_transfer: bool = True) -> float:
        """Seconds to stream ``total_rows`` in double-buffered morsels: the
        next morsel's host->device copy overlaps the current morsel's
        compute, so steady state pays max(transfer, compute) per morsel.
        ``include_transfer=False`` prices device-resident sources."""
        n_morsels = max(-(-int(total_rows) // int(morsel_rows)), 1)
        m_bytes = morsel_rows * BYTES_PER_VALUE * n_cols
        t_x = (m_bytes / (H2D_GBPS * 1e9) + STAGE_OVERHEAD_S) \
            if include_transfer else 0.0
        t_c = self.stream_cost(m_bytes, placement="partitioned",
                               flops=flops_per_row * morsel_rows)
        return n_morsels * max(t_x, t_c) + min(t_x, t_c)

    def choose_morsel_rows(self, total_rows: float, n_cols: int, *,
                           align: Optional[int] = None,
                           flops_per_row: float = 0.0,
                           include_transfer: bool = True) -> int:
        """argmin of ``morsel_cost`` over power-of-two candidates (and the
        whole input), aligned to the engine count."""
        align = align or self.n_engines
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
                                 include_transfer=include_transfer)
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

    @property
    def total_cost_s(self) -> float:
        return self.cost_s + sum(c.total_cost_s for c in self.children)

    def describe(self) -> str:
        morsel = f" morsel={self.morsel_rows}" if self.morsel_rows else ""
        return (f"impl={self.impl} placement={self.placement} "
                f"passes={self.n_passes} est_rows={self.est_rows_out:.0f} "
                f"cost={self.cost_s * 1e6:.1f}us bw={self.gbps:.0f}GB/s"
                f"{morsel}")


def _choose(model: CostModel, n_bytes: float, placements: Tuple[str, ...],
            *, n_passes: int = 1, flops: float = 0.0):
    """argmin over placements; returns (placement, cost, alts)."""
    alts = {pl: model.stream_cost(n_bytes, placement=pl, n_passes=n_passes,
                                  flops=flops)
            for pl in placements}
    best = min(alts, key=alts.get)
    return best, alts[best], alts


STREAM_PLACEMENTS = ("partitioned", "congested")


def plan_physical(node: L.Node, stats: Dict[str, TableStats],
                  model: CostModel, *, role: str = "stream") -> PhysNode:
    """Annotate a (logically optimized) plan with per-column placement,
    pass counts, costs, and the model's impl label.  ``role="build"`` is
    the build side of a join (replicated to every engine); everything
    else streams."""
    rows = estimate_rows(node, stats)

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
        pl, cost, alts = _choose(model, n_bytes, STREAM_PLACEMENTS)
        return PhysNode("scan", node, model.impl, pl, 1, rows, cost,
                        model.bandwidth_gbps(pl), alts, n_bytes=n_bytes)

    if isinstance(node, (L.Filter, L.FilterProject)):
        child = plan_physical(node.child, stats, model, role=role)
        in_rows = estimate_rows(node.child, stats)
        n_out_cols = len(node.columns) if isinstance(node, L.FilterProject) \
            else 1
        n_bytes = in_rows * BYTES_PER_VALUE + rows * BYTES_PER_VALUE \
            * n_out_cols
        placements = ("replicated",) if role == "build" \
            else STREAM_PLACEMENTS
        pl, cost, alts = _choose(model, n_bytes, placements)
        op = "filter_project" if isinstance(node, L.FilterProject) \
            else "filter"
        return PhysNode(op, node, model.impl, pl, 1, rows, cost,
                        model.bandwidth_gbps(pl), alts, (child,),
                        n_bytes=n_bytes)

    if isinstance(node, L.Join):
        left = plan_physical(node.left, stats, model, role="stream")
        right = plan_physical(node.right, stats, model, role="build")
        build_rows = estimate_rows(node.right, stats)
        probe_rows = estimate_rows(node.left, stats)
        n_passes = max(-(-int(build_rows) // HT_CAPACITY), 1)
        unique = key_is_unique(node.right, node.on, stats)
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
            chain = expected_chain_length(node.right, node.on, stats)
            sort_bytes = build_rows * BYTES_PER_VALUE * max(
                math.log2(max(build_rows, 2.0)), 1.0)
            n_bytes = (probe_rows * BYTES_PER_VALUE * max(chain, 1.0)
                       + (2 * rows * BYTES_PER_VALUE + sort_bytes)
                       / n_passes)
            op = "join_multi"
        # the probe runs wherever the probe stream already lives
        probe_pl = left.placement if left.placement != "replicated" \
            else STREAM_PLACEMENTS[0]
        pl, cost, alts = _choose(model, n_bytes, (probe_pl,),
                                 n_passes=n_passes)
        return PhysNode(op, node, model.impl, pl, n_passes, rows, cost,
                        model.bandwidth_gbps(pl), alts, (left, right),
                        n_bytes=n_bytes)

    if isinstance(node, L.Project):
        child = plan_physical(node.child, stats, model, role=role)
        n_bytes = rows * BYTES_PER_VALUE * len(node.columns)
        pl, cost, alts = _choose(model, n_bytes, STREAM_PLACEMENTS[:1])
        return PhysNode("project", node, model.impl, pl, 1, rows, cost,
                        model.bandwidth_gbps(pl), alts, (child,),
                        n_bytes=n_bytes)

    if isinstance(node, L.Aggregate):
        child = plan_physical(node.child, stats, model, role=role)
        n_bytes = estimate_rows(node.child, stats) * BYTES_PER_VALUE
        pl, cost, alts = _choose(model, n_bytes, STREAM_PLACEMENTS[:1])
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
        best = min(alts, key=alts.get)
        pl = best.split("/")[1]
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
                        n_bytes=epoch_bytes)

    if isinstance(node, L.ScoreGLM):
        child = plan_physical(node.child, stats, model, role=role)
        d = len(node.features)
        in_rows = estimate_rows(node.child, stats)
        # one pass over the feature columns plus the written score column
        n_bytes = in_rows * BYTES_PER_VALUE * d + rows * BYTES_PER_VALUE
        pl, cost, alts = _choose(model, n_bytes, STREAM_PLACEMENTS[:1],
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
