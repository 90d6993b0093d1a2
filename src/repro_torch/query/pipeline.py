"""Morsel-driven streaming pipelines — the paper's §V lesson end to end.

The eager executor materializes whole-column intermediates between
operators (BAT algebra).  This module compiles an aggregate-rooted
physical plan into a *pipeline*: the probe spine (scan -> filters -> join
probes -> aggregate) becomes one per-morsel step function with a small
carry, and the plan's pipeline breakers — join builds, the final
aggregate — are the only points where state wider than a morsel exists.
The driver streams partition-granular morsels (``MorselSpec``) and copies
host-resident morsels to the card from pinned memory on a side stream,
so the next morsel's copy overlaps the current morsel's compute.

Layout of a step's arguments::

    step(lits, carry, n_valid, *build_flat, *morsel_cols) -> carry

``build_flat`` is the deterministic flattening of every breaker's
``engine.JoinBuild``; ``morsel_cols`` are the base scan's columns for one
morsel, padded to ``rows`` with rows ``>= n_valid`` masked out.  Join
probes binary-search the sorted-bucket build (the counts kernel on the
card): per-row match counts multiply into a running
weight and build-column aggregates read bucket prefix sums, so the
streamed pair multiset matches the eager pair-list operator exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.columnar import engine
from repro_torch.kernels.join import join as join_kernels
from repro_torch.query import logical as L
from repro_torch.query.cost import TableStats, key_is_unique


@dataclasses.dataclass(frozen=True)
class BreakerSpec:
    """One pipeline breaker: a join build consumed whole before the probe
    stream starts.  ``value_cols`` are the build columns the plan reads
    above the join (sorted for a deterministic flat layout)."""
    table: str
    on: str
    value_cols: Tuple[str, ...]
    unique: bool

    @property
    def n_arrays(self) -> int:
        return 2 + len(self.value_cols)


@dataclasses.dataclass
class StreamPlan:
    """Analysis product: the probe spine's stream source and breakers."""
    node: L.Aggregate
    base_scan: L.Scan
    stream_cols: Tuple[str, ...]
    breakers: Tuple[BreakerSpec, ...]


def _analyze_spine(node: L.Node, stats: Dict[str, TableStats]):
    """Probe-spine analysis: Scan -> (Filter|FilterProject|Project)* with
    Joins whose build side is a Scan.  Returns (base_scan, breakers,
    dup_contributed, refs_above) or None when the shape does not stream."""
    table_columns = {t: s.columns for t, s in stats.items()}
    breakers = []
    dup_contributed = set()
    refs_above: list = []               # filter/join-key columns, root-down
    base_scan: list = [None]
    ok = [True]

    def visit(n: L.Node):
        if not ok[0]:
            return
        if isinstance(n, L.Scan):
            base_scan[0] = n
            return
        if isinstance(n, (L.Filter, L.FilterProject)):
            refs_above.append(n.column)
            visit(n.child)
            return
        if isinstance(n, L.Project):
            visit(n.child)
            return
        if isinstance(n, L.Join):
            if not isinstance(n.right, L.Scan) or \
                    n.right.table not in stats:
                ok[0] = False
                return
            refs_above.append(n.on)
            visit(n.left)               # post-order: breakers in eval order
            if not ok[0]:
                return
            lcols = set(L.output_columns(n.left, table_columns))
            rcols = L.output_columns(n.right, table_columns)
            contributed = tuple(sorted(c for c in rcols
                                       if c not in lcols and c != n.on))
            unique = key_is_unique(n.right, n.on, stats)
            if not unique:
                dup_contributed.update(contributed)
            breakers.append(BreakerSpec(n.right.table, n.on, contributed,
                                        unique))
            return
        ok[0] = False

    visit(node)
    if not ok[0] or base_scan[0] is None or base_scan[0].table not in stats:
        return None
    return base_scan[0], tuple(breakers), dup_contributed, refs_above


def analyze(node: L.Node, stats: Dict[str, TableStats]
            ) -> Optional[StreamPlan]:
    """Whether a plan lowers onto a morsel pipeline, and its shape if so.

    Streamable plans are aggregate-rooted probe spines.  Duplicate-keyed
    build sides are fine (bucket-weighted aggregation) as long as their
    non-key columns are only read by the final aggregate."""
    if not isinstance(node, L.Aggregate):
        return None
    spine = _analyze_spine(node.child, stats)
    if spine is None:
        return None
    scan, breakers, dup_contributed, refs_above = spine
    if dup_contributed & set(refs_above):
        return None
    stream_cols = scan.columns if scan.columns is not None \
        else tuple(stats[scan.table].columns)
    return StreamPlan(node, scan, tuple(stream_cols), breakers)


@dataclasses.dataclass
class TrainStreamPlan:
    """A TrainGLM-rooted pipeline: every epoch streams the training set
    morsel by morsel with the K model weight vectors as the carry
    (``engine.train_glm_stream`` — CoCoA block rotation with block =
    morsel).  ``filtered`` plans materialize the selected rows once (a
    pipeline breaker: streaming compaction would make the minibatch
    boundaries data-dependent) and stream the epochs over the
    materialized set; bare scans stream straight off the catalog table."""
    node: L.TrainGLM
    base_scan: L.Scan
    stream_cols: Tuple[str, ...]      # features + label on the base table
    filtered: bool


def analyze_train(node: L.Node, stats: Dict[str, TableStats]
                  ) -> Optional[TrainStreamPlan]:
    """Whether a TrainGLM-rooted plan lowers onto the epoch x morsel
    stream: Scan -> (Filter|FilterProject|Project)* with no joins (a
    joined training-set derivation takes the eager path)."""
    if not isinstance(node, L.TrainGLM):
        return None
    spine = _analyze_spine(node.child, stats)
    if spine is None:
        return None
    scan, breakers, _dup, _refs = spine
    if breakers:
        return None
    cols = tuple(node.features) + (node.label,)
    avail = set(scan.columns) if scan.columns is not None \
        else set(stats[scan.table].columns)
    if not set(cols) <= avail:
        return None
    filtered = any(isinstance(n, (L.Filter, L.FilterProject))
                   for n in L.walk(node.child))
    return TrainStreamPlan(node, scan, cols, filtered)


@dataclasses.dataclass
class CompiledPipeline:
    """One plan shape lowered to a per-morsel step at one granularity."""
    base_table: str
    stream_cols: Tuple[str, ...]
    breakers: Tuple[BreakerSpec, ...]
    rows: int
    step: Callable
    init_carry: Callable[[], object]
    finalize: Callable[[object], object]


def compile_pipeline(splan: StreamPlan, rows: int, agg_dtype: torch.dtype,
                     device: torch.device) -> CompiledPipeline:
    """Lower a streamable plan into one per-morsel step.

    Join probes go through the counts kernel on the card, whose ragged
    tail is masked, so every morsel size takes it (the TPU version needed
    ``rows % 4096 == 0`` and otherwise fell back to a plain probe that
    gives the same (start, count)).

    Integer aggregates accumulate in int64 (the reference's int32 under
    JAX's default 32-bit mode, equal until int32 would overflow); float
    sums and the mean keep the reference's float32 partial sums, which are
    exact for integer inputs below 2**24."""
    node = splan.node
    breakers = splan.breakers
    agg_is_float = agg_dtype.is_floating_point
    acc = torch.float32 if agg_is_float else torch.int64

    def zeros(dtype):
        return torch.zeros((), dtype=dtype, device=device)

    if node.op == "sum":
        init = lambda: zeros(acc)                          # noqa: E731
        fin = (lambda c: float(c)) if agg_is_float else (lambda c: int(c))
    elif node.op == "count":
        init = lambda: zeros(torch.int64)                  # noqa: E731
        fin = lambda c: int(c)                             # noqa: E731
    elif node.op == "mean":
        init = lambda: (zeros(torch.float32),              # noqa: E731
                        zeros(torch.float32))
        fin = lambda c: float(c[0] / c[1].clamp(min=1.0))  # noqa: E731
    else:
        raise ValueError(node.op)

    n_build = sum(b.n_arrays for b in breakers)
    offsets = [sum(b.n_arrays for b in breakers[:i])
               for i in range(len(breakers))]

    def step(lits, carry, n_valid, *arrays):
        build_flat = arrays[:n_build]
        morsel = arrays[n_build:]
        n_loc = morsel[0].shape[0]
        valid = torch.arange(n_loc, device=device) < n_valid
        lit_pos = [0]
        breaker_pos = [0]

        def next_lit():
            v = lits[lit_pos[0]]
            lit_pos[0] += 1
            return v

        def eval_node(n):
            """-> (cols, mask, weight, buckets): per-row values, the live-
            row mask, the multi-match multiplicity product (None = all
            ones), and bucket-sum pairs for duplicate-build columns."""
            if isinstance(n, L.Scan):
                return dict(zip(splan.stream_cols, morsel)), valid, None, {}
            if isinstance(n, (L.Filter, L.FilterProject)):
                cols, mask, weight, buckets = eval_node(n.child)
                lo, hi = next_lit(), next_lit()
                mask = engine.select_range_morsel(cols[n.column], lo, hi,
                                                  mask)
                if isinstance(n, L.FilterProject):
                    cols = {k: cols[k] for k in n.columns if k in cols}
                return cols, mask, weight, buckets
            if isinstance(n, L.Project):
                cols, mask, weight, buckets = eval_node(n.child)
                return ({k: cols[k] for k in n.columns if k in cols},
                        mask, weight, buckets)
            if isinstance(n, L.Join):
                cols, mask, weight, buckets = eval_node(n.left)
                i = breaker_pos[0]
                breaker_pos[0] += 1
                b, off = breakers[i], offsets[i]
                s_sorted, order = build_flat[off], build_flat[off + 1]
                vals = dict(zip(b.value_cols,
                                build_flat[off + 2:off + 2
                                           + len(b.value_cols)]))
                keys = cols[n.on]
                start, cnt = join_kernels.probe_counts(s_sorted, keys)
                mask = mask & (cnt > 0)
                if b.unique:
                    # clip like the reference's gather: unmatched rows
                    # read some build row and are masked out
                    safe = start.clamp(0, max(s_sorted.shape[0] - 1, 0))
                    for c in b.value_cols:
                        cols[c] = vals[c][order[safe]] \
                            if s_sorted.shape[0] else torch.zeros_like(keys)
                else:
                    weight = cnt if weight is None else weight * cnt
                    for c in b.value_cols:
                        buckets[c] = (engine.bucket_sums(vals[c], start,
                                                         cnt), cnt)
                return cols, mask, weight, buckets
            raise TypeError(n)

        cols, mask, weight, buckets = eval_node(node.child)
        w_live = mask.to(torch.int64) if weight is None \
            else torch.where(mask, weight, 0).to(torch.int64)
        if node.op == "count":
            return carry + w_live.sum()
        dtype = carry[0].dtype if node.op == "mean" else carry.dtype
        if node.column in cols:
            contrib = cols[node.column].to(dtype) * w_live.to(dtype)
        else:
            bsum, cnt = buckets[node.column]
            others = w_live // cnt.clamp(min=1)
            contrib = bsum.to(dtype) * others.to(dtype)
        if node.op == "sum":
            return carry + contrib.sum()
        s, c = carry
        return s + contrib.sum(), c + w_live.to(c.dtype).sum()

    return CompiledPipeline(splan.base_scan.table, splan.stream_cols,
                            breakers, rows, step, init, fin)


def _stage(arrays, device: torch.device, copy_stream):
    """Morsel columns onto the device: tensors pass through, host numpy
    slices copy from pinned memory with ``non_blocking=True`` on the side
    stream (on a CPU device they are wrapped without a copy)."""
    out = []
    for a in arrays:
        if isinstance(a, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(a))
            if copy_stream is not None:
                with torch.cuda.stream(copy_stream):
                    t = t.pin_memory().to(device, non_blocking=True)
            a = t.to(device)
        out.append(a)
    return out


def drive(cp: CompiledPipeline, n_morsels: int, get_morsel, build_flat,
          lits, device: torch.device, carry=None):
    """Run the morsel loop, double-buffered: morsel ``i+1`` is fetched (and
    its host columns' copies enqueued on a side stream) before morsel
    ``i`` is stepped, so those copies overlap the step's kernels.  The
    compute stream waits for a morsel's copies before using it."""
    carry = cp.init_carry() if carry is None else carry
    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" \
        else None

    def fetch(i):
        arrays, n_valid = get_morsel(i)
        return _stage(arrays, device, copy_stream), n_valid

    nxt = fetch(0)
    for i in range(n_morsels):
        cur, n_valid = nxt
        if copy_stream is not None:
            compute = torch.cuda.current_stream(device)
            compute.wait_stream(copy_stream)
            for t in cur:
                t.record_stream(compute)
        if i + 1 < n_morsels:
            nxt = fetch(i + 1)
        carry = cp.step(lits, carry, n_valid, *build_flat, *cur)
    return carry
