"""Morsel-driven streaming pipelines — the paper's §V lesson end to end.

The eager executor materializes whole-column intermediates between
operators (BAT algebra).  This module compiles an aggregate-rooted
physical plan into a *pipeline*: the probe spine (scan -> filters -> join
probes -> aggregate) becomes one per-morsel step function with a small
carry, and the plan's pipeline breakers — join builds, the final
aggregate — are the only points where state wider than a morsel exists.
The morsel loop streams partition-granular slices (``MorselSpec``); a
background thread fetches host- and disk-resident morsels and copies them
to the card from pinned memory on a side stream, so the next morsel's
transfer overlaps the current morsel's compute.  Project-rooted plans
compile to a per-morsel step that yields a compacted output chunk.

Under a shard layout (``shard=`` with ``rows`` a multiple of the shard
count) a step evaluates the spine on each shard's contiguous slice of the
morsel, one after another on the card, with the validity window offset
into the morsel's rows and the builds shared: an aggregate step reduces
each shard's partial in the carry's dtype and adds the partials in shard
order (the reference's ``psum``), a project step concatenates the shards'
(mask, cols) blocks in shard order.  Integer carries stay bit-identical to
the unsharded fold; a float sum is summed in another order.  Other row
counts take the unsharded step, as in the reference.

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

import contextlib
import dataclasses
import queue
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.columnar import engine
from repro_torch.distributed.sharding import ShardLayout
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
class ProjectStreamPlan:
    """A Project-rooted probe spine: the streamed form materializes one
    compacted output chunk per morsel instead of folding a carry.  Only
    unique-keyed build sides qualify — a multi-match join multiplies
    rows, which a per-row output mask cannot express."""
    node: L.Node                         # Project | FilterProject root
    base_scan: L.Scan
    stream_cols: Tuple[str, ...]
    breakers: Tuple[BreakerSpec, ...]
    out_cols: Tuple[str, ...]


def analyze_project(node: L.Node, stats: Dict[str, TableStats]
                    ) -> Optional[ProjectStreamPlan]:
    """Whether a Project-rooted plan lowers onto a morsel pipeline whose
    per-morsel product is a compacted chunk of the output table."""
    if not isinstance(node, (L.Project, L.FilterProject)):
        return None
    spine = _analyze_spine(node, stats)
    if spine is None:
        return None
    scan, breakers, _dup, _refs = spine
    if any(not b.unique for b in breakers):
        return None
    stream_cols = scan.columns if scan.columns is not None \
        else tuple(stats[scan.table].columns)
    return ProjectStreamPlan(node, scan, tuple(stream_cols), breakers,
                             tuple(node.columns))


@dataclasses.dataclass
class TrainStreamPlan:
    """A TrainGLM-rooted pipeline: every epoch streams the training set
    morsel by morsel with the K model weight vectors as the carry
    (``engine.train_glm_stream`` — CoCoA block rotation with block =
    morsel).  ``filtered`` plans materialize the selected rows once (a
    pipeline breaker: streaming compaction would make the minibatch
    boundaries data-dependent) and stream the epochs over the
    materialized set; bare scans stream straight off the catalog table,
    tier-aware: host and disk columns are staged per morsel, which is what
    lets an over-budget training set train under a spill plan."""
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
    """One plan shape lowered to a per-morsel step at one granularity.

    ``group_step(lits, carry, n_valid, *build_flat, *morsel_cols)`` runs
    G queries of this shape over one morsel at once: ``lits`` is a
    ``[G, n_lits]`` integer tensor and ``carry`` a ``[G]`` tensor (for
    ``mean``, a pair of them).  Only the row masks depend on the
    literals, so the spine (column values, join keys, each join's probe)
    is evaluated once and the filters broadcast into ``[G, rows]`` masks;
    each lane's carry equals what ``step`` folds for that query alone,
    bit for bit."""
    base_table: str
    stream_cols: Tuple[str, ...]
    breakers: Tuple[BreakerSpec, ...]
    rows: int
    step: Callable
    group_step: Callable
    init_carry: Callable[[], object]
    finalize: Callable[[object], object]
    device: torch.device
    shard: Optional[ShardLayout] = None   # set when the step is sharded

    @property
    def n_build_arrays(self) -> int:
        return sum(b.n_arrays for b in self.breakers)


def _n_slices(rows: int, shard: Optional[ShardLayout]) -> int:
    """How many shard slices a step of ``rows`` rows evaluates: the
    layout's count when it divides ``rows``, else 1 (unsharded)."""
    if shard is not None and shard.n_shards > 1 \
            and rows % shard.n_shards == 0:
        return shard.n_shards
    return 1


def _shard_slices(morsel, n_valid, n_sh: int, device: torch.device):
    """Each shard's contiguous slice of the morsel columns and its
    validity mask (rows below ``n_valid`` in morsel coordinates), in
    shard order."""
    n_loc = morsel[0].shape[0] // n_sh
    for k in range(n_sh):
        off = k * n_loc
        cols = morsel if n_sh == 1 \
            else tuple(a[off:off + n_loc] for a in morsel)
        yield cols, off + torch.arange(n_loc, device=device) < n_valid


def _eval_spine(root: L.Node, stream_cols, morsel, valid, lits,
                breakers, build_flat):
    """Evaluate a probe spine over one morsel.  Returns (cols, mask,
    weight, buckets): per-row values, the live-row mask, the multi-match
    multiplicity product (None = all ones), and bucket-sum pairs for
    duplicate-build columns.  Literals and breakers are consumed in
    evaluation order (post-order down the probe side).  ``lits`` is a
    sequence of Python ints, or a ``[G, n_lits]`` tensor for a group of
    queries, whose masks are then ``[G, rows]`` while everything else
    stays per row.

    Join probes go through the counts kernel on the card, whose ragged
    tail is masked, so every morsel size takes it (the TPU version needed
    ``rows % 4096 == 0`` and otherwise fell back to a plain probe that
    gives the same (start, count))."""
    grouped = isinstance(lits, torch.Tensor)
    lit_it = iter(lits.unbind(1) if grouped else lits)
    offsets = [sum(b.n_arrays for b in breakers[:i])
               for i in range(len(breakers))]
    breaker_pos = [0]

    def eval_node(n):
        if isinstance(n, L.Scan):
            return dict(zip(stream_cols, morsel)), valid, None, {}
        if isinstance(n, (L.Filter, L.FilterProject)):
            cols, mask, weight, buckets = eval_node(n.child)
            lo, hi = next(lit_it), next(lit_it)
            if grouped:
                mask = mask & engine.in_ranges(cols[n.column], lo[:, None],
                                               hi[:, None])
            else:
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
                            build_flat[off + 2:off + 2 + len(b.value_cols)]))
            keys = cols[n.on]
            start, cnt = join_kernels.probe_counts(s_sorted, keys)
            mask = mask & (cnt > 0)
            if b.unique:
                # clip like the reference's gather: unmatched rows read
                # some build row and are masked out
                safe = start.clamp(0, max(s_sorted.shape[0] - 1, 0))
                for c in b.value_cols:
                    cols[c] = vals[c][order[safe]] \
                        if s_sorted.shape[0] else torch.zeros_like(keys)
            else:
                weight = cnt if weight is None else weight * cnt
                for c in b.value_cols:
                    buckets[c] = (engine.bucket_sums(vals[c], start, cnt),
                                  cnt)
            return cols, mask, weight, buckets
        raise TypeError(n)

    cols, mask, weight, buckets = eval_node(root)
    if grouped and mask.dim() == 1:         # a spine with no filter
        mask = mask.expand(lits.shape[0], -1)
    return cols, mask, weight, buckets


def _lane_sums(x: torch.Tensor) -> torch.Tensor:
    """Per-lane sums of a ``[G, rows]`` tensor.  Integer sums are exact
    in any order; a float lane is summed alone, as ``step`` sums one
    query's morsel, so the group's carries equal the lone member's bit
    for bit."""
    if not x.dtype.is_floating_point:
        return x.sum(dim=1)
    return torch.stack([lane.sum() for lane in x])


def compile_pipeline(splan: StreamPlan, rows: int, agg_dtype: torch.dtype,
                     device: torch.device,
                     shard: Optional[ShardLayout] = None
                     ) -> CompiledPipeline:
    """Lower a streamable plan into one per-morsel step (sharded over
    ``shard`` when its count divides ``rows``).

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
    n_sh = _n_slices(rows, shard)

    def partial(lits, morsel, valid, build_flat, dtype, total):
        """One slice's carry increment, reduced in the carry's dtype."""
        cols, mask, weight, buckets = _eval_spine(
            node.child, splan.stream_cols, morsel, valid, lits, breakers,
            build_flat)
        w_live = mask.to(torch.int64) if weight is None \
            else torch.where(mask, weight, 0).to(torch.int64)
        if node.op == "count":
            return total(w_live)
        if node.column in cols:
            contrib = cols[node.column].to(dtype) * w_live.to(dtype)
        else:
            bsum, cnt = buckets[node.column]
            others = w_live // cnt.clamp(min=1)
            contrib = bsum.to(dtype) * others.to(dtype)
        if node.op == "sum":
            return total(contrib)
        return total(contrib), total(w_live.to(dtype))

    def fold(lits, carry, n_valid, arrays, total):
        dtype = carry[0].dtype if node.op == "mean" else carry.dtype
        parts = [partial(lits, morsel, valid, arrays[:n_build], dtype, total)
                 for morsel, valid in _shard_slices(arrays[n_build:],
                                                    n_valid, n_sh, device)]
        inc = parts[0]
        for p in parts[1:]:                 # the shards' sum, in order
            inc = (inc[0] + p[0], inc[1] + p[1]) if node.op == "mean" \
                else inc + p
        if node.op == "mean":
            return carry[0] + inc[0], carry[1] + inc[1]
        return carry + inc

    def step(lits, carry, n_valid, *arrays):
        return fold(lits, carry, n_valid, arrays, torch.sum)

    def group_step(lits, carry, n_valid, *arrays):
        return fold(lits, carry, n_valid, arrays, _lane_sums)

    return CompiledPipeline(splan.base_scan.table, splan.stream_cols,
                            breakers, rows, step, group_step, init, fin,
                            device, shard if n_sh > 1 else None)


@dataclasses.dataclass
class CompiledProject:
    """A Project-rooted plan lowered to a per-morsel step producing
    (mask, out_cols) at one granularity."""
    base_table: str
    stream_cols: Tuple[str, ...]
    breakers: Tuple[BreakerSpec, ...]
    rows: int
    out_cols: Tuple[str, ...]
    step: Callable
    shard: Optional[ShardLayout] = None   # set when the step is sharded

    @property
    def n_build_arrays(self) -> int:
        return sum(b.n_arrays for b in self.breakers)


def compile_project_pipeline(pplan: ProjectStreamPlan, rows: int,
                             device: torch.device,
                             shard: Optional[ShardLayout] = None
                             ) -> CompiledProject:
    """Lower a Project-rooted streamable plan into one per-morsel step,
    ``step(lits, n_valid, *build_flat, *morsel_cols) -> (mask, cols)``,
    with the aggregate pipeline's argument layout and literal order, for
    morsels of ``rows`` rows.  Under ``shard`` (dividing ``rows``) the
    shards' (mask, cols) blocks concatenate in shard order, back into the
    morsel's row order."""
    n_build = sum(b.n_arrays for b in pplan.breakers)
    n_sh = _n_slices(rows, shard)

    def step(lits, n_valid, *arrays):
        masks, outs = [], []
        for morsel, valid in _shard_slices(arrays[n_build:], n_valid, n_sh,
                                           device):
            cols, mask, _, _ = _eval_spine(
                pplan.node, pplan.stream_cols, morsel, valid, lits,
                pplan.breakers, arrays[:n_build])
            masks.append(mask)
            outs.append(tuple(cols[c] for c in pplan.out_cols))
        if n_sh == 1:
            return masks[0], outs[0]
        return torch.cat(masks), tuple(torch.cat(blocks)
                                       for blocks in zip(*outs))

    return CompiledProject(pplan.base_scan.table, pplan.stream_cols,
                           pplan.breakers, rows, pplan.out_cols, step,
                           shard if n_sh > 1 else None)


def _stage(arrays, device: torch.device, copy_stream):
    """Morsel columns onto the device: tensors pass through, host numpy
    slices (a disk column's slice is its read) are copied into a freshly
    pinned buffer and sent with ``non_blocking=True`` on the side stream
    (on a CPU device they are wrapped, copied only when read-only)."""
    out = []
    for a in arrays:
        if isinstance(a, np.ndarray):
            if copy_stream is not None:
                dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
                pinned = torch.empty(a.shape, dtype=dtype, pin_memory=True)
                pinned.numpy()[...] = a
                with torch.cuda.stream(copy_stream):
                    a = pinned.to(device, non_blocking=True)
            else:
                a = torch.from_numpy(
                    np.require(a, requirements=("C", "W"))).to(device)
        out.append(a)
    return out


def staged_morsels(n_morsels: int, get_morsel, device: torch.device, *,
                   prefetch: bool = True, on_staged=None):
    """Yield ``(arrays, n_valid)`` for morsels ``0 .. n_morsels - 1`` in
    order, each on ``device`` and ready for the current stream.

    With ``prefetch`` a background thread fetches and stages morsels
    ahead of the consumer through a queue of two: the host slicing (and
    a disk column's read), the pinned copy and the enqueued host -> device
    copy of morsel ``i + 1`` run while the consumer launches morsel
    ``i``'s kernels.  Without it the loop is single-threaded and double-
    buffered.  Both hand over the same morsels in the same order, so
    results are bit-identical.  Close the generator (``contextlib.
    closing``) to stop the thread when the consumer fails: it stops and
    is joined, and no staged buffer outlives the generator.

    ``on_staged(arrays, n_valid, seconds)``, when given, observes each
    fetch: the arrays ``get_morsel`` returned and the seconds from the
    call to the copies' completion, fenced on the copy stream's own
    event (never the device, which would stall the compute stream from
    the prefetch thread)."""
    on_card = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if on_card else None
    card = (device.index if device.index is not None
            else torch.cuda.current_device()) if on_card else None

    def fetch(i):
        t0 = time.perf_counter() if on_staged is not None else 0.0
        arrays, n_valid = get_morsel(i)
        staged = _stage(arrays, device, copy_stream)
        ready = None
        if copy_stream is not None:
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        if on_staged is not None:
            if ready is not None:
                ready.synchronize()
            on_staged(arrays, n_valid, time.perf_counter() - t0)
        return staged, n_valid, ready

    def hand_over(item):
        arrays, n_valid, ready = item
        if ready is not None:
            compute = torch.cuda.current_stream(device)
            compute.wait_event(ready)
            for t in arrays:
                t.record_stream(compute)
        return arrays, n_valid

    if not (prefetch and n_morsels > 1):
        nxt = fetch(0)
        for i in range(n_morsels):
            cur = nxt
            if i + 1 < n_morsels:
                nxt = fetch(i + 1)
            yield hand_over(cur)
        return

    buf: queue.Queue = queue.Queue(maxsize=2)
    failure: list = []
    stop = threading.Event()

    def put(item) -> bool:
        # a bounded wait, so a consumer that stopped can always release
        # the thread through ``stop``
        while not stop.is_set():
            try:
                buf.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def stage():
        try:
            if on_card:
                torch.cuda.set_device(card)
            for i in range(n_morsels):
                if not put(fetch(i)):
                    return
        except BaseException as e:            # noqa: BLE001 - re-raised
            failure.append(e)                 # by the consumer below
            put(None)

    thread = threading.Thread(target=stage, name="morsel-prefetch",
                              daemon=True)
    thread.start()
    try:
        for _ in range(n_morsels):
            item = buf.get()
            if item is None:
                break
            yield hand_over(item)
    finally:
        stop.set()
        thread.join()
    if failure:
        raise failure[0]


def _account_morsel(telemetry, metrics, i: int, t0: float, t1: float,
                    step_s: float, path: str) -> None:
    """One morsel's split: transfer wait (t0..t1, blocked on staging) and
    the step (``step_s`` long from t1).  With perfect overlap the wait
    term collapses toward zero."""
    if metrics is not None:
        metrics.inc("pipeline.morsels")
        metrics.inc("pipeline.transfer_wait_s", t1 - t0)
        metrics.inc("pipeline.compute_s", step_s)
        metrics.observe("pipeline.morsel_wait_s", t1 - t0)
        metrics.observe("pipeline.morsel_step_s", step_s)
    if telemetry is not None:
        telemetry.complete("pipeline.morsel_wait", t0, t1 - t0,
                           morsel=i, path=path)
        telemetry.complete("pipeline.morsel_step", t1, step_s,
                           morsel=i, path=path)


def drive(cp: CompiledPipeline, n_morsels: int, get_morsel, build_flat,
          lits, device: torch.device, carry=None, *,
          prefetch: bool = True, telemetry=None, metrics=None,
          on_staged=None):
    """Fold every morsel into the carry, in order, with the transfer of
    the next morsel overlapping the current one's kernels
    (``staged_morsels``, which ``on_staged`` is passed to).

    An enabled ``telemetry`` (with ``metrics``) records each morsel's
    transfer wait on the host clock and its step: on the card the step is
    timed by CUDA events on the compute stream, read once the last one
    has completed, since a host clock around the step sees only the
    launches.  Otherwise the loop is the uninstrumented one."""
    carry = cp.init_carry() if carry is None else carry
    morsels = staged_morsels(n_morsels, get_morsel, device,
                             prefetch=prefetch, on_staged=on_staged)
    if telemetry is None or not telemetry.enabled:
        with contextlib.closing(morsels):
            for arrays, n_valid in morsels:
                carry = cp.step(lits, carry, n_valid, *build_flat, *arrays)
        return carry
    path = "prefetch" if prefetch and n_morsels > 1 else "double_buffer"
    on_card = device.type == "cuda"
    stamps = []
    with contextlib.closing(morsels):
        t0 = time.perf_counter()
        for i, (arrays, n_valid) in enumerate(morsels):
            t1 = time.perf_counter()
            if on_card:
                step = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                step[0].record()
            carry = cp.step(lits, carry, n_valid, *build_flat, *arrays)
            if on_card:
                step[1].record()
            t2 = time.perf_counter()
            stamps.append((i, t0, t1, step if on_card else t2 - t1))
            t0 = t2
    if on_card and stamps:
        stamps[-1][3][1].synchronize()
    for i, t0, t1, step in stamps:
        step_s = step[0].elapsed_time(step[1]) / 1e3 if on_card else step
        _account_morsel(telemetry, metrics, i, t0, t1, step_s, path)
    return carry
