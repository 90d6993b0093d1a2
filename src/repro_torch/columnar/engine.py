"""Physical operators over the column store, backed by the accelerated cores.

This is the integration layer the paper builds into MonetDB: operators take
and return Tables; the FPGA roles are played by the card's kernels
(core.selection / core.join).  The kernel wrappers launch on CUDA tensors
and take their plain versions on CPU ones, so the device decides.  The
streaming forms at the end are partition-granular: state that outlives one
morsel is explicit.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.columnar.table import Column, MorselSpec, Table
from repro_torch.core import join as join_core
from repro_torch.core import selection as sel_core
from repro_torch.core import sgd_glm
from repro_torch.core.channels import ChannelPlan
from repro_torch.kernels.join import join as join_kernels
from repro_torch.kernels.join import ref as join_ref
from repro_torch.kernels.selection import ref as sel_ref
from repro_torch.kernels.sgd import ref as sgd_ref
from repro_torch.kernels.sgd.sgd import sgd


def compact_positions(valid: torch.Tensor, n: int) -> torch.Tensor:
    """Positions of the first ``n`` True entries, ascending, as int32
    (zero-filled if there are fewer — the reference's static-size
    nonzero)."""
    pos = torch.nonzero(valid).flatten()[:n].to(torch.int32)
    if pos.shape[0] < n:
        pos = torch.cat([pos, pos.new_zeros(n - pos.shape[0])])
    return pos


def in_range(col: torch.Tensor, lo, hi) -> torch.Tensor:
    """Row mask of lo <= col <= hi, with the bounds normalized the way the
    selection kernel takes them (``sel_ref.column_bounds``: int32-clamped
    for an integer column, rounded to float32 for a float32 one)."""
    lo, hi = sel_ref.column_bounds(col.dtype, lo, hi)
    return (col >= lo) & (col <= hi)


def in_ranges(col: torch.Tensor, lo: torch.Tensor,
              hi: torch.Tensor) -> torch.Tensor:
    """Row masks of G ranges at once: ``lo`` and ``hi`` are ``[G, 1]``
    integer tensors, the result ``[G, rows]``.  Integer bounds are
    normalized per range exactly as ``in_range`` normalizes a pair
    (clamped into int32, an empty or out-of-domain range made (1, 0));
    a float column compares in its own type, as a Python bound does."""
    if col.dtype.is_floating_point:
        lo, hi = lo.to(col.dtype), hi.to(col.dtype)
    else:
        empty = (lo > hi) | (lo > sel_ref.I32_MAX) | (hi < sel_ref.I32_MIN)
        lo = torch.where(empty, 1, lo.clamp(min=sel_ref.I32_MIN))
        hi = torch.where(empty, 0, hi.clamp(max=sel_ref.I32_MAX))
    return (col >= lo) & (col <= hi)


def scan(table: Table, columns: Sequence[str]) -> Table:
    return Table(table.name, {c: table.columns[c] for c in columns},
                 table.plan)


def select_range(table: Table, column: str, lo: int, hi: int, *,
                 block: int = 1024) -> Table:
    """Range selection -> materialized index column.

    The selection kernel masks ragged blocks, so every row count takes the
    kernel path; the TPU version halved ``block`` until the shard tiled
    and skipped the kernel otherwise.  A multi-engine plan that is not
    partitioned (or does not split evenly) selects the whole column as
    one engine: its congested mode is the Fig. 5 throughput baseline, a
    correct selection only at one engine.  Both give the same index
    list."""
    if table.plan is None:
        raise ValueError("place() the table first")
    n_eng = table.plan.n_engines
    plan = table.plan
    if n_eng > 1 and (plan.placement != "partitioned"
                      or table.num_rows % n_eng != 0):
        plan = ChannelPlan("partitioned", 1, plan.device)
    idx, counts = sel_core.select_distributed(
        table.column(column), lo, hi, plan, block=block)
    n = int(counts.sum())
    compacted = idx[compact_positions(idx >= 0, n)]
    return Table(f"{table.name}.sel", {"idx": Column(compacted, "idx")})


def join(left: Table, right: Table, on: str, *,
         unique: Optional[bool] = None) -> Table:
    """Inner join: right is the (build) side.  Returns the full multiset of
    matched index pairs (l_idx, r_idx).  Duplicate build keys emit one
    pair per match (the sorted-bucket multi-match join); ``unique=True``
    keeps the paper's open-addressing fast path (identical pairs when the
    keys really are unique)."""
    if left.plan is None:
        raise ValueError("place() the probe table first")
    n_build = right.num_rows
    if n_build > join_core.HT_CAPACITY:
        passes = -(-n_build // join_core.HT_CAPACITY)
        warnings.warn(
            f"join build side '{right.name}' has {n_build} rows > "
            f"HT_CAPACITY={join_core.HT_CAPACITY}: multi-pass join will "
            f"rescan the probe side {passes}x (Fig. 8b linear regime)",
            RuntimeWarning, stacklevel=2)
    if unique:
        l_keys = _pad_probe(left.column(on), left.plan.n_engines)
        s_idx, total = join_core.join_distributed(
            right.column(on), l_keys, left.plan)
        l_idx = compact_positions(s_idx >= 0, int(total))
        r_idx = s_idx[l_idx]
    else:
        l_idx, r_idx = _join_pairs(right.column(on), left.column(on),
                                   left.plan)
    return Table("join", {"l_idx": Column(l_idx, "l_idx"),
                          "r_idx": Column(r_idx, "r_idx")})


def _pad_probe(l_keys: torch.Tensor, n_engines: int) -> torch.Tensor:
    """Pad the probe side to a multiple of the engine count with -1, which
    matches nothing (build keys are validated non-negative and the pass
    pads are <= -(2**30))."""
    rem = (-int(l_keys.shape[0])) % max(int(n_engines), 1)
    if rem:
        l_keys = torch.cat([l_keys, l_keys.new_full((rem,), -1)])
    return l_keys


def _check_key_domain(s_keys: torch.Tensor, l_keys: torch.Tensor) -> None:
    # the multi-pass join reserves the negative range for its pass-padding
    # sentinels: reject negative keys instead of silently corrupting pairs.
    # (The reference also reserves 2**31 - 1, its Pallas table pad; the
    # counts kernel's padding is virtual, so every non-negative key joins.)
    for name, keys in (("build", s_keys), ("probe", l_keys)):
        if keys.shape[0] and int(keys.min()) < 0:
            raise ValueError(
                f"join {name} keys must be non-negative: negative values "
                "collide with the pass-padding sentinels")


def _join_pairs(s_keys: torch.Tensor, l_keys: torch.Tensor,
                plan: ChannelPlan):
    """Compacted (l_idx, s_idx) pair columns from the multi-match join.
    The per-engine totals are exact even when a pair list overflows, so one
    retry with the measured capacity always suffices."""
    _check_key_domain(s_keys, l_keys)
    l_keys = _pad_probe(l_keys, plan.n_engines)
    l_buf, s_buf, totals, overflow = join_core.join_distributed_multi(
        s_keys, l_keys, plan)
    if bool(overflow.any()):
        need = int(totals.max())
        l_buf, s_buf, totals, overflow = join_core.join_distributed_multi(
            s_keys, l_keys, plan,
            max_out_per_shard=max(need, 64))
        if bool(overflow.any()):
            raise RuntimeError("multi-match join overflowed after resizing")
    pos = compact_positions(l_buf >= 0, int(totals.sum()))
    return l_buf[pos], s_buf[pos]


def join_shuffle(left: Table, right: Table, on: str, layout) -> Table:
    """Inner join by shuffle repartitioning (the planner's costed
    alternative to sharing the build side): both sides hash-partition by
    key across ``layout``'s shards, and each shard joins its buckets.
    The pairs are bit-identical to ``join``'s: the raw emission is shard-
    major, and a final stable sort by probe row restores the one-engine
    (probe row, bucket position) order, since all matches of a probe row
    live on one shard and the stable partition and stable build sort keep
    equal-key matches in ascending build order.  Shuffle-bucket or pair-
    list overflows retry with the exact measured capacities, so the result
    is always complete."""
    s_keys, l_keys = right.column(on), left.column(on)
    _check_key_domain(s_keys, l_keys)
    kw = {}
    for _ in range(3):
        l_buf, s_buf, totals, pair_over, (s_counts, l_counts, shuf_over) = \
            join_core.join_shuffle_multi(s_keys, l_keys, layout, **kw)
        if not (bool(shuf_over) or bool(pair_over.any())):
            break
        # the counts and totals are exact even on overflow: one sizing
        # pass each for the buckets and the pair lists always converges
        l_cap = max(int(l_counts.max()), 8)
        kw = dict(s_cap=max(int(s_counts.max()), 8), l_cap=l_cap,
                  max_out_per_shard=max(int(totals.max()), 2 * l_cap, 64))
    else:
        raise RuntimeError("join_shuffle did not converge on capacity")
    pos = compact_positions(l_buf >= 0, int(totals.sum()))
    l_sel, s_sel = l_buf[pos], s_buf[pos]
    order = torch.argsort(l_sel, stable=True)
    return Table("join", {"l_idx": Column(l_sel[order], "l_idx"),
                          "r_idx": Column(s_sel[order], "r_idx")})


def gather(table: Table, idx: torch.Tensor, columns: Sequence[str],
           name: str = "proj") -> Table:
    return Table(name, {c: Column(table.column(c)[idx], c)
                        for c in columns})


def aggregate_sum(table: Table, column: str):
    """Sum of a column: an exact int (int64 accumulation) for integer
    columns, a float otherwise."""
    col = table.column(column)
    if col.dtype.is_floating_point:
        return float(col.sum())
    return int(col.sum(dtype=torch.int64))


def train_glm(table: Table, features: Sequence[str], label: str, grid,
              plan: ChannelPlan, *, kind: str = "logreg", epochs: int = 5):
    """In-database ML (paper §VI): hyper-parameter search over GLMs on
    columns of a table — the doppioDB-style UDF.  Returns (xs (K, n),
    losses (K,))."""
    a = torch.stack([table.column(f).to(torch.float32) for f in features],
                    dim=1)
    b = table.column(label).to(torch.float32)
    return sgd_glm.hyperparam_search(a, b, grid, plan, kind=kind,
                                     epochs=epochs)


# --------------------------------------------------------------------------- #
# streaming (morsel-driven) operators

@dataclasses.dataclass
class JoinBuild:
    """Sorted-bucket build state.  ``s_sorted``/``order`` are the layout of
    ``kernels/join/ref.bucket_build``; probe morsels binary-search their
    bucket.  ``values`` holds raw build columns for unique-key gathers,
    ``csums`` exclusive prefix sums over the key-sorted column for exact
    duplicate-bucket sums."""
    on: str
    unique: bool
    s_sorted: torch.Tensor
    order: torch.Tensor
    values: Dict[str, torch.Tensor]
    csums: Dict[str, torch.Tensor]

    def flat(self) -> Tuple[torch.Tensor, ...]:
        """Deterministic flattening (the pipeline's breaker layout)."""
        return (self.s_sorted, self.order,
                *(self.values[c] for c in sorted(self.values)),
                *(self.csums[c] for c in sorted(self.csums)))


def join_build(right: Table, on: str, value_cols: Sequence[str] = (), *,
               unique: bool = False,
               plan: Optional[ChannelPlan] = None) -> JoinBuild:
    """Pipeline breaker: consume the whole build side once, producing the
    state probe morsels stream against.  With ``plan``, every array moves
    to the plan's device.  Prefix sums of integer columns are int64 (the
    reference's are int32 under JAX's default 32-bit mode; equal wherever
    that does not overflow)."""
    keys = right.column(on)
    s_sorted, order = join_ref.bucket_build(keys)
    values: Dict[str, torch.Tensor] = {}
    csums: Dict[str, torch.Tensor] = {}
    for c in value_cols:
        col = right.column(c)
        if unique:
            values[c] = col
        else:
            sc = col[order]
            acc = sc.dtype if sc.dtype.is_floating_point else torch.int64
            csums[c] = torch.cat([torch.zeros(1, dtype=acc,
                                              device=sc.device),
                                  torch.cumsum(sc, 0, dtype=acc)])
    if plan is not None:
        s_sorted, order = plan.place(s_sorted), plan.place(order)
        values = {k: plan.place(v) for k, v in values.items()}
        csums = {k: plan.place(v) for k, v in csums.items()}
    return JoinBuild(on, unique, s_sorted, order, values, csums)


def join_probe_morsel(build: JoinBuild, keys: torch.Tensor):
    """(start, count) of each key's bucket in the sorted build side,
    through the counts kernel on the card."""
    return join_kernels.probe_counts(build.s_sorted, keys)


def bucket_sums(csum: torch.Tensor, start: torch.Tensor,
                count: torch.Tensor) -> torch.Tensor:
    """Sum of a build column over each probe row's bucket, via the
    exclusive prefix sums a JoinBuild carries."""
    s = start.to(torch.int64)
    return csum[s + count] - csum[s]


def select_range_morsel(col: torch.Tensor, lo, hi,
                        mask: torch.Tensor) -> torch.Tensor:
    """Streaming range selection: narrow the morsel's row mask — no index
    materialization between pipeline stages."""
    return mask & in_range(col, lo, hi)


def aggregate_sum_stream(carry: torch.Tensor, values: torch.Tensor,
                         mask: torch.Tensor,
                         weight: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Fold one morsel into a running sum (in the carry's dtype).
    ``weight`` is the per-row match multiplicity of duplicate-keyed joins
    upstream."""
    w = mask if weight is None else torch.where(mask, weight, 0)
    return carry + (values.to(carry.dtype) * w.to(carry.dtype)).sum()


def train_glm_stream(table: Table, features: Sequence[str], label: str,
                     grid, plan: ChannelPlan, *, kind: str = "logreg",
                     epochs: int = 5, minibatch: int = 16,
                     morsel_rows: Optional[int] = None, on_morsel=None):
    """Morsel-streamed hyper-parameter search: each epoch streams the
    morsels in table order with the K models' weights as the carry, one
    SGD launch per morsel (``epochs=1``), so the minibatch update
    sequence — and, the kernel being deterministic, the trained weights —
    equal ``train_glm``'s bit for bit when morsels align with minibatches
    (CoCoA-style block rotation with block = morsel).

    Non-dividing row counts zero-pad ONLY the final morsel up to the next
    minibatch multiple (never to a full morsel: a pure-pad minibatch
    would still apply the l2 shrinkage step and perturb the weights).
    Zero feature rows contribute exactly zero to the gradient numerator,
    so the streamed minibatch sequence equals the eager path's
    ``sgd_glm.pad_to_minibatch`` sequence on any row count; losses mask
    the pad rows and divide by the true row count.

    Morsels come from ``Table.morsel``, so host- and disk-tier columns
    stream too: each morsel's slice is staged onto the plan's device.
    ``on_morsel(n_bytes, seconds, tier)`` observes each morsel's fetch
    once per tier its columns live on: the valid rows' bytes from that
    tier and its share (by bytes) of the fetch's seconds, fenced on the
    device's current stream before and after."""
    m = table.num_rows
    if morsel_rows is None:
        morsel_rows = m
    morsel_rows = max((min(morsel_rows, m) // minibatch) * minibatch,
                      minibatch)
    spec = MorselSpec(m, morsel_rows)
    cols = tuple(features) + (label,)
    # the device the morsels land on: the plan's, else the label column's
    # (the card for a host- or disk-tier column)
    dev = plan.place(table.morsel(spec, 0, (label,))[0][label]).device
    hp = torch.tensor([[g.lr for g in grid], [g.l2 for g in grid]],
                      dtype=torch.float32, device=dev)
    lrs, l2s = hp[0], hp[1]
    xs = hp.new_zeros((len(grid), len(features)))

    def fence():
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()

    def morsel_arrays(i):
        if on_morsel is not None:
            fence()
            t0 = time.perf_counter()
        data, n_valid = table.morsel(spec, i, cols)
        # Table.morsel pads the ragged tail to spec.rows; keep only up to
        # the next minibatch multiple past the valid rows
        rows_pad = -(-n_valid // minibatch) * minibatch
        a = torch.stack([plan.place(data[f][:rows_pad]).to(torch.float32)
                         for f in features], dim=1)
        b = plan.place(data[label][:rows_pad]).to(torch.float32)
        if on_morsel is not None:
            fence()
            seconds = time.perf_counter() - t0
            moved: Dict[str, int] = {}
            for c in cols:
                tier = table.column_tier(c)
                moved[tier] = moved.get(tier, 0) \
                    + int(data[c][:n_valid].nbytes)
            total = sum(moved.values()) or 1
            for tier, n in moved.items():
                on_morsel(n, seconds * n / total, tier)
        return a, b, n_valid

    for _ in range(epochs):
        for i in range(spec.n_morsels):
            a_m, b_m, _ = morsel_arrays(i)
            xs = sgd(a_m, b_m, xs, lrs, l2s, minibatch=minibatch, epochs=1,
                     kind=kind)
    acc = hp.new_zeros((len(grid),))
    for i in range(spec.n_morsels):
        a_m, b_m, n_valid = morsel_arrays(i)
        acc = acc + sgd_ref.loss_terms(a_m[:n_valid], b_m[:n_valid], xs,
                                       kind).sum(dim=0)
    losses = acc / m + l2s * torch.square(xs).sum(dim=1)
    return xs, losses
