"""Rule-based logical optimizer — the MonetDB optimizer role (paper §III).

Rewrites, in order:
  1. predicate pushdown below joins (filter the side that owns the column
     before probing — the single biggest data-movement saving),
  2. projection pruning (scan only the columns the plan ever touches; a
     column store reads per-column, so pruning is pure bandwidth),
  3. build/probe side selection by estimated cardinality (the small side
     builds the hash table; fewer multi-pass rescans of Fig. 8b),
  4. selection->gather fusion (Filter+Project -> one FilterProject op).

Each rule is a pure Node -> Node rewrite; ``optimize`` composes them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.query import logical as L
from repro_torch.query.cost import (
    TableStats, estimate_rows, join_orientation_cost,
)


def _table_columns(stats: Dict[str, TableStats]) -> Dict[str, tuple]:
    return {t: s.columns for t, s in stats.items()}


def _rewrite_children(node: L.Node, fn) -> L.Node:
    updates = {f.name: fn(getattr(node, f.name))
               for f in dataclasses.fields(node)
               if isinstance(getattr(node, f.name), L.Node)}
    return dataclasses.replace(node, **updates) if updates else node


# --------------------------------------------------------------------------- #
# rule 1: predicate pushdown

def push_down_filters(node: L.Node, stats: Dict[str, TableStats]) -> L.Node:
    cols = _table_columns(stats)

    def push(n: L.Node) -> L.Node:
        n = _rewrite_children(n, push)
        if isinstance(n, L.Filter) and isinstance(n.child, L.Join):
            join = n.child
            in_left = n.column in L.output_columns(join.left, cols)
            in_right = n.column in L.output_columns(join.right, cols)
            if in_left and not in_right:
                return dataclasses.replace(
                    join, left=push(L.Filter(join.left, n.column, n.lo,
                                             n.hi)))
            if in_right and not in_left:
                return dataclasses.replace(
                    join, right=push(L.Filter(join.right, n.column, n.lo,
                                              n.hi)))
        return n

    return push(node)


# --------------------------------------------------------------------------- #
# rule 2: projection pruning

def prune_columns(node: L.Node, stats: Dict[str, TableStats],
                  required: Optional[Set[str]] = None) -> L.Node:
    """Narrow every Scan to the columns the plan above it actually reads."""
    cols = _table_columns(stats)

    if isinstance(node, L.Scan):
        avail = cols[node.table]
        if required is None:
            return node
        keep = tuple(c for c in avail if c in required)
        return L.Scan(node.table, keep)
    if isinstance(node, L.Aggregate):
        return dataclasses.replace(
            node, child=prune_columns(node.child, stats, {node.column}))
    if isinstance(node, (L.Project, L.FilterProject)):
        need = set(node.columns)
        if isinstance(node, L.FilterProject):
            need.add(node.column)
        return dataclasses.replace(
            node, child=prune_columns(node.child, stats, need))
    if isinstance(node, L.Filter):
        need = None if required is None else set(required) | {node.column}
        return dataclasses.replace(
            node, child=prune_columns(node.child, stats, need))
    if isinstance(node, L.Join):
        if required is None:
            lneed = rneed = None
        else:
            lcols = set(L.output_columns(node.left, cols))
            rcols = set(L.output_columns(node.right, cols))
            lneed = (set(required) & lcols) | {node.on}
            rneed = (set(required) & rcols) | {node.on}
        return dataclasses.replace(
            node, left=prune_columns(node.left, stats, lneed),
            right=prune_columns(node.right, stats, rneed))
    if isinstance(node, L.TrainGLM):
        need = set(node.features) | {node.label}
        return dataclasses.replace(
            node, child=prune_columns(node.child, stats, need))
    if isinstance(node, L.ScoreGLM):
        # the scored rows need only the feature columns; the (optional)
        # defining train plan prunes as its own root
        out = dataclasses.replace(
            node, child=prune_columns(node.child, stats,
                                      set(node.features)))
        if node.train is not None:
            out = dataclasses.replace(
                out, train=prune_columns(node.train, stats))
        return out
    return _rewrite_children(node, lambda c: prune_columns(c, stats,
                                                           required))


# --------------------------------------------------------------------------- #
# rule 3: build side selection

def choose_build_side(node: L.Node, stats: Dict[str, TableStats],
                      model=None) -> L.Node:
    """Pick each join's build side.  Without a cost model, the smaller
    estimated side builds (fewer HT_CAPACITY passes, smaller replication
    broadcast).  With one, both orientations are priced end to end —
    build sort/hash bytes, broadcast, chain-length-scaled probe stream,
    multi-pass rescans — so a provably-unique (fusable) build side is not
    swapped away for a marginally smaller duplicate-keyed one whose
    multi-match probe would cost more than it saves.  Duplicate-keyed
    build sides remain legal either way — the multi-match sorted-bucket
    kernel emits the exact pair multiset; uniqueness only selects the
    physical fast path downstream."""
    cols = _table_columns(stats)

    def visit(n: L.Node) -> L.Node:
        n = _rewrite_children(n, visit)
        if not isinstance(n, L.Join):
            return n
        # the join's column merge is left-wins: when both sides carry a
        # same-named non-key column, swapping sides changes which values
        # survive — orientation is semantic, not just physical, so the
        # optimizer must keep it
        lcols = set(L.output_columns(n.left, cols))
        rcols = set(L.output_columns(n.right, cols))
        if (lcols - {n.on}) & (rcols - {n.on}):
            return n
        swapped = L.Join(n.right, n.left, n.on)
        if model is None:
            return swapped if estimate_rows(n.left, stats) \
                < estimate_rows(n.right, stats) else n
        return swapped if join_orientation_cost(swapped, stats, model) \
            < join_orientation_cost(n, stats, model) else n

    return visit(node)


# --------------------------------------------------------------------------- #
# rule 4: selection -> gather fusion

def fuse_filter_project(node: L.Node) -> L.Node:
    def visit(n: L.Node) -> L.Node:
        n = _rewrite_children(n, visit)
        if isinstance(n, L.Project) and isinstance(n.child, L.Filter):
            f = n.child
            return L.FilterProject(f.child, f.column, f.lo, f.hi, n.columns)
        return n

    return visit(node)


def optimize(node: L.Node, stats: Dict[str, TableStats],
             model=None) -> L.Node:
    node = push_down_filters(node, stats)
    node = choose_build_side(node, stats, model)
    node = prune_columns(node, stats)
    node = fuse_filter_project(node)
    return node


# --------------------------------------------------------------------------- #
# rule 5 (batch-level): common-subplan extraction
#
# Across a batch of concurrent queries, repeated subtrees (a shared
# selection feeding different aggregates, one join build probed by many
# plans) are the units the semantic cache should hold with certainty
# rather than speculation.  Nodes are frozen dataclasses, so a subtree IS
# its own structural key; canonicalization folds filter-chain
# permutations into one representative before counting.

def common_subplans(nodes: Sequence[L.Node],
                    min_count: int = 2) -> Dict[L.Node, int]:
    """Subtrees occurring ``min_count``+ times across (already optimized)
    plans, keyed by the canonical subtree.  Scan leaves are excluded —
    column placements already dedup them — as are the roots themselves
    (result-level caching owns whole plans)."""
    counts: Dict[L.Node, int] = {}
    roots = {L.canonicalize(n) for n in nodes}
    for root in nodes:
        for sub in L.walk(L.canonicalize(root)):
            if isinstance(sub, L.Scan):
                continue
            counts[sub] = counts.get(sub, 0) + 1
    return {n: c for n, c in counts.items()
            if c >= min_count and n not in roots}


def optimize_batch(nodes: Sequence[L.Node], stats: Dict[str, TableStats],
                   model=None) -> Tuple[List[L.Node], Dict[L.Node, int]]:
    """Optimize every plan of a batch, then extract the subtrees they
    share — the serving front-end hints these to the semantic cache so
    the first executor to materialize one admits it unconditionally."""
    opt = [optimize(n, stats, model) for n in nodes]
    return opt, common_subplans(opt)
