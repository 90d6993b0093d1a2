"""Logical plan IR — the role MonetDB's relational algebra plays in the
paper's integration story (§II/III).

A query is an immutable tree of frozen dataclass nodes; the fluent ``Q``
DSL turns hand-written operator sequences into declarative plans.  Nodes are
hashable, so a node IS its own dedup key (structural equality); the
``signature``/``literals`` pair splits a plan into a pipeline-cache key
(structure + masked constants) and the constant vector that is fed to the
cached pipeline at run time.

Pure Python, no tensors: the port's copy of ``repro.query.logical``, so
plans and fingerprints are byte-identical between the two systems.
``HyperParams`` lives in ``core/sgd_glm.py``, as in the reference, and is
re-exported here for the plan DSL.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Mapping, Optional, Sequence, Tuple

from repro_torch.core.sgd_glm import HyperParams  # noqa: F401 (re-export)


@dataclasses.dataclass(frozen=True)
class Node:
    """Base logical operator."""

    def children(self) -> Tuple["Node", ...]:
        return tuple(v for f in dataclasses.fields(self)
                     for v in [getattr(self, f.name)] if isinstance(v, Node))


@dataclasses.dataclass(frozen=True)
class Scan(Node):
    table: str
    columns: Optional[Tuple[str, ...]] = None     # None = every column


@dataclasses.dataclass(frozen=True)
class Filter(Node):
    child: Node
    column: str
    lo: int
    hi: int


@dataclasses.dataclass(frozen=True)
class Join(Node):
    """Inner equi-join; ``right`` is the build side after optimization."""
    left: Node
    right: Node
    on: str


@dataclasses.dataclass(frozen=True)
class Project(Node):
    child: Node
    columns: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class FilterProject(Node):
    """Fusion product of Filter+Project: one selection->gather physical op
    (no intermediate index table materialized twice)."""
    child: Node
    column: str
    lo: int
    hi: int
    columns: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class Aggregate(Node):
    child: Node
    op: str                                       # sum | count | mean
    column: str


@dataclasses.dataclass(frozen=True)
class TrainGLM(Node):
    """In-database ML (paper §VI) as a plan node — the doppioDB UDF."""
    child: Node
    features: Tuple[str, ...]
    label: str
    grid: Tuple[HyperParams, ...]
    kind: str = "logreg"
    epochs: int = 5


@dataclasses.dataclass(frozen=True)
class ScoreGLM(Node):
    """Model serving (paper §VI): evaluate a trained GLM over fresh rows.

    ``train`` names the model by its defining plan — the executor
    resolves it to cached weights through the model fingerprint, which
    embeds the training tables' versions, so any mutation makes the
    cached model unreachable and forces a fresh train.  ``model_fp``
    instead pins a raw fingerprint (lookup-only: scoring fails if no
    such model is cached).  ``select`` picks the grid entry whose
    weights score; negative selects the best model by final loss."""
    child: Node
    features: Tuple[str, ...]
    train: Optional[TrainGLM] = None
    model_fp: str = ""
    select: int = -1
    kind: str = "logreg"


class Q:
    """Fluent plan DSL: ``Q.scan("lineitem").filter("qty", 30, 49)...``"""

    def __init__(self, node: Node):
        self.node = node

    @staticmethod
    def scan(table: str, columns: Optional[Sequence[str]] = None) -> "Q":
        return Q(Scan(table, tuple(columns) if columns is not None else None))

    def filter(self, column: str, lo: int, hi: int) -> "Q":
        return Q(Filter(self.node, column, int(lo), int(hi)))

    def join(self, other: "Q | Node", on: str) -> "Q":
        rhs = other.node if isinstance(other, Q) else other
        return Q(Join(self.node, rhs, on))

    def project(self, *columns: str) -> "Q":
        return Q(Project(self.node, tuple(columns)))

    def aggregate(self, op: str, column: str) -> "Q":
        return Q(Aggregate(self.node, op, column))

    def sum(self, column: str) -> "Q":
        return self.aggregate("sum", column)

    def count(self, column: str) -> "Q":
        return self.aggregate("count", column)

    def mean(self, column: str) -> "Q":
        return self.aggregate("mean", column)

    def train_glm(self, features: Sequence[str], label: str,
                  grid: Sequence[HyperParams], *, kind: str = "logreg",
                  epochs: int = 5) -> "Q":
        return Q(TrainGLM(self.node, tuple(features), label, tuple(grid),
                          kind, epochs))

    def score_glm(self, model, features: Optional[Sequence[str]] = None,
                  *, select: int = -1, kind: Optional[str] = None) -> "Q":
        """Evaluate a trained GLM over this plan's rows.  ``model`` is
        either a TrainGLM plan (or a ``Q`` wrapping one) — scored with
        its cached weights, retrained on a cache miss — or a raw model
        fingerprint string (lookup-only).  ``select`` picks the grid
        entry; negative = best by final training loss."""
        if isinstance(model, Q):
            model = model.node
        if isinstance(model, TrainGLM):
            feats = tuple(features) if features is not None \
                else model.features
            return Q(ScoreGLM(self.node, feats, model, "", int(select),
                              kind if kind is not None else model.kind))
        if features is None:
            raise ValueError(
                "score_glm with a raw fingerprint needs explicit features")
        return Q(ScoreGLM(self.node, tuple(features), None, str(model),
                          int(select), kind if kind is not None
                          else "logreg"))

    # the dashboard spelling: Q.scan(...).score(model_fp, features)
    score = score_glm


# --------------------------------------------------------------------------- #
# plan keys

_LITERAL_FIELDS = {"lo", "hi"}      # masked out of the compile-cache key


def signature(node: Node):
    """Structural key with predicate constants masked: two queries that
    differ only in range bounds share one compiled executable."""
    parts = [type(node).__name__]
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, Node):
            parts.append(signature(v))
        elif f.name in _LITERAL_FIELDS:
            parts.append("?")
        else:
            parts.append(v)
    return tuple(parts)


def literals(node: Node) -> Tuple[int, ...]:
    """The masked constants, pre-order — the traced args of the compiled
    plan (same order as ``signature`` masks them)."""
    out = []
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, Node):
            out.extend(literals(v))
        elif f.name in _LITERAL_FIELDS:
            out.append(int(v))
    return tuple(out)


def walk(node: Node):
    yield node
    for c in node.children():
        yield from walk(c)


def output_columns(node: Node, table_columns) -> Tuple[str, ...]:
    """Columns a node produces.  ``table_columns``: table name -> tuple."""
    if isinstance(node, Scan):
        return node.columns if node.columns is not None \
            else tuple(table_columns[node.table])
    if isinstance(node, (Project, FilterProject)):
        return node.columns
    if isinstance(node, Filter):
        return output_columns(node.child, table_columns)
    if isinstance(node, Join):
        l = output_columns(node.left, table_columns)
        r = output_columns(node.right, table_columns)
        return l + tuple(c for c in r if c not in l)
    if isinstance(node, Aggregate):
        return (node.column,)
    if isinstance(node, TrainGLM):
        return node.features + (node.label,)
    if isinstance(node, ScoreGLM):
        return ("score",)
    raise TypeError(node)


# --------------------------------------------------------------------------- #
# semantic fingerprints (the result/subplan cache key)
#
# ``signature``/``literals`` above split a plan for the COMPILE cache
# (constants masked — different range bounds share one executable).  The
# fingerprint below is the RESULT-cache key: constants are part of the
# identity, structure is canonicalized so semantically equal plans
# collide on purpose, and every referenced table's version is folded in
# so a mutation makes every dependent fingerprint unreachable.

def canonicalize(node: Node) -> Node:
    """Semantics-preserving normal form.  Adjacent range filters commute,
    so a Filter chain is merged per column (range intersection) and
    re-emitted in sorted column order; two queries that spell the same
    conjunction differently share one canonical tree.  The rewrite is
    only used for fingerprinting — execution keeps the optimizer's tree,
    whose literal order must match ``literals``."""
    node = _rewrite_canon_children(node)
    if isinstance(node, Filter):
        chain = []
        n = node
        while isinstance(n, Filter):
            chain.append(n)
            n = n.child
        bounds: dict = {}
        for f in chain:                       # intersect per column
            lo, hi = bounds.get(f.column, (f.lo, f.hi))
            bounds[f.column] = (max(lo, f.lo), min(hi, f.hi))
        out = n
        for col in sorted(bounds, reverse=True):   # outermost = smallest
            lo, hi = bounds[col]
            out = Filter(out, col, lo, hi)
        return out
    return node


def _rewrite_canon_children(node: Node) -> Node:
    updates = {f.name: canonicalize(getattr(node, f.name))
               for f in dataclasses.fields(node)
               if isinstance(getattr(node, f.name), Node)}
    return dataclasses.replace(node, **updates) if updates else node


def _known_cols(node: Node):
    """Output column set when provable from the tree alone (no catalog):
    None means unknown (a Scan with an implicit column list).  Used to
    gate join-side commutation — the join's column merge is left-wins,
    so side order is load-bearing whenever non-key names overlap."""
    if isinstance(node, Scan):
        return set(node.columns) if node.columns is not None else None
    if isinstance(node, Filter):
        return _known_cols(node.child)
    if isinstance(node, (Project, FilterProject)):
        return set(node.columns)
    if isinstance(node, Join):
        l, r = _known_cols(node.left), _known_cols(node.right)
        return l | r if l is not None and r is not None else None
    if isinstance(node, Aggregate):
        return {node.column}
    if isinstance(node, TrainGLM):
        return set(node.features) | {node.label}
    if isinstance(node, ScoreGLM):
        return {"score"}
    return None


def _join_commutes(node: Join) -> bool:
    """Sides commute only when both output column sets are provable and
    their non-key columns are disjoint: with an overlap, the merged
    output takes the LEFT side's column, so Join(a, b) and Join(b, a)
    aggregate different values and must not share a fingerprint."""
    l, r = _known_cols(node.left), _known_cols(node.right)
    if l is None or r is None:
        return False
    return not ((l - {node.on}) & (r - {node.on}))


def _canonical_key(node: Node, order_insensitive: bool):
    """Nested-tuple identity of a canonical plan.  Under an order-
    insensitive root (a commutative Aggregate), inner-join sides sort by
    key when commutation is provably safe (disjoint non-key columns) —
    Join(a, b) and Join(b, a) then feed the aggregate the same value
    multiset.  Row-producing roots (Project, TrainGLM's SGD sequence)
    stay order-sensitive: a swapped join changes their output."""
    attrs = [type(node).__name__]
    child_keys = []
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, Node):
            child_keys.append(_canonical_key(v, order_insensitive))
        else:
            attrs.append((f.name, repr(v)))
    if order_insensitive and isinstance(node, Join) \
            and _join_commutes(node):
        child_keys.sort()
    return (tuple(attrs), tuple(child_keys))


def tables_of(node: Node) -> Tuple[str, ...]:
    """Base tables a plan reads, sorted — the fingerprint's dependency
    set (and the invalidation sweep's index)."""
    return tuple(sorted({n.table for n in walk(node)
                         if isinstance(n, Scan)}))


def fingerprint(node: Node,
                versions: Optional[Mapping[str, int]] = None, *,
                order_sensitive: Optional[bool] = None,
                layout: Optional[tuple] = None) -> str:
    """Stable semantic hash of a plan against specific table versions.

    Equal fingerprints mean equal results: filter-chain permutations
    collide, join sides commute only under a commutative Aggregate root
    (pass ``order_sensitive=True`` to force exact structure — the
    subplan-cache key for materialized intermediates, whose row order
    matters).  Any referenced table's version bump changes the hash, so
    stale cache entries are unreachable rather than merely flagged.

    ``layout`` is the executor's shard-layout key (``ShardLayout.key()``):
    folded into the hash ONLY when given, so a 1-device executor (which
    passes None) produces byte-for-byte the fingerprints it always did,
    while an 8-device plan can never alias a 1-device plan's cache
    entries."""
    if order_sensitive is None:
        order_sensitive = not isinstance(node, Aggregate)
    key = _canonical_key(canonicalize(node), not order_sensitive)
    deps = tuple((t, int(versions.get(t, 0)) if versions else 0)
                 for t in tables_of(node))
    payload = (key, deps) if layout is None else (key, deps, layout)
    return hashlib.sha256(repr(payload).encode()).hexdigest()[:20]


# --------------------------------------------------------------------------- #
# predicate subsumption (interval extraction + the family key)
#
# A range selection's cost is the bytes it streams (the paper's central
# bandwidth-arbitrage point), so a narrower predicate can be served by
# refining an already-materialized SUPERSET bitmap — a 1-bit-per-
# surviving-row stream instead of the 32-bit base column.  The helpers
# below split a plan into the refinable interval and everything else:
# ``selection_interval`` extracts the innermost base-table range
# predicate, and ``subsumption_key`` is the version-keyed family key all
# range variants of one plan share (unlike ``fingerprint``, which embeds
# the bounds and therefore only ever matches exactly).

@dataclasses.dataclass(frozen=True)
class SelectionInterval:
    """One base-table range predicate lifted out of a plan.

    ``lo``/``hi`` are CLOSED bounds (``lo <= col <= hi``, matching
    ``Filter``); ``lo > hi`` denotes the empty interval.  ``residual``
    is the plan with this predicate removed — what still has to run on
    top of a cached superset bitmap after refinement."""
    table: str
    column: str
    lo: int
    hi: int
    residual: Node

    def contains(self, lo: int, hi: int) -> bool:
        """Closed-interval superset test: every row satisfying
        ``[lo, hi]`` also satisfies this interval.  An empty request
        (``lo > hi``) is contained in anything."""
        return lo > hi or (self.lo <= lo and self.hi >= hi)


def selection_interval(node: Node) -> Optional[SelectionInterval]:
    """Extract the innermost range predicate sitting directly on a base
    Scan (probe side first for joins), plus the residual plan with that
    predicate removed.  Returns None when no Filter/FilterProject wraps
    a Scan — there is nothing a cached superset bitmap could serve."""
    found: list = []

    def rebuild(n: Node) -> Node:
        if not found and isinstance(n, Filter) \
                and isinstance(n.child, Scan):
            found.append((n.child.table, n.column, int(n.lo), int(n.hi)))
            return n.child
        if not found and isinstance(n, FilterProject) \
                and isinstance(n.child, Scan):
            found.append((n.child.table, n.column, int(n.lo), int(n.hi)))
            return Project(n.child, n.columns)
        updates = {}
        for f in dataclasses.fields(n):
            v = getattr(n, f.name)
            if isinstance(v, Node) and not found:
                updates[f.name] = rebuild(v)
        return dataclasses.replace(n, **updates) if updates else n

    residual = rebuild(node)
    if not found:
        return None
    table, column, lo, hi = found[0]
    return SelectionInterval(table, column, lo, hi, residual)


def subsumption_key(node: Node,
                    versions: Optional[Mapping[str, int]] = None
                    ) -> Optional[tuple]:
    """Version-keyed FAMILY key for predicate subsumption, distinct from
    the exact fingerprint: every range variant of one selection plan —
    same structure, same predicate table/column, any ``(lo, hi)`` —
    shares this key.  The ``(table, column, version)`` triple this key
    leads with IS the semantic cache's interval-index bucket key
    (``SemanticCache.lookup_superset``) — the cache deliberately buckets
    by the triple alone so bitmaps are shared across plans with
    different residuals (a selection bitmap does not depend on what
    runs above it); the residual fingerprint here distinguishes whole
    PLAN families for callers that need plan-level identity (tests,
    observability).  Returns None when the plan has no extractable
    interval."""
    si = selection_interval(canonicalize(node))
    if si is None:
        return None
    version = int(versions.get(si.table, 0)) if versions else 0
    return ("subsume", si.table, si.column, version,
            fingerprint(si.residual, versions, order_sensitive=True))


def pformat(node: Node, indent: int = 0, note=None) -> str:
    """Readable plan tree (EXPLAIN-style)."""
    pad = "  " * indent
    label = type(node).__name__
    attrs = []
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if not isinstance(v, Node) and f.name != "grid":
            attrs.append(f"{f.name}={v}")
    extra = f"  [{note(node)}]" if note and note(node) else ""
    lines = [f"{pad}{label}({', '.join(attrs)}){extra}"]
    for c in node.children():
        lines.append(pformat(c, indent + 1, note))
    return "\n".join(lines)
