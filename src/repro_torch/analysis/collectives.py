"""Collective traffic of a dry-run step, the counterpart of the
reference's ``analysis/hlo.py``.  Torch has no compiled HLO to parse:
``launch.dryrun`` records each functional collective
(``torch.ops._c10d_functional``) that DTensor inserts, as a
``CollectiveRecord`` of its kind, result bytes on one rank and group
size.  ``collective_stats`` sums their operand sizes (the roofline's
collective term) and a ring-model "wire bytes" estimate per kind, with
the reference's model:

    all-gather      operand = result / g     wire ~ result * (g-1)/g
    all-reduce      operand = result         wire ~ 2 * result * (g-1)/g
    reduce-scatter  operand = result * g     wire ~ operand * (g-1)/g
    all-to-all      operand = result         wire ~ operand * (g-1)/g
    collective-permute operand = result      wire = operand

``op_histogram`` counts the aten ops of a step, most frequent first.
"""
from __future__ import annotations

import dataclasses
from collections import Counter, defaultdict
from typing import Iterable

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

# torch.ops._c10d_functional op name -> the reference's (HLO) kind
FUNCTIONAL_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    kind: str               # one of KINDS
    result_bytes: int       # the result on one rank
    group_size: int


@dataclasses.dataclass
class CollectiveStats:
    operand_bytes: dict          # per op kind, per device
    wire_bytes: dict             # ring-model estimate, per device
    counts: dict

    @property
    def total_operand_bytes(self) -> float:
        return float(sum(self.operand_bytes.values()))

    @property
    def total_wire_bytes(self) -> float:
        return float(sum(self.wire_bytes.values()))


def ring_model(kind: str, result_bytes: float, g: int) -> tuple:
    """(operand bytes, wire bytes) of one collective on one rank."""
    rb, g = float(result_bytes), max(int(g), 1)
    if kind == "all-gather":
        return rb / g, rb * (g - 1) / g
    if kind == "all-reduce":
        return rb, 2.0 * rb * (g - 1) / g
    if kind == "reduce-scatter":
        op = rb * g
        return op, op * (g - 1) / g
    if kind == "all-to-all":
        return rb, rb * (g - 1) / g
    if kind == "collective-permute":
        return rb, rb
    raise ValueError(f"unknown collective kind {kind!r}")


def collective_stats(records: Iterable[CollectiveRecord]) -> CollectiveStats:
    operand: dict = defaultdict(float)
    wire: dict = defaultdict(float)
    counts: dict = defaultdict(int)
    for r in records:
        op_b, w_b = ring_model(r.kind, r.result_bytes, r.group_size)
        operand[r.kind] += op_b
        wire[r.kind] += w_b
        counts[r.kind] += 1
    return CollectiveStats(dict(operand), dict(wire), dict(counts))


def op_histogram(ops: Iterable[str], top: int = 25) -> list[tuple[str, int]]:
    """Count the step's ops (names such as ``aten.mm``), most frequent
    first (ties in order of first appearance); the ``top`` of them."""
    return Counter(ops).most_common(top)
