"""Query-layer shard layouts (device = HBM pseudo-channel, Figs. 5-7).

The query stack stripes row streams across ``n_shards`` shards, each
playing one pseudo-channel of the paper's channel-count sweep.  One H100
is one device, so a shard is a contiguous slice of each sharded column on
the executor's card and the shards run one after another; a layout names
the slicing, not a set of devices.  ``ShardLayout.key()`` joins plan
fingerprints and the executor's compiled-plan keys, so a 1-shard and an
8-shard plan never alias.

``hash_shard`` and ``partition_to_shards`` are the shuffle join's
repartitioning: both join sides go through the same owner function, so
matching keys land on the same shard.

The model-sharding half of the reference module (logical-axis rules for
the LM harness) is not here.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

QUERY_SHARD_AXIS = "shard"


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """A query-layer striping: ``n_shards`` contiguous slices of one
    device's columns, one channel each."""

    n_shards: int
    axis: str = QUERY_SHARD_AXIS

    def __post_init__(self) -> None:
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")

    def key(self) -> tuple:
        """Hashable identity folded into fingerprints and cache keys (the
        reference's tuple, so fingerprints match)."""
        return ("shard_layout", self.n_shards, self.axis)


def hash_shard(keys: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Shard owner of each key: plain modulo, in int32.  Keys are
    validated non-negative by the eager engine layer, so the modulo is a
    total function here."""
    return (keys % n_shards).to(torch.int32)


def partition_to_shards(shard_ids: torch.Tensor,
                        values: Sequence[torch.Tensor], n_shards: int,
                        cap: int, fills: Sequence[torch.Tensor]
                        ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor,
                                   torch.Tensor]:
    """Scatter rows into fixed-capacity per-shard buckets (the shuffle).

    ``values`` are (N,) tensors sharing ``shard_ids``; each is scattered
    with one stable permutation into a copy of its ``fills[i]`` template
    of shape (n_shards, cap), whose contents are the pad pattern.  Within
    a shard, rows keep their input order.  Rows beyond a shard's ``cap``
    are dropped, but ``counts`` stays exact (``bincount``), so one retry
    with the measured capacity always suffices.  Returns (buckets, counts
    (n_shards,) int32, overflowed (0-d bool))."""
    n = shard_ids.shape[0]
    sid64 = shard_ids.to(torch.int64)
    order = torch.argsort(sid64, stable=True)
    sid = sid64[order]
    counts = torch.bincount(sid64, minlength=n_shards)[:n_shards]
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n, dtype=torch.int64, device=shard_ids.device) \
        - starts[sid]
    keep = pos < cap
    rows, cols = sid[keep], pos[keep]
    buckets = []
    for f, v in zip(fills, values):
        b = f.clone()
        b[rows, cols] = v[order][keep].to(b.dtype)
        buckets.append(b)
    counts = counts.to(torch.int32)
    return tuple(buckets), counts, (counts > cap).any()
