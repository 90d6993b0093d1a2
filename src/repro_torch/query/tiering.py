"""Tiered placement planning — device <-> host <-> disk spill plans.

A copy of the reference's planner (``repro/query/tiering.py``, which
imports no JAX), priced by the port's cost model; the environment names
are the reference's.

The paper's placement question ("which channel holds which column") stops
being binary once the working set exceeds the device placement budget:
instead of a hard ``PlacementCapacityError`` the executor asks this module
for a *spill plan* that assigns every streamed column a tier from the
priced hierarchy in ``cost.TIERS``.  The planner is greedy in the cache's
own currency: columns are ranked by the recompute-seconds-per-byte they
save on the fast tier (``CostModel.tier_score`` / promotion cost), the
device budget is filled hottest-first, the remainder cascades to host
DRAM and then disk, and only bytes that not even disk can hold surface as
``overflow_bytes`` (the one case that still errors).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.query.cost import CostModel, TIERS

ColKey = Tuple[str, str]                 # (table, column)


def _env_bytes(name: str) -> Optional[int]:
    """Parse a byte-count env var; unset/empty/invalid -> None (no cap)."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        v = int(raw)
    except ValueError:
        return None
    return v if v >= 0 else None


def default_spill_dir() -> str:
    """Where disk-tier column backings live (``REPRO_SPILL_DIR`` or a
    per-process tempdir); created lazily by the first demotion."""
    return os.environ.get("REPRO_SPILL_DIR") or os.path.join(
        tempfile.gettempdir(), f"repro_spill_{os.getpid()}")


@dataclasses.dataclass(frozen=True)
class TierBudgets:
    """Per-tier byte budgets.  ``None`` = unbounded (the host and disk
    default — matching today's behavior where anything that doesn't fit
    the device placement lives in host numpy arrays anyway)."""
    device: Optional[int] = None
    host: Optional[int] = None
    disk: Optional[int] = None

    @classmethod
    def from_env(cls, device: Optional[int] = None) -> "TierBudgets":
        """Budgets from the environment: ``REPRO_PLACEMENT_CAP`` (device),
        ``REPRO_HOST_CAP``, ``REPRO_DISK_CAP``.  An explicit ``device``
        argument (the Executor constructor) wins over the env."""
        return cls(
            device=device if device is not None
            else _env_bytes("REPRO_PLACEMENT_CAP"),
            host=_env_bytes("REPRO_HOST_CAP"),
            disk=_env_bytes("REPRO_DISK_CAP"))

    def cap(self, tier: str) -> Optional[int]:
        return getattr(self, tier)


@dataclasses.dataclass
class SpillPlan:
    """One tier assignment for a pipeline's streamed working set."""
    tiers: Dict[ColKey, str]
    bytes_by_tier: Dict[str, int]
    overflow_bytes: int = 0              # couldn't fit even on disk
    promote_s_per_exec: float = 0.0      # priced promotion per execution

    @property
    def spilled(self) -> bool:
        return any(t != "device" for t in self.tiers.values())

    def tier_of(self, key: ColKey) -> str:
        return self.tiers.get(key, "device")

    def describe(self) -> str:
        by = {t: n for t, n in self.bytes_by_tier.items() if n}
        return (f"tiers={by} promote={self.promote_s_per_exec * 1e6:.0f}us"
                + (f" OVERFLOW={self.overflow_bytes}B"
                   if self.overflow_bytes else ""))


def plan_spill(cols: Sequence[Tuple[ColKey, int]],
               budgets: TierBudgets,
               model: CostModel, *,
               reserved_device: int = 0,
               heat: Optional[Dict[ColKey, float]] = None) -> SpillPlan:
    """Assign each ``((table, column), n_bytes)`` a tier.

    Greedy fill, hottest-first: each column's *heat* is the recompute
    seconds per byte it represents on the device tier (callers pass
    observed reuse via ``heat``; absent that, every byte costs one
    device-bandwidth stream to re-promote, so bigger columns are hotter
    in absolute seconds and win device residency).  ``reserved_device``
    carves build-side / breaker bytes out of the device budget before
    stream columns are placed.  Promotion seconds accumulated into
    ``promote_s_per_exec`` are what ``morsel_cost(src_tier=...)`` will
    charge the streaming pipeline per execution."""
    heat = heat or {}
    remaining = {t: budgets.cap(t) for t in TIERS}
    if remaining["device"] is not None:
        remaining["device"] = max(remaining["device"] - reserved_device, 0)

    def rank(item: Tuple[ColKey, int]) -> Tuple[float, int]:
        key, n = item
        # per-byte heat first (observed reuse), absolute bytes second:
        # equal heat, the bigger column avoids more promotion seconds
        return (heat.get(key, 0.0), n)

    tiers: Dict[ColKey, str] = {}
    by_tier = {t: 0 for t in TIERS}
    overflow = 0
    promote_s = 0.0
    for key, n_bytes in sorted(cols, key=rank, reverse=True):
        placed_tier = None
        for tier in TIERS:
            cap = remaining[tier]
            if cap is None or cap >= n_bytes:
                placed_tier = tier
                if cap is not None:
                    remaining[tier] = cap - n_bytes
                break
        if placed_tier is None:
            overflow += n_bytes
            placed_tier = "disk"         # recorded, but overflow errors
        tiers[key] = placed_tier
        by_tier[placed_tier] += n_bytes
        promote_s += model.promotion_cost(float(n_bytes), placed_tier)
    return SpillPlan(tiers, by_tier, overflow, promote_s)
