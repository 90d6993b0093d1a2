"""A minimal column store — the MonetDB integration surface (paper §II/III).

Tables are dicts of int32/float32 columns.  A device column is a torch
tensor; a host column is a numpy array and a disk column a read-only
``.npy`` memmap (the memory tiers below the device).  Intermediate results
materialize eagerly, like MonetDB's BAT algebra — except for the morsel
views below, which cut columns into partition-granular slices for the
streaming execution path.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.channels import ChannelPlan
from repro_torch.device import DeviceLike, resolve


def as_column(data, device) -> torch.Tensor:
    """A column tensor on ``device`` with the reference's 32-bit types:
    JAX's default mode stores 64-bit integers and floats as int32 and
    float32, so the port does too and both systems hold the same values.
    Integers outside int32 are refused instead of wrapped."""
    if isinstance(data, torch.Tensor):
        a = data
    else:
        a = torch.from_numpy(np.ascontiguousarray(np.asarray(data)))
    if a.dtype == torch.float64:
        a = a.to(torch.float32)
    elif a.dtype in (torch.int64, torch.uint32, torch.uint64):
        if a.numel() and (int(a.min()) < -2 ** 31
                          or int(a.max()) > 2 ** 31 - 1):
            raise ValueError("integer column outside int32")
        a = a.to(torch.int32)
    return a.to(device)


@dataclasses.dataclass(frozen=True)
class MorselSpec:
    """Partition-granular slicing of a column set: ``rows`` per morsel,
    aligned to a ChannelPlan's engine count.  The last morsel may be
    ragged; its view is zero-padded to ``rows`` and carries the valid
    count."""

    total_rows: int
    rows: int

    def __post_init__(self):
        if self.rows <= 0 or self.total_rows < 0:
            raise ValueError(f"bad morsel spec {self}")

    @property
    def n_morsels(self) -> int:
        return max(-(-self.total_rows // self.rows), 1)

    def bounds(self, i: int) -> Tuple[int, int]:
        start = i * self.rows
        return start, min(start + self.rows, self.total_rows)

    @staticmethod
    def for_plan(total_rows: int, target_rows: int,
                 plan: ChannelPlan) -> "MorselSpec":
        """Target rounded up so each morsel shards evenly across the plan's
        engines, capped at (aligned) table size so a small table is a
        single morsel."""
        rows = plan.align_morsel_rows(min(max(target_rows, 1),
                                          max(total_rows, 1)))
        return MorselSpec(total_rows, rows)


@dataclasses.dataclass
class Column:
    data: object                       # torch.Tensor, or numpy / memmap
    name: str                          # when tier != "device"
    tier: str = "device"               # "device" | "host" | "disk"

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nbytes(self) -> int:
        d = self.data
        if isinstance(d, torch.Tensor):
            return d.numel() * d.element_size()
        return int(d.nbytes)

    def __len__(self):
        return int(self.data.shape[0])


@dataclasses.dataclass
class Table:
    name: str
    columns: dict
    plan: Optional[ChannelPlan] = None
    # mutation counter: every in-place column update bumps it; tier moves
    # never do
    version: int = 0

    @property
    def num_rows(self) -> int:
        return len(next(iter(self.columns.values())))

    def column(self, name: str):
        return self.columns[name].data

    def update_column(self, name: str, data,
                      device: DeviceLike = None) -> "Table":
        """Replace one column in place and bump the table version.  The
        new data lands on ``device``; with None, a device column keeps its
        device and a host or disk column moves to the card."""
        old = self.columns[name].data
        dev = old.device if device is None and isinstance(old, torch.Tensor) \
            else resolve(device)
        arr = as_column(data, dev)
        if arr.shape[0] != self.num_rows:
            raise ValueError(f"column {name}: {arr.shape[0]} rows, table "
                             f"has {self.num_rows}")
        self.columns[name] = Column(arr, name)
        self.version += 1
        return self

    def place(self, plan: ChannelPlan) -> "Table":
        """Every column onto the plan's device, tagged with the plan."""
        cols = {k: Column(plan.place(c.data), k)
                for k, c in self.columns.items()}
        return Table(self.name, cols, plan, self.version)

    # -- tier moves (device <-> host <-> disk) ------------------------------ #

    def column_tier(self, name: str) -> str:
        return self.columns[name].tier

    def demote_column(self, name: str, tier: str,
                      spill_dir: Optional[str] = None) -> "Table":
        """Push one column down to ``tier``: "host" keeps a numpy copy,
        "disk" writes an .npy under ``spill_dir`` and re-opens it as a
        read-only memmap; "device" promotes.  Values never change, so the
        table's version does not move.  Every disk demotion writes a file
        of its own: a name made only of table, column and version would
        hand a later table of the same name the earlier one's data."""
        col = self.columns[name]
        if col.tier == tier:
            return self
        if tier == "device":
            return self.promote_column(name)
        host = col.data.cpu().numpy() if isinstance(col.data, torch.Tensor) \
            else np.asarray(col.data)
        if tier == "host":
            self.columns[name] = Column(host, name, "host")
        elif tier == "disk":
            if not spill_dir:
                raise ValueError("disk demotion needs a spill directory")
            os.makedirs(spill_dir, exist_ok=True)
            fd, path = tempfile.mkstemp(
                suffix=".npy", dir=spill_dir,
                prefix=f"{self.name}__{name}__v{self.version}__")
            os.close(fd)
            np.save(path, host)
            self.columns[name] = Column(np.load(path, mmap_mode="r"),
                                        name, "disk")
        else:
            raise ValueError(f"demote to unknown tier {tier!r}")
        return self

    def promote_column(self, name: str, device: DeviceLike = None
                       ) -> "Table":
        """Bring a host/disk column back onto ``device`` wholesale."""
        col = self.columns[name]
        if col.tier != "device":
            self.columns[name] = Column(
                torch.from_numpy(np.array(col.data)).to(resolve(device)),
                name)
        return self

    # -- morsel views (streaming execution path) ---------------------------- #

    def morsel(self, spec: MorselSpec, i: int,
               columns: Optional[Sequence[str]] = None) -> Tuple[dict, int]:
        """Morsel ``i`` of the named columns as ``spec.rows``-sized arrays
        plus the valid row count.  The last morsel is zero-padded;
        consumers mask rows ``>= n_valid``.  Host/disk columns come back
        as numpy (the caller stages them onto the device)."""
        start, stop = spec.bounds(i)
        n_valid = stop - start
        out = {}
        for c in (columns if columns is not None else tuple(self.columns)):
            col = self.columns[c]
            d = col.data[start:stop]
            if col.tier != "device":
                d = np.asarray(d)
                if n_valid < spec.rows:
                    d = np.concatenate(
                        [d, np.zeros((spec.rows - n_valid,), d.dtype)])
            elif n_valid < spec.rows:
                d = torch.cat([d, d.new_zeros(spec.rows - n_valid)])
            out[c] = d
        return out, n_valid

    @staticmethod
    def from_arrays(name: str, arrays: Mapping[str, np.ndarray],
                    device: DeviceLike = None) -> "Table":
        """A device table from numpy columns (``device=None``: the card)."""
        dev = resolve(device)
        cols = {k: Column(as_column(v, dev), k)
                for k, v in arrays.items()}
        if len({len(c) for c in cols.values()}) != 1:
            raise ValueError(f"ragged table {name!r}")
        return Table(name, cols)
