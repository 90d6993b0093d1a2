"""Scale-out range selection (paper §IV) over the plan's engines.

Each engine scans its contiguous shard of the column with the selection
kernel and emits an index line plus its match count.  One card runs the
engines one after another (the TPU port ran them under ``shard_map``);
the only synchronization is the final count reduction.
"""
from __future__ import annotations

import torch

from repro_torch.core.channels import ChannelPlan
from repro_torch.kernels.selection import ops as sel_ops
from repro_torch.kernels.selection.selection import DEFAULT_BLOCK


def select_distributed(x: torch.Tensor, lo, hi, plan: ChannelPlan, *,
                       block: int = DEFAULT_BLOCK):
    """x: (N,) int32 with N a multiple of the engine count.  Returns (idx
    lines (N,), per-engine counts (n_engines,)); indices are GLOBAL.

    The kernel masks ragged blocks, so N need not tile into ``block``.
    Congested placement keeps the Fig. 5 baseline: every engine rescans
    the FIRST shard with its own offset, which is a correct selection only
    at one engine."""
    n = x.shape[0]
    n_eng = plan.n_engines
    if n % n_eng:
        raise ValueError(f"{n} rows do not split into {n_eng} engines")
    shard = n // n_eng
    lines, counts = [], []
    for eng in range(n_eng):
        lo_row = eng * shard if plan.placement == "partitioned" else 0
        idx, cnt = sel_ops.select(x[lo_row:lo_row + shard], lo, hi,
                                  block=block)
        lines.append(torch.where(idx >= 0, idx + eng * shard, -1))
        counts.append(cnt.sum())
    return torch.cat(lines), torch.stack(counts)
