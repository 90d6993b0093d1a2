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


def selectivity_histogram(x: torch.Tensor,
                          selectivity_bins: int = 10) -> torch.Tensor:
    """Helper for Fig. 6 experiments: the counts (float32) of x's values
    in ``selectivity_bins`` equal bins over [min, max], to pick ranges of
    a target selectivity: ``jnp.histogram(x, bins)[0]`` bit for bit (for
    fewer than 2**24 values a bin).  As there, the values and the edges
    are float32 (an int32 column is cast), the range widens by 0.5 each
    way when min == max, the edges are ``jnp.linspace``'s, a value goes to
    the bin whose right edge is the first above it, and the last edge
    falls into the last bin.  The edges are computed as XLA compiles
    ``jnp.linspace`` (see below).  ``torch.histc`` takes floats only and
    ``torch.histogram`` has no CUDA kernel, so the bins are searched and
    counted with ``bincount``, on any device."""
    xf = x.reshape(-1).to(torch.float32)
    lo, hi = x.min().to(torch.float32), x.max().to(torch.float32)
    flat = lo == hi
    lo, hi = torch.where(flat, lo - 0.5, lo), torch.where(flat, hi + 0.5, hi)
    # jnp.linspace's edges as XLA compiles them on the CPU: the division
    # by the bin count a product with its f32 reciprocal r, hi's term
    # reassociated, and the sum contracted into one fused multiply-add,
    # fma(i, hi * r, lo * (1 - i * r)) (an f32 product is exact in f64)
    i = torch.arange(selectivity_bins, dtype=torch.float32, device=x.device)
    r = (torch.tensor(1.0, dtype=torch.float32) / selectivity_bins).item()
    head = lo * (1 - i * r)
    fma = i.double() * (hi * r).double() + head.double()
    edges = torch.cat([fma.to(torch.float32), hi[None]])
    idx = torch.searchsorted(edges, xf, right=True)
    idx = torch.where(xf == edges[-1], selectivity_bins, idx)
    counts = torch.bincount(idx, minlength=selectivity_bins + 1)
    return counts[1:selectivity_bins + 1].to(torch.float32)
