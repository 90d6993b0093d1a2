"""Traffic-generator analogue (paper §II, Fig. 1/2) on one card.

The paper instruments each AXI3 port with a configurable traffic
generator.  Here the generator is the read + write stream ``o = x + 1``
(``kernels/bandwidth``, a hand-written CUDA kernel on the card), one
engine per contiguous slice of the column, and ``measure_gbps`` times it
with CUDA events.  ``core.channels.fpga_bandwidth_model`` stays the
paper's published curve for comparison.
"""
from __future__ import annotations

import torch

from repro_torch.core.channels import ChannelPlan
from repro_torch.kernels.bandwidth.stream import stream_copy


def stream_copy_distributed(x: torch.Tensor,
                            plan: ChannelPlan) -> torch.Tensor:
    """One generator per engine: engine ``e`` streams rows
    ``[e * shard, (e + 1) * shard)`` into the same rows of the output,
    the engines one after another on the card.  In the reference every
    placement hands each engine its own slice (``shard_map`` with
    ``P(axis)``); the placement only decides where ``x`` sat before.  So
    the congested plan computes the same bits as the partitioned one,
    and only its time is of interest (the Fig. 2 analogue)."""
    n = x.shape[0]
    n_eng = plan.n_engines
    if n % n_eng:
        raise ValueError(f"{n} rows do not split into {n_eng} engines")
    x = plan.place(x)
    out = torch.empty_like(x)
    shard = n // n_eng
    for eng in range(n_eng):
        lo = eng * shard
        stream_copy(x[lo:lo + shard], out=out[lo:lo + shard])
    return out


def measure_gbps(fn, x: torch.Tensor, *, iters: int = 5) -> float:
    """GB/s of the read + write stream ``fn(x)`` on the card: CUDA events
    around ``iters`` calls after one warm-up, counting ``2 * x.nbytes``
    (each element read once and written once).  A CPU tensor raises: the
    port reports no host-clock number as a device rate."""
    if x.device.type != "cuda":
        raise ValueError("measure_gbps times the card with CUDA events; "
                         f"got a tensor on {x.device}")
    fn(x)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(x)
    stop.record()
    torch.cuda.synchronize(x.device)
    seconds = start.elapsed_time(stop) / 1e3 / iters
    return 2 * x.numel() * x.element_size() / seconds / 1e9
