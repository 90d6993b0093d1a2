"""Channel-aware placement planner (the paper's Fig. 2 lesson) for one card.

On the AD9H7 the 8 GiB HBM is 32 pseudo-channels x 256 MiB; peak bandwidth
needs every port on its own channel.  One H100 is one device with one HBM
system, so an "engine" here is a contiguous shard of a column on that card:
``ChannelPlan.n_engines`` is a plain int (default 1) and the operators loop
over the shards.  The partitioned / congested / replicated placements keep
their meaning for the operators (congested = every engine rescans shard 0,
the Fig. 5 baseline), but on one card they all live in the same memory.

``fpga_bandwidth_model`` is the paper's calibrated AD9H7 model, copied.
The card's own entry is NVIDIA's data-sheet figure for the H100 SXM
(3.35 TB/s), a placeholder until the port's calibration runs on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import numpy as np
import torch

from repro_torch.device import resolve

# --- paper hardware model (AD9H7, 2 stacks x 16 pseudo channels) ----------- #
N_PORTS = 32
CHANNEL_MIB = 256
PORT_GBPS_200 = 190.0 / 32      # per-port ideal at 200 MHz (meas. Fig. 2)
PORT_GBPS_300 = 282.0 / 32
# a hammered channel sustains more than one port's share but far less than
# the aggregate: calibrated to the paper's S=0 points (14 / 21 GB/s)
CHANNEL_GBPS_200 = 14.0
CHANNEL_GBPS_300 = 21.0

# --- NVIDIA H100 SXM: data-sheet rates, not measurements ------------------- #
H100_HBM_GBPS = 3350.0
H100_FP32_FLOPS = 67e12         # float32 outside the tensor cores


def fpga_bandwidth_model(n_ports: int, separation_mib: int,
                         clock_mhz: int = 200) -> float:
    """Aggregate GB/s for the Fig. 2 microbenchmark: n_ports traffic
    generators, each offset by ``separation_mib`` MiB.  Ports whose address
    ranges land on the same physical channel share that channel's bandwidth.
    """
    port_bw = PORT_GBPS_200 if clock_mhz == 200 else PORT_GBPS_300
    chan_bw = CHANNEL_GBPS_200 if clock_mhz == 200 else CHANNEL_GBPS_300
    chans = [((i * separation_mib) // CHANNEL_MIB) % N_PORTS
             for i in range(n_ports)]
    load = np.bincount(chans, minlength=N_PORTS)
    total = 0.0
    for n in load:
        if n:
            total += min(n * port_bw, chan_bw)
    return total


Placement = Literal["partitioned", "congested", "replicated"]


@dataclasses.dataclass(frozen=True)
class ChannelPlan:
    """Placement of a 1-D column across ``n_engines`` contiguous shards of
    one device."""

    placement: Placement = "partitioned"
    n_engines: int = 1
    device: Optional[torch.device] = None

    def place(self, x) -> torch.Tensor:
        """Move a column onto the plan's device.  Without one, a tensor
        stays where it is and a numpy array goes to the card
        (``device.resolve(None)``), never quietly to the CPU."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device) if self.device is not None else x
        # a disk column's read-only memmap slice is copied (read) here:
        # torch wraps only writable memory
        x = np.require(x, requirements=("C", "W"))
        return torch.from_numpy(x).to(resolve(self.device))

    def align_morsel_rows(self, rows: int) -> int:
        """Round a morsel row count up to a multiple of the engine count so
        every morsel splits evenly into per-engine shards."""
        n = self.n_engines
        return max(-(-int(rows) // n) * n, n)


def plan(placement: Placement = "partitioned", n_engines: int = 1,
         device=None) -> ChannelPlan:
    return ChannelPlan(placement, int(n_engines),
                       torch.device(device) if device is not None else None)
