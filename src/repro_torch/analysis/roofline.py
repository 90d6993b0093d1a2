"""Three-term roofline of a dry-run cell on H100 targets.

All inputs are per-device quantities (``launch.dryrun``'s counts of one
rank's share of the step); terms are seconds a step on the card:

  compute    = flops / PEAK_FLOPS
  memory     = bytes_accessed / HBM_BW
  collective = collective_operand_bytes / NET_BW

MODEL_FLOPS is the textbook 6*N*D (dense) / 6*N_active*D (MoE) per train
step, 2*N*D_new for serve steps: the "useful work" yardstick; the ratio
MODEL_FLOPS / counted FLOPs exposes remat, masking and capacity waste.

The constants are NVIDIA's data-sheet figures for the H100 SXM, not
measurements:
  * ``PEAK_FLOPS``: dense bf16 tensor-core rate;
  * ``HBM_BW``: ``core.channels.H100_HBM_GBPS``, the one place that figure
    is kept;
  * ``NET_BW``: one 400 Gb/s NDR InfiniBand port a card.  A node holds 8
    cards, so both axes of a 16-wide mesh span nodes, and every
    production collective crosses the network.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.channels import H100_HBM_GBPS

PEAK_FLOPS = 989e12          # bf16 dense / card (data sheet)
HBM_BW = H100_HBM_GBPS * 1e9  # bytes/s / card (data sheet)
NET_BW = 50e9                # bytes/s / card: one 400 Gb/s port (data sheet)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_dev: float
    bytes_per_dev: float
    coll_operand_bytes: float
    coll_wire_bytes: float
    model_flops_global: float
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    net_bw: float = NET_BW

    @property
    def t_compute(self) -> float:
        return self.flops_per_dev / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_per_dev / self.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_operand_bytes / self.net_bw

    @property
    def t_collective_wire(self) -> float:
        return self.coll_wire_bytes / self.net_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Step-time lower bound under perfect overlap of the three engines."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        counted = self.flops_per_dev * self.chips
        return self.model_flops_global / counted if counted else 0.0

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilization achievable at the roofline bound."""
        denom = self.t_bound * self.chips * self.peak_flops
        return self.model_flops_global / denom if denom else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_dev": self.flops_per_dev,
            "bytes_per_dev": self.bytes_per_dev,
            "coll_operand_bytes": self.coll_operand_bytes,
            "coll_wire_bytes": self.coll_wire_bytes,
            "model_flops_global": self.model_flops_global,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu_bound,
        }


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """Global useful FLOPs per step."""
    n_active = cfg.param_count(active=True)
    if shape.kind == "train":
        return 6.0 * n_active * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.tokens
    # decode: one new token per sequence (KV / state reads are a memory cost)
    return 2.0 * n_active * shape.global_batch


def from_measurements(cfg: ArchConfig, shape: ShapeConfig, mesh_name: str,
                      chips: int, flops_per_dev: float, bytes_per_dev: float,
                      coll_operand: float, coll_wire: float,
                      **constants) -> Roofline:
    """``constants``: ``peak_flops``, ``hbm_bw`` or ``net_bw`` in place of
    the H100's."""
    return Roofline(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, chips=chips,
        flops_per_dev=flops_per_dev, bytes_per_dev=bytes_per_dev,
        coll_operand_bytes=coll_operand, coll_wire_bytes=coll_wire,
        model_flops_global=model_flops(cfg, shape), **constants,
    )
