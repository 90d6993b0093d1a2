"""The SSD chunk scan over model-layout tensors: the Mamba-2 block's
prefill calls this, and it runs the SSD kernel on the card and its plain
version on the CPU (the tensors' device decides)."""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd.ssd import ssd_scan


def ssd(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
        b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor, *,
        chunk: int = 128):
    """x (B, S, nh, hd); dt (B, S, nh) f32; b, c (B, S, ng, ds).  Returns
    (y (B, S, nh, hd), h_final (B, nh, hd, ds) f32)."""
    return ssd_scan(*(t.contiguous() for t in (x, dt, a_log, b, c, d_skip)),
                    chunk=chunk)
