"""Range selection: ``select`` is the kernel wrapper, which launches the
hand-written kernel for CUDA tensors and takes its plain version for CPU
tensors — the role the CPU baselines play in the paper."""
from __future__ import annotations

import torch

from repro_torch.kernels.selection.selection import DEFAULT_BLOCK, select


def select_count(x: torch.Tensor, lo, hi, *,
                 block: int = DEFAULT_BLOCK) -> torch.Tensor:
    _, counts = select(x, lo, hi, block=block)
    return counts.sum()


def compact(idx_lines: torch.Tensor, counts: torch.Tensor):
    """The compacted index array from padded kernel output (matches first,
    in row order, then the -1 dummies) and the total count."""
    flat = idx_lines.reshape(-1)
    order = torch.argsort((flat == -1).to(torch.int8), stable=True)
    return flat[order], counts.sum()
