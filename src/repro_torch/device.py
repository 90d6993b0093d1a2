"""Device resolution for the port's entry points.

Everything runs on the CUDA card unless the caller asks for another device
by name.  There is no quiet fallback: with no card and no explicit device,
resolution raises, so a CPU run is always one the caller chose.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA card; anything else is taken as given."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: pass device='cpu' explicitly to "
            "run the port on the CPU")
    return torch.device("cuda")
