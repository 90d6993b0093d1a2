"""Plain-torch oracle for the traffic generator (paper §II): the read +
write stream ``o = x + 1``.  Integer addition wraps at the top of the
type, as the reference's does."""
from __future__ import annotations

import torch


def stream_copy_ref(x: torch.Tensor) -> torch.Tensor:
    return x + 1
