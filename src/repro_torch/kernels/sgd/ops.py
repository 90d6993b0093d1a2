"""One-job SGD GLM trainer on top of the K-job kernel wrapper."""
from __future__ import annotations

import torch

from repro_torch.kernels.sgd.sgd import sgd


def sgd_train(a: torch.Tensor, b: torch.Tensor, x0: torch.Tensor, *,
              lr: float, l2: float = 0.0, minibatch: int = 16,
              epochs: int = 1, kind: str = "ridge") -> torch.Tensor:
    """a (m, n) f32, b (m,), x0 (n,) -> trained x (n,): the SGD kernel on
    the card, its plain version on the CPU."""
    hp = torch.tensor([[lr], [l2]], dtype=torch.float32, device=a.device)
    return sgd(a, b, x0.reshape(1, -1).contiguous(), hp[0], hp[1],
               minibatch=minibatch, epochs=epochs, kind=kind)[0]
