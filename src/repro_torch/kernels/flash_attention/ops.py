"""Attention over (B, S, H, D) model-layout tensors: the model's prefill
calls this, and it runs the flash-attention kernel on the card and its
plain version on the CPU (the tensors' device decides)."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import flash_attention


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True) -> torch.Tensor:
    """q (B, S, H, D); k, v (B, S, KV, D) with the kv heads unexpanded."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal)
