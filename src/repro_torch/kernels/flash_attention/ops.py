"""Attention over (B, S, H, D) model-layout tensors: the model's prefill
calls this, and it runs the flash-attention kernel on the card and its
plain version on the CPU (the tensors' device decides)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.flash_attention import flash_attention


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True, q_pos: Optional[torch.Tensor] = None,
           k_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, Sq, H, D); k, v (B, Sk, KV, D) with the kv heads unexpanded;
    int32 ``q_pos`` / ``k_pos`` (B, Sq) / (B, Sk) make the causal mask one
    by position."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, q_pos=q_pos, k_pos=k_pos)
