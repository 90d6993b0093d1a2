"""Shared model primitives: the init rule, norms, RoPE, logits over a
padded vocab, and the gated and plain MLPs.

Matmuls run in the param dtype (bf16); norms, RoPE angles, softmax and
logits accumulate in f32, as in the reference (``repro.models.common``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

PARAM_DTYPE = torch.bfloat16
INIT_SCALE = 0.02


def param(*shape: int, dtype=PARAM_DTYPE, device=None) -> nn.Parameter:
    """An uninitialised serving parameter (no gradient)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator,
                init_scale: float = INIT_SCALE) -> None:
    """The reference's init rule (``materialize``): 1-D params are zeros
    (norms use the (1 + scale) form, so zero is the identity); every other
    param is ``normal * min(init_scale, 1 / sqrt(fan_in))`` with fan_in the
    product of all but the last dim, drawn in f32 from ``generator`` on the
    param's device in the order of ``named_parameters``.  The reference
    applies the rule to its superblock-stacked arrays; here every layer's
    params are unstacked, so a layer's norm scales are 1-D and zero."""
    for _, p in module.named_parameters():
        if p.dim() <= 1:
            p.zero_()
            continue
        fan_in = float(math.prod(p.shape[:-1])) or 1.0
        scale = min(init_scale, 1.0 / math.sqrt(fan_in))
        p.copy_(scale * torch.randn(p.shape, generator=generator,
                                    dtype=torch.float32, device=p.device))


# --------------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------------- #

def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor,
              bias: Optional[torch.Tensor] = None,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * (1.0 + scale.float())
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def apply_norm(cfg, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return rmsnorm(x, scale) if cfg.norm == "rmsnorm" else layernorm(x, scale)


# --------------------------------------------------------------------------- #
# RoPE (standard and partial)
# --------------------------------------------------------------------------- #

def _rope_freqs(dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rotary_pct: float = 1.0,
               mrope_sections: Optional[tuple[int, int, int]] = None
               ) -> torch.Tensor:
    """x (B, S, H, D); positions (B, S) integers.  The first
    ``rotary_pct`` of each head rotates (rotate-half form), the rest passes
    through."""
    if mrope_sections is not None:
        raise NotImplementedError(
            "M-RoPE (qwen2-vl) is not ported yet: ROADMAP A11")
    d = x.shape[-1]
    rot = int(d * rotary_pct)
    rot -= rot % 2
    half = rot // 2
    freqs = _rope_freqs(rot, theta, x.device)
    angles = positions.float()[..., None] * freqs          # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:rot].float()
    y = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).to(x.dtype)
    if rot < d:
        y = torch.cat([y, x[..., rot:]], -1)
    return y


# --------------------------------------------------------------------------- #
# logits over a padded vocab
# --------------------------------------------------------------------------- #

def logits_fn(embed: torch.Tensor, unembed: Optional[torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) -> f32 logits (B, S, padded vocab): bf16 products summed
    in f32, as the reference's ``preferred_element_type=float32``; a tied
    model reads the embedding table transposed."""
    table = embed.t() if unembed is None else unembed
    return x.float() @ table.float()


# --------------------------------------------------------------------------- #
# MLP
# --------------------------------------------------------------------------- #

def _act(cfg, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if cfg.activation == "silu" else \
        F.gelu(x, approximate="tanh")


class MLP(nn.Module):
    """Gated (SwiGLU, gate and up fused into one (d, 2, f) weight) or plain
    two-matrix MLP, by the config's activation."""

    def __init__(self, cfg, d_ff: int, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        if cfg.gated_ffn:
            self.w_in = param(d, 2, d_ff, device=device)
        else:
            self.w_up = param(d, d_ff, device=device)
        self.w_down = param(d_ff, d, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.gated_ffn:
            d, _, f = self.w_in.shape
            gu = (x @ self.w_in.reshape(d, 2 * f)).unflatten(-1, (2, f))
            h = _act(self.cfg, gu[..., 0, :]) * gu[..., 1, :]
        else:
            h = _act(self.cfg, x @ self.w_up)
        return h @ self.w_down
