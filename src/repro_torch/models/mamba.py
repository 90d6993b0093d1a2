"""Mamba-2 block (SSD, state-space duality — arXiv:2405.21060) for serving.

Prefill runs the chunked SSD scan through ``kernels.ssd.ops.ssd``: the
hand-written kernel on the card, its plain version on the CPU.  Both work
in f32 inside; the reference's XLA path (``repro.models.mamba``) keeps
the intra-chunk tensors in bf16, so the two models agree at a bf16
tolerance.  A length that is not a multiple of the chunk is masked inside
the scan, which computes what the reference's dt = 0 padding computes.
Decode is one state update in plain torch (``ssd_decode_step``); the
reference has no kernel for it either.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.models.common import la, param

SSD_CHUNK = 128


class SSMCache(NamedTuple):
    conv: torch.Tensor      # (B, w-1, di + 2*ng*ds) — rolling conv inputs
    state: torch.Tensor     # (B, nh, hd, ds) f32


def init_ssm_cache_spec(cfg: ArchConfig, batch: int,
                        dtype=torch.bfloat16) -> dict:
    """Shapes and types of one SSM layer's cache: {name: (shape, dtype)};
    the conv inputs in ``dtype``, the state always in f32."""
    di, ds = cfg.d_inner, cfg.ssm_state
    nh, ng, w = cfg.n_ssm_heads, cfg.ssm_groups, cfg.ssm_conv_width
    return {"conv": ((batch, w - 1, di + 2 * ng * ds), dtype),
            "state": ((batch, nh, cfg.ssm_head_dim, ds), torch.float32)}


def ssm_specs(cfg: ArchConfig) -> dict:
    """``Mamba``'s params, in its order."""
    d, di, ds = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh, ng, w = cfg.n_ssm_heads, cfg.ssm_groups, cfg.ssm_conv_width
    return {
        "w_x": la((d, di), ("fsdp", "ssm_heads")),
        "w_z": la((d, di), ("fsdp", "ssm_heads")),
        "w_b": la((d, ng * ds), ("fsdp", None)),
        "w_c": la((d, ng * ds), ("fsdp", None)),
        "w_dt": la((d, nh), ("fsdp", "ssm_heads")),
        "dt_bias": la((nh,), ("ssm_heads",), torch.float32),
        "a_log": la((nh,), ("ssm_heads",), torch.float32),
        "d_skip": la((nh,), ("ssm_heads",), torch.float32),
        "conv_w": la((w, di + 2 * ng * ds), (None, None)),
        "norm": la((di,), ("ssm_heads",)),
        "w_out": la((di, d), ("ssm_heads", "fsdp")),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv via stacked shifts. u (B, S, C), w (W, C)."""
    width = w.shape[0]
    acc = u * w[-1]
    for i in range(1, width):
        shifted = F.pad(u, (0, 0, i, 0))[:, :-i]
        acc = acc + shifted * w[-1 - i]
    return acc


def ssd_decode_step(x, dt, a_log, b, c, d_skip, state):
    """One-token SSD update. x (B, 1, nh, hd); dt (B, 1, nh) f32; b, c
    (B, 1, ng, ds); state (B, nh, hd, ds) f32 -> (y (B, 1, nh, hd) in x's
    type, new state)."""
    xf = x[:, 0].float()                                       # (B, nh, hd)
    dt0 = dt[:, 0]                                             # (B, nh)
    da = torch.exp(-torch.exp(a_log)[None, :] * dt0)
    rep = x.shape[2] // b.shape[2]
    b0 = b[:, 0].repeat_interleave(rep, dim=1).float()          # (B, nh, ds)
    c0 = c[:, 0].repeat_interleave(rep, dim=1).float()
    upd = (dt0[..., None] * xf)[..., None] * b0[:, :, None, :]
    state = state * da[:, :, None, None] + upd
    y = torch.einsum("bhds,bhs->bhd", state, c0) + d_skip[None, :, None] * xf
    return y[:, None].to(x.dtype), state


class Mamba(nn.Module):
    """The full Mamba-2 mixer over x (B, S, d_model); weights in the
    reference's layout (``ssm_params``)."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, di, ds = cfg.d_model, cfg.d_inner, cfg.ssm_state
        nh, ng, w = cfg.n_ssm_heads, cfg.ssm_groups, cfg.ssm_conv_width
        self.w_x = param(d, di, device=device)
        self.w_z = param(d, di, device=device)
        self.w_b = param(d, ng * ds, device=device)
        self.w_c = param(d, ng * ds, device=device)
        self.w_dt = param(d, nh, device=device)
        self.dt_bias = param(nh, dtype=torch.float32, device=device)
        self.a_log = param(nh, dtype=torch.float32, device=device)
        self.d_skip = param(nh, dtype=torch.float32, device=device)
        self.conv_w = param(w, di + 2 * ng * ds, device=device)
        self.norm = param(di, device=device)
        self.w_out = param(di, d, device=device)

    def forward(self, x: torch.Tensor, *, cache: Optional[SSMCache] = None):
        """Returns (out (B, S, d_model), the new cache or None)."""
        cfg = self.cfg
        bsz, s, _ = x.shape
        di, ds = cfg.d_inner, cfg.ssm_state
        nh, ng, w = cfg.n_ssm_heads, cfg.ssm_groups, cfg.ssm_conv_width
        hd = cfg.ssm_head_dim

        z = x @ self.w_z
        dt_raw = (x @ self.w_dt).float()
        conv_in = torch.cat([x @ self.w_x, x @ self.w_b, x @ self.w_c], -1)
        if cache is not None:
            full = torch.cat([cache.conv.to(conv_in.dtype), conv_in], 1)
            conv_out = _causal_conv(full, self.conv_w)[:, w - 1:]
            new_conv = full[:, -(w - 1):]
        else:
            conv_out = _causal_conv(conv_in, self.conv_w)
            new_conv = conv_in[:, -(w - 1):]
        conv_out = F.silu(conv_out)

        xs = conv_out[..., :di].reshape(bsz, s, nh, hd)
        bb = conv_out[..., di:di + ng * ds].reshape(bsz, s, ng, ds)
        cc = conv_out[..., di + ng * ds:].reshape(bsz, s, ng, ds)
        dt = F.softplus(dt_raw + self.dt_bias)

        if cache is not None and s == 1:
            y, new_state = ssd_decode_step(xs, dt, self.a_log, bb, cc,
                                           self.d_skip, cache.state)
        else:
            y, new_state = ssd(xs, dt, self.a_log, bb, cc, self.d_skip,
                               chunk=SSD_CHUNK)
        y = y.reshape(bsz, s, di)

        # gated RMS norm (mamba2's z-gating): bf16 tensors, f32 statistics
        yg = y * F.silu(z)
        var = yg.float().square().mean(-1, keepdim=True)
        scale = torch.rsqrt(var + 1e-5) * (1.0 + self.norm.float())
        y = (yg * scale.to(yg.dtype)).to(x.dtype)

        out = y @ self.w_out
        new_cache = SSMCache(new_conv, new_state) if cache is not None \
            else None
        return out, new_cache
