"""Mamba-2 block (SSD, state-space duality — arXiv:2405.21060) for serving.

Prefill runs the chunked SSD scan through ``kernels.ssd.ops.ssd``: the
hand-written kernel on the card, its plain version on the CPU.  Both work
in f32 inside; the reference's XLA path (``repro.models.mamba``) keeps
the intra-chunk tensors in bf16, so the two models agree at a bf16
tolerance.  A length that is not a multiple of the chunk is masked inside
the scan, which computes what the reference's dt = 0 padding computes.
Decode is one state update in plain torch (``ssd_decode_step``); the
reference has no kernel for it either.

Given sharding ``rules`` and a DTensor input, the projections pin their
layouts where the reference's do (x and z on ``ssm_heads``), and the
causal conv (on the x, B and C channels apart: a depthwise conv, so per
channel the same sums), the scan and the decode step run on each rank's
block: batch rows on the data axes, SSD heads on ``model``, B and C
whole.  The body is the one-card body: each helper falls through to
its one-card form on plain tensors.
"""
from __future__ import annotations

import itertools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (
    ShardingRules, active, constrain, on_shards,
)
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


def ssm_cache_logical(cfg: ArchConfig, batch: int) -> dict:
    """One SSM layer's cache as LogicalArrays (the reference's
    ``init_ssm_cache_spec``): the conv inputs (batch, None, None) in bf16,
    the state (batch, ssm_heads, None, None) in f32."""
    di, ds = cfg.d_inner, cfg.ssm_state
    nh, ng, w = cfg.n_ssm_heads, cfg.ssm_groups, cfg.ssm_conv_width
    return {"conv": la((batch, w - 1, di + 2 * ng * ds),
                       ("batch", None, None), torch.bfloat16),
            "state": la((batch, nh, cfg.ssm_head_dim, ds),
                        ("batch", "ssm_heads", None, None), torch.float32)}


# the layouts of the scan's operands on each rank
HEADS4 = ("batch", None, "ssm_heads", None)
HEADS3 = ("batch", None, "ssm_heads")
GROUPS = ("batch", None, None, None)
STATE = ("batch", "ssm_heads", None, None)
PER_HEAD = ("ssm_heads",)


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


def _ssd_scan(x, dt, a_log, b, c, d_skip):
    """The prefill's scan (B8) at the model's chunk."""
    return ssd(x, dt, a_log, b, c, d_skip, chunk=SSD_CHUNK)


def _conv_silu(rules: Optional[ShardingRules], parts: list,
               conv_w: torch.Tensor, cache_conv: Optional[torch.Tensor]):
    """The depthwise causal conv, then SiLU, over the channels of
    ``parts`` side by side (x's, B's and C's), continuing ``cache_conv``'s
    last W - 1 inputs where given: (the output of each part, the last
    W - 1 inputs, the new cache's).  On one card one conv over them all; under
    rules one conv a part on each rank's block (x's channels split with
    the SSD heads, B's and C's whole): a conv is per channel, so either
    way the same sums."""
    w = conv_w.shape[0]
    ends = list(itertools.accumulate(p.shape[-1] for p in parts))
    bounds = list(zip([0] + ends[:-1], ends))
    if rules is None:
        u = torch.cat(parts, -1)
        if cache_conv is not None:
            u = torch.cat([cache_conv.to(u.dtype), u], 1)
            out = _causal_conv(u, conv_w)[:, w - 1:]
        else:
            out = _causal_conv(u, conv_w)
        out = F.silu(out)
        return [out[..., a:b] for a, b in bounds], u[:, -(w - 1):]
    outs, tails = [], []
    for p, (a, b), logical in zip(parts, bounds, ("ssm_heads", None, None)):
        if cache_conv is not None:
            p = torch.cat([cache_conv[..., a:b].to(p.dtype), p], 1)
        out = on_shards(rules, _causal_conv, (("batch", None, logical),),
                        (("batch", None, logical), (None, logical)),
                        p, conv_w[:, a:b])
        outs.append(F.silu(out if cache_conv is None else out[:, w - 1:]))
        tails.append(p[:, -(w - 1):])
    return outs, torch.cat(tails, -1)


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

    def forward(self, x: torch.Tensor, *, cache: Optional[SSMCache] = None,
                rules: Optional[ShardingRules] = None):
        """Returns (out (B, S, d_model), the new cache or None); ``rules``
        lay a DTensor ``x``'s step out (see the module)."""
        cfg = self.cfg
        bsz, s, _ = x.shape
        di, ds = cfg.d_inner, cfg.ssm_state
        nh, ng, w = cfg.n_ssm_heads, cfg.ssm_groups, cfg.ssm_conv_width
        hd = cfg.ssm_head_dim
        rules = active(rules, x)

        z = constrain(rules, x @ self.w_z, *HEADS3)
        dt_raw = (x @ self.w_dt).float()
        parts = [constrain(rules, x @ self.w_x, *HEADS3), x @ self.w_b,
                 x @ self.w_c]
        (xs, bb, cc), new_conv = _conv_silu(
            rules, parts, self.conv_w, None if cache is None else cache.conv)
        xs = xs.reshape(bsz, s, nh, hd)
        bb = bb.reshape(bsz, s, ng, ds)
        cc = cc.reshape(bsz, s, ng, ds)
        dt = F.softplus(dt_raw + self.dt_bias)

        ins = (HEADS4, HEADS3, PER_HEAD, GROUPS, GROUPS, PER_HEAD)
        args = (xs, dt, self.a_log, bb, cc, self.d_skip)
        if cache is not None and s == 1:
            y, new_state = on_shards(rules, ssd_decode_step, (HEADS4, STATE),
                                     ins + (STATE,), *args, cache.state)
        else:
            y, new_state = on_shards(rules, _ssd_scan, (HEADS4, STATE), ins,
                                     *args)
        y = constrain(rules, y.reshape(bsz, s, di), *HEADS3)

        # gated RMS norm (mamba2's z-gating): bf16 tensors, f32 statistics
        yg = y * F.silu(z)
        var = yg.float().square().mean(-1, keepdim=True)
        scale = torch.rsqrt(var + 1e-5) * (1.0 + self.norm.float())
        y = (yg * scale.to(yg.dtype)).to(x.dtype)
        # DTensor may lay the norm's output out along the sequence: the
        # out-projection reads it by heads
        y = constrain(rules, y, *HEADS3)

        out = constrain(rules, y @ self.w_out, "batch", None, None)
        new_cache = SSMCache(new_conv, new_state) if cache is not None \
            else None
        return out, new_cache
