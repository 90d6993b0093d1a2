"""Plain versions of the SSD (Mamba-2) chunk scan.

``ssd_plain`` is the f32 chunk scan that the TPU's ``ssd_pallas``
computes, over model-layout tensors: a loop over chunks carrying the
state h (hd, ds) per batch row and head.  Group g of b and c serves heads
g * nh / ng .. (g + 1) * nh / ng - 1, as the reference's ``jnp.repeat``
does.  A ragged last chunk is padded with dt = 0, which adds nothing to
y or h, so any length works.  ``ssd_naive`` is the sequential recurrence
in numpy, a copy of the reference's ground truth for tests.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def ssd_plain(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor, *,
              chunk: int = 128):
    """x (B, S, nh, hd); dt (B, S, nh) f32; a_log, d_skip (nh,) f32; b, c
    (B, S, ng, ds) -> (y (B, S, nh, hd) in x's type, h (B, nh, hd, ds)
    f32)."""
    bsz, s, nh, hd = x.shape
    ds = b.shape[-1]
    rep = nh // b.shape[2]
    pad = -s % chunk

    def heads_first(t, width=None):            # (B, S, nh[, w]) -> padded
        t = t.float()
        if width is not None and t.shape[2] != nh:
            t = t.repeat_interleave(rep, dim=2)
        t = t.transpose(1, 2)                  # (B, nh, S[, w])
        return F.pad(t, (0, 0, 0, pad) if t.dim() == 4 else (0, pad))

    xf, dtf = heads_first(x, hd), heads_first(dt)
    bf, cf = heads_first(b, ds), heads_first(c, ds)
    a_neg = -torch.exp(a_log.float())[None, :, None]
    dsk = d_skip.float()[None, :, None, None]
    keep = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    h = torch.zeros(bsz, nh, hd, ds, dtype=torch.float32, device=x.device)
    ys = []
    for j0 in range(0, s + pad, chunk):
        sl = slice(j0, j0 + chunk)
        xc, dtc, bc, cc = xf[:, :, sl], dtf[:, :, sl], bf[:, :, sl], cf[:, :, sl]
        cum = torch.cumsum(a_neg * dtc, dim=-1)            # (B, nh, Q)
        xdt = xc * dtc[..., None]
        seg = cum[..., :, None] - cum[..., None, :]
        scores = (cc @ bc.transpose(-1, -2)) * torch.where(
            keep, torch.exp(seg), 0.0)
        y = scores @ xdt
        y = y + torch.exp(cum)[..., None] * (cc @ h.transpose(-1, -2))
        ys.append(y + dsk * xc)
        decay = torch.exp(cum[..., -1:] - cum)
        h = h * torch.exp(cum[..., -1])[..., None, None] \
            + (xdt * decay[..., None]).transpose(-1, -2) @ bc
    y = torch.cat(ys, dim=2)[:, :, :s].transpose(1, 2)
    return y.to(x.dtype), h


def ssd_naive(x, dt, a_log, b, c, d_skip):
    """Sequential recurrence in numpy — ground truth for tests."""
    x, dt, b, c = map(np.asarray, (x, dt, b, c))
    a_log, d_skip = np.asarray(a_log), np.asarray(d_skip)
    B, S, NH, HD = x.shape
    NG, DS = b.shape[-2], b.shape[-1]
    rep = NH // NG
    h = np.zeros((B, NH, HD, DS), np.float32)
    A = -np.exp(a_log)
    ys = []
    for t in range(S):
        da = np.exp(A[None, :] * dt[:, t])
        bt = np.repeat(b[:, t], rep, axis=1)
        ct = np.repeat(c[:, t], rep, axis=1)
        upd = (dt[:, t][..., None] * x[:, t])[..., None] * bt[:, :, None, :]
        h = h * da[:, :, None, None] + upd
        y = np.einsum("bhds,bhs->bhd", h, ct) + d_skip[None, :, None] * x[:, t]
        ys.append(y)
    return np.stack(ys, 1), h
