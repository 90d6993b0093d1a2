"""Plain versions of the SSD (Mamba-2) chunk scan.

``ssd_plain`` is the f32 chunk scan that the TPU's ``ssd_pallas``
computes, over model-layout tensors: a loop over chunks carrying the
state h (hd, ds) per batch row and head.  Group g of b and c serves heads
g * nh / ng .. (g + 1) * nh / ng - 1, as the reference's ``jnp.repeat``
does.  A ragged last chunk is padded with dt = 0, which adds nothing to
y or h, so any length works.  ``ssd_naive`` is the sequential recurrence
in numpy, a copy of the reference's ground truth for tests.

The card's kernel runs the state-passing form in three passes, each with
a plain version here: ``ssd_chunk_states_plain`` (every chunk's own state
S_k and decay exp(cum_last)), ``ssd_state_pass_plain`` (the state
entering each chunk, H_{k+1} = H_k exp(cum_last_k) + S_k, and the final
state) and ``ssd_chunk_scan_plain`` (y from each chunk's tokens and the
state entering it); ``ssd_chunked_plain`` composes them.  With
``split_bf16`` the three products that have an f32 operand (x dt decay
against b, the masked and decayed scores against x, C against H) take it
as hi = bf16(v) plus lo = bf16(v - hi), each product in f32: the
arithmetic of the kernel's tensor-core route, on bf16 inputs.
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
        # masked before the exp, so no inf above the diagonal reaches
        # autograd (0 x inf is NaN in the backward)
        scores = (cc @ bc.transpose(-1, -2)) * torch.exp(
            torch.where(keep, seg, float("-inf")))
        y = scores @ xdt
        y = y + torch.exp(cum)[..., None] * (cc @ h.transpose(-1, -2))
        ys.append(y + dsk * xc)
        decay = torch.exp(cum[..., -1:] - cum)
        h = h * torch.exp(cum[..., -1])[..., None, None] \
            + (xdt * decay[..., None]).transpose(-1, -2) @ bc
    y = torch.cat(ys, dim=2)[:, :, :s].transpose(1, 2)
    return y.to(x.dtype), h


def _chunks(t: torch.Tensor, nh: int, chunk: int) -> torch.Tensor:
    """(B, S, n[, w]) -> f32 (B, nh, nc, chunk[, w]), zero past S; a group
    axis n < nh is repeated over its heads."""
    t = t.float()
    if t.shape[2] != nh:
        t = t.repeat_interleave(nh // t.shape[2], dim=2)
    t = t.transpose(1, 2)
    pad = -t.shape[2] % chunk
    t = F.pad(t, (0, 0, 0, pad) if t.dim() == 4 else (0, pad))
    return t.reshape(*t.shape[:2], -1, chunk, *t.shape[3:])


def _cum(dt: torch.Tensor, a_log: torch.Tensor) -> torch.Tensor:
    """The cumsum of a = -exp(a_log) dt within each chunk of dt (B, nh,
    nc, Q)."""
    return torch.cumsum(-torch.exp(a_log.float())[None, :, None, None] * dt,
                        dim=-1)


def _split(v: torch.Tensor, split_bf16: bool):
    """v as the f32 terms whose products a route sums: (v,), or (hi, lo)
    with hi = bf16(v) and lo = bf16(v - hi)."""
    if not split_bf16:
        return (v,)
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def ssd_chunk_states_plain(x, dt, a_log, b, *, chunk: int = 128,
                           split_bf16: bool = False):
    """Pass 1: each chunk's own state S_k = sum_j exp(cum_last - cum_j)
    dt_j x_j b_j^T -> (states (B, nh, nc, hd, ds) f32, decay = exp(cum_last)
    (B, nh, nc) f32)."""
    nh = x.shape[2]
    dtc = _chunks(dt, nh, chunk)
    cum = _cum(dtc, a_log)
    w = dtc * torch.exp(cum[..., -1:] - cum)
    xw = _chunks(x, nh, chunk) * w[..., None]
    bc = _chunks(b, nh, chunk)
    states = sum(t.transpose(-1, -2) @ bc for t in _split(xw, split_bf16))
    return states, torch.exp(cum[..., -1])


def ssd_state_pass_plain(states: torch.Tensor, decay: torch.Tensor):
    """Pass 2: (states (B, nh, nc, hd, ds), decay (B, nh, nc)) -> (the
    state entering each chunk, like states, with H_0 = 0; the final state
    (B, nh, hd, ds))."""
    h = torch.zeros_like(states[:, :, 0])
    entering = []
    for k in range(states.shape[2]):
        entering.append(h)
        h = h * decay[:, :, k, None, None] + states[:, :, k]
    return torch.stack(entering, 2) if entering else states.clone(), h


def ssd_chunk_scan_plain(x, dt, a_log, b, c, d_skip, h_in, *,
                         chunk: int = 128, split_bf16: bool = False):
    """Pass 3: y_i = sum_{j <= i} (c_i . b_j) exp(cum_i - cum_j) dt_j x_j
    + exp(cum_i) (c_i . H_k) + d_skip x_i from the state H_k entering each
    chunk (h_in (B, nh, nc, hd, ds)) -> y (B, S, nh, hd) in x's type."""
    bsz, s, nh, hd = x.shape
    dtc = _chunks(dt, nh, chunk)
    cum = _cum(dtc, a_log)
    xc, bc, cc = (_chunks(t, nh, chunk) for t in (x, b, c))
    keep = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    seg = torch.exp(torch.where(keep, cum[..., :, None] - cum[..., None, :],
                                float("-inf")))
    scores = (cc @ bc.transpose(-1, -2)) * seg * dtc[..., None, :]
    y = sum(t @ xc for t in _split(scores, split_bf16))
    y = y + torch.exp(cum)[..., None] * sum(
        cc @ t.transpose(-1, -2) for t in _split(h_in, split_bf16))
    y = y + d_skip.float()[None, :, None, None, None] * xc
    y = y.reshape(bsz, nh, -1, hd)[:, :, :s].transpose(1, 2)
    return y.to(x.dtype)


def ssd_chunked_plain(x, dt, a_log, b, c, d_skip, *, chunk: int = 128,
                      split_bf16: bool = False):
    """The three passes composed: (y like x, final state (B, nh, hd, ds)
    f32), the function ``ssd_plain`` computes."""
    states, decay = ssd_chunk_states_plain(x, dt, a_log, b, chunk=chunk,
                                           split_bf16=split_bf16)
    h_in, h = ssd_state_pass_plain(states, decay)
    y = ssd_chunk_scan_plain(x, dt, a_log, b, c, d_skip, h_in, chunk=chunk,
                             split_bf16=split_bf16)
    return y, h


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
