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

The backward has a plain version of each forward pass's gradient, in
explicit formulas (no autograd): ``ssd_chunk_scan_bwd_plain`` (pass 3's:
the intra-chunk and skip terms and the gradient of the state entering
each chunk, R_k = sum_i exp(cum_i) gy_i c_i^T), ``ssd_state_pass_bwd_plain``
(pass 2's, run backwards: dS_k = G_{k+1}, G_k = R_k + exp(cum_last_k)
G_{k+1} from G_nc = the final state's gradient, and the decays'
gradients <dS_k, H_k>) and ``ssd_chunk_states_bwd_plain`` (pass 1's);
``ssd_backward_plain`` rebuilds the entering states with the forward's
passes 1 and 2 and composes them.  Every plain function computes in f32,
or in f64 where x is f64 (a reference for tests).
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
    f32, or f64 where x is f64)."""
    bsz, s, nh, hd = x.shape
    ds = b.shape[-1]
    rep = nh // b.shape[2]
    pad = -s % chunk

    def heads_first(t, width=None):            # (B, S, nh[, w]) -> padded
        t = _real(t)
        if width is not None and t.shape[2] != nh:
            t = t.repeat_interleave(rep, dim=2)
        t = t.transpose(1, 2)                  # (B, nh, S[, w])
        return F.pad(t, (0, 0, 0, pad) if t.dim() == 4 else (0, pad))

    xf, dtf = heads_first(x, hd), heads_first(dt)
    bf, cf = heads_first(b, ds), heads_first(c, ds)
    a_neg = -torch.exp(_real(a_log))[None, :, None]
    dsk = _real(d_skip)[None, :, None, None]
    keep = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    h = torch.zeros(bsz, nh, hd, ds, dtype=xf.dtype, device=x.device)
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


def _real(t: torch.Tensor) -> torch.Tensor:
    """t in f32, or in f64 where it is f64."""
    return t if t.dtype == torch.float64 else t.float()


def _chunks(t: torch.Tensor, nh: int, chunk: int) -> torch.Tensor:
    """(B, S, n[, w]) -> f32 (B, nh, nc, chunk[, w]), zero past S; a group
    axis n < nh is repeated over its heads."""
    t = _real(t)
    if t.shape[2] != nh:
        t = t.repeat_interleave(nh // t.shape[2], dim=2)
    t = t.transpose(1, 2)
    pad = -t.shape[2] % chunk
    t = F.pad(t, (0, 0, 0, pad) if t.dim() == 4 else (0, pad))
    return t.reshape(*t.shape[:2], -1, chunk, *t.shape[3:])


def _cum(dt: torch.Tensor, a_log: torch.Tensor) -> torch.Tensor:
    """The cumsum of a = -exp(a_log) dt within each chunk of dt (B, nh,
    nc, Q)."""
    return torch.cumsum(-torch.exp(_real(a_log))[None, :, None, None] * dt,
                        dim=-1)


def _split(v: torch.Tensor, split_bf16: bool):
    """v as the f32 terms whose products a route sums: (v,), or (hi, lo)
    with hi = bf16(v) and lo = bf16(v - hi)."""
    if not split_bf16:
        return (v,)
    hi = v.to(torch.bfloat16).to(v.dtype)
    return hi, (v - hi).to(torch.bfloat16).to(v.dtype)


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
    s, nh = x.shape[1], x.shape[2]
    dtc = _chunks(dt, nh, chunk)
    cum = _cum(dtc, a_log)
    xc, bc, cc = (_chunks(t, nh, chunk) for t in (x, b, c))
    seg = _seg_exp(cum)
    scores = (cc @ bc.transpose(-1, -2)) * seg * dtc[..., None, :]
    y = sum(t @ xc for t in _split(scores, split_bf16))
    y = y + torch.exp(cum)[..., None] * sum(
        cc @ t.transpose(-1, -2) for t in _split(h_in, split_bf16))
    y = y + _real(d_skip)[None, :, None, None, None] * xc
    return _unchunk(y, s).to(x.dtype)


def _seg_exp(cum: torch.Tensor) -> torch.Tensor:
    """exp(cum_i - cum_j) for j <= i and 0 above the diagonal (masked
    before the exp, so no inf reaches a product: 0 x inf is NaN)."""
    q = cum.shape[-1]
    keep = torch.ones(q, q, dtype=torch.bool, device=cum.device).tril()
    return torch.exp(torch.where(keep, cum[..., :, None] - cum[..., None, :],
                                 float("-inf")))


def _unchunk(t: torch.Tensor, s: int) -> torch.Tensor:
    """(B, nh, nc, chunk[, w]) -> (B, S, nh[, w]): the inverse of
    ``_chunks`` on a head axis, the padding dropped."""
    t = t.reshape(*t.shape[:2], -1, *t.shape[4:])[:, :, :s]
    return t.transpose(1, 2)


def _group_sum(t: torch.Tensor, ng: int) -> torch.Tensor:
    """(B, S, nh, w) -> (B, S, ng, w): each group's heads summed in
    order, the inverse of ``_chunks``' repeat."""
    bsz, s, nh, w = t.shape
    return t.reshape(bsz, s, ng, nh // ng, w).sum(3)


def _rev_cumsum(t: torch.Tensor) -> torch.Tensor:
    """sum_{t' >= t} along the last axis."""
    return torch.flip(torch.cumsum(torch.flip(t, (-1,)), -1), (-1,))


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


def ssd_chunk_scan_bwd_plain(x, dt, a_log, b, c, d_skip, h_in, gy, *,
                             chunk: int = 128):
    """Pass 3's gradients: those of ``ssd_chunk_scan_plain`` at (x, dt,
    a_log, b, c, d_skip, h_in) against gy (B, S, nh, hd) -> (dx, ddt,
    da_log, db, dc, dd_skip, dh_in), each in f32 (f64) and the shape of its
    input.  With M_ij = (c_i . b_j) E_ij dt_j and W_ij = (gy_i . x_j) E_ij
    dt_j (E_ij = exp(cum_i - cum_j), j <= i) and e_i = exp(cum_i):
    dx = M^T gy + d_skip gy, db = W^T c, dc = W b + e (gy H),
    dh_in = R = sum_i e_i gy_i c_i^T; d(cum)_t = sum_j F_tj - sum_i F_it
    + e_t gy_t . (H c_t) with F_ij = M_ij (gy_i . x_j), which a reverse
    cumsum carries to each token's a; ddt = sum_i F_ij / dt_j - exp(a_log)
    da, and da_log = sum_t da_t a_t = sum_{j <= i} F_ij (cum_i - cum_j)
    + sum_t e_t gy_t . (H c_t) cum_t."""
    s, nh = x.shape[1], x.shape[2]
    ng = b.shape[2]
    dtc = _chunks(dt, nh, chunk)
    cum = _cum(dtc, a_log)
    xc, bc, cc, gyc = (_chunks(t, nh, chunk) for t in (x, b, c, gy))
    seg = _seg_exp(cum)
    cb = cc @ bc.transpose(-1, -2)
    gx = gyc @ xc.transpose(-1, -2)
    m = cb * seg * dtc[..., None, :]
    w = gx * seg * dtc[..., None, :]
    t = cb * seg * gx                           # F = T dt_j
    f = t * dtc[..., None, :]
    e = torch.exp(cum)
    h_in = _real(h_in)
    gyh = gyc @ h_in                            # (.., Q, ds): H^T gy_i
    dx = m.transpose(-1, -2) @ gyc \
        + _real(d_skip)[None, :, None, None, None] * gyc
    db = w.transpose(-1, -2) @ cc
    dc = w @ bc + e[..., None] * gyh
    dh_in = (gyc * e[..., None]).transpose(-1, -2) @ cc
    ev = e * (gyh * cc).sum(-1)                 # e_t gy_t . (H c_t)
    dcum = f.sum(-1) - f.sum(-2) + ev
    da = _rev_cumsum(dcum)
    a_neg = -torch.exp(_real(a_log))
    ddt = t.sum(-2) + a_neg[None, :, None, None] * da
    # sum_t da_t a_t, summed pair by pair: F_ij (cum_i - cum_j) (zero above
    # the diagonal, where F is) and e_t v_t cum_t, which the reverse cumsum
    # would give as differences of sums of far larger terms
    seg = torch.where(f != 0, cum[..., :, None] - cum[..., None, :], 0.0)
    da_log = ((f * seg).sum((-1, -2)) + (ev * cum).sum(-1)).sum((0, 2))
    dd_skip = (gyc * xc).sum((0, 2, 3, 4))
    return (_unchunk(dx, s), _unchunk(ddt, s), da_log,
            _group_sum(_unchunk(db, s), ng), _group_sum(_unchunk(dc, s), ng),
            dd_skip, dh_in)


def ssd_state_pass_bwd_plain(h_in, decay, dh_in, gh=None):
    """Pass 2's gradients, the chunks in reverse: those of
    ``ssd_state_pass_plain`` at (states, decay) against dh_in (the
    entering states' gradient, R) and gh (the final state's; None: 0),
    given the entering states h_in -> (dstates like h_in, ddecay (B, nh,
    nc)): G = gh, then for k = nc - 1 .. 0, dS_k = G, ddecay_k = <G, H_k>
    and G = R_k + decay_k G."""
    g = torch.zeros_like(h_in[:, :, 0]) if gh is None else _real(gh)
    dstates, ddecay = torch.empty_like(h_in), torch.empty_like(decay)
    for k in reversed(range(h_in.shape[2])):
        dstates[:, :, k] = g
        ddecay[:, :, k] = (g * h_in[:, :, k]).sum((-1, -2))
        g = dh_in[:, :, k] + decay[:, :, k, None, None] * g
    return dstates, ddecay


def ssd_chunk_states_bwd_plain(x, dt, a_log, b, dstates, ddecay, *,
                               chunk: int = 128):
    """Pass 1's gradients: those of ``ssd_chunk_states_plain`` at (x, dt,
    a_log, b) against (dstates, ddecay) -> (dx, ddt, da_log, db) in f32
    (f64).  With w_j = dt_j exp(L - cum_j) (L = cum_last) and u_j = x_j .
    (dS b_j): dx_j = w_j dS b_j, db_j = w_j dS^T x_j; d(cum)_j = -w_j u_j
    and dL = sum_j w_j u_j + exp(L) ddecay, which a reverse cumsum carries
    to each token's a; ddt = exp(L - cum) u - exp(a_log) da, and da_log =
    sum_t da_t a_t = sum_j w_j u_j (L - cum_j) + L exp(L) ddecay."""
    s, nh = x.shape[1], x.shape[2]
    ng = b.shape[2]
    dtc = _chunks(dt, nh, chunk)
    cum = _cum(dtc, a_log)
    last = cum[..., -1:]
    decay_to_end = torch.exp(last - cum)
    wv = dtc * decay_to_end
    xc, bc = _chunks(x, nh, chunk), _chunks(b, nh, chunk)
    ds_b = bc @ dstates.transpose(-1, -2)       # (.., Q, hd): dS b_j
    dx = wv[..., None] * ds_b
    db = wv[..., None] * (xc @ dstates)
    u = (xc * ds_b).sum(-1)
    dcum = -wv * u
    dcay = torch.exp(last[..., 0]) * ddecay
    dcum[..., -1] += (wv * u).sum(-1) + dcay
    da = _rev_cumsum(dcum)
    a_neg = -torch.exp(_real(a_log))
    ddt = decay_to_end * u + a_neg[None, :, None, None] * da
    # sum_t da_t a_t, term by term (see ssd_chunk_scan_bwd_plain)
    da_log = ((wv * u * (last - cum)).sum(-1) + last[..., 0] * dcay).sum(
        (0, 2))
    return (_unchunk(dx, s), _unchunk(ddt, s), da_log,
            _group_sum(_unchunk(db, s), ng))


def ssd_backward_plain(x, dt, a_log, b, c, d_skip, gy, gh=None, *,
                       chunk: int = 128):
    """The gradients of ``ssd_chunked_plain``'s (y, final state) at its six
    inputs against gy and gh (None: 0), in the inputs' types: the entering
    states rebuilt by passes 1 and 2, then the three passes' gradients in
    reverse order (``ssd_chunk_scan_bwd_plain``,
    ``ssd_state_pass_bwd_plain``, ``ssd_chunk_states_bwd_plain``),
    summed."""
    states, decay = ssd_chunk_states_plain(x, dt, a_log, b, chunk=chunk)
    h_in, _ = ssd_state_pass_plain(states, decay)
    dx, ddt, da_log, db, dc, dd_skip, dh_in = ssd_chunk_scan_bwd_plain(
        x, dt, a_log, b, c, d_skip, h_in, gy, chunk=chunk)
    dstates, ddecay = ssd_state_pass_bwd_plain(h_in, decay, dh_in, gh)
    dx1, ddt1, da_log1, db1 = ssd_chunk_states_bwd_plain(
        x, dt, a_log, b, dstates, ddecay, chunk=chunk)
    return ((dx + dx1).to(x.dtype), (ddt + ddt1).to(dt.dtype),
            (da_log + da_log1).to(a_log.dtype), (db + db1).to(b.dtype),
            dc.to(c.dtype), dd_skip.to(d_skip.dtype))


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
