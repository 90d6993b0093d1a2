"""Context-parallel decode attention (the explicit flash-decoding combine).

The counterpart of ``repro.distributed.context_parallel``.  Each rank of a
mesh axis holds one slice of the sequence of k and v and attends the
replicated one-token query over it (``cp_local``: the slice's running
max ``m``, sum ``l`` and unnormalised output ``o``); the slices merge
with the log-sum-exp trick (``lse_combine``):

    out = sum_i exp(m_i - m) * o_i / sum_i exp(m_i - m) * l_i

over ``all_reduce`` MAX and SUM of the axis's group (``cp_decode_attention``),
or over a stacked slice dim (``combine_stacked``), with the same
arithmetic.  Used for the jamba long_500k decode (524,288 positions).
Masked scores are ``NEG_INF`` = -1e30, a finite number, so a slice with
no valid key weighs nothing and a row with none at all gets the mean of
v, as in the reference.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

NEG_INF = -1e30


def cp_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             k_valid: torch.Tensor):
    """One slice: q (B, H, 1, D), k and v (B, S_local, H, D), k_valid
    (B, S_local) bool -> f32 (m (B, H, 1), l (B, H, 1), o (B, H, 1, D))."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bkhd->bhqk", q.float(), k.float()) * scale
    s = torch.where(k_valid[:, None, None, :], s, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    o = torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    return m, l, o


def lse_combine(m, l, o, pmax, psum):
    """The log-sum-exp combine of slices' (m, l, o), with ``pmax`` and
    ``psum`` reducing across the slices -> the f32 output."""
    m_g = pmax(m)
    w = torch.exp(m - m_g)
    denom = psum(w * l)
    num = psum(o * w[..., None])
    return num / torch.clamp_min(denom, 1e-30)[..., None]


def combine_stacked(m, l, o):
    """``lse_combine`` over dim 0 of stacked slices' (m, l, o)."""
    return lse_combine(m, l, o, lambda t: t.amax(0, keepdim=True),
                       lambda t: t.sum(0, keepdim=True))[0]


def _all_reduce(group, op):
    def reduce(t):
        t = t.clone()
        dist.all_reduce(t, op=op, group=group)
        return t
    return reduce


def cp_decode_attention(mesh: DeviceMesh, axis: str, q: torch.Tensor,
                        k: torch.Tensor, v: torch.Tensor,
                        k_valid: torch.Tensor) -> torch.Tensor:
    """q (B, H, 1, D), the same on every rank of ``axis``; k and v (B,
    S_local, H, D) and k_valid (B, S_local) this rank's slice of the
    sequence -> (B, H, 1, D) in q's type, the same on every rank."""
    group = mesh.get_group(axis)
    m, l, o = cp_local(q, k, v, k_valid)
    out = lse_combine(m, l, o, _all_reduce(group, dist.ReduceOp.MAX),
                      _all_reduce(group, dist.ReduceOp.SUM))
    return out.to(q.dtype)


def cp_decode_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        k_valid: torch.Tensor) -> torch.Tensor:
    """The unsharded oracle: one masked softmax over the whole sequence."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bkhd->bhqk", q.float(), k.float()) * scale
    s = torch.where(k_valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bhqd", p, v.float()).to(q.dtype)
