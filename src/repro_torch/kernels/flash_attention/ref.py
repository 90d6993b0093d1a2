"""Plain-torch oracle for the flash-attention kernel: dense softmax
attention over model-layout tensors.

q (B, Sq, H, D); k, v (B, Sk, KV, D) with H a multiple of KV (q head h
reads kv head h // (H / KV), as the reference's ``jnp.repeat`` expansion
does).  Non-causal attention takes every key, at any Sq and Sk (the
reference's cross-attention).  Causal attention (Sq == Sk) masks by
index, j > i, or, given per-row positions ``q_pos`` (B, Sq) and
``k_pos`` (B, Sk), where ``q_pos[b, i] < k_pos[b, j]``: the reference's
``q_pos >= k_pos`` mask (``attention.py``'s ``_dense_attn``), which is
the index mask when positions rise strictly along the row.  A row with
no key left averages every key, as the reference's softmax over
``NEG_INF`` scores does.  Scores are f32; the unnormalised ``p`` is
rounded to the value type before ``p . v`` and the sum divides
afterwards, which is what the TPU kernel's online softmax computes; the
output is in q's type.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_pos: Optional[torch.Tensor] = None,
                    k_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, kvh, h // kvh, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * d ** -0.5
    if causal:
        if q_pos is None:
            keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        else:
            keep = (q_pos[:, None, None, :, None]
                    >= k_pos[:, None, None, None, :])
        scores = torch.where(keep, scores, NEG_INF)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    den = p.sum(-1, keepdim=True).clamp(min=1e-30)
    p = p.to(v.dtype).float()
    out = torch.einsum("bkgqs,bskd->bkgqd", p, v.float()) / den
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)
