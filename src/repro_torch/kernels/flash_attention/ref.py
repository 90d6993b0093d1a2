"""Plain-torch oracle for the flash-attention kernel: dense softmax
attention over model-layout tensors.

q (B, S, H, D); k, v (B, S, KV, D) with H a multiple of KV (q head h
reads kv head h // (H / KV), as the reference's ``jnp.repeat`` expansion
does).  Scores are f32; the unnormalised ``p`` is rounded to the value
type before ``p . v`` and the sum divides afterwards, which is what the
TPU kernel's online softmax computes; the output is in q's type.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qg = q.float().reshape(b, s, kvh, h // kvh, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * d ** -0.5
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = torch.where(keep, scores, NEG_INF)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    den = p.sum(-1, keepdim=True).clamp(min=1e-30)
    p = p.to(v.dtype).float()
    out = torch.einsum("bkgqs,bskd->bkgqd", p, v.float()) / den
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)
