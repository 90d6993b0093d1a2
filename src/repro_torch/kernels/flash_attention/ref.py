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

``kv_tile_visits`` is the rule by which the bf16 backward kernel's dK / dV
blocks choose their q tiles under the position mask, as a plain function.
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


def _tile_fold(x: torch.Tensor, tile: int, fill: int) -> torch.Tensor:
    """(B, n) -> (B, ceil(n / tile), tile), the last tile padded with
    ``fill``."""
    b, n = x.shape
    out = x.new_full((b, -(-n // tile) * tile), fill)
    out[:, :n] = x
    return out.reshape(b, -1, tile)


def kv_tile_visits(q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                   q_tile: int = 64, kv_tile: int = 128) -> torch.Tensor:
    """Under the position mask, the q tiles (of ``q_tile`` rows) that the
    backward's dK / dV block of each kv tile (of ``kv_tile`` rows) visits:
    (B, ceil(Sk / kv_tile), ceil(Sq / q_tile)) bool.  A q tile is visited
    where its largest q position reaches the kv tile's least k position
    (some row keeps a key of the tile), and by every kv tile where it
    holds a row that keeps no key at all (a q position below every k
    position of the batch row): such a row averages every key, P = 1 /
    Sk, so it adds 1 / Sk . dO to every kv row's dV.  No other pair adds
    to dK or dV: where every row of a q tile is below every k position of
    a kv tile, each of their pairs is masked."""
    lo, hi = torch.iinfo(torch.int32).min, torch.iinfo(torch.int32).max
    qmax = _tile_fold(q_pos, q_tile, lo).amax(-1)          # (B, nq)
    qmin = _tile_fold(q_pos, q_tile, hi).amin(-1)
    kmin = _tile_fold(k_pos, kv_tile, hi).amin(-1)         # (B, nk)
    dead = qmin < k_pos.amin(-1, keepdim=True)
    return (qmax[:, None, :] >= kmin[:, :, None]) | dead[:, None, :]
