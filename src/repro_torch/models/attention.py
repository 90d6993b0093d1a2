"""Attention for serving: GQA/MHA projections, the KV cache, prefill
through the flash-attention kernel and decode over the cache.

Prefill (s > 1) attends over the freshly projected k and v through
``kernels.flash_attention.ops.attend``: the hand-written kernel on the
card, its plain version on the CPU; the kv heads stay unexpanded.  The
causal mask is by index, or by the positions ``mask_pos`` (B, S) that
the caller passes where its positions do not rise strictly along a row
(the reference masks by ``q_pos >= k_pos`` always; the two agree on
strictly rising positions).  The cross form attends, non-causally, to
k and v computed elsewhere (an encoder's output through this layer's
wk and wv, kept in a cache), and projects only q.
Decode (s == 1) is a plain masked softmax over the whole cache, as the
reference computes it outside any kernel (``attention.py``'s
``_dense_attn``): positions past ``pos + 1`` are masked to ``NEG_INF``;
its p is rounded where the prefill kernel rounds it (before the
normalisation, where the reference's dense path rounds after), so
prefill and decode agree with each other exactly on the CPU.
The cache is updated in place (the reference returns a new array); the
returned ``KVCache`` holds the same tensors with the advanced position.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention.ops import attend
from repro_torch.models.common import apply_rope, la, param

NEG_INF = -1e30


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor          # (B, S_max, KV, hd)
    v: torch.Tensor
    pos: int                 # tokens written so far


def attn_specs(cfg: ArchConfig, tp: int) -> dict:
    """``Attention``'s params at tensor-parallel degree ``tp``: query heads
    (and an MHA's kv heads) padded as the config pads them."""
    hp, kvp = cfg.padded_heads(tp), cfg.padded_kv_heads(tp)
    d, hd = cfg.d_model, cfg.head_dim
    return {
        "wq": la((d, hp, hd), ("fsdp", "heads", "head_dim")),
        "wk": la((d, kvp, hd), ("fsdp", "kv_heads", "head_dim")),
        "wv": la((d, kvp, hd), ("fsdp", "kv_heads", "head_dim")),
        "wo": la((hp, hd, d), ("heads", "head_dim", "fsdp")),
    }


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16) -> dict:
    """Shapes and types of one attention layer's cache:
    {name: (shape, dtype)}."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": (shape, dtype), "v": (shape, dtype)}


def _decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 length: int) -> torch.Tensor:
    """q (B, 1, H, D) against the cache k, v (B, S_max, KV, D), of which the
    first ``length`` positions are valid.  Scores in f32; like the prefill
    kernel, p = exp(s - max) is rounded to q's type before p . v and the
    sum divides afterwards, so a decode step computes what the prefill
    computes for the same position."""
    b, _, h, d = q.shape
    kvh, s_max = k.shape[2], k.shape[1]
    qg = q.float().reshape(b, kvh, h // kvh, d)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * d ** -0.5
    valid = torch.arange(s_max, device=q.device) < length
    s = torch.where(valid, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    den = p.sum(-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(q.dtype).float(),
                       v.float()) / den
    return out.to(q.dtype).reshape(b, 1, h, d)


class Attention(nn.Module):
    """Self- or cross-attention over x (B, S, d_model), with RoPE unless
    the config's positions are absolute; weights in the reference's
    layout: wq (d, H, hd), wk and wv (d, KV, hd), wo (H, hd, d)."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.use_rope = cfg.position_scheme != "absolute"
        d, hd = cfg.d_model, cfg.head_dim
        self.wq = param(d, cfg.n_heads, hd, device=device)
        self.wk = param(d, cfg.n_kv_heads, hd, device=device)
        self.wv = param(d, cfg.n_kv_heads, hd, device=device)
        self.wo = param(cfg.n_heads, hd, d, device=device)

    def forward(self, x: torch.Tensor, positions: Optional[torch.Tensor], *,
                cache: Optional[KVCache] = None, causal: bool = True,
                mask_pos: Optional[torch.Tensor] = None,
                cross_kv: Optional[tuple] = None):
        """Returns (out (B, S, d_model), the advanced cache or None).
        ``mask_pos`` (B, S) masks a causal prefill by position;
        ``cross_kv`` = (k, v), each (B, S_enc, KV, hd), makes this
        cross-attention over all of them: a prefill through the kernel, a
        one-token step through the decode attention over their length."""
        cfg = self.cfg
        b, s, d = x.shape

        def proj(w):
            return (x @ w.reshape(d, -1)).unflatten(-1, w.shape[1:])

        def rope(t):
            if not self.use_rope:
                return t
            return apply_rope(t, positions, cfg.rope_theta, cfg.rotary_pct,
                              cfg.mrope_sections)

        q = rope(proj(self.wq))
        if cross_kv is not None:
            k, v = cross_kv
            out = _decode_attn(q, k, v, k.shape[1]) if s == 1 else \
                attend(q, k, v, causal=False)
            return out.reshape(b, s, -1) @ self.wo.reshape(-1, d), None
        k = rope(proj(self.wk))
        v = proj(self.wv)
        new_cache = None
        if cache is not None:
            end = cache.pos + s
            cache.k[:, cache.pos:end] = k
            cache.v[:, cache.pos:end] = v
            new_cache = KVCache(cache.k, cache.v, end)
        if cache is not None and s == 1:
            out = _decode_attn(q, cache.k, cache.v, new_cache.pos)
        else:
            out = attend(q, k, v, causal=causal, q_pos=mask_pos,
                         k_pos=mask_pos)
        y = out.reshape(b, s, -1) @ self.wo.reshape(-1, d)
        return y, new_cache
