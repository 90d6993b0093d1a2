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

Given sharding ``rules`` and DTensor activations, q, k, v and the output
are pinned where the reference pins them (q on ``heads``, k and v on
``kv_heads``, the cache on ``kv_seq``), and the kernel's call runs on
each rank's block (``sharding.on_shards``): batch rows on the data axes,
q heads on ``model``; a rank whose q heads are a slice of the heads
reads the kv heads they share when the kv heads are replicated.  Decode
over a cache whose sequence is split (flash-decoding) computes each
rank's scores over its slice and combines them with a max and two sums
over the ``kv_seq`` axis; a cache write goes to the rank that holds the
positions.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed._functional_collectives as funcol
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (
    ShardingRules, active, axis_coordinate, constrain, dim_block, is_sharded,
    mesh_dim, on_shards,
)
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


def cache_logical(cfg: ArchConfig, batch: int, max_len: int, tp: int,
                  dtype=torch.bfloat16) -> dict:
    """One attention layer's cache as LogicalArrays at tensor-parallel
    degree ``tp`` (the reference's ``init_cache``): k and v (B, S_max,
    padded kv heads, hd) over ``("batch", "kv_seq", "kv_heads",
    "head_dim")``."""
    kvp, hd = cfg.padded_kv_heads(tp), cfg.head_dim
    ax = ("batch", "kv_seq", "kv_heads", "head_dim")
    return {"k": la((batch, max_len, kvp, hd), ax, dtype),
            "v": la((batch, max_len, kvp, hd), ax, dtype)}


QKV = ("batch", None, "heads", "head_dim")
KV = ("batch", None, "kv_heads", "head_dim")
CACHE = ("batch", "kv_seq", "kv_heads", "head_dim")
POS = ("batch", None)


def _own_kv_heads(rules: Optional[ShardingRules], q: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor) -> tuple:
    """The k and v heads a rank's local q heads read: a slice of them
    where the q heads are split and the kv heads replicated, else all of
    them (one card, or kv heads split with the q heads)."""
    if rules is None or rules.kv_heads is not None or rules.heads is None:
        return k, v
    q_heads = q.shape[2]
    tp = rules.mesh.size(mesh_dim(rules, rules.heads))
    g = q_heads * tp // k.shape[2]
    if q_heads % g and g % q_heads:
        raise ValueError(f"{q_heads} q heads a rank against groups of {g}")
    first = axis_coordinate(rules, rules.heads) * q_heads // g
    own = slice(first, first + max(q_heads // g, 1))
    return k[:, :, own], v[:, :, own]


def project(rules: Optional[ShardingRules], x, w, heads: str = "heads"):
    """x (B, S, d) through w (d, H, hd) -> (B, S, H, hd).  Under rules
    whose ``heads`` rule is None (the heads whole on every rank), on each
    rank's batch rows: DTensor would split the product's H x hd columns
    where no head boundary falls."""
    def local(x, w):
        d = w.shape[0]
        return (x @ w.reshape(d, -1)).unflatten(-1, w.shape[1:])
    if rules is None or getattr(rules, heads) is not None:
        return local(x, w)
    return on_shards(rules, local, (("batch", None, None, None),),
                     (("batch", None, None), (None, None, None)), x, w)


def _attend(rules: Optional[ShardingRules], q, k, v, *, causal: bool,
            q_pos=None, k_pos=None):
    """The kernel's call (``attend``), under rules on each rank's block:
    q (batch, None, heads, head_dim), k and v (batch, None, kv_heads,
    head_dim), positions (batch, None)."""
    def local(q, k, v, q_pos, k_pos):
        return attend(q, *_own_kv_heads(rules, q, k, v), causal=causal,
                      q_pos=q_pos, k_pos=k_pos)
    return on_shards(rules, local, (QKV,), (QKV, KV, KV, POS, POS),
                     q, k, v, q_pos, k_pos)


def _decode(rules: Optional[ShardingRules], q, k, v, length: int):
    """``_decode_attn``, under rules on each rank's block of the cache
    (batch, kv_seq, kv_heads, head_dim).  Where the cache's sequence is
    split (flash-decoding), every rank takes all the q heads and scores its
    slice of positions, and the slices combine over the ``kv_seq`` axis."""
    seq_axis = None if rules is None else rules.kv_seq
    q_spec, first, group = QKV, 0, None
    if seq_axis is not None:
        q_spec = ("batch", None, None, "head_dim")
        first = dim_block(rules, k.shape[1], "kv_seq").start
        group = (rules.mesh, mesh_dim(rules, seq_axis))

    def local(q, k, v):
        if seq_axis is None:
            k, v = _own_kv_heads(rules, q, k, v)
        return _decode_attn(q, k, v, length, first=first, group=group)

    out = on_shards(rules, local, (q_spec,), (q_spec, CACHE, CACHE), q, k, v)
    return constrain(rules, out, *QKV)


def write_cache(rules: Optional[ShardingRules], cache_t: torch.Tensor,
                new: torch.Tensor, start: int) -> None:
    """Positions ``start`` .. ``start + S`` of ``cache_t`` (B, S_max, KV, hd)
    set to ``new`` (B, S, KV, hd) in place; a DTensor cache on each rank's
    block of positions (``kv_seq``), from ``new`` laid out as the cache
    but whole along the sequence."""
    end = start + new.shape[1]
    if not is_sharded(rules, cache_t):
        cache_t[:, start:end] = new
        return
    local = cache_t.to_local()
    blk = dim_block(rules, cache_t.shape[1], "kv_seq")
    lo, hi = max(start, blk.start), min(end, blk.stop)
    if lo >= hi:
        return
    src = new.redistribute(rules.mesh, rules.placements(*KV)).to_local()
    local[:, lo - blk.start:hi - blk.start] = \
        src[:, lo - start:hi - start].to(local.dtype)


def _decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 length: int, *, first: int = 0,
                 group: Optional[tuple] = None) -> torch.Tensor:
    """q (B, 1, H, D) against the cache k, v (B, S_max, KV, D), of which the
    first ``length`` positions are valid.  Scores in f32; like the prefill
    kernel, p = exp(s - max) is rounded to q's type before p . v and the
    sum divides afterwards, so a decode step computes what the prefill
    computes for the same position.  k and v may be one rank's slice of a
    cache split along its sequence: ``first`` is its first position and
    ``group`` (mesh, dim) the axis it is split over, across which the max
    and the two sums combine (flash-decoding)."""
    b, _, h, d = q.shape
    kvh, s_max = k.shape[2], k.shape[1]
    qg = q.float().reshape(b, kvh, h // kvh, d)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * d ** -0.5
    valid = torch.arange(first, first + s_max, device=q.device) < length
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    if group is not None:
        m = funcol.all_reduce(m, "max", group)
    p = torch.exp(s - m)
    den = p.sum(-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(q.dtype).float(),
                       v.float())
    if group is not None:
        den = funcol.all_reduce(den, "sum", group)
        out = funcol.all_reduce(out, "sum", group)
    return (out / den).to(q.dtype).reshape(b, 1, h, d)


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
                cross_kv: Optional[tuple] = None,
                rules: Optional[ShardingRules] = None):
        """Returns (out (B, S, d_model), the advanced cache or None).
        ``mask_pos`` (B, S) masks a causal prefill by position;
        ``cross_kv`` = (k, v), each (B, S_enc, KV, hd), makes this
        cross-attention over all of them: a prefill through the kernel, a
        one-token step through the decode attention over their length.
        ``rules`` lay a DTensor ``x``'s step out (see the module)."""
        cfg = self.cfg
        b, s, d = x.shape
        rules = active(rules, x)

        def output(out):
            out = constrain(rules, out, *QKV)
            return constrain(rules, out.reshape(b, s, -1)
                             @ self.wo.reshape(-1, d), "batch", None, None)

        def rope(t):
            if not self.use_rope:
                return t
            return apply_rope(t, positions, cfg.rope_theta, cfg.rotary_pct,
                              cfg.mrope_sections)

        q = constrain(rules, rope(project(rules, x, self.wq)), *QKV)
        if cross_kv is not None:
            k, v = cross_kv
            out = _decode(rules, q, k, v, k.shape[1]) if s == 1 else \
                _attend(rules, q, k, v, causal=False)
            return output(out), None
        k = constrain(rules, rope(project(rules, x, self.wk, "kv_heads")),
                      *KV)
        v = constrain(rules, project(rules, x, self.wv, "kv_heads"), *KV)
        new_cache = None
        if cache is not None:
            end = cache.pos + s
            write_cache(rules, cache.k, k, cache.pos)
            write_cache(rules, cache.v, v, cache.pos)
            new_cache = KVCache(cache.k, cache.v, end)
        if cache is not None and s == 1:
            out = _decode(rules, q, cache.k, cache.v, new_cache.pos)
        else:
            out = _attend(rules, q, k, v, causal=causal, q_pos=mask_pos,
                          k_pos=mask_pos)
        return output(out), new_cache
