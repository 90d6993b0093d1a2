"""Decoder-only LM for serving, for the ``dense`` and ``ssm`` families.

The reference stacks each superblock position's params and scans over
them (``repro.models.transformer``); one H100 runs the layers from an
``nn.ModuleList`` in a Python loop instead, so layer ``i`` is the
reference's superblock ``i // P`` at position ``i % P`` (``_period``).
Caches are a list with one entry per layer: a ``KVCache`` for an
attention layer, an ``SSMCache`` for an SSM layer.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import Attention, KVCache, init_cache
from repro_torch.models.common import MLP, apply_norm, logits_fn, param
from repro_torch.models.mamba import Mamba, SSMCache, init_ssm_cache_spec

FAMILIES = ("dense", "ssm")

Cache = Union[KVCache, SSMCache]


def check_family(cfg: ArchConfig) -> None:
    """The port serves the dense and SSM families; every other one raises
    rather than running a substitute."""
    if cfg.family not in FAMILIES or cfg.is_enc_dec or cfg.n_experts \
            or cfg.mrope_sections is not None:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) is not ported yet: the port serves "
            f"the {' and '.join(FAMILIES)} families; MoE, hybrid, VLM and "
            "encoder-decoder models wait for ROADMAP A11")


def _period(cfg: ArchConfig) -> int:
    p = 1
    if cfg.family in ("hybrid", "ssm"):
        p = math.lcm(p, cfg.attn_every if cfg.family == "hybrid" else 1)
    if cfg.n_experts:
        p = math.lcm(p, cfg.moe_every)
    assert cfg.num_layers % p == 0, (cfg.name, cfg.num_layers, p)
    return p


class Block(nn.Module):
    """Pre-norm residual layer: attention or Mamba-2, then (outside the
    SSM family) the MLP."""

    def __init__(self, cfg: ArchConfig, i: int, device=None):
        super().__init__()
        self.cfg = cfg
        self.norm1 = param(cfg.d_model, device=device)
        if cfg.layer_is_attn(i):
            self.attn = Attention(cfg, device)
        else:
            self.ssm = Mamba(cfg, device)
        if cfg.family != "ssm":
            self.norm2 = param(cfg.d_model, device=device)
            self.ffn = MLP(cfg, cfg.d_ff, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cache: Optional[Cache]):
        h = apply_norm(self.cfg, x, self.norm1)
        if hasattr(self, "attn"):
            mix, new_c = self.attn(h, positions, cache=cache)
        else:
            mix, new_c = self.ssm(h, cache=cache)
        x = x + mix
        if self.cfg.family != "ssm":
            x = x + self.ffn(apply_norm(self.cfg, x, self.norm2))
        return x, new_c


class Transformer(nn.Module):
    """Embedding, ``num_layers`` blocks and the final norm; the logits read
    the untied ``unembed`` (d, padded vocab) or the embedding transposed."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        pv = cfg.padded_vocab(1)
        self.embed = param(pv, cfg.d_model, device=device)
        if not cfg.tie_embeddings:
            self.unembed = param(cfg.d_model, pv, device=device)
        self.layers = nn.ModuleList(
            Block(cfg, i, device) for i in range(cfg.num_layers))
        self.final_norm = param(cfg.d_model, device=device)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return logits_fn(self.embed, getattr(self, "unembed", None), x)

    def forward(self, tokens: torch.Tensor, *,
                positions: Optional[torch.Tensor] = None,
                caches: Optional[List[Cache]] = None, cache_pos: int = 0):
        """tokens (B, S) -> (x_final (B, S, d_model), new caches or None)."""
        b, s = tokens.shape
        x = F.embedding(tokens, self.embed)
        if positions is None:
            positions = (torch.arange(s, device=tokens.device)
                         + cache_pos).expand(b, s)
        new_caches = [] if caches is not None else None
        for i, layer in enumerate(self.layers):
            c = caches[i] if caches is not None else None
            if isinstance(c, KVCache):          # written from cache_pos on
                c = dataclasses.replace(c, pos=cache_pos)
            x, c = layer(x, positions, c)
            if caches is not None:
                new_caches.append(c)
        return apply_norm(self.cfg, x, self.final_norm), new_caches


def prefill_fn(model: Transformer, tokens: torch.Tensor,
               caches: List[Cache]):
    """Populate the caches from a whole prompt (B, S); return the last
    token's f32 logits (B, 1, padded vocab) and the caches."""
    x, new_caches = model(tokens, caches=caches, cache_pos=0)
    return model.logits(x[:, -1:]), new_caches


def decode_fn(model: Transformer, tokens: torch.Tensor, pos: int,
              caches: List[Cache]):
    """One step: tokens (B, 1) at position ``pos`` -> (logits (B, 1,
    padded vocab) f32, caches)."""
    x, new_caches = model(tokens, caches=caches, cache_pos=pos)
    return model.logits(x), new_caches


def cache_specs(cfg: ArchConfig, batch: int, max_len: int,
                dtype=torch.bfloat16) -> list:
    """Per layer, {name: (shape, dtype)} of its cache; ``dtype`` is the
    type of the cached activations (k, v and the conv inputs), the model's
    compute type; an SSM state is always f32."""
    return [init_cache(cfg, batch, max_len, dtype) if cfg.layer_is_attn(i)
            else init_ssm_cache_spec(cfg, batch, dtype)
            for i in range(cfg.num_layers)]


def make_caches(cfg: ArchConfig, batch: int, max_len: int, device=None,
                dtype=torch.bfloat16) -> List[Cache]:
    """Zero-filled caches, one per layer, position 0."""
    out: List[Cache] = []
    for spec in cache_specs(cfg, batch, max_len, dtype):
        t = {k: torch.zeros(shape, dtype=dt, device=device)
             for k, (shape, dt) in spec.items()}
        out.append(KVCache(t["k"], t["v"], 0) if "k" in t
                   else SSMCache(t["conv"], t["state"]))
    return out
