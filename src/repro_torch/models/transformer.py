"""Decoder-only LM for serving: the dense, moe, hybrid, ssm and vlm
families.

The reference stacks each superblock position's params and scans over
them (``repro.models.transformer``); one H100 runs the layers from an
``nn.ModuleList`` in a Python loop instead, so layer ``i`` is the
reference's superblock ``i // P`` at position ``i % P`` (``_period``).
Layer ``i`` mixes with attention where ``cfg.layer_is_attn(i)`` and with
Mamba-2 elsewhere, then (outside the SSM family) runs the MoE where
``cfg.layer_is_moe(i)`` and the MLP elsewhere: jamba's schedule over its
period of 8.  Caches are a list with one entry per layer: a ``KVCache``
for an attention layer, an ``SSMCache`` for an SSM layer.  The vlm
family takes precomputed patch embeddings over the first positions of
every row and M-RoPE (t, h, w) positions.  The reference masks attention
by position (``q_pos >= k_pos``, on the t component under M-RoPE); a
prefill whose positions rise strictly along every row gets the same mask
by index, and any other (Qwen2-VL's image patches share one t) passes
its positions to every attention layer, which masks by them.  The
encoder-decoder family (whisper) is ``models.encdec``.

Training (``loss_fn``) runs the same layers with the MoE layers' aux
losses summed, each layer inside ``torch.utils.checkpoint`` (the
reference's ``remat=True`` with ``nothing_saveable``: a layer keeps only
its input, and the backward runs its forward again, launching its
kernel a second time).

Every entry point takes optional sharding ``rules``: with DTensor
parameters and inputs (``launch.dryrun``'s step, a multi-rank run) each
module pins its layouts where the reference's does and runs its kernel
on each rank's block; positions built here become replicated DTensors,
and positions given as a DTensor always mask by position (the
reference's mask), with no host read.  With ``rules=None``, or plain
tensors, nothing changes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Union

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (
    ShardingRules, is_sharded, replicated_like, tree_sds,
)
from repro_torch.launch.mesh import mesh_axis
from repro_torch.models.attention import (
    Attention, KVCache, attn_specs, cache_logical as attn_cache_logical,
    init_cache,
)
from repro_torch.models.common import (
    MLP, apply_norm, cross_entropy, embed_specs, embed_tokens, flat_specs,
    la, logits_fn, mlp_specs, over_params, param,
)
from repro_torch.models.mamba import (
    Mamba, SSMCache, init_ssm_cache_spec, ssm_cache_logical, ssm_specs,
)
from repro_torch.models.moe import MoE, moe_specs

FAMILIES = ("dense", "moe", "hybrid", "ssm", "vlm")

Cache = Union[KVCache, SSMCache]


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
    SSM family) the MoE or the MLP."""

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
            if cfg.layer_is_moe(i):
                self.moe = MoE(cfg, device)
            else:
                self.ffn = MLP(cfg, cfg.d_ff, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cache: Optional[Cache], *,
                capacity_factor: Optional[float] = None,
                mask_pos: Optional[torch.Tensor] = None,
                with_aux: bool = False,
                rules: Optional[ShardingRules] = None):
        """Returns (x, the advanced cache), and the layer's MoE aux loss
        (a zero f32 scalar without an MoE) ``with_aux``; ``mask_pos``
        reaches the attention's causal mask, ``rules`` every module."""
        h = apply_norm(self.cfg, x, self.norm1)
        if hasattr(self, "attn"):
            mix, new_c = self.attn(h, positions, cache=cache,
                                   mask_pos=mask_pos, rules=rules)
        else:
            mix, new_c = self.ssm(h, cache=cache, rules=rules)
        x = x + mix
        aux = x.new_zeros((), dtype=torch.float32) if with_aux else None
        if self.cfg.family != "ssm":
            h = apply_norm(self.cfg, x, self.norm2)
            if hasattr(self, "moe"):
                y = self.moe(h, capacity_factor=capacity_factor,
                             with_aux=with_aux, rules=rules)
                if with_aux:
                    y, aux = y
            else:
                y = self.ffn(h, rules)
            x = x + y
        return (x, new_c, aux) if with_aux else (x, new_c)


def block_specs(cfg: ArchConfig, tp: int, i: int) -> dict:
    """Layer ``i``'s params as ``Block`` holds them (the reference's
    ``_position_params`` at position ``i % P``, less the superblock
    dim)."""
    d = {"norm1": la((cfg.d_model,), (None,))}
    if cfg.layer_is_attn(i):
        d["attn"] = attn_specs(cfg, tp)
    else:
        d["ssm"] = ssm_specs(cfg)
    if cfg.family != "ssm":
        d["norm2"] = la((cfg.d_model,), (None,))
        if cfg.layer_is_moe(i):
            d["moe"] = moe_specs(cfg, tp)
        else:
            d["ffn"] = mlp_specs(cfg, cfg.d_ff)
    return d


def init_specs(cfg: ArchConfig, tp: int) -> dict:
    """Every parameter as a LogicalArray, keyed by its ``state_dict`` name
    (``layers.{i}.attn.wq``) in the reference's order: at ``tp`` 1
    the model's own shapes and types; at ``tp`` > 1 the reference's padded
    heads, kv heads, experts and vocab."""
    specs = dict(embed_specs(cfg, tp))
    for i in range(cfg.num_layers):
        specs.update(flat_specs(f"layers.{i}.", block_specs(cfg, tp, i)))
    specs["final_norm"] = la((cfg.d_model,), (None,))
    return specs


def mask_positions(positions: torch.Tensor) -> Optional[torch.Tensor]:
    """None where every row's positions (component 0 under M-RoPE) rise
    strictly, so that the index mask is the reference's positional one
    (one host read); else those positions, int32, for the mask.  A
    DTensor's positions are always returned (no host read)."""
    t = positions[..., 0] if positions.dim() == 3 else positions
    if isinstance(t, DTensor):
        return t.to(torch.int32) if t.shape[1] > 1 else None
    if t.shape[1] <= 1 or bool((t[:, 1:] > t[:, :-1]).all()):
        return None
    return t.to(torch.int32).contiguous()


class Transformer(nn.Module):
    """Embedding, ``num_layers`` blocks and the final norm; the logits read
    the untied ``unembed`` (d, padded vocab) or the embedding transposed."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        if cfg.family not in FAMILIES or cfg.is_enc_dec:
            raise ValueError(f"{cfg.name} ({cfg.family}) is no decoder-only "
                             "model: the encoder-decoder family is "
                             "models.encdec's")
        self.cfg = cfg
        pv = cfg.padded_vocab(1)
        self.embed = param(pv, cfg.d_model, device=device)
        if not cfg.tie_embeddings:
            self.unembed = param(cfg.d_model, pv, device=device)
        self.layers = nn.ModuleList(
            Block(cfg, i, device) for i in range(cfg.num_layers))
        self.final_norm = param(cfg.d_model, device=device)

    def logits(self, x: torch.Tensor,
               rules: Optional[ShardingRules] = None) -> torch.Tensor:
        return logits_fn(self.embed, getattr(self, "unembed", None), x,
                         rules)

    def forward(self, tokens: torch.Tensor, *,
                positions: Optional[torch.Tensor] = None,
                caches: Optional[List[Cache]] = None, cache_pos: int = 0,
                vision_embeds: Optional[torch.Tensor] = None,
                capacity_factor: Optional[float] = None,
                with_aux: bool = False, remat: bool = False,
                rules: Optional[ShardingRules] = None):
        """tokens (B, S) -> (x_final (B, S, d_model), new caches or None),
        and ``with_aux`` the MoE layers' aux losses summed (f32).
        ``vision_embeds``
        (B, P, d_model) replace the first P positions' embeddings.  The
        positions default to ``cache_pos`` onwards, as (B, S, 3) copies
        under M-RoPE; explicit positions that do not rise strictly along
        a row mask attention by position.  ``capacity_factor`` reaches
        every MoE layer.  ``remat`` runs each layer (without a cache)
        under ``torch.utils.checkpoint``.  ``rules``: see the module."""
        b, s = tokens.shape
        x = embed_tokens(self.embed, tokens, rules)
        sharded = is_sharded(rules, x)
        if vision_embeds is not None:
            p = vision_embeds.shape[1]
            if sharded:
                x = torch.cat([vision_embeds.to(x.dtype), x[:, p:]], 1)
            else:
                x[:, :p] = vision_embeds.to(x.dtype)
        mask_pos = None
        if positions is None:
            positions = (torch.arange(s, device=tokens.device)
                         + cache_pos).expand(b, s)
            if self.cfg.mrope_sections is not None:
                positions = positions[..., None].expand(b, s, 3)
            positions = replicated_like(positions, x)
        else:
            mask_pos = mask_positions(positions)
        new_caches = [] if caches is not None else None
        aux = x.new_zeros((), dtype=torch.float32) if with_aux else None
        for i, layer in enumerate(self.layers):
            c = caches[i] if caches is not None else None
            if isinstance(c, KVCache):          # written from cache_pos on
                c = dataclasses.replace(c, pos=cache_pos)
            kw = dict(capacity_factor=capacity_factor, mask_pos=mask_pos,
                      with_aux=with_aux, rules=rules)
            if remat and c is None:
                out = checkpoint(layer, x, positions, None,
                                 use_reentrant=False, **kw)
            else:
                out = layer(x, positions, c, **kw)
            x, c = out[:2]
            if with_aux:
                aux = aux + out[2]
            if caches is not None:
                new_caches.append(c)
        x = apply_norm(self.cfg, x, self.final_norm)
        return (x, new_caches, aux) if with_aux else (x, new_caches)


def loss_fn(model: Transformer, batch: dict, *, aux_weight: float = 0.01,
            remat: bool = True, rules: Optional[ShardingRules] = None):
    """The training loss of ``batch`` (``tokens`` and ``targets`` (B, S),
    optional ``positions`` and ``vision_embeds``): the mean cross entropy
    over the padded vocab plus ``aux_weight`` times the MoE layers' aux
    losses -> (loss, {"ce", "aux"}), f32 scalars; every layer runs under
    ``torch.utils.checkpoint`` unless ``remat`` is off."""
    x, _, aux = model(batch["tokens"], positions=batch.get("positions"),
                      vision_embeds=batch.get("vision_embeds"),
                      with_aux=True, remat=remat, rules=rules)
    ce = cross_entropy(model.logits(x, rules), batch["targets"],
                       model.cfg.vocab_size)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def prefill_fn(model: Transformer, tokens: torch.Tensor,
               caches: List[Cache], *,
               vision_embeds: Optional[torch.Tensor] = None,
               positions: Optional[torch.Tensor] = None,
               capacity_factor: Optional[float] = None,
               rules: Optional[ShardingRules] = None):
    """Populate the caches from a whole prompt (B, S), with the reference
    batch's optional ``vision_embeds`` and ``positions``; return the last
    token's f32 logits (B, 1, padded vocab) and the caches."""
    x, new_caches = model(tokens, caches=caches, cache_pos=0,
                          vision_embeds=vision_embeds, positions=positions,
                          capacity_factor=capacity_factor, rules=rules)
    return model.logits(x[:, -1:], rules), new_caches


def decode_fn(model: Transformer, tokens: torch.Tensor, pos: int,
              caches: List[Cache], *,
              rules: Optional[ShardingRules] = None):
    """One step: tokens (B, 1) at position ``pos`` -> (logits (B, 1,
    padded vocab) f32, caches).  A one-token step never drops an MoE
    assignment: its capacity is at least 1 and its k experts differ."""
    x, new_caches = model(tokens, caches=caches, cache_pos=pos, rules=rules)
    return model.logits(x, rules), new_caches


def cache_specs(cfg: ArchConfig, batch: int, max_len: int,
                dtype=torch.bfloat16) -> list:
    """Per layer, {name: (shape, dtype)} of its cache; ``dtype`` is the
    type of the cached activations (k, v and the conv inputs), the model's
    compute type; an SSM state is always f32."""
    return [init_cache(cfg, batch, max_len, dtype) if cfg.layer_is_attn(i)
            else init_ssm_cache_spec(cfg, batch, dtype)
            for i in range(cfg.num_layers)]


def cache_logical(cfg: ArchConfig, batch: int, max_len: int,
                  tp: int) -> list:
    """Per layer, its cache as LogicalArrays at tensor-parallel degree
    ``tp`` (the reference's ``cache_specs``, unstacked: its leaf at
    superblock position j holds layers j, j + P, ...)."""
    return [attn_cache_logical(cfg, batch, max_len, tp)
            if cfg.layer_is_attn(i) else ssm_cache_logical(cfg, batch)
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


# --------------------------------------------------------------------------- #
# the dry run's repeated unit
# --------------------------------------------------------------------------- #

def count_units(cfg: ArchConfig, shape, rules: ShardingRules) -> list:
    """The reference's ``[(name, fn, args, mult)]``: one superblock (the P
    layers of a period) as a step of its own, ``mult`` = superblocks - 1
    (none at one superblock).  ``args`` are meta stand-ins laid out by
    ``rules``: x (B, S, d) bf16 over ("batch", None, None) (S = 1 for
    decode), the P layers' params keyed ``{j}.{name}``, and for a serve
    step their caches (``cache_logical``'s entries).  The train unit is the
    value and the gradients (x's and the params') of sum(y) + aux through
    the layers under ``torch.utils.checkpoint``, as the step runs them; a
    serve unit runs them over the caches at position 0 (prefill) or
    ``seq_len - 1`` (decode).  The port's model is unrolled, so the dry
    run counts the whole step and records the units beside it."""
    p = _period(cfg)
    n_super = cfg.num_layers // p
    if n_super <= 1:
        return []
    tp = mesh_axis(rules.mesh, "model")
    b = shape.global_batch
    s = shape.seq_len if shape.kind != "decode" else 1
    off = shape.seq_len - 1 if shape.kind == "decode" else 0
    x_sds = la((b, s, cfg.d_model), ("batch", None, None)).sds(rules)
    lps = {f"{j}.{n}": spec for j in range(p)
           for n, spec in flat_specs("", block_specs(cfg, tp, j)).items()}
    lps_sds = tree_sds(lps, rules)
    blocks = nn.ModuleList(Block(cfg, j, "meta") for j in range(p))

    def positions_like(x):
        pos = (torch.arange(s, device=x.device) + off).expand(b, s)
        if cfg.mrope_sections is not None:
            pos = pos[..., None].expand(b, s, 3)
        return replicated_like(pos, x)

    if shape.kind == "train":
        def run(blocks, x, leaves):
            y, aux = x, None
            pos = positions_like(x)
            for blk in blocks:
                y, _, a = checkpoint(blk, y, pos, None, use_reentrant=False,
                                     with_aux=True, rules=rules)
                aux = a if aux is None else aux + a
            val = y.float().sum() + aux
            grads = torch.autograd.grad(val, [x, *leaves.values()],
                                        allow_unused=True)
            return val.detach(), grads

        def unit(x, lps):
            x = x.detach().requires_grad_(True)
            leaves = {n: t.detach().requires_grad_(True)
                      for n, t in lps.items()}
            return over_params(blocks, leaves, run, x, leaves)
        return [("superblock_train", unit, (x_sds, lps_sds), n_super - 1)]

    lcs = [attn_cache_logical(cfg, b, shape.seq_len, tp)
           if cfg.layer_is_attn(j) else ssm_cache_logical(cfg, b)
           for j in range(p)]
    lcs_sds = tree_sds(lcs, rules)

    def serve(blocks, x, lcs):
        pos = positions_like(x)
        new = []
        for blk, c in zip(blocks, lcs):
            cache = KVCache(c["k"], c["v"], off) if "k" in c \
                else SSMCache(c["conv"], c["state"])
            x, nc = blk(x, pos, cache, rules=rules)
            new.append(nc)
        return x, new

    @torch.no_grad()
    def unit(x, lps, lcs):
        return over_params(blocks, lps, serve, x, lcs)
    return [(f"superblock_{shape.kind}", unit, (x_sds, lps_sds, lcs_sds),
             n_super - 1)]
