"""Shared model primitives: parameter specs (``la``, the embedding's and
the MLP's), the init rule, parameters onto a mesh (``distribute``),
norms, RoPE and M-RoPE, logits over a padded vocab and the loss over
them, and the gated and plain MLPs.

Matmuls run in the param dtype (bf16); norms, RoPE angles, softmax and
logits accumulate in f32, as in the reference (``repro.models.common``).
Given sharding ``rules`` and DTensor activations, the embedding, the
logits and the MLP pin their layouts where the reference's do, and the
constants built here (RoPE positions, the padded-vocab mask) become
replicated DTensors beside a DTensor input.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial
from torch.func import functional_call

from repro_torch.distributed.sharding import (
    LogicalArray, ShardingRules, dim_block, from_whole, is_sharded,
    on_shards, replicated_like, validate_divisibility,
)
from repro_torch.launch.mesh import axis_names

PARAM_DTYPE = torch.bfloat16
INIT_SCALE = 0.02


# --------------------------------------------------------------------------- #
# parameter specs: each module's params as LogicalArrays (the reference's
# ``la`` leaves), keyed as the module's ``named_parameters`` names them
# --------------------------------------------------------------------------- #

def la(shape, logical, dtype=PARAM_DTYPE) -> LogicalArray:
    if len(shape) != len(logical):
        raise ValueError(f"shape {shape} against logical dims {logical}")
    return LogicalArray(tuple(int(s) for s in shape), tuple(logical), dtype)


def flat_specs(prefix: str, tree: dict) -> dict:
    """Nested spec dicts as one dict of dotted ``state_dict`` names."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_specs(f"{prefix}{k}.", v))
        else:
            out[f"{prefix}{k}"] = v
    return out


def embed_specs(cfg, tp: int) -> dict:
    """``embed`` (padded vocab, d) and, untied, ``unembed`` (d, padded
    vocab)."""
    pv = cfg.padded_vocab(tp)
    p = {"embed": la((pv, cfg.d_model), ("vocab", "fsdp"))}
    if not cfg.tie_embeddings:
        p["unembed"] = la((cfg.d_model, pv), ("fsdp", "vocab"))
    return p


def mlp_specs(cfg, d_ff: int) -> dict:
    """``MLP``'s params: gate and up fused into ``w_in`` (d, 2, f), or
    ``w_up``, then ``w_down``."""
    if cfg.gated_ffn:
        return {"w_in": la((cfg.d_model, 2, d_ff), ("fsdp", None, "mlp")),
                "w_down": la((d_ff, cfg.d_model), ("mlp", "fsdp"))}
    return {"w_up": la((cfg.d_model, d_ff), ("fsdp", "mlp")),
            "w_down": la((d_ff, cfg.d_model), ("mlp", "fsdp"))}


class _Call(nn.Module):
    """Holds a module so that ``functional_call`` swaps its parameters for
    the whole of a function of it (a backward and an update too)."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module

    def forward(self, fn, *args):
        return fn(self.module, *args)


def over_params(module: nn.Module, params: dict, fn, *args):
    """``fn(module, *args)`` with every parameter of ``module`` (a model
    built on the meta device) swapped for ``params``' tensor of its
    ``named_parameters`` name, by ``torch.func.functional_call``."""
    return functional_call(_Call(module), {f"module.{n}": p
                                           for n, p in params.items()},
                           (fn, *args), strict=True)


def param(*shape: int, dtype=PARAM_DTYPE, device=None) -> nn.Parameter:
    """An uninitialised serving parameter (no gradient)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator,
                init_scale: float = INIT_SCALE) -> None:
    """The reference's init rule (``materialize``): 1-D params are zeros
    (norms use the (1 + scale) form, so zero is the identity); every other
    param is ``normal * min(init_scale, 1 / sqrt(fan_in))`` with fan_in the
    product of all but the last dim, drawn in f32 from ``generator`` on the
    param's device in the order of ``named_parameters``.  The reference
    applies the rule to its superblock-stacked arrays; here every layer's
    params are unstacked, so a layer's norm scales are 1-D and zero."""
    for _, p in module.named_parameters():
        if p.dim() <= 1:
            p.zero_()
            continue
        fan_in = float(math.prod(p.shape[:-1])) or 1.0
        scale = min(init_scale, 1.0 / math.sqrt(fan_in))
        p.copy_(scale * torch.randn(p.shape, generator=generator,
                                    dtype=torch.float32, device=p.device))


@torch.no_grad()
def distribute(model: nn.Module, specs: dict, rules: ShardingRules) -> None:
    """Each parameter of ``model`` (drawn whole and equal on every rank)
    replaced, one at a time, by an ``nn.Parameter`` holding the DTensor of
    this rank's block, laid out by ``rules.placements`` of its spec's
    logical dims (``specs``: ``init_specs``' LogicalArrays by name); the
    whole tensor is dropped as its block takes its place, so a rank never
    holds two whole copies.  A spec whose shape is not the parameter's
    (heads, experts or vocab padded for the mesh), or a split dim the
    mesh axis does not divide, raises: nothing is padded here."""
    problems = validate_divisibility(specs, rules)
    if problems:
        raise ValueError(f"{model.cfg.name} does not split over "
                         f"{axis_names(rules.mesh)}: {problems}")
    for name in [n for n, _ in model.named_parameters()]:
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner)
        p, la = getattr(module, leaf), specs[name]
        if tuple(p.shape) != la.shape:
            raise ValueError(f"{name}: the model holds {tuple(p.shape)}, "
                             f"the specs {la.shape}")
        block = from_whole(p.detach(), rules.mesh,
                           rules.placements(*la.logical))
        setattr(module, leaf, nn.Parameter(block,
                                           requires_grad=p.requires_grad))


# --------------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------------- #

def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor,
              bias: Optional[torch.Tensor] = None,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * (1.0 + scale.float())
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def apply_norm(cfg, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return rmsnorm(x, scale) if cfg.norm == "rmsnorm" else layernorm(x, scale)


# --------------------------------------------------------------------------- #
# RoPE (standard, partial, and qwen2-vl's M-RoPE)
# --------------------------------------------------------------------------- #

def _rope_freqs(dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rotary_pct: float = 1.0,
               mrope_sections: Optional[tuple[int, int, int]] = None
               ) -> torch.Tensor:
    """x (B, S, H, D); positions (B, S) integers, or (B, S, 3) for M-RoPE.
    The first ``rotary_pct`` of each head rotates (rotate-half form), the
    rest passes through.  With ``mrope_sections`` (t, h, w) each frequency
    index takes the position component its section names, in order;
    without them a (B, S, 3) position rotates by its component 0."""
    d = x.shape[-1]
    rot = int(d * rotary_pct)
    rot -= rot % 2
    half = rot // 2
    freqs = replicated_like(_rope_freqs(rot, theta, x.device), x)
    positions = replicated_like(positions, x)
    if mrope_sections is not None:
        if positions.dim() != 3 or sum(mrope_sections) != half:
            raise ValueError(f"M-RoPE needs (B, S, 3) positions and sections "
                             f"summing to {half}, got positions "
                             f"{tuple(positions.shape)}, {mrope_sections}")
        # each section's component widened to its frequencies: slices of
        # the positions, with no host copy and no read of a device size
        pos = positions.float()
        angles = torch.cat([pos[..., j:j + 1].expand(*pos.shape[:-1], n)
                            for j, n in enumerate(mrope_sections)],
                           -1) * freqs
    else:
        if positions.dim() == 3:
            positions = positions[..., 0]
        angles = positions.float()[..., None] * freqs      # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:rot].float()
    y = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).to(x.dtype)
    if rot < d:
        y = torch.cat([y, x[..., rot:]], -1)
    return y


# --------------------------------------------------------------------------- #
# logits over a padded vocab
# --------------------------------------------------------------------------- #

def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor,
                 rules: Optional[ShardingRules] = None) -> torch.Tensor:
    """tokens (B, S) -> their rows of the table (B, S, d).  Under
    ``rules`` each rank looks its batch rows up in its block of the vocab
    (a row outside it reads zeros), and the blocks' rows sum over the
    vocab's mesh axis."""
    if not is_sharded(rules, embed):
        return F.embedding(tokens, embed)
    rows = dim_block(rules, embed.shape[0], "vocab")

    def local(tokens, table):
        t = tokens.long() - rows.start
        inside = (t >= 0) & (t < table.shape[0])
        x = F.embedding(torch.where(inside, t, 0), table)
        return x * inside[..., None].to(x.dtype)

    out = tuple(Partial() if n == rules.vocab else p for n, p in
                zip(axis_names(rules.mesh),
                    rules.placements("batch", None, None)))
    x = on_shards(rules, local, (out,), (("batch", None), ("vocab", None)),
                  tokens, embed)
    return rules.constrain(x, "batch", None, None)


def logits_fn(embed: torch.Tensor, unembed: Optional[torch.Tensor],
              x: torch.Tensor,
              rules: Optional[ShardingRules] = None) -> torch.Tensor:
    """x (B, S, d) -> f32 logits (B, S, padded vocab): bf16 products summed
    in f32, as the reference's ``preferred_element_type=float32``; a tied
    model reads the embedding table transposed."""
    table = embed.t() if unembed is None else unembed
    logits = x.float() @ table.float()
    return rules.constrain(logits, "batch", None, "vocab") \
        if is_sharded(rules, logits) else logits


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  vocab_size: int, z_loss: float = 0.0) -> torch.Tensor:
    """The mean token loss, f32: logits (B, S, padded vocab), targets (B,
    S) integer.  Columns past ``vocab_size`` are masked to -1e30 before
    the logsumexp; a token's loss is the logsumexp less its gold logit,
    plus ``z_loss`` times the squared logsumexp where that is non-zero
    (the reference's ``common.cross_entropy``)."""
    logits = logits.float()
    pv = logits.shape[-1]
    if pv > vocab_size:
        keep = torch.arange(pv, device=logits.device) < vocab_size
        logits = torch.where(replicated_like(keep, logits), logits, -1e30)
    lse = torch.logsumexp(logits, -1)
    if isinstance(logits, DTensor):
        # a gather along a split vocab has no DTensor layout: the gold
        # logit as a masked sum, each rank's columns a partial sum
        cols = replicated_like(torch.arange(pv, device=logits.device), logits)
        gold = torch.where(cols == targets.long()[..., None], logits,
                           0.0).sum(-1)
    else:
        gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    loss = lse - gold
    if z_loss:
        loss = loss + z_loss * lse.square()
    return loss.mean()


# --------------------------------------------------------------------------- #
# MLP
# --------------------------------------------------------------------------- #

def _act(cfg, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if cfg.activation == "silu" else \
        F.gelu(x, approximate="tanh")


class MLP(nn.Module):
    """Gated (SwiGLU, gate and up fused into one (d, 2, f) weight) or plain
    two-matrix MLP, by the config's activation."""

    def __init__(self, cfg, d_ff: int, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        if cfg.gated_ffn:
            self.w_in = param(d, 2, d_ff, device=device)
        else:
            self.w_up = param(d, d_ff, device=device)
        self.w_down = param(d_ff, d, device=device)

    def forward(self, x: torch.Tensor,
                rules: Optional[ShardingRules] = None) -> torch.Tensor:
        sharded = is_sharded(rules, x)
        if self.cfg.gated_ffn and sharded:
            # d_ff splits over the mesh: gate and up as two products (a
            # (2, f) -> 2 f reshape of a split f has no DTensor layout)
            h = _act(self.cfg, x @ self.w_in[:, 0]) * (x @ self.w_in[:, 1])
        elif self.cfg.gated_ffn:
            d, _, f = self.w_in.shape
            gu = (x @ self.w_in.reshape(d, 2 * f)).unflatten(-1, (2, f))
            h = _act(self.cfg, gu[..., 0, :]) * gu[..., 1, :]
        else:
            h = _act(self.cfg, x @ self.w_up)
        if not sharded:
            return h @ self.w_down
        h = rules.constrain(h, "batch", None, "mlp")
        return rules.constrain(h @ self.w_down, "batch", None, None)
