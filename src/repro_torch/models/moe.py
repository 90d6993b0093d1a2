"""Mixture-of-Experts layer with GShard-style capacity dispatch, for serving.

The reference (``repro.models.moe``) computes the routing, the dispatch,
the expert products and the combine in plain jnp, outside any kernel; the
port computes them in plain torch, the expert products as batched matmuls
over the experts.  As in the reference, dispatch is per batch row: an
assignment's position in its expert is its rank among the row's
assignments to that expert, in the order of the row's (S * k) flattened
ids, and an assignment at or past the capacity ``c`` is dropped (its gate
is zeroed).  Kept assignments are copied into one (E, B, C) slot buffer
whose spare last row takes every dropped one, the experts' gated FFN runs
over all slots, and each token sums its kept slots' outputs times their
gates in the activation type; a dropped assignment reads the last slot's
output times its zero gate.  Every step is out of place, so a trainer
differentiates the layer as it stands.  One device holds every expert, so the
reference's padded experts never arise (``padded_experts(1)`` is the
expert count).

Given sharding ``rules`` and a DTensor input (weights laid out at the
mesh's tensor-parallel degree, experts padded to a multiple of it), the
layer runs on each rank's block (``sharding.on_shards``): every rank
routes its batch rows over all the (padded) experts, padded experts
masked out of the softmax as the reference masks them; the aux loss
takes the batch means of its counts and probabilities as each rank's
share, summed over the mesh; the rank keeps the slots of the experts it
holds (experts on ``model``), runs their FFN and combines their outputs
into a partial y that sums over ``model`` (the reference's activation
psum).  Shared experts are the MLP over the DTensor.  It is the one-card
body: one card is the rank that holds every expert (``dispatch`` with
``own`` None).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.distributed.tensor import Partial

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (
    ShardingRules, active, constrain, dim_block, on_shards,
)
from repro_torch.launch.mesh import axis_names
from repro_torch.models.common import MLP, _act, la, mlp_specs, param


def moe_specs(cfg: ArchConfig, tp: int = 1) -> dict:
    """``MoE``'s params at tensor-parallel degree ``tp``: experts padded as
    the config pads them (the model itself holds the unpadded count,
    ``padded_experts(1)``)."""
    e, d, f = cfg.padded_experts(tp), cfg.d_model, cfg.moe_d_ff
    p = {
        "router": la((d, e), (None, None), torch.float32),
        "w_in": la((e, d, 2, f), ("experts", "fsdp", None, "moe_mlp")),
        "w_down": la((e, f, d), ("experts", "moe_mlp", "fsdp")),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_specs(cfg, cfg.n_shared_experts * cfg.moe_d_ff)
    return p


def capacity(cfg: ArchConfig, seq: int,
             capacity_factor: Optional[float] = None) -> int:
    """Slots per expert and batch row for ``seq`` tokens: the reference's
    rule, capacity factor 1.0 for a top-1 router and 1.25 otherwise, and
    ``c = max(ceil(cf * seq * k / E), 1)``."""
    if capacity_factor is None:
        capacity_factor = 1.0 if cfg.top_k == 1 else 1.25
    c = int(-(-capacity_factor * seq * cfg.top_k // cfg.n_experts))
    return max(c, 1)


def batch_means(probs: torch.Tensor, ids: torch.Tensor) -> tuple:
    """The aux loss's batch means of a routing (``MoE.route``'s probs
    (B, S, E) and ids (B, S, k)): each expert's assignments a row, over the
    rows, and its probability, over the rows and positions; each (E,)
    f32."""
    b, s, k = ids.shape
    e = probs.shape[-1]
    counts = torch.zeros(b, e, dtype=torch.float32, device=probs.device)
    counts.scatter_add_(1, ids.reshape(b, s * k),
                        torch.ones(b, s * k, device=probs.device))
    return counts.mean(0), probs.mean((0, 1))


def aux_loss(probs: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The Switch / GShard load-balance loss of a routing (``MoE.route``'s
    probs (B, S, E) and ids (B, S, k)), from per-row assignment counts: the
    f32 scalar the reference's ``moe_apply`` returns beside y for its
    trainer, and ``MoE.forward`` with ``with_aux``.  The gradient reaches
    the router through the mean probabilities only."""
    mean_counts, mean_probs = batch_means(probs, ids)
    return probs.shape[-1] * torch.sum(mean_counts / ids.shape[1]
                                       * mean_probs)


def positions_in_expert(ids: torch.Tensor) -> torch.Tensor:
    """ids (B, S, k) -> each assignment's rank among the assignments of its
    row to the same expert, in the row's flattened (s, k) order: a stable
    sort of the row's ids, then each index less the start of its run."""
    b, s, k = ids.shape
    flat = ids.reshape(b, s * k)
    sorted_e, order = torch.sort(flat, dim=-1, stable=True)
    idx = torch.arange(s * k, device=ids.device).expand(b, s * k)
    is_start = torch.ones_like(flat, dtype=torch.bool)
    is_start[:, 1:] = sorted_e[:, 1:] != sorted_e[:, :-1]
    run_start = torch.cummax(torch.where(is_start, idx, 0), dim=-1).values
    pos = torch.empty_like(flat).scatter_(1, order, idx - run_start)
    return pos.reshape(b, s, k)


def dispatch(cfg: ArchConfig, x: torch.Tensor, gate: torch.Tensor,
             ids: torch.Tensor, w_in: torch.Tensor, w_down: torch.Tensor,
             c: int, own: Optional[slice] = None) -> torch.Tensor:
    """x (B, S, d) through the experts of its routing (gate, ids (B, S, k)),
    ``c`` slots an expert and row -> y (B, S, d) in x's type.  ``w_in``
    (E', d, 2, f) and ``w_down`` (E', f, d) hold every expert (``own``
    None, one card) or the block ``own`` of them: its assignments alone
    are run and combined, and y is the block's part of the sum."""
    b, s, d = x.shape
    k, f = cfg.top_k, cfg.moe_d_ff
    el = w_in.shape[0]
    pos = positions_in_expert(ids)
    keep = pos < c
    if own is not None:
        ids = ids - own.start
        keep = keep & (ids >= 0) & (ids < el)
    bi = torch.arange(b, device=x.device)[:, None, None]
    # slot (expert, row, position) of a kept assignment; the spare slot
    # el * b * c takes the dropped ones and stays out of the products
    slot = torch.where(keep, (ids * b + bi) * c + pos, el * b * c)
    buf = x.new_zeros(el * b * c + 1, d)
    buf[slot.reshape(-1)] = x.unsqueeze(2).expand(b, s, k, d).reshape(
        -1, d)
    gu = torch.bmm(buf[:-1].view(el, b * c, d),
                   w_in.reshape(el, d, 2 * f)).unflatten(-1, (2, f))
    h = _act(cfg, gu[..., 0, :]) * gu[..., 1, :]
    out = torch.bmm(h, w_down).view(el * b * c, d)
    # combine: each token's kept outputs times their gates (zero where
    # dropped, which read the last slot) in x's type, summed over its
    # k assignments
    return (out[slot.clamp(max=el * b * c - 1)]
            * (gate * keep).to(x.dtype)[..., None]).sum(2)


class MoE(nn.Module):
    """Top-k routed experts (gated FFNs of width ``moe_d_ff``) and, where
    the config has them, shared experts; weights in the reference's layout:
    router (d, E) in f32, w_in (E, d, 2, f), w_down (E, f, d)."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.cfg = cfg
        e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
        self.router = param(d, e, dtype=torch.float32, device=device)
        self.w_in = param(e, d, 2, f, device=device)
        self.w_down = param(e, f, d, device=device)
        if cfg.n_shared_experts:
            self.shared = MLP(cfg, cfg.n_shared_experts * cfg.moe_d_ff, device)

    def route(self, x: torch.Tensor, router: Optional[torch.Tensor] = None):
        """x (B, S, d) -> (probs (B, S, E) f32, gate (B, S, k) f32
        renormalised over the top k, ids (B, S, k) in descending order of
        probability).  A ``router`` wider than the config's experts (padded)
        masks its padded columns to -1e30 before the softmax."""
        router = self.router if router is None else router
        logits = x.float() @ router
        if router.shape[-1] > self.cfg.n_experts:
            real = torch.arange(router.shape[-1], device=x.device) \
                < self.cfg.n_experts
            logits = torch.where(real, logits, -1e30)
        probs = torch.softmax(logits, dim=-1)
        gate, ids = torch.topk(probs, self.cfg.top_k, dim=-1)
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
        return probs, gate, ids

    def forward(self, x: torch.Tensor, *,
                capacity_factor: Optional[float] = None,
                with_aux: bool = False,
                rules: Optional[ShardingRules] = None):
        """x (B, S, d) -> y (B, S, d) in x's type, or (y, the aux loss)
        ``with_aux``; ``rules`` lay a DTensor ``x``'s step out (see the
        module)."""
        cfg = self.cfg
        s = x.shape[1]
        c = capacity(cfg, s, capacity_factor)
        rules = active(rules, x)
        own, ranks, outs, ins = None, 1, None, None
        if rules is not None:
            own = dim_block(rules, self.w_in.shape[0], "experts")
            ranks = rules.mesh.size()
            names = axis_names(rules.mesh)
            y_pl = tuple(Partial() if n == rules.experts else p for n, p in
                         zip(names, rules.placements("batch", None, None)))
            # the batch means sum over every axis: the data axes' ranks
            # hold parts of the batch, the others the same part again
            mean_pl = (Partial(),) * len(names)
            outs = (y_pl, mean_pl, mean_pl) if with_aux else (y_pl,)
            ins = (("batch", None, None), (None, None),
                   ("experts", None, None, None), ("experts", None, None))

        def local(x, router, w_in, w_down):
            # one card routes through route(x), which a test may replace
            probs, gate, ids = self.route(x) if rules is None else \
                self.route(x, router)
            y = dispatch(cfg, x, gate, ids, w_in, w_down, c, own)
            if not with_aux:
                return y
            means = batch_means(probs, ids)
            # each rank's share of the batch means (see on_shards: y is
            # split, so a mean every rank computes is a share too)
            return (y, *means) if ranks == 1 else \
                (y, *(m / ranks for m in means))

        res = on_shards(rules, local, outs, ins, x, self.router, self.w_in,
                        self.w_down)
        if with_aux:
            y, mean_counts, mean_probs = res
            aux = cfg.n_experts * torch.sum(mean_counts / s * mean_probs)
        else:
            y, aux = res, None
        y = constrain(rules, y, "batch", None, None)
        if cfg.n_shared_experts:
            y = y + self.shared(x, rules)
        return (y, aux) if with_aux else y
