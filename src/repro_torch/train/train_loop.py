"""Step factories over a built model: the train step (loss, gradients,
optimizer update), prefill and greedy decode, each under optional
sharding ``rules`` (the reference's factories take them; with
``rules=None``, or a model of plain tensors, a step runs as on one
card); and ``step_and_specs``, one dry-run cell's step with its inputs
as meta stand-ins."""
from __future__ import annotations

from typing import Callable

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.distributed.sharding import (
    ShardingRules, constrain, tree_sds, whole,
)
from repro_torch.launch.mesh import mesh_axis
from repro_torch.models import registry
from repro_torch.models.attention import KVCache
from repro_torch.models.common import over_params
from repro_torch.models.mamba import SSMCache
from repro_torch.models.registry import ModelBundle
from repro_torch.train.optimizer import AdamW


def make_train_step(mb: ModelBundle, model, opt, rules=None,
                    **loss_kw) -> Callable:
    """``train_step(opt_state, batch) -> (opt_state, metrics)``: the
    bundle's loss of ``batch`` under ``rules`` (``loss_kw`` passed on),
    the gradients of every named parameter (zero where the loss does not
    reach one, as the reference's ``jax.grad`` gives), and ``opt.update``
    in place on the model's parameters and the state.  The gradient of a
    DTensor parameter is laid out as the parameter.  ``metrics``:
    ``loss``, ``ce``, ``aux`` and ``grad_norm`` (the unclipped global
    norm), f32 0-dim tensors on the model's device, whole on every rank.
    Makes every parameter require its gradient."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)

    def train_step(opt_state, batch):
        loss, metrics = mb.loss_fn(model, batch, rules=rules, **loss_kw)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {n: _laid_out_as(p, g)
                 for (n, p), g in zip(params.items(), grads)}
        _, opt_state, gnorm = opt.update(grads, opt_state, params)
        metrics = {k: whole(v.detach()) for k, v in metrics.items()}
        metrics.update(loss=whole(loss.detach()), grad_norm=whole(gnorm))
        return opt_state, metrics
    return train_step


def _laid_out_as(p: torch.Tensor, g) -> torch.Tensor:
    """``p``'s gradient ``g`` in ``p``'s layout: zeros where the loss does
    not reach ``p``; a DTensor's partial sums summed and its blocks
    redistributed to ``p``'s placements."""
    if g is None:
        return torch.zeros_like(p)
    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def greedy(cfg: ArchConfig, logits: torch.Tensor,
           rules=None) -> torch.Tensor:
    """The greedy token of each row of ``logits`` (..., padded vocab) over
    the real vocab (padded columns never win); a DTensor's vocab is
    gathered whole first."""
    if isinstance(logits, DTensor):
        logits = constrain(rules, logits, "batch", None, None)
    return torch.argmax(logits[..., :cfg.vocab_size], dim=-1)


def make_prefill_step(mb: ModelBundle, model, rules=None) -> Callable:
    def prefill_step(tokens: torch.Tensor, caches, **inputs):
        """``inputs``: the prompt's other inputs (an encoder-decoder's
        ``frames``)."""
        return mb.prefill_fn(model, tokens, caches, rules=rules, **inputs)
    return prefill_step


def make_decode_step(mb: ModelBundle, model, rules=None) -> Callable:
    def decode_step(tokens: torch.Tensor, pos: int, caches):
        logits, new_caches = mb.decode_fn(model, tokens, pos, caches,
                                          rules=rules)
        return greedy(mb.cfg, logits, rules), logits, new_caches
    return decode_step


# --------------------------------------------------------------------------- #
# one dry-run cell's step over stand-ins
# --------------------------------------------------------------------------- #

def cache_objects(tree, pos: int):
    """A cache tree of tensors (``cache_specs_sds``' form) as the models'
    cache objects, the KV caches at ``pos``."""
    def one(c):
        return KVCache(c["k"], c["v"], pos) if "k" in c \
            else SSMCache(c["conv"], c["state"])
    if isinstance(tree, dict):
        return {"self": [one(c) for c in tree["self"]],
                "cross": tree["cross"]}
    return [one(c) for c in tree]


def _cache_tree(caches):
    """The models' cache objects back as a tree of tensors."""
    def one(c):
        return {"k": c.k, "v": c.v} if isinstance(c, KVCache) \
            else {"conv": c.conv, "state": c.state}
    if isinstance(caches, dict):
        return {"self": [one(c) for c in caches["self"]],
                "cross": caches["cross"]}
    return [one(c) for c in caches]


def _position(pos: torch.Tensor, shape: ShapeConfig) -> int:
    """A decode step's position: ``pos``'s value, or for a stand-in that
    holds no data (meta or fake) ``seq_len - 1``, the position
    ``registry.make_batch`` gives."""
    local = pos.to_local() if isinstance(pos, DTensor) else pos
    if local.is_meta or is_fake(local):
        return shape.seq_len - 1
    return int(local)


def step_and_specs(cfg: ArchConfig, shape: ShapeConfig, rules: ShardingRules,
                   *, optimizer=None):
    """(step_fn, args) for one dry-run cell: the args are meta stand-ins
    laid out by ``rules`` (``LogicalArray.sds``: no storage), and
    ``step_fn`` runs the port's real step over a model built on the meta
    device, its parameters swapped for the args' by
    ``torch.func.functional_call``:

    * train: ``fn(params, opt_state, batch) -> (params, opt_state,
      metrics)``: the loss under the rules, the gradients of every
      parameter, and the optimizer's update in place (AdamW unless
      ``optimizer``);
    * prefill: ``fn(params, batch, caches) -> (logits, caches)``;
    * decode: ``fn(params, batch, caches) -> (next token, logits,
      caches)``, the greedy token over the real vocab.

    ``params`` are keyed by ``state_dict`` name; the caches are
    ``registry.cache_specs_sds``' tree.  Run with DTensors (the dry run's
    fake ones, or real ones on a process group) in place of the
    stand-ins."""
    mb = registry.bundle(cfg)
    tp = mesh_axis(rules.mesh, "model")
    specs = mb.init_specs(tp)
    params_sds = tree_sds(specs, rules)
    batch_sds = registry.batch_specs(cfg, shape, rules)
    model = mb.build("meta")

    if shape.kind == "train":
        opt = optimizer or AdamW()
        opt_sds = tree_sds(opt.init_specs(specs), rules)

        def train(model, params, opt_state, batch):
            loss, metrics = mb.loss_fn(model, batch, rules=rules)
            names = list(params)
            grads = torch.autograd.grad(loss, [params[n] for n in names],
                                        allow_unused=True)
            grads = {n: torch.zeros_like(params[n]) if g is None else g
                     for n, g in zip(names, grads)}
            _, opt_state, gnorm = opt.update(grads, opt_state, params)
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics.update(loss=loss.detach(), grad_norm=gnorm)
            return params, opt_state, metrics

        def train_step(params, opt_state, batch):
            leaves = {n: p.detach().requires_grad_(p.is_floating_point())
                      for n, p in params.items()}
            return over_params(model, leaves, train, leaves, opt_state, batch)
        return train_step, (params_sds, opt_sds, batch_sds)

    cache_sds = registry.cache_specs_sds(cfg, shape, rules)
    inputs = ("vision_embeds", "positions", "frames")

    if shape.kind == "prefill":
        def prefill(model, batch, caches):
            kw = {k: batch[k] for k in inputs if k in batch}
            logits, new = mb.prefill_fn(model, batch["tokens"],
                                        cache_objects(caches, 0),
                                        rules=rules, **kw)
            return logits, _cache_tree(new)

        @torch.no_grad()
        def prefill_step(params, batch, caches):
            return over_params(model, params, prefill, batch, caches)
        return prefill_step, (params_sds, batch_sds, cache_sds)

    def decode(model, batch, caches):
        pos = _position(batch["pos"], shape)
        logits, new = mb.decode_fn(model, batch["tokens"], pos,
                                   cache_objects(caches, pos), rules=rules)
        return greedy(cfg, logits, rules), logits, _cache_tree(new)

    @torch.no_grad()
    def decode_step(params, batch, caches):
        return over_params(model, params, decode, batch, caches)
    return decode_step, (params_sds, batch_sds, cache_sds)
