"""Step factories over a built model: the train step (loss, gradients,
optimizer update), prefill and greedy decode."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.registry import ModelBundle


def make_train_step(mb: ModelBundle, model, opt, **loss_kw) -> Callable:
    """``train_step(opt_state, batch) -> (opt_state, metrics)``: the
    bundle's loss of ``batch`` (``loss_kw`` passed on), the gradients of
    every named parameter (zero where the loss does not reach one, as the
    reference's ``jax.grad`` gives), and ``opt.update`` in place on the
    model's parameters and the state.  ``metrics``: ``loss``, ``ce``,
    ``aux`` and ``grad_norm`` (the unclipped global norm), f32 0-dim
    tensors on the model's device.  Makes every parameter require its
    gradient."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)

    def train_step(opt_state, batch):
        loss, metrics = mb.loss_fn(model, batch, **loss_kw)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(params.items(), grads)}
        _, opt_state, gnorm = opt.update(grads, opt_state, params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(loss=loss.detach(), grad_norm=gnorm)
        return opt_state, metrics
    return train_step


def make_prefill_step(mb: ModelBundle, model) -> Callable:
    def prefill_step(tokens: torch.Tensor, caches, **inputs):
        """``inputs``: the prompt's other inputs (an encoder-decoder's
        ``frames``)."""
        return mb.prefill_fn(model, tokens, caches, **inputs)
    return prefill_step


def make_decode_step(mb: ModelBundle, model) -> Callable:
    def decode_step(tokens: torch.Tensor, pos: int, caches):
        logits, new_caches = mb.decode_fn(model, tokens, pos, caches)
        # greedy token for the serving loop; padded vocab columns never win
        next_tok = torch.argmax(logits[..., :mb.cfg.vocab_size], dim=-1)
        return next_tok, logits, new_caches
    return decode_step
