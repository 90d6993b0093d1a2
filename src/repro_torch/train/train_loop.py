"""Serve-step factories: prefill and greedy decode over a built model."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.registry import ModelBundle


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
