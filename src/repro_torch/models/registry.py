"""Model registry: one entry point per servable architecture.

``bundle(cfg)`` returns how to build the model on a device and its
prefill and decode functions; a family this port does not serve yet
raises ``NotImplementedError`` (it never runs a substitute).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig
    build: Callable           # (device) -> Transformer, weights uninitialised
    prefill_fn: Callable      # (model, tokens, caches, *, vision_embeds,
                              #  positions) -> (logits, caches)
    decode_fn: Callable       # (model, tokens, pos, caches) -> (logits, caches)


def bundle(cfg: ArchConfig) -> ModelBundle:
    transformer.check_family(cfg)
    return ModelBundle(
        cfg=cfg,
        build=partial(transformer.Transformer, cfg),
        prefill_fn=transformer.prefill_fn,
        decode_fn=transformer.decode_fn,
    )


def make_cache(cfg: ArchConfig, batch: int, max_len: int, device=None,
               dtype=torch.bfloat16):
    """Zero-filled caches for ``batch`` sequences of up to ``max_len``,
    activations cached in ``dtype`` (the model's compute type)."""
    return transformer.make_caches(cfg, batch, max_len, device, dtype)
