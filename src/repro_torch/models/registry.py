"""Model registry: one entry point per servable architecture.

``bundle(cfg)`` returns how to build the model on a device, its
parameter specs (shapes, logical axes, types), its training loss and its prefill and decode functions: the encoder-decoder family's
(``models.encdec``) or the decoder-only families' (``models.transformer``).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, transformer


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig
    build: Callable           # (device) -> the model, weights uninitialised
    init_specs: Callable      # (tp) -> {state_dict name: LogicalArray}
    loss_fn: Callable         # (model, batch, **kw) -> (loss, {"ce", "aux"})
    prefill_fn: Callable      # (model, tokens, caches, **inputs) -> (logits,
                              #  caches); inputs: vision_embeds, positions,
                              #  capacity_factor, or an enc-dec's frames
    decode_fn: Callable       # (model, tokens, pos, caches) -> (logits, caches)


def bundle(cfg: ArchConfig) -> ModelBundle:
    if cfg.is_enc_dec:
        return ModelBundle(cfg=cfg, build=partial(encdec.EncoderDecoder, cfg),
                           init_specs=partial(encdec.init_specs, cfg),
                           loss_fn=encdec.loss_fn,
                           prefill_fn=encdec.prefill_fn,
                           decode_fn=encdec.decode_fn)
    return ModelBundle(
        cfg=cfg,
        build=partial(transformer.Transformer, cfg),
        init_specs=partial(transformer.init_specs, cfg),
        loss_fn=transformer.loss_fn,
        prefill_fn=transformer.prefill_fn,
        decode_fn=transformer.decode_fn,
    )


def make_cache(cfg: ArchConfig, batch: int, max_len: int, device=None,
               dtype=torch.bfloat16, enc_len: Optional[int] = None):
    """Zero-filled caches for ``batch`` sequences of up to ``max_len``,
    activations cached in ``dtype`` (the model's compute type); an
    encoder-decoder's cross cache holds ``enc_len`` frames (its config's
    ``n_audio_frames`` when None)."""
    if cfg.is_enc_dec:
        return encdec.make_caches(
            cfg, batch, max_len,
            cfg.n_audio_frames if enc_len is None else enc_len, device, dtype)
    return transformer.make_caches(cfg, batch, max_len, device, dtype)
