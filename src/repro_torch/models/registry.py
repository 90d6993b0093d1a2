"""Model registry: one entry point per servable architecture.

``bundle(cfg)`` returns how to build the model on a device, its
parameter specs (shapes, logical axes, types), its training loss, its
prefill and decode functions, its caches as LogicalArrays and its
repeated units for the dry run: the encoder-decoder family's
(``models.encdec``) or the decoder-only families' (``models.transformer``).

``batch_specs`` and ``cache_specs_sds`` give a step's inputs as meta
stand-ins laid out by sharding rules (no storage): what
``train.train_loop.step_and_specs`` hands the dry run.  ``make_batch``
and ``make_cache(cfg, shape, rules)`` give real small tensors of the same
shapes and types.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.distributed.sharding import (
    LogicalArray, ShardingRules, local_block, of_block, tree_map, tree_sds,
)
from repro_torch.device import resolve
from repro_torch.launch.mesh import mesh_axis
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
    cache_logical: Callable   # (batch, max_len, tp, shape) -> LogicalArray
                              #  tree
    count_units: Callable     # (shape, rules) -> [(name, fn, args, mult)]


def bundle(cfg: ArchConfig) -> ModelBundle:
    if cfg.is_enc_dec:
        return ModelBundle(
            cfg=cfg, build=partial(encdec.EncoderDecoder, cfg),
            init_specs=partial(encdec.init_specs, cfg),
            loss_fn=encdec.loss_fn, prefill_fn=encdec.prefill_fn,
            decode_fn=encdec.decode_fn,
            cache_logical=lambda b, s, tp, shape: encdec.cache_logical(
                cfg, b, s, tp, enc_len=shape.seq_len),
            count_units=partial(encdec.count_units, cfg))
    return ModelBundle(
        cfg=cfg,
        build=partial(transformer.Transformer, cfg),
        init_specs=partial(transformer.init_specs, cfg),
        loss_fn=transformer.loss_fn,
        prefill_fn=transformer.prefill_fn,
        decode_fn=transformer.decode_fn,
        cache_logical=lambda b, s, tp, shape: transformer.cache_logical(
            cfg, b, s, tp),
        count_units=partial(transformer.count_units, cfg),
    )


# --------------------------------------------------------------------------- #
# a step's inputs as stand-ins laid out by the rules, and real small ones
# --------------------------------------------------------------------------- #

def batch_logical(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """The step's data inputs as LogicalArrays (the reference's
    ``batch_specs``, less the sharding)."""
    b, s = shape.global_batch, shape.seq_len
    tok = ("batch", None)
    if shape.kind == "train":
        specs = {"tokens": LogicalArray((b, s), tok, torch.int32),
                 "targets": LogicalArray((b, s), tok, torch.int32)}
    elif shape.kind == "prefill":
        specs = {"tokens": LogicalArray((b, s), tok, torch.int32)}
    else:  # decode: one new token against a seq_len KV cache
        specs = {"tokens": LogicalArray((b, 1), tok, torch.int32),
                 "pos": LogicalArray((), (), torch.int32)}
    wide = ("batch", None, None)
    if cfg.family == "vlm" and shape.kind != "decode":
        specs["vision_embeds"] = LogicalArray(
            (b, min(cfg.n_vision_patches, s), cfg.d_model), wide,
            torch.bfloat16)
        specs["positions"] = LogicalArray((b, s, 3), wide, torch.int32)
    if cfg.is_enc_dec and shape.kind != "decode":
        specs["frames"] = LogicalArray((b, s, cfg.d_model), wide,
                                       torch.bfloat16)
    return specs


def batch_specs(cfg: ArchConfig, shape: ShapeConfig, rules: ShardingRules):
    """Meta stand-ins for the step's data inputs, each carrying its
    ``device_mesh`` and ``placements``."""
    return tree_sds(batch_logical(cfg, shape), rules)


def cache_logical(cfg: ArchConfig, shape: ShapeConfig,
                  rules: ShardingRules):
    """The serve step's caches as LogicalArrays at the rules' tensor-parallel
    degree (None for train)."""
    if shape.kind == "train":
        return None
    tp = mesh_axis(rules.mesh, "model")
    return bundle(cfg).cache_logical(shape.global_batch, shape.seq_len, tp,
                                     shape)


def cache_specs_sds(cfg: ArchConfig, shape: ShapeConfig,
                    rules: ShardingRules):
    """Meta stand-ins for the serve step's caches (None for train)."""
    tree = cache_logical(cfg, shape, rules)
    return None if tree is None else tree_sds(tree, rules)


def make_batch(cfg: ArchConfig, shape: ShapeConfig, rules: ShardingRules,
               generator: torch.Generator) -> dict:
    """Real (small) tensors matching ``batch_specs``, drawn from
    ``generator`` on its device: tokens uniform over the vocab, floats
    normal at scale 0.02 in their type, ``pos`` = ``seq_len - 1`` and
    ``positions`` the arange over the sequence in each row and component,
    as the reference's ``make_batch``."""
    dev = generator.device
    out = {}
    for k, la in batch_logical(cfg, shape).items():
        if la.dtype == torch.int32:
            if k == "pos":
                out[k] = torch.tensor(shape.seq_len - 1, dtype=torch.int32,
                                      device=dev)
            elif k == "positions":
                base = torch.arange(la.shape[1], dtype=torch.int32,
                                    device=dev)
                out[k] = base[None, :, None].expand(la.shape).contiguous()
            else:
                out[k] = torch.randint(0, cfg.vocab_size, la.shape,
                                       generator=generator, device=dev,
                                       dtype=torch.int32)
        else:
            out[k] = (0.02 * torch.randn(la.shape, generator=generator,
                                         device=dev)).to(la.dtype)
    return out


def make_cache(cfg: ArchConfig, batch, max_len=None, device=None,
               dtype=torch.bfloat16, enc_len: Optional[int] = None):
    """Zero-filled caches for ``batch`` sequences of up to ``max_len``,
    activations cached in ``dtype`` (the model's compute type); an
    encoder-decoder's cross cache holds ``enc_len`` frames (its config's
    ``n_audio_frames`` when None).

    ``make_cache(cfg, shape, rules, device=None)``, with a ShapeConfig,
    gives the reference's form instead: ``cache_specs_sds``' tree filled
    with zeros on ``device`` (the card unless named), its bf16 leaves in
    ``dtype``, None for train.  Over a ``DeviceMesh`` each leaf is the
    DTensor of this rank's block of zeros, laid out by its
    LogicalArray."""
    if isinstance(batch, ShapeConfig):
        tree = cache_logical(cfg, batch, max_len)
        if tree is None:
            return None
        dev = resolve(device)
        mesh = max_len.mesh

        def zeros(_, la):
            dt = dtype if la.dtype == torch.bfloat16 else la.dtype
            if not isinstance(mesh, DeviceMesh):
                return torch.zeros(la.shape, dtype=dt, device=dev)
            placements = max_len.placements(*la.logical)
            block = local_block(la.shape, mesh, placements)
            local = torch.zeros([s.stop - s.start for s in block], dtype=dt,
                                device=dev)
            return of_block(local, mesh, placements, la.shape)
        return tree_map(zeros, tree)
    if cfg.is_enc_dec:
        return encdec.make_caches(
            cfg, batch, max_len,
            cfg.n_audio_frames if enc_len is None else enc_len, device, dtype)
    return transformer.make_caches(cfg, batch, max_len, device, dtype)
