"""Whisper-style encoder-decoder (the audio family) for serving.

The counterpart of ``repro.models.encdec``.  As there, the conv frontend
is a stub: the encoder takes precomputed frame embeddings (B, S_enc,
d_model).  Positions are absolute and sinusoidal (computed, not stored);
attention has no RoPE; layers are pre-LayerNorm with a plain GELU MLP,
biases omitted.  The reference stacks each stack's layer params and
scans over them; here each stack is an ``nn.ModuleList``.

Serving: ``prefill_fn`` encodes the frames (non-causal self-attention,
one flash-attention launch a layer on the card), computes every decoder
layer's cross k and v from the encoder output (the cross cache,
(L, B, S_enc, KV, hd) in the model's type, as the reference's
``_cross_kv`` stacks them), then runs the decoder over the prompt:
causal self-attention through the KV cache and cross-attention to the
frames, each a launch a layer.  ``decode_fn`` takes one token against
both caches.  The caches are ``{"self": [KVCache per decoder layer],
"cross": {"k", "v"}}``.

Training (``loss_fn``): the encoder over the frames, then the decoder
over the tokens with no cache, each decoder layer computing its cross k
and v from the encoder output itself (out of place, so autograd
differentiates them; the reference recomputes them inside its scan body
alike), every layer under ``torch.utils.checkpoint``, then the cross
entropy; the aux loss is a zero f32 scalar.

Every entry point takes optional sharding ``rules``, as
``models.transformer``'s do: with DTensor parameters and inputs the
encoder input and the cross k and v are pinned where the reference pins
them, the attention and MLP modules pin theirs, the sinusoids become
replicated DTensors, and the cross cache is computed out of place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (
    ShardingRules, active, constrain, is_sharded, replicated_like, tree_sds,
)
from repro_torch.launch.mesh import mesh_axis
from repro_torch.models.attention import (
    KV, Attention, KVCache, attn_specs, cache_logical as attn_cache_logical,
    init_cache, project,
)
from repro_torch.models.common import (
    MLP, apply_norm, cross_entropy, embed_specs, embed_tokens, flat_specs,
    la, logits_fn, mlp_specs, over_params, param,
)


def sinusoid(s: int, d: int, offset: int = 0, device=None) -> torch.Tensor:
    """(s, d) f32 absolute positions ``offset`` .. ``offset + s - 1``: sines
    of the d / 2 frequencies, then cosines (the reference's
    ``_sinusoid``)."""
    pos = torch.arange(s, dtype=torch.float32, device=device) + offset
    inv = torch.exp(-torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    / d * math.log(10000.0))
    ang = pos[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def init_specs(cfg: ArchConfig, tp: int) -> dict:
    """Every parameter as a LogicalArray, keyed by its ``state_dict`` name
    (``encoder.{i}.attn.wq``, ``decoder.{i}.cross_attn.wk``) in
    the reference's order; at ``tp`` > 1 the reference's padded
    shapes."""
    norm = la((cfg.d_model,), (None,))
    enc = {"norm1": norm, "attn": attn_specs(cfg, tp), "norm2": norm,
           "ffn": mlp_specs(cfg, cfg.d_ff)}
    dec = {"norm1": norm, "self_attn": attn_specs(cfg, tp), "norm_x": norm,
           "cross_attn": attn_specs(cfg, tp), "norm2": norm,
           "ffn": mlp_specs(cfg, cfg.d_ff)}
    specs = dict(embed_specs(cfg, tp))
    for i in range(cfg.n_encoder_layers):
        specs.update(flat_specs(f"encoder.{i}.", enc))
    for i in range(cfg.num_layers):
        specs.update(flat_specs(f"decoder.{i}.", dec))
    specs["enc_norm"] = norm
    specs["final_norm"] = norm
    return specs


class EncoderLayer(nn.Module):
    """Non-causal self-attention, then the MLP, each pre-norm residual."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.norm1 = param(cfg.d_model, device=device)
        self.attn = Attention(cfg, device)
        self.norm2 = param(cfg.d_model, device=device)
        self.ffn = MLP(cfg, cfg.d_ff, device)

    def forward(self, x: torch.Tensor,
                rules: Optional[ShardingRules] = None) -> torch.Tensor:
        mix, _ = self.attn(apply_norm(self.cfg, x, self.norm1), None,
                           causal=False, rules=rules)
        x = x + mix
        return x + self.ffn(apply_norm(self.cfg, x, self.norm2), rules)


class DecoderLayer(nn.Module):
    """Causal self-attention over the KV cache, cross-attention to the
    frames, then the MLP, each pre-norm residual."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.norm1 = param(cfg.d_model, device=device)
        self.self_attn = Attention(cfg, device)
        self.norm_x = param(cfg.d_model, device=device)
        self.cross_attn = Attention(cfg, device)
        self.norm2 = param(cfg.d_model, device=device)
        self.ffn = MLP(cfg, cfg.d_ff, device)

    def cross_proj(self, enc_out: torch.Tensor,
                   rules: Optional[ShardingRules] = None) -> tuple:
        """(k, v), each (B, S_enc, KV, hd): the encoder output through this
        layer's cross-attention wk and wv, out of place."""
        rules = active(rules, enc_out)
        w = self.cross_attn
        return tuple(constrain(rules, project(rules, enc_out, t, "kv_heads"),
                               *KV) for t in (w.wk, w.wv))

    def forward(self, x: torch.Tensor, cache: Optional[KVCache],
                cross_kv: Optional[tuple] = None,
                enc_out: Optional[torch.Tensor] = None,
                rules: Optional[ShardingRules] = None):
        """Returns (x, the advanced cache or None).  The cross k and v are
        ``cross_kv``'s, or this layer's projections of ``enc_out``."""
        cfg = self.cfg
        if cross_kv is None:
            cross_kv = self.cross_proj(enc_out, rules)
        mix, cache = self.self_attn(apply_norm(cfg, x, self.norm1), None,
                                    cache=cache, rules=rules)
        x = x + mix
        cross, _ = self.cross_attn(apply_norm(cfg, x, self.norm_x), None,
                                   cross_kv=cross_kv, rules=rules)
        x = x + cross
        return x + self.ffn(apply_norm(cfg, x, self.norm2), rules), cache


class EncoderDecoder(nn.Module):
    """Embedding, ``n_encoder_layers`` encoder and ``num_layers`` decoder
    layers, ``enc_norm`` and ``final_norm``; the logits read the untied
    ``unembed`` (d, padded vocab) or the embedding transposed."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        if not cfg.is_enc_dec:
            raise ValueError(f"{cfg.name} has no encoder")
        self.cfg = cfg
        pv = cfg.padded_vocab(1)
        self.embed = param(pv, cfg.d_model, device=device)
        if not cfg.tie_embeddings:
            self.unembed = param(cfg.d_model, pv, device=device)
        self.encoder = nn.ModuleList(EncoderLayer(cfg, device)
                                     for _ in range(cfg.n_encoder_layers))
        self.decoder = nn.ModuleList(DecoderLayer(cfg, device)
                                     for _ in range(cfg.num_layers))
        self.enc_norm = param(cfg.d_model, device=device)
        self.final_norm = param(cfg.d_model, device=device)

    def logits(self, x: torch.Tensor,
               rules: Optional[ShardingRules] = None) -> torch.Tensor:
        return logits_fn(self.embed, getattr(self, "unembed", None), x,
                         rules)


def encode(model: EncoderDecoder, frames: torch.Tensor, *,
           remat: bool = False,
           rules: Optional[ShardingRules] = None) -> torch.Tensor:
    """frames (B, S_enc, d_model) -> the encoder output, in the model's
    type: frames plus sinusoidal positions, the encoder layers (each under
    ``torch.utils.checkpoint`` with ``remat``), then ``enc_norm``."""
    dtype = model.embed.dtype
    x = frames.to(dtype)
    pe = sinusoid(x.shape[1], x.shape[2], device=x.device).to(dtype)
    x = constrain(rules, x + replicated_like(pe, x), "batch", None, None)
    for layer in model.encoder:
        x = checkpoint(layer, x, rules, use_reentrant=False) if remat \
            else layer(x, rules)
    return apply_norm(model.cfg, x, model.enc_norm)


def cross_kv(model: EncoderDecoder, enc_out: torch.Tensor,
             out: Optional[dict] = None,
             rules: Optional[ShardingRules] = None) -> dict:
    """Every decoder layer's cross k and v from the encoder output:
    ``{"k", "v"}``, each (L, B, S_enc, KV, hd) in the model's type, written
    into ``out`` where its shape is theirs (a cache made for these frames),
    else into new tensors; a DTensor's stacked out of place."""
    cfg = model.cfg
    b, s, d = enc_out.shape
    if is_sharded(rules, enc_out):
        kv = [layer.cross_proj(enc_out, rules) for layer in model.decoder]
        return {n: torch.stack([t[j] for t in kv])
                for j, n in enumerate(("k", "v"))}
    shape = (cfg.num_layers, b, s, cfg.n_kv_heads, cfg.head_dim)
    if out is None or tuple(out["k"].shape) != shape:
        out = {n: torch.empty(shape, dtype=enc_out.dtype,
                              device=enc_out.device) for n in ("k", "v")}
    for i, layer in enumerate(model.decoder):
        for n in ("k", "v"):
            w = getattr(layer.cross_attn, "w" + n)
            torch.matmul(enc_out, w.reshape(d, -1),
                         out=out[n][i].view(b, s, -1))
    return out


def decode_trunk(model: EncoderDecoder, tokens: torch.Tensor,
                 cross: Optional[dict], self_caches: Optional[List[KVCache]],
                 cache_pos: int, *, enc_out: Optional[torch.Tensor] = None,
                 remat: bool = False,
                 rules: Optional[ShardingRules] = None):
    """The decoder over tokens (B, S) at positions ``cache_pos`` onwards:
    token embeddings plus sinusoidal positions, each layer's self-attention
    through its cache and cross-attention to ``cross``, then
    ``final_norm``.  Returns (x (B, S, d_model), the advanced caches).
    Training passes no caches and ``enc_out`` in place of ``cross``:
    each layer projects its own cross k and v from it, under
    ``torch.utils.checkpoint`` with ``remat``; the caches are then
    None."""
    cfg = model.cfg
    x = embed_tokens(model.embed, tokens, rules)
    pe = sinusoid(tokens.shape[1], cfg.d_model, cache_pos,
                  x.device).to(x.dtype)
    x = x + replicated_like(pe, x)
    if self_caches is None:
        for layer in model.decoder:
            x = checkpoint(layer, x, None, None, enc_out, rules,
                           use_reentrant=False)[0] if remat \
                else layer(x, None, None, enc_out, rules)[0]
        return apply_norm(cfg, x, model.final_norm), None
    new_caches = []
    for i, layer in enumerate(model.decoder):
        c = dataclasses.replace(self_caches[i], pos=cache_pos)
        x, c = layer(x, c, (cross["k"][i], cross["v"][i]), rules=rules)
        new_caches.append(c)
    return apply_norm(cfg, x, model.final_norm), new_caches


def loss_fn(model: EncoderDecoder, batch: dict, *, remat: bool = True,
            rules: Optional[ShardingRules] = None, **_):
    """The training loss of ``batch`` (``frames`` (B, S_enc, d_model),
    ``tokens`` and ``targets`` (B, S)): the mean cross entropy of the
    decoder's logits over the padded vocab -> (loss, {"ce", "aux"}), the
    aux a zero f32 scalar (other keywords, such as ``aux_weight``, are
    ignored, as the reference ignores them)."""
    enc_out = encode(model, batch["frames"], remat=remat, rules=rules)
    x, _ = decode_trunk(model, batch["tokens"], None, None, 0,
                        enc_out=enc_out, remat=remat, rules=rules)
    ce = cross_entropy(model.logits(x, rules), batch["targets"],
                       model.cfg.vocab_size)
    return ce, {"ce": ce, "aux": ce.new_zeros(())}


def prefill_fn(model: EncoderDecoder, tokens: torch.Tensor, caches: dict, *,
               frames: torch.Tensor, rules: Optional[ShardingRules] = None):
    """Encode ``frames`` (B, S_enc, d_model) into the cross cache and
    populate the self caches from a whole prompt (B, S); return the last
    token's f32 logits (B, 1, padded vocab) and ``{"self", "cross"}``.
    The cross cache has the frames' length, whatever ``caches``' has."""
    cross = cross_kv(model, encode(model, frames, rules=rules),
                     caches.get("cross"), rules)
    x, new_self = decode_trunk(model, tokens, cross, caches["self"], 0,
                               rules=rules)
    return model.logits(x[:, -1:], rules), {"self": new_self,
                                            "cross": cross}


def decode_fn(model: EncoderDecoder, tokens: torch.Tensor, pos: int,
              caches: dict, *, rules: Optional[ShardingRules] = None):
    """One step: tokens (B, 1) at position ``pos`` -> (logits (B, 1,
    padded vocab) f32, caches)."""
    x, new_self = decode_trunk(model, tokens, caches["cross"],
                               caches["self"], pos, rules=rules)
    return model.logits(x, rules), {"self": new_self,
                                    "cross": caches["cross"]}


def cache_specs(cfg: ArchConfig, batch: int, max_len: int, enc_len: int,
                dtype=torch.bfloat16) -> dict:
    """``{"self": [per decoder layer {name: (shape, dtype)}], "cross":
    {name: (shape, dtype)}}``: each layer's KV cache of ``max_len`` and the
    cross k and v of ``enc_len`` frames, stacked over the layers."""
    shape = (cfg.num_layers, batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
    return {"self": [init_cache(cfg, batch, max_len, dtype)
                     for _ in range(cfg.num_layers)],
            "cross": {"k": (shape, dtype), "v": (shape, dtype)}}


def cache_logical(cfg: ArchConfig, batch: int, max_len: int, tp: int,
                  enc_len: int) -> dict:
    """The caches as LogicalArrays at tensor-parallel degree ``tp`` (the
    reference's ``cache_specs``): ``{"self": [per decoder layer {"k",
    "v"}], "cross": {"k", "v"}}``, the cross k and v stacked over the
    layers, (L, B, S_enc, padded kv heads, hd) over ``(None, "batch",
    None, "kv_heads", "head_dim")``."""
    kvp, hd = cfg.padded_kv_heads(tp), cfg.head_dim
    ax = (None, "batch", None, "kv_heads", "head_dim")
    shape = (cfg.num_layers, batch, enc_len, kvp, hd)
    return {"self": [attn_cache_logical(cfg, batch, max_len, tp)
                     for _ in range(cfg.num_layers)],
            "cross": {"k": la(shape, ax, torch.bfloat16),
                      "v": la(shape, ax, torch.bfloat16)}}


def make_caches(cfg: ArchConfig, batch: int, max_len: int, enc_len: int,
                device=None, dtype=torch.bfloat16) -> dict:
    """Zero-filled caches, the self caches at position 0."""
    spec = cache_specs(cfg, batch, max_len, enc_len, dtype)

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)
    return {"self": [KVCache(zeros(*s["k"]), zeros(*s["v"]), 0)
                     for s in spec["self"]],
            "cross": {n: zeros(*sd) for n, sd in spec["cross"].items()}}


# --------------------------------------------------------------------------- #
# the dry run's repeated units
# --------------------------------------------------------------------------- #

def count_units(cfg: ArchConfig, shape, rules: ShardingRules) -> list:
    """The reference's ``[(name, fn, args, mult)]``: one encoder layer
    (``mult`` = encoder layers - 1) and one decoder layer (decoder layers
    - 1), each a step of its own over meta stand-ins laid out by
    ``rules``: x_enc (B, S, d) and x_dec (B, S or 1, d) bf16 over
    ("batch", None, None), the layer's params, and for serving its self
    cache and, in decode, the cross k and v (B, S, KV, hd).  Train units
    are the value and the gradients of sum(y) through the layer under
    ``torch.utils.checkpoint``, the decoder's from x_dec, x_enc (its
    cross k and v projected from it) and its params; prefill's decoder
    layer projects its cross k and v from x_enc too."""
    tp = mesh_axis(rules.mesh, "model")
    b = shape.global_batch
    s_dec = shape.seq_len if shape.kind != "decode" else 1
    s_enc = shape.seq_len
    off = shape.seq_len - 1 if shape.kind == "decode" else 0
    d = cfg.d_model
    wide = ("batch", None, None)
    x_enc = la((b, s_enc, d), wide).sds(rules)
    x_dec = la((b, s_dec, d), wide).sds(rules)
    spec = init_specs(dataclasses.replace(cfg, n_encoder_layers=1,
                                          num_layers=1), tp)
    enc_pj = tree_sds({k[len("encoder.0."):]: v for k, v in spec.items()
                       if k.startswith("encoder.0.")}, rules)
    dec_pj = tree_sds({k[len("decoder.0."):]: v for k, v in spec.items()
                       if k.startswith("decoder.0.")}, rules)
    enc_layer = EncoderLayer(cfg, "meta")
    dec_layer = DecoderLayer(cfg, "meta")

    def with_grads(layer, run, xs, pj):
        xs = [x.detach().requires_grad_(True) for x in xs]
        leaves = {n: t.detach().requires_grad_(True) for n, t in pj.items()}

        def grads_of(layer, *xs):
            val = run(layer, *xs)
            return val.detach(), torch.autograd.grad(
                val, [*xs, *leaves.values()], allow_unused=True)
        return over_params(layer, leaves, grads_of, *xs)

    if shape.kind == "train":
        def enc_run(layer, x):
            y = checkpoint(layer, x, use_reentrant=False, rules=rules)
            return y.float().sum()

        def dec_run(layer, x, enc_out):
            y, _ = checkpoint(layer, x, None, None, enc_out,
                              use_reentrant=False, rules=rules)
            return y.float().sum()

        def enc_unit(x, pj):
            return with_grads(enc_layer, enc_run, [x], pj)

        def dec_unit(x, enc_out, pj):
            return with_grads(dec_layer, dec_run, [x, enc_out], pj)
        return [("enc_layer_train", enc_unit, (x_enc, enc_pj),
                 cfg.n_encoder_layers - 1),
                ("dec_layer_train", dec_unit, (x_dec, x_enc, dec_pj),
                 cfg.num_layers - 1)]

    cache_sds = tree_sds(attn_cache_logical(cfg, b, shape.seq_len, tp),
                         rules)

    def dec_fwd(layer, x, cache, enc_out=None, ckv=None):
        c = KVCache(cache["k"], cache["v"], off)
        kv = None if ckv is None else (ckv["k"], ckv["v"])
        y, nc = layer(x, c, kv, enc_out, rules=rules)
        return y, {"k": nc.k, "v": nc.v}

    def enc_fwd(layer, x):
        return layer(x, rules=rules)

    units = []
    if shape.kind == "prefill":
        @torch.no_grad()
        def enc_unit(x, pj):
            return over_params(enc_layer, pj, enc_fwd, x)

        @torch.no_grad()
        def dec_unit(x, enc_out, pj, cache):
            return over_params(dec_layer, pj, dec_fwd, x, cache, enc_out)
        units.append(("enc_layer", enc_unit, (x_enc, enc_pj),
                      cfg.n_encoder_layers - 1))
        units.append(("dec_layer", dec_unit, (x_dec, x_enc, dec_pj,
                                              cache_sds),
                      cfg.num_layers - 1))
        return units

    kvp, hd = cfg.padded_kv_heads(tp), cfg.head_dim
    ckv_sds = tree_sds({n: la((b, s_enc, kvp, hd), KV) for n in ("k", "v")},
                       rules)

    @torch.no_grad()
    def dec_unit(x, pj, ckv, cache):
        return over_params(dec_layer, pj, dec_fwd, x, cache, None, ckv)
    units.append(("dec_layer", dec_unit, (x_dec, dec_pj, ckv_sds, cache_sds),
                  cfg.num_layers - 1))
    return units
