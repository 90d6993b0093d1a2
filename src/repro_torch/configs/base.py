"""Architecture + shape configuration system.

Every assigned architecture is a frozen ``ArchConfig``; every assigned input
shape is a ``ShapeConfig``.  The dry-run, smoke tests, benchmarks and the
roofline analysis all consume these, so the exact paper/HF dimensions live
here and nowhere else.

Dimension-padding policy (production posture, recorded in DESIGN.md):
  * vocab is padded up to a multiple of ``VOCAB_PAD`` (128) so it shards over
    the tensor axis (Megatron-style); logits at padded positions are masked.
  * query heads are padded up to the tensor-parallel degree when the waste is
    <= ``HEAD_PAD_MAX_WASTE``; otherwise attention weights are replicated and
    only the FFN is tensor-sharded (whisper's 20 heads).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal, Optional, Sequence

VOCAB_PAD = 128
HEAD_PAD_MAX_WASTE = 0.25

Family = Literal["dense", "moe", "hybrid", "vlm", "audio", "ssm"]
StepKind = Literal["train", "prefill", "decode"]


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: StepKind

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """A complete architecture description (full production size)."""

    name: str
    family: Family
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                      # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1                     # layer i is MoE iff i % moe_every == moe_offset
    moe_offset: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0                      # 0 -> d_ff

    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    ssm_groups: int = 1                    # ngroups for B/C (Mamba-2)
    attn_every: int = 1                    # hybrid: layer i is attention iff i % attn_every == attn_offset
    attn_offset: int = 0

    # --- encoder/decoder ---
    n_encoder_layers: int = 0              # 0 -> decoder-only

    # --- misc architecture knobs ---
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    activation: Literal["silu", "gelu"] = "silu"
    position_scheme: Literal["rope", "absolute"] = "rope"
    rope_theta: float = 10_000.0
    rotary_pct: float = 1.0                # stablelm uses 0.25
    mrope_sections: Optional[tuple[int, int, int]] = None   # qwen2-vl M-RoPE
    tie_embeddings: bool = False
    n_vision_patches: int = 0              # vlm stub frontend patch count
    n_audio_frames: int = 0                # audio stub frontend frame count (per seq_len unit)

    source: str = ""                       # provenance string from the assignment

    # ------------------------------------------------------------------ #
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))
        if self.n_experts and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    # --- structural helpers ------------------------------------------- #
    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_enc_dec(self) -> bool:
        return self.n_encoder_layers > 0

    def layer_is_attn(self, i: int) -> bool:
        if self.family == "ssm":
            return False
        if self.family == "hybrid":
            return i % self.attn_every == self.attn_offset
        return True

    def layer_is_moe(self, i: int) -> bool:
        if not self.n_experts:
            return False
        return i % self.moe_every == self.moe_offset

    @property
    def d_inner(self) -> int:
        """Mamba inner width."""
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    # --- padding under tensor parallelism ------------------------------ #
    def padded_vocab(self, tp: int) -> int:
        mult = VOCAB_PAD * tp // math.gcd(VOCAB_PAD, tp) if tp > 1 else VOCAB_PAD
        return ((self.vocab_size + mult - 1) // mult) * mult

    def padded_heads(self, tp: int) -> int:
        """Query-head count after TP padding: always padded up to a multiple
        of tp (zero-weight heads contribute nothing; waste recorded in the
        roofline's useful-FLOPs ratio)."""
        if tp <= 1 or self.n_heads % tp == 0:
            return self.n_heads
        return ((self.n_heads + tp - 1) // tp) * tp

    def padded_kv_heads(self, tp: int) -> int:
        """MHA archs pad KV alongside Q so groups stay 1:1; GQA archs never
        pad KV (the cache is sequence-sharded instead, flash-decoding style),
        but padded Q must remain an integer multiple of KV."""
        if self.n_kv_heads == self.n_heads:
            return self.padded_heads(tp)
        assert self.padded_heads(tp) % max(self.n_kv_heads, 1) == 0, self.name
        return self.n_kv_heads

    def attn_tp(self, tp: int) -> int:
        """Effective tensor-parallel degree usable inside attention."""
        return tp if self.padded_heads(tp) % tp == 0 else 1

    def kv_tp(self, tp: int) -> int:
        return tp if (tp > 1 and self.padded_kv_heads(tp) % tp == 0) else 1

    def head_dim_tp(self, tp: int) -> int:
        """RoPE-free archs whose heads can't shard may shard head_dim
        instead (the contraction dims of QK^T and PV are psum-safe)."""
        ok = (tp > 1 and self.n_heads > 0 and self.attn_tp(tp) == 1
              and self.position_scheme == "absolute"
              and self.head_dim % tp == 0)
        return tp if ok else 1

    def padded_experts(self, tp: int) -> int:
        """Experts padded up to a multiple of tp so EP always applies
        (padded experts are masked in the router; hillclimb #2 — the
        expert-TP fallback left granite-moe with 32-wide matmul shards)."""
        if not self.n_experts or tp <= 1 or self.n_experts % tp == 0:
            return self.n_experts
        return ((self.n_experts + tp - 1) // tp) * tp

    def expert_parallel(self, tp: int) -> bool:
        """EP whenever experts (after padding) divide the model axis."""
        return bool(self.n_experts) and tp > 1 \
            and self.padded_experts(tp) % tp == 0

    # --- parameter counts (for MODEL_FLOPS and memory budgeting) ------- #
    def _attn_params(self) -> int:
        qkv = self.d_model * self.head_dim * (self.n_heads + 2 * self.n_kv_heads)
        o = self.n_heads * self.head_dim * self.d_model
        return qkv + o

    @property
    def gated_ffn(self) -> bool:
        return self.activation == "silu"   # SwiGLU-style; gelu archs use 2-mat MLP

    def _ffn_params(self, d_ff: int) -> int:
        return (3 if self.gated_ffn else 2) * self.d_model * d_ff

    def _moe_params(self) -> int:
        router = self.d_model * self.n_experts
        experts = self.n_experts * self._ffn_params(self.moe_d_ff)
        shared = self.n_shared_experts * self._ffn_params(self.moe_d_ff)
        return router + experts + shared

    def _moe_active_params(self) -> int:
        router = self.d_model * self.n_experts
        act = (self.top_k + self.n_shared_experts) * self._ffn_params(self.moe_d_ff)
        return router + act

    def _ssm_params(self) -> int:
        # Mamba-2: B and C are per-group (ngroups=1), shared across heads.
        di, ds = self.d_inner, self.ssm_state
        nh, ng = self.n_ssm_heads, self.ssm_groups
        in_proj = self.d_model * (2 * di + 2 * ng * ds + nh)     # x, z, B, C, dt
        conv = self.ssm_conv_width * (di + 2 * ng * ds)
        out_proj = di * self.d_model
        return in_proj + conv + out_proj + 2 * nh                # A_log, D params

    def _layer_params(self, i: int, active: bool) -> int:
        p = 0
        if self.layer_is_attn(i):
            p += self._attn_params()
        elif self.family in ("hybrid", "ssm"):
            p += self._ssm_params()
        if self.family == "ssm":
            pass                                                  # mamba2: no FFN
        elif self.layer_is_moe(i):
            p += self._moe_active_params() if active else self._moe_params()
        else:
            p += self._ffn_params(self.d_ff)
        p += 2 * self.d_model                                     # norms
        return p

    def param_count(self, active: bool = False) -> int:
        n = self.vocab_size * self.d_model                        # embed
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model                   # lm head
        n += sum(self._layer_params(i, active) for i in range(self.num_layers))
        if self.is_enc_dec:
            # encoder layers: attention + dense FFN (+ cross-attn in decoder)
            enc = self.n_encoder_layers * (
                self._attn_params() + self._ffn_params(self.d_ff) + 2 * self.d_model
            )
            cross = self.num_layers * (self._attn_params() + self.d_model)
            n += enc + cross
        return n

    # --- applicability ------------------------------------------------- #
    def supports_shape(self, shape: ShapeConfig) -> bool:
        if shape.name == "long_500k":
            # Sub-quadratic families only (DESIGN.md §Arch-applicability).
            return self.family in ("ssm", "hybrid")
        return True

    def skip_reason(self, shape: ShapeConfig) -> str:
        if self.supports_shape(shape):
            return ""
        return "pure full-attention arch: 500k decode requires sub-quadratic family"


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def all_archs() -> dict[str, ArchConfig]:
    if not _REGISTRY:
        _load_all()
    return dict(_REGISTRY)


def _load_all() -> None:
    # Import for registration side effects.
    from repro_torch.configs import (  # noqa: F401
        internlm2_20b, granite_8b, llama3_8b, stablelm_3b, jamba_v01_52b,
        qwen2_vl_7b, llama4_scout_17b_a16e, granite_moe_3b_a800m,
        whisper_large_v3, mamba2_780m,
    )


def smoke_config(cfg: ArchConfig) -> ArchConfig:
    """A reduced same-family config for CPU smoke tests."""
    period = 1
    if cfg.family == "hybrid":
        period = math.lcm(period, cfg.attn_every)
    if cfg.n_experts:
        period = math.lcm(period, cfg.moe_every)
    changes: dict = dict(
        num_layers=max(min(cfg.num_layers, 4), period),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
    )
    if cfg.n_experts:
        changes.update(n_experts=min(cfg.n_experts, 4), moe_d_ff=64,
                       top_k=min(cfg.top_k, 2))
    if cfg.family in ("ssm", "hybrid"):
        changes.update(ssm_state=16, ssm_head_dim=16)
    if cfg.is_enc_dec:
        changes.update(n_encoder_layers=2)
    if cfg.mrope_sections:
        changes.update(mrope_sections=(4, 6, 6))    # sums to head_dim // 2
    if cfg.n_vision_patches:
        changes.update(n_vision_patches=16)
    if cfg.n_audio_frames:
        changes.update(n_audio_frames=64)
    return dataclasses.replace(cfg, **changes)


SMOKE_SHAPE = ShapeConfig("smoke", seq_len=64, global_batch=2, kind="train")


def dryrun_cells(archs: Optional[Sequence[str]] = None):
    """All (arch, shape) cells with skip metadata — 40 in total."""
    cells = []
    names = list(archs) if archs else sorted(all_archs())
    for a in names:
        cfg = get_arch(a)
        for s in SHAPES.values():
            cells.append((cfg, s, cfg.skip_reason(s)))
    return cells
