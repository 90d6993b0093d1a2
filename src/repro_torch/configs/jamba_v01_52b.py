"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887; hf].

Layer schedule (32 layers): attention at i % 8 == 4 (1 attention per 8-layer
block, the paper's 1:7 ratio); MoE FFN at odd layers (every other layer,
e=16, top-2), dense FFN elsewhere.  SSM blocks use the Mamba-2/SSD formulation
(DESIGN.md records this substitution for the Mamba-1 blocks of the original).
"""
from repro_torch.configs.base import ArchConfig, register

JAMBA_V01_52B = register(ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    n_experts=16,
    top_k=2,
    moe_every=2,
    moe_offset=1,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_conv_width=4,
    ssm_expand=2,
    attn_every=8,
    attn_offset=4,
    norm="rmsnorm",
    activation="silu",
    source="arXiv:2403.19887; hf:ai21labs/Jamba-v0.1",
))
