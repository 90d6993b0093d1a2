"""mamba2-780m — attention-free SSD (state-space duality) [arXiv:2405.21060].

d_inner = 2*d_model = 3072, head_dim 64 -> 48 SSD heads, state 128.
No FFN (d_ff = 0): each layer is a single Mamba-2 block.
"""
from repro_torch.configs.base import ArchConfig, register

MAMBA2_780M = register(ArchConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    head_dim=1,                    # unused (attention-free)
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_conv_width=4,
    ssm_expand=2,
    norm="rmsnorm",
    activation="silu",
    tie_embeddings=True,
    source="arXiv:2405.21060; hf:state-spaces/mamba2-780m",
))
