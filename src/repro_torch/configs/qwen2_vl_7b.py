"""qwen2-vl-7b — VLM backbone, M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

The vision frontend is a STUB per the assignment: ``input_specs()`` supplies
precomputed patch embeddings (n_vision_patches x d_model) that are spliced
into the token sequence; M-RoPE position ids carry (t, h, w) sections.
"""
from repro_torch.configs.base import ArchConfig, register

QWEN2_VL_7B = register(ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    norm="rmsnorm",
    activation="silu",
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),      # sums to head_dim//2 = 64
    n_vision_patches=256,
    source="arXiv:2409.12191; hf:Qwen/Qwen2-VL-7B-Instruct",
))
