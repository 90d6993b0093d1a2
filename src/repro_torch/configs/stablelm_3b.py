"""stablelm-3b — MHA (kv=32), partial rotary, LayerNorm [hf:stabilityai]."""
from repro_torch.configs.base import ArchConfig, register

STABLELM_3B = register(ArchConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    norm="layernorm",
    activation="silu",
    rope_theta=10_000.0,
    rotary_pct=0.25,
    source="hf:stabilityai/stablelm-2-1_6b (scaled 3b variant per assignment)",
))
