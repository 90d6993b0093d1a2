"""llama4-scout-17b-a16e — MoE 16e top-1 + shared expert, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E].

Early-fusion multimodality is out of scope for the assigned shapes (text
backbone only); every layer is MoE with one shared expert, router top-1.
"""
from repro_torch.configs.base import ArchConfig, register

LLAMA4_SCOUT = register(ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    n_experts=16,
    top_k=1,
    moe_every=1,
    n_shared_experts=1,
    moe_d_ff=8192,
    norm="rmsnorm",
    activation="silu",
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
))
