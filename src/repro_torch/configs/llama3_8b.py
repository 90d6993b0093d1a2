"""llama3-8b — dense GQA, 128k vocab [arXiv:2407.21783]."""
from repro_torch.configs.base import ArchConfig, register

LLAMA3_8B = register(ArchConfig(
    name="llama3-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    norm="rmsnorm",
    activation="silu",
    rope_theta=500_000.0,
    source="arXiv:2407.21783",
))
