"""granite-8b — llama-arch code model, GQA [arXiv:2405.04324; hf]."""
from repro_torch.configs.base import ArchConfig, register

GRANITE_8B = register(ArchConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=49152,
    norm="rmsnorm",
    activation="silu",
    rope_theta=10_000_000.0,
    source="arXiv:2405.04324; hf:ibm-granite/granite-8b-code-base",
))
