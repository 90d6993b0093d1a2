"""internlm2-20b — dense GQA transformer [arXiv:2403.17297; hf]."""
from repro_torch.configs.base import ArchConfig, register

INTERNLM2_20B = register(ArchConfig(
    name="internlm2-20b",
    family="dense",
    num_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92544,
    norm="rmsnorm",
    activation="silu",
    rope_theta=1_000_000.0,
    source="arXiv:2403.17297; hf:internlm/internlm2-20b",
))
