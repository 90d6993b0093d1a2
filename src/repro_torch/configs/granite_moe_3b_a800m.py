"""granite-moe-3b-a800m — fine-grained MoE 40e top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base].

vocab 49155 is not divisible by the tensor axis; the config system pads it to
a multiple of lcm(128, tp) with masked logits.  40 experts do not divide the
16-way model axis, so this arch uses expert-TP (d_ff=512 sharded 16-way ->
32 columns/shard) instead of expert-parallel dispatch.
"""
from repro_torch.configs.base import ArchConfig, register

GRANITE_MOE_3B = register(ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    n_experts=40,
    top_k=8,
    moe_every=1,
    moe_d_ff=512,
    norm="rmsnorm",
    activation="silu",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base (3b-a800m scaling)",
))
