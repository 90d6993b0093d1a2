"""whisper-large-v3 — encoder-decoder audio transformer [arXiv:2212.04356].

The conv frontend is a STUB per the assignment: ``input_specs()`` supplies
precomputed frame embeddings (seq_len frames x d_model) for the encoder;
decoder consumes seq_len tokens.  20 heads do not divide the 16-way tensor
axis and padding to 32 would waste 60%, so attention weights stay replicated
and only the FFN is tensor-sharded (DESIGN.md padding policy).
"""
from repro_torch.configs.base import ArchConfig, register

WHISPER_LARGE_V3 = register(ArchConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,                # decoder layers
    n_encoder_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    norm="layernorm",
    activation="gelu",
    position_scheme="absolute",
    n_audio_frames=1500,
    source="arXiv:2212.04356; hf:openai/whisper-large-v3",
))
