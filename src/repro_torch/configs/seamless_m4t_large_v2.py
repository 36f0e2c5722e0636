"""SeamlessM4T-Large v2 (text/speech backbone). 24L encoder + 24L decoder,
d_model=1024 16H (kv=16) d_ff=8192 vocab=256206. The speech frontend is a
STUB: input_specs supplies precomputed frame embeddings (B, frames, D).
[arXiv:2308.11596; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,  # decoder layers
    encoder_layers=24,
    cross_attention=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    activation="gelu",
    norm="layernorm",
    embed_inputs=True,
    frontend_seq=4096,  # stub speech frames fed to the encoder
    rope_theta=1e4,
    max_seq_len=32768,
)
