"""InternVL2-76B — LM backbone only (InternViT frontend is a STUB; the
training cell feeds precomputed patch+text embeddings). 80L d_model=8192
64H (GQA kv=8) d_ff=28672 vocab=128256, Llama-3-70B-shaped backbone.
[arXiv:2404.16821; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    activation="silu",
    norm="rmsnorm",
    embed_inputs=True,  # train cells consume stub embeddings
    rope_theta=5e5,
    max_seq_len=32768,
)
