"""StarCoder2-15B. 40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152;
GQA + RoPE, biases on attention/MLP, non-gated GELU, LayerNorm.
[arXiv:2402.19173; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    activation="gelu",
    norm="layernorm",
    qkv_bias=True,
    mlp_bias=True,
    rope_theta=1e5,
    max_seq_len=16384,
)
