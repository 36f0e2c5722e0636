"""Nemotron-4 340B. 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000; squared-ReLU MLP (non-gated), LayerNorm, RoPE.
[arXiv:2402.16819; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab_size=256000,
    activation="relu2",
    norm="layernorm",
    rope_theta=1e4,
    max_seq_len=4096,
)
