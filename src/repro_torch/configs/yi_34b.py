"""Yi-34B. 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000;
Llama-architecture GQA, SwiGLU, RMSNorm. [arXiv:2403.04652; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    activation="silu",
    norm="rmsnorm",
    rope_theta=5e6,
    max_seq_len=200000,
)
