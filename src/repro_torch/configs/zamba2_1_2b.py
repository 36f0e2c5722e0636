"""Zamba2-1.2B. 38 Mamba-2 blocks (d_model=2048, ssm_state=64) with a
single shared attention(+FFN) block (32H, kv=32, d_ff=8192) applied before
every 6th Mamba block. Sub-quadratic → runs the long_500k cell.
[arXiv:2411.15242; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    activation="silu",
    norm="rmsnorm",
    ssm_state=64,
    ssm_head_dim=64,
    ssm_chunk=128,
    attn_every=6,
    rope_theta=1e4,
    max_seq_len=524288,
)
