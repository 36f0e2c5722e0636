"""xLSTM-1.3B. 48 blocks (d_model=2048, 4 heads) in xLSTM[7:1] layout:
super-blocks of 7 mLSTM + 1 sLSTM. d_ff=0 — blocks carry their own
up/down projections. The mLSTM head dim is d_inner / heads = 1024
(``head_dim=512`` is the sLSTM's d_model / heads).
[arXiv:2405.04517; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50304,
    activation="silu",
    norm="layernorm",
    mlstm_per_slstm=7,
    max_seq_len=524288,
)
