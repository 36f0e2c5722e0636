"""Kimi K2 — trillion-parameter MoE, 32B active.

61L d_model=7168 64H (GQA kv=8) d_ff=2048 (per-expert) vocab=163840;
384 routed experts, top-8, one shared expert. The released K2 uses MLA
attention and a dense first layer; this config follows the assigned table
(GQA kv=8, uniform MoE layers) — deviations noted in DESIGN.md.
[arXiv:2501.kimi2; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=112,
    d_ff=2048,  # shared-expert width
    vocab_size=163840,
    activation="silu",
    norm="rmsnorm",
    num_experts=384,
    num_experts_per_tok=8,
    expert_d_ff=2048,
    moe_shared_ffn=True,
    capacity_factor=1.25,
    rope_theta=5e4,
    max_seq_len=131072,
)
