"""Llama-4 Scout 17B-active / 16-expert.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048; MoE with 16 routed
experts, top-1 routing, plus a shared (dense) expert per layer — early
fusion multimodality is out of scope for the LM backbone cells.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,  # shared-expert / dense FFN width
    vocab_size=202048,
    activation="silu",
    norm="rmsnorm",
    num_experts=16,
    num_experts_per_tok=1,
    expert_d_ff=8192,
    moe_shared_ffn=True,
    rope_theta=5e5,
    max_seq_len=524288,
)
