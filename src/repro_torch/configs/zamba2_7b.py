"""Zamba2-7B-Instruct at its published widths (port only; the JAX package
has no such config). 81 Mamba-2 layers (d_model 3584, expand 2: 112 heads
of 64, state 64, 2 groups of B and C, conv 4) and two shared transformer
blocks, taken in turn by the 13 layers of ``hybrid_layer_ids``: each reads
concat(residual, embedding), 7168 wide, through RMSNorm, attention of 32
heads of 224 with RoPE over the whole head (scores scaled by
1 / sqrt(224 / 2)) and o_proj to 3584, then RMSNorm and a gated erf-GELU
MLP 3584 -> 2 x 14336 -> 3584 whose gate_up carries the application's own
rank-128 LoRA; the block's output goes through the application's 3584 x
3584 ``linear`` and is added to that layer's Mamba input only. RMSNorm eps
1e-5, vocabulary 32,000, tied embeddings (transformers' default: the
published config does not state it). ``ssm_chunk`` is 128, the kernel's
largest, where the config's ``chunk_size`` is 256: chunking tiles an exact
scan, so the two differ only by rounding.
[https://huggingface.co/Zyphra/Zamba2-7B-Instruct; arXiv:2411.15242]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=224,
    d_ff=14336,
    vocab_size=32000,
    activation="geglu",
    norm="rmsnorm",
    tie_embeddings=True,
    rope_theta=1e4,
    max_seq_len=4096,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_chunk=128,
    hybrid_layer_ids=(6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77),
    num_mem_blocks=2,
    attention_hidden_size=7168,
    adapter_rank=128,
    ssm_groups=2,
    norm_eps=1e-5,
)
