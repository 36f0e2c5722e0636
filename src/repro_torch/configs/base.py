"""Model configuration for the PyTorch port.

Same fields, defaults, ``hd``, ``reduced()``, ``param_count()``,
``active_param_count()``, ``supports_shape()`` and ``skip_reason()`` as the
JAX package's ``configs/base.py``, and the same :class:`ShapeCell` cells
(``SHAPES``, ``SHAPES_BY_NAME``); ``dtype`` and ``cdtype`` return
``torch.dtype``\\ s. The port adds the fields of the published Zamba2
layout (``hybrid_layer_ids`` and the five after it), which the JAX package
lacks: at their defaults every config is the JAX package's, field for
field, and ``param_count()`` counts the same. ``use_pallas`` is kept for field
parity only: on a CUDA device attention always runs through the
hand-written kernels, and on the CPU through their plain versions.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (input-shape) cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # 'dense' | 'moe' | 'hybrid' | 'ssm' | 'encdec' | 'vlm'
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    activation: str = "silu"
    norm: str = "rmsnorm"
    qkv_bias: bool = False
    mlp_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1e4
    max_seq_len: int = 32768
    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    expert_d_ff: int = 0
    moe_shared_ffn: bool = False  # dense (shared-expert) FFN alongside routed
    capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    attn_every: int = 0  # zamba2: shared attention before every Nth block
    # --- the published Zamba2 layout (port only) ---
    #: layers whose Mamba block a shared transformer block feeds (the
    #: config's ``hybrid_layer_ids``); empty keeps the JAX package's
    #: layout, one shared block with residuals before every
    #: ``attn_every``-th layer, and the five fields below at their defaults
    hybrid_layer_ids: Tuple[int, ...] = ()
    num_mem_blocks: int = 1  # shared blocks, taken in turn by the applications
    attention_hidden_size: int = 0  # the shared block's input width (0: d_model)
    adapter_rank: int = 0  # rank of each application's LoRA on the MLP's gate_up
    ssm_groups: int = 1  # Mamba-2 groups: B and C per group of heads
    norm_eps: float = 1e-6  # the hybrid family's RMSNorm eps
    mlstm_per_slstm: int = 7  # xlstm block ratio
    # --- enc-dec ---
    encoder_layers: int = 0
    cross_attention: bool = False
    # --- modality frontend stubs ---
    embed_inputs: bool = False  # training inputs are embeddings, not tokens
    frontend_seq: int = 0  # encoder memory length supplied by the stub
    # --- numerics / training ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    # --- serving ---
    attn_q_chunk: int = 512
    use_pallas: bool = False  # field parity; not a switch in the port

    def __post_init__(self):
        # a JSON list and a tuple name the same layers (and compare equal)
        object.__setattr__(self, "hybrid_layer_ids", tuple(self.hybrid_layer_ids))

    # ------------------------------------------------------------------ api
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def supports_shape(self, shape: ShapeCell) -> bool:
        """long_500k needs a sub-quadratic mixer (DESIGN.md §shape-skips)."""
        if shape.name == "long_500k":
            return self.family in ("hybrid", "ssm")
        return True

    def skip_reason(self, shape: ShapeCell) -> Optional[str]:
        if self.supports_shape(shape):
            return None
        return "full-attention@500k"

    def param_count(self) -> int:
        """Approximate parameter count (embedding + layers), for roofline."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd, hq, hkv = self.hd, self.num_heads, self.num_kv_heads
        attn = d * hd * (hq + 2 * hkv) + hq * hd * d
        if self.family in ("dense", "vlm"):
            ffn = d * f * (3 if self.activation == "silu" else 2)
            per_layer = attn + ffn
            layers = self.num_layers * per_layer
        elif self.family == "moe":
            gated = 3 if self.activation == "silu" else 2
            routed = self.num_experts * d * self.expert_d_ff * gated
            shared = d * f * gated if self.moe_shared_ffn else 0
            layers = self.num_layers * (attn + routed + shared + d * self.num_experts)
        elif self.family == "hybrid":
            d_inner = 2 * d
            mamba = d * (2 * d_inner + 2 * self.ssm_groups * self.ssm_state
                         + d_inner // self.ssm_head_dim)
            mamba += d_inner * d
            layers = self.num_layers * mamba + attn  # one shared attn block
            if self.hybrid_layer_ids:  # the published layout's shared blocks
                width = self.attention_hidden_size or d
                block = (width * hd * (hq + 2 * hkv) + hq * hd * d
                         + d * f * (3 if self.activation in ("silu", "geglu") else 2))
                per_app = self.adapter_rank * (d + 2 * f) + d * d  # LoRA, linear
                layers += (self.num_mem_blocks * block - attn
                           + len(self.hybrid_layer_ids) * per_app)
        elif self.family == "ssm":
            d_inner = 2 * d
            hd_i = d_inner // self.num_heads
            mlstm = d * 2 * d_inner + 3 * self.num_heads * hd_i * hd_i + d_inner * d
            slstm = 4 * d * d + self.num_heads * (d // self.num_heads) ** 2 * 4 + d * d
            n_s = self.num_layers // (self.mlstm_per_slstm + 1)
            layers = (self.num_layers - n_s) * mlstm + n_s * slstm
        elif self.family == "encdec":
            ffn = d * f * (3 if self.activation == "silu" else 2)
            enc = self.encoder_layers * (attn + ffn)
            dec = self.num_layers * (2 * attn + ffn)
            layers = enc + dec
        else:
            raise ValueError(self.family)
        embed = v * d * (1 if self.tie_embeddings else 2)
        return int(layers + embed)

    def active_param_count(self) -> int:
        """Activated params per token (== param_count for dense)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        gated = 3 if self.activation == "silu" else 2
        hd, hq, hkv = self.hd, self.num_heads, self.num_kv_heads
        attn = d * hd * (hq + 2 * hkv) + hq * hd * d
        routed_active = self.num_experts_per_tok * d * self.expert_d_ff * gated
        shared = d * self.d_ff * gated if self.moe_shared_ffn else 0
        layers = self.num_layers * (attn + routed_active + shared + d * self.num_experts)
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return int(layers + embed)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(
            name=self.name + "-smoke",
            capacity_factor=8.0,  # drop-free at smoke scale → exact streaming
            num_layers=min(self.num_layers, 4 if self.family in ("hybrid", "ssm") else 2),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=16,
            d_ff=96 if self.d_ff else 0,
            vocab_size=128,
            max_seq_len=64,
            param_dtype="float32",
            compute_dtype="float32",
            remat=False,
            attn_q_chunk=16,
            ssm_chunk=8,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            num_experts=4 if self.num_experts else 0,
            num_experts_per_tok=min(self.num_experts_per_tok, 2),
            expert_d_ff=48 if self.expert_d_ff else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            attn_every=2 if self.attn_every else 0,
            mlstm_per_slstm=min(self.mlstm_per_slstm, 3),
            frontend_seq=8 if self.frontend_seq else 0,
        )
        if self.family == "ssm":
            kw["num_layers"] = kw["mlstm_per_slstm"] + 1
        return dataclasses.replace(self, **kw)
