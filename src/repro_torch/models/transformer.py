"""Decoder-only transformer LM: the dense, MoE and VLM-backbone families.

The JAX package's ``lax.scan`` over the stacked layer axis becomes a loop
over per-layer views of the same stacked tensors; the ``shard_activation``
calls, which do nothing without a mesh, are dropped. Attention goes
through ``kernels/ops.py``: the hand-written kernels on a CUDA device,
their plain versions on the CPU. A MoE layer's FFN is ``models/moe.py``
(plus the shared expert's MLP when ``moe_shared_ffn`` is set); the VLM
family is the same decoder, fed token ids or float embeddings.

Entry points:
  * ``forward``       — logits over a full (B, S) sequence.
  * ``loss_fn``       — the next-token loss over a batch (training).
  * ``prefill``       — run the prompt, write K/V into the cache in place,
                        return last-position logits + cache.
  * ``decode_step``   — one token against the KV cache, in place.

As in the JAX package, the batch shares one scalar ``cache["len"]``:
prefill sets it to the (padded) prompt length, left-pad tokens get real
positions and are attended with no pad mask.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (
    dense_init,
    embed_init,
    init_mlp,
    apply_rope,
    layer_views,
    make_norm,
    mlp,
    remat,
    rope_frequencies,
    softmax_cross_entropy,
    unembed,
)

Params = Dict[str, Any]
Rope = Tuple[torch.Tensor, torch.Tensor]


FAMILIES = ("dense", "moe", "vlm")


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported to PyTorch yet")
    make_norm(cfg.norm)  # raises on an unknown norm


# ------------------------------------------------------------------- params
def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random params on ``gen``'s device, stacked on a leading layer axis;
    a MoE layer's router stays f32, as the JAX package keeps it."""
    _check_supported(cfg)
    init_norm, _ = make_norm(cfg.norm)
    dev, lead = gen.device, (cfg.num_layers,)
    layers: Params = {
        "attn_norm": init_norm(cfg.d_model, cfg.dtype, dev, lead),
        "attn": attn_lib.init_attention(
            gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd,
            cfg.dtype, qkv_bias=cfg.qkv_bias, lead=lead),
        "mlp_norm": init_norm(cfg.d_model, cfg.dtype, dev, lead),
    }
    if cfg.family == "moe":
        layers["moe"] = moe_lib.init_moe(
            gen, cfg.d_model, cfg.num_experts, cfg.expert_d_ff, cfg.activation,
            cfg.dtype, lead=lead)
    if cfg.family != "moe" or cfg.moe_shared_ffn:
        layers["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation,
                                 cfg.dtype, bias=cfg.mlp_bias, lead=lead)
    params: Params = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, cfg.dtype),
        "layers": layers,
        "final_norm": init_norm(cfg.d_model, cfg.dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, cfg.dtype,
                                       scale=1.0 / math.sqrt(cfg.d_model))
    return params


# ------------------------------------------------------------------ forward
def _embed_tokens(cfg: ModelConfig, params: Params, tokens_or_embeds) -> torch.Tensor:
    if tokens_or_embeds.is_floating_point():  # modality-frontend embeddings
        return tokens_or_embeds.to(cfg.dtype).to(cfg.cdtype)
    return params["embed"][tokens_or_embeds].to(cfg.cdtype)


def _unembed(params: Params, x) -> torch.Tensor:
    return unembed(params["embed"], x, params.get("lm_head"))


def _qkv_rope(cfg: ModelConfig, p: Params, x, cos, sin, positions):
    q, k, v = attn_lib.qkv_proj(p["attn"], x, cfg.num_heads, cfg.num_kv_heads, cfg.hd)
    return apply_rope(q, cos, sin, positions), apply_rope(k, cos, sin, positions), v


def _ffn_block(cfg: ModelConfig, p: Params, x, return_aux: bool):
    """Dense or MoE FFN; returns (out, MoE aux loss, or None for a dense
    FFN or without ``return_aux``)."""
    if cfg.family == "moe":
        routed, aux = moe_lib.moe_ffn(
            p["moe"], x, top_k=cfg.num_experts_per_tok,
            capacity_factor=cfg.capacity_factor, activation=cfg.activation,
            return_aux=return_aux)
        if cfg.moe_shared_ffn:
            routed = routed + mlp(p["mlp"], x, cfg.activation)
        return routed, aux
    return mlp(p["mlp"], x, cfg.activation), None


def _finish_layer(cfg: ModelConfig, p: Params, x, attn_out, norm, return_aux: bool = False):
    """Residual attention output, then the FFN block → (x, aux)."""
    b, s = x.shape[:2]
    x = x + attn_out.reshape(b, s, cfg.num_heads * cfg.hd) @ p["attn"]["wo"]
    h, aux = _ffn_block(cfg, p, norm(p["mlp_norm"], x), return_aux)
    return x + h, aux


def forward(cfg: ModelConfig, params: Params, tokens_or_embeds,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward → (logits (B, S, V) f32, MoE aux loss summed
    over the layers; 0 for dense). Takes token ids or (B, S, D) float
    embeddings."""
    _check_supported(cfg)
    _, norm = make_norm(cfg.norm)
    x = _embed_tokens(cfg, params, tokens_or_embeds)
    b, s = x.shape[:2]
    cos, sin = rope_frequencies(cfg.hd, s, cfg.rope_theta, device=x.device)
    positions = torch.arange(s, device=x.device).expand(b, s)
    aux = torch.zeros((), device=x.device)

    def layer(x, p):
        q, k, v = _qkv_rope(cfg, p, norm(p["attn_norm"], x), cos, sin, positions)
        return _finish_layer(cfg, p, x, kernel_ops.flash_attention(q, k, v, causal=True),
                             norm, return_aux=True)

    for p in layer_views(params["layers"], cfg.num_layers):
        x, layer_aux = remat(cfg.remat, layer, x, p)
        if layer_aux is not None:
            aux = aux + layer_aux
    x = norm(params["final_norm"], x)
    return _unembed(params, x), aux


def loss_fn(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            aux_weight: float = 0.01) -> torch.Tensor:
    """Next-token loss of ``batch`` ({"tokens" or "inputs", "labels"}) plus
    ``aux_weight`` times the MoE load-balance loss, as in JAX."""
    inputs = batch.get("inputs", batch.get("tokens"))
    logits, aux = forward(cfg, params, inputs)
    loss = softmax_cross_entropy(logits[:, :-1], batch["labels"][:, 1:])
    return loss + aux_weight * aux


# ------------------------------------------------------------------ serving
def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> Dict[str, torch.Tensor]:
    return attn_lib.init_kv_cache(
        cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.hd, cfg.cdtype,
        device=device)


def _rope_for(cfg: ModelConfig, cache, rope: Optional[Rope]) -> Rope:
    if rope is not None:
        return rope
    # the JAX package's (max_seq_len, D/2) table: decode positions run past
    # the cache's S_max when plen + gen_len - 1 > max_len
    return rope_frequencies(cfg.hd, cfg.max_seq_len, cfg.rope_theta,
                            device=cache["k"].device)


def prefill(cfg: ModelConfig, params: Params, tokens, cache: Dict[str, torch.Tensor],
            rope: Optional[Rope] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run the prompt; write K/V for all layers into ``cache`` in place;
    return (last-position logits (B, 1, V) f32, cache)."""
    _check_supported(cfg)
    _, norm = make_norm(cfg.norm)
    x = _embed_tokens(cfg, params, tokens)
    b, s = x.shape[:2]
    cos, sin = _rope_for(cfg, cache, rope)
    positions = torch.arange(s, device=x.device).expand(b, s)
    k_layers = torch.unbind(cache["k"], 0)
    v_layers = torch.unbind(cache["v"], 0)
    for p, kc, vc in zip(layer_views(params["layers"], cfg.num_layers), k_layers, v_layers):
        q, k, v = _qkv_rope(cfg, p, norm(p["attn_norm"], x), cos, sin, positions)
        out = kernel_ops.flash_attention(q, k, v, causal=True)
        kc[:, :s].copy_(k)
        vc[:, :s].copy_(v)
        x, _ = _finish_layer(cfg, p, x, out, norm)
    cache["len"].fill_(s)
    x_last = norm(params["final_norm"], x[:, -1:])
    return _unembed(params, x_last), cache


def decode_step(cfg: ModelConfig, params: Params, tokens, cache: Dict[str, torch.Tensor],
                rope: Optional[Rope] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step, in place. tokens: (B, 1) int → (logits (B, 1, V), cache).

    The position, the cache write index and the attended length all derive
    from the device-side ``cache["len"]``: no host sync. Past the cache's
    end the step does what the JAX package's does: the RoPE row of a
    position past the table is its last row (a gather clamps), the write
    lands on the last cache row (``dynamic_update_slice`` clamps), and
    every row is attended (the kernel clamps the length to S_max).
    """
    _check_supported(cfg)
    _, norm = make_norm(cfg.norm)
    x = _embed_tokens(cfg, params, tokens)
    b = x.shape[0]
    cos, sin = _rope_for(cfg, cache, rope)
    cache_len = cache["len"]
    pos = cache_len.reshape(1).long()
    positions = pos.clamp(max=cos.shape[0] - 1).reshape(1, 1).expand(b, 1)
    write_at = attn_lib.clamp_start(pos, cache["k"].shape[2])
    lengths = (cache_len + 1).reshape(1)  # includes the token written now
    k_layers = torch.unbind(cache["k"], 0)
    v_layers = torch.unbind(cache["v"], 0)
    for p, kc, vc in zip(layer_views(params["layers"], cfg.num_layers), k_layers, v_layers):
        q, k, v = _qkv_rope(cfg, p, norm(p["attn_norm"], x), cos, sin, positions)
        attn_lib.cache_update_layer(kc, vc, k, v, write_at)
        out = kernel_ops.decode_attention(q, kc, vc, lengths)
        x, _ = _finish_layer(cfg, p, x, out, norm)
    cache["len"].add_(1)
    x = norm(params["final_norm"], x)
    return _unembed(params, x), cache
