"""Zamba2-style hybrid: a stack of Mamba-2 blocks with a single *shared*
transformer block (attention + SwiGLU FFN, one set of weights) applied
before every ``attn_every``-th Mamba block. Each application of the shared
block has its own KV cache ("apps" axis).

The JAX package's layer scan with a ``lax.cond`` on a per-layer flag
becomes a loop over per-layer views of the same stacked params; the
shared block runs where the flag is set. ``shard_activation``, which does
nothing on one device, is dropped; ``cfg.remat`` recomputes each layer
body in the backward pass, as ``jax.checkpoint`` does in JAX. The shared
block's attention goes through ``kernels/ops.py`` (``flash_attention`` at
prefill, ``decode_attention`` at decode) and each Mamba block's prefill
scan through ``ops.ssd_scan``: the hand-written kernels on a CUDA device,
their plain versions on the CPU.

**Prefill reads no state of the cache.** It starts every Mamba block from
a zero SSD state and a zero conv prefix (what a fresh JAX cache gives),
then overwrites ``ssm_h``, ``ssm_conv``, the attention K/V rows
``[0:S]`` and ``len`` in place; decode attends only rows below ``len``.
So a pooled hybrid cache behaves like a KV cache: nothing stale is ever
read, and it needs no reset between batches. (The JAX ``_run_with_cache``
hands the cache's state to the prompt's scan and conv, so its pooled
engine leaks one batch's state into the next.)
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import attention as attn_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (
    apply_rope,
    dense_init,
    embed_init,
    init_mlp,
    layer_views,
    make_norm,
    mlp,
    remat,
    rope_frequencies,
    softmax_cross_entropy,
)

Params = Dict[str, Any]
Rope = Tuple[torch.Tensor, torch.Tensor]


def n_attn_apps(cfg: ModelConfig) -> int:
    return sum(1 for i in range(cfg.num_layers) if i % cfg.attn_every == 0)


def _attn_flags(cfg: ModelConfig) -> Tuple[List[bool], List[int]]:
    """Per layer: whether the shared block runs before it, and its
    application's index into the cache's apps axis (cumsum(flags) - 1)."""
    flags = [i % cfg.attn_every == 0 for i in range(cfg.num_layers)]
    app_idx, count = [], 0
    for f in flags:
        count += f
        app_idx.append(count - 1)
    return flags, app_idx


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random params on ``gen``'s device, in the JAX package's tree (Mamba
    leaves stacked on a leading layer axis; ``a_log``, ``dt_bias`` and
    ``d_skip`` stay f32 whatever the param dtype)."""
    init_norm, _ = make_norm(cfg.norm)
    dev, lead = gen.device, (cfg.num_layers,)
    return {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, cfg.dtype),
        "layers": {
            "norm": init_norm(cfg.d_model, cfg.dtype, dev, lead),
            "mamba": ssm_lib.init_mamba2(gen, cfg.d_model, cfg.ssm_state, cfg.dtype,
                                         head_dim=cfg.ssm_head_dim, lead=lead),
        },
        "shared": {
            "attn_norm": init_norm(cfg.d_model, cfg.dtype, dev),
            "attn": attn_lib.init_attention(gen, cfg.d_model, cfg.num_heads,
                                            cfg.num_kv_heads, cfg.hd, cfg.dtype),
            "mlp_norm": init_norm(cfg.d_model, cfg.dtype, dev),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation, cfg.dtype),
        },
        "final_norm": init_norm(cfg.d_model, cfg.dtype, dev),
        "lm_head": dense_init(gen, cfg.d_model, cfg.vocab_size, cfg.dtype,
                              scale=1.0 / math.sqrt(cfg.d_model)),
    }


def _shared_block(cfg: ModelConfig, shared: Params, x, cos, sin, positions,
                  mode: str, kv=None, write_at=None, lengths=None):
    """One application of the shared attention+FFN block.

    ``kv`` is this application's cache slice ``(k, v)``, each
    ``(B, S_max, Hkv, D)``, written in place: at prefill rows ``[0:S]``, at
    decode the row at ``write_at`` (a device tensor, already clamped into
    the cache), after which the block attends over ``lengths`` rows.
    """
    _, norm = make_norm(cfg.norm)
    h = norm(shared["attn_norm"], x)
    q, k, v = attn_lib.qkv_proj(shared["attn"], h, cfg.num_heads, cfg.num_kv_heads, cfg.hd)
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    if mode == "decode":
        k_cache, v_cache = kv
        attn_lib.cache_update_layer(k_cache, v_cache, k, v, write_at)
        out = kernel_ops.decode_attention(q, k_cache, v_cache, lengths)
    else:
        out = kernel_ops.flash_attention(q, k, v, causal=True)
        if kv is not None:
            s = x.shape[1]
            kv[0][:, :s].copy_(k)
            kv[1][:, :s].copy_(v)
    b, s = x.shape[:2]
    out = out.reshape(b, s, cfg.num_heads * cfg.hd) @ shared["attn"]["wo"]
    x = x + out
    return x + mlp(shared["mlp"], norm(shared["mlp_norm"], x), cfg.activation)


def _mamba(cfg: ModelConfig, layer: Params, x, state=None, step: bool = False):
    _, norm = make_norm(cfg.norm)
    h, _ = ssm_lib.mamba2_forward(
        layer["mamba"], norm(layer["norm"], x), d_state=cfg.ssm_state,
        head_dim=cfg.ssm_head_dim, chunk=cfg.ssm_chunk, state=state, step=step)
    return x + h


def _logits(cfg: ModelConfig, params: Params, x) -> torch.Tensor:
    _, norm = make_norm(cfg.norm)
    x = norm(params["final_norm"], x)
    return (x @ params["lm_head"].to(x.dtype)).float()


def forward(cfg: ModelConfig, params: Params, tokens) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward → (logits (B, S, V) f32, aux loss 0)."""
    x = params["embed"][tokens].to(cfg.cdtype)
    b, s = x.shape[:2]
    cos, sin = rope_frequencies(cfg.hd, s, cfg.rope_theta, device=x.device)
    positions = torch.arange(s, device=x.device).expand(b, s)
    flags, _ = _attn_flags(cfg)

    def body(x, layer, shared, is_attn):
        if is_attn:
            x = _shared_block(cfg, shared, x, cos, sin, positions, "train")
        return _mamba(cfg, layer, x)

    for layer, is_attn in zip(layer_views(params["layers"], cfg.num_layers), flags):
        x = remat(cfg.remat, body, x, layer, params["shared"], is_attn)
    return _logits(cfg, params, x), torch.zeros((), device=x.device)


def loss_fn(cfg: ModelConfig, params: Params, batch) -> torch.Tensor:
    """Next-token loss of ``batch`` ({"tokens", "labels"}), as in JAX."""
    logits, _ = forward(cfg, params, batch.get("inputs", batch.get("tokens")))
    return softmax_cross_entropy(logits[:, :-1], batch["labels"][:, 1:])


# ------------------------------------------------------------------ serving
def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> Dict[str, Any]:
    apps = n_attn_apps(cfg)
    d_inner = 2 * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_state
    kv_shape = (apps, batch, max_len, cfg.num_kv_heads, cfg.hd)
    return {
        "attn_k": torch.zeros(kv_shape, dtype=cfg.cdtype, device=device),
        "attn_v": torch.zeros(kv_shape, dtype=cfg.cdtype, device=device),
        "ssm_h": torch.zeros((cfg.num_layers, batch, n_heads, cfg.ssm_head_dim,
                              cfg.ssm_state), dtype=torch.float32, device=device),
        "ssm_conv": torch.zeros((cfg.num_layers, batch, 3, conv_dim), dtype=cfg.cdtype,
                                device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


def _rope_for(cfg: ModelConfig, cache, rope: Optional[Rope]) -> Rope:
    if rope is not None:
        return rope
    # the JAX package's (max_seq_len, D/2) table: decode positions run past
    # the cache's S_max when plen + gen_len - 1 > max_len
    return rope_frequencies(cfg.hd, cfg.max_seq_len, cfg.rope_theta,
                            device=cache["attn_k"].device)


def _run_with_cache(cfg: ModelConfig, params: Params, tokens, cache: Dict[str, Any],
                    mode: str, rope: Optional[Rope]) -> torch.Tensor:
    """Last-position logits (B, 1, V) f32; the cache is written in place."""
    x = params["embed"][tokens].to(cfg.cdtype)
    b, s = x.shape[:2]
    cos, sin = _rope_for(cfg, cache, rope)
    cache_len = cache["len"]
    decode = mode == "decode"
    write_at = lengths = None
    if decode:
        # past the cache's end, as the dense decode_step: the last RoPE
        # row, the last cache row, every row attended
        pos = cache_len.reshape(1).long()
        positions = pos.clamp(max=cos.shape[0] - 1).reshape(1, 1).expand(b, 1)
        write_at = attn_lib.clamp_start(pos, cache["attn_k"].shape[2])
        lengths = (cache_len + 1).reshape(1)
    else:
        positions = torch.arange(s, device=x.device).expand(b, s)
    flags, app_idx = _attn_flags(cfg)
    layers = layer_views(params["layers"], cfg.num_layers)
    for i, (layer, is_attn, app) in enumerate(zip(layers, flags, app_idx)):
        if is_attn:
            kv = (cache["attn_k"][app], cache["attn_v"][app])
            x = _shared_block(cfg, params["shared"], x, cos, sin, positions, mode,
                              kv=kv, write_at=write_at, lengths=lengths)
        state = {"h": cache["ssm_h"][i], "conv": cache["ssm_conv"][i]}
        x = _mamba(cfg, layer, x, state=state, step=decode)
    if decode:
        cache["len"].add_(1)
    else:
        cache["len"].fill_(s)
    return _logits(cfg, params, x[:, -1:])


def prefill(cfg: ModelConfig, params: Params, tokens, cache: Dict[str, Any],
            rope: Optional[Rope] = None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the prompt from a zero state (the cache's state is not read);
    write the state after it, the K/V rows ``[0:S]`` and ``len = S`` into
    ``cache`` in place → (last-position logits (B, 1, V) f32, cache)."""
    return _run_with_cache(cfg, params, tokens, cache, "prefill", rope), cache


def decode_step(cfg: ModelConfig, params: Params, tokens, cache: Dict[str, Any],
                rope: Optional[Rope] = None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One token from the cache's state, in place. tokens: (B, 1) int →
    (logits (B, 1, V) f32, cache). Position, K/V write index and attended
    length derive from the device-side ``len``: no host sync."""
    return _run_with_cache(cfg, params, tokens, cache, "decode", rope), cache
