"""Encoder-decoder transformer (SeamlessM4T v2 text/speech backbone).

The counterpart of the JAX package's ``models/encdec.py``, with the same
param tree (``embed``, ``enc_layers``, ``enc_norm``, ``dec_layers`` with
``cross`` and ``cross_norm``, ``final_norm``, ``lm_head``), so
``convert.from_jax`` carries the weights unchanged, and the same cache
(``k``, ``v``, ``len``, ``memory``), so a cache crosses between the
packages. As in the JAX package the speech frontend is a stub: the inputs
are ``{"frames": (B, S_enc, D) embeddings, "tokens": (B, S_dec) ids}``.

Attention goes through ``kernels/ops.py``, as in every other family:

* encoder self-attention, Sq = Sk = S_enc: ``flash_attention(causal=False)``;
* decoder self-attention at prefill: ``flash_attention(causal=True)``;
* cross-attention at prefill, the prompt's rows over S_enc encoder
  frames: ``flash_attention(causal=False)`` with Sq != Sk;
* decoder self-attention at decode: ``decode_attention`` over the cache;
* cross-attention at decode: ``decode_attention`` over all S_enc frames.

So a prefill launches the flash kernel three times a layer pair and a
decode step the decode kernel twice a decoder layer. As in the JAX
package, each decode step recomputes the cross K/V from ``memory`` (the
cache holds the encoder output, not its projections). Decoding past the
cache's end does what the JAX package's does, as in the dense model: the
RoPE position clamps to the table, the write to the last cache row.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (
    dense_init,
    embed_init,
    init_mlp,
    layer_views,
    make_norm,
    mlp,
    remat,
    rope_frequencies,
    softmax_cross_entropy,
    unembed,
)
from repro_torch.models.transformer import _qkv_rope, _rope_for

Params = Dict[str, Any]
Rope = Tuple[torch.Tensor, torch.Tensor]


# ------------------------------------------------------------------- params
def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random params on ``gen``'s device, stacked on a leading layer axis."""
    init_norm, _ = make_norm(cfg.norm)
    dev = gen.device

    def block(n_layers: int, cross: bool) -> Params:
        lead = (n_layers,)
        p = {
            "attn_norm": init_norm(cfg.d_model, cfg.dtype, dev, lead),
            "attn": attn_lib.init_attention(gen, cfg.d_model, cfg.num_heads,
                                            cfg.num_kv_heads, cfg.hd, cfg.dtype, lead=lead),
            "mlp_norm": init_norm(cfg.d_model, cfg.dtype, dev, lead),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation, cfg.dtype, lead=lead),
        }
        if cross:
            p["cross_norm"] = init_norm(cfg.d_model, cfg.dtype, dev, lead)
            p["cross"] = attn_lib.init_attention(gen, cfg.d_model, cfg.num_heads,
                                                 cfg.num_kv_heads, cfg.hd, cfg.dtype,
                                                 lead=lead)
        return p

    return {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, cfg.dtype),
        "enc_layers": block(cfg.encoder_layers, cross=False),
        "enc_norm": init_norm(cfg.d_model, cfg.dtype, dev),
        "dec_layers": block(cfg.num_layers, cross=True),
        "final_norm": init_norm(cfg.d_model, cfg.dtype, dev),
        "lm_head": dense_init(gen, cfg.d_model, cfg.vocab_size, cfg.dtype,
                              scale=1.0 / math.sqrt(cfg.d_model)),
    }


# ------------------------------------------------------------------ encoder
def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, S_enc, D) stub embeddings → encoder memory (B, S_enc, D)."""
    _, norm = make_norm(cfg.norm)
    x = frames.to(cfg.cdtype)
    b, s = x.shape[:2]
    cos, sin = rope_frequencies(cfg.hd, s, cfg.rope_theta, device=x.device)
    positions = torch.arange(s, device=x.device).expand(b, s)

    def attention(x, p):
        q, k, v = _qkv_rope(cfg, p, norm(p["attn_norm"], x), cos, sin, positions)
        out = kernel_ops.flash_attention(q, k, v, causal=False)
        return x + out.reshape(b, s, cfg.num_heads * cfg.hd) @ p["attn"]["wo"]

    def ffn(x, p):
        return x + mlp(p["mlp"], norm(p["mlp_norm"], x), cfg.activation)

    # Two calls a layer, not one: the caller holds a call's input until it
    # returns, so one call over the layer would keep its input alive through
    # the MLP, a (B, S, D) activation more than the prefill needs (0.27 GB
    # at B = 32 x 4096 frames). Under remat each block is a checkpoint of
    # its own (JAX checkpoints the layer: one saved input a layer, not two).
    for p in layer_views(params["enc_layers"], cfg.encoder_layers):
        x = remat(cfg.remat, attention, x, p)
        x = remat(cfg.remat, ffn, x, p)
    return norm(params["enc_norm"], x)


# ------------------------------------------------------------------ decoder
def _cross(cfg: ModelConfig, p: Params, h: torch.Tensor, memory: torch.Tensor,
           enc_len: Optional[torch.Tensor]) -> torch.Tensor:
    """Cross-attention of ``h`` (B, S, D) over ``memory`` (B, S_enc, D), its
    K/V projected here (no positional rotation on memory keys); one query
    row a sequence (decode) goes through the decode kernel over all
    ``enc_len`` frames."""
    b, s = h.shape[:2]
    sm = memory.shape[1]
    qc = (h @ p["cross"]["wq"]).reshape(b, s, cfg.num_heads, cfg.hd)
    kc = (memory @ p["cross"]["wk"]).reshape(b, sm, cfg.num_kv_heads, cfg.hd)
    vc = (memory @ p["cross"]["wv"]).reshape(b, sm, cfg.num_kv_heads, cfg.hd)
    if enc_len is None:
        return kernel_ops.flash_attention(qc, kc, vc, causal=False)
    return kernel_ops.decode_attention(qc, kc, vc, enc_len)


def _decoder_layer(cfg: ModelConfig, p: Params, x, attn_out, memory, enc_len, norm):
    """Residual self-attention output, cross-attention, then the MLP."""
    b, s = x.shape[:2]
    x = x + attn_out.reshape(b, s, cfg.num_heads * cfg.hd) @ p["attn"]["wo"]
    out = _cross(cfg, p, norm(p["cross_norm"], x), memory, enc_len)
    x = x + out.reshape(b, s, cfg.num_heads * cfg.hd) @ p["cross"]["wo"]
    return x + mlp(p["mlp"], norm(p["mlp_norm"], x), cfg.activation)


def _run_decoder(cfg: ModelConfig, params: Params, tokens, memory, rope, cache=None):
    """Prefill (``cache`` given: each layer's K/V written into it) or a
    full-sequence pass (each layer recomputed in the backward pass under
    ``cfg.remat``, as in JAX's train mode); causal self-attention over the
    tokens → the last layer's output (B, S, D), before the final norm."""
    _, norm = make_norm(cfg.norm)
    x = params["embed"][tokens].to(cfg.cdtype)
    b, s = x.shape[:2]
    cos, sin = rope
    positions = torch.arange(s, device=x.device).expand(b, s)

    def layer(x, p, memory, i):
        q, k, v = _qkv_rope(cfg, p, norm(p["attn_norm"], x), cos, sin, positions)
        out = kernel_ops.flash_attention(q, k, v, causal=True)
        if cache is not None:
            cache["k"][i, :, :s].copy_(k)
            cache["v"][i, :, :s].copy_(v)
        return _decoder_layer(cfg, p, x, out, memory, None, norm)

    for i, p in enumerate(layer_views(params["dec_layers"], cfg.num_layers)):
        x = remat(cfg.remat and cache is None, layer, x, p, memory, i)
    return x


def forward(cfg: ModelConfig, params: Params, inputs) -> Tuple[torch.Tensor, torch.Tensor]:
    """inputs: {"frames": (B, S_enc, D), "tokens": (B, S_dec)} → (logits
    (B, S_dec, V) f32, a zero aux loss)."""
    _, norm = make_norm(cfg.norm)
    memory = encode(cfg, params, inputs["frames"])
    tokens = inputs["tokens"]
    # the decoder's RoPE table is max_seq_len long, as in JAX
    rope = rope_frequencies(cfg.hd, cfg.max_seq_len, cfg.rope_theta, device=tokens.device)
    x = _run_decoder(cfg, params, tokens, memory, rope)
    x = norm(params["final_norm"], x)
    return unembed(params["embed"], x, params["lm_head"]), torch.zeros((), device=x.device)


def loss_fn(cfg: ModelConfig, params: Params, batch) -> torch.Tensor:
    """Next-token loss of ``batch`` ({"frames", "tokens", "labels"}), as in JAX."""
    logits, _ = forward(cfg, params, batch)
    return softmax_cross_entropy(logits[:, :-1], batch["labels"][:, 1:])


# ------------------------------------------------------------------ serving
def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> Dict[str, torch.Tensor]:
    c = attn_lib.init_kv_cache(cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.hd,
                               cfg.cdtype, device=device)
    c["memory"] = torch.zeros((batch, cfg.frontend_seq or 1, cfg.d_model), dtype=cfg.cdtype,
                              device=device)
    return c


def prefill(cfg: ModelConfig, params: Params, inputs, cache: Dict[str, torch.Tensor],
            rope: Optional[Rope] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Encode ``inputs["frames"]``, then run the decoder over
    ``inputs["tokens"]``: each layer's K/V written into ``cache`` in place,
    ``cache["memory"]`` set to the encoder output (of the frames' length,
    as in JAX) → (last-position logits (B, 1, V) f32, cache)."""
    _, norm = make_norm(cfg.norm)
    memory = encode(cfg, params, inputs["frames"])
    tokens = inputs["tokens"]
    x = _run_decoder(cfg, params, tokens, memory, _rope_for(cfg, cache, rope), cache=cache)
    cache["len"].fill_(tokens.shape[1])
    cache["memory"] = memory
    x_last = norm(params["final_norm"], x[:, -1:])
    return unembed(params["embed"], x_last, params["lm_head"]), cache


def decode_step(cfg: ModelConfig, params: Params, tokens, cache: Dict[str, torch.Tensor],
                rope: Optional[Rope] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step, in place. tokens: (B, 1) int → (logits (B, 1, V), cache).

    Self-attention as the dense model's decode step (position, write index
    and length from the device-side ``cache["len"]``, clamped as JAX
    clamps past the cache's end); cross-attention over every frame of
    ``cache["memory"]``, its K/V recomputed from it, as in JAX.
    """
    _, norm = make_norm(cfg.norm)
    x = params["embed"][tokens].to(cfg.cdtype)
    b = x.shape[0]
    memory = cache["memory"]
    cos, sin = _rope_for(cfg, cache, rope)
    cache_len = cache["len"]
    pos = cache_len.reshape(1).long()
    positions = pos.clamp(max=cos.shape[0] - 1).reshape(1, 1).expand(b, 1)
    write_at = attn_lib.clamp_start(pos, cache["k"].shape[2])
    lengths = (cache_len + 1).reshape(1)  # includes the token written now
    enc_len = torch.full((1,), memory.shape[1], dtype=torch.int32, device=x.device)
    layers = layer_views(params["dec_layers"], cfg.num_layers)
    for p, kc, vc in zip(layers, torch.unbind(cache["k"], 0), torch.unbind(cache["v"], 0)):
        q, k, v = _qkv_rope(cfg, p, norm(p["attn_norm"], x), cos, sin, positions)
        attn_lib.cache_update_layer(kc, vc, k, v, write_at)
        out = kernel_ops.decode_attention(q, kc, vc, lengths)
        x = _decoder_layer(cfg, p, x, out, memory, enc_len, norm)
    cache["len"].add_(1)
    x = norm(params["final_norm"], x)
    return unembed(params["embed"], x, params["lm_head"]), cache
