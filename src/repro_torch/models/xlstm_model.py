"""xLSTM LM (xLSTM[7:1]): super-blocks of ``mlstm_per_slstm`` mLSTM blocks
followed by one sLSTM block.

The JAX package's two-level ``lax.scan`` (over super-blocks, then over the
mLSTM stack) becomes two plain loops over per-block views of the same
stacked params: ``m_blocks`` leaves are ``(n_super, n_m, ...)``,
``s_blocks`` leaves ``(n_super, ...)``. ``shard_activation``, which does
nothing on one device, is dropped; ``cfg.remat`` recomputes each
super-block in the backward pass, as ``jax.checkpoint`` does in JAX.

The cache is recurrent state, not a KV cache: ``prefill`` reads it (the
mLSTM conv prefix, the sLSTM carry), so a reused cache must first be put
back to ``init_cache``'s values (:func:`reset_cache`). Prefill and decode
write it in place.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import xlstm as xl
from repro_torch.models.layers import (dense_init, embed_init, make_norm, remat,
                                        softmax_cross_entropy)

Params = Dict[str, Any]


def block_counts(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_super, n_mlstm_per_super). num_layers must divide evenly."""
    per = cfg.mlstm_per_slstm + 1
    if cfg.num_layers % per:
        raise ValueError(
            f"{cfg.name}: num_layers={cfg.num_layers} not divisible by "
            f"mlstm_per_slstm+1={per}")
    return cfg.num_layers // per, cfg.mlstm_per_slstm


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random params on ``gen``'s device, in the JAX package's tree."""
    init_norm, _ = make_norm(cfg.norm)
    n_super, n_m = block_counts(cfg)
    dev = gen.device
    return {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, cfg.dtype),
        "m_blocks": {
            "norm": init_norm(cfg.d_model, cfg.dtype, dev, (n_super, n_m)),
            "mlstm": xl.init_mlstm(gen, cfg.d_model, cfg.num_heads, cfg.dtype,
                                   lead=(n_super, n_m)),
        },
        "s_blocks": {
            "norm": init_norm(cfg.d_model, cfg.dtype, dev, (n_super,)),
            "slstm": xl.init_slstm(gen, cfg.d_model, cfg.num_heads, cfg.dtype,
                                   lead=(n_super,)),
        },
        "final_norm": init_norm(cfg.d_model, cfg.dtype, dev),
        "lm_head": dense_init(gen, cfg.d_model, cfg.vocab_size, cfg.dtype,
                              scale=1.0 / math.sqrt(cfg.d_model)),
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int = 0, device=None) -> Dict[str, Any]:
    """Recurrent state; ``max_len`` is ignored (O(1)-in-seq states)."""
    n_super, n_m = block_counts(cfg)
    return {
        "m": xl.init_mlstm_state(batch, cfg.d_model, cfg.num_heads, cfg.cdtype,
                                 lead=(n_super, n_m), device=device),
        "s": xl.init_slstm_state(batch, cfg.d_model, cfg.num_heads,
                                 lead=(n_super,), device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


def reset_cache(cfg: ModelConfig, cache: Dict[str, Any]) -> Dict[str, Any]:
    """Put ``init_cache``'s values back into ``cache``, in place."""
    m = cache["m"]
    m["conv"].zero_()
    m["cell"]["C"].zero_()
    m["cell"]["n"].zero_()
    m["cell"]["m"].fill_(xl.NEG_INF)
    for t in cache["s"].values():
        t.zero_()
    cache["len"].zero_()
    return cache


def _index(tree, *idx):
    """The same tree of views at ``t[idx]`` for every leaf."""
    if isinstance(tree, dict):
        return {k: _index(v, *idx) for k, v in tree.items()}
    return tree[idx]


def _run(cfg: ModelConfig, params: Params, tokens, cache: Optional[Dict[str, Any]],
         last_only: bool = False) -> torch.Tensor:
    """Logits (f32) of every position, or of the last one; with ``cache``
    the blocks read and write its state in place."""
    _, norm = make_norm(cfg.norm)
    n_super, n_m = block_counts(cfg)
    x = params["embed"][tokens].to(cfg.cdtype)

    def super_block(x, si, m_params, s_params):
        for mi in range(n_m):
            mp = _index(m_params, mi)
            mst = _index(cache["m"], si, mi) if cache is not None else None
            h, _ = xl.mlstm_block(mp["mlstm"], norm(mp["norm"], x), cfg.num_heads,
                                  state=mst, chunk=cfg.attn_q_chunk)
            x = x + h
        sst = _index(cache["s"], si) if cache is not None else None
        h, _ = xl.slstm_block(s_params["slstm"], norm(s_params["norm"], x), cfg.num_heads,
                              state=sst)
        return x + h

    for si in range(n_super):
        x = remat(cfg.remat and cache is None, super_block, x, si,
                  _index(params["m_blocks"], si), _index(params["s_blocks"], si))
    if last_only:  # per-position norm and projection: the last row alone
        x = x[:, -1:]
    x = norm(params["final_norm"], x)
    return (x @ params["lm_head"].to(x.dtype)).float()


def forward(cfg: ModelConfig, params: Params, tokens) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward → (logits (B, S, V) f32, aux loss 0)."""
    logits = _run(cfg, params, tokens, None)
    return logits, torch.zeros((), device=logits.device)


def loss_fn(cfg: ModelConfig, params: Params, batch) -> torch.Tensor:
    """Next-token loss of ``batch`` ({"tokens", "labels"}), as in JAX."""
    logits, _ = forward(cfg, params, batch.get("inputs", batch.get("tokens")))
    return softmax_cross_entropy(logits[:, :-1], batch["labels"][:, 1:])


def prefill(cfg: ModelConfig, params: Params, tokens, cache: Dict[str, Any],
            rope=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the prompt from the state in ``cache`` and leave the state after
    it there (in place) → (last-position logits (B, 1, V) f32, cache).
    ``rope`` is the engine's keyword for attention families; unused."""
    logits = _run(cfg, params, tokens, cache, last_only=True)
    cache["len"].add_(tokens.shape[1])
    return logits, cache


def decode_step(cfg: ModelConfig, params: Params, tokens, cache: Dict[str, Any],
                rope=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One token through the recurrent cells, in place → (logits (B, 1, V), cache)."""
    logits = _run(cfg, params, tokens, cache)
    cache["len"].add_(1)
    return logits, cache
