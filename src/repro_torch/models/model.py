"""Model facade: one uniform API over the ported architecture families.

    model = Model(cfg)
    params = model.init(torch.Generator(device).manual_seed(0))
    logits, cache = model.prefill(params, tokens, cache)
    logits, cache = model.decode_step(params, tokens, cache)

Every family of the JAX package is ported: dense, moe and vlm (the decoder
transformer), ssm (xLSTM), hybrid (Zamba2) and encdec (SeamlessM4T, whose
``prefill`` and ``forward`` take ``{"frames", "tokens"}``, as in JAX).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, hybrid, transformer, xlstm_model

Params = Dict[str, Any]

_FAMILY_MODULES = {
    "dense": transformer,
    "moe": transformer,
    "vlm": transformer,
    "ssm": xlstm_model,
    "hybrid": hybrid,
    "encdec": encdec,
}
#: Families whose attention takes RoPE tables (an engine builds them once).
#: The encoder-decoder's ``rope=`` is its decoder's table, built per call
#: when not given (the engine does not serve it); its encoder's is S_enc
#: rows, built from the frames' length at each call.
_ROPE_FAMILIES = ("dense", "moe", "vlm", "hybrid")
#: Families whose cache is recurrent state that prefill reads: a reused
#: cache must first be put back to ``init_cache``'s values. (The hybrid
#: family's prefill reads none of its state, so its cache is reused as is.)
_RECURRENT_FAMILIES = ("ssm",)


class Model:
    def __init__(self, cfg: ModelConfig):
        if cfg.family not in _FAMILY_MODULES:
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported to PyTorch yet; "
                f"ported: {sorted(_FAMILY_MODULES)}")
        self.cfg = cfg
        self._mod = _FAMILY_MODULES[cfg.family]
        self.uses_rope = cfg.family in _ROPE_FAMILIES
        self.recurrent = cfg.family in _RECURRENT_FAMILIES

    def init(self, gen: torch.Generator) -> Params:
        return self._mod.init_params(self.cfg, gen)

    def forward(self, params: Params, inputs) -> torch.Tensor:
        logits, _ = self._mod.forward(self.cfg, params, inputs)
        return logits

    def init_cache(self, batch: int, max_len: int, device=None):
        return self._mod.init_cache(self.cfg, batch, max_len, device=device)

    def reset_cache(self, cache):
        """Put a recurrent cache back to ``init_cache``'s values, in place."""
        return self._mod.reset_cache(self.cfg, cache)

    def prefill(self, params: Params, inputs, cache, rope=None):
        return self._mod.prefill(self.cfg, params, inputs, cache, rope=rope)

    def decode_step(self, params: Params, tokens, cache, rope=None):
        return self._mod.decode_step(self.cfg, params, tokens, cache, rope=rope)
