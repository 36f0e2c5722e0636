"""Model facade: one uniform API over the ported architecture families.

    model = Model(cfg)
    params = model.init(torch.Generator(device).manual_seed(0))
    loss   = model.loss(params, batch)
    logits, cache = model.prefill(params, tokens, cache)
    logits, cache = model.decode_step(params, tokens, cache)

plus ``make_inputs(cfg, shape, gen)`` building real (random) inputs for a
:class:`ShapeCell` from an explicit generator, and ``input_specs(cfg,
shape)`` building the same inputs as meta tensors for the dry-run (shapes
and dtypes, no allocation), where the JAX package builds
``ShapeDtypeStruct`` stand-ins.

Every family of the JAX package is ported: dense, moe and vlm (the decoder
transformer), ssm (xLSTM), hybrid (Zamba2) and encdec (SeamlessM4T, whose
``prefill`` and ``forward`` take ``{"frames", "tokens"}``, as in JAX).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.kernels import ops as kernel_ops
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

    def init_abstract(self) -> Params:
        """The tree of :meth:`init` on the meta device: the same leaf paths,
        shapes and dtypes, no allocation and no random draw."""
        return self._mod.init_params(self.cfg, _MetaGenerator())

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The training loss of ``batch``. Attention, the mLSTM and the SSD
        scan run their plain versions on every device, as the JAX package
        trains through its plain jnp path: the kernels have no backward."""
        with kernel_ops.plain_versions():
            return self._mod.loss_fn(self.cfg, params, batch)

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


class _MetaGenerator(torch.Generator):
    """A generator whose ``device`` is the meta device: every ``init_*``
    places its tensors on ``gen.device``, and a draw on the meta device
    makes an empty tensor of the right shape and dtype."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def _token_spec(b: int, s: int) -> torch.Tensor:
    return torch.empty((b, s), dtype=torch.int32, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeCell) -> Dict[str, Any]:
    """Meta tensors for every input of the shape's step function, as the
    JAX package's ``input_specs`` builds ``ShapeDtypeStruct`` stand-ins:

    * ``train``:   the loss inputs (tokens or embeddings, and labels; the
      encoder-decoder's frames and tokens);
    * ``prefill``: a prompt of ``seq_len`` tokens and an empty cache;
    * ``decode``:  one new token and a cache of ``seq_len``.

    Caches come from ``init_cache(device="meta")``."""
    b, s = shape.global_batch, shape.seq_len
    model = Model(cfg)

    def frames():
        return torch.empty((b, cfg.frontend_seq or s, cfg.d_model), dtype=cfg.cdtype,
                           device="meta")

    if shape.kind == "train":
        if cfg.family == "encdec":
            return {"batch": {"frames": frames(), "tokens": _token_spec(b, s),
                              "labels": _token_spec(b, s)}}
        if cfg.embed_inputs:
            inputs = torch.empty((b, s, cfg.d_model), dtype=cfg.cdtype, device="meta")
            return {"batch": {"inputs": inputs, "labels": _token_spec(b, s)}}
        return {"batch": {"tokens": _token_spec(b, s), "labels": _token_spec(b, s)}}
    if shape.kind == "prefill":
        cache = model.init_cache(b, s, device="meta")
        if cfg.family == "encdec":
            return {"inputs": {"frames": frames(), "tokens": _token_spec(b, s)},
                    "cache": cache}
        return {"inputs": _token_spec(b, s), "cache": cache}
    if shape.kind == "decode":
        return {"tokens": _token_spec(b, 1), "cache": model.init_cache(b, s, device="meta")}
    raise ValueError(shape.kind)


def make_inputs(cfg: ModelConfig, shape: ShapeCell, gen: torch.Generator) -> Dict[str, Any]:
    """Random inputs for ``shape`` on ``gen``'s device, as the JAX package's
    ``make_inputs`` builds them: ``{"batch": ...}`` for a train cell (token
    ids and labels; float embeddings for ``embed_inputs``; frames and
    tokens for the encoder-decoder), a prompt and an empty cache for
    prefill, one token and a cache of ``seq_len - 1`` entries for decode.
    Caches come from the real ``init_cache``."""
    b, s = shape.global_batch, shape.seq_len
    dev = gen.device
    model = Model(cfg)

    def toks(bb, ss):
        return torch.randint(0, cfg.vocab_size, (bb, ss), generator=gen, device=dev,
                             dtype=torch.int32)

    def frames():
        return torch.randn((b, cfg.frontend_seq or s, cfg.d_model), generator=gen,
                           device=dev).to(cfg.cdtype)

    if shape.kind == "train":
        labels = toks(b, s)
        if cfg.family == "encdec":
            return {"batch": {"frames": frames(), "tokens": toks(b, s), "labels": labels}}
        if cfg.embed_inputs:
            inputs = torch.randn((b, s, cfg.d_model), generator=gen, device=dev)
            return {"batch": {"inputs": inputs.to(cfg.cdtype), "labels": labels}}
        return {"batch": {"tokens": toks(b, s), "labels": labels}}
    if shape.kind == "prefill":
        cache = model.init_cache(b, s, device=dev)
        if cfg.family == "encdec":
            return {"inputs": {"frames": frames(), "tokens": toks(b, s)}, "cache": cache}
        return {"inputs": toks(b, s), "cache": cache}
    if shape.kind == "decode":
        cache = model.init_cache(b, s, device=dev)
        cache["len"].fill_(s - 1)
        return {"tokens": toks(b, 1), "cache": cache}
    raise ValueError(shape.kind)
