"""Shared building blocks: norms, activations, RoPE, projections, embeddings.

Plain functions on tensors, as in the JAX package: ``init_*`` builds a
params dict, the matching apply function consumes it. Weights keep the JAX
layout — ``(in, out)`` matrices, so ``x @ W`` needs no transpose.
Parameter dtype and compute dtype are decoupled (bf16 params and matmuls
with f32 norm and softmax accumulation on the card; f32 everywhere for the
CPU tests).
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

Params = Dict[str, Any]


# ----------------------------------------------------------------- init utils
#: f32 elements drawn at a time (512 MB): a large weight is drawn in row
#: blocks of at most this many elements, each cast into the result, so its
#: f32 draw never needs the whole tensor at once (kimi-k2's stacked expert
#: ``wi`` is 11.3 G elements a layer, a 45 GB f32 transient)
DRAW_ELEMENTS = 1 << 27


def normal_init(gen: torch.Generator, shape: Sequence[int], scale: float,
                dtype) -> torch.Tensor:
    """N(0, scale²) of ``shape`` in ``dtype`` on the generator's device.

    Allocated in ``dtype`` first, then filled a block of rows (over every
    axis but the last) at a time: each block is drawn in f32 and cast, as
    the JAX package draws f32 and casts. A tensor of at most
    :data:`DRAW_ELEMENTS` elements is one draw.
    """
    out = torch.empty(tuple(shape), dtype=dtype, device=gen.device)
    if out.is_meta:  # ``Model.init_abstract``: shapes and dtypes only
        return out
    rows = out.view(-1, out.shape[-1])
    step = max(1, DRAW_ELEMENTS // rows.shape[1])
    for r0 in range(0, rows.shape[0], step):
        r1 = min(r0 + step, rows.shape[0])
        draw = torch.randn((r1 - r0, rows.shape[1]), generator=gen, device=gen.device)
        rows[r0:r1] = draw.mul_(scale)
    return out


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               scale: Optional[float] = None, lead: Sequence[int] = ()) -> torch.Tensor:
    """N(0, 1/in_dim) weights of shape ``(*lead, in_dim, out_dim)``.

    ``lead`` is the stacked layer axis (and, for experts, the expert axis).
    """
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return normal_init(gen, (*lead, in_dim, out_dim), scale, dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype) -> torch.Tensor:
    return normal_init(gen, (vocab, dim), 0.02, dtype)


# ----------------------------------------------------------------------- norms
def init_rmsnorm(dim: int, dtype, device=None, lead: Sequence[int] = ()) -> Params:
    return {"scale": torch.ones((*lead, dim), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p["scale"].float()).to(x.dtype)


def init_layernorm(dim: int, dtype, device=None, lead: Sequence[int] = ()) -> Params:
    return {"scale": torch.ones((*lead, dim), dtype=dtype, device=device),
            "bias": torch.zeros((*lead, dim), dtype=dtype, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """f32 statistics, biased variance (``jnp.var``), eps 1e-6."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    centered = xf - mu
    var = torch.mean(centered * centered, dim=-1, keepdim=True)
    out = centered * torch.rsqrt(var + eps)
    return (out * p["scale"].float() + p["bias"].float()).to(x.dtype)


def make_norm(kind: str):
    """(init, apply) for ``ModelConfig.norm``."""
    if kind == "rmsnorm":
        return init_rmsnorm, rmsnorm
    if kind == "layernorm":
        return init_layernorm, layernorm
    raise ValueError(f"unknown norm {kind!r}")


# ----------------------------------------------------------------- activations
#: gated (GLU) families use fused wi = [gate|up]; ``geglu`` is the erf GELU
#: gated so (``transformers``' ``ACT2FN["gelu"]``, Zamba2's ``hidden_act``)
GATED_ACTIVATIONS = ("silu", "geglu")


def _relu2(x: torch.Tensor) -> torch.Tensor:
    """Squared ReLU (Primer / Nemotron-4)."""
    return torch.square(F.relu(x))


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def activation_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return _gelu_tanh
    if name == "geglu":
        return F.gelu
    if name == "relu":
        return F.relu
    if name == "relu2":
        return _relu2
    raise ValueError(f"unknown activation {name!r}")


# ------------------------------------------------------------------------ FFN
def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, activation: str,
             dtype, bias: bool = False, lead: Sequence[int] = ()) -> Params:
    gated = activation in GATED_ACTIVATIONS
    wi_out = 2 * d_ff if gated else d_ff
    p = {
        "wi": dense_init(gen, d_model, wi_out, dtype, lead=lead),
        "wo": dense_init(gen, d_ff, d_model, dtype, scale=1.0 / math.sqrt(d_ff),
                         lead=lead),
    }
    if bias:
        p["bi"] = torch.zeros((*lead, wi_out), dtype=dtype, device=gen.device)
        p["bo"] = torch.zeros((*lead, d_model), dtype=dtype, device=gen.device)
    return p


def mlp(p: Params, x: torch.Tensor, activation: str) -> torch.Tensor:
    act = activation_fn(activation)
    h = x @ p["wi"]
    if "bi" in p:
        h = h + p["bi"]
    if activation in GATED_ACTIVATIONS:
        gate, up = torch.chunk(h, 2, dim=-1)
        h = act(gate) * up
    else:
        h = act(h)
    out = h @ p["wo"]
    if "bo" in p:
        out = out + p["bo"]
    return out


# ----------------------------------------------------------------------- RoPE
def rope_frequencies(head_dim: int, max_len: int, theta: float,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Precompute f32 (cos, sin) tables of shape (max_len, head_dim // 2)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv = 1.0 / (theta ** exponent)
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Rotate split halves (not interleaved pairs). x: (B, S, H, D);
    positions: (B, S) absolute indices."""
    c = cos[positions][:, :, None, :]  # (B, S, 1, D/2)
    s = sin[positions][:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------- stacked layers
def layer_views(layers: Params, num_layers: int) -> List[Params]:
    """Per-layer views of the stacked layer params (no copies)."""
    if isinstance(layers, torch.Tensor):
        return list(torch.unbind(layers, 0))
    per_key = {k: layer_views(v, num_layers) for k, v in layers.items()}
    return [{k: per_key[k][i] for k in per_key} for i in range(num_layers)]


def _needs_grad(tree) -> bool:
    if isinstance(tree, torch.Tensor):
        return tree.requires_grad
    if isinstance(tree, dict):
        return any(_needs_grad(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_needs_grad(v) for v in tree)
    return False


def remat(enabled: bool, fn, *args):
    """``fn(*args)``; with ``enabled`` (``cfg.remat``), while a gradient is
    being taken (grad mode on and some tensor of ``args`` requiring grad),
    its activations are not kept but recomputed in the backward pass, as
    the JAX package's ``jax.checkpoint(..., policy=nothing_saveable)``
    around each layer body. Inference never enters the checkpoint. Pass
    the layer's param views in ``args`` so that their gradients reach the
    stacked leaves. The recomputation runs the kernels' plain versions if
    the forward did (it may run on autograd's own thread, outside the
    caller's ``ops.plain_versions()``)."""
    if not (enabled and torch.is_grad_enabled() and _needs_grad(args)):
        return fn(*args)
    from repro_torch.kernels import ops  # kernels/ref.py imports the models

    recompute = ops.plain_versions if ops.plain_active() else contextlib.nullcontext
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), recompute()))


# ----------------------------------------------------------------- embeddings
def unembed(table: torch.Tensor, x: torch.Tensor,
            head: Optional[torch.Tensor]) -> torch.Tensor:
    """Project to f32 vocab logits; ``head`` is None for tied embeddings."""
    w = head if head is not None else table.T
    return (x @ w.to(x.dtype)).float()


# --------------------------------------------------------------------- losses
def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token loss. logits: (..., V) f32; labels: (...) int.

    The JAX package takes the gold logit with a one-hot contraction, so that
    a vocab-sharded logits tensor reduces with a psum. On one device the
    port gathers it: ``sum(logits * onehot)`` is exactly the gold logit, so
    the value is the same, and no second (B, S, V) f32 tensor is made, nor
    its gradient (each 4096 × 151,936 × 4 B = 2.49 GB for qwen2-0.5b at
    B = 8, S = 512).
    """
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    nll = lse - gold
    if mask is not None:
        mask = mask.to(nll.dtype)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
