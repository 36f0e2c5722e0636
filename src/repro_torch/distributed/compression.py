"""Gradient compression for a data-parallel reduction.

The counterpart of the JAX package's ``distributed/compression.py``: two
schemes, usable as hooks around ``adamw.apply_updates``, over the port's
nested dicts of tensors.

* :func:`int8_compress` / :func:`int8_decompress` — per-tensor symmetric
  int8 quantization (4× traffic reduction vs f32, 2× vs bf16) with an f32
  scale per leaf.
* :class:`TopKCompressor` — top-k magnitude sparsification with **error
  feedback** (the residual is carried and added to the next step's
  gradient, preserving convergence; Stich et al., 2018).

These compress the *representation*; the collective that carries the
payload (values + indices) is the caller's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch

from repro_torch.utils.tree import leaves, tree_map, unflatten


# ------------------------------------------------------------------- int8
def int8_compress(tree: Any) -> Any:
    """Per-leaf symmetric int8 quantization: leaf → (q int8, scale f32)."""

    def one(x):
        if not x.is_floating_point():
            return (x, None)
        xf = x.float()
        scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
        q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
        return (q, scale)

    return tree_map(one, tree)


def _is_pair(t) -> bool:
    return isinstance(t, tuple) and not hasattr(t, "_fields")


def int8_decompress(ctree: Any, like: Any) -> Any:
    """Inverse of :func:`int8_compress` (dtype restored from ``like``)."""
    out = []
    for (q, scale), ref in zip(leaves(ctree, is_leaf=_is_pair), leaves(like)):
        out.append(q if scale is None else (q.float() * scale).to(ref.dtype))
    return unflatten(like, out)


# ------------------------------------------------------------------- top-k
@dataclasses.dataclass
class TopKState:
    residual: Any  # error-feedback memory, same structure as grads


class TopKCompressor:
    """Top-k magnitude sparsification with error feedback.

    ``compress`` returns (values, indices, shape) per leaf covering
    ``fraction`` of the entries; the untransmitted remainder accumulates in
    the residual and is re-injected next step.
    """

    def __init__(self, fraction: float = 0.01):
        if not 0 < fraction <= 1:
            raise ValueError("fraction must be in (0, 1]")
        self.fraction = fraction

    def init(self, grads: Any) -> TopKState:
        return TopKState(residual=tree_map(
            lambda g: torch.zeros_like(g, dtype=torch.float32), grads))

    def compress(self, grads: Any, state: TopKState) -> Tuple[Any, TopKState]:
        frac = self.fraction

        def one(g, r):
            flat = (g.float() + r).reshape(-1)
            k = max(1, int(flat.shape[0] * frac))
            _, idx = torch.topk(torch.abs(flat), k)
            sel = flat[idx]
            kept = torch.zeros_like(flat).index_put_((idx,), sel)
            new_r = flat - kept  # error feedback
            return (sel, idx, tuple(g.shape)), new_r.reshape(g.shape)

        outs = [one(g, r) for g, r in zip(leaves(grads), leaves(state.residual))]
        payload = unflatten(grads, [o[0] for o in outs])
        return payload, TopKState(residual=unflatten(grads, [o[1] for o in outs]))

    @staticmethod
    def decompress(payload: Any, like: Any) -> Any:
        out = []
        for (vals, idx, shape), ref in zip(
                leaves(payload, is_leaf=lambda t: isinstance(t, tuple) and len(t) == 3),
                leaves(like)):
            dense = torch.zeros(math.prod(shape), dtype=torch.float32, device=vals.device)
            out.append(dense.index_put_((idx,), vals).reshape(shape).to(ref.dtype))
        return unflatten(like, out)

    def compressed_bytes(self, grads: Any) -> int:
        total = 0
        for g in leaves(grads):
            k = max(1, int(g.numel() * self.fraction))
            total += k * (4 + 4)  # f32 value + int32 index
        return total
