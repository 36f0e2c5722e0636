"""Mixture-of-Experts FFN with sort-based token dispatch, single device.

The JAX package's ``models/moe.py`` has three paths; this is its global
(no-mesh) one, ``_moe_global``, step for step: (token, choice) pairs are
sorted by expert id (a stable sort), each pair's position within its
expert comes from the sorted order, and tokens go into a capacity-bounded
(E, C, D) buffer, overflow dropped (standard capacity-factor semantics).
The router runs in f32, with the Switch-style load-balance loss. The
shard-map paths (expert parallelism over a mesh) are not ported.

Two rules the serving path adds, neither of which changes the numbers:

* **No host sync**, so a decode loop that calls this is captured into one
  CUDA graph: no boolean indexing, no ``.item()``; the capacity comes
  from the static shapes.
* **Deterministic on the card**: the JAX package scatters with ``.at[].add``;
  here the dispatch is a gather (slot c of expert e holds the sorted pair
  ``start[e] + c`` when expert e has more than c pairs, else zeros) and the
  combine a gather through the inverse permutation and a sum over the K
  choices, with no float atomics, so two runs give the same bits. A
  dropped pair adds zeros in the JAX scatter; here it is a zero weight.

There is no Pallas kernel here in the reference, so none here: the two
expert products are ``torch.bmm`` over (E, C, D) × (E, D, 2F) and
(E, C, F) × (E, F, D).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.models.layers import GATED_ACTIVATIONS, activation_fn, dense_init, normal_init


def init_moe(gen: torch.Generator, d_model: int, num_experts: int, expert_d_ff: int,
             activation: str, dtype, lead: Sequence[int] = ()) -> dict:
    """Router (D, E) in f32 (the softmax over experts is precision-sensitive),
    experts in ``dtype``:
    ``wi`` (E, D, 2, F) for a gated activation (gate and up on their own
    axis, as the JAX package stores them), else (E, D, F); ``wo`` (E, F, D).
    ``lead`` is the stacked layer axis."""
    gated = activation in GATED_ACTIVATIONS
    wi_shape = ((num_experts, d_model, 2, expert_d_ff) if gated
                else (num_experts, d_model, expert_d_ff))
    return {
        "router": dense_init(gen, d_model, num_experts, torch.float32, lead=lead),
        "wi": normal_init(gen, (*lead, *wi_shape), 1.0 / math.sqrt(d_model), dtype),
        "wo": normal_init(gen, (*lead, num_experts, expert_d_ff, d_model),
                          1.0 / math.sqrt(expert_d_ff), dtype),
    }


def expert_capacity(num_tokens: int, num_experts: int, top_k: int,
                    capacity_factor: float, multiple_of: int = 8) -> int:
    cap = math.ceil(num_tokens * top_k * capacity_factor / num_experts)
    return max(multiple_of, multiple_of * math.ceil(cap / multiple_of))


def moe_ffn(p: dict, x: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25,
            activation: str = "silu", return_aux: bool = True,
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Routed expert FFN. x: (B, S, D) → (B, S, D), aux-loss scalar (f32;
    None when ``return_aux`` is off: serving launches nothing for it)."""
    b, s, d = x.shape
    t = b * s
    e = p["router"].shape[-1]
    cap = expert_capacity(t, e, top_k, capacity_factor)
    dev = x.device
    xf = x.reshape(t, d)

    # ---- router (f32) ----
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)  # (T, E)
    gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)  # (T, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # ---- sort (token, choice) pairs by expert ----
    flat_e = expert_idx.reshape(t * top_k)
    sort_order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_order]
    experts = torch.arange(e, device=dev)
    # first and one-past-last sorted index of each expert
    expert_start = torch.searchsorted(sorted_e, experts, right=False)
    expert_end = torch.searchsorted(sorted_e, experts, right=True)
    pos_in_expert = torch.arange(t * top_k, device=dev) - expert_start[sorted_e]
    keep = pos_in_expert < cap
    slot = torch.where(keep, pos_in_expert, 0)
    token_of = sort_order // top_k  # original token index per sorted pair

    # ---- dispatch: the (E, C, D) buffer, gathered ----
    slots = torch.arange(cap, device=dev)
    src = expert_start[:, None] + slots[None, :]  # (E, C) sorted pair per slot
    filled = src < expert_end[:, None]
    src = torch.where(filled, src, 0)
    expert_in = torch.where(filled[..., None], xf[token_of[src]], 0)

    # ---- expert computation ----
    act = activation_fn(activation)
    wi = p["wi"]
    if wi.dim() == 4:  # gated storage (E, D, 2, F) → fused (E, D, 2F)
        wi = wi.reshape(wi.shape[0], wi.shape[1], -1)
    h = torch.bmm(expert_in, wi)
    if activation in GATED_ACTIVATIONS:
        g, u = torch.chunk(h, 2, dim=-1)
        h = act(g) * u
    else:
        h = act(h)
    expert_out = torch.bmm(h, p["wo"])  # (E, C, D)

    # ---- combine: gather back and weight by (renormalised) gates ----
    contrib = expert_out[sorted_e, slot]  # (T·K, D), expert-sorted order
    w = gate_vals.reshape(t * top_k)[sort_order].to(contrib.dtype)
    contrib = contrib * (w * keep.to(contrib.dtype))[:, None]
    inverse = torch.argsort(sort_order)  # sorted position of each (token, choice)
    y = contrib[inverse].reshape(t, top_k, d).sum(dim=1)

    # ---- Switch-style load-balance auxiliary loss ----
    aux = None
    if return_aux:
        me = probs.mean(dim=0)  # mean router prob per expert
        pe = (expert_idx[:, :1] == experts).float().mean(dim=0)  # top-1 share per expert
        aux = e * torch.sum(me * pe)
    return y.reshape(b, s, d).to(x.dtype), aux
