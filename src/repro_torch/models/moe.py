"""Mixture-of-Experts FFN with sort-based token dispatch.

The JAX package's ``models/moe.py`` paths, both ported:

* the global (no-mesh) path, ``_moe_global``, step for step: (token,
  choice) pairs are sorted by expert id (a stable sort), each pair's
  position within its expert comes from the sorted order, and tokens go
  into a capacity-bounded (E, C, D) buffer, overflow dropped (standard
  capacity-factor semantics). The router runs in f32, with the
  Switch-style load-balance loss;
* the expert-parallel plans of ``_moe_shard_map``, taken when an ambient
  mesh (``distributed/constraint.py::use_mesh``) has a "model" axis that
  divides E and its DP axes divide T: each rank runs
  :func:`_local_dispatch_compute` on its experts, and explicit
  ``torch.distributed`` collectives over the mesh's groups do what
  ``shard_map``'s ``all_gather``/``psum`` do (:func:`_moe_expert_parallel`).

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

#: mesh axes the tokens shard over (pod-major), as ``launch/mesh.py::batch_axes``
DP_AXES = ("pod", "data")


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
    None when ``return_aux`` is off: serving launches nothing for it).

    Under an ambient mesh with a "model" axis that divides E, whose DP axes
    divide T = B·S, the expert-parallel plans run
    (:func:`_moe_expert_parallel`, as JAX's ``moe_ffn`` takes
    ``_moe_shard_map``); otherwise the global path below."""
    from repro_torch.distributed.constraint import ambient_mesh

    mesh = ambient_mesh()
    if mesh is not None and "model" in mesh.mesh_dim_names:
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        dp_n = math.prod(sizes.get(a, 1) for a in DP_AXES)
        if p["router"].shape[-1] % sizes["model"] == 0 and (x.shape[0] * x.shape[1]) % dp_n == 0:
            return _moe_expert_parallel(p, x, mesh, top_k=top_k,
                                        capacity_factor=capacity_factor,
                                        activation=activation, return_aux=return_aux)
    return _moe_global(p, x, top_k=top_k, capacity_factor=capacity_factor,
                       activation=activation, return_aux=return_aux)


def _moe_global(p: dict, x: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25,
                activation: str = "silu", return_aux: bool = True,
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Global (no-mesh) path: sort-based dispatch with capacity."""
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
    expert_out = _experts(expert_in, p["wi"], p["wo"], activation)  # (E, C, D)

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


# ------------------------------------------------------------ expert parallel
def _experts(expert_in: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
             activation: str) -> torch.Tensor:
    """(E, C, D) → (E, C, D) through each expert's FFN. A gated ``wi``
    (E, D, 2, F) holds gate and up on their own axis, so an F-shard of it
    is an aligned pair and the same product gives that shard's part."""
    act = activation_fn(activation)
    if wi.dim() == 4:  # gated storage (E, D, 2, F) → fused (E, D, 2F)
        wi = wi.reshape(wi.shape[0], wi.shape[1], -1)
    h = torch.bmm(expert_in, wi)
    if activation in GATED_ACTIVATIONS:
        g, u = torch.chunk(h, 2, dim=-1)
        h = act(g) * u
    else:
        h = act(h)
    return torch.bmm(h, wo)


def _local_dispatch_compute(xf: torch.Tensor, router: torch.Tensor, wi: torch.Tensor,
                            wo: torch.Tensor, *, e_loc: int, e_lo: int, top_k: int,
                            cap: int, activation: str, return_aux: bool,
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One rank's MoE: sort-based dispatch over the experts it owns.

    xf: (T_loc, D) this rank's tokens; router (D, E) whole; wi (E_loc, D,
    [2,] F_loc) / wo (E_loc, F_loc, D) the rank's experts ``e_lo ..
    e_lo + e_loc - 1`` (F whole or one F-shard). Returns (the partial y
    (T_loc, D) — the caller sums it over the ranks that split the experts
    and F —, the aux loss). A pure function of its inputs, as JAX's: the
    choices routed to other ranks' experts go to an overflow bucket
    ``e_loc`` that is dropped. Dispatch and combine are gathers, as in
    :func:`_moe_global`, with no float atomics, so two runs give the same
    bits.
    """
    t_loc, d = xf.shape
    dev = xf.device

    logits = xf.float() @ router.float()  # (T_loc, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    flat_e = expert_idx.reshape(t_loc * top_k)
    mine = (flat_e >= e_lo) & (flat_e < e_lo + e_loc)
    local_e = torch.where(mine, flat_e - e_lo, e_loc)

    sort_order = torch.argsort(local_e, stable=True)
    sorted_e = local_e[sort_order]
    buckets = torch.arange(e_loc + 1, device=dev)  # the owned experts and the overflow
    expert_start = torch.searchsorted(sorted_e, buckets, right=False)
    expert_end = torch.searchsorted(sorted_e, buckets, right=True)
    pos_in_expert = torch.arange(t_loc * top_k, device=dev) - expert_start[sorted_e]
    keep = (pos_in_expert < cap) & (sorted_e < e_loc)
    slot = torch.where(keep, pos_in_expert, 0)
    token_of = sort_order // top_k

    slots = torch.arange(cap, device=dev)
    src = expert_start[:e_loc, None] + slots[None, :]  # (E_loc, C)
    filled = src < expert_end[:e_loc, None]
    src = torch.where(filled, src, 0)
    expert_in = torch.where(filled[..., None], xf[token_of[src]], 0)

    expert_out = _experts(expert_in, wi, wo, activation)  # (E_loc, C, D)

    contrib = expert_out[sorted_e.clamp(max=e_loc - 1), slot]
    w = gate_vals.reshape(t_loc * top_k)[sort_order].to(contrib.dtype)
    contrib = contrib * (w * keep.to(contrib.dtype))[:, None]
    inverse = torch.argsort(sort_order)
    y = contrib[inverse].reshape(t_loc, top_k, d).sum(dim=1)

    aux = None
    if return_aux:
        e = router.shape[-1]
        me = probs.mean(dim=0)
        pe = (expert_idx[:, :1] == torch.arange(e, device=dev)).float().mean(dim=0)
        aux = e * torch.sum(me * pe)
    return y, aux


def choose_plan(t: int, num_params_wio: int, itemsize: int, d: int, model_n: int,
                dp_n: int) -> str:
    """JAX's napkin rule: ``"token-route"`` where moving the tokens costs
    fewer bytes than gathering this rank's expert weights over DP (and
    there is a DP axis), else ``"weight-gather"``."""
    weight_gather_bytes = num_params_wio * itemsize // max(model_n, 1)
    token_route_bytes = 4 * t * d * itemsize
    return "token-route" if dp_n > 1 and token_route_bytes < weight_gather_bytes else "weight-gather"


def _groups(mesh, axes) -> list:
    """The process groups of ``axes`` (those the mesh has), in mesh order."""
    return [mesh.get_group(a) for a in mesh.mesh_dim_names if a in axes]


def _all_gather_cat(t: torch.Tensor, groups: list, dim: int) -> torch.Tensor:
    """Concatenate ``t`` over the ranks of ``groups`` along ``dim``, the
    last group innermost (pod-major, as JAX tiles a gather over a tuple of
    axes). A group of one rank has nothing to gather: ``t`` stays as it is
    (no copy of a layer's experts)."""
    import torch.distributed as dist

    for g in reversed(groups):
        n = dist.get_world_size(g)
        if n == 1:
            continue
        out = torch.empty((n * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t.contiguous(), group=g)
        t = out if dim == 0 else torch.cat(out.chunk(n, dim=0), dim=dim)
    return t


def _all_reduce(t: torch.Tensor, groups: list) -> torch.Tensor:
    import torch.distributed as dist

    for g in groups:
        dist.all_reduce(t, group=g)
    return t


def _local_block(t, mesh, spec) -> torch.Tensor:
    """This rank's block of ``t`` laid out by ``spec`` (a DTensor's local
    tensor, redistributed first if it is laid out otherwise; a plain tensor
    is the global value and is sliced)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.distributed.sharding import to_placements

    placements = to_placements(spec, mesh)
    if isinstance(t, DTensor):
        if list(t.placements) != placements:
            t = t.redistribute(mesh, placements)
        return t.to_local()
    return distribute_tensor(t, mesh, placements, src_data_rank=None).to_local()


def _moe_expert_parallel(p: dict, x, mesh, *, top_k: int, capacity_factor: float,
                         activation: str, return_aux: bool):
    """The expert-parallel plans of JAX's ``_moe_shard_map``, chosen by its
    napkin rule (:func:`choose_plan`), with the same capacities.

    Each argument is laid out as JAX's ``in_specs`` lay it out — tokens
    (T, D) over the DP axes, the router whole, ``wi`` (E, D, [2,] F) and
    ``wo`` (E, F, D) with E over "model" and F over "data" — from a DTensor
    (redistributed if it lies otherwise) or, for a plain tensor, taken as
    the global value every rank holds and sliced.

    * **weight-gather** (train/prefill, T large): each rank gathers its
      experts' F shards over "data" (``all_gather``), dispatches its own
      token slice (capacity from T_loc), and one ``all_reduce`` over
      "model" combines; the aux loss is averaged over DP.
    * **token-route** (decode, T small): the weights stay sharded; the
      tokens are gathered over DP, each rank computes its (experts,
      F-shard) part for all T tokens (capacity from T), one ``all_reduce``
      over "model" ∪ "data" combines and each rank keeps its token slice.

    The collectives are ``torch.distributed`` calls on the mesh's groups.
    The all-reduces run at every group size; a gather over one rank is
    skipped (it would only copy). On a CUDA tensor the groups must be
    NCCL's. The weight F-shards are gathered and summed over "data" only,
    the axis they are split over; JAX gathers and sums them over every DP
    axis, which on a mesh with "pod" counts each F-shard once a pod.

    Returns y as x came: a DTensor laid out like a DP-sharded x, or, for a
    plain x, the whole (B, S, D) on every rank (an all-gather over DP).
    """
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    if not dist.is_initialized():
        raise RuntimeError("moe_ffn: a mesh is ambient but there is no process group")
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    dp_axes = tuple(a for a in DP_AXES if a in sizes)
    data_ax = "data" if "data" in sizes else None
    model_n = sizes["model"]
    dp_n = math.prod(sizes[a] for a in dp_axes)
    dp_groups, data_groups = _groups(mesh, dp_axes), _groups(mesh, ("data",))
    model_groups = _groups(mesh, ("model",))
    if x.device.type == "cuda":
        bad = [dist.get_backend(g) for g in dp_groups + model_groups
               if dist.get_backend(g) != "nccl"]
        if bad:
            raise RuntimeError(f"moe_ffn: CUDA tensors need NCCL groups, got {bad}")

    b, s, d = x.shape
    t = b * s
    e = p["router"].shape[-1]
    e_loc = e // model_n
    t_loc = t // dp_n
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    e_lo = coord["model"] * e_loc
    r = 0
    for a in dp_axes:  # pod-major index of this rank's token slice
        r = r * sizes[a] + coord[a]

    dp_entry = (dp_axes if len(dp_axes) > 1 else dp_axes[0]) if dp_axes else None
    if isinstance(x, DTensor):
        xf = _local_block(x.reshape(t, d), mesh, (dp_entry, None))
    else:
        xf = x.reshape(t, d)[r * t_loc:(r + 1) * t_loc]
    router = _local_block(p["router"], mesh, (None, None))
    wi_spec = ("model", None, None, data_ax) if p["wi"].dim() == 4 else ("model", None, data_ax)
    wi = _local_block(p["wi"], mesh, wi_spec)
    wo = _local_block(p["wo"], mesh, ("model", data_ax, None))

    plan = choose_plan(t, p["wi"].numel() + p["wo"].numel(), x.element_size(), d, model_n, dp_n)
    if plan == "token-route":
        cap = expert_capacity(t, e, top_k, capacity_factor)
        x_all = _all_gather_cat(xf, dp_groups, dim=0)
        y_part, aux = _local_dispatch_compute(
            x_all, router, wi, wo, e_loc=e_loc, e_lo=e_lo, top_k=top_k, cap=cap,
            activation=activation, return_aux=return_aux)
        y_all = _all_reduce(y_part, model_groups + data_groups)
        y = y_all[r * t_loc:(r + 1) * t_loc]
    else:
        cap = expert_capacity(t_loc, e, top_k, capacity_factor)
        wi_full = _all_gather_cat(wi, data_groups, dim=wi.dim() - 1)
        wo_full = _all_gather_cat(wo, data_groups, dim=1)
        y, aux = _local_dispatch_compute(
            xf, router, wi_full, wo_full, e_loc=e_loc, e_lo=e_lo, top_k=top_k, cap=cap,
            activation=activation, return_aux=return_aux)
        y = _all_reduce(y, model_groups)
        if aux is not None:
            aux = _all_reduce(aux, dp_groups) / dp_n

    if isinstance(x, DTensor) and b % dp_n == 0:
        from repro_torch.distributed.sharding import to_placements

        y = DTensor.from_local(y.reshape(b // dp_n, s, d).to(x.dtype), mesh,
                               to_placements((dp_entry, None, None), mesh))
        return y, aux
    y = _all_gather_cat(y, dp_groups, dim=0)
    return y.reshape(b, s, d).to(x.dtype), aux
