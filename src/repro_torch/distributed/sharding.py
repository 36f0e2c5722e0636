"""Sharding rules: params (FSDP×TP×EP), optimizer state, inputs, caches.

The JAX package's rules, line for line (single-pod mesh ("data","model");
multi-pod adds a pure-DP "pod" axis in front):

  * weight matrices — contracting/output features over "model" (tensor
    parallel), the other large dim over "data" (FSDP: gathered on use,
    gradients reduce-scattered);
  * expert weights — experts over "model" (expert parallel), the expert
    FFN width F over "data";
  * embeddings / lm_head — vocab over "model", d_model over "data";
  * batch inputs — batch over ("pod","data"); when batch == 1 (long-context
    decode) the sequence dim shards over "data" instead (sequence
    parallelism);
  * KV caches / SSM states — batch over ("pod","data"); then the largest
    remaining dim divisible by "model" (kv-heads when they divide evenly,
    otherwise the cache sequence dim);
  * 1-D/small leaves — replicated.

Pattern overrides keep the out-projections ("wo", "out_proj", "down_proj")
sharded on their *contracting* dim so TP activations flow without an extra
all-gather (Megatron convention).

A spec is a tuple with one entry a tensor dim — None, an axis name, or a
tuple of axis names — the counterpart of JAX's ``PartitionSpec`` (and equal
to ``tuple(P(...))``). :func:`to_placements` turns one into the
``torch.distributed.tensor`` placements of a ``DeviceMesh``; the ``shard_*``
functions return trees of placements. A mesh is read only through
``mesh_dim_names`` and ``shape``.
"""
from __future__ import annotations

import math
import re
from typing import Any, Callable, List, Tuple

from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.launch.mesh import axis_sizes, batch_axes
from repro_torch.optim.adamw import AdamWState
from repro_torch.utils.tree import flatten_with_path, unflatten

Spec = Tuple[Any, ...]


def _axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)


def _batch_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return int(math.prod(sizes[a] for a in batch_axes(mesh)))


def leaf_path_str(path) -> str:
    return "/".join(path)


# ----------------------------------------------------------------- parameters
def param_spec(path: str, shape: Tuple[int, ...], mesh, cfg: ModelConfig) -> Spec:
    model_n = _axis_size(mesh, "model")
    data_n = _axis_size(mesh, "data")
    spec: list = [None] * len(shape)
    if len(shape) <= 1:
        return tuple(spec)

    dims = list(range(len(shape)))

    def assign(axis_name: str, dim: int) -> None:
        spec[dim] = axis_name
        dims.remove(dim)

    def divisible(dim: int, n: int) -> bool:
        return n > 1 and shape[dim] % n == 0 and shape[dim] >= 2 * n

    # -- pattern overrides ---------------------------------------------------
    low = path.lower()
    is_embed = re.search(r"(^|/)embed", low) and shape[-1] == cfg.d_model
    is_head = "lm_head" in low
    is_expert = re.search(r"moe/w[io]$", low) or (
        len(shape) >= 3 and cfg.num_experts and shape[-3] == cfg.num_experts
        and "conv" not in low)
    is_out_proj = re.search(r"(wo|out_proj|down_proj)$", low)

    if is_embed:
        # (V, D) or stacked (.., V, D): vocab → model, d_model → data
        if divisible(len(shape) - 2, model_n):
            assign("model", len(shape) - 2)
        if divisible(len(shape) - 1, data_n):
            assign("data", len(shape) - 1)
        return tuple(spec)
    if is_head:
        # (D, V): vocab → model, d_model → data
        if divisible(len(shape) - 1, model_n):
            assign("model", len(shape) - 1)
        if divisible(len(shape) - 2, data_n):
            assign("data", len(shape) - 2)
        return tuple(spec)
    if is_expert and cfg.num_experts:
        e_dim = next((d for d in dims if shape[d] == cfg.num_experts), None)
        if e_dim is not None and shape[e_dim] % model_n == 0:
            assign("model", e_dim)
        # FSDP over the expert FFN width — what the expert-parallel MoE
        # consumes (wi: (…, E, D, F) F→data; wo: (…, E, F, D) F→data).
        f_dim = len(shape) - 1 if low.endswith("wi") else len(shape) - 2
        if f_dim in dims and divisible(f_dim, data_n):
            assign("data", f_dim)
        else:
            cands = [d for d in dims if divisible(d, data_n)]
            if cands:
                assign("data", max(cands, key=lambda d: shape[d]))
        return tuple(spec)

    # -- generic matrices ----------------------------------------------------
    if is_out_proj:
        model_dim = len(shape) - 2  # contracting dim
        other = len(shape) - 1
    else:
        model_dim = len(shape) - 1  # output features
        other = len(shape) - 2
    if divisible(model_dim, model_n):
        assign("model", model_dim)
    if other in dims and divisible(other, data_n):
        assign("data", other)
    else:
        cands = [d for d in dims if divisible(d, data_n) and shape[d] >= 512]
        if cands:
            assign("data", max(cands, key=lambda d: shape[d]))
    return tuple(spec)


# ---------------------------------------------------------------- data/caches
def data_spec(shape: Tuple[int, ...], mesh, cfg: ModelConfig, global_batch: int) -> Spec:
    """Batch inputs: batch over ("pod","data"); seq over "data" if batch=1."""
    b_axes = batch_axes(mesh)
    bsz = _batch_size(mesh)
    spec: list = [None] * len(shape)
    if not shape:
        return ()
    if shape[0] == global_batch and global_batch % max(bsz, 1) == 0 and bsz > 1:
        spec[0] = b_axes if len(b_axes) > 1 else b_axes[0]
    elif len(shape) >= 2 and "data" in mesh.mesh_dim_names:
        # batch not shardable (e.g. 1): sequence parallelism over "data"
        if shape[1] % _axis_size(mesh, "data") == 0 and shape[1] >= 2 * _axis_size(mesh, "data"):
            spec[1] = "data"
    return tuple(spec)


def cache_spec(path: str, shape: Tuple[int, ...], mesh, cfg: ModelConfig,
               global_batch: int) -> Spec:
    model_n = _axis_size(mesh, "model")
    b_axes = batch_axes(mesh)
    bsz = _batch_size(mesh)
    spec: list = [None] * len(shape)
    if len(shape) == 0:
        return ()
    dims = list(range(len(shape)))
    # batch dim: first dim whose size == global_batch and shards evenly
    for d in dims:
        if shape[d] == global_batch and global_batch % max(bsz, 1) == 0 and bsz > 1:
            spec[d] = b_axes if len(b_axes) > 1 else b_axes[0]
            dims.remove(d)
            break
    # model dim: kv-heads if they divide; else largest divisible dim
    head_like = [d for d in dims
                 if shape[d] in (cfg.num_kv_heads, cfg.num_heads)
                 and shape[d] % model_n == 0 and model_n > 1]
    if head_like:
        spec[head_like[0]] = "model"
    else:
        cands = [d for d in dims
                 if model_n > 1 and shape[d] % model_n == 0 and shape[d] >= 2 * model_n]
        if cands:
            spec[max(cands, key=lambda d: shape[d])] = "model"
    return tuple(spec)


# ----------------------------------------------------------------- placements
def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(spec: Spec, mesh) -> List[Any]:
    """The DTensor placements of ``spec``, one a mesh dim: ``Shard(d)`` on
    every mesh dim that tensor dim d is split over, ``Replicate()`` on the
    others. A dim over ("pod", "data") is ``Shard(d)`` on both mesh dims;
    DTensor splits it over the earlier mesh dim first (pod-major), which
    is how JAX lays out a dim over a tuple of axes."""
    out: List[Any] = [Replicate() for _ in mesh.mesh_dim_names]
    for d, entry in enumerate(spec):
        for a in _axes_of(entry):
            out[mesh.mesh_dim_names.index(a)] = Shard(d)
    return out


def local_shape(shape: Tuple[int, ...], spec: Spec, mesh) -> Tuple[int, ...]:
    """One device's block of a tensor of ``shape`` laid out by ``spec``
    (every rule above splits only dims the axes divide)."""
    sizes = axis_sizes(mesh)
    return tuple(n // math.prod(sizes[a] for a in _axes_of(entry))
                 for n, entry in zip(shape, spec))


def map_with_path(fn: Callable[[str, Any], Any], tree: Any) -> Any:
    """``fn(path, leaf)`` over the leaves of ``tree``, the path joined by
    "/" as the JAX package names it."""
    flat = flatten_with_path(tree)
    return unflatten(tree, [fn(leaf_path_str(p), leaf) for p, leaf in flat])


def shard_params(params: Any, mesh, cfg: ModelConfig) -> Any:
    """Placements tree matching a (meta or concrete) param tree."""
    return map_with_path(
        lambda path, leaf: to_placements(param_spec(path, tuple(leaf.shape), mesh, cfg), mesh),
        params)


def shard_opt_state(opt: AdamWState, param_placements: Any, mesh) -> AdamWState:
    """Optimizer state mirrors the params' placements (mu/nu); the step is
    replicated."""
    return AdamWState(step=[Replicate() for _ in mesh.mesh_dim_names],
                      mu=param_placements, nu=param_placements)


def input_spec(path: str, shape: Tuple[int, ...], mesh, cfg: ModelConfig,
               shape_cell: ShapeCell, *, is_cache: bool = False) -> Spec:
    """:func:`cache_spec` for a cache leaf (``is_cache`` or "cache" in its
    path), else :func:`data_spec`."""
    if is_cache or "cache" in path:
        return cache_spec(path, shape, mesh, cfg, shape_cell.global_batch)
    return data_spec(shape, mesh, cfg, shape_cell.global_batch)


def shard_inputs(inputs: Any, mesh, cfg: ModelConfig, shape_cell: ShapeCell, *,
                 is_cache: bool = False) -> Any:
    """Placements tree for the step-function inputs of one dry-run cell.

    ``is_cache=True`` forces :func:`cache_spec` for every leaf (the cache
    argument is passed as a bare tree, so its leaf paths carry no "cache"
    marker).
    """
    return map_with_path(
        lambda path, leaf: to_placements(
            input_spec(path, tuple(leaf.shape), mesh, cfg, shape_cell, is_cache=is_cache),
            mesh),
        inputs)
