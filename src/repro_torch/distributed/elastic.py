"""Elastic scaling: resume work on a different mesh than it was saved from.

Checkpoints (``repro_torch.distributed.checkpoint``, the JAX package's
layout, so either package's restores here) store full (unsharded) arrays
addressed by leaf path, so elasticity is a *placement* decision at restore
time: ``reshard(tree, mesh, cfg)`` derives each leaf's placements on the
new mesh from ``param_spec`` and places it with ``distribute_tensor``. A
job saved on one mesh restores onto another without any format
conversion; only divisibility constraints re-derive.

Every rank reads the whole checkpoint and keeps its own block
(``src_data_rank=None``: no collective). For the serving path, elasticity
is live: ``ReplicaPool.scale_to`` adds or retires replicas, and the proxy
control-plane snapshot carries over verbatim.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

from torch.distributed.tensor import distribute_tensor

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed.sharding import shard_params
from repro_torch.utils.tree import tree_map


def reshard(tree: Any, mesh, cfg: ModelConfig) -> Any:
    """Place a tree of full tensors onto ``mesh`` (DTensors), each leaf at
    the placements ``shard_params`` derives for it there."""
    return tree_map(
        lambda leaf, placements: distribute_tensor(leaf.to(mesh.device_type), mesh, placements,
                                                   src_data_rank=None),
        tree, shard_params(tree, mesh, cfg), is_leaf=lambda x: isinstance(x, list))


def restore_elastic(directory: str, like: Any, mesh, cfg: ModelConfig,
                    step: Optional[int] = None) -> Tuple[int, Any, dict]:
    """Restore the latest (or given) checkpoint onto an arbitrary mesh."""
    if step is None:
        step = ckpt.latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    tree, meta = ckpt.restore_checkpoint(directory, step, like)
    return step, reshard(tree, mesh, cfg), meta
