"""Device meshes: the counterpart of the JAX package's ``launch/mesh.py``.

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` built on an
initialised process group whose world size is the mesh's device count
(``init_process_group`` first: NCCL on the card, gloo on the CPU, or the
fake backend for the dry-run, which allocates nothing and runs one
process). The functions build nothing at import.

The shapes and axis names are JAX's, so the dry-run's records line up with
the JAX package's:

  single-pod:  (16, 16)      axes ("data", "model")
  multi-pod:   (2, 16, 16)   axes ("pod", "data", "model")

"model" carries tensor and expert parallelism, "data" FSDP and batch
parallelism, "pod" pure data parallelism. On H100 nodes eight GPUs share
one NVLink domain (NVSwitch, 450 GB/s a GPU each way), so with ranks laid
out row-major a 16-wide "model" axis spans two nodes and every "data"
neighbour is on another node: both axes cross InfiniBand (one 400 Gb/s
NDR port a GPU, 50 GB/s). The JAX package's mesh put "model" on a TPU
pod's inner ICI ring; no axis of 16 fits inside one H100 node.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device_type: Optional[str] = None) -> DeviceMesh:
    """A mesh of ``shape`` on axes ``axes`` over the default process group,
    whose world size must be the product of ``shape``. ``device_type``
    defaults to ``"cuda"`` under NCCL and ``"cpu"`` under any other
    backend (gloo; the dry-run's fake backend)."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; the process "
                         f"group has {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def axis_sizes(mesh) -> dict:
    """{axis name: size}, as JAX's ``mesh.shape``. Reads only the mesh's
    ``mesh_dim_names`` and ``shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def batch_axes(mesh) -> Tuple[str, ...]:
    """Axes the batch dimension shards over (pod+data when present)."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def mesh_devices(mesh) -> int:
    return int(math.prod(mesh.shape))
