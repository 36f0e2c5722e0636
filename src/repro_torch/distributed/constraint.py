"""Best-effort activation sharding constraints.

``shard_activation(x, spec...)`` lays ``x`` out by ``spec`` using whatever
axes the ambient mesh actually has, skipping axes that don't divide the
dimension — JAX's rule — so code can state its *intent* (batch over
("pod","data"), vocab over "model") and still run with no mesh (the CPU
tests, one card) or a partial mesh.

``use_mesh(mesh)`` is the counterpart of JAX's ``with mesh:``: it makes a
``DeviceMesh`` ambient for the block, in this context (thread or task).

On a DTensor the constraint redistributes; a plain tensor is returned as
it is, since eager PyTorch has no compiler to take the hint. That is why
the port's models keep no ``shard_activation`` calls: in the JAX package
they are GSPMD hints, with no eager counterpart.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Tuple, Union

import torch
from torch.distributed.tensor import DTensor

from repro_torch.launch.mesh import axis_sizes

AxisSpec = Union[None, str, Tuple[str, ...]]

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` ambient within the block."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def ambient_mesh():
    """The mesh of the enclosing :func:`use_mesh` block, or None."""
    return _MESH.get()


def fixed_spec(shape: Tuple[int, ...], spec, mesh) -> tuple:
    """``spec`` cut to the axes ``mesh`` has whose product divides each dim
    (and is above 1); None where none is left."""
    sizes = axis_sizes(mesh)
    fixed = []
    for dim, axes in zip(shape, spec):
        if axes is None:
            fixed.append(None)
            continue
        if isinstance(axes, str):
            axes = (axes,)
        present = tuple(a for a in axes if a in sizes)
        size = math.prod(sizes[a] for a in present)
        if present and size > 1 and dim % size == 0:
            fixed.append(present if len(present) > 1 else present[0])
        else:
            fixed.append(None)
    return tuple(fixed)


def shard_activation(x: torch.Tensor, *spec: AxisSpec) -> torch.Tensor:
    """Lay a DTensor ``x`` out by ``spec`` where the ambient mesh allows it."""
    mesh = ambient_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    if len(spec) != x.dim():
        raise ValueError(f"spec rank {len(spec)} != array rank {x.dim()}")
    fixed = fixed_spec(tuple(x.shape), spec, mesh)
    if all(f is None for f in fixed):
        return x
    from repro_torch.distributed.sharding import to_placements

    return x.redistribute(mesh, to_placements(fixed, mesh))
