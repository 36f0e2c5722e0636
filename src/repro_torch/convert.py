"""Parameter bridge between the JAX package's params and the port's.

Both packages keep the same pytree: ``(in, out)`` weight matrices, the
stacked leading layer axis and the fused ``wi = [gate|up]``. So conversion
is a pure copy of every leaf — no transpose, no reordering. The input is
the JAX param tree already fetched to the host as numpy arrays.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _leaf_to_torch(a, device, dtype) -> torch.Tensor:
    a = np.array(a)  # a writable copy: host arrays fetched from JAX are read-only
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: same bits as torch's
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


#: leaves that keep their own dtype under ``from_jax(..., dtype=)``: the MoE
#: router stays f32 beside bf16 experts, as both packages initialise it
KEEP_DTYPE = ("router",)


def from_jax(params_np: Dict[str, Any], device=None, dtype=None) -> Dict[str, Any]:
    """Nested dict of numpy arrays → same nested dict of tensors on ``device``
    (cast to ``dtype`` when given, but for the :data:`KEEP_DTYPE` leaves)."""
    if isinstance(params_np, dict):
        return {k: from_jax(v, device, None if k in KEEP_DTYPE else dtype)
                for k, v in params_np.items()}
    return _leaf_to_torch(params_np, device, dtype)


def to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """Nested dict of tensors → nested dict of numpy arrays on the host
    (bfloat16 leaves widen to float32, which holds them exactly)."""
    if isinstance(params, dict):
        return {k: to_numpy(v) for k, v in params.items()}
    t = params.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
