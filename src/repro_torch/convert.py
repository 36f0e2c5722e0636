"""Parameter bridge between the JAX package's params and the port's.

Both packages keep the same pytree: ``(in, out)`` weight matrices, the
stacked leading layer axis and the fused ``wi = [gate|up]``. So conversion
is a pure copy of every leaf — no transpose, no reordering. The input is
the JAX param tree already fetched to the host as numpy arrays.

An optimizer state crosses too: JAX's ``AdamWState`` (any NamedTuple with
the fields ``step``, ``mu``, ``nu``) becomes the port's, its step an int32
scalar and its moments trees of the params' structure, and back.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.optim.adamw import AdamWState


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


def _is_adamw_state(x) -> bool:
    return isinstance(x, tuple) and getattr(x, "_fields", None) == AdamWState._fields


def from_jax(params_np: Dict[str, Any], device=None, dtype=None) -> Dict[str, Any]:
    """Nested dict of numpy arrays → same nested dict of tensors on ``device``
    (cast to ``dtype`` when given, but for the :data:`KEEP_DTYPE` leaves).
    An ``AdamWState`` becomes the port's, ``dtype`` casting its moments."""
    if _is_adamw_state(params_np):
        step = torch.tensor(int(np.asarray(params_np.step)), dtype=torch.int32, device=device)
        return AdamWState(step, from_jax(params_np.mu, device, dtype),
                          from_jax(params_np.nu, device, dtype))
    if isinstance(params_np, dict):
        return {k: from_jax(v, device, None if k in KEEP_DTYPE else dtype)
                for k, v in params_np.items()}
    return _leaf_to_torch(params_np, device, dtype)


def to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """Nested dict of tensors → nested dict of numpy arrays on the host
    (bfloat16 leaves widen to float32, which holds them exactly). An
    ``AdamWState`` stays one, its step an int32 numpy scalar: JAX's
    ``AdamWState(*to_numpy(state))`` takes it back."""
    if _is_adamw_state(params):
        return AdamWState(np.asarray(int(params.step), np.int32), to_numpy(params.mu),
                          to_numpy(params.nu))
    if isinstance(params, dict):
        return {k: to_numpy(v) for k, v in params.items()}
    t = params.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
