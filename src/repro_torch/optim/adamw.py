"""AdamW over the port's nested param dicts, with a configurable state
dtype and global-norm clipping.

The counterpart of the JAX package's ``optim/adamw.py``, with the same
numerics: the bias corrections ``b1 ** step`` in f32, the clip scale cast
to each gradient's dtype, the update in f32 cast back to the param's
dtype, weight decay on every float leaf (norms and embeddings too), and
integer leaves passed through untouched. The functions return new trees
and are meant to run under ``torch.no_grad()``. A gradient of None (a
float param the loss does not reach) counts as zeros, as JAX's would be.

State dtype matters at scale: bf16 first/second moments halve optimizer
memory; f32 is the default for small models.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.utils.tree import leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: Optional[float] = 1.0
    state_dtype: str = "float32"  # 'float32' | 'bfloat16'


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    mu: Any
    nu: Any


def init_state(config: AdamWConfig, params: Any) -> AdamWState:
    dt = getattr(torch, config.state_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt if p.is_floating_point() else p.dtype,
                           device=p.device)

    step_device = leaves(params)[0].device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=step_device),
        mu=tree_map(zeros, params),
        nu=tree_map(zeros, params),
    )


def global_norm(tree: Any) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.float())) for x in leaves(tree) if x is not None]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def apply_updates(config: AdamWConfig, params: Any, grads: Any,
                  state: AdamWState, lr_scale: torch.Tensor | float = 1.0,
                  ) -> Tuple[Any, AdamWState, dict]:
    """One AdamW step. Returns (params, state, metrics)."""
    gnorm = global_norm(grads)
    flat_p = leaves(params)
    flat_g = [torch.zeros_like(p) if g is None else g
              for p, g in zip(flat_p, leaves(grads, is_leaf=lambda x: x is None))]
    if config.grad_clip_norm is not None:
        scale = torch.clamp(config.grad_clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        flat_g = [g * scale.to(g.dtype) for g in flat_g]
    step = state.step + 1
    b1, b2 = config.b1, config.b2
    stepf = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=stepf.device), stepf)
    lr = config.learning_rate * lr_scale

    def upd(p, g, m, n):
        if not p.is_floating_point():
            return p, m, n
        gf = g.float()
        mf = m.float() * b1 + gf * (1 - b1)
        nf = n.float() * b2 + torch.square(gf) * (1 - b2)
        update = (mf / bc1) / (torch.sqrt(nf / bc2) + config.eps)
        update = update + config.weight_decay * p.float()
        p_new = p.float() - lr * update
        return p_new.to(p.dtype), mf.to(m.dtype), nf.to(n.dtype)

    out = [upd(p, g, m, n) for p, g, m, n in
           zip(flat_p, flat_g, leaves(state.mu), leaves(state.nu))]
    new_p = unflatten(params, [o[0] for o in out])
    new_m = unflatten(params, [o[1] for o in out])
    new_n = unflatten(params, [o[2] for o in out])
    return new_p, AdamWState(step, new_m, new_n), {"grad_norm": gnorm}


# -------------------------------------------------------------- LR schedules
def cosine_schedule(step: torch.Tensor, *, warmup: int, total: int,
                    min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_frac`` of peak."""
    s = torch.as_tensor(step).float()
    warm = s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(s < warmup, warm, cos)
