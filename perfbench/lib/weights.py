"""A cell's weights, made on the device from the run's seed.

The tree is the port's parameter layout (``Model.init_abstract()`` gives
its paths, shapes and dtypes on the meta device, with no draw); the values
are the benchmark's own: one draw per leaf, on a ``torch.Generator`` on
the card, in the dtype the leaf is served in. The program and the
reference get the same tensors.

Each leaf is filled by a rule found by its name (the last key of its
path). Biases and norm parameters are drawn away from 0 and 1, so that the
check sees them. A family's reference may add or override rules in its
``WEIGHTS`` table.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch


def _normal(scale: float, shift: float = 0.0):
    def fill(t: torch.Tensor, gen: torch.Generator) -> None:
        t.normal_(shift, scale, generator=gen)
    return fill


def _fan_in(t: torch.Tensor, gen: torch.Generator) -> None:
    """N(0, 1 / in_dim) for an ``(..., in, out)`` matrix."""
    t.normal_(0.0, 1.0 / math.sqrt(t.shape[-2]), generator=gen)


#: leaf name -> fill(tensor, generator)
RULES: Dict[str, Callable[[torch.Tensor, torch.Generator], None]] = {
    "embed": _normal(0.02),
    "lm_head": _fan_in,
    "wq": _fan_in, "wk": _fan_in, "wv": _fan_in, "wo": _fan_in, "wi": _fan_in,
    "bq": _normal(0.02), "bk": _normal(0.02), "bv": _normal(0.02),
    "bi": _normal(0.02), "bo": _normal(0.02),
    "scale": _normal(0.1, 1.0), "bias": _normal(0.1),
}


def _leaves(tree: Any, prefix: Tuple[str, ...] = ()):
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from _leaves(tree[k], prefix + (k,))


def _set(tree: Dict[str, Any], path: Tuple[str, ...], value: torch.Tensor) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def make(abstract: Any, seed: int, device, extra: Optional[Mapping] = None,
         into: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Fill a tree shaped as ``abstract`` (meta tensors) from ``seed`` on
    ``device``: new tensors, or, with ``into``, that tree's own tensors in
    place (a served pool's graphs keep reading them)."""
    rules = dict(RULES)
    rules.update(extra or {})
    gen = torch.Generator(device=device).manual_seed(seed)
    out: Dict[str, Any] = into if into is not None else {}
    given = dict(_leaves(into)) if into is not None else {}
    with torch.no_grad():
        for path, meta in _leaves(abstract):
            name = path[-1]
            if name not in rules:
                raise KeyError(f"no weight rule for leaf {'.'.join(path)}")
            t = given.get(path)
            if t is None:
                t = torch.empty(meta.shape, dtype=meta.dtype, device=device)
                _set(out, path, t)
            rules[name](t, gen)
    return out

