"""Nested-dict trees of tensors, flattened in JAX's pytree order.

The port keeps params, optimizer state and gradients as nested dicts (and
the optimizer's ``AdamWState`` NamedTuple), as the JAX package keeps its
pytrees. These helpers walk them in the order ``jax.tree_util`` does —
dict keys sorted, a NamedTuple's fields and a list's items in order, None
an empty subtree — so a flattened tree lines up leaf for leaf with the
JAX package's (the checkpoint layout restores by position).
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional, Tuple

Path = Tuple[str, ...]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_path(tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None,
                      ) -> List[Tuple[Path, Any]]:
    """[(key path, leaf)] in JAX's flatten order."""
    return list(_walk(tree, (), is_leaf))


def _walk(tree, path: Path, is_leaf) -> Iterator[Tuple[Path, Any]]:
    if is_leaf is not None and is_leaf(tree):
        yield path, tree
    elif tree is None:
        return
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (str(k),), is_leaf)
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from _walk(getattr(tree, name), path + (name,), is_leaf)
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _walk(x, path + (str(i),), is_leaf)
    else:
        yield path, tree


def leaves(tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None) -> List[Any]:
    return [leaf for _, leaf in _walk(tree, (), is_leaf)]


def unflatten(like: Any, new_leaves, is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """``like``'s structure (dict key order kept) with ``new_leaves`` in
    flatten order."""
    it = iter(new_leaves)
    out = _rebuild(like, it, is_leaf)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree has")
    return out


_END = object()


def _rebuild(tree, it, is_leaf):
    if is_leaf is not None and is_leaf(tree):
        return next(it)
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = dict.fromkeys(tree)
        for k in sorted(tree):
            out[k] = _rebuild(tree[k], it, is_leaf)
        return out
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, n), it, is_leaf) for n in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, it, is_leaf) for x in tree)
    return next(it)


def tree_map(fn: Callable, tree: Any, *rest: Any,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    flat = [leaves(t, is_leaf) for t in (tree, *rest)]
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)], is_leaf)
