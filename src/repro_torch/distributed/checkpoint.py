"""Step-granular checkpoints that either package restores.

The JAX package's layout, unchanged: ``<dir>/step_<N>/`` holds one
``.npy`` per tree leaf, named by its ``"__"``-joined key path, plus
``manifest.json`` (leaf names, dtypes, a description of the tree, user
metadata such as the data iterator's state). Writes are atomic (a tmp dir,
then a rename), and the manifest, written last, is the commit marker:
``latest_step`` sees committed checkpoints only, so a crash mid-write
never corrupts a restore.

Restores go by position, as in JAX: the flattened ``like`` tree is zipped
with the manifest's leaves. So the leaves are written in JAX's flatten
order (``utils/tree.py``: dict keys sorted, ``AdamWState`` as ``step``,
``mu``, ``nu``), under the names JAX gives them (``opt__mu__...`` for the
NamedTuple's fields). A bf16 leaf is written as f32 (exact) with
``"bfloat16"`` in ``dtypes``, as JAX writes it, so neither side needs
numpy's bf16 (``ml_dtypes``) to read the other's.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils.tree import flatten_with_path, unflatten

_STEP_RE = re.compile(r"^step_(\d+)$")
_COMMIT = "manifest.json"


def _leaf_name(path) -> str:
    return "__".join(path) or "leaf"


#: torch dtypes numpy holds as they are; any other (bf16, fp8) is written as f32
_NUMPY_NATIVE = (torch.float16, torch.float32, torch.float64, torch.int8, torch.int16,
                 torch.int32, torch.int64, torch.uint8, torch.bool)


def _to_numpy(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(the array to write, the dtype name to record)."""
    t = leaf.detach().cpu()
    name = str(t.dtype).removeprefix("torch.")
    return (t if t.dtype in _NUMPY_NATIVE else t.float()).numpy(), name  # exact for bf16


def save_checkpoint(directory: str, step: int, tree: Any,
                    metadata: Optional[Dict] = None) -> str:
    """Atomically write ``tree`` (of tensors) as ``<directory>/step_<step>``."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step}")
    tmp = tempfile.mkdtemp(prefix=f".step_{step}_", dir=directory)
    try:
        flat = flatten_with_path(tree)
        names, dtypes = [], []
        for path, leaf in flat:
            name = _leaf_name(path)
            base = name
            i = 0
            while name in names:  # disambiguate collisions deterministically
                i += 1
                name = f"{base}__{i}"
            names.append(name)
            arr, dtype = _to_numpy(leaf)
            dtypes.append(dtype)
            np.save(os.path.join(tmp, name + ".npy"), arr)
        manifest = {
            "step": step,
            "leaves": names,
            "dtypes": dtypes,
            "treedef": " ".join(_leaf_name(p) for p, _ in flat),
            "metadata": metadata or {},
        }
        # manifest written last = commit marker
        with open(os.path.join(tmp, _COMMIT), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        return final
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def latest_step(directory: str) -> Optional[int]:
    """Largest committed step, or None."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for entry in os.listdir(directory):
        m = _STEP_RE.match(entry)
        if m and os.path.exists(os.path.join(directory, entry, _COMMIT)):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, like: Any) -> Tuple[Any, Dict]:
    """Restore into the structure of ``like``, a tree of tensors
    (shape-checked): each leaf of ``like`` gives its restored leaf's dtype
    and device."""
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, _COMMIT)) as f:
        manifest = json.load(f)
    flat = flatten_with_path(like)
    if len(flat) != len(manifest["leaves"]):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, "
            f"template has {len(flat)}")
    out = []
    for (_, leaf), name in zip(flat, manifest["leaves"]):
        arr = np.load(os.path.join(path, name + ".npy"))
        want_shape = tuple(leaf.shape)
        if tuple(arr.shape) != want_shape:
            raise ValueError(
                f"leaf {name}: checkpoint shape {arr.shape} != {want_shape}")
        out.append(torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype))
    return unflatten(like, out), manifest["metadata"]


def restore_latest(directory: str, like: Any) -> Optional[Tuple[int, Any, Dict]]:
    step = latest_step(directory)
    if step is None:
        return None
    tree, meta = restore_checkpoint(directory, step, like)
    return step, tree, meta


def prune_checkpoints(directory: str, keep: int = 3) -> None:
    """Remove all but the newest ``keep`` committed checkpoints."""
    if not os.path.isdir(directory):
        return
    steps = sorted(
        int(m.group(1)) for m in (_STEP_RE.match(e) for e in os.listdir(directory))
        if m and os.path.exists(os.path.join(directory, f"step_{m.group(1)}", _COMMIT))
    )
    for s in steps[:-keep] if keep > 0 else steps:
        shutil.rmtree(os.path.join(directory, f"step_{s}"), ignore_errors=True)
