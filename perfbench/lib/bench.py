"""Set-up shared by the run, the knee sweep and the calibration: the
program's model, engine and pool for a cell, with the benchmark's weights."""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any, Dict, Iterable

from perfbench.lib import spec, weights

#: top-level module names that no process of the benchmark may hold: JAX
#: and the JAX package (``repro_torch`` is another name, compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules: Iterable[str] = None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Served:
    model: Dict[str, Any]
    cfg: Any
    params: Dict[str, Any]
    pool: Any
    ref: Any


def model_config(model: Dict[str, Any]):
    from repro_torch.configs.base import ModelConfig

    return ModelConfig(**model)


def engine_config(mix: Dict[str, Any]):
    """Batch buckets from the cell, one prompt bucket of ``prompt_len``,
    ``max_len = prompt_len + gen_len``."""
    from repro_torch.serving.engine import EngineConfig

    p, g = mix["prompt_len"], mix["gen_len"]
    return EngineConfig(batch_buckets=tuple(mix["engine"]["batch_buckets"]),
                        prompt_buckets=(p,), max_len=p + g, gen_len=g)


def build(cell: spec.Cell, seed: int, device: str) -> Served:
    """The cell's weights from ``seed`` on ``device``, a ``ReplicaPool`` over
    them, warmed at the cell's one prompt bucket and generated length."""
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import ReplicaPool

    model = cell.config["model"]
    cfg = model_config(model)
    ref = spec.reference(cfg.family)
    t0 = time.monotonic()
    params = weights.make(Model(cfg).init_abstract(), seed, device,
                          extra=getattr(ref, "WEIGHTS", None))
    _sync(device)
    t1 = time.monotonic()
    pool = ReplicaPool(cfg, engine_config(cell.mix), n_replicas=int(cell.mix["replicas"]),
                       device=device, params=params)
    timings = pool.warmup(cell.mix["prompt_len"])
    log(f"[setup] weights {t1 - t0:.2f} s, pool and warm-up {time.monotonic() - t1:.2f} s "
        "(second call a bucket, ms: "
        + ", ".join(f"{b}: {1e3 * t:.1f}" for (b, _), t in sorted(timings.items())) + ")")
    return Served(model=model, cfg=cfg, params=params, pool=pool, ref=ref)


def _sync(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


def reseed(served: Served, seed: int, device: str) -> None:
    """New weights from ``seed``, written into the served tensors in place."""
    from repro_torch.models.model import Model

    weights.make(Model(served.cfg).init_abstract(), seed, device,
                 extra=getattr(served.ref, "WEIGHTS", None), into=served.params)


def device_info(device: str, chips: int) -> Dict[str, Any]:
    """The ``device`` entry of the result: the cards used and the peak of
    allocated memory on the fullest of them."""
    import torch

    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": max(int(torch.cuda.max_memory_allocated(i))
                                     for i in range(chips))}
