"""Find a cell, its configuration, its traffic, its metrics and its reference
by the names in ``BENCHMARK.json``.

Nothing here knows a cell or a model: a later change adds a configuration,
a cell or a per-layer metric by adding its file and its entry.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

#: the benchmark's own directory, and the checkout it lies in
BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    workloads: Optional[List[str]] = None
    bound: Optional[float] = None
    layer: Optional[str] = None
    moves: Optional[str] = None

    def applies_to(self, workload: str) -> bool:
        return self.workloads is None or workload in self.workloads


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with its configuration and traffic files."""
    name: str
    config_name: str
    traffic: str
    chips: int
    config: Dict[str, Any]   # perfbench/configs/<config>.json
    mix: Dict[str, Any]      # perfbench/cells/<traffic>.json


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return load_json(root / "BENCHMARK.json")


def config_file(spec: Dict[str, Any], name: str, root: Path = ROOT) -> Dict[str, Any]:
    for c in spec["configs"]:
        if c["name"] == name:
            return load_json(root / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> Cell:
    spec = benchmark(root)
    for w in spec["workloads"]:
        if w["name"] == name:
            mix = load_json(BENCH_DIR / "cells" / f"{w['traffic']}.json")
            return Cell(name=name, config_name=w["config"], traffic=w["traffic"],
                        chips=int(w["chips"]), config=config_file(spec, w["config"], root),
                        mix=mix)
    known = [w["name"] for w in spec["workloads"]]
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {known}")


def metrics(kind: str, workload: str, root: Path = ROOT) -> List[Metric]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``workload`` reports."""
    out = []
    for m in benchmark(root)[kind]:
        metric = Metric(**m)
        if metric.applies_to(workload):
            out.append(metric)
    return out


def _load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str) -> ModuleType:
    """``perfbench/metrics/<name>.py``: its ``read(record)`` returns the
    metric's value, or None where the run holds nothing to read."""
    return _load_module(BENCH_DIR / "metrics" / f"{name}.py", f"perfbench_metric_{name}")


def reference(family: str) -> ModuleType:
    """``perfbench/reference/<family>.py``: the plain float32 model."""
    return importlib.import_module(f"perfbench.reference.{family}")
