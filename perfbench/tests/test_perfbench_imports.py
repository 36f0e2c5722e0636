"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module name (``repro_torch`` is not ``repro``), and the
command gives no result in a directory that holds only the benchmark."""
import json
import os
import shutil
import subprocess
import sys

from perfbench.lib import bench, spec

PROBE = """
import json, sys
sys.path[:0] = [{src!r}, {root!r}, {bench!r}]
import run, sweep, calibrate
from perfbench.lib import bench, spec
for kind in ("end_to_end", "per_layer"):
    for m in spec.benchmark()[kind]:
        spec.metric_reader(m["name"])
for c in spec.benchmark()["configs"]:
    spec.reference(json.load(open(spec.ROOT / c["file"]))["model"]["family"])
import repro_torch.runtime, repro_torch.serving.batcher, repro_torch.serving.engine
import repro_torch.models.model, repro_torch.kernels.ops, repro_torch.core.config
import torch.profiler
print(json.dumps(bench.forbidden_modules()))
"""


def test_nothing_the_run_imports_is_jax_or_the_jax_package():
    code = PROBE.format(src=str(spec.ROOT / "src"), root=str(spec.ROOT),
                        bench=str(spec.BENCH_DIR))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=240, cwd=str(spec.ROOT))
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_compare_whole():
    assert bench.forbidden_modules(["repro_torch.models", "numpy"]) == []
    assert bench.forbidden_modules(["repro.models", "jax.numpy", "jaxlib"]) == ["jax", "jaxlib",
                                                                               "repro"]


def test_no_result_from_the_benchmark_alone(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.BENCH_DIR, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          spec.benchmark()["workloads"][0]["name"], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         env=env, timeout=240, cwd=str(tmp_path))
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
