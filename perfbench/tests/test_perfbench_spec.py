"""Cells, configurations, metrics and references resolve by name, and the
benchmark's file keeps to its contract's shape."""
import json
import re

import pytest

from perfbench.lib import spec

SPEC = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
WORKLOADS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    cells = len(SPEC["workloads"])
    assert 1 <= cells <= 24
    # a full check of 24 cells fits in the driver's 43,200 s
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_and_metrics():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + WORKLOADS + [c["name"] for c in SPEC["configs"]]:
        assert NAME.match(n), n
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(WORKLOADS)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_resolves_by_name(workload):
    cell = spec.cell(workload)
    mix, model = cell.mix, cell.config["model"]
    assert cell.chips == 1
    assert mix["config"] == cell.config_name
    assert mix["arrivals"]["rate"] > 0 and mix["slo_ms"] > 0
    assert mix["check"]["logit_gap_limit"] > 0
    assert mix["prompt_len"] + mix["gen_len"] <= model["max_seq_len"]
    assert spec.reference(model["family"]).logits
    for kind in ("end_to_end", "per_layer"):
        metrics = spec.metrics(kind, workload)
        assert metrics
        for m in metrics:
            assert callable(spec.metric_reader(m.name).read)


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file_is_the_port_config_as_run(entry):
    from repro_torch.configs import get_config

    from perfbench.lib import bench

    data = json.loads((spec.ROOT / entry["file"]).read_text())
    assert entry["file"].startswith("perfbench/configs/")
    assert data["source"] == entry["source"]
    assert bench.model_config(data["model"]) == get_config(entry["name"])
    assert entry["reduced"] == data["reduced"]


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        spec.cell("no-such-cell")
