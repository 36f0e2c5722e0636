#!/usr/bin/env python3
"""Serve one cell of ``BENCHMARK.json`` once and print one JSON line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up: the cell's weights from the seed on the card, a ``ReplicaPool`` of
the port warmed at the cell's shapes, then the lead-in's traffic. Then the
window of ``--seconds``, the tail until every request due in it is
resolved, and the check (``lib/check.py``). ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer ones, read in a
run that profiles the window's last batches (``lib/live.py``).

Exits 2 without a card (or with fewer than the cell asks for), 3 if JAX or
the JAX package was loaded, and prints no result then.
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
# every build and kernel cache inside the checkout, at fixed paths
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[_var] = str(ROOT / ".perfbench_cache" / _sub)

from perfbench.lib import bench, check, live, spec, trace, traffic  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def read_metrics(record, kind: str, workload: str) -> dict:
    out = {}
    for m in spec.metrics(kind, workload):
        value = spec.metric_reader(m.name).read(record)
        if value is not None:
            out[m.name] = {"value": float(value), "unit": m.unit}
    return out


def judge(served, record, device: str) -> dict:
    """The check: every number compared, each with its limit."""
    limits = record.mix["check"]
    # every sampled request is judged over all of its served tokens
    min_tokens = int(limits["sample"]) * int(record.mix["gen_len"])
    counts = check.accounting(record, served.model["vocab_size"])
    checks = {name: {"value": n, "limit": 0} for name, n in counts.items()}
    picked = check.sample(record, int(limits["sample"]))
    if picked:
        prompts, served_tokens = check.tokens_of(record, picked)
        gaps, _ = check.logit_gaps(served.ref, served.model, served.params, prompts,
                                   served_tokens, device, int(limits["rows_per_block"]))
        checks["logit_gap"] = {"value": float(gaps.max()),
                               "limit": float(limits["logit_gap_limit"])}
        checks["sampled_tokens"] = {"value": int(served_tokens.size), "limit": min_tokens}
    else:
        checks["sampled_tokens"] = {"value": 0, "limit": min_tokens}
    return checks


def passed(checks: dict) -> bool:
    ok = True
    for name, c in checks.items():
        if name == "sampled_tokens":
            ok &= c["value"] >= c["limit"]
        else:
            ok &= c["value"] <= c["limit"]
    return bool(ok)


def main(argv=None, *, device: str = "cuda", cell: spec.Cell = None) -> int:
    """One run. ``device`` and ``cell`` let the tests drive a run on the CPU
    at a tiny size; the command line always runs a cell of the file on the
    card."""
    args = parse(argv)
    import torch

    cell = cell or spec.cell(args.workload)
    if device == "cuda" and not (torch.cuda.is_available()
                                 and torch.cuda.device_count() >= cell.chips):
        bench.log(f"needs {cell.chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    seed = traffic.seed_key(args.seed)
    served = bench.build(cell, seed, device)
    opened = {}
    record = live.serve(served.pool, served.model, cell.mix, seed, args.seconds,
                        trace=bool(args.trace),
                        on_window_open=lambda: opened.setdefault("t", time.monotonic()))
    record.extra["setup_s"] = opened["t"] - T_START
    if record.extra["profile_costs"]:
        bench.log(f"[trace] profiler costs: {record.extra['profile_costs']}")
    counted = record.counted()
    ep = record.summary["endpoints"]["ep"]
    bench.log(f"[run] {len(counted)} requests due in the window, "
              f"{sum(r.failure is not None for r in counted)} failed; "
              f"{len(record.window_batches())} batches dispatched in it; Max_BS at the end "
              f"{ep['max_bs']}; setup {record.extra['setup_s']:.1f} s")
    info = bench.device_info(device, cell.chips)
    kind = "per_layer" if args.trace else "end_to_end"
    result = {"metrics": read_metrics(record, kind, cell.name), "device": info}
    if args.trace and record.profile is not None:
        busy = trace.busy_s(record.profile)
        if busy is not None:
            info["busy_s"] = busy
            info["window_s"] = record.profile.window_s
            result["breakdown"] = trace.breakdown(record.profile)
    # the program's state goes before the reference runs: weights stay
    served.pool = None
    record.profile = None
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    checks = judge(served, record, device)
    found = bench.forbidden_modules()
    if found:
        bench.log(f"loaded in this process, and forbidden here: {found}")
        return 3
    for name, c in checks.items():
        bench.log(f"check {name}: {c['value']} (limit {c['limit']})")
    line = {"correct": passed(checks), "attempted": len(counted),
            "failed": sum(r.failure is not None for r in counted), **result,
            "checks": checks}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
