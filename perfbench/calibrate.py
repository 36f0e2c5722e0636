#!/usr/bin/env python3
"""The readings a cell's check limit is set from, on the card.

    python3 perfbench/calibrate.py --workload <cell> --seeds 101,102,... [--seconds 10]

In one process: the cell's set-up once, then for each seed new weights
from that seed (written into the served tensors in place), one short run
at the cell's own load and shapes (its lead-in, ``--seconds`` of window,
the tail), and on the run's own sample of served requests the widest
logit gap of the program's tokens (the lower reading) and of the tokens
the fp8 reference ranks first at the same positions (the upper reading).
The limit in the cell file lies between the largest program reading and
the smallest control reading. One line a seed on standard error; a JSON
summary as the last line of standard output, also written to
``chiprun_out/``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from perfbench.lib import bench, check, live, spec, traffic  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        bench.log("the calibration runs on the card")
        return 2
    cell = spec.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    t0 = time.monotonic()
    served = bench.build(cell, traffic.seed_key(seeds[0]), "cuda")
    bench.log(f"[calibrate] {cell.name}: set-up {time.monotonic() - t0:.1f} s")
    limits = cell.mix["check"]
    rows = []
    for i, seed in enumerate(seeds):
        key = traffic.seed_key(seed)
        if i:
            bench.reseed(served, key, "cuda")
        rec = live.serve(served.pool, served.model, cell.mix, key, args.seconds)
        picked = check.sample(rec, int(limits["sample"]))
        prompts, toks = check.tokens_of(rec, picked)
        t1 = time.monotonic()
        gaps, ctrl = check.logit_gaps(served.ref, served.model, served.params, prompts, toks,
                                      "cuda", int(limits["rows_per_block"]), control=True)
        row = {"seed": seed, "requests": len(rec.counted()),
               "batches": len(rec.window_batches()), "sampled_tokens": int(toks.size),
               "program_gap": float(gaps.max()), "program_gaps": gaps.tolist(),
               "accounting": check.accounting(rec, served.model["vocab_size"]),
               "reference_s": time.monotonic() - t1, "control_gap": float(ctrl.max()),
               "control_gaps": ctrl.tolist()}
        rows.append(row)
        bench.log("[calibrate] " + json.dumps({k: v for k, v in row.items()
                                                if not k.endswith("_gaps")}))
    out = {"workload": cell.name, "device": torch.cuda.get_device_name(0),
           "seconds": args.seconds, "rows": rows,
           "lower": max(r["program_gap"] for r in rows),
           "upper": min(r["control_gap"] for r in rows)}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"calibrate-{cell.name}.json").write_text(json.dumps(out, indent=1))
    print(json.dumps({k: v for k, v in out.items() if k != "rows"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
