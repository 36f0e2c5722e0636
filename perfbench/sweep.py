#!/usr/bin/env python3
"""Find a cell's knee once, on the card: the highest Poisson rate its
system sustains. The cell's ``rate`` and ``slo_ms`` are then written into
its file from these readings; no run works them out again.

    python3 perfbench/sweep.py --workload <cell> --fractions 0.5,0.7,0.9,1.0 [--seconds 20]

In one process: the cell's set-up (weights from ``--seed``, the pool
warmed), then the SLO by the repo's rule, 10 x the median of five timed
(2, ``prompt_len``) batches at the cell's ``gen_len``; the time of each batch
bucket (median of three); then, for each rate (``--rates``, or
``--fractions`` of the bucket-32 capacity 32 / t_32), one run of the
cell's traffic shape under Poisson arrivals at that rate: its lead-in, a
window of ``--seconds`` and the tail. A rate passes where the p95 (a
failure counts as +inf) is within the SLO, every request due in the window
finishes within the drain limit, and the backlog at the window's close
clears within a quarter of the window (``drain_s``), so that it does not
grow. The sweep stops after a rate that leaves requests unfinished at the
drain limit: the pool would still be serving that rate's backlog when the
next rate began. Prints one line a rate on standard error and a JSON
summary as the last line of standard output, also written to
``chiprun_out/``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from perfbench.lib import bench, live, spec, stats, traffic  # noqa: E402


def timed(engine, prompt_len: int, vocab: int, batch: int, n: int, seed: int) -> list:
    import numpy as np

    rng = np.random.default_rng([seed, batch])
    out = []
    for _ in range(n):
        prompts = rng.integers(0, vocab, (batch, prompt_len)).astype(np.int32)
        out.append(engine.generate(prompts)[1]["latency_s"])
    return out


def reading(record, rate: float, slo_s: float) -> dict:
    counted = record.counted()
    lat = [r.latency for r in counted]
    done = [r.complete for r in counted if r.complete is not None]
    unfinished = sum(r.failure is not None for r in counted)
    drain_s = (max(done) - record.window[1]) if done else float("inf")
    batches = record.window_batches()
    p95 = stats.percentile(lat, 95)
    ok = (p95 <= slo_s and unfinished == 0 and drain_s <= record.seconds / 4)
    return {"rate": rate, "requests": len(counted), "p50_ms": stats.as_ms(stats.percentile(lat, 50)),
            "p95_ms": stats.as_ms(p95), "unfinished": unfinished, "drain_s": drain_s,
            "avg_batch": sum(b.size for b in batches) / max(1, len(batches)), "passes": ok}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--fractions", default="0.5,0.7,0.85,1.0")
    ap.add_argument("--rates", default="")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        bench.log("the sweep runs on the card")
        return 2
    cell = spec.cell(args.workload)
    t0 = time.monotonic()
    served = bench.build(cell, traffic.seed_key(args.seed), "cuda")
    mix, vocab = dict(cell.mix), served.model["vocab_size"]
    eng = served.pool.replicas[0]
    two = timed(eng, mix["prompt_len"], vocab, 2, 5, args.seed)
    slo_s = 10.0 * statistics.median(two)
    buckets = {b: statistics.median(timed(eng, mix["prompt_len"], vocab, b, 3, args.seed))
               for b in mix["engine"]["batch_buckets"]}
    cap = max(buckets) / buckets[max(buckets)]
    bench.log(f"[sweep] {cell.name}: set-up {time.monotonic() - t0:.1f} s; (2, "
              f"{mix['prompt_len']}) x {mix['gen_len']} ms: "
              + ", ".join(f"{1e3 * t:.2f}" for t in two) + f" -> SLO {1e3 * slo_s:.1f} ms")
    bench.log("[sweep] bucket ms: " + ", ".join(f"{b}: {1e3 * t:.2f}" for b, t in buckets.items())
              + f"; bucket-32 capacity {cap:.3f} req/s")
    rates = ([float(r) for r in args.rates.split(",")] if args.rates else
             [round(cap * float(f), 3) for f in args.fractions.split(",")])
    mix["slo_ms"] = 1e3 * slo_s
    rows = []
    for rate in rates:
        arrivals = {"process": "poisson", "rate": rate}
        rec = live.serve(served.pool, served.model, mix, traffic.seed_key(args.seed),
                         args.seconds, arrivals=arrivals)
        row = reading(rec, rate, slo_s)
        rows.append(row)
        bench.log("[sweep] " + json.dumps(row))
        if row["unfinished"]:
            break
    passing = [r["rate"] for r in rows if r["passes"]]
    out = {"workload": cell.name, "device": torch.cuda.get_device_name(0),
           "slo_ms": 1e3 * slo_s, "two_ms": [1e3 * t for t in two],
           "bucket_ms": {b: 1e3 * t for b, t in buckets.items()}, "capacity_32": cap,
           "seconds": args.seconds, "rows": rows, "knee": max(passing) if passing else None}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"sweep-{cell.name}.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
