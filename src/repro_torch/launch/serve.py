"""Serving driver: MLProxy fronting the PyTorch engine on the card.

Requests arrive on a seeded Poisson schedule in virtual time and go
through the paper's proxy (``MLProxy``: Smart Monitor, AIMD optimizer,
Algorithm-1 scheduler); every batch it dispatches runs for real through
``ReplicaPoolTarget`` → ``ReplicaPool`` → ``InferenceEngine`` on the
device, and the measured wall time is the upstream latency the monitor
learns from. One always-warm replica serves the dispatched batches one at
a time: a batch completes at max(dispatch, replica free) plus its measured
latency — the "transparent platform" of the sim↔live parity runs. The
simulator and the serverless platform of the JAX driver are not ported
yet; this loop drives the proxy through its public protocol and adds no
policy logic.

    PYTHONPATH=src python -m repro_torch.launch.serve               # full qwen2-0.5b on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b   # full xLSTM-1.3B
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b  # full Zamba2-1.2B
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b --reduced --device cpu
"""
from __future__ import annotations

import argparse
import heapq
import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.config import OptimizerConfig, ProxyConfig, SLAConfig
from repro_torch.core.proxy import MLProxy
from repro_torch.core.request import Batch, Request
from repro_torch.serving.batcher import ReplicaPoolTarget
from repro_torch.serving.engine import EngineConfig, ReplicaPool


def engine_config(full_size: bool, gen_len: int) -> EngineConfig:
    """The serving buckets: prompts of up to 128 tokens at full size; the
    reduced model's 64-position limit keeps it to one 16-token bucket."""
    if full_size:
        return EngineConfig(batch_buckets=(1, 2, 4, 8, 16, 32),
                            prompt_buckets=(32, 128), max_len=128 + gen_len,
                            gen_len=gen_len)
    return EngineConfig(batch_buckets=(1, 2, 4, 8, 16, 32), prompt_buckets=(16,),
                        max_len=16 + gen_len + 8, gen_len=gen_len)


def run_event_loop(make_proxy: Callable[[Callable[[Batch], None]], Any],
                   arrivals: np.ndarray, payloads: Sequence[Any],
                   execute: Callable[[Batch], float]) -> Dict[str, Any]:
    """Drive a policy through its public protocol in virtual time.

    ``make_proxy(dispatch_fn)`` builds the policy; ``execute(batch)`` runs
    one dispatched batch and returns its latency in seconds. One replica
    serves batches in dispatch order: a batch completes at max(dispatch,
    replica free) + latency, and the policy sees completion - dispatch as
    the upstream latency. Returns the requests, one record per batch and
    the policy's final ``stats()``.
    """
    events: List[tuple] = []
    seq = itertools.count()
    records: List[Dict[str, Any]] = []
    requests: List[Request] = []
    replica_free = 0.0

    def push(t: float, kind: str, obj) -> None:
        heapq.heappush(events, (t, next(seq), kind, obj))

    def dispatch(batch: Batch) -> None:
        nonlocal replica_free
        latency = execute(batch)
        done = max(batch.dispatch_time, replica_free) + latency
        replica_free = done
        records.append({"dispatch": batch.dispatch_time, "size": batch.size,
                        "bucket": batch.effective_size, "latency_s": latency,
                        "cause": batch.cause, "done": done})
        push(done, "done", batch)

    proxy = make_proxy(dispatch)
    n_requests = len(arrivals)
    for i, t in enumerate(arrivals):
        push(float(t), "arrival", i)

    timer_at: Optional[float] = None
    timer_gen = 0

    def reschedule(now: float, min_time: float = 0.0) -> None:
        nonlocal timer_at, timer_gen
        t = proxy.next_event_time(now)
        if t is None:
            return
        t = max(t, now, min_time)
        if timer_at is None or t < timer_at - 1e-12:
            timer_at = t
            timer_gen += 1
            push(t, "timer", timer_gen)

    completed = 0
    now = 0.0
    while completed < n_requests:
        if not events:
            raise RuntimeError(f"event loop ran dry with {n_requests - completed} "
                               "requests outstanding")
        now, _, kind, obj = heapq.heappop(events)
        if kind == "arrival":
            req = Request(arrival_time=now, payload=payloads[obj])
            requests.append(req)
            proxy.on_request(req, now)
            if len(requests) == n_requests:
                proxy.flush(now)  # no more traffic: send what is queued
        elif kind == "done":
            proxy.on_response(obj, now - obj.dispatch_time, now)
            completed += obj.size
        else:
            if obj != timer_gen:
                continue  # superseded by a later reschedule
            timer_at = None
            proxy.on_timer(now)
            reschedule(now, min_time=now + 1e-6)
            continue
        reschedule(now)
    return {"requests": requests, "batches": records, "stats": proxy.stats(now),
            "end_time": now}


def poisson_arrivals(n_requests: int, rate: float, rng: np.random.Generator) -> np.ndarray:
    return np.cumsum(rng.exponential(1.0 / rate, size=n_requests))


def run_proxy_loop(pool: ReplicaPool, *, n_requests: int, rate: float,
                   prompt_len: int, seed: int = 0, slo_s: float = 2.0,
                   optimizer: Optional[OptimizerConfig] = None,
                   bucketing="pow2") -> Dict[str, Any]:
    """Serve ``n_requests`` seeded Poisson arrivals at ``rate``/s of random
    ``prompt_len``-token prompts through MLProxy onto ``pool``.

    Each request's ``payload`` comes back holding its generated tokens;
    each batch record carries the latency measured on the device.
    """
    rng = np.random.default_rng(seed)
    arrivals = poisson_arrivals(n_requests, rate, rng)
    payloads = rng.integers(0, pool.cfg.vocab_size, size=(n_requests, prompt_len),
                            dtype=np.int32)
    target = ReplicaPoolTarget(pool, prompt_len=prompt_len)
    cfg = ProxyConfig(sla=SLAConfig(slo_target=slo_s),
                      optimizer=optimizer or OptimizerConfig(),
                      bucketing=bucketing)
    return run_event_loop(lambda dispatch: MLProxy(cfg, dispatch_fn=dispatch),
                          arrivals, payloads,
                          lambda batch: target(batch)[1]["latency_s"])


def offered_load(timings: Dict[Tuple[int, int], float], prompt_bucket: int,
                 batch: int = 2) -> Tuple[float, float]:
    """(arrival rate /s, SLO s) scaled to the engine's measured speed.

    ``timings`` are ``warmup()``'s seconds per (batch bucket, prompt
    bucket). With ``t`` the time of a ``batch``-request batch (MLProxy's
    starting Max_BS is 2), the SLO is 10·t and the rate keeps one replica
    80% busy at that batch size: 0.8·batch/t. A fixed rate and SLO would
    put a slower engine into overload — the queue grows, the monitor's
    latencies inflate and the AIMD optimizer shrinks batches to 1 — and a
    faster one into idle timeouts.
    """
    t = timings[(batch, prompt_bucket)]
    return 0.8 * batch / t, 10.0 * t


def summarize(result: Dict[str, Any]) -> Dict[str, Any]:
    """Requests, batches, average batch, p95 end-to-end latency (virtual
    seconds) and mean measured ms per batch bucket."""
    reqs, recs = result["requests"], result["batches"]
    e2e = np.array([r.e2e_latency for r in reqs if r.e2e_latency is not None])
    by_bucket: Dict[int, List[float]] = {}
    for rec in recs:
        by_bucket.setdefault(rec["bucket"], []).append(rec["latency_s"])
    return {
        "requests": len(reqs),
        "completed": int(len(e2e)),
        "batches": len(recs),
        "avg_batch": sum(r["size"] for r in recs) / max(len(recs), 1),
        "p95_s": float(np.percentile(e2e, 95)) if len(e2e) else float("nan"),
        "ms_per_bucket": {b: 1e3 * float(np.mean(v)) for b, v in sorted(by_bucket.items())},
    }


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="qwen2-0.5b", choices=list(ARCH_IDS))
    p.add_argument("--requests", type=int, default=300)
    p.add_argument("--rate", type=float, default=None,
                   help="arrivals per second (default: from the warmup timings)")
    p.add_argument("--slo-ms", type=float, default=None,
                   help="response-time SLO (default: from the warmup timings)")
    p.add_argument("--gen-len", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reduced", action="store_true",
                   help="reduced config (CPU runs); default full size")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    ecfg = engine_config(not args.reduced, args.gen_len)
    pool = ReplicaPool(cfg, ecfg, seed=args.seed, device=args.device)
    print(f"[serve] warming buckets for {cfg.name} on {pool.device} ...")
    prompt_len = ecfg.prompt_buckets[-1]
    rate, slo_s = offered_load(pool.warmup(), prompt_len)
    rate = args.rate if args.rate is not None else rate
    slo_s = args.slo_ms / 1000.0 if args.slo_ms is not None else slo_s
    print(f"[serve] {args.requests} requests at {rate:.2f}/s, SLO {slo_s * 1000:.0f} ms")
    result = run_proxy_loop(
        pool, n_requests=args.requests, rate=rate, prompt_len=prompt_len,
        seed=args.seed, slo_s=slo_s,
        optimizer=OptimizerConfig(update_interval=5.0, initial_max_bs=2))
    s = summarize(result)
    print(f"[serve] {s['completed']} requests, {s['batches']} batches, "
          f"avg batch {s['avg_batch']:.2f}, P95 {s['p95_s'] * 1000:.0f} ms, "
          f"ms per bucket {s['ms_per_bucket']}")


if __name__ == "__main__":
    main()
