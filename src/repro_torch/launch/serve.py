"""Serving driver: MLProxy fronting the PyTorch engine on the simulated
serverless platform.

The hybrid loop of the JAX package's driver: simulated Poisson arrivals
drive the proxy (``MLProxy``: Smart Monitor, AIMD optimizer, Algorithm-1
scheduler) in virtual time in front of the simulated serverless platform
(``ServerlessPlatform``: cold starts, Knative-style scaling, cost in
container-seconds); every batch the platform runs executes a real bucketed
prefill+decode through ``EngineBackedLatency`` → ``InferenceEngine`` on the
device, and the measured wall time is the service time the Smart Monitor
learns from. ``--snapshot`` persists the proxy's control-plane state, so
a restarted proxy resumes with its learned latency statistics.

The rate and SLO default to the offered-load rule (:func:`offered_load`)
over the median of several timed batches of two. ``run_event_loop`` and
``run_proxy_loop`` are the direct path: one always-warm replica behind
``ReplicaPoolTarget`` and no platform (the "transparent platform" of the
sim↔live parity runs).

    PYTHONPATH=src python -m repro_torch.launch.serve               # full qwen2-0.5b on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b   # full xLSTM-1.3B
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b  # full Zamba2-1.2B
    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-15b  # full StarCoder2-15B
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --arch llama4-scout-17b-a16e --duration 10  # any registered arch: MoE, VLM, dense
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --duration 20 [--snapshot proxy_state.json]
"""
from __future__ import annotations

import argparse
import heapq
import itertools
import json
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.config import OptimizerConfig, ProxyConfig, SLAConfig
from repro_torch.core.proxy import MLProxy
from repro_torch.core.request import Batch, Request
from repro_torch.serverless.platform import PlatformConfig
from repro_torch.serving.batcher import EngineBackedLatency, ReplicaPoolTarget
from repro_torch.serving.engine import (
    UNSERVED_FAMILIES,
    EngineConfig,
    InferenceEngine,
    ReplicaPool,
)
from repro_torch.simulation.arrivals import PoissonProcess
from repro_torch.simulation.simulator import Simulator


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


def time_samples(engine: InferenceEngine, prompt_bucket: int, batch: int = 2,
                 n: int = 5, seed: int = 0) -> List[float]:
    """Wall seconds of ``n`` timed ``generate()`` calls of ``batch`` random
    ``prompt_bucket``-token prompts, on an engine already warm at that
    shape. They count in the engine's serving ``stats``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        prompts = rng.integers(0, engine.cfg.vocab_size,
                               (batch, prompt_bucket)).astype(np.int32)
        out.append(engine.generate(prompts)[1]["latency_s"])
    return out


def offered_load(samples: Sequence[float], batch: int = 2) -> Tuple[float, float]:
    """(arrival rate /s, SLO s) scaled to the engine's measured speed.

    ``samples`` are wall seconds of ``batch``-request batches (MLProxy's
    starting Max_BS is 2) at the served prompt bucket, from
    :func:`time_samples`. With ``t`` their median, the SLO is 10·t and the
    rate keeps one replica 80% busy at that batch size: 0.8·batch/t. A
    fixed rate and SLO would put a slower engine into overload — the queue
    grows, the monitor's latencies inflate and the AIMD optimizer shrinks
    batches to 1 — and a faster one into idle timeouts. The median of
    several samples, not one, keeps a single slow or fast call (host
    noise) from setting the operating point.
    """
    if len(samples) < 5:
        raise ValueError(f"offered_load needs at least 5 samples, got {len(samples)}")
    t = float(np.median(samples))
    return 0.8 * batch / t, 10.0 * t


def build_simulator(engine: InferenceEngine, *, rate: float, duration: float,
                    slo_s: float, prompt_len: int, gen_len: Optional[int] = None,
                    timings: Optional[Dict[Tuple[int, int], float]] = None,
                    policy: str = "mlproxy", seed: int = 0,
                    snapshot: Optional[str] = None,
                    fixed_latency: bool = False) -> Simulator:
    """The JAX driver's simulation over ``engine``: Poisson arrivals at
    ``rate`` for ``duration`` virtual seconds, ``policy`` in front of a
    ``ServerlessPlatform`` with one warm container and 0.5 s cold starts,
    every batch executed by the engine. ``timings`` (``warmup()``'s) seed
    the latency model's per-bucket estimates, so the first RT95 probes do
    not see 0.0. With ``fixed_latency`` the service times are each batch
    bucket's fastest warm call instead, held for the whole run (every
    batch still runs on the engine). With ``snapshot`` naming a file that
    exists, the policy resumes from the control-plane state saved there."""
    workload = EngineBackedLatency(engine, prompt_len=prompt_len, gen_len=gen_len,
                                   fixed=fixed_latency)
    if fixed_latency:
        timings = workload.warm_timings()
    if timings:
        workload.seed(timings)
    policy_kwargs = ({"bucketing": "pow2",
                      "optimizer": OptimizerConfig(update_interval=5.0, initial_max_bs=2)}
                     if policy == "mlproxy" else {})
    sim = Simulator(
        policy=policy, sla=SLAConfig(slo_target=slo_s), workload=workload,
        arrivals=PoissonProcess(rate=rate, duration=duration),
        platform_config=PlatformConfig(initial_scale=1, cold_start=0.5),
        duration=duration, seed=seed, policy_kwargs=policy_kwargs)
    if snapshot and os.path.exists(snapshot):
        with open(snapshot) as f:
            sim.policy.restore(json.load(f))
    return sim


def save_snapshot(sim: Simulator, path: str) -> None:
    """Persist the policy's control-plane state to ``path`` (JSON)."""
    with open(path, "w") as f:
        json.dump(sim.policy.snapshot(), f,
                  default=lambda o: getattr(o, "__dict__", str(o)))


def sim_line(summary: Dict[str, float]) -> str:
    """The paper's end-to-end numbers of one simulated run."""
    return (f"{summary['completed']:.0f} of {summary['submitted_requests']:.0f} requests, "
            f"avg batch {summary['avg_batch_size']:.2f}, p95 {1e3 * summary['p95']:.1f} ms, "
            f"violations {summary['violation_pct']:.2f}%, cost_integral "
            f"{summary['cost_integral']:.2f} container-s, avg containers "
            f"{summary['avg_containers']:.3f}, peak {summary['peak_containers']:.0f}, "
            f"cold starts {summary['cold_starts']:.0f}")


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
    p.add_argument("--arch", default="qwen2-0.5b",
                   choices=[a for a in ARCH_IDS if get_config(a).family not in UNSERVED_FAMILIES])
    p.add_argument("--duration", type=float, default=60.0,
                   help="simulated seconds of arrivals")
    p.add_argument("--rate", type=float, default=None,
                   help="arrivals per second (default: the offered-load rule)")
    p.add_argument("--slo-ms", type=float, default=None,
                   help="response-time SLO (default: the offered-load rule)")
    p.add_argument("--gen-len", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reduced", action="store_true",
                   help="reduced config (CPU runs); default full size")
    p.add_argument("--device", default="cuda")
    p.add_argument("--snapshot", default=None,
                   help="path to persist/restore proxy control-plane state")
    p.add_argument("--fixed-latency", action="store_true",
                   help="service times held at each batch bucket's fastest of five "
                        "warm calls (batches still run on the engine), so the run's "
                        "decisions do not move with the host's load")
    args = p.parse_args()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    ecfg = engine_config(not args.reduced, args.gen_len)
    engine = InferenceEngine(cfg, ecfg, seed=args.seed, device=args.device)
    prompt_len = ecfg.prompt_buckets[-1]
    print(f"[serve] warming buckets for {cfg.name} on {engine.device} ...")
    timings = engine.warmup(plen=prompt_len)
    samples = time_samples(engine, prompt_len, seed=args.seed)
    rate, slo_s = offered_load(samples)
    rate = args.rate if args.rate is not None else rate
    slo_s = args.slo_ms / 1000.0 if args.slo_ms is not None else slo_s
    print("[serve] (2, %d) samples ms: %s" % (
        prompt_len, ", ".join(f"{1e3 * t:.1f}" for t in samples)))
    print(f"[serve] {args.duration:.0f} s of arrivals at {rate:.2f}/s, "
          f"SLO {slo_s * 1000:.0f} ms")
    sim = build_simulator(engine, rate=rate, duration=args.duration, slo_s=slo_s,
                          prompt_len=prompt_len, gen_len=args.gen_len, timings=timings,
                          seed=args.seed, snapshot=args.snapshot,
                          fixed_latency=args.fixed_latency)
    if args.snapshot and os.path.exists(args.snapshot):
        print(f"[serve] restored proxy state (Max_BS={sim.policy.max_bs})")
    batches0 = engine.stats["batches"]
    res = sim.run()
    print(f"[serve] {sim_line(res.summary)}; "
          f"{engine.stats['batches'] - batches0:.0f} engine batches")
    if args.snapshot:
        save_snapshot(sim, args.snapshot)
        print(f"[serve] proxy state saved → {args.snapshot}")


if __name__ == "__main__":
    main()
