"""Glue between the MLProxy control plane and the PyTorch engine.

``EngineBackedLatency`` turns the real engine into a
:class:`~repro_torch.serverless.latency.LatencyModel`: ``sample(batch_size)``
executes a real bucketed prefill+decode on the engine's device and returns
measured wall seconds. Plugging it into the Simulator gives the hybrid
loop of ``launch/serve.py``: simulated arrivals and serverless platform
(cold starts, scaling, cost) + real MLProxy decisions + real execution on
the card (service times measured, not modeled). It is the JAX package's
class over the torch engine, which has the same ``ecfg``, ``cfg`` and
``generate`` surface.

``ReplicaPoolTarget`` is the real-serving dispatch target: it adapts a
:class:`~repro_torch.serving.engine.ReplicaPool` to the
``dispatch_fn(batch)`` contract of the shared
:class:`~repro_torch.core.batch_queue.BatchQueue`, so a policy dispatches
straight onto the card.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core.request import Batch
from repro_torch.serverless.latency import LatencyModel
from repro_torch.serving.engine import (
    InferenceEngine,
    ReplicaPool,
    next_bucket,
    wall_clock,
)


class EngineBackedLatency(LatencyModel):
    """LatencyModel whose samples are real engine executions.

    Estimates start cold; seed them from warmup timings
    (``seed(engine.warmup())`` or ``warmup=True``) so the first policy
    RT95 probes see realistic per-bucket latency instead of 0.0 — a cold
    0.0 estimate makes the scheduler promise free batches until real
    samples correct it.

    With ``fixed=True`` the seeded estimates never move: every batch still
    runs on the engine, but its service time is its bucket's seeded
    latency, not the wall time of that call. Seeded from
    :meth:`warm_timings`, a run's decisions then do not depend on how
    loaded the host is while it runs.
    """

    name = "engine"
    noise_cv = 0.0  # real wall-clock variation is the noise

    def __init__(self, engine: InferenceEngine, prompt_len: int = 16,
                 gen_len: Optional[int] = None, warmup: bool = False,
                 fixed: bool = False) -> None:
        self.engine = engine
        self.prompt_len = prompt_len
        self.gen_len = gen_len
        self.fixed = fixed
        self._ema: Dict[int, float] = {}
        if warmup:
            self.seed(engine.warmup(plen=prompt_len))

    def warm_timings(self, calls: int = 5) -> Dict[Tuple[int, int], float]:
        """(batch bucket, ``prompt_len``) → the fastest of ``calls`` timed
        ``generate()`` calls at that bucket, on a warm engine: one call
        slowed by other work on the host does not set a bucket's time."""
        rng = np.random.default_rng(0)
        out = {}
        for bucket in self.engine.ecfg.batch_buckets:
            prompts = rng.integers(0, self.engine.cfg.vocab_size,
                                   size=(bucket, self.prompt_len)).astype(np.int32)
            out[(bucket, self.prompt_len)] = min(
                self.engine.generate(prompts, gen_len=self.gen_len)[1]["latency_s"]
                for _ in range(calls))
        return out

    def seed(self, timings: Mapping[Tuple[int, int], float]) -> None:
        """Seed per-bucket EMAs from ``warmup()`` timings.

        ``timings`` maps (batch bucket, prompt bucket) → seconds; for each
        batch bucket the timing of the prompt bucket closest to this
        model's ``prompt_len`` is used. Measured samples keep updating the
        EMA afterwards — the seed only covers the cold window.
        """
        by_bucket: Dict[int, Tuple[int, float]] = {}
        for (bucket, plen), dt in timings.items():
            best = by_bucket.get(bucket)
            dist = abs(plen - self.prompt_len)
            if best is None or dist < best[0]:
                by_bucket[bucket] = (dist, dt)
        for bucket, (_, dt) in by_bucket.items():
            self._ema.setdefault(bucket, dt)

    def mean(self, batch_size: int) -> float:
        # clamp: estimation must stay total for any size the policy may
        # probe (RT95[N_q+1] can exceed the largest compiled bucket); an
        # oversized size executes as sequential largest-bucket chunks, so
        # the estimate carries the same chunk factor sample() pays
        largest = self.engine.ecfg.batch_buckets[-1]
        chunks = max(1, -(-batch_size // largest))
        bucket = next_bucket(batch_size, self.engine.ecfg.batch_buckets,
                             clamp=True)
        if bucket in self._ema:
            return chunks * self._ema[bucket]
        # Never measured: scale the nearest known bucket's EMA by the
        # bucket-size ratio. The old behaviour (largest known EMA,
        # unscaled) under-estimated bigger buckets and over-estimated
        # smaller ones; linear-in-bucket scaling is conservative for
        # sub-linear batching but keeps estimates ordered.
        known = sorted(self._ema)
        if known:
            nearest = min(known, key=lambda b: abs(b - bucket))
            return chunks * self._ema[nearest] * (bucket / nearest)
        return 0.0

    def sample(self, batch_size: int, rng: np.random.Generator) -> float:
        # Oversized sizes execute as sequential largest-bucket chunks —
        # exactly what the dispatch path does — so the sampled latency is
        # the real cost, not a mid-simulation ValueError.
        largest = self.engine.ecfg.batch_buckets[-1]
        total = 0.0
        remaining = batch_size
        while remaining > 0:
            n = min(remaining, largest)
            prompts = rng.integers(
                0, self.engine.cfg.vocab_size,
                size=(n, self.prompt_len)).astype(np.int32)
            _, timing = self.engine.generate(prompts, gen_len=self.gen_len)
            bucket = timing["bucket"]
            dt = timing["latency_s"]
            if self.fixed:
                dt = self._ema.setdefault(bucket, dt)
            else:
                prev = self._ema.get(bucket)
                self._ema[bucket] = dt if prev is None else 0.8 * prev + 0.2 * dt
            total += dt
            remaining -= n
        return total


class ReplicaPoolTarget:
    """Per-endpoint dispatch target backed by a :class:`ReplicaPool`.

    Callable with the ``dispatch_fn(batch)`` signature the shared
    ``BatchQueue`` expects: builds the prompt array from each request's
    payload (token-id arrays; missing payloads become zero prompts), runs
    the pool with round-robin failover, and reports the measured wall-clock
    back through ``on_done(batch, latency_s, now)`` — typically the owning
    policy's ``on_response`` — closing the monitor feedback loop on real
    hardware.

    ``deadline`` (absolute, on this target's ``clock``) bounds the chunked
    path: once it has passed, remaining chunks are aborted — their
    requests are marked ``timed_out`` with no payload and counted in
    ``timing["deadline_aborted"]`` — instead of burning engine time on
    work nobody is waiting for. The chunk already running is never
    interrupted.
    """

    def __init__(self, pool: ReplicaPool, prompt_len: int = 16,
                 gen_len: Optional[int] = None,
                 on_done: Optional[Callable[[Batch, float, float], None]] = None,
                 clock: Optional[Callable[[], float]] = None) -> None:
        self.pool = pool
        self.prompt_len = prompt_len
        self.gen_len = gen_len
        self.on_done = on_done
        # measurement clock; any deadline passed to __call__ must be
        # absolute on THIS clock
        self.clock = clock if clock is not None else wall_clock
        self.batches = 0
        self.requests = 0
        #: requests whose chunk was never executed because the batch
        #: deadline passed mid-way through the chunked path
        self.deadline_aborted = 0

    def _prompts(self, batch: Batch) -> np.ndarray:
        prompts = np.zeros((batch.size, self.prompt_len), np.int32)
        for i, req in enumerate(batch.requests):
            if req.payload is None:
                continue
            # keep the LAST prompt_len tokens: with left-padding the engine
            # continues from the trailing context, not the prompt's head
            toks = np.asarray(req.payload, np.int32).ravel()[-self.prompt_len:]
            prompts[i, self.prompt_len - len(toks):] = toks  # left-pad
        return prompts

    def __call__(self, batch: Batch, deadline: Optional[float] = None):
        t0 = self.clock()
        prompts = self._prompts(batch)
        largest = self.pool.engine_cfg.batch_buckets[-1]
        aborted_from: Optional[int] = None
        if batch.size <= largest:
            out, timing = self.pool.generate(prompts, gen_len=self.gen_len)
        else:
            # A batch larger than the largest bucket executes as sequential
            # largest-bucket chunks — the dispatch path never raises on a
            # policy whose cap outruns the engine's buckets.
            outs = []
            timing = None
            chunks = 0
            for lo in range(0, batch.size, largest):
                if (deadline is not None and lo > 0
                        and self.clock() >= deadline):
                    aborted_from = lo
                    break
                o, timing = self.pool.generate(prompts[lo:lo + largest],
                                               gen_len=self.gen_len)
                outs.append(o)
                chunks += 1
            out = np.concatenate(outs, axis=0)
            if out.shape[0] < batch.size:  # aborted tail: zero rows
                pad = np.zeros((batch.size - out.shape[0],) + out.shape[1:],
                               out.dtype)
                out = np.concatenate([out, pad], axis=0)
            timing = dict(timing)
            timing["chunks"] = chunks
        latency = self.clock() - t0
        self.batches += 1
        self.requests += batch.size
        if aborted_from is not None:
            timing["deadline_aborted"] = batch.size - aborted_from
            self.deadline_aborted += batch.size - aborted_from
        for i, (req, tokens) in enumerate(zip(batch.requests, out)):
            if aborted_from is not None and i >= aborted_from:
                req.timed_out = True  # partial batch: tail reported dead
            else:
                req.payload = tokens
        if self.on_done is not None:
            self.on_done(batch, latency, t0 + latency)
        return out, timing
