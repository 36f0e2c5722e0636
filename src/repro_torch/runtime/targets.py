"""Dispatch targets — where the live runtime sends a dispatched batch.

A target is an async callable ``await target(batch)``; the server measures
the wall(-virtual) time around the await and that measurement IS the
upstream latency the policy's monitor learns from (the paper's measured
feedback loop, §2.2). Two implementations:

* :class:`SyntheticTarget` — models the upstream with any
  :class:`~repro.serverless.latency.LatencyModel`: samples a service time
  (per the batch's endpoint-aware ``sample_batch`` hook) and sleeps it on
  the runtime clock. An optional concurrency cap queues excess batches,
  so queueing delay shows up in the measured latency exactly like the
  platform's activator queue does in the simulator.
* :class:`EngineTarget` — the real data plane: adapts
  :class:`~repro.serving.batcher.ReplicaPoolTarget` (bucketed JAX
  prefill/decode on a :class:`~repro.serving.engine.ReplicaPool`), running
  the blocking engine call in a worker thread so the event loop keeps
  serving arrivals while a batch computes.

Both expose ``max_batch`` (None = unbounded) so the server can clamp a
policy's batch-size cap to the largest engine bucket at *config* time
instead of discovering the mismatch mid-dispatch.
"""
from __future__ import annotations

import asyncio
import functools
import inspect
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.request import Batch
from repro_torch.runtime.clock import Clock
from repro_torch.serverless.latency import LatencyModel


class DispatchTarget:
    """Protocol: awaitable batch executor with an optional size ceiling.

    ``deadline`` is the batch's tightest remaining absolute deadline on
    the runtime clock (None = no member carries one). Targets are free to
    ignore it; real HTTP/gRPC upstreams would map it onto a request
    timeout header so the whole serving chain stays SLO-accountable.
    """

    #: Largest batch the target can execute in one call (None = unbounded).
    max_batch: Optional[int] = None
    #: Compiled batch buckets of a fixed-shape backend (None = shapeless).
    #: The server's ``add_endpoint(pack=True)`` reads this to turn on
    #: bucket-aware packing in the owning policy.
    batch_buckets: Optional[Tuple[int, ...]] = None

    async def __call__(self, batch: Batch,
                       deadline: Optional[float] = None) -> None:
        raise NotImplementedError


class SyntheticTarget(DispatchTarget):
    """Async-sleep upstream parameterized by any :class:`LatencyModel`.

    ``concurrency`` > 0 bounds simultaneous batch executions with a
    semaphore (a fixed-size container fleet); the wait for a slot is part
    of the measured upstream latency, mirroring platform-side queueing.
    """

    def __init__(self, latency_model: LatencyModel, clock: Clock,
                 rng: Optional[np.random.Generator] = None,
                 concurrency: int = 0,
                 batch_buckets: Optional[Sequence[int]] = None) -> None:
        self.latency = latency_model
        self.clock = clock
        # an optional bucket grid makes the synthetic upstream behave like
        # a fixed-shape engine for packing experiments (latency models
        # already price batches by Batch.effective_size)
        self.batch_buckets = tuple(batch_buckets) if batch_buckets else None
        self.rng = rng if rng is not None else np.random.default_rng(0)
        self.concurrency = concurrency
        self._sem = asyncio.Semaphore(concurrency) if concurrency > 0 else None
        self.batches = 0
        self.requests = 0
        self.cancelled = 0
        #: calls that began executing (>= batches: a preempted / hedged /
        #: drain-cancelled call starts but never completes)
        self.started = 0
        #: tightest deadline of the most recent call (propagation probe)
        self.last_deadline: Optional[float] = None

    async def __call__(self, batch: Batch,
                       deadline: Optional[float] = None) -> None:
        # Sample BEFORE awaiting the slot: service-time draws happen in
        # dispatch order, so the stream stays deterministic under FakeClock
        # regardless of how long slot waits interleave.
        self.started += 1
        self.last_deadline = deadline
        service = float(self.latency.sample_batch(batch, self.rng))
        try:
            if self._sem is not None:
                async with self._sem:
                    await self.clock.sleep(service)
            else:
                await self.clock.sleep(service)
        except asyncio.CancelledError:
            # hedge loser / drain-timeout straggler: slot freed, no count
            self.cancelled += 1
            raise
        self.batches += 1
        self.requests += batch.size


class TieredTarget(DispatchTarget):
    """Fan-out target: one inner :class:`DispatchTarget` per fleet tier.

    The live-world counterpart of
    :class:`~repro.serverless.tiers.TieredPlatform`: batches arrive
    already stamped with ``batch.tier`` by the endpoint's
    :class:`~repro.core.frontend.SpilloverRouter` (the same router seam
    the simulator uses, so routing decisions agree across worlds) and
    are forwarded to that tier's target. Unstamped batches fall back to
    the cheapest tier, so a router-less endpoint degrades to a
    single-tier fleet instead of erroring.

    Per-tier busy-seconds are integrated around each call and combined
    through ``cost_weights`` into :attr:`cost_integral` — the live
    analogue of the platform's billable-seconds cost metric (billing
    here follows *execution* time, as serverless per-invocation billing
    does, rather than provisioned-fleet time).
    """

    def __init__(self, targets, clock: Clock,
                 cost_weights: Optional[dict] = None) -> None:
        if not targets:
            raise ValueError("TieredTarget needs at least one tier")
        self.targets = dict(targets)
        self.clock = clock
        weights = cost_weights or {}
        self.cost_weights = {
            n: float(weights.get(n, 1.0)) for n in self.targets}
        # cheapest tier is the fallback (first wins on cost ties)
        self.default_tier = min(self.targets,
                                key=lambda n: self.cost_weights[n])
        # conservative ceiling: the smallest per-tier cap must hold for
        # every tier a batch might land on
        caps = [t.max_batch for t in self.targets.values()
                if t.max_batch is not None]
        self.max_batch = min(caps) if caps else None
        buckets = {t.batch_buckets for t in self.targets.values()}
        self.batch_buckets = (buckets.pop() if len(buckets) == 1 else None)
        self._takes_deadline = {}
        for name, t in self.targets.items():
            try:
                sig = inspect.signature(
                    t.__call__ if hasattr(t, "__call__") else t)
                self._takes_deadline[name] = "deadline" in sig.parameters
            except (TypeError, ValueError):
                self._takes_deadline[name] = False
        self.calls = {n: 0 for n in self.targets}
        self.requests = {n: 0 for n in self.targets}
        self.busy_seconds = {n: 0.0 for n in self.targets}
        self.default_routed = 0  # batches that arrived with no tier stamp

    @property
    def cost_integral(self) -> float:
        """Weighted busy-seconds: Σ tier ``cost_weight × busy_seconds``."""
        return sum(self.cost_weights[n] * s
                   for n, s in self.busy_seconds.items())

    def stats(self) -> dict:
        """Per-tier call/billing breakdown for the server summary."""
        return {
            "default_routed": self.default_routed,
            "cost_integral": self.cost_integral,
            "tiers": {
                n: {
                    "calls": self.calls[n],
                    "requests": self.requests[n],
                    "busy_seconds": self.busy_seconds[n],
                    "cost_weight": self.cost_weights[n],
                    "cost_integral": (self.cost_weights[n]
                                      * self.busy_seconds[n]),
                }
                for n in self.targets
            },
        }

    async def __call__(self, batch: Batch,
                       deadline: Optional[float] = None) -> None:
        tier = batch.tier
        if tier is None:
            batch.tier = tier = self.default_tier
            self.default_routed += 1
        try:
            target = self.targets[tier]
        except KeyError:
            raise KeyError(f"batch stamped with unknown tier {tier!r}; "
                           f"fleet has {sorted(self.targets)}") from None
        t0 = self.clock.now()
        try:
            if self._takes_deadline[tier]:
                await target(batch, deadline=deadline)
            else:
                await target(batch)
        finally:
            # billed while running — a cancelled straggler still accrues
            self.busy_seconds[tier] += float(self.clock.now() - t0)
        self.calls[tier] += 1
        self.requests[tier] += batch.size


class EngineTarget(DispatchTarget):
    """Real JAX engine upstream via :class:`ReplicaPoolTarget`.

    The blocking pool call runs in ``asyncio``'s default thread-pool
    executor, keeping the proxy loop responsive. Concurrency defaults to
    the pool's replica count — the pool's per-replica locks let that many
    dispatches overlap on distinct replicas, so the runtime no longer
    serializes a multi-replica pool behind one slot. Oversized batches
    are chunked by the pool target (see ``serving/batcher.py``), so a
    policy whose cap exceeds the largest engine bucket degrades to
    multiple engine calls instead of raising mid-dispatch.
    """

    def __init__(self, pool_target,
                 max_concurrent: Optional[int] = None,
                 clock: Optional[Clock] = None) -> None:
        # `pool_target` is a ReplicaPoolTarget (imported lazily by callers
        # so this module stays importable without JAX).
        self.pool_target = pool_target
        # the runtime clock deadlines are absolute on; required to forward
        # deadlines (the pool target's measurement clock has a different
        # epoch, so the absolute value must be translated, not passed raw)
        self.clock = clock
        buckets = pool_target.pool.engine_cfg.batch_buckets
        self.max_batch = max(buckets)
        self.batch_buckets = tuple(buckets)
        if max_concurrent is None:
            max_concurrent = max(1, len(pool_target.pool.replicas))
        self._sem = asyncio.Semaphore(max_concurrent)
        # Older pool targets predate the ``deadline=`` parameter.
        try:
            sig = inspect.signature(pool_target.__call__)
            self._takes_deadline = "deadline" in sig.parameters
        except (TypeError, ValueError):
            self._takes_deadline = False

    def _pool_deadline(self, deadline: Optional[float]) -> Optional[float]:
        """Translate a runtime-clock deadline onto the pool's clock.

        Both are absolute instants but on different epochs (the runtime
        clock zeroes at server start; the pool's measurement clock is raw
        monotonic), so the *remaining budget* is carried across:
        ``pool_now + (deadline - runtime_now)``. Without a runtime clock
        there is no sound translation — forward None rather than a
        wrong-epoch value that would abort every follow-up chunk.
        """
        if deadline is None or self.clock is None:
            return None
        pool_clock = getattr(self.pool_target, "clock", None)
        if pool_clock is None:
            return None
        return pool_clock() + (deadline - self.clock.now())

    async def __call__(self, batch: Batch,
                       deadline: Optional[float] = None) -> None:
        # The deadline is forwarded to the pool target, whose chunked
        # path aborts unexecuted chunks once it passes (a chunk already
        # running is not interruptible mid-kernel).
        loop = asyncio.get_running_loop()
        if self._takes_deadline:
            call = functools.partial(self.pool_target, batch,
                                     deadline=self._pool_deadline(deadline))
        else:
            call = functools.partial(self.pool_target, batch)
        async with self._sem:
            await loop.run_in_executor(None, call)
