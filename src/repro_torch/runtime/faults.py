"""Deterministic chaos injection for the live runtime.

:class:`FaultyTarget` wraps any :class:`~repro.runtime.targets.DispatchTarget`
and injects the five fault kinds the sim-world chaos suite
(``experiments/scenarios.py``, PR 2) models on the platform side:

``crash``
    The container dies before producing a result: sleep ``crash_latency``
    (the time the proxy waits before the failure surfaces), then raise
    :class:`CrashFault`. The inner target is never invoked.
``timeout``
    The upstream stalls and the platform's gateway answers 504: sleep
    ``timeout_stall`` — burning real deadline budget — then raise
    :class:`UpstreamTimeout`. The inner target is never invoked.
``straggler``
    A cold-start / noisy-neighbour slowdown: sleep ``straggler_delay``
    extra, then run the inner target normally. No error is raised —
    stragglers exercise hedging and deadline budgets, not retries.
``partial``
    The batch executes but a fraction of its results are unusable (e.g.
    a worker crashed mid-batch after partial writeback): run the inner
    target to completion, then raise :class:`PartialBatchFault`. The
    proxy retries the *whole* batch — the simple policy that keeps
    exactly-once accounting trivial (no per-request splits mid-flight).
``preempt``
    The platform reclaims the container mid-execution: race the inner
    target against a ``preempt_after`` timer; if the timer wins, cancel
    the inner call and raise :class:`PreemptedFault`.

Determinism: faults are drawn from a dedicated seeded RNG stream (the
third :class:`numpy.random.SeedSequence` child, mirroring the simulator's
``arrivals``/``service``/``faults`` split) with exactly one uniform draw
at call entry, in dispatch order. Under
:class:`~repro.runtime.clock.FakeClock` dispatch order is deterministic,
so the full fault schedule — recorded in :attr:`FaultyTarget.fault_log` —
is bit-identical across runs with the same seed.
"""
from __future__ import annotations

import asyncio
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.request import Batch
from repro_torch.runtime.clock import Clock
from repro_torch.runtime.targets import DispatchTarget

#: The five injectable fault kinds, in cumulative-probability order.
FAULT_KINDS: Tuple[str, ...] = (
    "crash", "timeout", "straggler", "partial", "preempt"
)


class InjectedFault(RuntimeError):
    """Base class of every fault :class:`FaultyTarget` injects."""


class CrashFault(InjectedFault):
    """The (simulated) container crashed before producing a result."""


class UpstreamTimeout(InjectedFault):
    """The (simulated) upstream stalled until the platform gateway gave up."""


class PartialBatchFault(InjectedFault):
    """The batch executed but some results were lost; retry the whole batch."""


class PreemptedFault(InjectedFault):
    """The platform reclaimed the container mid-execution."""


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Injection probabilities and timing of each fault kind.

    Probabilities are per dispatch attempt and mutually exclusive (one
    uniform draw selects at most one kind); their sum must be <= 1.
    """

    #: P(container crash) and how long the crash takes to surface.
    crash_prob: float = 0.0
    crash_latency: float = 0.005
    #: P(upstream stall -> gateway 504) and how long the stall burns.
    timeout_prob: float = 0.0
    timeout_stall: float = 0.5
    #: P(straggler) and the extra delay added before a normal completion.
    straggler_prob: float = 0.0
    straggler_delay: float = 0.5
    #: P(partial-batch failure); the whole batch is retried (see module doc).
    partial_prob: float = 0.0
    #: P(preemption) and how far into execution the container is reclaimed.
    preempt_prob: float = 0.0
    preempt_after: float = 0.01
    #: Seed of the dedicated fault stream (see :func:`fault_rng`).
    seed: int = 0

    def __post_init__(self) -> None:
        probs = (self.crash_prob, self.timeout_prob, self.straggler_prob,
                 self.partial_prob, self.preempt_prob)
        if any(p < 0 for p in probs) or sum(probs) > 1.0 + 1e-12:
            raise ValueError(
                f"fault probabilities must be >= 0 and sum to <= 1, got "
                f"{probs}"
            )
        for what, v in (("crash_latency", self.crash_latency),
                        ("timeout_stall", self.timeout_stall),
                        ("straggler_delay", self.straggler_delay),
                        ("preempt_after", self.preempt_after)):
            if v < 0:
                raise ValueError(f"{what} must be >= 0, got {v}")

    @property
    def total_prob(self) -> float:
        return (self.crash_prob + self.timeout_prob + self.straggler_prob
                + self.partial_prob + self.preempt_prob)


def fault_rng(seed: int) -> np.random.Generator:
    """The named fault stream: third SeedSequence child of ``seed``.

    Mirrors the simulator's ``arrivals``/``service``/``faults`` stream
    split (and :func:`~repro.runtime.loadgen._spawn_streams`, which takes
    children 0 and 1), so a live run seeded like a sim run draws its
    faults from the same stream the platform's chaos would.
    """
    streams: Sequence[np.random.SeedSequence] = \
        np.random.SeedSequence(seed).spawn(3)
    return np.random.default_rng(streams[2])


class FaultyTarget(DispatchTarget):
    """Chaos wrapper around any :class:`DispatchTarget` (see module doc).

    Exposes the inner target's ``max_batch``/``batch_buckets`` unchanged
    so policy-cap clamping and bucket-aware packing behave identically
    with and without the wrapper.
    """

    def __init__(self, inner: DispatchTarget, clock: Clock,
                 config: FaultConfig,
                 rng: Optional[np.random.Generator] = None,
                 tracer=None) -> None:
        self.inner = inner
        self.clock = clock
        self.config = config
        self.tracer = tracer
        self.rng = rng if rng is not None else fault_rng(config.seed)
        # mirror the inner target's shape contract so cap clamping and
        # bucket-aware packing behave identically through the wrapper
        self.max_batch = inner.max_batch
        self.batch_buckets = getattr(inner, "batch_buckets", None)
        # cumulative selection edges, in FAULT_KINDS order
        probs = (config.crash_prob, config.timeout_prob,
                 config.straggler_prob, config.partial_prob,
                 config.preempt_prob)
        edges: List[Tuple[float, str]] = []
        acc = 0.0
        for p, kind in zip(probs, FAULT_KINDS):
            acc += p
            edges.append((acc, kind))
        self._edges = edges
        self.calls = 0
        #: injections per kind (plus "ok" for clean passes) — lifetime.
        self.injected = {kind: 0 for kind in FAULT_KINDS}
        self.injected["ok"] = 0
        #: (call index, clock time, kind) per dispatch attempt, including
        #: clean ones — the byte-identity artifact of the determinism tests.
        self.fault_log: List[Tuple[int, float, str]] = []

    # --------------------------------------------------------------- metrics
    def register_metrics(self, registry, prefix: str = "chaos") -> None:
        """Bind the injection ledger into a MetricsRegistry."""
        b = registry.bind
        b(f"{prefix}.calls", lambda: self.calls)
        for kind in (*FAULT_KINDS, "ok"):
            b(f"{prefix}.injected.{kind}",
              lambda k=kind: self.injected[k])

    # --------------------------------------------------------------- helpers
    def _draw(self) -> str:
        """One uniform draw at call entry selects the fault kind (or 'ok')."""
        if self.config.total_prob <= 0.0:
            # zero-fault config: skip the draw entirely so a wrapped target
            # is RNG-identical to the bare one (the no-fault byte-identity
            # guarantee the bench asserts)
            return "ok"
        u = float(self.rng.random())
        for edge, kind in self._edges:
            if u < edge:
                return kind
        return "ok"

    async def _invoke(self, batch: Batch, deadline: Optional[float]):
        return await self.inner(batch, deadline=deadline)

    # --------------------------------------------------------------- dispatch
    async def __call__(self, batch: Batch,
                       deadline: Optional[float] = None):
        idx = self.calls
        self.calls += 1
        kind = self._draw()
        self.injected[kind] += 1
        now = self.clock.now()
        self.fault_log.append((idx, now, kind))
        if self.tracer is not None:
            self.tracer.emit(now, "attempt", batch.endpoint,
                             batch=batch.trace_id, size=batch.size,
                             detail=kind)
        cfg = self.config
        if kind == "crash":
            await self.clock.sleep(cfg.crash_latency)
            raise CrashFault(
                f"injected container crash on call {idx} "
                f"(batch of {batch.size})"
            )
        if kind == "timeout":
            await self.clock.sleep(cfg.timeout_stall)
            raise UpstreamTimeout(
                f"injected upstream stall of {cfg.timeout_stall}s on call "
                f"{idx} (batch of {batch.size})"
            )
        if kind == "straggler":
            await self.clock.sleep(cfg.straggler_delay)
            return await self._invoke(batch, deadline)
        if kind == "partial":
            result = await self._invoke(batch, deadline)
            del result  # results discarded: the whole batch is retried
            raise PartialBatchFault(
                f"injected partial-batch failure on call {idx} "
                f"(batch of {batch.size})"
            )
        if kind == "preempt":
            loop = asyncio.get_running_loop()
            work = loop.create_task(self._invoke(batch, deadline))
            timer = loop.create_task(self.clock.sleep(cfg.preempt_after))
            try:
                await asyncio.wait({work, timer},
                                   return_when=asyncio.FIRST_COMPLETED)
            except asyncio.CancelledError:
                # outer cancellation (drain timeout / losing hedge): tear
                # down both children before propagating
                for t in (work, timer):
                    t.cancel()
                await asyncio.gather(work, timer, return_exceptions=True)
                raise
            if work.done():
                timer.cancel()
                await asyncio.gather(timer, return_exceptions=True)
                return work.result()
            work.cancel()
            await asyncio.gather(work, return_exceptions=True)
            raise PreemptedFault(
                f"injected preemption after {cfg.preempt_after}s on call "
                f"{idx} (batch of {batch.size})"
            )
        return await self._invoke(batch, deadline)
