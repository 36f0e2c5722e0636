"""AsyncProxyServer — the wall-clock reverse-proxy runtime.

This is the live counterpart of the discrete-event drivers in
``simulation/simulator.py``: the same ONE batching core — a
:class:`~repro.core.frontend.ProxyFrontend` routing over
:class:`~repro.core.batch_queue.Policy` instances on the shared
:class:`~repro.core.batch_queue.BatchQueue` — driven by real asyncio
timers instead of a simulated event heap. Policies are clock-free
(callers pass ``now``), so MLProxy and all four baselines run here
**unmodified**; the runtime contributes only:

* the **timer loop** — one task that sleeps until the frontend's merged
  ``next_event_time`` (woken early by arrivals/completions/shutdown) and
  fires ``on_timer``, exactly the role the simulator's generation-stamped
  timer events play;
* **dispatch execution** — every batch a policy dispatches becomes an
  asyncio task awaiting a :class:`~repro.runtime.targets.DispatchTarget`;
  the measured await time is the upstream latency fed back through
  ``on_response`` (the paper's measured feedback loop);
* **admission control / backpressure** — optional caps on per-endpoint
  queue depth and total outstanding requests; excess submissions are
  rejected at the door and accounted for;
* **deadline enforcement** — requests carry an absolute deadline
  (client-supplied or derived from the endpoint SLA); the shared
  ``BatchQueue`` expiry sweep evicts dead requests before batch
  formation, their tickets resolve with a :class:`DeadlineExceeded`
  result, and the batch's tightest remaining deadline is propagated to
  the dispatch target;
* **proxy-tier straggler hedging** — a dispatched batch that exceeds the
  configured quantile of its bucket's measured latency is re-issued to
  the target; first completion wins and the loser is cancelled (the
  proxy-side mirror of the platform's hedge ledger);
* **deadline-aware retries** — a failed dispatch attempt is retried with
  capped exponential backoff plus seeded jitter, but never past the
  batch's tightest deadline: leftover budget resolves the tickets
  ``timed_out`` (the SLA already lost), an exhausted retry budget
  resolves them ``failed`` with a :class:`TargetError`;
* **circuit breaking + brownout shedding** — an optional per-endpoint
  :class:`~repro.runtime.breaker.CircuitBreaker` opens on a windowed
  failure rate; while it is not closed, admission runs in brownout
  (tightened ``max_queue``/``max_outstanding`` caps) and the open
  transition sheds the endpoint's lowest-slack queued requests — both
  accounted in the dedicated ``shed`` ledger class, distinct from
  ``rejected`` (hard caps) and ``timed_out`` (deadlines);
* **graceful drain** — ``drain(timeout=...)`` stops admissions, flushes
  every queue, awaits in-flight work (cancelling stragglers — including
  batches parked on a retry backoff or a breaker probe wait — at the
  timeout) and asserts the runtime conservation invariant
  (``submitted == completed + rejected + shed + timed_out + failed``,
  zero lost — the live mirror of the platform's ``assert_conserved``).

All interaction with the server must happen on its event loop (asyncio is
single-threaded; policies are not thread-safe).
"""
from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import inspect
import math
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.config import SLAConfig
from repro_torch.core.frontend import ProxyFrontend, SpilloverRouter
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.core.request import Batch, Request
from repro_torch.runtime.breaker import CLOSED, BreakerConfig, CircuitBreaker
from repro_torch.runtime.clock import Clock, WallClock
from repro_torch.runtime.targets import DispatchTarget
from repro_torch.simulation.stats import CompletionLog


class DeadlineExceeded(Exception):
    """A request's deadline passed while it was still queued at the proxy.

    Its ticket resolves normally (``ticket.timed_out`` is True and
    ``ticket.error`` carries this exception); the request was never
    dispatched or billed.
    """


class DrainTimeout(Exception):
    """A dispatched batch was cancelled because ``drain(timeout=...)``
    expired before its target completed; its requests are accounted as
    ``failed`` and their tickets resolve with this error."""


class TargetError(Exception):
    """A dispatch target kept failing until the retry budget ran out.

    The final upstream exception is chained as ``__cause__``; the batch's
    requests are accounted as ``failed`` and their tickets resolve with
    this error — a buggy target degrades one batch, not the whole drain.
    """

    def __init__(self, message: str, attempts: int = 1) -> None:
        super().__init__(message)
        self.attempts = attempts


class BrownoutShed(Exception):
    """A request was shed by brownout admission control: its endpoint's
    circuit breaker is not closed, so the proxy is deliberately dropping
    load it cannot serve within SLA. The ticket resolves normally with
    ``shed=True`` and this error attached; the request was never
    dispatched or billed (a distinct ledger class from ``rejected``)."""


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Knobs of the live runtime (all independent of any policy)."""

    #: Per-endpoint pending-queue cap; a submission that would grow the
    #: policy queue past this is rejected. 0 = unlimited.
    max_queue: int = 0
    #: Cap on outstanding requests (accepted, not yet completed) across
    #: the whole server — the backpressure valve. 0 = unlimited.
    max_outstanding: int = 0
    #: Re-check cadence of the timer loop when no policy deadline is
    #: pending (it is otherwise woken by arrivals/completions).
    timer_idle: float = 1.0
    #: Floor between consecutive timer firings; guards against a policy
    #: whose ``next_event_time`` returns the same instant repeatedly
    #: (mirrors the simulator driver's ``min_time`` guard).
    min_timer_tick: float = 1e-6
    #: How policy batch caps exceeding a target's ``max_batch`` are
    #: handled at ``add_endpoint`` time: "clamp" rewrites the policy's cap
    #: down to the largest bucket; "error" raises immediately.
    oversize: str = "clamp"
    #: Proxy-tier straggler hedging: a dispatched batch still unfinished
    #: after the ``hedge_quantile``-th percentile of its bucket's measured
    #: upstream latency is re-issued to the target; first completion wins,
    #: the loser is cancelled. Percentile units (e.g. 95.0); <= 0 disables.
    hedge_quantile: float = 0.0
    #: Minimum in-window latency samples for a bucket before hedging arms
    #: (a cold bucket has no trustworthy straggler threshold).
    hedge_min_samples: int = 10
    #: Proxy-tier retry budget per batch: a failed dispatch attempt is
    #: retried up to this many times with capped exponential backoff,
    #: never past the batch's tightest deadline. 0 disables retries (a
    #: failed batch resolves immediately — the pre-fault-tolerance
    #: behaviour, and the byte-identity default).
    max_retries: int = 0
    #: Backoff before the first retry; attempt k waits
    #: ``min(retry_backoff * 2**(k-1), retry_backoff_cap)`` seconds.
    retry_backoff: float = 0.05
    retry_backoff_cap: float = 2.0
    #: Uniform jitter fraction multiplied onto each backoff (decorrelates
    #: retry storms); drawn from the seeded retry stream, one draw per
    #: retry actually scheduled, so no-retry runs never touch the stream.
    retry_jitter: float = 0.1
    #: Seed of the retry-jitter stream.
    retry_seed: int = 0
    #: Per-endpoint circuit breaker; None disables breaking (and with it
    #: brownout shedding).
    breaker: Optional[BreakerConfig] = None
    #: Brownout queue cap while an endpoint's breaker is not closed: the
    #: endpoint's pending queue is held at this depth (excess submissions
    #: are shed, and the open transition sheds queued requests down to
    #: it, lowest slack first). 0 disables queue brownout.
    brownout_queue: int = 4
    #: Brownout cap on total outstanding requests while ANY breaker is
    #: not closed. 0 disables outstanding brownout.
    brownout_outstanding: int = 0

    def __post_init__(self) -> None:
        if self.oversize not in ("clamp", "error"):
            raise ValueError(f"unknown oversize mode {self.oversize!r}")
        if self.hedge_quantile > 100 or 0 < self.hedge_quantile < 1:
            # fractions like 0.95 would silently hedge at the bucket
            # MINIMUM (rank ⌈0.0095·n⌉), doubling upstream load
            raise ValueError(
                f"hedge_quantile is in percentile units ((1, 100], e.g. "
                f"95.0; <= 0 disables), got {self.hedge_quantile}"
            )
        if self.hedge_min_samples < 1:
            raise ValueError("hedge_min_samples must be >= 1")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.retry_backoff <= 0 or self.retry_backoff_cap <= 0:
            raise ValueError("retry backoffs must be > 0")
        if self.retry_jitter < 0:
            raise ValueError("retry_jitter must be >= 0")
        if self.brownout_queue < 0 or self.brownout_outstanding < 0:
            raise ValueError("brownout caps must be >= 0 (0 disables)")


class RequestTicket:
    """Handle returned by :meth:`AsyncProxyServer.submit`.

    ``future`` resolves with the ticket when the request completes — or
    immediately with ``rejected=True`` when admission control turns it
    away, with ``shed=True`` (and ``error`` set to a
    :class:`BrownoutShed`) when brownout admission dropped it, or with
    ``timed_out=True`` (and ``error`` set to a :class:`DeadlineExceeded`)
    when the request's deadline expired while it was still queued.
    """

    __slots__ = ("request", "future", "rejected", "endpoint", "timed_out",
                 "shed", "error")

    def __init__(self, request: Request, future: asyncio.Future,
                 endpoint: str, rejected: bool = False) -> None:
        self.request = request
        self.future = future
        self.endpoint = endpoint
        self.rejected = rejected
        self.timed_out = False
        self.shed = False
        self.error: Optional[BaseException] = None

    @property
    def e2e_latency(self) -> Optional[float]:
        return self.request.e2e_latency


def clamp_policy_kwargs(policy: str, policy_kwargs: Optional[dict],
                        max_batch: int, mode: str = "clamp") -> dict:
    """Reconcile a policy's batch-size cap with an engine bucket ceiling.

    Policies dispatch up to their own cap (MLProxy's
    ``OptimizerConfig.max_bs_cap``, the baselines' ``batch_size``/
    ``max_cap``); a fixed-shape engine can only execute up to its largest
    compiled bucket. ``mode="clamp"`` rewrites the cap down to
    ``max_batch``; ``mode="error"`` raises so the mismatch fails at config
    time. (Dispatch-time chunking in ``serving/batcher.py`` is the safety
    net either way.)
    """
    kw = dict(policy_kwargs or {})

    def resolve(current: int, what: str) -> int:
        if current <= max_batch:
            return current
        if mode == "error":
            raise ValueError(
                f"{what} {current} exceeds the largest engine bucket "
                f"{max_batch}; lower the cap or add buckets"
            )
        return max_batch

    if policy == "mlproxy":
        from repro_torch.core.config import OptimizerConfig, ProxyConfig

        pc: Optional[ProxyConfig] = kw.get("proxy_config")
        opt: OptimizerConfig = (
            pc.optimizer if pc is not None
            else kw.get("optimizer") or OptimizerConfig()
        )
        cap = resolve(opt.max_bs_cap, "mlproxy max_bs_cap")
        if cap != opt.max_bs_cap:
            opt = dataclasses.replace(opt, max_bs_cap=cap,
                                      initial_max_bs=min(opt.initial_max_bs, cap))
            if pc is not None:
                kw["proxy_config"] = dataclasses.replace(pc, optimizer=opt)
            else:
                kw["optimizer"] = opt
    elif policy == "static":
        if "batch_size" in kw:
            kw["batch_size"] = resolve(kw["batch_size"], "static batch_size")
    elif policy in ("clipper", "oracle"):
        if "max_cap" in kw:
            # the caller chose this cap: clamp or error per `mode`
            kw["max_cap"] = resolve(kw["max_cap"], f"{policy} max_cap")
        else:
            # The caller never set a cap — the policy's own default
            # applies. Lower it silently if it exceeds the engine bucket
            # (a default is not a caller choice, so `mode="error"` must
            # not raise, and clamping must never *raise* the cap).
            from repro_torch.core.policies import DEFAULT_MAX_CAP

            if DEFAULT_MAX_CAP > max_batch:
                kw["max_cap"] = max_batch
    return kw


class AsyncProxyServer:
    """Asyncio reverse proxy running the shared batching core live."""

    def __init__(self, clock: Optional[Clock] = None,
                 config: Optional[RuntimeConfig] = None,
                 tracer=None, recorder=None) -> None:
        self.clock = clock if clock is not None else WallClock()
        self.config = config or RuntimeConfig()
        # Observability plane (both optional and zero-cost when None):
        # ``tracer`` (repro.obs.trace.Tracer) records lifecycle spans,
        # ``recorder`` (repro.obs.recorder.FlightRecorder) keeps the
        # bounded postmortem ring dumped on conservation failure, drain
        # timeout, or breaker-open.
        self.tracer = tracer
        self.recorder = recorder
        self.frontend = ProxyFrontend(tracer=tracer)
        self._targets: Dict[str, DispatchTarget] = {}
        self._target_takes_deadline: Dict[str, bool] = {}

        # conservation ledger:
        #   submitted == completed + rejected + shed + timed_out + failed
        #                + outstanding   (drained: outstanding == 0)
        self.submitted = 0
        self.completed = 0
        self.rejected = 0
        self.shed = 0  # brownout admission drop; never dispatched
        self.timed_out = 0  # deadline expired while queued; never dispatched
        self.failed = 0  # target raised; requests resolved with the error
        # Subset of `failed` that drain(timeout=) itself cancelled, and the
        # subset a target's exhausted retry budget produced (TargetError).
        # A clean shutdown tolerates exactly their sum — any OTHER failure
        # at drain still trips assert_conserved, preserving the "lost
        # accounting cannot slip through drain()" signal.
        self.drain_cancelled = 0
        self.target_failures = 0
        self._tickets: Dict[int, RequestTicket] = {}  # req_id → outstanding

        # active-window anchors for summary() throughput (the clock may
        # predate the server, and summaries may run after idle gaps)
        self._first_submit: Optional[float] = None
        self._last_completion: Optional[float] = None

        # proxy-tier straggler hedging
        self.hedged_batches = 0  # duplicates issued
        self.hedge_wins = 0      # duplicates that finished first
        self._hedged_by_ep: Dict[str, int] = {}
        self._hedge_wins_by_ep: Dict[str, int] = {}
        # per-endpoint admissions (the sim surfaces submitted_requests per
        # endpoint; key-parity requires the live summary to match)
        self._submitted_by_ep: Dict[str, int] = {}

        # proxy-tier retries + circuit breaking (fault tolerance)
        self.retried_batches = 0    # batches that needed >= 1 proxy retry
        self.retry_exhausted = 0    # batches whose retry budget ran out
        self.faulted_batches = 0    # batches with >= 1 failed attempt
        self.recovered_batches = 0  # faulted batches that still completed
        # completions whose ticket was already resolved — must stay 0;
        # the "zero duplicate completions" half of the chaos invariant
        self.duplicate_completions = 0
        #: (time, endpoint, batch size, failure #, backoff, error type)
        #: per retry actually scheduled — the fault-determinism artifact.
        self.retry_log: List[Tuple[float, str, int, int, float, str]] = []
        self._breakers: Dict[str, CircuitBreaker] = {}
        # seeded retry-jitter stream; drawn once per scheduled retry, in
        # scheduling order, so FakeClock runs stay bit-identical
        self._retry_rng = np.random.default_rng(
            np.random.SeedSequence(self.config.retry_seed))

        # dispatch bookkeeping
        self._batch_tasks: Set[asyncio.Task] = set()
        self.inflight_batches = 0
        #: (dispatch time, endpoint, size, effective size, cause) per batch
        #: — the decision log the determinism tests replay.
        self.dispatch_log: List[Tuple[float, str, int, int, str]] = []
        #: per-endpoint {bucket → [measured upstream seconds]} — the raw
        #: material of ``runtime/calibrate.py``.
        self.bucket_samples: Dict[str, Dict[int, List[float]]] = {}
        self.completions: Dict[str, CompletionLog] = {}

        # event-loop work counter: one tick per handled event (admission,
        # dispatch, expiry sweep, batch resolution, timer pass) — the live
        # mirror of the simulator drivers' ``events_processed``
        self.events_processed = 0

        self._wake = asyncio.Event()
        self._accepting = True
        self._running = False
        self._timer_task: Optional[asyncio.Task] = None

        # Central metrics surface: every hand-rolled ledger counter above
        # is bound (read-only, zero hot-path cost) into one registry.
        self.metrics = MetricsRegistry()
        self.register_metrics(self.metrics)

    def register_metrics(self, registry: "MetricsRegistry",
                         prefix: str = "server") -> None:
        """Bind the runtime ledger into a MetricsRegistry.

        Enforced by the ``unregistered-counter`` reprolint rule: every
        monotonic counter this class increments must be bound here (or
        carry an explicit suppression)."""
        b = registry.bind
        b(f"{prefix}.submitted", lambda: self.submitted)
        b(f"{prefix}.completed", lambda: self.completed)
        b(f"{prefix}.rejected", lambda: self.rejected)
        b(f"{prefix}.shed", lambda: self.shed)
        b(f"{prefix}.timed_out", lambda: self.timed_out)
        b(f"{prefix}.failed", lambda: self.failed)
        b(f"{prefix}.drain_cancelled", lambda: self.drain_cancelled)
        b(f"{prefix}.target_failures", lambda: self.target_failures)
        b(f"{prefix}.hedged_batches", lambda: self.hedged_batches)
        b(f"{prefix}.hedge_wins", lambda: self.hedge_wins)
        b(f"{prefix}.retried_batches", lambda: self.retried_batches)
        b(f"{prefix}.retry_exhausted", lambda: self.retry_exhausted)
        b(f"{prefix}.faulted_batches", lambda: self.faulted_batches)
        b(f"{prefix}.recovered_batches", lambda: self.recovered_batches)
        b(f"{prefix}.duplicate_completions",
          lambda: self.duplicate_completions)
        b(f"{prefix}.inflight_batches", lambda: self.inflight_batches)
        b(f"{prefix}.events_processed", lambda: self.events_processed)

    # ------------------------------------------------------------- topology
    def add_endpoint(self, name: str, *, sla: SLAConfig,
                     target: DispatchTarget, policy: str = "mlproxy",
                     policy_kwargs: Optional[dict] = None,
                     pack: bool = False,
                     router: Optional["SpilloverRouter"] = None) -> None:
        """Register an endpoint backed by ``target``.

        If the target declares a ``max_batch`` (fixed-shape engines), the
        policy's batch-size cap is reconciled with it per
        ``RuntimeConfig.oversize`` before the policy is built.

        ``pack=True`` turns on bucket-aware packing against the target's
        ``batch_buckets``: the policy's full-trigger rounds its batch
        target up to the next engine bucket edge and dispatches exactly at
        it, so "full" batches execute with zero padding (the padding-waste
        stat in :meth:`summary` shows the effect).

        ``router`` attaches a :class:`~repro.core.frontend.SpilloverRouter`
        that stamps ``batch.tier`` at dispatch; pair it with a
        :class:`~repro.runtime.targets.TieredTarget` whose tier names
        match the router's so stamped batches land on the right fleet.
        """
        if pack:
            buckets = getattr(target, "batch_buckets", None)
            if not buckets:
                raise ValueError(
                    f"pack=True needs a target exposing batch_buckets; "
                    f"{type(target).__name__} has none")
            policy_kwargs = dict(policy_kwargs or {})
            if policy == "mlproxy" and "proxy_config" in policy_kwargs:
                pc = policy_kwargs["proxy_config"]
                policy_kwargs["proxy_config"] = dataclasses.replace(
                    pc, pack_buckets=tuple(buckets))
            else:
                policy_kwargs.setdefault("pack_buckets", tuple(buckets))
        if target.max_batch is not None:
            policy_kwargs = clamp_policy_kwargs(
                policy, policy_kwargs, target.max_batch, self.config.oversize
            )
        self._targets[name] = target
        # Older/external targets may predate the ``deadline=`` parameter;
        # probe once at config time instead of discovering mid-dispatch.
        try:
            params = inspect.signature(target.__call__).parameters
            takes_deadline = ("deadline" in params or any(
                p.kind is inspect.Parameter.VAR_KEYWORD
                for p in params.values()))
        except (TypeError, ValueError):
            takes_deadline = False
        self._target_takes_deadline[name] = takes_deadline
        self.completions[name] = CompletionLog()
        self.bucket_samples[name] = {}
        self._submitted_by_ep[name] = 0
        self._hedged_by_ep[name] = 0
        self._hedge_wins_by_ep[name] = 0
        if self.config.breaker is not None:
            self._breakers[name] = CircuitBreaker(self.config.breaker)
            self._breakers[name].register_metrics(
                self.metrics, prefix=f"endpoint.{name}.breaker")

        def dispatch(batch: Batch, _name: str = name) -> None:
            self._on_dispatch(_name, batch)

        def expire(requests: List[Request], now: float,
                   _name: str = name) -> None:
            self._on_expired(_name, requests, now)

        ep = self.frontend.add_endpoint(
            name, sla=sla, dispatch_fn=dispatch,
            policy=policy, policy_kwargs=policy_kwargs, expire_fn=expire,
            router=router)
        if router is not None:
            router.register_metrics(self.metrics,
                                    prefix=f"endpoint.{name}.router")
        monitor = getattr(ep.policy, "monitor", None)
        if monitor is not None:
            monitor.register_metrics(self.metrics,
                                     prefix=f"endpoint.{name}")
        queue = getattr(
            getattr(ep.policy, "scheduler", ep.policy), "queue", None)
        if queue is not None:
            queue.register_metrics(self.metrics,
                                   prefix=f"endpoint.{name}.queue")

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._accepting = True
        self._timer_task = asyncio.get_running_loop().create_task(
            self._timer_loop()
        )

    async def drain(self, timeout: Optional[float] = None) -> None:
        """Graceful shutdown: stop admissions, flush, await in-flight work.

        ``timeout`` (seconds on the runtime clock) bounds the wait for
        in-flight batches: stragglers still running when it expires are
        cancelled, their tickets resolve with a :class:`DrainTimeout`
        error, and their requests are accounted as ``failed`` — a stuck
        upstream can no longer hang the process. ``None`` waits
        indefinitely (the pre-deadline behaviour).

        On return the conservation invariant holds in its drained form:
        every submitted request was completed, rejected at the door,
        timed out on its deadline, or failed — nothing queued, nothing in
        flight, nothing lost.
        """
        self._accepting = False
        self.frontend.flush(self.clock.now())
        if timeout is None:
            await self._await_batches()
        else:
            await self._drain_bounded(timeout)
        self._running = False
        self._wake.set()
        if self._timer_task is not None:
            await self._timer_task
            self._timer_task = None
        self.assert_conserved(require_drained=True)

    async def _await_batches(self) -> None:
        """Await in-flight batches, gathering only tasks not yet done: a
        finished task leaves ``_batch_tasks`` only once its callback runs."""
        while True:
            running = [t for t in self._batch_tasks if not t.done()]
            if not running:
                return
            await asyncio.gather(*running, return_exceptions=True)

    async def _drain_bounded(self, timeout: float) -> None:
        """Await in-flight batches up to ``timeout``, then cancel the rest."""
        # Let freshly created batch tasks take their first step so each
        # one owns its bookkeeping before any cancellation can reach it.
        await asyncio.sleep(0)
        loop = asyncio.get_running_loop()
        waiter = loop.create_task(self._await_batches())
        timer = loop.create_task(self.clock.sleep(timeout))
        await asyncio.wait({waiter, timer},
                           return_when=asyncio.FIRST_COMPLETED)
        if waiter.done():
            await self._cancel(timer)
            return
        await self._cancel(waiter)
        stragglers = list(self._batch_tasks)
        if stragglers and self.recorder is not None:
            self.recorder.dump("drain_timeout", now=self.clock.now(),
                               extra={"stragglers": len(stragglers),
                                      "timeout": timeout})
        for t in stragglers:
            t.cancel()
        # _run_batch converts the cancellation into failed-accounting and
        # finishes normally; gather collects stragglers either way.
        await asyncio.gather(*stragglers, return_exceptions=True)

    # -------------------------------------------------------------- ingress
    def submit(self, request: Optional[Request] = None, *,
               endpoint: Optional[str] = None, payload=None) -> RequestTicket:
        """Admit one request (event-loop thread only); returns its ticket.

        Raises ``ValueError`` if ``request.req_id`` is already
        outstanding: silently overwriting the old ticket would leak a
        never-resolving future and break the conservation ledger.
        """
        now = self.clock.now()
        if request is None:
            request = Request(arrival_time=now, payload=payload)
        elif request.req_id in self._tickets:
            raise ValueError(
                f"request {request.req_id} is already outstanding; "
                "submit a fresh Request per attempt"
            )
        ep = self.frontend.resolve(endpoint or request.endpoint)
        loop = asyncio.get_running_loop()
        future: asyncio.Future = loop.create_future()
        self.submitted += 1
        self._submitted_by_ep[ep.name] = \
            self._submitted_by_ep.get(ep.name, 0) + 1
        self.events_processed += 1
        if self._first_submit is None:
            self._first_submit = now

        cfg = self.config
        if cfg.max_queue > 0 or self._breakers:
            # dead requests the timer hasn't swept yet must not count
            # toward the queue cap (they would spuriously reject this one)
            ep.policy.expire(now)
        outstanding = self.submitted - self.completed - self.rejected \
            - self.shed - self.timed_out - self.failed - 1  # excl. this one
        reject = (
            not self._accepting
            or (cfg.max_outstanding > 0 and outstanding >= cfg.max_outstanding)
            or (cfg.max_queue > 0 and ep.policy.queue_len >= cfg.max_queue)
        )
        if reject:
            self.rejected += 1
            if self.tracer is not None:
                self.tracer.emit(now, "rejected", ep.name,
                                 req_id=request.req_id)
            ticket = RequestTicket(request, future, ep.name, rejected=True)
            future.set_result(ticket)
            return ticket

        # Brownout admission: while this endpoint's breaker is not closed
        # the queue cap tightens to brownout_queue, and while ANY breaker
        # is not closed the outstanding cap tightens to
        # brownout_outstanding. A submission admitted under the normal
        # caps but dropped by the tightened ones is `shed`, not
        # `rejected` — a deliberate brownout decision, not backpressure.
        breaker = self._breakers.get(ep.name)
        browned_ep = breaker is not None and breaker.state(now) != CLOSED
        drop = (
            browned_ep and cfg.brownout_queue > 0
            and ep.policy.queue_len >= cfg.brownout_queue
        )
        if (not drop and cfg.brownout_outstanding > 0
                and outstanding >= cfg.brownout_outstanding):
            drop = any(b.state(now) != CLOSED for b in self._breakers.values())
        if drop:
            self.shed += 1
            if self.tracer is not None:
                self.tracer.emit(now, "shed", ep.name,
                                 req_id=request.req_id, detail="brownout")
            ticket = RequestTicket(request, future, ep.name)
            ticket.shed = True
            ticket.error = BrownoutShed(
                f"request {request.req_id} shed at t={now:.6f}: endpoint "
                f"{ep.name!r} is browned out (breaker "
                f"{breaker.state(now) if breaker else 'n/a'})"
            )
            future.set_result(ticket)
            return ticket

        ticket = RequestTicket(request, future, ep.name)
        self._tickets[request.req_id] = ticket
        self.frontend.on_request(request, now, endpoint=ep.name)
        self._wake.set()  # deadline may have changed
        return ticket

    # ------------------------------------------------------------- dispatch
    def _on_dispatch(self, name: str, batch: Batch) -> None:
        """Policy handed us a batch (synchronously, on the loop thread)."""
        now = self.clock.now()
        self.dispatch_log.append(
            (now, name, batch.size, batch.effective_size, batch.cause)
        )
        self.inflight_batches += 1
        self.events_processed += 1
        if self.recorder is not None:
            self.recorder.note(now, "dispatch", endpoint=name,
                               batch=batch.trace_id, size=batch.size,
                               cause=batch.cause)
        task = asyncio.get_running_loop().create_task(
            self._run_batch(name, batch, now)
        )
        self._batch_tasks.add(task)
        task.add_done_callback(self._batch_tasks.discard)

    def _on_expired(self, name: str, requests: List[Request],
                    now: float) -> None:
        """Expiry sweep evicted ``requests``: resolve their tickets.

        The requests were never dispatched (and never will be); their
        tickets resolve with ``timed_out=True`` and a
        :class:`DeadlineExceeded` error attached.
        """
        for r in requests:
            ticket = self._tickets.pop(r.req_id, None)
            if ticket is not None and not ticket.future.done():
                ticket.timed_out = True
                ticket.error = DeadlineExceeded(
                    f"request {r.req_id} expired at t={now:.6f} "
                    f"(deadline {r.deadline:.6f}) while queued on "
                    f"{name!r}"
                )
                ticket.future.set_result(ticket)
        self.timed_out += len(requests)
        self.events_processed += 1
        self._wake.set()

    def _hedge_threshold(self, name: str, batch: Batch) -> Optional[float]:
        """Straggler threshold for ``batch``: the configured quantile of
        its bucket's measured upstream latency (None = hedging off or the
        bucket is still cold)."""
        q = self.config.hedge_quantile
        if q <= 0:
            return None
        monitor = getattr(self.frontend.endpoint(name).policy, "monitor", None)
        if monitor is None:
            return None
        return monitor.bucket_quantile(
            batch.effective_size, q, self.clock.now(),
            self.config.hedge_min_samples,
        )

    async def _execute_hedged(self, name: str, batch: Batch,
                              deadline: Optional[float]) -> int:
        """Run ``batch`` on its target with optional straggler hedging.

        Returns the number of attempts issued (1, or 2 when hedged).
        First completion wins; the other attempt is cancelled. If the
        first finisher raised while its sibling is still running, the
        sibling is awaited as the fallback before giving up.
        """
        target = self._targets[name]
        loop = asyncio.get_running_loop()
        if self._target_takes_deadline[name]:
            start = lambda: loop.create_task(target(batch, deadline=deadline))  # noqa: E731
        else:
            start = lambda: loop.create_task(target(batch))  # noqa: E731
        children: Set[asyncio.Task] = set()
        try:
            primary = start()
            children.add(primary)
            threshold = self._hedge_threshold(name, batch)
            if threshold is None:
                await primary
                return 1

            timer = loop.create_task(self.clock.sleep(threshold))
            children.add(timer)
            await asyncio.wait({primary, timer},
                               return_when=asyncio.FIRST_COMPLETED)
            if primary.done():
                await self._cancel(timer)
                children.discard(timer)
                primary.result()  # re-raise a target error
                return 1

            # Straggler: re-issue to the target; first completion wins.
            await self._cancel(timer)
            children.discard(timer)
            self.hedged_batches += 1
            self._hedged_by_ep[name] = self._hedged_by_ep.get(name, 0) + 1
            if self.tracer is not None:
                self.tracer.emit(self.clock.now(), "hedge", name,
                                 batch=batch.trace_id, size=batch.size,
                                 value=threshold)
            hedge = start()
            children.add(hedge)
            done, pending = await asyncio.wait(
                {primary, hedge}, return_when=asyncio.FIRST_COMPLETED)
            ok = [t for t in done if t.exception() is None]
            if ok:
                winner = primary if primary in ok else hedge
            elif pending:
                # sole finisher failed — fall back to the live sibling
                winner = next(iter(pending))
                await asyncio.wait({winner})
                if winner.exception() is not None:
                    next(iter(done)).result()  # raise the FIRST error
            else:
                primary.result()  # both done, both failed
                raise primary.exception()  # pragma: no cover (unreachable)
            for t in (primary, hedge):
                if t is not winner:
                    await self._cancel(t)
                    children.discard(t)
            if winner is hedge:
                self.hedge_wins += 1
                self._hedge_wins_by_ep[name] = \
                    self._hedge_wins_by_ep.get(name, 0) + 1
            winner.result()
            return 2
        except asyncio.CancelledError:
            # drain(timeout=) cancelled us: tear down every live attempt
            for t in children:
                t.cancel()
            await asyncio.gather(*children, return_exceptions=True)
            raise

    @staticmethod
    async def _cancel(task: asyncio.Task) -> None:
        task.cancel()
        with contextlib.suppress(asyncio.CancelledError, Exception):
            await task

    def _brownout_shed(self, name: str, now: float) -> None:
        """Breaker opened on ``name``: shed its queue down to the brownout
        cap, lowest-slack first, and resolve the victims' tickets."""
        keep = self.config.brownout_queue
        if keep <= 0:
            return
        victims = self.frontend.endpoint(name).policy.shed(now, keep)
        for r in victims:
            ticket = self._tickets.pop(r.req_id, None)
            if ticket is not None and not ticket.future.done():
                ticket.shed = True
                ticket.error = BrownoutShed(
                    f"request {r.req_id} shed at t={now:.6f}: endpoint "
                    f"{name!r} circuit opened"
                )
                ticket.future.set_result(ticket)
        self.shed += len(victims)
        if victims:
            self._wake.set()

    def _record_failure(self, name: str, batch: Batch, now: float) -> None:
        """One dispatch attempt failed: feed the monitor's failure stats
        and the breaker; an opening breaker triggers brownout shedding."""
        monitor = getattr(self.frontend.endpoint(name).policy, "monitor", None)
        if monitor is not None:
            monitor.record_failure(batch.effective_size, now)
        breaker = self._breakers.get(name)
        if breaker is not None and breaker.record_failure(now):
            if self.tracer is not None:
                self.tracer.emit(now, "breaker_open", name,
                                 batch=batch.trace_id)
            if self.recorder is not None:
                self.recorder.note(now, "breaker_open", endpoint=name)
                self.recorder.dump("breaker_open", now=now,
                                   extra={"endpoint": name})
            self._brownout_shed(name, now)

    def _backoff(self, failures: int) -> float:
        """Capped exponential backoff before retry #``failures``, with
        seeded uniform jitter (one stream draw per scheduled retry)."""
        cfg = self.config
        backoff = min(cfg.retry_backoff_cap,
                      cfg.retry_backoff * (2.0 ** (failures - 1)))
        if cfg.retry_jitter > 0:
            backoff *= 1.0 + cfg.retry_jitter * float(self._retry_rng.random())
        return backoff

    async def _breaker_gate(self, name: str,
                            deadline: Optional[float],
                            trace_id: int = -1) -> bool:
        """Park until ``name``'s breaker admits a dispatch attempt.

        While open, sleeps to the probe instant; while half-open with the
        single probe slot taken, polls at ``probe_interval`` until the
        probe's outcome settles the state. Returns False when the next
        admissible attempt instant already lies past ``deadline`` — the
        batch cannot possibly complete in time, so the caller resolves it
        ``timed_out`` instead of waiting. The waits are plain clock sleeps
        inside the batch task, so ``drain(timeout=)`` cancels them like
        any other parked sleeper. The loop is bounded by the breaker's
        own dynamics (each pass sleeps a full open interval or a probe
        beat) and by the deadline cutoff.
        """
        breaker = self._breakers.get(name)
        if breaker is None:
            return True
        while True:
            now = self.clock.now()
            until = breaker.blocked_until(now)
            if until is not None:
                # open: sleep out the remaining interval
                if deadline is not None and until >= deadline:
                    return False
                if self.tracer is not None:
                    self.tracer.emit(now, "breaker_wait", name,
                                     batch=trace_id, value=until - now,
                                     detail="open")
                await self.clock.sleep(until - now)
                continue
            if breaker.try_probe(now):
                return True
            # half-open, probe slot taken: wait a beat for its verdict
            beat = breaker.config.probe_interval
            if deadline is not None and now + beat >= deadline:
                return False
            if self.tracer is not None:
                self.tracer.emit(now, "breaker_wait", name,
                                 batch=trace_id, value=beat,
                                 detail="half_open")
            await self.clock.sleep(beat)

    async def _run_batch(self, name: str, batch: Batch, t0: float) -> None:
        cfg = self.config
        breaker = self._breakers.get(name)
        deadline = batch.tightest_deadline
        error: Optional[BaseException] = None
        timed_out = False
        attempts = 0
        failures = 0
        retries_issued = 0
        try:
            while True:  # bounded by max_retries and the batch deadline
                if not await self._breaker_gate(name, deadline,
                                                batch.trace_id):
                    # every admissible probe instant is past the deadline:
                    # the SLA is already lost, stop burning the upstream
                    timed_out = True
                    break
                try:
                    attempts += await self._execute_hedged(
                        name, batch, deadline)
                    error = None
                    if breaker is not None:
                        breaker.record_success(self.clock.now())
                    break
                except asyncio.CancelledError:
                    raise
                except Exception as exc:  # noqa: BLE001 — retried/resolved
                    attempts += 1
                    failures += 1
                    error = exc
                    now = self.clock.now()
                    if self.tracer is not None:
                        self.tracer.emit(now, "fault", name,
                                         batch=batch.trace_id,
                                         size=batch.size,
                                         detail=type(exc).__name__)
                    self._record_failure(name, batch, now)
                    if failures > cfg.max_retries:
                        self.retry_exhausted += 1
                        break
                    backoff = self._backoff(failures)
                    if deadline is not None and now + backoff >= deadline:
                        # leftover budget cannot fit another attempt:
                        # deadline semantics win over retry semantics
                        timed_out = True
                        break
                    retries_issued += 1
                    self.retry_log.append(
                        (now, name, batch.size, failures, backoff,
                         type(exc).__name__)
                    )
                    if self.tracer is not None:
                        self.tracer.emit(now, "retry", name,
                                         batch=batch.trace_id,
                                         size=batch.size, value=backoff,
                                         detail=type(exc).__name__)
                    if self.recorder is not None:
                        self.recorder.note(now, "retry", endpoint=name,
                                           batch=batch.trace_id,
                                           failures=failures,
                                           backoff=backoff,
                                           error=type(exc).__name__)
                    await self.clock.sleep(backoff)
        except asyncio.CancelledError:
            # drain(timeout=) gave up on this batch — possibly mid-attempt,
            # parked on a retry backoff, or waiting out an open breaker:
            # account its requests as failed rather than hanging the
            # process (the task itself completes normally so drain's
            # gather() can collect it).
            error = DrainTimeout(
                f"batch of {batch.size} on {name!r} cancelled at drain "
                "timeout"
            )
            timed_out = False
            self.drain_cancelled += batch.size
        now = self.clock.now()
        self.inflight_batches -= 1
        self.events_processed += 1
        if failures:
            self.faulted_batches += 1
        if retries_issued:
            self.retried_batches += 1
        # The success path releases the router's in-flight slot through
        # frontend.on_response -> router.on_batch_done; the terminal
        # failure paths below never reach it, so release here or the
        # tier's inflight count leaks and the cap wedges shut.
        _router = self.frontend.endpoint(name).router
        if (_router is not None and batch.tier is not None
                and (timed_out or error is not None)):
            _router.release(batch.tier)
        if timed_out:
            # the batch was never completed by the upstream; its requests
            # exhaust their deadline exactly like a queue expiry would
            for r in batch.requests:
                ticket = self._tickets.pop(r.req_id, None)
                if ticket is not None and not ticket.future.done():
                    ticket.timed_out = True
                    ticket.error = DeadlineExceeded(
                        f"request {r.req_id} ran out of deadline budget at "
                        f"t={now:.6f} after {failures} failed dispatch "
                        f"attempt(s) on {name!r}"
                    )
                    ticket.future.set_result(ticket)
            self.timed_out += batch.size
            if self.tracer is not None:
                self.tracer.emit(now, "timed_out", name,
                                 batch=batch.trace_id, size=batch.size)
            self._wake.set()
            return
        if error is None:
            batch.attempts = max(1, attempts)
            if failures:
                self.recovered_batches += 1
            latency = now - t0
            self.frontend.on_response(batch, latency, now)
            self.bucket_samples[name].setdefault(
                batch.effective_size, []
            ).append(latency)
            log = self.completions[name]
            for r in batch.requests:
                log.append(now, now - r.arrival_time, r.arrival_time)
                ticket = self._tickets.pop(r.req_id, None)
                if ticket is not None and not ticket.future.done():
                    ticket.future.set_result(ticket)
                else:
                    # a completion with no live ticket means the request
                    # was resolved twice — the invariant chaos must not
                    # be able to break
                    self.duplicate_completions += 1
            self.completed += batch.size
            self._last_completion = now
            if self.tracer is not None:
                self.tracer.emit(now, "completed", name,
                                 batch=batch.trace_id, size=batch.size,
                                 value=latency)
        else:
            if not isinstance(error, DrainTimeout):
                # exhausted retry budget: classify as a target failure so
                # the drained assert can tell it from lost accounting
                wrapped = TargetError(
                    f"batch of {batch.size} on {name!r} failed after "
                    f"{max(1, attempts)} attempt(s): {error!r}",
                    attempts=max(1, attempts),
                )
                wrapped.__cause__ = error
                error = wrapped
                self.target_failures += batch.size
            for r in batch.requests:
                ticket = self._tickets.pop(r.req_id, None)
                if ticket is not None and not ticket.future.done():
                    ticket.error = error
                    ticket.future.set_exception(error)
            self.failed += batch.size
            if self.tracer is not None:
                self.tracer.emit(now, "failed", name,
                                 batch=batch.trace_id, size=batch.size,
                                 detail=type(error).__name__)
        self._wake.set()

    # ---------------------------------------------------------------- timer
    async def _timer_loop(self) -> None:
        cfg = self.config
        while self._running:
            now = self.clock.now()
            self.events_processed += 1
            self.frontend.on_timer(now)
            nxt = self.frontend.next_event_time(now)
            if nxt is None:
                timeout: Optional[float] = cfg.timer_idle
            else:
                timeout = max(nxt - now, cfg.min_timer_tick)
            await self.clock.wait(self._wake, timeout)
            self._wake.clear()

    # ---------------------------------------------------------- conservation
    def conservation(self) -> dict:
        queue_len = sum(
            ep["queue_len"]
            for ep in self.frontend.stats(self.clock.now())["endpoints"].values()
        )
        outstanding = len(self._tickets)
        lost = (self.submitted - self.completed - self.rejected - self.shed
                - self.timed_out - self.failed - outstanding)
        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "rejected": self.rejected,
            "shed": self.shed,
            "timed_out": self.timed_out,
            "failed": self.failed,
            "drain_cancelled": self.drain_cancelled,
            "target_failures": self.target_failures,
            "outstanding": outstanding,
            "queued": queue_len,
            "inflight_batches": self.inflight_batches,
            "hedged_batches": self.hedged_batches,
            "retried_batches": self.retried_batches,
            "retry_exhausted": self.retry_exhausted,
            "faulted_batches": self.faulted_batches,
            "recovered_batches": self.recovered_batches,
            "duplicate_completions": self.duplicate_completions,
            "lost": lost,
        }

    def assert_conserved(self, require_drained: bool = False) -> dict:
        """Raise ``AssertionError`` on any broken runtime invariant.

        Mirrors ``ServerlessPlatform.assert_conserved``: nothing lost and
        nothing completed twice at any instant; with ``require_drained``,
        nothing outstanding either (``submitted == completed + rejected +
        shed + timed_out + failed`` — every terminal state explicitly
        accounted, zero lost) and every failure is *classified*: either
        ``drain(timeout=)`` cancelled it or an exhausted retry budget
        resolved it as a :class:`TargetError`. An unclassified failure at
        drain still trips the assert — lost accounting cannot slip
        through shutdown.
        """
        c = self.conservation()

        def trip(reason: str) -> AssertionError:
            # the flight recorder dumps its ring BEFORE the raise so the
            # postmortem survives even if the caller swallows the error
            if self.recorder is not None:
                self.recorder.dump(f"conservation-{reason}",
                                   now=self.clock.now(), extra=c)
            return AssertionError(f"{reason}: {c}")

        if c["lost"] != 0:
            raise trip("runtime lost requests")
        if c["duplicate_completions"] != 0:
            raise trip("duplicate completions")
        if require_drained:
            if c["outstanding"] or c["queued"] or c["inflight_batches"]:
                raise trip("undrained work at shutdown")
            if c["failed"] != c["drain_cancelled"] + c["target_failures"]:
                raise trip("unclassified failed dispatches at shutdown")
            if c["submitted"] != (c["completed"] + c["rejected"] + c["shed"]
                                  + c["timed_out"] + c["failed"]):
                raise trip("conservation imbalance")
        return c

    # --------------------------------------------------------------- metrics
    def summary(self) -> dict:
        """Fleet summary with the same headline keys as ``SimResult``."""
        now = self.clock.now()
        fstats = self.frontend.stats(now)
        per: Dict[str, dict] = {}
        all_e2e: List[np.ndarray] = []
        total_viol = 0.0
        for name in self.frontend.names:
            ep = self.frontend.endpoint(name)
            e2e = self.completions[name].e2e.view()
            all_e2e.append(e2e)
            viol = (float(np.mean(e2e > ep.sla.slo_target))
                    if len(e2e) else 0.0)
            total_viol += viol * len(e2e)
            st = fstats["endpoints"][name]
            per[name] = {
                "completed": float(len(e2e)),
                "slo_target": ep.sla.slo_target,
                "violation_rate": viol,
                "violation_pct": 100.0 * viol,
                "p50": float(np.percentile(e2e, 50)) if len(e2e) else math.nan,
                "p95": float(np.percentile(e2e, 95)) if len(e2e) else math.nan,
                "mean_latency": float(e2e.mean()) if len(e2e) else math.nan,
                "avg_batch_size": st.get("avg_batch_size", 0.0),
                "dispatched_batches": float(st.get("dispatched_batches", 0)),
                "max_bs": float(st.get("max_bs", 1)),
                "upstream_batches": float(st.get("upstream_batches", 0)),
                "retried_batches": float(st.get("retried_batches", 0)),
                "retry_rate": float(st.get("retry_rate", 0.0)),
                "failure_rate": float(st.get("failure_rate", 0.0)),
                "timed_out": float(st.get("expired", 0)),
                "shed": float(st.get("shed", 0)),
                "padding_waste": float(st.get("padding_waste", 0.0)),
                "submitted_requests": float(
                    self._submitted_by_ep.get(name, 0)),
                "queue_depth_hwm": float(st.get("queue_depth_hwm", 0)),
                "burn_rate_fast": float(st.get("burn_rate_fast", 0.0)),
                "burn_rate_slow": float(st.get("burn_rate_slow", 0.0)),
                "hedged_batches": float(self._hedged_by_ep.get(name, 0)),
                "hedge_wins": float(self._hedge_wins_by_ep.get(name, 0)),
            }
            breaker = self._breakers.get(name)
            if breaker is not None:
                per[name]["breaker"] = breaker.stats(now)
            # Tiered endpoints only: extra keys would break the strict
            # dict-equality checks untiered parity tests rely on.
            if ep.router is not None:
                per[name]["router"] = ep.router.stats()
            target = self._targets.get(name)
            tier_stats = getattr(target, "stats", None)
            if tier_stats is not None and hasattr(target, "cost_integral"):
                per[name]["tiers"] = tier_stats()
                per[name]["cost_integral"] = float(target.cost_integral)
        e2e = np.concatenate(all_e2e) if all_e2e else np.empty(0)
        n = len(e2e)
        cons = self.conservation()
        # Throughput over the active window (first submit → last
        # completion), not the raw clock: a clock predating the server or
        # a summary taken after an idle gap must not deflate it.
        if (self._first_submit is not None
                and self._last_completion is not None
                and self._last_completion > self._first_submit):
            throughput = n / (self._last_completion - self._first_submit)
        else:
            throughput = 0.0
        summary = {
            "completed": float(n),
            "violation_rate": total_viol / n if n else 0.0,
            "violation_pct": 100.0 * total_viol / n if n else 0.0,
            "p50": float(np.percentile(e2e, 50)) if n else math.nan,
            "p95": float(np.percentile(e2e, 95)) if n else math.nan,
            "p99": float(np.percentile(e2e, 99)) if n else math.nan,
            "mean_latency": float(e2e.mean()) if n else math.nan,
            "avg_batch_size": fstats["aggregate"]["avg_batch_size"],
            "dispatched_batches": float(
                fstats["aggregate"]["dispatched_batches"]
            ),
            "submitted": float(cons["submitted"]),
            "rejected": float(cons["rejected"]),
            "shed": float(cons["shed"]),
            "timed_out": float(cons["timed_out"]),
            "failed": float(cons["failed"]),
            "hedged_batches": float(self.hedged_batches),
            "hedge_wins": float(self.hedge_wins),
            "retried_batches": float(self.retried_batches),
            "retry_exhausted": float(self.retry_exhausted),
            "faulted_batches": float(self.faulted_batches),
            "recovered_batches": float(self.recovered_batches),
            "duplicate_completions": float(self.duplicate_completions),
            "padding_waste": fstats["aggregate"]["padding_waste"],
            "lost": float(cons["lost"]),
            "throughput": throughput,
            "events_processed": float(self.events_processed),
            "queue_depth_hwm": float(
                fstats["aggregate"]["queue_depth_hwm"]),
            "burn_rate_fast": fstats["aggregate"]["burn_rate_fast"],
            "burn_rate_slow": fstats["aggregate"]["burn_rate_slow"],
            "endpoints": per,
        }
        return summary
