"""End-to-end discrete-event simulation: arrivals → policy → platform.

Reproduces the paper's experimental pipeline (§3): a Poisson client
(optionally trace-modulated) sends requests to the front-end policy
(MLProxy or a baseline); the policy dispatches batches to the simulated
Knative platform; completions flow back through the policy's monitor.

Outputs match the paper's reporting: average container count (cost),
SLO-violation percentage, average batch size (Table 3), the CCDF of
response times (Fig. 6) and time series of P95 / containers / miss rate /
Max_BS (Fig. 7).

Two drivers share the event machinery:

* :class:`Simulator` — the paper's single-endpoint pipeline (one policy,
  one platform).
* :class:`MultiEndpointSimulator` — beyond paper: drives a
  :class:`~repro.core.frontend.ProxyFrontend` with per-endpoint arrival
  processes, per-endpoint SLAs/policies, and per-endpoint *or shared*
  :class:`~repro.serverless.platform.ServerlessPlatform` fleets (shared
  fleets use :class:`~repro.serverless.latency.EndpointRoutedLatency` to
  give each endpoint its own service-time model).

Event-core design notes (the scale hot path):

* Arrivals are presampled in numpy blocks through
  :class:`_ArrivalPump` (one cursor per arrival process) instead of one
  scalar RNG draw + closure per request.
* The simulator RNG is split into three named spawned streams —
  *arrivals*, *service*, *faults* — so block-sampling arrivals can never
  reorder service-time or fault draws (one-time break in seed
  compatibility with earlier revisions; per-seed determinism is
  unaffected).
* Policy timers are generation-stamped: superseded heap entries are
  dropped on pop instead of spuriously invoking ``policy.on_timer``.
* Completion metrics accumulate into growable float buffers
  (:mod:`repro.simulation.stats`); the sampler's windowed P95 is a binary
  search + vectorized percentile, not a rebuilt Python list.
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import ProxyFrontend, ProxyConfig, SLAConfig
from repro_torch.core.policies import make_policy
from repro_torch.core.request import Batch, Request
from repro_torch.serverless.latency import EndpointRoutedLatency, LatencyModel
from repro_torch.serverless.platform import PlatformConfig, ServerlessPlatform
from repro_torch.serverless.tiers import TieredPlatform, TierSpec, make_router
from repro_torch.simulation.arrivals import ArrivalProcess
from repro_torch.simulation.events import EventQueue
from repro_torch.simulation.stats import CompletionLog


@dataclasses.dataclass(slots=True)
class SimResult:
    summary: Dict[str, float]
    e2e_latencies: np.ndarray  # seconds, one per completed request
    arrival_times: np.ndarray
    timeline: Dict[str, np.ndarray]  # sampled time series
    policy_stats: Dict[str, float]

    def ccdf(self):
        """Return (latency_sorted, ccdf) for Fig.6-style plots."""
        lat = np.sort(self.e2e_latencies)
        n = len(lat)
        if n == 0:
            return lat, lat
        ccdf = 1.0 - (np.arange(1, n + 1) / n)
        return lat, ccdf


class _ArrivalPump:
    """Cursor over :meth:`ArrivalProcess.next_arrivals` windows.

    Sweeps contiguous ``(clock, clock + horizon]`` windows, buffering each
    block as plain Python floats; :meth:`next` hands out one arrival at a
    time to the event loop. The horizon adapts so blocks stay in a
    cache-friendly size band regardless of arrival rate.
    """

    __slots__ = ("proc", "rng", "end", "clock", "horizon", "buf", "idx")

    _MIN_H, _MAX_H = 0.25, 512.0
    _TARGET_LO, _TARGET_HI = 4096, 131072

    def __init__(self, proc: ArrivalProcess, rng: np.random.Generator,
                 duration: float, horizon: float = 8.0) -> None:
        proc.reset()
        self.proc = proc
        self.rng = rng
        self.end = duration
        self.clock = 0.0
        self.horizon = horizon
        self.buf: List[float] = []
        self.idx = 0

    def next(self) -> Optional[float]:
        idx = self.idx
        buf = self.buf
        while idx >= len(buf):
            if self.clock >= self.end:
                return None
            h = min(self.horizon, self.end - self.clock)
            block = self.proc.next_arrivals(self.clock, self.rng, h)
            self.clock += h
            n = len(block)
            if n >= self._TARGET_HI:
                self.horizon = max(self._MIN_H, self.horizon * 0.5)
            elif n < self._TARGET_LO:
                self.horizon = min(self._MAX_H, self.horizon * 2.0)
            buf = block.tolist()
            self.buf = buf
            idx = 0
        self.idx = idx + 1
        return buf[idx]


class _ProxyHedger:
    """Proxy-tier straggler hedging for the simulators.

    Mirror of the live runtime's hedged dispatch: when a dispatched batch
    is still unfinished after the configured quantile of its bucket's
    measured upstream latency, a shadow copy is re-submitted to the
    platform; the first completion wins (stamping ``attempts`` with the
    extra attempt) and the loser's completion is swallowed. The sim
    cannot *cancel* platform-side work the way the runtime cancels its
    loser task — on a transparent platform (the parity configuration)
    that is observationally identical; on a capacity-bound fleet the
    loser briefly occupies a slot until it finishes.

    All mappings key on ``id()`` of batches that the state dict itself
    keeps alive, so keys cannot be recycled while tracked.
    """

    __slots__ = ("quantile", "min_samples", "events", "submit_fn",
                 "monitor_fn", "_state", "_shadow_owner", "hedged", "wins",
                 "hedged_by_ep", "wins_by_ep")

    def __init__(self, quantile: float, min_samples: int, events: EventQueue,
                 submit_fn, monitor_fn) -> None:
        if quantile < 1 or quantile > 100:
            # percentile units, same contract as RuntimeConfig: a
            # fraction like 0.95 would hedge at the bucket minimum
            raise ValueError(
                f"hedge_quantile is in percentile units ((1, 100], e.g. "
                f"95.0), got {quantile}"
            )
        self.quantile = quantile
        self.min_samples = min_samples
        self.events = events
        self.submit_fn = submit_fn      # (batch, now) -> platform submit
        self.monitor_fn = monitor_fn    # (batch) -> SmartMonitor
        # id(primary) → [primary, shadow|None, first_completion_seen]
        self._state: Dict[int, list] = {}
        self._shadow_owner: Dict[int, Batch] = {}
        self.hedged = 0
        self.wins = 0
        # per-endpoint splits of the two counters above (key "" for the
        # single-endpoint simulator, whose batches carry no endpoint)
        self.hedged_by_ep: Dict[str, int] = {}
        self.wins_by_ep: Dict[str, int] = {}

    def on_dispatch(self, batch: Batch, now: float) -> None:
        """Arm the straggler timer for a freshly dispatched batch."""
        monitor = self.monitor_fn(batch)
        threshold = monitor.bucket_quantile(
            batch.effective_size, self.quantile, now, self.min_samples
        )
        if threshold is None:
            return  # bucket still cold: hedging stays off (same as live)
        self._state[id(batch)] = [batch, None, False]
        self.events.push(now + threshold, partial(self._maybe_hedge, batch))

    def _maybe_hedge(self, batch: Batch, now: float) -> None:
        st = self._state.get(id(batch))
        if st is None or st[2] or st[1] is not None:
            return  # already completed (or already hedged)
        shadow = Batch(requests=batch.requests,
                       dispatch_time=batch.dispatch_time, cause=batch.cause,
                       bucket_size=batch.bucket_size, endpoint=batch.endpoint,
                       tier=batch.tier)
        st[1] = shadow
        self._shadow_owner[id(shadow)] = batch
        self.hedged += 1
        ep = batch.endpoint or ""
        self.hedged_by_ep[ep] = self.hedged_by_ep.get(ep, 0) + 1
        self.submit_fn(shadow, now)

    def resolve(self, batch: Batch, latency: float, now: float):
        """Map a platform completion onto its primary batch.

        Returns ``(primary, latency)`` for a winning completion or
        ``None`` for a hedge loser whose completion must be ignored.
        """
        owner = self._shadow_owner.get(id(batch))
        primary = owner if owner is not None else batch
        st = self._state.get(id(primary))
        if st is None:
            return primary, latency  # untracked: hedging never armed
        if st[2]:
            # loser: the sibling already completed this work
            shadow = st[1]
            if shadow is not None:
                self._shadow_owner.pop(id(shadow), None)
            del self._state[id(primary)]
            return None
        st[2] = True
        if st[1] is None:
            del self._state[id(primary)]  # finished before the timer fired
            return primary, latency
        # hedged and first across the line: stamp the extra attempt and
        # measure latency from the PRIMARY dispatch (what the proxy saw),
        # exactly as the live runtime's `now - t0` does.
        if owner is not None:
            self.wins += 1
            ep = primary.endpoint or ""
            self.wins_by_ep[ep] = self.wins_by_ep.get(ep, 0) + 1
        primary.attempts = batch.attempts + 1
        return primary, now - primary.dispatch_time


class _EventLoopDriver:
    """Timer wiring + run/flush/drain loop shared by both simulators.

    Subclasses provide ``events``/``now``/``duration``/``drain_grace`` and
    :meth:`_control` returning the Policy-like front object
    (``next_event_time``/``on_timer``/``flush``).

    Policy timers are generation-stamped: every (re)schedule bumps
    ``_timer_gen`` and the stamped value rides the heap entry, so an entry
    superseded by an earlier reschedule is dropped on pop instead of
    calling ``policy.on_timer`` at a stale deadline.
    """

    events: EventQueue
    now: float
    duration: float
    drain_grace: float
    _timer_scheduled_at: Optional[float]
    _timer_gen: int
    events_processed: int

    def _control(self):
        raise NotImplementedError

    def _on_policy_timer(self, gen: int, now: float) -> None:
        if gen != self._timer_gen:
            return  # superseded heap entry: a later reschedule owns the timer
        self._timer_scheduled_at = None
        self._control().on_timer(now)
        self._reschedule_policy_timer(min_time=now + 1e-6)

    def _reschedule_policy_timer(self, min_time: float = 0.0) -> None:
        t = self._control().next_event_time(self.now)
        if t is None:
            return
        # min_time guards against zero-progress loops when a policy keeps
        # requesting the instant a timer just served
        t = max(t, self.now, min_time)
        if self._timer_scheduled_at is None or t < self._timer_scheduled_at - 1e-12:
            self._timer_scheduled_at = t
            self._timer_gen += 1
            self.events.push(t, partial(self._on_policy_timer, self._timer_gen))

    def _drive(self) -> float:
        """Run events through duration + drain grace, flushing queued
        batches at end-of-run; returns the hard-stop time."""
        hard_stop = self.duration + self.drain_grace
        flushed = False
        events = self.events
        n_events = 0
        while events:
            t, fn = events.pop()
            if t > hard_stop:
                break
            self.now = t
            if not flushed and t >= self.duration:
                self._control().flush(self.now)
                flushed = True
            fn(t)
            n_events += 1
        if not flushed:
            self._control().flush(self.now)
        # drain remaining completions
        while events:
            t, fn = events.pop()
            if t > hard_stop:
                break
            self.now = t
            fn(t)
            n_events += 1
        self.events_processed += n_events
        return hard_stop


def _spawn_streams(seed: int):
    """(arrivals, service, faults) generators from one root seed.

    Named spawned streams keep the three draw categories independent:
    block-sampling arrivals consumes only the arrivals stream, so service
    times and fault outcomes for a given seed do not shift when the
    arrival path (or its chunking) changes.
    """
    arr_ss, svc_ss, fault_ss = np.random.SeedSequence(seed).spawn(3)
    return (
        np.random.default_rng(arr_ss),
        np.random.default_rng(svc_ss),
        np.random.default_rng(fault_ss),
    )


class Simulator(_EventLoopDriver):
    def __init__(
        self,
        *,
        policy: str,
        sla: SLAConfig,
        workload: LatencyModel,
        arrivals: ArrivalProcess,
        platform_config: Optional[PlatformConfig] = None,
        policy_kwargs: Optional[dict] = None,
        duration: float = 600.0,
        warmup: float = 0.0,
        drain_grace: float = 120.0,
        sample_interval: float = 5.0,
        p95_window: float = 60.0,
        seed: int = 0,
        hedge_quantile: float = 0.0,
        hedge_min_samples: int = 10,
        tracer=None,
        recorder=None,
    ) -> None:
        self.sla = sla
        self.workload = workload
        self.arrivals = arrivals
        self.duration = duration
        self.warmup = warmup
        self.drain_grace = drain_grace
        self.sample_interval = sample_interval
        self.p95_window = p95_window
        self.rng_arrivals, self.rng, self.rng_faults = _spawn_streams(seed)
        self.events = EventQueue()
        self.now = 0.0
        self.events_processed = 0
        # optional observability plane (same seam as the live runtime:
        # None — the default — keeps the hot path byte-identical)
        self.tracer = tracer
        self.recorder = recorder

        self.platform = ServerlessPlatform(
            config=platform_config or PlatformConfig(),
            latency_model=workload,
            events=self.events,
            rng=self.rng,
            fault_rng=self.rng_faults,
            on_batch_done=self._on_batch_done,
            tracer=tracer,
            recorder=recorder,
        )
        self.policy = make_policy(
            policy, sla, self._dispatch, tracer=tracer,
            **(policy_kwargs or {})
        )
        # per-request absolute deadlines (None disables — the default)
        self._deadline_budget = sla.deadline_budget
        self.arrived_requests = 0
        # proxy-tier straggler hedging (sim mirror of the live runtime's)
        self._hedger: Optional[_ProxyHedger] = None
        if hedge_quantile > 0:
            self._hedger = _ProxyHedger(
                hedge_quantile, hedge_min_samples, self.events,
                submit_fn=lambda b, t: self.platform.submit(b, t),
                monitor_fn=lambda b: self.policy.monitor,
            )

        self.completions = CompletionLog()
        self._pump = _ArrivalPump(arrivals, self.rng_arrivals, duration)
        self._on_arrival_cb = self._on_arrival  # bound once, reused per event
        self._timer_scheduled_at: Optional[float] = None
        self._timer_gen = 0
        self._samples: List[dict] = []

    # --------------------------------------------------------------- wiring
    def _dispatch(self, batch: Batch) -> None:
        self.platform.submit(batch, self.now)
        if self._hedger is not None:
            self._hedger.on_dispatch(batch, self.now)

    def _on_batch_done(self, batch: Batch, upstream_latency: float, now: float) -> None:
        if self._hedger is not None:
            resolved = self._hedger.resolve(batch, upstream_latency, now)
            if resolved is None:
                return  # hedge loser: the sibling already completed this
            batch, upstream_latency = resolved
        self.policy.on_response(batch, upstream_latency, now)
        log = self.completions
        for r in batch.requests:
            log.append(now, now - r.arrival_time, r.arrival_time)
        self._reschedule_policy_timer()

    def _on_arrival(self, now: float) -> None:
        self.arrived_requests += 1
        req = Request(arrival_time=now)
        if self._deadline_budget is not None:
            req.deadline = now + self._deadline_budget
        if self.tracer is not None:
            # no frontend in the single-endpoint pipeline, so the driver
            # stamps admission itself (the multi-endpoint path gets this
            # from ProxyFrontend.on_request)
            self.tracer.emit(now, "admitted", "", req_id=req.req_id)
        self.policy.on_request(req, now)
        nxt = self._pump.next()
        if nxt is not None:
            self.events.push(nxt, self._on_arrival_cb)
        self._reschedule_policy_timer()

    def _control(self):
        return self.policy

    # --------------------------------------------------------------- metrics
    def _on_sample(self, now: float) -> None:
        lats = self.completions.window(now - self.p95_window)
        n = len(lats)
        if n:
            p95 = float(np.percentile(lats, 95))
            miss = float(np.count_nonzero(lats > self.sla.slo_target)) / n
        else:
            p95 = math.nan
            miss = math.nan
        self._samples.append(
            {
                "t": now,
                "p95": p95,
                "miss_rate": miss,
                "containers": self.platform.billable_count,
                "ready": self.platform.ready_count(now),
                "queued_batches": self.platform.queued_batches,
                "max_bs": float(self.policy.max_bs),
                "proxy_queue": self.policy.stats(now).get("queue_len", 0),
            }
        )
        if now < self.duration + self.drain_grace:
            self.events.push(now + self.sample_interval, self._on_sample)

    # ------------------------------------------------------------------ run
    def run(self) -> SimResult:
        first = self._pump.next()
        if first is not None:
            self.events.push(first, self._on_arrival_cb)
        self.events.push(0.0, self._on_sample)
        self.platform.start(0.0)
        if self.warmup > 0:
            self.events.push(self.warmup, self.platform.reset_billing)

        hard_stop = self._drive()
        self.platform.finalize(min(self.now, hard_stop))
        return self._result()

    def _result(self) -> SimResult:
        all_e2e = self.completions.e2e.view()
        all_arr = self.completions.arrival.view()
        keep = all_arr >= self.warmup
        e2e = all_e2e[keep]
        arr = all_arr[keep]
        viol = float(np.mean(e2e > self.sla.slo_target)) if len(e2e) else 0.0
        pstats = self.policy.stats(self.now)
        billing_window = max(self.now, self.duration) - self.warmup
        summary = {
            "completed": float(len(e2e)),
            "violation_rate": viol,
            "violation_pct": 100.0 * viol,
            "avg_containers": self.platform.avg_containers(billing_window),
            # cost is a billable-seconds integral (avg_containers × window),
            # surfaced directly so cost reports need no re-derivation
            "cost_integral": float(self.platform.cost_integral),
            "peak_containers": float(self.platform.peak_containers),
            "avg_batch_size": pstats.get("avg_batch_size", 0.0),
            "p50": float(np.percentile(e2e, 50)) if len(e2e) else math.nan,
            "p95": float(np.percentile(e2e, 95)) if len(e2e) else math.nan,
            "p99": float(np.percentile(e2e, 99)) if len(e2e) else math.nan,
            "mean_latency": float(e2e.mean()) if len(e2e) else math.nan,
            "cold_starts": float(self.platform.cold_starts),
            "failed_attempts": float(self.platform.failed_attempts),
            "hedged_dispatches": float(self.platform.hedged_dispatches),
            "throughput": float(len(e2e)) / max(self.now, 1e-9),
            # deadline / proxy-hedge accounting (identical semantics to
            # the live runtime's summary keys)
            "submitted_requests": float(self.arrived_requests),
            "timed_out": float(pstats.get("expired", 0)),
            "hedged_batches": float(self._hedger.hedged
                                    if self._hedger else 0),
            "hedge_wins": float(self._hedger.wins if self._hedger else 0),
            # event-core work counter + queue high-water mark + SLO burn,
            # under the SAME key names as the live runtime's summary()
            "events_processed": float(self.events_processed),
            "queue_depth_hwm": float(pstats.get("queue_depth_hwm", 0)),
            "burn_rate_fast": float(pstats.get("burn_rate_fast", 0.0)),
            "burn_rate_slow": float(pstats.get("burn_rate_slow", 0.0)),
        }
        # conservation ledger: every submitted batch must be completed or
        # still accounted for (queued/in-flight); lost and duplicate must
        # stay 0 in every run, faults or not
        cons = self.platform.conservation()
        summary.update(
            {
                "submitted_batches": float(cons["submitted_batches"]),
                "completed_batches": float(cons["completed_batches"]),
                "outstanding_batches": float(cons["outstanding_batches"]),
                "lost_batches": float(cons["lost_batches"]),
                "duplicate_completions": float(cons["duplicate_completions"]),
                "requeued_batches": float(cons["requeued_batches"]),
                "cancelled_attempts": float(cons["cancelled_attempts"]),
                "preemptions": float(cons["preemptions"]),
            }
        )
        timeline = {
            k: np.asarray([s[k] for s in self._samples], dtype=np.float64)
            for k in (self._samples[0].keys() if self._samples else [])
        }
        return SimResult(
            summary=summary,
            e2e_latencies=e2e,
            arrival_times=arr,
            timeline=timeline,
            policy_stats={k: v for k, v in pstats.items() if isinstance(v, (int, float))},
        )


def run_simulation(**kwargs) -> SimResult:
    """Convenience wrapper: ``run_simulation(policy=..., sla=..., ...)``."""
    return Simulator(**kwargs).run()


# ---------------------------------------------------------------------------
# Multi-endpoint scenario layer (beyond paper)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(slots=True)
class EndpointSpec:
    """Everything one endpoint needs in a multi-endpoint scenario.

    ``platform`` names a shared-fleet group: endpoints with the same key
    run on one :class:`ServerlessPlatform` (multi-model serving); ``None``
    gives the endpoint a dedicated fleet. ``platform_config`` is taken from
    the first group member that sets one.

    ``tiers`` (a tuple of :class:`~repro.serverless.tiers.TierSpec`)
    upgrades the endpoint's fleet to a :class:`TieredPlatform` and gives
    the endpoint a :class:`~repro.core.frontend.SpilloverRouter` over
    those tiers; every member of a shared group must declare the same
    tier list. ``platform_config`` (or the group's) becomes the base
    config tiers inherit from.
    """

    policy: str
    sla: SLAConfig
    workload: LatencyModel
    arrivals: ArrivalProcess
    policy_kwargs: Optional[dict] = None
    platform: Optional[str] = None
    platform_config: Optional[PlatformConfig] = None
    tiers: Optional[tuple] = None  # Tuple[TierSpec, ...]


@dataclasses.dataclass(slots=True)
class MultiSimResult:
    summary: Dict[str, float]                    # fleet-level aggregate
    endpoints: Dict[str, Dict[str, float]]       # per-endpoint summaries
    e2e_latencies: Dict[str, np.ndarray]         # per-endpoint latencies
    frontend_stats: dict
    # per-tier breakdowns, populated only for tiered fleets so the
    # summary/endpoints surfaces above stay byte-comparable with
    # untirered runs: platform-group key → tier name → metrics, and
    # endpoint → SpilloverRouter.stats()
    tiers: Dict[str, dict] = dataclasses.field(default_factory=dict)
    routers: Dict[str, dict] = dataclasses.field(default_factory=dict)


class MultiEndpointSimulator(_EventLoopDriver):
    """Drives one :class:`ProxyFrontend` over N endpoints in one event loop.

    Each endpoint has its own arrival process, SLA, policy, and (dedicated
    or shared) platform; the frontend merges every policy's timer into one
    clock, exactly as a single proxy process would in production. Each
    endpoint's arrival pump runs on its own spawned child of the arrivals
    stream, so per-endpoint block sampling stays order-independent.
    """

    def __init__(
        self,
        endpoints: Dict[str, EndpointSpec],
        *,
        duration: float = 600.0,
        warmup: float = 0.0,
        drain_grace: float = 120.0,
        seed: int = 0,
        hedge_quantile: float = 0.0,
        hedge_min_samples: int = 10,
        tracer=None,
        recorder=None,
    ) -> None:
        if not endpoints:
            raise ValueError("need at least one endpoint")
        self.specs = dict(endpoints)
        self.duration = duration
        self.warmup = warmup
        self.drain_grace = drain_grace
        arr_ss, svc_ss, fault_ss = np.random.SeedSequence(seed).spawn(3)
        self.rng = np.random.default_rng(svc_ss)
        self.rng_faults = np.random.default_rng(fault_ss)
        self.events = EventQueue()
        self.now = 0.0
        self.events_processed = 0
        self.tracer = tracer
        self.recorder = recorder

        # platform groups: shared key → one fleet; None → dedicated fleet
        groups: Dict[str, List[str]] = {}
        for name, spec in self.specs.items():
            key = spec.platform if spec.platform is not None else f"dedicated:{name}"
            groups.setdefault(key, []).append(name)
        # values are ServerlessPlatform or TieredPlatform (same surface)
        self.platforms: Dict[str, ServerlessPlatform] = {}
        self._platform_of: Dict[str, str] = {}
        for key, members in groups.items():
            if len(members) == 1:
                latency: LatencyModel = self.specs[members[0]].workload
            else:
                latency = EndpointRoutedLatency(
                    {m: self.specs[m].workload for m in members}
                )
            pc = next(
                (self.specs[m].platform_config for m in members
                 if self.specs[m].platform_config is not None),
                None,
            )
            tier_lists = {m: tuple(self.specs[m].tiers)
                          for m in members if self.specs[m].tiers}
            if tier_lists and len(set(tier_lists.values())) > 1:
                raise ValueError(
                    f"platform group {key!r}: members disagree on tiers "
                    f"({sorted(tier_lists)})")
            if tier_lists:
                self.platforms[key] = TieredPlatform(
                    next(iter(tier_lists.values())),
                    latency_model=latency,
                    events=self.events,
                    rng=self.rng,
                    on_batch_done=self._on_batch_done,
                    base_config=pc or PlatformConfig(),
                    fault_rng=self.rng_faults,
                    tracer=tracer,
                    recorder=recorder,
                )
            else:
                self.platforms[key] = ServerlessPlatform(
                    config=pc or PlatformConfig(),
                    latency_model=latency,
                    events=self.events,
                    rng=self.rng,
                    fault_rng=self.rng_faults,
                    on_batch_done=self._on_batch_done,
                    tracer=tracer,
                    recorder=recorder,
                )
            for m in members:
                self._platform_of[m] = key

        # proxy-tier hedging shared across endpoints (shadow batches are
        # routed to their endpoint's platform by the stamped endpoint key)
        self._hedger: Optional[_ProxyHedger] = None
        if hedge_quantile > 0:
            self._hedger = _ProxyHedger(
                hedge_quantile, hedge_min_samples, self.events,
                submit_fn=lambda b, t: self.platforms[
                    self._platform_of[b.endpoint]].submit(b, t),
                monitor_fn=lambda b: self.frontend.endpoint(
                    b.endpoint).policy.monitor,
            )

        self.frontend = ProxyFrontend(tracer=tracer)
        for name, spec in self.specs.items():
            plat = self.platforms[self._platform_of[name]]
            router = None
            if spec.tiers:
                # one router per endpoint (per-endpoint in-flight signals)
                # probing the shared fleet's per-tier platform queues
                router = make_router(spec.tiers,
                                     queue_probe=plat.tier_queue_depth,
                                     tracer=tracer)
            self.frontend.add_endpoint(
                name,
                sla=spec.sla,
                dispatch_fn=partial(self._dispatch_batch, plat),
                policy=spec.policy,
                policy_kwargs=spec.policy_kwargs,
                router=router,
            )
        self.arrived_requests: Dict[str, int] = {n: 0 for n in self.specs}

        # one spawned arrivals stream + one pump + one reusable arrival
        # callback per endpoint (registration order is deterministic)
        arr_children = arr_ss.spawn(len(self.specs))
        self._pumps: Dict[str, _ArrivalPump] = {}
        self._arrival_cbs: Dict[str, partial] = {}
        for (name, spec), child in zip(self.specs.items(), arr_children):
            self._pumps[name] = _ArrivalPump(
                spec.arrivals, np.random.default_rng(child), duration
            )
            self._arrival_cbs[name] = partial(self._on_arrival, name)

        self.completions: Dict[str, CompletionLog] = {
            n: CompletionLog() for n in self.specs
        }
        self._timer_scheduled_at: Optional[float] = None
        self._timer_gen = 0

    # --------------------------------------------------------------- wiring
    def _control(self):
        return self.frontend

    def _dispatch_batch(self, plat: ServerlessPlatform, batch: Batch) -> None:
        plat.submit(batch, self.now)
        if self._hedger is not None:
            self._hedger.on_dispatch(batch, self.now)

    def _on_batch_done(self, batch: Batch, upstream_latency: float, now: float) -> None:
        if self._hedger is not None:
            resolved = self._hedger.resolve(batch, upstream_latency, now)
            if resolved is None:
                return  # hedge loser
            batch, upstream_latency = resolved
        self.frontend.on_response(batch, upstream_latency, now)
        log = self.completions[batch.endpoint]
        for r in batch.requests:
            log.append(now, now - r.arrival_time, r.arrival_time)
        self._reschedule_policy_timer()

    def _on_arrival(self, name: str, now: float) -> None:
        self.arrived_requests[name] += 1
        # frontend.on_request derives the deadline from the endpoint SLA
        self.frontend.on_request(Request(arrival_time=now, endpoint=name), now)
        nxt = self._pumps[name].next()
        if nxt is not None:
            self.events.push(nxt, self._arrival_cbs[name])
        self._reschedule_policy_timer()

    # ------------------------------------------------------------------ run
    def run(self) -> MultiSimResult:
        for name in self.specs:
            first = self._pumps[name].next()
            if first is not None:
                self.events.push(first, self._arrival_cbs[name])
        for plat in self.platforms.values():
            plat.start(0.0)
            if self.warmup > 0:
                self.events.push(self.warmup, plat.reset_billing)

        hard_stop = self._drive()
        for plat in self.platforms.values():
            plat.finalize(min(self.now, hard_stop))
        return self._result()

    def _result(self) -> MultiSimResult:
        billing_window = max(self.now, self.duration) - self.warmup
        fstats = self.frontend.stats(self.now)
        endpoints: Dict[str, Dict[str, float]] = {}
        latencies: Dict[str, np.ndarray] = {}
        for name, spec in self.specs.items():
            log = self.completions[name]
            keep = log.arrival.view() >= self.warmup
            e2e = log.e2e.view()[keep]
            latencies[name] = e2e
            viol = float(np.mean(e2e > spec.sla.slo_target)) if len(e2e) else 0.0
            ep_stats = fstats["endpoints"][name]
            hedger = self._hedger
            endpoints[name] = {
                "completed": float(len(e2e)),
                "slo_target": spec.sla.slo_target,
                "violation_rate": viol,
                "violation_pct": 100.0 * viol,
                "avg_batch_size": ep_stats.get("avg_batch_size", 0.0),
                "dispatched_batches": float(
                    ep_stats.get("dispatched_batches", 0)),
                "max_bs": float(ep_stats.get("max_bs", 1)),
                "p50": float(np.percentile(e2e, 50)) if len(e2e) else math.nan,
                "p95": float(np.percentile(e2e, 95)) if len(e2e) else math.nan,
                "mean_latency": float(e2e.mean()) if len(e2e) else math.nan,
                # per-endpoint retry accounting (platform-side crash
                # retries + hedges observed through Batch.attempts); PR 2
                # surfaced only the fleet aggregate
                "upstream_batches": float(ep_stats.get("upstream_batches", 0)),
                "retried_batches": float(ep_stats.get("retried_batches", 0)),
                "retry_rate": float(ep_stats.get("retry_rate", 0.0)),
                "failure_rate": float(ep_stats.get("failure_rate", 0.0)),
                # deadline accounting (mirrors the live runtime summary)
                "submitted_requests": float(self.arrived_requests[name]),
                "timed_out": float(ep_stats.get("expired", 0)),
                "shed": float(ep_stats.get("shed", 0)),
                "padding_waste": float(ep_stats.get("padding_waste", 0.0)),
                # observability surface: identical key names to the live
                # runtime's per-endpoint summary (sim↔live parity-tested)
                "queue_depth_hwm": float(ep_stats.get("queue_depth_hwm", 0)),
                "burn_rate_fast": float(ep_stats.get("burn_rate_fast", 0.0)),
                "burn_rate_slow": float(ep_stats.get("burn_rate_slow", 0.0)),
                "hedged_batches": float(
                    hedger.hedged_by_ep.get(name, 0) if hedger else 0),
                "hedge_wins": float(
                    hedger.wins_by_ep.get(name, 0) if hedger else 0),
            }
        total_containers = sum(
            p.avg_containers(billing_window) for p in self.platforms.values()
        )
        all_completed = sum(s["completed"] for s in endpoints.values())
        # fleet violation rate weighted by each endpoint's completed count
        agg_viol = (
            sum(s["violation_rate"] * s["completed"] for s in endpoints.values())
            / all_completed
            if all_completed
            else 0.0
        )
        # weighted cost: Σ platform cost_integral (TieredPlatform applies
        # per-tier cost weights; a plain platform's integral is weight-1.0,
        # so untirered and 1-tier runs produce the identical float)
        total_cost = sum(
            p.cost_integral for p in self.platforms.values())
        summary = {
            "completed": all_completed,
            "violation_rate": agg_viol,
            "violation_pct": 100.0 * agg_viol,
            "avg_containers": total_containers,
            "cost_integral": float(total_cost),
            "weighted_cost": float(total_cost / billing_window
                                   if billing_window > 0 else 0.0),
            "peak_containers": float(
                sum(p.peak_containers for p in self.platforms.values())
            ),
            "cold_starts": float(sum(p.cold_starts for p in self.platforms.values())),
            "n_platforms": float(len(self.platforms)),
            "n_endpoints": float(len(self.specs)),
            "submitted_requests": float(sum(self.arrived_requests.values())),
            "timed_out": float(sum(s["timed_out"] for s in endpoints.values())),
            "hedged_batches": float(self._hedger.hedged
                                    if self._hedger else 0),
            "hedge_wins": float(self._hedger.wins if self._hedger else 0),
            "events_processed": float(self.events_processed),
            "queue_depth_hwm": float(
                fstats["aggregate"]["queue_depth_hwm"]),
            "burn_rate_fast": fstats["aggregate"]["burn_rate_fast"],
            "burn_rate_slow": fstats["aggregate"]["burn_rate_slow"],
        }
        # fleet-wide conservation ledger (summed over every platform)
        cons = [p.conservation() for p in self.platforms.values()]
        for key in (
            "submitted_batches",
            "completed_batches",
            "outstanding_batches",
            "lost_batches",
            "duplicate_completions",
            "requeued_batches",
            "cancelled_attempts",
            "preemptions",
        ):
            summary[key] = float(sum(c[key] for c in cons))
        # per-tier breakdowns (tiered fleets only — kept OUT of summary/
        # endpoints so those stay byte-comparable with untirered runs)
        tiers_out: Dict[str, dict] = {}
        for key, p in self.platforms.items():
            if not isinstance(p, TieredPlatform):
                continue
            cost_bt = p.cost_by_tier()
            cons_bt = p.conservation_by_tier()
            tiers_out[key] = {
                tn: {
                    "avg_containers": child.avg_containers(billing_window),
                    "peak_containers": float(child.peak_containers),
                    "cold_starts": float(child.cold_starts),
                    "container_seconds": cost_bt[tn]["container_seconds"],
                    "cost_weight": cost_bt[tn]["cost_weight"],
                    "cost_integral": cost_bt[tn]["cost_integral"],
                    "submitted_batches": float(
                        cons_bt[tn]["submitted_batches"]),
                    "completed_batches": float(
                        cons_bt[tn]["completed_batches"]),
                    "requeued_batches": float(
                        cons_bt[tn]["requeued_batches"]),
                    "preemptions": float(cons_bt[tn]["preemptions"]),
                }
                for tn, child in p.platforms.items()
            }
        routers_out = {
            name: ep.router.stats()
            for name in self.specs
            if (ep := self.frontend.endpoint(name)).router is not None
        }
        return MultiSimResult(
            summary=summary,
            endpoints=endpoints,
            e2e_latencies=latencies,
            frontend_stats=fstats,
            tiers=tiers_out,
            routers=routers_out,
        )


def run_multi_simulation(endpoints: Dict[str, EndpointSpec], **kwargs) -> MultiSimResult:
    """Convenience wrapper: ``run_multi_simulation({"a": EndpointSpec(...)})``."""
    return MultiEndpointSimulator(endpoints, **kwargs).run()
