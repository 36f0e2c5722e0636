"""ProxyFrontend — the multi-endpoint routing layer.

The paper deploys one MLProxy per serverless endpoint; a production fleet
serves many models with many SLA classes through one proxy process. The
frontend owns N named endpoints — each with its own
:class:`~repro.core.batch_queue.Policy` (MLProxy or any baseline), its own
:class:`~repro.core.config.SLAConfig`, and its own dispatch target — and:

* routes arrivals by endpoint key (``request.endpoint`` or an explicit
  argument),
* stamps every outgoing :class:`~repro.core.request.Batch` with its
  endpoint name so shared dispatch targets can demultiplex,
* merges every endpoint's ``next_event_time`` into one timer so the caller
  (simulator or wall-clock serving loop) runs a single clock,
* exposes aggregated and per-endpoint ``stats``/``snapshot``/``restore``.

The frontend is clock-free like the policies beneath it: callers pass
``now`` into every method.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.batch_queue import DispatchFn, ExpireFn, Policy
from repro_torch.core.config import SLAConfig
from repro_torch.core.request import Batch, Request


@dataclasses.dataclass(frozen=True)
class TierRoute:
    """Router-facing view of one fleet tier.

    The router prefers tiers in ascending ``cost_weight`` order and
    escalates past a tier when any enabled guard trips (0 disables a
    guard): ``max_inflight`` caps batches dispatched-but-unresolved on
    the tier, ``queue_depth_max`` bounds the tier's backend queue as
    seen through the router's queue probe, and ``latency_threshold``
    bounds the tier's recent (EWMA) upstream latency.
    """

    name: str
    cost_weight: float = 1.0
    max_inflight: int = 0
    queue_depth_max: int = 0
    latency_threshold: float = 0.0


class SpilloverRouter:
    """Cost-aware tier selection at batch dispatch time.

    One router per endpoint. The frontend calls :meth:`route` as each
    batch leaves the policy queue (stamping ``batch.tier``) and
    :meth:`on_batch_done` / :meth:`release` as batches resolve, so the
    in-flight and latency signals are maintained entirely at the
    dispatch seam both worlds share — sim and live runs of the same
    schedule make identical decisions.

    Escalation is deterministic: tiers are probed cheapest-first and the
    first tier with no tripped guard wins; if every tier is guarded, the
    most expensive tier takes the batch (``exhausted``). A tier skipped
    for *latency* is deterministically re-probed every ``probe_every``-th
    consecutive skip, so a recovered tier gets fresh samples instead of
    staying escalated on a stale EWMA forever.

    ``queue_probe(tier_name) -> int`` is the pluggable backend-depth
    signal (platform queue in sim, target queue in live); None disables
    queue-depth escalation.
    """

    def __init__(
        self,
        tiers: Sequence[TierRoute],
        *,
        queue_probe: Optional[Callable[[str], int]] = None,
        latency_alpha: float = 0.2,
        probe_every: int = 16,
        tracer=None,
    ) -> None:
        if not tiers:
            raise ValueError("SpilloverRouter needs at least one tier")
        routes = [
            t if isinstance(t, TierRoute) else TierRoute(
                name=t.name, cost_weight=t.cost_weight,
                max_inflight=t.max_inflight,
                queue_depth_max=t.queue_depth_max,
                latency_threshold=t.latency_threshold)
            for t in tiers
        ]
        names = [r.name for r in routes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tier names: {names}")
        # stable sort: equal-cost tiers keep their given order
        self.order: Tuple[TierRoute, ...] = tuple(
            sorted(routes, key=lambda r: r.cost_weight))
        self._queue_probe = queue_probe
        self.latency_alpha = latency_alpha
        self.probe_every = probe_every
        self._tracer = tracer
        self._inflight: Dict[str, int] = {r.name: 0 for r in self.order}
        self._lat_ema: Dict[str, Optional[float]] = {
            r.name: None for r in self.order}
        self._skips: Dict[str, int] = {r.name: 0 for r in self.order}
        self.decisions = 0
        self.spillovers = 0  # batches routed past the cheapest tier
        self.routed: Dict[str, int] = {r.name: 0 for r in self.order}
        self.escalations: Dict[str, int] = {
            "inflight_cap": 0, "queue_depth": 0, "latency": 0}
        # (t, endpoint, size, tier, reason) — the byte-identity artifact
        # tests compare across same-seed runs
        self.decision_log: List[Tuple[float, str, int, str, str]] = []

    @property
    def tier_names(self) -> Tuple[str, ...]:
        return tuple(r.name for r in self.order)

    def _skip_reason(self, r: TierRoute) -> Optional[str]:
        if r.max_inflight > 0 and self._inflight[r.name] >= r.max_inflight:
            return "inflight_cap"
        if (r.queue_depth_max > 0 and self._queue_probe is not None
                and self._queue_probe(r.name) >= r.queue_depth_max):
            return "queue_depth"
        if r.latency_threshold > 0:
            ema = self._lat_ema[r.name]
            if ema is not None and ema > r.latency_threshold:
                return "latency"
        return None

    def route(self, batch: Batch, now: float) -> str:
        """Pick a tier for ``batch`` and stamp ``batch.tier``."""
        chosen: Optional[TierRoute] = None
        reason = "exhausted"
        for idx, r in enumerate(self.order):
            skip = self._skip_reason(r)
            if skip is None:
                self._skips[r.name] = 0
                chosen = r
                reason = "preferred" if idx == 0 else "spillover"
                break
            self._skips[r.name] += 1
            if (skip == "latency" and self.probe_every > 0
                    and self._skips[r.name] % self.probe_every == 0):
                chosen = r
                reason = "probe"
                break
            self.escalations[skip] += 1
        if chosen is None:
            chosen = self.order[-1]
        self.decisions += 1
        if chosen is not self.order[0]:
            self.spillovers += 1
        self._inflight[chosen.name] += 1
        self.routed[chosen.name] += 1
        batch.tier = chosen.name
        self.decision_log.append(
            (now, batch.endpoint or "", batch.size, chosen.name, reason))
        if self._tracer is not None:
            self._tracer.emit(now, "routed", batch.endpoint or "",
                              batch=batch.trace_id, size=batch.size,
                              detail=f"{chosen.name}:{reason}")
        return chosen.name

    def release(self, tier: Optional[str]) -> None:
        """Return one in-flight slot without a latency sample (failure /
        timeout terminals, where no upstream latency exists)."""
        if tier in self._inflight and self._inflight[tier] > 0:
            self._inflight[tier] -= 1

    def on_batch_done(self, tier: Optional[str], upstream_latency: float,
                      now: float) -> None:
        """Completion hook: frees the slot and feeds the latency EWMA."""
        self.release(tier)
        if tier in self._lat_ema and upstream_latency is not None:
            prev = self._lat_ema[tier]
            a = self.latency_alpha
            self._lat_ema[tier] = (
                upstream_latency if prev is None
                else (1.0 - a) * prev + a * upstream_latency)

    def stats(self) -> dict:
        return {
            "decisions": self.decisions,
            "spillovers": self.spillovers,
            "spillover_rate": (self.spillovers / self.decisions
                               if self.decisions else 0.0),
            "routed": dict(self.routed),
            "inflight": dict(self._inflight),
            "escalations": dict(self.escalations),
        }

    def register_metrics(self, registry, prefix: str = "router") -> None:
        """Bind routing counters into a MetricsRegistry."""
        b = registry.bind
        b(f"{prefix}.decisions", lambda: self.decisions)
        b(f"{prefix}.spillovers", lambda: self.spillovers)
        for r in self.order:
            b(f"{prefix}.routed.{r.name}",
              lambda _n=r.name: self.routed[_n])
            b(f"{prefix}.inflight.{r.name}",
              lambda _n=r.name: self._inflight[_n])
        for why in self.escalations:
            b(f"{prefix}.escalations.{why}",
              lambda _w=why: self.escalations[_w])


@dataclasses.dataclass
class Endpoint:
    """One named endpoint: its policy, SLA, and dispatch target."""

    name: str
    policy: Policy
    sla: SLAConfig
    dispatch_fn: DispatchFn  # the unwrapped target (platform, pool, ...)
    # Optional fleet-tier selector; when set, every dispatched batch is
    # stamped with a tier before it reaches dispatch_fn.
    router: Optional[SpilloverRouter] = None

    @property
    def deadline_budget(self) -> Optional[float]:
        """Per-request deadline budget in seconds (None = no deadlines)."""
        return self.sla.deadline_budget


class ProxyFrontend:
    """Routes requests across N endpoints, each with its own policy + SLA.

    ``tracer`` (optional :class:`repro.obs.trace.Tracer`) turns on
    lifecycle span emission: the frontend stamps ``admitted`` at
    admission and hands the tracer down to every endpoint's policy
    queue. None (the default) costs one attribute check per arrival.
    """

    def __init__(self, tracer=None) -> None:
        self._endpoints: Dict[str, Endpoint] = {}
        self._tracer = tracer

    # ------------------------------------------------------------- topology
    def add_endpoint(
        self,
        name: str,
        *,
        sla: SLAConfig,
        dispatch_fn: DispatchFn,
        policy: str = "mlproxy",
        policy_kwargs: Optional[dict] = None,
        expire_fn: Optional[ExpireFn] = None,
        router: Optional[SpilloverRouter] = None,
    ) -> Endpoint:
        """Register an endpoint; ``policy`` is a :func:`make_policy` name.

        The policy's dispatch path is wrapped so every batch is stamped
        with the endpoint name — and, when ``router`` is given, with the
        :class:`SpilloverRouter`'s tier choice — before it reaches
        ``dispatch_fn``. ``expire_fn(requests, now)`` (optional) fires
        whenever the policy's queue evicts deadline-expired requests, so
        the caller can resolve them (the live runtime completes their
        tickets with a ``DeadlineExceeded`` result).
        """
        # deferred import: policies imports proxy which imports batch_queue
        from repro_torch.core.policies import make_policy

        if name in self._endpoints:
            raise ValueError(f"endpoint {name!r} already registered")

        def stamped_dispatch(batch: Batch, _name=name, _fn=dispatch_fn,
                             _router=router) -> None:
            batch.endpoint = _name
            for r in batch.requests:
                r.endpoint = _name
            if _router is not None:
                # dispatch_time IS the policy's `now` for this batch —
                # the router needs no clock of its own
                _router.route(batch, batch.dispatch_time)
            _fn(batch)

        pol = make_policy(policy, sla, stamped_dispatch, expire_fn=expire_fn,
                          tracer=self._tracer, **(policy_kwargs or {}))
        ep = Endpoint(name=name, policy=pol, sla=sla, dispatch_fn=dispatch_fn,
                      router=router)
        self._endpoints[name] = ep
        return ep

    def endpoint(self, name: str) -> Endpoint:
        return self._endpoints[name]

    @property
    def names(self) -> List[str]:
        return list(self._endpoints)

    def __len__(self) -> int:
        return len(self._endpoints)

    # -------------------------------------------------------------- routing
    def resolve(self, key: Optional[str]) -> Endpoint:
        """Public routing lookup: endpoint for ``key`` (None ⇒ the only one)."""
        return self._resolve(key)

    def _resolve(self, key: Optional[str]) -> Endpoint:
        if key is None:
            if len(self._endpoints) == 1:
                return next(iter(self._endpoints.values()))
            raise KeyError(
                "request has no endpoint key and the frontend serves "
                f"{len(self._endpoints)} endpoints"
            )
        try:
            return self._endpoints[key]
        except KeyError:
            raise KeyError(
                f"unknown endpoint {key!r}; registered: {sorted(self._endpoints)}"
            ) from None

    def on_request(self, request: Request, now: float,
                   endpoint: Optional[str] = None) -> None:
        """Route one arrival to its endpoint's policy.

        Admission is where deadlines attach: a client-supplied
        ``request.deadline`` is honored as-is; otherwise, if the
        endpoint's SLA sets ``deadline_factor``, the deadline is derived
        here as ``now + slo_target × deadline_factor``.
        """
        ep = self._resolve(endpoint or request.endpoint)
        request.endpoint = ep.name
        if request.deadline is None and ep.deadline_budget is not None:
            request.deadline = now + ep.deadline_budget
        if self._tracer is not None:
            self._tracer.emit(now, "admitted", ep.name, request.req_id)
        ep.policy.on_request(request, now)

    def on_response(self, batch: Batch, upstream_latency: float, now: float) -> None:
        """Route a completed upstream batch back to the owning policy."""
        ep = self._resolve(batch.endpoint)
        if ep.router is not None and batch.tier is not None:
            ep.router.on_batch_done(batch.tier, upstream_latency, now)
        ep.policy.on_response(batch, upstream_latency, now)

    # --------------------------------------------------------------- timers
    def on_timer(self, now: float) -> None:
        """Fire every endpoint's timer; each policy guards its own deadline."""
        for ep in self._endpoints.values():
            ep.policy.on_timer(now)

    def next_event_time(self, now: float) -> Optional[float]:
        """Merged timer: the earliest ``next_event_time`` across endpoints."""
        times = [
            t for ep in self._endpoints.values()
            if (t := ep.policy.next_event_time(now)) is not None
        ]
        return min(times) if times else None

    def flush(self, now: float) -> None:
        for ep in self._endpoints.values():
            ep.policy.flush(now)

    # -------------------------------------------------------------- metrics
    def stats(self, now: float) -> dict:
        """Per-endpoint stats plus a fleet-level aggregate."""
        per = {name: ep.policy.stats(now) for name, ep in self._endpoints.items()}
        agg_batches = sum(s["dispatched_batches"] for s in per.values())
        agg_requests = sum(s["dispatched_requests"] for s in per.values())
        agg_retried = sum(s.get("retried_batches", 0) for s in per.values())
        agg_upstream = sum(s.get("upstream_batches", 0) for s in per.values())
        agg_slots = sum(s.get("dispatched_slots", 0) for s in per.values())
        agg_padded = sum(s.get("padded_slots", 0) for s in per.values())
        agg_attempts = sum(
            s.get("upstream_attempts", s.get("upstream_batches", 0))
            for s in per.values())
        agg_failed = sum(s.get("failed_attempts", 0) for s in per.values())
        return {
            "endpoints": per,
            "aggregate": {
                "n_endpoints": len(per),
                "queue_len": sum(s["queue_len"] for s in per.values()),
                # deepest any single endpoint queue has been (max, not sum:
                # the HWMs of different endpoints happen at different times)
                "queue_depth_hwm": max(
                    (s.get("queue_depth_hwm", 0) for s in per.values()),
                    default=0),
                "dispatched_batches": agg_batches,
                "dispatched_requests": agg_requests,
                # deadline-expired requests evicted before dispatch
                "expired": sum(s.get("expired", 0) for s in per.values()),
                # brownout-shed requests evicted at admission pressure
                "shed": sum(s.get("shed", 0) for s in per.values()),
                "avg_batch_size": agg_requests / agg_batches if agg_batches else 0.0,
                # upstream completion/attempt ledger (drift-audit parity
                # with the per-endpoint stats surface)
                "upstream_batches": agg_upstream,
                "upstream_attempts": agg_attempts,
                "dispatched_slots": agg_slots,
                "padded_slots": agg_padded,
                # platform-side crash retries / hedges, observed through
                # Batch.attempts on the completion path; rate is over
                # *completed* upstream batches, same as per-endpoint stats
                "retried_batches": agg_retried,
                "retry_rate": agg_retried / agg_upstream if agg_upstream else 0.0,
                # failed upstream attempts (target errors / injected
                # faults), over all attempts that reached the target
                "failed_attempts": agg_failed,
                "failure_rate": (agg_failed / (agg_attempts + agg_failed)
                                 if (agg_attempts + agg_failed) else 0.0),
                # bucket slots burned on padding, over all dispatched slots
                # (0.0 on unbucketed endpoints: every slot is a request)
                "padding_waste": agg_padded / agg_slots if agg_slots else 0.0,
                # worst-endpoint SLO burn (max, not mean: the alerting
                # question is "is ANY endpoint burning its budget")
                "burn_rate_fast": max(
                    (s.get("burn_rate_fast", 0.0) for s in per.values()),
                    default=0.0),
                "burn_rate_slow": max(
                    (s.get("burn_rate_slow", 0.0) for s in per.values()),
                    default=0.0),
            },
        }

    # ------------------------------------------------------ fault tolerance
    def snapshot(self) -> dict:
        return {name: ep.policy.snapshot() for name, ep in self._endpoints.items()}

    def restore(self, state: dict) -> None:
        for name, sub in state.items():
            self._endpoints[name].policy.restore(sub)
