"""Shared batch-queue primitive and the formal ``Policy`` protocol.

Every batching policy in this repo — :class:`~repro.core.proxy.MLProxy`'s
queue scheduler and all four baselines in :mod:`repro.core.policies` —
needs the same machinery underneath its decision logic: a FIFO of pending
requests, the first-arrival (FRT) reference point, a single pending dispatch
deadline, pow2 bucketing for fixed-shape backends, dispatch counters, and
snapshot/restore of all of the above. That machinery used to be duplicated
between ``QueueScheduler._dispatch`` and ``BatchingPolicy._dispatch``;
:class:`BatchQueue` is the one shared implementation.

A policy *decides* (target batch size, timeout); the queue *executes*
(accumulate, stamp, bucket, count, hand off). The split keeps every policy
down to its decision logic and makes the dispatch path change in exactly
one place.

:class:`Policy` is the event-driven surface the routing layer
(:mod:`repro.core.frontend`), the simulator, and the serving engine program
against. It is a :func:`typing.runtime_checkable` protocol so conformance
is testable without inheritance.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Callable, List, Optional, Protocol, \
    runtime_checkable

from repro_torch.core.config import bucket_of
from repro_torch.core.monitor import SmartMonitor
from repro_torch.core.request import Batch, Request

if TYPE_CHECKING:  # imported lazily so the core stays obs-optional
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.trace import Tracer

DispatchFn = Callable[[Batch], None]
#: Called with (expired_requests, now) whenever the expiry sweep evicts
#: already-dead requests from the queue — the hook the live runtime uses
#: to resolve their tickets with a DeadlineExceeded result.
ExpireFn = Callable[[List[Request], float], None]

#: Epsilon for "deadline has passed" checks, mirroring the timer-fire
#: epsilon in the policies: a timer that wakes a float-ulp before the
#: deadline must still count the request as expired.
_EXPIRY_EPS = 1e-12


@runtime_checkable
class Policy(Protocol):
    """Event-driven batching-policy surface (clock-free: callers pass ``now``).

    Implementations: :class:`~repro.core.proxy.MLProxy` and every baseline in
    :mod:`repro.core.policies`. The simulator, the serving loop, and
    :class:`~repro.core.frontend.ProxyFrontend` only ever touch this surface,
    so policies are freely swappable per endpoint.
    """

    def on_request(self, request: Request, now: float) -> None:
        """Handle one arrival; may dispatch synchronously."""

    def on_response(self, batch: Batch, upstream_latency: float, now: float) -> None:
        """Record a completed upstream batch; completes member requests."""

    def on_timer(self, now: float) -> None:
        """Fire due timeouts / periodic updates."""

    def expire(self, now: float) -> List[Request]:
        """Evict queued requests whose deadline has passed; returns them.

        O(1) when nothing is expirable — safe to call on admission paths
        (e.g. before a queue-depth check counts dead requests)."""
        ...

    def shed(self, now: float, keep: int) -> List[Request]:
        """Evict queued requests beyond ``keep``, lowest deadline slack
        first (brownout load shedding); returns the evicted list."""
        ...

    def next_event_time(self, now: float) -> Optional[float]:
        """Earliest future time at which :meth:`on_timer` must run."""

    def flush(self, now: float) -> None:
        """Dispatch whatever is queued (shutdown / checkpoint barrier)."""

    def stats(self, now: float) -> dict:
        """Point-in-time metrics (max_bs, queue_len, violation_rate, ...)."""

    def snapshot(self) -> dict:
        """Serializable control-plane state (crash/restart resumes warm)."""

    def restore(self, state: dict) -> None:
        """Inverse of :meth:`snapshot`."""

    @property
    def max_bs(self) -> int:
        """Current target batch size."""
        ...

    @property
    def queue_len(self) -> int:
        """Pending requests queued (O(1); cheaper than ``stats()``)."""
        ...


class BatchQueue:
    """The shared queue/dispatch/bucketing/snapshot core under every policy.

    Holds pending requests plus the two pieces of timing state every policy
    needs — the oldest-arrival reference (``first_arrival``, the paper's FRT
    anchor) and the single pending dispatch deadline (``next_deadline``) —
    and owns the one ``_dispatch`` implementation: stamp dispatch times,
    apply bucketing, reset state, bump counters, notify the monitor, hand
    the batch to ``dispatch_fn``.
    """

    def __init__(
        self,
        dispatch_fn: DispatchFn,
        monitor: Optional[SmartMonitor] = None,
        bucketing: Optional[str] = None,
        expire_fn: Optional[ExpireFn] = None,
        tracer: Optional["Tracer"] = None,
    ) -> None:
        self.dispatch_fn = dispatch_fn
        self.monitor = monitor
        self.bucketing = bucketing
        self.expire_fn = expire_fn
        # Lifecycle span tracer (repro.obs.trace). None (the default)
        # means every emission site below is a single attribute check —
        # tracing off must cost nothing and perturb nothing.
        self.tracer = tracer
        self._queue: List[Request] = []
        self.first_arrival: Optional[float] = None
        self.next_deadline: Optional[float] = None
        self.dispatched_batches = 0
        self.dispatched_requests = 0
        self.expired_requests = 0
        self.shed_requests = 0
        # Deepest the queue has ever been (admission-time high-water mark).
        self.queue_depth_hwm = 0
        # Deadline bookkeeping for the hot path: how many queued requests
        # carry a deadline, and the earliest of them. Deadline-free
        # workloads (the default) pay one integer check per sweep; with
        # deadlines on, both the sweep and ``next_expiry`` are O(1)
        # unless something actually expires.
        self._deadline_count = 0
        self._min_deadline: Optional[float] = None

    # ------------------------------------------------------------------ api
    def __len__(self) -> int:
        return len(self._queue)

    @property
    def queue_len(self) -> int:
        return len(self._queue)

    def append(self, request: Request, now: float) -> None:
        """Enqueue one request; anchors ``first_arrival`` on an empty queue."""
        if not self._queue:
            self.first_arrival = now
        self._queue.append(request)
        if len(self._queue) > self.queue_depth_hwm:
            self.queue_depth_hwm = len(self._queue)
        # Deliberately no span event here: a per-arrival emission would
        # dominate the tracing-on overhead budget, and the queue-entry
        # instant is recoverable — the "batched"/"expired"/"shed" event
        # that resolves this request carries ``arrival_time`` in its
        # value field, so exporters reconstruct the queue-wait span
        # without a hot-path event.
        if request.deadline is not None:
            self._deadline_count += 1
            if (self._min_deadline is None
                    or request.deadline < self._min_deadline):
                self._min_deadline = request.deadline

    def frt(self, now: float) -> float:
        """Age of the oldest queued request (0 when empty)."""
        if self.first_arrival is None:
            return 0.0
        return now - self.first_arrival

    # --------------------------------------------------------------- expiry
    def expire(self, now: float) -> List[Request]:
        """Evict queued requests whose deadline has already passed.

        Expired requests are marked ``timed_out`` (terminal state), counted
        in ``expired_requests``, and handed to ``expire_fn`` so the owner
        (live server, simulator) can resolve them; they are never batched,
        dispatched, or billed. Returns the evicted list (often empty).
        """
        cutoff = now + _EXPIRY_EPS
        if self._min_deadline is None or self._min_deadline > cutoff:
            return []  # O(1): nothing queued can have expired yet
        expired = [r for r in self._queue
                   if r.deadline is not None and r.deadline <= cutoff]
        if not expired:
            return expired
        self._queue = [r for r in self._queue
                       if r.deadline is None or r.deadline > cutoff]
        self._deadline_count -= len(expired)
        self._min_deadline = min(
            (r.deadline for r in self._queue if r.deadline is not None),
            default=None,
        )
        self.expired_requests += len(expired)
        for r in expired:
            r.timed_out = True
        if self.tracer is not None:
            for r in expired:
                self.tracer.emit(now, "expired", r.endpoint or "",
                                 r.req_id, -1, 0, r.arrival_time)
        if self._queue:
            # FIFO order: the head of the surviving queue is the oldest;
            # re-anchor FRT on its arrival instant.
            self.first_arrival = self._queue[0].arrival_time
        else:
            self.first_arrival = None
            self.next_deadline = None
        if self.expire_fn is not None:
            self.expire_fn(expired, now)
        return expired

    def shed(self, now: float, keep: int) -> List[Request]:
        """Evict queued requests beyond ``keep``, lowest slack first.

        Brownout shedding: when an endpoint's circuit breaker opens, the
        requests least likely to survive the outage are dropped first —
        the ones with the smallest remaining deadline slack. Deadline-free
        requests have infinite slack, so they shed last (newest first,
        preserving the oldest requests' place at the head of the FIFO).

        Shed requests are counted in ``shed_requests`` and returned to the
        caller for ticket resolution; ``expire_fn`` is NOT invoked —
        shedding is an admission-control decision, not a deadline expiry
        (the two are distinct ledger classes).
        """
        # slack ordering reduces to deadline ordering (same `now`); `now`
        # is only used to timestamp shed span events
        excess = len(self._queue) - max(0, keep)
        if excess <= 0:
            return []
        order = sorted(
            range(len(self._queue)),
            key=lambda i: (
                (1, 0.0, -i) if self._queue[i].deadline is None
                else (0, self._queue[i].deadline, -i)
            ),
        )
        victims = set(order[:excess])
        evicted = [self._queue[i] for i in order[:excess]]
        self._queue = [r for i, r in enumerate(self._queue)
                       if i not in victims]
        self.shed_requests += len(evicted)
        if self.tracer is not None:
            for r in evicted:
                self.tracer.emit(now, "shed", r.endpoint or "",
                                 r.req_id, -1, 0, r.arrival_time)
        deadlines = [r.deadline for r in self._queue if r.deadline is not None]
        self._deadline_count = len(deadlines)
        self._min_deadline = min(deadlines, default=None)
        if self._queue:
            # FIFO order: the head of the surviving queue is the oldest
            self.first_arrival = self._queue[0].arrival_time
        else:
            self.first_arrival = None
            self.next_deadline = None
        return evicted

    def next_expiry(self) -> Optional[float]:
        """Earliest queued deadline (None when no queued request has one)."""
        return self._min_deadline

    def next_event_time(self) -> Optional[float]:
        """Merged wake-up: the earlier of the dispatch deadline and the
        earliest request expiry (what every policy's ``next_event_time``
        must report so the shared timer wakes for expiries too)."""
        deadline = self.next_deadline
        expiry = self._min_deadline
        if deadline is None:
            return expiry
        if expiry is None:
            return deadline
        return min(deadline, expiry)

    def _dispatch(self, now: float, cause: str,
                  limit: Optional[int] = None) -> Optional[Batch]:
        """Dispatch the queue (or its first ``limit`` requests) as one batch.
        The only implementation.

        Already-expired requests are evicted *before* batch formation; if
        that empties the queue there is nothing to dispatch and ``None``
        is returned (state already reset by the sweep). ``limit`` is how
        bucket-aware packing dispatches exactly at a bucket edge: the head
        of the FIFO goes out, the tail stays queued with its FRT anchor
        re-anchored on the new oldest request.
        """
        if self._deadline_count:
            self.expire(now)
            if not self._queue:
                return None
        if limit is not None and 0 < limit < len(self._queue):
            head, tail = self._queue[:limit], self._queue[limit:]
        else:
            head, tail = self._queue, []
        batch = Batch(requests=head, dispatch_time=now, cause=cause)
        if self.bucketing is not None:
            batch.bucket_size = bucket_of(batch.size, self.bucketing)
        for r in batch.requests:
            r.dispatch_time = now
        self._queue = tail
        self.next_deadline = None
        if tail:
            # FIFO order: the head of the surviving queue is the oldest
            self.first_arrival = tail[0].arrival_time
            deadlines = [r.deadline for r in tail if r.deadline is not None]
            self._deadline_count = len(deadlines)
            self._min_deadline = min(deadlines, default=None)
        else:
            self.first_arrival = None
            self._deadline_count = 0
            self._min_deadline = None
        self.dispatched_batches += 1
        self.dispatched_requests += batch.size
        if self.monitor is not None:
            self.monitor.record_dispatch(batch.size, cause,
                                         effective_size=batch.effective_size)
        tracer = self.tracer
        if tracer is not None:
            bid = batch.trace_id = tracer.next_batch_id()
            reqs = batch.requests
            ep = reqs[0].endpoint or "" if reqs else ""
            # inlined tracer.emit (see Tracer docstring): this is the
            # hottest emission site on the decision path. Membership is
            # packed columnar — ONE "batched" event per batch whose req
            # slot holds the member-id tuple and whose value slot holds
            # the matching arrival-time tuple — because per-member
            # events are what blow the ≤10% tracing-on overhead budget:
            # the retained ring allocations, not the emit calls, are the
            # measured cost. The ring evicts oldest-first on its own
            # (deque maxlen); drops are accounted up front, which is
            # exactly what per-event checks would have counted.
            buf = tracer.buf
            overflow = len(buf) + 2 - tracer.capacity
            if overflow > 0:
                tracer.dropped += overflow
            buf.append((now, "dispatched", ep, -1, bid, batch.size, 0.0,
                        cause))
            buf.append((now, "batched", ep,
                        tuple([r.req_id for r in reqs]), bid, batch.size,
                        tuple([r.arrival_time for r in reqs]), ""))
        self.dispatch_fn(batch)
        return batch

    @property
    def avg_batch_size(self) -> float:
        return (self.dispatched_requests / self.dispatched_batches
                if self.dispatched_batches else 0.0)

    def stats(self, monitor: SmartMonitor, now: float, *,
              max_bs: int, max_bs_raw: float) -> dict:
        """The one canonical per-policy stats dict.

        Every policy's ``stats()`` delegates here, so the key set cannot
        drift between MLProxy and the baselines (regression-tested in
        the stats-parity tests)."""
        burn = monitor.burn.rates(now)
        return {
            "max_bs": max_bs,
            "max_bs_raw": max_bs_raw,
            "queue_len": self.queue_len,
            "queue_depth_hwm": self.queue_depth_hwm,
            "dispatched_batches": self.dispatched_batches,
            "dispatched_requests": self.dispatched_requests,
            "avg_batch_size": self.avg_batch_size,
            "expired": self.expired_requests,
            "shed": self.shed_requests,
            "e2e_p": monitor.e2e_percentile(now),
            "violation_rate": monitor.violation_rate(),
            "timeout_ratio": monitor.timeout_ratio(),
            "upstream_batches": monitor.lifetime_upstream_batches,
            "upstream_attempts": monitor.lifetime_upstream_attempts,
            "retried_batches": monitor.lifetime_retried_batches,
            "retry_rate": monitor.retry_rate(),
            "failed_attempts": monitor.lifetime_failed_attempts,
            "failure_rate": monitor.failure_rate(),
            "dispatched_slots": monitor.lifetime_dispatched_slots,
            "padded_slots": monitor.lifetime_padded_slots,
            "padding_waste": monitor.padding_waste(),
            "burn_rate_fast": burn["burn_rate_fast"],
            "burn_rate_slow": burn["burn_rate_slow"],
        }

    # -------------------------------------------------------------- metrics
    def register_metrics(self, registry: "MetricsRegistry",
                         prefix: str = "queue") -> None:
        """Bind this queue's ledger counters into a MetricsRegistry."""
        registry.bind(f"{prefix}.dispatched_batches",
                      lambda: self.dispatched_batches)
        registry.bind(f"{prefix}.dispatched_requests",
                      lambda: self.dispatched_requests)
        registry.bind(f"{prefix}.expired_requests",
                      lambda: self.expired_requests)
        registry.bind(f"{prefix}.shed_requests", lambda: self.shed_requests)
        registry.bind(f"{prefix}.depth", lambda: len(self._queue))
        registry.bind(f"{prefix}.depth_hwm", lambda: self.queue_depth_hwm)

    # ------------------------------------------------------ fault tolerance
    def snapshot(self) -> dict:
        return {
            "queue": list(self._queue),
            "first_arrival": self.first_arrival,
            "next_deadline": self.next_deadline,
            "dispatched_batches": self.dispatched_batches,
            "dispatched_requests": self.dispatched_requests,
            "expired_requests": self.expired_requests,
            "shed_requests": self.shed_requests,
            "queue_depth_hwm": self.queue_depth_hwm,
        }

    def restore(self, state: dict) -> None:
        self._queue = list(state["queue"])
        self.first_arrival = state["first_arrival"]
        self.next_deadline = state["next_deadline"]
        self.dispatched_batches = state["dispatched_batches"]
        self.dispatched_requests = state["dispatched_requests"]
        # pre-deadline snapshots carry no expiry state; pre-brownout
        # snapshots carry no shed accounting; pre-obs snapshots carry no
        # high-water mark
        self.expired_requests = state.get("expired_requests", 0)
        self.shed_requests = state.get("shed_requests", 0)
        self.queue_depth_hwm = state.get("queue_depth_hwm", len(self._queue))
        deadlines = [r.deadline for r in self._queue if r.deadline is not None]
        self._deadline_count = len(deadlines)
        self._min_deadline = min(deadlines, default=None)
