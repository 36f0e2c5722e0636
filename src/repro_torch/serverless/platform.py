"""Simulated serverless platform (Knative-shaped) for experiments.

Models the pieces of Knative that the paper's evaluation depends on:

* **Containers** with a concurrency limit (``containerConcurrency``); a
  batched request occupies one concurrency slot for its service time (the
  ML serving containers in the paper process requests serially).
* **KPA autoscaler**: concurrency-based scaling with a stable window, a
  panic window, target utilization, scale-to-zero after a grace period and
  cold-start delay for new containers.
* **Activator queue**: requests (batches) that arrive when no slot is free
  queue platform-side; their queueing time is part of the upstream response
  time the proxy's monitor observes — exactly what MLProxy sees through its
  HTTP client.
* **Billing**: cost is a billable-seconds *integral* — billable
  (provisioned or draining) containers integrated over time, exposed as
  :attr:`ServerlessPlatform.cost_integral` — not a point-in-time container
  count. The paper's "number of containers" figure is this integral
  divided by the billing window (:meth:`ServerlessPlatform.avg_containers`).
* **Fault injection** (beyond paper, required at production scale): random
  container crashes with at-least-once re-dispatch, straggler service
  times, spot-style container preemption (a billable container reclaimed
  mid-batch), and optional hedged duplicates for straggler mitigation.

Execution is organised around an explicit **attempt ledger**: every
:class:`_WorkItem` (one upstream batch) owns the set of its live
:class:`_Attempt` records — (container, start time, scheduled completion) —
and every state transition (crash, completion, hedge, drain, scale-down)
resolves through the ledger:

* a container crash cancels and requeues *every* live attempt on the dead
  container, so co-resident batches are never lost when
  ``container_concurrency > 1``;
* the first completed attempt wins; sibling attempts are cancelled on the
  spot, freeing their concurrency slots immediately (no phantom occupancy
  until a stale completion timer fires);
* hedged duplicates are capped per item (``max_hedges``) and placed
  anti-affine to the item's live attempts, so one straggler cannot fan out
  into a duplicate storm on the same doomed container;
* the autoscaler's concurrency signal is derived from the ledger (live
  attempts + queued-not-done items), so completed items lingering in the
  queue never inflate it.

The ledger makes the conservation invariant checkable at any instant:
``submitted == completed + queued + inflight`` with zero lost and zero
duplicate completions — see :meth:`ServerlessPlatform.conservation` and
:meth:`ServerlessPlatform.assert_conserved`.

The platform is clock-free like the proxy: it schedules itself on the
shared :class:`~repro.simulation.events.EventQueue`.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import itertools
import math
from functools import partial
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.request import Batch
from repro_torch.serverless.latency import LatencyModel
from repro_torch.simulation.events import EventQueue


@dataclasses.dataclass(frozen=True)
class PlatformConfig:
    container_concurrency: int = 1
    target_utilization: float = 0.7
    autoscale_tick: float = 2.0
    metric_tick: float = 1.0
    stable_window: float = 60.0
    panic_window: float = 6.0
    panic_threshold: float = 2.0
    scale_to_zero_grace: float = 30.0
    cold_start: float = 4.0
    min_scale: int = 0
    max_scale: int = 1000
    initial_scale: int = 0
    # Knative rate limits: desired ≤ up_rate × current per tick, and
    # desired ≥ current / down_rate per tick.
    max_scale_up_rate: float = 10.0
    max_scale_down_rate: float = 2.0
    # Processor-sharing slowdown: with k batches co-resident on one
    # container, each takes ×(1 + ps_slowdown·(k−1)) longer (CPU-bound ML
    # containers serialize; 1.0 ≈ perfect processor sharing).
    ps_slowdown: float = 1.0
    # Fault injection / mitigation (beyond paper)
    failure_prob_per_batch: float = 0.0
    # Spot-style preemption: per-attempt probability that the hosting
    # container is reclaimed mid-service. Like a crash, every co-resident
    # attempt is requeued through the ledger, but the accounting is kept
    # separate (capacity taken back by the platform, not lost to a fault).
    preempt_prob_per_batch: float = 0.0
    straggler_prob: float = 0.0
    straggler_mult: float = 5.0
    hedge_factor: float = 0.0  # >0 enables hedged re-dispatch at f×E[s]
    max_hedges: int = 1  # cap on hedged duplicates per work item


class _Container:
    _ids = itertools.count()
    __slots__ = ("cid", "ready_at", "terminated", "draining", "inflight",
                 "attempts", "counted_ready", "in_heap")

    def __init__(self, ready_at: float) -> None:
        self.cid = next(_Container._ids)
        self.ready_at = ready_at
        self.terminated = False
        self.draining = False  # finish in-flight work then terminate
        self.inflight: int = 0
        self.attempts: List["_Attempt"] = []  # live attempts hosted here
        # Bookkeeping for the O(1) counters / free-heap (see platform):
        # counted_ready mirrors "ready and not draining" exactly as of the
        # last state transition; in_heap marks membership in the free-heap.
        self.counted_ready = False
        self.in_heap = False

    def is_ready(self, now: float) -> bool:
        return not self.terminated and now >= self.ready_at

    def available_slots(self, now: float, concurrency: int) -> int:
        if not self.is_ready(now) or self.draining:
            return 0
        return max(0, concurrency - self.inflight)


class _Attempt:
    """One dispatch of a work item onto a container.

    ``resolved`` flips exactly once — on completion, cancellation (a
    sibling won), or crash — so the completion/crash/hedge events queued
    against this attempt become no-ops the moment it leaves the ledger.
    """

    _ids = itertools.count()
    __slots__ = ("attempt_id", "item", "container", "start", "eta", "resolved")

    def __init__(self, item: "_WorkItem", container: _Container,
                 start: float, eta: float) -> None:
        self.attempt_id = next(_Attempt._ids)
        self.item = item
        self.container = container
        self.start = start
        self.eta = eta  # scheduled completion (or crash instant if doomed)
        self.resolved = False


class _WorkItem:
    _ids = itertools.count()
    __slots__ = ("item_id", "batch", "submit_time", "done", "attempts",
                 "hedges", "live", "queued")

    def __init__(self, batch: Batch, submit_time: float) -> None:
        self.item_id = next(_WorkItem._ids)
        self.batch = batch
        self.submit_time = submit_time
        self.done = False
        self.attempts = 0  # total attempts ever started
        self.hedges = 0  # hedged duplicates issued (capped by max_hedges)
        self.live: List[_Attempt] = []  # unresolved attempts
        self.queued = False  # logically in the pending queue


class ServerlessPlatform:
    """Discrete-event Knative-like platform fed by a batching policy."""

    def __init__(
        self,
        config: PlatformConfig,
        latency_model: LatencyModel,
        events: EventQueue,
        rng: np.random.Generator,
        on_batch_done: Callable[[Batch, float, float], None],
        fault_rng: Optional[np.random.Generator] = None,
        tracer=None,
        recorder=None,
    ) -> None:
        """``on_batch_done(batch, upstream_latency, now)`` fires once per batch.

        ``rng`` draws service times; ``fault_rng`` (defaulting to the same
        stream) draws crash/straggler outcomes. The simulator passes two
        spawned streams so fault injection cannot shift service-time draws
        (and vice versa) when either path changes.

        ``tracer``/``recorder`` are the optional observability seams (see
        :mod:`repro.obs`): the tracer receives one span per ledger
        transition (attempt / fault / hedge / completion), the recorder's
        ring is dumped when :meth:`assert_conserved` trips. Both default
        to None, which keeps the hot path untouched.
        """
        self.config = config
        self.latency = latency_model
        self.events = events
        self.rng = rng
        self.fault_rng = fault_rng if fault_rng is not None else rng
        self.on_batch_done = on_batch_done
        self.tracer = tracer
        self.recorder = recorder

        self.containers: List[_Container] = []
        self.pending: Deque[_WorkItem] = collections.deque()
        # O(1) fleet counters (maintained at every container transition;
        # replaces the per-event list scans that dominated large runs) and
        # the cid-ordered heap of containers that may have a free slot.
        self._n_provisioned = 0
        self._n_billable = 0
        self._n_ready = 0
        self._free_heap: List[Tuple[int, _Container]] = []
        self._queued_count = 0  # live (not-done) items in ``pending``
        self._live_attempts = 0  # unresolved attempts across all containers
        self._open: Dict[int, _WorkItem] = {}  # item_id → not-yet-done item
        # time-weighted concurrency (Knative's queue-proxy reports average
        # concurrency over each reporting period, not point samples —
        # point-sampling misses sub-second batches and flaps the panic mode)
        self._conc_samples: Deque[Tuple[float, float]] = collections.deque()
        self._conc_integral = 0.0
        self._conc_t = 0.0
        self._last_traffic: float = 0.0
        self._panic_until: float = -1.0
        self._started = False

        # billing + metrics
        self.container_seconds = 0.0
        self._billing_last_t = 0.0
        self._billing_last_n = 0
        self.submitted_batches = 0
        self.submitted_requests = 0
        self.completed_batches = 0
        self.completed_requests = 0
        self.failed_attempts = 0
        self.preemptions = 0  # billable containers reclaimed mid-batch
        self.preempted_attempts = 0  # live attempts cancelled by reclaims
        self.requeued_batches = 0  # crash/preempt at-least-once requeues
        self.hedged_dispatches = 0
        self.cancelled_attempts = 0  # sibling attempts cancelled by a winner
        self.duplicate_completions = 0  # must stay 0: exactly-once guard
        self.cold_starts = 0
        self.peak_containers = 0
        self.timeline: List[Tuple[float, int, int, int]] = []  # (t, provisioned, ready, queued)

        for _ in range(max(config.min_scale, config.initial_scale)):
            self._start_container(0.0, cold=False)

    # ------------------------------------------------------------------ api
    def start(self, now: float) -> None:
        """Begin autoscaler + metric ticking."""
        if self._started:
            return
        self._started = True
        self._billing_last_t = now
        self.events.push(now + self.config.metric_tick, self._metric_tick)
        self.events.push(now + self.config.autoscale_tick, self._autoscale_tick)

    def submit(self, batch: Batch, now: float) -> None:
        """One upstream HTTP request carrying ``batch`` (the proxy's view)."""
        self.start(now)
        self._accrue_conc(now)
        self._last_traffic = now
        item = _WorkItem(batch, now)
        self.submitted_batches += 1
        self.submitted_requests += batch.size
        self._open[item.item_id] = item
        self._enqueue(item)
        # Reactive fast-path: Knative's activator pokes the autoscaler on
        # traffic from zero; model that by an immediate scale check.
        if self._n_ready == 0 and self._n_provisioned == 0:
            self._scale_to(max(1, self.config.min_scale), now)
        self._try_assign(now)

    @property
    def billable_count(self) -> int:
        """Containers currently billed (provisioned or draining)."""
        return self._billable_count()

    def ready_count(self, now: float) -> int:
        """Containers ready to accept work at ``now``."""
        return self._ready_count(now)

    @property
    def queued_batches(self) -> int:
        """Live (not-yet-done) work items waiting in the platform queue."""
        return self._queued_count

    # --------------------------------------------------------------- ledger
    def _enqueue(self, item: _WorkItem, front: bool = False) -> None:
        """Put ``item`` (back) into the pending queue exactly once."""
        if item.queued or item.done:
            return
        item.queued = True
        self._queued_count += 1
        if front:
            self.pending.appendleft(item)
        else:
            self.pending.append(item)

    def _mark_dequeued(self, item: _WorkItem) -> None:
        """Logically remove ``item`` from pending (deque entry goes stale)."""
        if item.queued:
            item.queued = False
            self._queued_count -= 1

    def _resolve_attempt(self, a: _Attempt, now: float,
                         container_dead: bool = False) -> None:
        """Take one attempt out of the ledger, freeing its slot.

        ``container_dead`` skips per-slot bookkeeping when the whole
        container just crashed (its occupancy is zeroed wholesale).
        """
        if a.resolved:
            return
        a.resolved = True
        self._live_attempts -= 1
        a.item.live.remove(a)
        c = a.container
        if a in c.attempts:
            c.attempts.remove(a)
        if not container_dead and not c.terminated:
            c.inflight = max(0, c.inflight - 1)
            if c.draining:
                if c.inflight == 0:
                    self._mark_terminated(c, now)
            else:
                self._heap_push(c)  # a slot just freed

    # ------------------------------------------------------------- internals
    def _provisioned_count(self) -> int:
        return self._n_provisioned

    def _billable_count(self) -> int:
        return self._n_billable

    def _ready_count(self, now: float) -> int:
        return self._n_ready

    def _heap_push(self, c: _Container) -> None:
        """Offer ``c`` to the free-heap (cid order == creation order, so
        assignment prefers the oldest free container, as the old full scan
        did). Entries are lazily invalidated on pop."""
        if not c.in_heap and not c.terminated and not c.draining:
            c.in_heap = True
            heapq.heappush(self._free_heap, (c.cid, c))

    def _mark_terminated(self, c: _Container, now: float) -> None:
        """Centralized terminate transition: billing + counters."""
        self._accrue_billing(now)
        c.terminated = True
        self._n_billable -= 1
        if not c.draining:
            self._n_provisioned -= 1
        if c.counted_ready:
            c.counted_ready = False
            self._n_ready -= 1
        self._billing_last_n = self._n_billable

    def _concurrency(self) -> float:
        # Ledger-derived: live attempts + queued live items. Items that
        # completed while a stale copy sat in ``pending`` are excluded, so
        # crash/hedge churn cannot inflate the autoscaler signal.
        return float(self._live_attempts + self._queued_count)

    def _accrue_conc(self, now: float) -> None:
        """Advance the time-weighted concurrency integral to ``now``."""
        if now > self._conc_t:
            self._conc_integral += self._concurrency() * (now - self._conc_t)
            self._conc_t = now

    def _accrue_billing(self, now: float) -> None:
        self.container_seconds += self._billing_last_n * (now - self._billing_last_t)
        self._billing_last_t = now
        self._billing_last_n = self._billable_count()

    def _start_container(self, now: float, cold: bool = True) -> None:
        self._accrue_billing(now)
        delay = self.config.cold_start if cold else 0.0
        c = _Container(ready_at=now + delay)
        self.containers.append(c)
        self._n_provisioned += 1
        self._n_billable += 1
        if cold:
            self.cold_starts += 1
            self.events.push(c.ready_at, partial(self._on_container_ready, c))
        else:
            c.counted_ready = True
            self._n_ready += 1
            self._heap_push(c)
        self._billing_last_n = self._n_billable
        if self._n_billable > self.peak_containers:
            self.peak_containers = self._n_billable

    def _on_container_ready(self, c: _Container, now: float) -> None:
        if c.terminated:
            return  # scaled down (or crashed) before it ever became ready
        if not c.draining:
            c.counted_ready = True
            self._n_ready += 1
            self._heap_push(c)
        self._try_assign(now)

    def _terminate(self, c: _Container, now: float) -> None:
        if c.inflight > 0:
            # drains, then terminates when its last live attempt resolves
            self._accrue_billing(now)
            c.draining = True
            self._n_provisioned -= 1
            if c.counted_ready:
                c.counted_ready = False
                self._n_ready -= 1
            self._billing_last_n = self._n_billable
        else:
            self._mark_terminated(c, now)

    def _try_assign(self, now: float) -> None:
        self._accrue_conc(now)
        if self._queued_count == 0:
            return
        conc = self.config.container_concurrency
        heap = self._free_heap
        pending = self.pending
        # Containers that still have a free slot but whose slot no queued
        # item may use (anti-affinity): parked aside, restored afterwards.
        blocked: List[Tuple[int, _Container]] = []
        while self._queued_count > 0 and heap:
            cid_c = heap[0]
            c = cid_c[1]
            if c.terminated or c.draining or c.inflight >= conc:
                heapq.heappop(heap)  # stale entry
                c.in_heap = False
                continue
            deferred: List[_WorkItem] = []
            item = None
            while pending:
                it = pending.popleft()
                if not it.queued or it.done:
                    continue  # stale deque entry; already resolved elsewhere
                if any(a.container is c for a in it.live):
                    # anti-affinity: a hedge/retry must not land next to its
                    # own live sibling — it would share the sibling's fate
                    deferred.append(it)
                    continue
                item = it
                break
            for d in reversed(deferred):
                pending.appendleft(d)
            if item is None:
                heapq.heappop(heap)  # free, but unusable for this queue
                blocked.append(cid_c)
                continue
            self._mark_dequeued(item)
            self._execute(c, item, now)
        for entry in blocked:
            heapq.heappush(heap, entry)

    def _execute(self, c: _Container, item: _WorkItem, now: float) -> None:
        cfg = self.config
        c.inflight += 1
        item.attempts += 1
        service = self.latency.sample_batch(item.batch, self.rng)
        if cfg.ps_slowdown > 0 and c.inflight > 1:
            service *= 1.0 + cfg.ps_slowdown * (c.inflight - 1)
        if cfg.straggler_prob > 0 and self.fault_rng.random() < cfg.straggler_prob:
            service *= cfg.straggler_mult
        fail = (cfg.failure_prob_per_batch > 0
                and self.fault_rng.random() < cfg.failure_prob_per_batch)
        # Preemption draw is guarded so zero-prob configs consume no extra
        # randomness (byte-identity with pre-preemption runs); a crash on
        # the same attempt wins — the container cannot die twice.
        preempt = (not fail and cfg.preempt_prob_per_batch > 0
                   and self.fault_rng.random() < cfg.preempt_prob_per_batch)
        a = _Attempt(item, c, start=now, eta=now + service)
        item.live.append(a)
        c.attempts.append(a)
        self._live_attempts += 1
        if self.tracer is not None:
            self.tracer.emit(now, "attempt", item.batch.endpoint,
                             batch=item.batch.trace_id,
                             size=item.batch.size, value=service,
                             detail=f"try{item.attempts}")
        if fail:
            # crash at a uniform point during service; every live attempt
            # on the container is requeued in _crash
            a.eta = now + service * float(self.fault_rng.random())
            self.events.push(a.eta, partial(self._crash, a))
        elif preempt:
            # spot reclaim at a uniform point during service; same requeue
            # semantics as a crash, separate accounting (_preempt)
            a.eta = now + service * float(self.fault_rng.random())
            self.events.push(a.eta, partial(self._preempt, a))
        else:
            self.events.push(a.eta, partial(self._complete, a))
            if cfg.hedge_factor > 0 and item.hedges < cfg.max_hedges:
                est = self.latency.mean_batch(item.batch)
                self.events.push(
                    now + cfg.hedge_factor * est,
                    partial(self._maybe_hedge, a),
                )

    def _maybe_hedge(self, a: _Attempt, now: float) -> None:
        item = a.item
        if item.done or a.resolved or item.queued:
            return  # finished, superseded, or already awaiting re-dispatch
        if item.hedges >= self.config.max_hedges:
            return
        # straggler suspected: re-dispatch a duplicate; first finisher wins.
        # _try_assign places it anti-affine to the straggling attempt.
        self._accrue_conc(now)  # charge the pre-hedge interval at the old level
        item.hedges += 1
        self.hedged_dispatches += 1
        if self.tracer is not None:
            self.tracer.emit(now, "hedge", item.batch.endpoint,
                             batch=item.batch.trace_id,
                             size=item.batch.size)
        self._enqueue(item, front=True)
        self._try_assign(now)

    def _crash(self, a: _Attempt, now: float) -> None:
        if a.resolved:
            return  # attempt was cancelled/completed before the fault hit
        if a.container.terminated:
            return
        self._accrue_conc(now)
        self.failed_attempts += 1
        self._reclaim_container(a, now, detail="crash")

    def _preempt(self, a: _Attempt, now: float) -> None:
        """Spot-style reclaim: the platform takes the container back
        mid-batch. Same ledger path as a crash (every co-resident attempt
        requeued, nothing lost), but billed to the preemption counters so
        chaos reports can tell lost capacity from reclaimed capacity."""
        if a.resolved:
            return  # attempt was cancelled/completed before the reclaim
        if a.container.terminated:
            return
        self._accrue_conc(now)
        self.preemptions += 1
        self.preempted_attempts += self._reclaim_container(
            a, now, detail="preempt")

    def _reclaim_container(self, a: _Attempt, now: float,
                           detail: str) -> int:
        """Terminate ``a``'s container mid-service (crash or preemption),
        requeueing every live attempt through the ledger. Returns the
        number of attempts the reclaim cancelled."""
        c = a.container
        if self.tracer is not None:
            self.tracer.emit(now, "fault", a.item.batch.endpoint,
                             batch=a.item.batch.trace_id,
                             size=a.item.batch.size, detail=detail)
        self._mark_terminated(c, now)
        # resolve EVERY live attempt on the dead container — co-resident
        # batches die with it and must be requeued, not leaked
        victims = list(c.attempts)
        for v in victims:
            self._resolve_attempt(v, now, container_dead=True)
        c.inflight = 0
        for v in reversed(victims):  # appendleft keeps oldest-first order
            it = v.item
            if not it.done and not it.queued and not it.live:
                self.requeued_batches += 1
                if self.tracer is not None:
                    self.tracer.emit(now, "retry", it.batch.endpoint,
                                     batch=it.batch.trace_id,
                                     size=it.batch.size, detail="requeue")
                self._enqueue(it, front=True)  # at-least-once re-dispatch
        self._try_assign(now)
        return len(victims)

    def _complete(self, a: _Attempt, now: float) -> None:
        if a.resolved:
            return  # sibling won or container crashed under this attempt
        item = a.item
        self._accrue_conc(now)
        self._resolve_attempt(a, now)
        if item.done:
            # unreachable by construction (winning completion resolves all
            # siblings); counted defensively so a regression is loud
            self.duplicate_completions += 1
        else:
            item.done = True
            # first finisher wins: cancel sibling attempts immediately so
            # their slots free now, not when their stale timers fire
            for sib in list(item.live):
                self._resolve_attempt(sib, now)
                self.cancelled_attempts += 1
            self._mark_dequeued(item)
            self._open.pop(item.item_id, None)
            self.completed_batches += 1
            self.completed_requests += item.batch.size
            item.batch.attempts = item.attempts
            if self.tracer is not None:
                self.tracer.emit(now, "completed", item.batch.endpoint,
                                 batch=item.batch.trace_id,
                                 size=item.batch.size,
                                 value=now - item.submit_time)
            self.on_batch_done(item.batch, now - item.submit_time, now)
        self._try_assign(now)

    # --------------------------------------------------------------- metrics
    def register_metrics(self, registry, prefix: str = "platform") -> None:
        """Bind the platform's lifetime ledger into a MetricsRegistry."""
        b = registry.bind
        b(f"{prefix}.submitted_batches", lambda: self.submitted_batches)
        b(f"{prefix}.submitted_requests", lambda: self.submitted_requests)
        b(f"{prefix}.completed_batches", lambda: self.completed_batches)
        b(f"{prefix}.completed_requests", lambda: self.completed_requests)
        b(f"{prefix}.failed_attempts", lambda: self.failed_attempts)
        b(f"{prefix}.preemptions", lambda: self.preemptions)
        b(f"{prefix}.preempted_attempts", lambda: self.preempted_attempts)
        b(f"{prefix}.requeued_batches", lambda: self.requeued_batches)
        b(f"{prefix}.hedged_dispatches", lambda: self.hedged_dispatches)
        b(f"{prefix}.cancelled_attempts", lambda: self.cancelled_attempts)
        b(f"{prefix}.duplicate_completions",
          lambda: self.duplicate_completions)
        b(f"{prefix}.cold_starts", lambda: self.cold_starts)
        b(f"{prefix}.peak_containers", lambda: self.peak_containers)

    # --------------------------------------------------------- conservation
    def conservation(self) -> dict:
        """Point-in-time conservation ledger.

        Invariants (asserted by :meth:`assert_conserved`): every submitted
        batch is either completed, queued, or in flight (``lost == 0``) and
        no batch ever completes twice (``duplicate_completions == 0``).
        """
        queued = sum(1 for it in self._open.values() if it.queued)
        inflight = sum(
            1 for it in self._open.values() if not it.queued and it.live
        )
        lost = sum(
            1 for it in self._open.values() if not it.queued and not it.live
        )
        return {
            "submitted_batches": self.submitted_batches,
            "submitted_requests": self.submitted_requests,
            "completed_batches": self.completed_batches,
            "completed_requests": self.completed_requests,
            "queued_batches": queued,
            "inflight_batches": inflight,
            "outstanding_batches": len(self._open),
            "lost_batches": lost,
            "duplicate_completions": self.duplicate_completions,
            "requeued_batches": self.requeued_batches,
            "hedged_dispatches": self.hedged_dispatches,
            "cancelled_attempts": self.cancelled_attempts,
            "failed_attempts": self.failed_attempts,
            "preemptions": self.preemptions,
            "preempted_attempts": self.preempted_attempts,
            "cold_starts": self.cold_starts,
        }

    def assert_conserved(self, require_drained: bool = False) -> dict:
        """Raise ``AssertionError`` if any conservation invariant is broken.

        ``require_drained`` additionally demands that nothing is left
        outstanding — i.e. every submitted request completed exactly once
        (the end-of-run form of the invariant).
        """
        c = self.conservation()

        def trip(reason: str) -> AssertionError:
            # flight-recorder postmortem fires BEFORE the raise so the
            # ring survives even when the caller swallows the error
            if self.recorder is not None:
                self.recorder.dump(f"conservation-{reason}",
                                   now=self._conc_t, extra=c)
            return AssertionError(f"{reason}: {c}")

        if c["lost_batches"] != 0:
            raise trip("lost batches")
        if c["duplicate_completions"] != 0:
            raise trip("duplicate completions")
        accounted = (
            c["completed_batches"] + c["queued_batches"] + c["inflight_batches"]
        )
        if accounted != c["submitted_batches"]:
            raise trip("conservation imbalance")
        if require_drained:
            if c["outstanding_batches"] != 0:
                raise trip("undrained work at end of run")
            if c["completed_requests"] != c["submitted_requests"]:
                raise trip("request count mismatch")
        return c

    # ------------------------------------------------------------ autoscaler
    def _metric_tick(self, now: float) -> None:
        self._accrue_conc(now)
        # prune terminated containers — _scale_to and the crash path still
        # walk this list; without pruning long churny runs leak memory
        if len(self.containers) > 2 * max(self._n_provisioned, 1):
            self.containers = [c for c in self.containers if not c.terminated]
        self._conc_samples.append((now, self._conc_integral))
        cutoff = now - self.config.stable_window - 2 * self.config.metric_tick
        while self._conc_samples and self._conc_samples[0][0] < cutoff:
            self._conc_samples.popleft()
        self.timeline.append(
            (now, self._n_billable, self._n_ready, self._queued_count)
        )
        self.events.push(now + self.config.metric_tick, self._metric_tick)

    def _window_avg(self, now: float, window: float) -> float:
        """Time-weighted average concurrency over the trailing window."""
        if not self._conc_samples:
            return 0.0
        t_end, i_end = self._conc_samples[-1]
        target = now - window
        start: Optional[Tuple[float, float]] = None
        for (t, i) in self._conc_samples:
            if t >= target:
                start = (t, i)
                break
        if start is None:
            # every sample predates the window: the buffer only holds stale
            # history, so report the instantaneous signal instead of the
            # average over the whole (out-of-window) buffer
            return self._concurrency()
        t_start, i_start = start
        if t_end <= t_start:
            return self._concurrency()
        return (i_end - i_start) / (t_end - t_start)

    def _autoscale_tick(self, now: float) -> None:
        cfg = self.config
        per_pod = cfg.container_concurrency * cfg.target_utilization
        stable = self._window_avg(now, cfg.stable_window)
        panic = self._window_avg(now, cfg.panic_window)
        current = self._provisioned_count()

        desired_stable = math.ceil(stable / per_pod) if stable > 0 else 0
        desired_panic = math.ceil(panic / per_pod) if panic > 0 else 0

        if current > 0 and panic >= cfg.panic_threshold * per_pod * current:
            self._panic_until = now + cfg.stable_window
        in_panic = now <= self._panic_until

        desired = max(desired_stable, desired_panic) if in_panic else desired_stable
        if in_panic:
            desired = max(desired, current)  # no scale-down during panic
        # scale-to-zero only after the grace period with no traffic
        if desired == 0 and (now - self._last_traffic) < cfg.scale_to_zero_grace:
            desired = max(1, cfg.min_scale) if self._last_traffic > 0 else cfg.min_scale
        # Knative rate limits (per autoscale tick)
        effective = max(current, 1)
        desired = min(desired, math.ceil(effective * cfg.max_scale_up_rate))
        desired = max(desired, math.floor(effective / cfg.max_scale_down_rate))
        desired = max(cfg.min_scale, min(cfg.max_scale, desired))
        if desired != current:
            self._scale_to(desired, now)
        self.events.push(now + cfg.autoscale_tick, self._autoscale_tick)

    def _scale_to(self, desired: int, now: float) -> None:
        current = self._provisioned_count()
        if desired > current:
            for _ in range(desired - current):
                self._start_container(now)
        elif desired < current:
            # terminate idle containers first, newest first
            victims = sorted(
                (c for c in self.containers if not c.terminated and not c.draining),
                key=lambda c: (c.inflight > 0, -c.ready_at),
            )
            for c in victims[: current - desired]:
                self._terminate(c, now)
        self._try_assign(now)

    # ---------------------------------------------------------------- report
    def reset_billing(self, now: float) -> None:
        """Zero the billing integral (end-of-warmup barrier)."""
        self._accrue_billing(now)
        self.container_seconds = 0.0
        self._billing_last_t = now
        self.peak_containers = self._billable_count()
        self.cold_starts = 0

    def finalize(self, now: float) -> None:
        self._accrue_billing(now)

    @property
    def cost_integral(self) -> float:
        """Billable container-seconds accrued since the last billing reset.

        The platform's cost metric is this *integral* of billable
        (provisioned or draining) containers over time — not a container
        count. :class:`~repro.serverless.tiers.TieredPlatform` applies
        per-tier cost weights on top; the paper's "number of containers"
        figure is this integral / billing window (:meth:`avg_containers`).
        """
        return self.container_seconds

    def avg_containers(self, duration: float) -> float:
        return self.container_seconds / duration if duration > 0 else 0.0
