"""Batching policies: MLProxy plus the baselines it is compared against.

Every policy implements the formal :class:`~repro.core.batch_queue.Policy`
protocol (`on_request`, `on_response`, `on_timer`, `next_event_time`,
`flush`, `stats`, `snapshot`/`restore`, `max_bs`), so the simulator, the
serving engine, and the multi-endpoint
:class:`~repro.core.frontend.ProxyFrontend` can swap them freely.

All queue/dispatch mechanics (pending FIFO, first-arrival anchor, deadline,
bucketing, counters, snapshot of that state) live in the one shared
:class:`~repro.core.batch_queue.BatchQueue`; each policy here contributes
only its decision logic — a target batch size and a queue timeout:

* ``PassthroughPolicy`` — the paper's "MLProxy off" baseline: every request
  is forwarded upstream immediately as a batch of one (what a stock API
  gateway does).
* ``StaticBatchPolicy`` — fixed max batch size + fixed queue timeout
  (what naive middleware does; no SLA awareness).
* ``ClipperAIMDPolicy`` — Clipper-style adaptive batching (Crankshaw et al.,
  NSDI'17): AIMD directly on the batch size driven only by whether the
  latency SLO was met, with a fixed small queue timeout.
* ``OracleStaticPolicy`` — BATCH-style profiled baseline (Ali et al.,
  SC'20): given an offline-profiled latency curve, pick the largest batch
  size whose predicted latency fits under the SLO and derive the timeout
  from the leftover budget. Requires prior profiling — exactly the
  requirement MLProxy removes.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

from repro_torch.core.batch_queue import BatchQueue, ExpireFn
from repro_torch.core.config import (MonitorConfig, ProxyConfig, SLAConfig,
                               bucket_of, validate_buckets)
from repro_torch.core.monitor import SmartMonitor
from repro_torch.core.proxy import MLProxy
from repro_torch.core.request import Batch, Request

#: Default batch-size ceiling of the cap-carrying baselines (clipper /
#: oracle). Module-level so config-time reconciliation against engine
#: buckets (``runtime.server.clamp_policy_kwargs``) can tell "policy
#: default" apart from "caller choice" without signature introspection.
DEFAULT_MAX_CAP = 256


class BatchingPolicy:
    """Decision logic + shared :class:`BatchQueue` for non-MLProxy policies.

    ``pack_buckets`` (the engine's ``batch_buckets``) turns on bucket-aware
    packing: the full-trigger threshold rounds the policy's target up to
    the next bucket edge and dispatches exactly at it, so "full" batches
    execute with zero padding. Latency within a bucket is the padded
    bucket's latency (the monitor keys by it), so the extra requests ride
    in slots that would otherwise be padding. Timeout/flush dispatches
    still flush the whole queue — SLA pressure beats packing efficiency.
    Setting ``pack_buckets`` without ``bucketing`` implies
    ``bucketing = pack_buckets``.
    """

    def __init__(self, sla: SLAConfig, dispatch_fn: Callable[[Batch], None],
                 monitor_config: Optional[MonitorConfig] = None,
                 bucketing=None,
                 expire_fn: Optional[ExpireFn] = None,
                 pack_buckets: Optional[Sequence[int]] = None,
                 tracer=None) -> None:
        self.sla = sla
        if pack_buckets is not None:
            pack_buckets = validate_buckets(pack_buckets, "pack_buckets")
            if bucketing is None:
                bucketing = pack_buckets
        self.pack_buckets = pack_buckets
        self.monitor = SmartMonitor(monitor_config or MonitorConfig(), sla)
        self.queue = BatchQueue(dispatch_fn, self.monitor, bucketing=bucketing,
                                expire_fn=expire_fn, tracer=tracer)

    # -------- subclass interface ------------------------------------------
    def target_batch_size(self, now: float) -> int:
        raise NotImplementedError

    def queue_timeout(self, now: float) -> Optional[float]:
        """Relative timeout measured from first-request arrival, or None."""
        raise NotImplementedError

    # -------- shared machinery --------------------------------------------
    @property
    def queue_len(self) -> int:
        return self.queue.queue_len

    @property
    def next_deadline(self) -> Optional[float]:
        return self.queue.next_deadline

    @property
    def dispatched_batches(self) -> int:
        return self.queue.dispatched_batches

    @property
    def dispatched_requests(self) -> int:
        return self.queue.dispatched_requests

    def packed_target(self, now: float) -> int:
        """Full-trigger threshold: the raw target, rounded up to the next
        bucket edge when packing is on (clamped to the largest bucket)."""
        target = max(1, self.target_batch_size(now))
        if self.pack_buckets is not None:
            target = bucket_of(target, self.pack_buckets)
        return target

    def on_request(self, request: Request, now: float) -> None:
        self.queue.expire(now)  # evict dead requests before sizing the batch
        self.queue.append(request, now)
        if self.pack_buckets is None:
            if self.queue.queue_len >= max(1, self.target_batch_size(now)):
                self.queue._dispatch(now, "full")
                return
        else:
            # packed full-trigger: dispatch exactly at the bucket edge;
            # any backlog beyond it (e.g. after restore) stays queued and
            # falls through to re-arm the timeout below
            target = self.packed_target(now)
            while self.queue.queue_len >= target:
                if self.queue._dispatch(now, "full", limit=target) is None:
                    break
                target = self.packed_target(now)
            if not self.queue.queue_len:
                return
        to = self.queue_timeout(now)
        if to is None:
            self.queue.next_deadline = None
        else:
            # anchor on the oldest queued request (frt handles the
            # first_arrival == 0.0 case an `or now` fallback would drop)
            deadline = (now - self.queue.frt(now)) + to
            if deadline <= now:
                self.queue._dispatch(now, "timeout")
            else:
                self.queue.next_deadline = deadline

    def on_timer(self, now: float) -> None:
        # Expiry first: the merged timer also wakes for request expiries,
        # which must never be batched into the timeout dispatch below.
        self.queue.expire(now)
        if self.queue.next_deadline is not None and now + 1e-12 >= self.queue.next_deadline:
            if self.queue.queue_len:
                self.queue._dispatch(now, "timeout")
            else:
                self.queue.next_deadline = None

    def on_response(self, batch: Batch, upstream_latency: float, now: float) -> None:
        self.monitor.record_upstream(batch.effective_size, upstream_latency, now,
                                     attempts=batch.attempts)
        batch.complete(now)
        for r in batch.requests:
            self.monitor.record_e2e(r.e2e_latency, now)

    def expire(self, now: float) -> List[Request]:
        """Evict deadline-expired queued requests (O(1) when none)."""
        return self.queue.expire(now)

    def shed(self, now: float, keep: int) -> List[Request]:
        """Evict queued requests beyond ``keep``, lowest slack first."""
        return self.queue.shed(now, keep)

    def next_event_time(self, now: float) -> Optional[float]:
        # dispatch deadline merged with the earliest request expiry
        return self.queue.next_event_time()

    def flush(self, now: float) -> None:
        if self.queue.queue_len:
            self.queue._dispatch(now, "flush")

    @property
    def max_bs(self) -> int:
        return self.target_batch_size(0.0)

    def stats(self, now: float) -> dict:
        # One canonical key set for every policy — see BatchQueue.stats.
        # Baselines have no AIMD fractional state, so raw == effective.
        target = self.target_batch_size(now)
        return self.queue.stats(self.monitor, now,
                                max_bs=target, max_bs_raw=float(target))

    def snapshot(self) -> dict:
        return {
            "monitor": self.monitor.snapshot(),
            "queue": self.queue.snapshot(),
        }

    def restore(self, state: dict) -> None:
        self.monitor.restore(state["monitor"])
        if "counts" in state:  # pre-BatchQueue snapshot layout
            self.queue.restore({
                "queue": state["queue"],
                "first_arrival": state["first_arrival"],
                "next_deadline": state["next_deadline"],
                "dispatched_batches": state["counts"][0],
                "dispatched_requests": state["counts"][1],
            })
        else:
            self.queue.restore(state["queue"])


class PassthroughPolicy(BatchingPolicy):
    """No batching: forward every request immediately (stock API gateway)."""

    def target_batch_size(self, now: float) -> int:
        return 1

    def queue_timeout(self, now: float) -> Optional[float]:
        return 0.0


class StaticBatchPolicy(BatchingPolicy):
    """Fixed batch size and fixed queue timeout."""

    def __init__(self, sla, dispatch_fn, batch_size: int, timeout: float, **kw) -> None:
        super().__init__(sla, dispatch_fn, **kw)
        self._bs = batch_size
        self._to = timeout

    def target_batch_size(self, now: float) -> int:
        return self._bs

    def queue_timeout(self, now: float) -> Optional[float]:
        return self._to


class ClipperAIMDPolicy(BatchingPolicy):
    """Clipper-style AIMD: grow batch size additively while the windowed
    latency percentile meets the SLO; back off multiplicatively otherwise.
    The queue timeout is a fixed fraction of the SLO budget."""

    def __init__(self, sla, dispatch_fn, inc: int = 1, dec_mult: float = 0.9,
                 update_interval: float = 10.0, timeout_frac: float = 0.25,
                 max_cap: int = DEFAULT_MAX_CAP, **kw) -> None:
        super().__init__(sla, dispatch_fn, **kw)
        self.inc = inc
        self.dec_mult = dec_mult
        self.update_interval = update_interval
        self.timeout_frac = timeout_frac
        self.max_cap = max_cap
        self._bs = 1.0
        self._last_update: Optional[float] = None

    def target_batch_size(self, now: float) -> int:
        return max(1, min(self.max_cap, int(self._bs)))

    def queue_timeout(self, now: float) -> Optional[float]:
        return self.sla.slo_target * self.timeout_frac

    def on_timer(self, now: float) -> None:
        super().on_timer(now)
        if self._last_update is None:
            self._last_update = now
            return
        # epsilon tolerance: without it a timer that fires a float-ulp
        # before the interval boundary never advances _last_update while
        # next_event_time keeps returning the same instant (spin)
        if now - self._last_update >= self.update_interval - 1e-9:
            p = self.monitor.e2e_percentile(now)
            if p is not None and p > self.sla.slo_target:
                self._bs = max(1.0, self._bs * self.dec_mult)
            else:
                self._bs = min(float(self.max_cap), self._bs + self.inc)
            self._last_update = now

    def next_event_time(self, now: float) -> Optional[float]:
        nxt = (self._last_update + self.update_interval
               if self._last_update is not None
               else now + self.update_interval)
        queue_next = self.queue.next_event_time()
        if queue_next is not None:
            return min(queue_next, nxt)
        return nxt

    def snapshot(self) -> dict:
        state = super().snapshot()
        state["aimd"] = (self._bs, self._last_update)
        return state

    def restore(self, state: dict) -> None:
        super().restore(state)
        if "aimd" in state:
            self._bs, self._last_update = state["aimd"]


class OracleStaticPolicy(BatchingPolicy):
    """BATCH-style profiled baseline: requires an offline latency model
    ``latency_model(bs) -> p95 seconds`` (the profiling step MLProxy
    removes) and solves for the largest SLO-feasible batch size."""

    def __init__(self, sla, dispatch_fn, latency_model: Callable[[int], float],
                 headroom: float = 0.9, max_cap: int = DEFAULT_MAX_CAP,
                 **kw) -> None:
        super().__init__(sla, dispatch_fn, **kw)
        self.latency_model = latency_model
        budget = sla.slo_target * headroom
        bs = 1
        for cand in range(1, max_cap + 1):
            if latency_model(cand) <= budget:
                bs = cand
            else:
                break
        self._bs = bs
        self._to = max(0.0, budget - latency_model(bs))

    def target_batch_size(self, now: float) -> int:
        return self._bs

    def queue_timeout(self, now: float) -> Optional[float]:
        return self._to


def make_policy(name: str, sla: SLAConfig, dispatch_fn,
                expire_fn: Optional[ExpireFn] = None, tracer=None, **kwargs):
    """Factory used by the simulator, the frontend, and benchmarks.

    ``expire_fn(requests, now)`` (optional) is invoked by the policy's
    queue whenever the expiry sweep evicts already-dead requests.
    ``tracer`` (optional :class:`repro.obs.trace.Tracer`) turns on
    lifecycle span emission in the policy's queue.
    """
    if name == "mlproxy":
        proxy_cfg = kwargs.pop("proxy_config", None) or ProxyConfig(sla=sla, **kwargs)
        return MLProxy(proxy_cfg, dispatch_fn, expire_fn=expire_fn,
                       tracer=tracer)
    if name == "passthrough":
        return PassthroughPolicy(sla, dispatch_fn, expire_fn=expire_fn,
                                 tracer=tracer, **kwargs)
    if name == "static":
        return StaticBatchPolicy(sla, dispatch_fn, expire_fn=expire_fn,
                                 tracer=tracer, **kwargs)
    if name == "clipper":
        return ClipperAIMDPolicy(sla, dispatch_fn, expire_fn=expire_fn,
                                 tracer=tracer, **kwargs)
    if name == "oracle":
        return OracleStaticPolicy(sla, dispatch_fn, expire_fn=expire_fn,
                                  tracer=tracer, **kwargs)
    raise ValueError(f"unknown policy {name!r}")
