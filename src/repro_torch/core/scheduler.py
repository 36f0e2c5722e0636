"""Algorithm 1 — the high-frequency queue scheduler.

Event-driven implementation of the paper's queue scheduler: on every arrival
the dispatch timeout is recomputed from the monitor's latency estimate for a
batch one larger than the current queue,

    DTO = SLO_T − RT_p95[N_q + 1]
    TO  = DTO − FRT        (FRT = age of the oldest queued request)

and the batch is dispatched when (a) it reaches ``Max_BS``, (b) the timeout
fires, or (c) ``TO ≤ 0`` at recomputation time (the paper's "negative DTO →
dispatch immediately" rule, which also covers negative DTO).

The queue/dispatch mechanics (FIFO, FRT anchor, bucketing, counters,
snapshot) live in the shared :class:`~repro.core.batch_queue.BatchQueue`;
this module holds only the Algorithm-1 decision logic on top of it.

The scheduler is clock-free: callers pass ``now`` into every method, and read
``next_deadline`` to know when to call :meth:`on_timer`. This makes the same
object usable from the discrete-event simulator and from a wall-clock loop.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.core.batch_queue import BatchQueue, DispatchFn, ExpireFn
from repro_torch.core.config import ProxyConfig, bucket_of
from repro_torch.core.monitor import SmartMonitor
from repro_torch.core.request import Request


class QueueScheduler:
    """Single-endpoint batch queue implementing Algorithm 1."""

    def __init__(
        self,
        config: ProxyConfig,
        monitor: SmartMonitor,
        dispatch_fn: DispatchFn,
        max_bs_fn: Callable[[], int],
        expire_fn: Optional[ExpireFn] = None,
        tracer=None,
    ) -> None:
        self.config = config
        self.monitor = monitor
        self.max_bs_fn = max_bs_fn
        self.queue = BatchQueue(dispatch_fn, monitor, bucketing=config.bucketing,
                                expire_fn=expire_fn, tracer=tracer)

    # ------------------------------------------------------------------ api
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

    def on_arrival(self, request: Request, now: float) -> None:
        """Handle one request arrival (lines 5–20 of Algorithm 1)."""
        self.queue.expire(now)  # dead requests must not count toward Max_BS
        if self.queue.queue_len:
            # A pending timeout exists; arrival cancels and recomputes it.
            self.queue.next_deadline = None
        self.queue.append(request, now)

        max_bs = max(1, self.max_bs_fn())
        pack = self.config.pack_buckets
        if pack is None:
            if self.queue.queue_len >= max_bs:
                self.queue._dispatch(now, cause="full")
                return
        else:
            # Bucket-aware packing: round Max_BS up to the next engine
            # bucket edge and dispatch exactly at it — a "full" batch then
            # executes with zero padding, and the monitor's RT95[bucket]
            # keying means the timeout math already prices the edge.
            target = bucket_of(max_bs, pack)
            while self.queue.queue_len >= target:
                if self.queue._dispatch(now, cause="full",
                                        limit=target) is None:
                    break
            if not self.queue.queue_len:
                return

        # DTO = SLO − RT95[N_q + 1]; probing one size larger guards against
        # the latency of the batch after one more arrival (paper eq. 1).
        est = self.monitor.upstream_percentile(self.queue.queue_len + 1, now)
        dto = self.config.sla.slo_target - est - self.config.dispatch_overhead
        to = dto - self.queue.frt(now)
        if to <= 0:
            # Negative timeout: the queue is already at risk → dispatch now.
            self.queue._dispatch(now, cause="timeout")
        else:
            self.queue.next_deadline = now + to

    def on_timer(self, now: float) -> None:
        """Fire the dispatch timeout if due (lines 21–24 of Algorithm 1).

        The expiry sweep runs first: a timer may have been armed for a
        request expiry rather than a dispatch deadline."""
        self.queue.expire(now)
        if self.queue.next_deadline is None or now + 1e-12 < self.queue.next_deadline:
            return
        if self.queue.queue_len:
            self.queue._dispatch(now, cause="timeout")
        else:  # stale timer
            self.queue.next_deadline = None

    def flush(self, now: float) -> None:
        """Dispatch whatever is queued (shutdown / checkpoint barrier)."""
        if self.queue.queue_len:
            self.queue._dispatch(now, cause="flush")

    # ------------------------------------------------------ fault tolerance
    def snapshot(self) -> dict:
        return self.queue.snapshot()

    def restore(self, state: dict) -> None:
        self.queue.restore(state)
