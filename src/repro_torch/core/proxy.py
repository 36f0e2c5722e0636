"""MLProxy — the adaptive reverse proxy (Smart Proxy + Smart Monitor).

Wires together the three paper components behind the event-driven
:class:`~repro.core.batch_queue.Policy` protocol:

    proxy = MLProxy(config, dispatch_fn=send_upstream)
    proxy.on_request(req, now)             # arrival path (Algorithm 1)
    proxy.on_response(batch, latency, now) # upstream completion → monitor
    proxy.on_timer(now)                    # timeout + AIMD ticks
    proxy.next_event_time(now)             # earliest time on_timer is needed

The queue/dispatch mechanics under the scheduler live in the shared
:class:`~repro.core.batch_queue.BatchQueue` — the same primitive every
baseline in :mod:`repro.core.policies` runs on — so MLProxy differs from
the baselines only in its decision logic (Algorithms 1 + 2).

``dispatch_fn(batch)`` is the only outbound dependency — the simulator sends
the batch to the modeled serverless platform; the real serving path sends it
to the JAX :class:`~repro.serving.engine.InferenceEngine`. Multiple MLProxy
instances (or baselines) are composed behind one
:class:`~repro.core.frontend.ProxyFrontend` for multi-endpoint serving.
"""
from __future__ import annotations

from typing import Callable, List, Optional

from repro_torch.core.batch_queue import ExpireFn
from repro_torch.core.config import ProxyConfig
from repro_torch.core.monitor import SmartMonitor
from repro_torch.core.optimizer import AIMDBatchOptimizer
from repro_torch.core.request import Batch, Request
from repro_torch.core.scheduler import QueueScheduler


class MLProxy:
    """Single-endpoint adaptive batching proxy (the paper's contribution)."""

    def __init__(self, config: ProxyConfig, dispatch_fn: Callable[[Batch], None],
                 expire_fn: Optional[ExpireFn] = None, tracer=None) -> None:
        self.config = config
        self.monitor = SmartMonitor(config.monitor, config.sla)
        self.optimizer = AIMDBatchOptimizer(config.optimizer, config.sla, self.monitor)
        self.scheduler = QueueScheduler(
            config=config,
            monitor=self.monitor,
            dispatch_fn=dispatch_fn,
            max_bs_fn=lambda: self.optimizer.max_bs,
            expire_fn=expire_fn,
            tracer=tracer,
        )
        self._started = False

    # ------------------------------------------------------------------ api
    def on_request(self, request: Request, now: float) -> None:
        if not self._started:
            # anchor the AIMD interval to first traffic
            self.optimizer.maybe_update(now)
            self._started = True
        self.scheduler.on_arrival(request, now)

    def on_response(self, batch: Batch, upstream_latency: float, now: float) -> None:
        """Record a completed upstream batch; completes every member request."""
        # Monitor keys by the *effective* (padded) size on bucketed backends:
        # that is the size whose latency the next dispatch decision must
        # predict.
        self.monitor.record_upstream(batch.effective_size, upstream_latency, now,
                                     attempts=batch.attempts)
        batch.complete(now)
        for r in batch.requests:
            assert r.e2e_latency is not None
            self.monitor.record_e2e(r.e2e_latency, now)

    def on_timer(self, now: float) -> None:
        self.scheduler.on_timer(now)
        self.optimizer.maybe_update(now)

    def next_event_time(self, now: float) -> Optional[float]:
        """Earliest future time at which :meth:`on_timer` must run.

        Merges the dispatch deadline, the earliest queued-request expiry,
        and the AIMD update tick."""
        deadline = self.scheduler.queue.next_event_time()
        if not self._started:
            return deadline
        update = self.optimizer.next_update_time(now)
        if deadline is None or update < deadline:
            return update
        return deadline

    def expire(self, now: float) -> List[Request]:
        """Evict deadline-expired queued requests (O(1) when none)."""
        return self.scheduler.queue.expire(now)

    def shed(self, now: float, keep: int) -> List[Request]:
        """Evict queued requests beyond ``keep``, lowest slack first."""
        return self.scheduler.queue.shed(now, keep)

    def flush(self, now: float) -> None:
        self.scheduler.flush(now)

    # --------------------------------------------------------------- metrics
    @property
    def max_bs(self) -> int:
        return self.optimizer.max_bs

    @property
    def queue_len(self) -> int:
        return self.scheduler.queue_len

    def stats(self, now: float) -> dict:
        # One canonical key set for every policy — see BatchQueue.stats.
        return self.scheduler.queue.stats(
            self.monitor, now,
            max_bs=self.optimizer.max_bs,
            max_bs_raw=self.optimizer.max_bs_raw)

    # ------------------------------------------------------ fault tolerance
    def snapshot(self) -> dict:
        """Serializable control-plane state (crash/restart resumes warm)."""
        return {
            "monitor": self.monitor.snapshot(),
            "optimizer": self.optimizer.snapshot(),
            "scheduler": self.scheduler.snapshot(),
            "started": self._started,
        }

    def restore(self, state: dict) -> None:
        self.monitor.restore(state["monitor"])
        self.optimizer.restore(state["optimizer"])
        self.scheduler.restore(state["scheduler"])
        self._started = state["started"]
