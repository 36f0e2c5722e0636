"""Request / batch data types shared by the proxy, simulator and engine."""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, List, Optional

_req_counter = itertools.count()


def _next_req_id() -> int:
    return next(_req_counter)


def reset_request_ids() -> None:
    """Restart the process-global request-id sequence (test seam).

    Request ids record allocation order, not randomness: without a reset,
    two same-seed runs in one process draw disjoint id ranges, which is
    the one thing standing between their span logs and byte-identity.
    Never call this while requests from a previous run are still live.
    """
    global _req_counter
    _req_counter = itertools.count()


@dataclasses.dataclass(slots=True)
class Request:
    """One inference request as seen by the proxy.

    ``slots=True``: requests are created once per simulated arrival — on
    million-request runs the per-instance dict is measurable in both time
    and memory on the event-core hot path.
    """

    arrival_time: float
    payload: Any = None
    req_id: int = dataclasses.field(default_factory=_next_req_id)
    # Routing key used by the multi-endpoint frontend (None on the
    # single-endpoint path).
    endpoint: Optional[str] = None
    # Absolute completion deadline (same clock as ``arrival_time``).
    # Client-supplied, or derived at admission from the endpoint's
    # ``SLAConfig.deadline_factor``; ``None`` = no deadline. A request
    # still queued past its deadline is evicted by the BatchQueue expiry
    # sweep and ends in the ``timed_out`` terminal state.
    deadline: Optional[float] = None
    timed_out: bool = False
    # Filled in on completion:
    dispatch_time: Optional[float] = None
    completion_time: Optional[float] = None

    @property
    def e2e_latency(self) -> Optional[float]:
        if self.completion_time is None:
            return None
        return self.completion_time - self.arrival_time

    @property
    def queue_time(self) -> Optional[float]:
        if self.dispatch_time is None:
            return None
        return self.dispatch_time - self.arrival_time

    def remaining_budget(self, now: float) -> Optional[float]:
        """Seconds until the deadline (negative if past); None if no deadline."""
        if self.deadline is None:
            return None
        return self.deadline - now


@dataclasses.dataclass(slots=True)
class Batch:
    """A dispatched batch of requests."""

    requests: List[Request]
    dispatch_time: float
    cause: str  # 'full' | 'timeout' | 'flush'
    bucket_size: Optional[int] = None  # padded size on fixed-shape backends
    # Stamped by the frontend so shared dispatch targets (and shared
    # platforms) know which endpoint's model a batch belongs to.
    endpoint: Optional[str] = None
    # Fleet tier chosen by the SpilloverRouter at dispatch time (None on
    # single-fleet paths). TieredPlatform / TieredTarget use it to pick
    # the per-tier backend; EndpointRoutedLatency keys on it too.
    tier: Optional[str] = None
    # Stamped by the platform on completion: how many dispatch attempts
    # (crash retries + hedges) this batch took before it finished. The
    # monitor uses it for retry-aware upstream statistics.
    attempts: int = 1
    # Span id stamped by a tracing BatchQueue at dispatch (-1 = untraced);
    # correlates retry/hedge/terminal events in the drivers back to the
    # ``dispatched`` event and its member ``batched`` events.
    trace_id: int = -1

    @property
    def size(self) -> int:
        return len(self.requests)

    @property
    def effective_size(self) -> int:
        return self.bucket_size if self.bucket_size is not None else self.size

    @property
    def oldest_arrival(self) -> float:
        return min(r.arrival_time for r in self.requests)

    @property
    def tightest_deadline(self) -> Optional[float]:
        """Earliest member deadline — what the dispatch path propagates
        upstream (None when no member carries a deadline)."""
        deadline: Optional[float] = None
        for r in self.requests:
            if r.deadline is not None and (deadline is None or r.deadline < deadline):
                deadline = r.deadline
        return deadline

    def complete(self, completion_time: float) -> None:
        for r in self.requests:
            r.completion_time = completion_time
