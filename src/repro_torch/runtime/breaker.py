"""Per-endpoint circuit breaker for the live runtime.

Classic three-state machine driven by a *windowed* failure rate over the
last ``window`` dispatch attempts:

* **closed** — normal operation. Every attempt outcome enters the window;
  once it holds at least ``min_samples`` outcomes and the failure
  fraction reaches ``failure_threshold``, the breaker opens.
* **open** — the endpoint is presumed down. Dispatches wait (the server
  parks the batch task on the clock until the probe instant) and
  admission switches to brownout shedding. After ``open_duration``
  seconds the breaker lazily transitions to half-open.
* **half-open** — probe mode: a SINGLE probe attempt goes out (the herd
  of parked batches keeps waiting — with faults, failures surface faster
  than successes, so letting everyone probe at once would let one fast
  failure re-open the breaker before any success lands); ``close_after``
  probe successes close the breaker (window cleared — the outage's
  failures must not instantly re-trip it), any failure re-opens it.

The breaker is **clock-free** (callers pass ``now``) and keeps **no
timer tasks**: the open→half-open transition is computed lazily from
``opened_at + open_duration`` on every query. That makes it trivially
deterministic under :class:`~repro.runtime.clock.FakeClock` and means
``drain(timeout=)`` has no breaker-owned timers to chase — the only
parked sleeper is the batch task itself, which drain already cancels.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, List, Optional, Tuple

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"


@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    """Knobs of one endpoint's circuit breaker."""

    #: Size of the sliding outcome window (count-based, not time-based:
    #: deterministic and O(1) regardless of traffic rate).
    window: int = 20
    #: Minimum outcomes in the window before the breaker may open — a
    #: single early failure must not trip a cold endpoint.
    min_samples: int = 5
    #: Windowed failure fraction at which the breaker opens.
    failure_threshold: float = 0.5
    #: Seconds the breaker stays open before probing (half-open).
    open_duration: float = 5.0
    #: Consecutive half-open successes required to close.
    close_after: int = 1
    #: How often a half-open waiter re-checks for the free probe slot
    #: (the probe's completion time is unknowable in advance, so waiters
    #: poll on the clock at this cadence — deterministic under FakeClock).
    probe_interval: float = 0.1

    def __post_init__(self) -> None:
        if self.window < 1 or self.min_samples < 1:
            raise ValueError("window and min_samples must be >= 1")
        if self.min_samples > self.window:
            raise ValueError(
                f"min_samples ({self.min_samples}) cannot exceed the "
                f"window ({self.window})"
            )
        if not 0.0 < self.failure_threshold <= 1.0:
            raise ValueError(
                f"failure_threshold must be in (0, 1], got "
                f"{self.failure_threshold}"
            )
        if self.open_duration <= 0:
            raise ValueError("open_duration must be > 0")
        if self.close_after < 1:
            raise ValueError("close_after must be >= 1")
        if self.probe_interval <= 0:
            raise ValueError("probe_interval must be > 0")


class CircuitBreaker:
    """Windowed-failure-rate breaker (see module doc for the state machine)."""

    def __init__(self, config: BreakerConfig) -> None:
        self.config = config
        self._outcomes: Deque[bool] = collections.deque(maxlen=config.window)
        self._state = CLOSED
        self._opened_at: Optional[float] = None
        self._half_open_successes = 0
        self._probe_inflight = False
        # lifetime transition counters (stats/reporting)
        self.opened = 0    # closed -> open trips
        self.reopened = 0  # half-open probe failures
        self.closed = 0    # half-open -> closed recoveries
        #: (time, new state) transition log — determinism/debug artifact.
        self.transitions: List[Tuple[float, str]] = []

    # --------------------------------------------------------------- queries
    def _promote(self, now: float) -> None:
        """Lazy open → half-open once the open interval has elapsed."""
        if (self._state == OPEN and self._opened_at is not None
                and now >= self._opened_at + self.config.open_duration):
            self._state = HALF_OPEN
            self._half_open_successes = 0
            self._probe_inflight = False
            self.transitions.append((now, HALF_OPEN))

    def state(self, now: float) -> str:
        self._promote(now)
        return self._state

    def blocked_until(self, now: float) -> Optional[float]:
        """Earliest instant a probe may go out (None = not blocked)."""
        self._promote(now)
        if self._state != OPEN or self._opened_at is None:
            return None
        return self._opened_at + self.config.open_duration

    def failure_rate(self) -> float:
        """Failure fraction of the current outcome window."""
        if not self._outcomes:
            return 0.0
        return sum(self._outcomes) / len(self._outcomes)

    def try_probe(self, now: float) -> bool:
        """Claim the dispatch slot: True = the caller may attempt now.

        Closed state always admits; half-open admits exactly one probe at
        a time (released by the next recorded outcome); open admits
        nothing — callers should wait until :meth:`blocked_until`.
        """
        self._promote(now)
        if self._state == CLOSED:
            return True
        if self._state == HALF_OPEN and not self._probe_inflight:
            self._probe_inflight = True
            return True
        return False

    # --------------------------------------------------------------- updates
    def record_success(self, now: float) -> None:
        self._promote(now)
        self._outcomes.append(False)
        if self._state == HALF_OPEN:
            self._probe_inflight = False
            self._half_open_successes += 1
            if self._half_open_successes >= self.config.close_after:
                self._state = CLOSED
                self._opened_at = None
                # the outage's failures must not instantly re-trip a
                # freshly recovered endpoint
                self._outcomes.clear()
                self.closed += 1
                self.transitions.append((now, CLOSED))

    def record_failure(self, now: float) -> bool:
        """Record one failed attempt; returns True when this failure
        transitioned the breaker into the open state (the caller's cue to
        brownout-shed the endpoint's queue)."""
        self._promote(now)
        self._outcomes.append(True)
        cfg = self.config
        if self._state == HALF_OPEN:
            # probe failed: back to open for another full interval
            self._state = OPEN
            self._opened_at = now
            self._probe_inflight = False
            self.reopened += 1
            self.transitions.append((now, OPEN))
            return True
        if (self._state == CLOSED
                and len(self._outcomes) >= cfg.min_samples
                and self.failure_rate() >= cfg.failure_threshold):
            self._state = OPEN
            self._opened_at = now
            self.opened += 1
            self.transitions.append((now, OPEN))
            return True
        return False

    # ----------------------------------------------------------------- stats
    def register_metrics(self, registry, prefix: str = "breaker") -> None:
        """Bind the lifetime transition counters into a MetricsRegistry."""
        b = registry.bind
        b(f"{prefix}.opened", lambda: self.opened)
        b(f"{prefix}.reopened", lambda: self.reopened)
        b(f"{prefix}.closed", lambda: self.closed)
        b(f"{prefix}.transitions", lambda: len(self.transitions))

    def stats(self, now: float) -> dict:
        return {
            "state": self.state(now),
            "failure_rate": self.failure_rate(),
            "opened": self.opened,
            "reopened": self.reopened,
            "closed": self.closed,
        }
