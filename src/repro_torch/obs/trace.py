"""Ring-buffered lifecycle span tracer.

The tracer records flat events; span *trees* are reconstructed offline
by :mod:`repro.obs.export`. Keeping the hot path to "build one tuple,
append to a deque" is what makes the ≤10% tracing-on overhead budget on
``bench_proxy_overhead`` reachable, and keeping events as plain tuples
(not objects) keeps the ring cache-friendly at six-figure capacities.

Events are 8-tuples indexed by the ``EV_*`` constants:

    (t, kind, endpoint, req_id, batch, size, value, detail)

- ``t`` comes from whatever clock the caller holds (sim time or
  ``Clock.now()``) — the tracer itself never reads a wall clock, so a
  ``FakeClock`` run produces byte-identical event streams across runs.
- ``req_id``/``batch`` are -1 when the event is not request- or
  batch-scoped. Batch ids are handed out by :meth:`Tracer.next_batch_id`
  and stamped onto ``Batch.trace_id`` at dispatch, which is how retry /
  hedge / completion events in the drivers correlate back to the
  ``dispatched`` event and its ``batched`` membership event.
- ``batched`` is the one columnar kind: ONE event per dispatched batch
  whose req slot holds the *tuple* of member request ids and whose
  value slot holds the matching tuple of member arrival (queue-entry)
  times. Per-member events would dominate the tracing-on overhead
  budget — the ring retention is the measured cost — so membership is
  packed into two tuples per batch instead.
- ``value`` elsewhere carries an optional float payload (backoff
  seconds on ``retry``, wait seconds on ``breaker_wait``, latency on
  terminal events, and — on ``expired``/``shed`` — the request's
  queue-entry ``arrival_time``, which is how exporters anchor the
  queue-wait span without a per-arrival hot-path event); ``detail``
  carries a short string (dispatch cause, fault kind, error type).

The request lifecycle, as kinds:

    admitted -> expired | shed | batched   (queue entry in ev value)
    batched  -> (per batch) dispatched -> (attempt | fault | retry |
                 hedge | breaker_wait)* -> completed | timed_out | failed

plus ``rejected`` for admission-control drops that never reach a queue
and ``breaker_open`` for circuit transitions.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, List, Tuple, Union

# Tuple field indices (events are plain tuples for speed).
EV_T = 0
EV_KIND = 1
EV_ENDPOINT = 2
EV_REQ = 3
EV_BATCH = 4
EV_SIZE = 5
EV_VALUE = 6
EV_DETAIL = 7

# req/value slots are scalars everywhere except the columnar "batched"
# kind, where they hold the member-id / member-arrival tuples.
TraceTuple = Tuple[float, str, str, Union[int, Tuple[int, ...]], int, int,
                   Union[float, Tuple[float, ...]], str]

#: Every kind the instrumented modules emit, in rough lifecycle order.
SPAN_KINDS = (
    "admitted",      # frontend accepted the request (deadline attached)
    "rejected",      # admission control turned the request away
    "expired",       # dead on queue: deadline passed before dispatch
    "shed",          # dropped by load shedding / brownout
    "batched",       # batch membership: member ids in req slot (tuple),
                     # member arrival times in value slot (tuple)
    "dispatched",    # batch handed to the dispatch_fn (cause in detail)
    "routed",        # SpilloverRouter picked a fleet tier for the batch
                     # (detail = "tier:reason", e.g. "fast:inflight_cap")
    "attempt",       # platform/target attempt started
    "fault",         # injected or upstream fault (kind in detail)
    "retry",         # driver re-submitting a failed batch (backoff in value)
    "hedge",         # speculative duplicate dispatch
    "breaker_wait",  # batch held at an open circuit (wait secs in value)
    "breaker_open",  # circuit transitioned to open
    "completed",     # batch finished; requests resolved
    "timed_out",     # batch resolved past its deadline
    "failed",        # batch exhausted retries / cancelled at drain
)


class Tracer:
    """Bounded ring of lifecycle events.

    ``capacity`` bounds memory; once full, the oldest events are evicted
    (``dropped`` counts evictions so exporters can flag truncation).

    ``buf`` is deliberately public: the per-request emission site on the
    proxy decision path (``BatchQueue._dispatch``) inlines the append
    instead of calling :meth:`emit` — one Python call per request is
    what separates passing and failing the ≤10% overhead gate. The
    inlined form must stay semantically identical to :meth:`emit`::

        buf = tracer.buf
        if len(buf) == tracer.capacity:
            tracer.dropped += 1
        buf.append((t, kind, endpoint, req_id, batch, size, value, detail))
    """

    __slots__ = ("capacity", "dropped", "buf", "_batch_seq")

    def __init__(self, capacity: int = 1 << 16) -> None:
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self.dropped = 0
        self.buf: Deque[TraceTuple] = deque(maxlen=capacity)
        self._batch_seq = 0

    # ------------------------------------------------------------- hot path
    def emit(self, t: float, kind: str, endpoint: str = "",
             req_id: int = -1, batch: int = -1, size: int = 0,
             value: float = 0.0, detail: str = "") -> None:
        buf = self.buf
        if len(buf) == self.capacity:
            self.dropped += 1
        buf.append((t, kind, endpoint, req_id, batch, size, value, detail))

    def next_batch_id(self) -> int:
        """Monotonic id stamped on ``Batch.trace_id`` at dispatch."""
        self._batch_seq += 1
        return self._batch_seq

    # ------------------------------------------------------------- reading
    def __len__(self) -> int:
        return len(self.buf)

    def events(self) -> List[TraceTuple]:
        return list(self.buf)

    def clear(self) -> None:
        self.buf.clear()
        self.dropped = 0
        self._batch_seq = 0


def serialize_events(events: List[TraceTuple]) -> bytes:
    """Canonical byte encoding of an event stream.

    Used by determinism tests: two FakeClock runs with the same seed
    must serialize to identical bytes. ``repr`` of floats is exact
    (shortest round-trip representation), so this is a faithful canonical
    form, not a lossy pretty-print.
    """
    return "\n".join(repr(ev) for ev in events).encode()
