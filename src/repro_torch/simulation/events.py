"""Deterministic discrete-event queue.

Events are ``(time, seq, callback)``; ``seq`` is a monotone tie-breaker so
same-timestamp events fire in insertion order, which keeps runs bit-for-bit
reproducible for a fixed seed.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Callable, Optional

Callback = Callable[[float], None]


class EventQueue:
    __slots__ = ("_heap", "_seq")

    def __init__(self) -> None:
        self._heap = []
        self._seq = itertools.count()

    def push(self, time: float, fn: Callback) -> None:
        if time != time:  # NaN guard
            raise ValueError("event time is NaN")
        heapq.heappush(self._heap, (time, next(self._seq), fn))

    def pop(self):
        time, _, fn = heapq.heappop(self._heap)
        return time, fn

    def peek_time(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
