"""Clock seam for the wall-clock serving runtime.

Everything in :mod:`repro.runtime` tells time through a :class:`Clock`
instead of calling ``time``/``asyncio.sleep`` directly, which gives the
runtime two interchangeable time sources:

* :class:`WallClock` — real time. ``now()`` is a monotonic offset from
  construction (so runtime timestamps start near 0.0 like simulator time)
  and ``sleep``/``wait`` are plain asyncio primitives.
* :class:`FakeClock` — deterministic virtual time for tests and the
  sim↔live parity bench. Sleeping tasks park on a heap of
  ``(wake_time, seq, future)``; :meth:`FakeClock.run_until` advances
  virtual time only when the event loop has fully settled (no runnable
  task), then wakes the earliest sleeper. Same seed + same trace →
  bit-identical execution order, which is what makes the runtime's
  dispatch-decision log replayable (see ``tests/test_runtime.py``).

The protocol is intentionally tiny — ``now``, ``sleep``, ``wait`` (event
with timeout), ``run_until`` (drive a coroutine to completion) — so any
other source (e.g. a scaled-time clock for accelerated soak tests) can
slot in.
"""
from __future__ import annotations

import asyncio
import heapq
import itertools
import time
from typing import Any, Awaitable, Coroutine, List, Optional, Tuple


class Clock:
    """Protocol: monotonic ``now()`` plus async ``sleep``/``wait``."""

    def now(self) -> float:
        raise NotImplementedError

    async def sleep(self, seconds: float) -> None:
        raise NotImplementedError

    async def wait(self, event: asyncio.Event, timeout: Optional[float]) -> bool:
        """Wait until ``event`` is set or ``timeout`` elapses.

        Returns True if the event was set, False on timeout. ``None``
        timeout waits indefinitely.
        """
        raise NotImplementedError

    async def run_until(self, aw: Awaitable) -> Any:
        """Drive ``aw`` to completion under this clock; returns its result."""
        raise NotImplementedError


class WallClock(Clock):
    """Real time, zeroed at construction."""

    def __init__(self) -> None:
        self._t0 = time.monotonic()  # reprolint: disable=wallclock

    def now(self) -> float:
        return time.monotonic() - self._t0  # reprolint: disable=wallclock

    async def sleep(self, seconds: float) -> None:
        await asyncio.sleep(max(0.0, seconds))

    async def wait(self, event: asyncio.Event, timeout: Optional[float]) -> bool:
        if timeout is None:
            await event.wait()
            return True
        try:
            await asyncio.wait_for(event.wait(), max(0.0, timeout))
            return True
        except asyncio.TimeoutError:
            return False

    async def run_until(self, aw: Awaitable) -> Any:
        return await aw


class FakeClock(Clock):
    """Deterministic virtual time driven by :meth:`run_until`.

    Tasks that ``await clock.sleep(dt)`` park a future on a heap keyed by
    ``(wake_time, seq)``; the driver advances ``now`` to the earliest
    pending wake time only once the event loop is idle (every task blocked
    on a future), then resolves that one sleeper and lets the loop settle
    again. Ties fire in sleep order and asyncio's ready queue is FIFO, so
    runs are bit-for-bit repeatable.
    """

    # Safety bound on settle iterations: a genuine ping-pong livelock
    # (two tasks re-scheduling each other forever without blocking)
    # should fail loudly rather than hang the test suite.
    MAX_SETTLE = 100_000

    def __init__(self, start: float = 0.0) -> None:
        self._now = start
        self._heap: List[Tuple[float, int, asyncio.Future]] = []
        self._seq = itertools.count()

    def now(self) -> float:
        return self._now

    async def sleep(self, seconds: float) -> None:
        if seconds <= 0:
            await asyncio.sleep(0)
            return
        fut = asyncio.get_running_loop().create_future()
        heapq.heappush(self._heap, (self._now + seconds, next(self._seq), fut))
        await fut

    async def wait(self, event: asyncio.Event, timeout: Optional[float]) -> bool:
        if timeout is None:
            await event.wait()
            return True
        if event.is_set():
            return True
        sleeper = asyncio.ensure_future(self.sleep(timeout))
        waiter = asyncio.ensure_future(event.wait())
        done, pending = await asyncio.wait(
            {sleeper, waiter}, return_when=asyncio.FIRST_COMPLETED
        )
        for p in pending:
            p.cancel()
        for p in pending:
            try:
                await p
            except asyncio.CancelledError:
                pass
        return event.is_set()

    async def _settle(self) -> None:
        """Yield until the event loop has no immediately-runnable callback.

        Relies on CPython's ``loop._ready`` deque when available: after our
        own ``sleep(0)`` resumes, an empty ready queue means every other
        task is blocked on a future, so it is safe to advance time. Falls
        back to a fixed number of yields on loops without ``_ready``.
        """
        loop = asyncio.get_running_loop()
        ready = getattr(loop, "_ready", None)
        if ready is None:
            for _ in range(64):
                await asyncio.sleep(0)
            return
        for _ in range(self.MAX_SETTLE):
            if not ready:
                return
            await asyncio.sleep(0)
        raise RuntimeError(
            "FakeClock: event loop never went idle (runnable-task livelock?)"
        )

    async def run_until(self, aw: Awaitable) -> Any:
        task = asyncio.ensure_future(aw)
        heap = self._heap
        while True:
            await self._settle()
            if task.done():
                break
            while heap and heap[0][2].done():  # cancelled/stale sleepers
                heapq.heappop(heap)
            if not heap:
                raise RuntimeError(
                    "FakeClock deadlock: tasks pending but no timer to advance"
                )
            t, _, fut = heapq.heappop(heap)
            if t > self._now:
                self._now = t
            fut.set_result(None)
        return task.result()


def run(clock: Clock, main: Coroutine) -> Any:
    """Run ``main`` to completion under ``clock`` in a fresh event loop."""
    return asyncio.run(clock.run_until(main))
