"""Arrival processes (the paper generates clients with a Poisson process
modulated by real-world traces; §3.1, §3.5).

Two APIs per process:

* ``next_arrival(now, rng)`` — the original scalar protocol: the next
  arrival strictly after ``now``, or ``None`` when the process is done.
* ``next_arrivals(now, rng, horizon)`` — the vectorized protocol: every
  arrival in the half-open window ``(now, now + horizon]`` as one numpy
  array, presampled in blocks. Callers sweep contiguous windows
  (successive calls advance ``now`` by exactly ``horizon``); processes may
  keep internal state across windows (e.g. the MMPP2 modulating chain),
  which :meth:`reset` clears before a fresh run.

The simulator feeds its event loop from ``next_arrivals`` through a cursor
(see ``repro.simulation.simulator._ArrivalPump``), which replaces one RNG
call + one closure per request with one amortized numpy block draw.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.simulation.traces import Trace

_EMPTY = np.empty(0, dtype=np.float64)


def _poisson_window(start: float, end: float, rate: float,
                    rng: np.random.Generator) -> np.ndarray:
    """All homogeneous-Poisson arrivals in ``(start, end]`` at ``rate``.

    Draws exponential gaps in blocks sized to the expected count; the
    overshoot draws past ``end`` are discarded (memorylessness makes the
    restart at the next window boundary exact).
    """
    if rate <= 0 or end <= start:
        return _EMPTY
    chunks = []
    t = start
    while True:
        n = max(16, int(rate * (end - t) * 1.2) + 8)
        times = t + np.cumsum(rng.exponential(1.0 / rate, n))
        last = float(times[-1])
        if last > end:
            chunks.append(times[: int(np.searchsorted(times, end, side="right"))])
            break
        chunks.append(times)
        if last == end:
            break
        t = last
    return chunks[0] if len(chunks) == 1 else np.concatenate(chunks)


class ArrivalProcess:
    """Protocol: scalar ``next_arrival`` plus vectorized ``next_arrivals``."""

    def next_arrival(self, now: float, rng: np.random.Generator) -> Optional[float]:
        raise NotImplementedError

    def reset(self) -> None:
        """Clear internal window-sweep state before a fresh run.

        Subclasses with their own state (e.g. :class:`MMPP2`) must call
        ``super().reset()`` or clear everything themselves.
        """
        self._pending = None  # overshoot buffer of the generic fallback

    def next_arrivals(self, now: float, rng: np.random.Generator,
                      horizon: float) -> np.ndarray:
        """Every arrival in ``(now, now + horizon]`` as a float64 array.

        Generic fallback loops the scalar API and buffers the one draw
        that overshoots the window so no arrival is lost between windows;
        subclasses override with true block sampling.
        """
        end = now + horizon
        out = []
        t = getattr(self, "_pending", None)
        if t is not None:
            self._pending = None
            if t > end:
                self._pending = t
                return _EMPTY
            out.append(t)
        else:
            t = now
        while True:
            t = self.next_arrival(out[-1] if out else t, rng)
            if t is None:
                break
            if t > end:
                self._pending = t  # carried into the next window
                break
            out.append(t)
        return np.asarray(out, dtype=np.float64)


@dataclasses.dataclass(slots=True)
class PoissonProcess(ArrivalProcess):
    """Homogeneous Poisson with rate ``rate`` (req/s) over [0, duration)."""

    rate: float
    duration: float

    def next_arrival(self, now: float, rng: np.random.Generator) -> Optional[float]:
        if self.rate <= 0:
            return None
        t = now + rng.exponential(1.0 / self.rate)
        return t if t < self.duration else None

    def next_arrivals(self, now: float, rng: np.random.Generator,
                      horizon: float) -> np.ndarray:
        return _poisson_window(now, min(now + horizon, self.duration),
                               self.rate, rng)


@dataclasses.dataclass(slots=True)
class DeterministicProcess(ArrivalProcess):
    """Fixed inter-arrival gap (tests and worst-case analyses)."""

    gap: float
    duration: float

    def next_arrival(self, now: float, rng: np.random.Generator) -> Optional[float]:
        t = now + self.gap
        return t if t < self.duration else None

    def next_arrivals(self, now: float, rng: np.random.Generator,
                      horizon: float) -> np.ndarray:
        # Arrivals sit on the exact lattice k*gap (k >= 1), computed
        # directly so the sweep is stateless. This matches a scalar chain
        # started at t=0 except at the duration boundary: when duration is
        # an exact multiple of gap, the chain's accumulated rounding can
        # land its last arrival a few ulps below duration, while the
        # lattice correctly excludes k*gap == duration.
        end = min(now + horizon, self.duration)
        k0 = int(np.floor(now / self.gap)) + 1
        while k0 * self.gap <= now:  # strictly after `now`
            k0 += 1
        k1 = int(np.floor(end / self.gap))
        while k1 * self.gap > end:
            k1 -= 1
        if k1 * self.gap >= self.duration:  # duration boundary is exclusive
            k1 -= 1
        if k1 < k0:
            return _EMPTY
        return np.arange(k0, k1 + 1, dtype=np.float64) * self.gap


@dataclasses.dataclass(slots=True)
class TraceModulatedPoisson(ArrivalProcess):
    """Non-homogeneous Poisson via thinning (Lewis & Shedler, 1979).

    λ(t) comes from a :class:`Trace`; proposals are generated at λ_max and
    accepted with probability λ(t)/λ_max — exact for piecewise-constant
    rate profiles and O(1) per proposal. The vectorized path draws the
    proposal gaps and acceptance uniforms in paired blocks and evaluates
    λ(t) for the whole block with one searchsorted.
    """

    trace: Trace

    def next_arrival(self, now: float, rng: np.random.Generator) -> Optional[float]:
        lam_max = self.trace.max_rate
        if lam_max <= 0:
            return None
        t = now
        end = float(self.trace.times[-1])
        while True:
            t = t + rng.exponential(1.0 / lam_max)
            if t >= end:
                return None
            if rng.random() * lam_max <= self.trace.rate_at(t):
                return t

    def next_arrivals(self, now: float, rng: np.random.Generator,
                      horizon: float) -> np.ndarray:
        lam_max = self.trace.max_rate
        if lam_max <= 0:
            return _EMPTY
        end = min(now + horizon, float(self.trace.times[-1]))
        accepted = []
        t = now
        while t < end:
            n = max(16, int(lam_max * (end - t) * 1.2) + 8)
            props = t + np.cumsum(rng.exponential(1.0 / lam_max, n))
            u = rng.random(n)  # paired acceptance draws, same block order
            cut = int(np.searchsorted(props, end, side="right"))
            if cut:
                within = props[:cut]
                keep = u[:cut] * lam_max <= self.trace.rate_at_many(within)
                accepted.append(within[keep])
            last = float(props[-1])
            if last >= end:
                break
            t = last
        if not accepted:
            return _EMPTY
        return accepted[0] if len(accepted) == 1 else np.concatenate(accepted)


@dataclasses.dataclass(slots=True)
class Schedule(ArrivalProcess):
    """Replays an explicit, pre-sampled array of arrival times.

    The shared-workload primitive of the sim↔live bridge: sample any
    stochastic process ONCE with :func:`sample_schedule`, then replay the
    identical arrival instants through the discrete-event simulator and
    the wall-clock runtime (``repro.runtime``), so both worlds serve the
    same trace. Stateless and RNG-free — replaying never consumes draws.
    """

    times: np.ndarray

    def __post_init__(self) -> None:
        self.times = np.sort(np.asarray(self.times, dtype=np.float64))

    @property
    def duration(self) -> float:
        return float(self.times[-1]) if len(self.times) else 0.0

    def next_arrival(self, now: float, rng: np.random.Generator) -> Optional[float]:
        i = int(np.searchsorted(self.times, now, side="right"))
        return float(self.times[i]) if i < len(self.times) else None

    def next_arrivals(self, now: float, rng: np.random.Generator,
                      horizon: float) -> np.ndarray:
        lo = int(np.searchsorted(self.times, now, side="right"))
        hi = int(np.searchsorted(self.times, now + horizon, side="right"))
        return self.times[lo:hi].copy()


def sample_schedule(process: ArrivalProcess, rng, duration: float,
                    horizon: float = 64.0) -> np.ndarray:
    """Materialize every arrival of ``process`` over ``[0, duration)``.

    ``rng`` is a seed or a ``numpy`` Generator. Sweeps contiguous
    fixed-``horizon`` windows of the vectorized API; the draw follows the
    process's distribution exactly, but the concrete instants for a given
    seed differ from a ``Simulator`` run sampling the live process (its
    arrival pump uses adaptive windows, and window boundaries change which
    overshoot draws are discarded). To put the *identical* workload in
    both worlds, sample once with this function and hand the same
    :class:`Schedule` to both — which is what the parity bench does.
    """
    if not isinstance(rng, np.random.Generator):
        rng = np.random.default_rng(rng)
    process.reset()
    chunks = []
    t = 0.0
    while t < duration:
        h = min(horizon, duration - t)
        block = process.next_arrivals(t, rng, h)
        if len(block):
            chunks.append(block)
        t += h
    if not chunks:
        return _EMPTY.copy()
    out = chunks[0] if len(chunks) == 1 else np.concatenate(chunks)
    return out[out < duration]


@dataclasses.dataclass(slots=True)
class MMPP2(ArrivalProcess):
    """2-state Markov-modulated Poisson process (bursty-load stress tests).

    State 0: rate ``rate_lo``; state 1: rate ``rate_hi``; exponential
    sojourn times with means ``mean_lo`` / ``mean_hi``. The modulating
    chain is internal state that persists across windows; :meth:`reset`
    rewinds it for a fresh run.
    """

    rate_lo: float
    rate_hi: float
    mean_lo: float
    mean_hi: float
    duration: float
    _state: int = 0
    _switch_at: Optional[float] = None

    def reset(self) -> None:
        self._state = 0
        self._switch_at = None

    def next_arrival(self, now: float, rng: np.random.Generator) -> Optional[float]:
        t = now
        while True:
            if self._switch_at is None:
                mean = self.mean_lo if self._state == 0 else self.mean_hi
                self._switch_at = t + rng.exponential(mean)
            rate = self.rate_lo if self._state == 0 else self.rate_hi
            if rate <= 0:
                t = self._switch_at
            else:
                cand = t + rng.exponential(1.0 / rate)
                if cand < self._switch_at:
                    return cand if cand < self.duration else None
                t = self._switch_at
            if t >= self.duration:
                return None
            self._state ^= 1
            self._switch_at = None

    def next_arrivals(self, now: float, rng: np.random.Generator,
                      horizon: float) -> np.ndarray:
        end = min(now + horizon, self.duration)
        out = []
        t = now
        while t < end:
            if self._switch_at is None:
                mean = self.mean_lo if self._state == 0 else self.mean_hi
                self._switch_at = t + rng.exponential(mean)
            rate = self.rate_lo if self._state == 0 else self.rate_hi
            seg_end = min(self._switch_at, end)
            if rate > 0:
                seg = _poisson_window(t, seg_end, rate, rng)
                if len(seg):
                    out.append(seg)
            if self._switch_at <= end:
                t = self._switch_at
                self._state ^= 1
                self._switch_at = None
            else:
                t = end
        if not out:
            return _EMPTY
        return out[0] if len(out) == 1 else np.concatenate(out)
