"""Typed metrics in a central registry.

Three primitive types plus a *bound* metric:

- :class:`Counter` — monotonically increasing int.
- :class:`Gauge` — last-write-wins float (with a high-water helper).
- :class:`Histogram` — fixed-bound bucket counts + sum/count.
- bound metrics (:meth:`MetricsRegistry.bind`) — a zero-cost adapter
  over an existing hand-rolled counter: the owning object keeps its
  plain ``self.x += 1`` hot path and exposes the value to the registry
  through a callable, so migrating the platform/runtime ledgers costs
  nothing on the dispatch path and cannot perturb byte-identical logs.

``snapshot()``/``restore()`` round-trip owned metrics losslessly; bound
metrics are materialized into snapshots but (by design) not restored —
their source of truth is the bound object, which has its own
snapshot/restore path.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

DEFAULT_BOUNDS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                  1.0, 2.5, 5.0, 10.0)


class Counter:
    """Monotonic counter. ``inc`` with a negative amount is an error."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0

    def inc(self, amount: int = 1) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative inc {amount}")
        self.value += amount

    def __repr__(self) -> str:
        return f"Counter({self.name}={self.value})"


class Gauge:
    """Point-in-time value; ``update_max`` keeps a high-water mark."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = value

    def update_max(self, value: float) -> None:
        if value > self.value:
            self.value = value

    def __repr__(self) -> str:
        return f"Gauge({self.name}={self.value})"


class Histogram:
    """Cumulative-style histogram over fixed upper bounds.

    ``counts[i]`` counts observations ``<= bounds[i]``; the final slot
    is the overflow bucket. ``total``/``count`` give the mean for free.
    """

    __slots__ = ("name", "bounds", "counts", "count", "total")

    def __init__(self, name: str,
                 bounds: Sequence[float] = DEFAULT_BOUNDS) -> None:
        if list(bounds) != sorted(bounds):
            raise ValueError(f"histogram {name}: bounds must be sorted")
        self.name = name
        self.bounds = tuple(bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0

    def observe(self, value: float) -> None:
        i = 0
        bounds = self.bounds
        n = len(bounds)
        while i < n and value > bounds[i]:
            i += 1
        self.counts[i] += 1
        self.count += 1
        self.total += value

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def __repr__(self) -> str:
        return f"Histogram({self.name}: n={self.count}, mean={self.mean:.6g})"


class MetricsRegistry:
    """Central name → metric table shared by a proxy/driver instance.

    ``counter``/``gauge``/``histogram`` are get-or-create (idempotent,
    so components can register eagerly without coordination); ``bind``
    registers a read-only callable over an external counter.
    """

    __slots__ = ("_counters", "_gauges", "_histograms", "_bound")

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._bound: Dict[str, Callable[[], float]] = {}

    # ------------------------------------------------------------- create
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            self._check_fresh(name, self._counters)
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            self._check_fresh(name, self._gauges)
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str,
                  bounds: Optional[Sequence[float]] = None) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            self._check_fresh(name, self._histograms)
            h = self._histograms[name] = Histogram(
                name, bounds if bounds is not None else DEFAULT_BOUNDS)
        return h

    def bind(self, name: str, source: Callable[[], float]) -> None:
        """Register a read-only view over an externally owned counter."""
        self._check_fresh(name, self._bound)
        self._bound[name] = source

    def _check_fresh(self, name: str, own: dict) -> None:
        for table in (self._counters, self._gauges, self._histograms,
                      self._bound):
            if table is not own and name in table:
                raise ValueError(f"metric {name!r} already registered "
                                 "with a different type")

    # -------------------------------------------------------------- read
    def names(self) -> List[str]:
        return sorted(set(self._counters) | set(self._gauges)
                      | set(self._histograms) | set(self._bound))

    def value(self, name: str) -> float:
        if name in self._counters:
            return self._counters[name].value
        if name in self._gauges:
            return self._gauges[name].value
        if name in self._bound:
            return self._bound[name]()
        if name in self._histograms:
            return self._histograms[name].count
        raise KeyError(name)

    def snapshot(self) -> dict:
        return {
            "counters": {n: c.value for n, c in sorted(self._counters.items())},
            "gauges": {n: g.value for n, g in sorted(self._gauges.items())},
            "histograms": {
                n: {"bounds": list(h.bounds), "counts": list(h.counts),
                    "count": h.count, "total": h.total}
                for n, h in sorted(self._histograms.items())},
            "bound": {n: fn() for n, fn in sorted(self._bound.items())},
        }

    def restore(self, state: dict) -> None:
        for name, value in state.get("counters", {}).items():
            self.counter(name).value = value
        for name, value in state.get("gauges", {}).items():
            self.gauge(name).value = value
        for name, hs in state.get("histograms", {}).items():
            h = self.histogram(name, hs.get("bounds"))
            h.counts = list(hs.get("counts", h.counts))
            h.count = hs.get("count", 0)
            h.total = hs.get("total", 0.0)
