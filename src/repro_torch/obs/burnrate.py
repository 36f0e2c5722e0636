"""Multi-window SLO burn-rate meters (SRE-style fast/slow burn).

The SLA grants an *error budget*: a pXX latency target allows a
``1 - XX/100`` fraction of requests to violate the SLO (a p95 target
budgets 5% violations). The burn rate is the windowed violation rate
divided by that budget — burn 1.0 means violations are arriving exactly
at the budgeted pace; burn 20 means the budget for the window is being
consumed 20x too fast.

Two windows, per the classic multi-window alerting scheme: a *fast*
window (default 60 s) catches sharp regressions quickly, a *slow*
window (default 600 s) filters blips. ``burning`` is true only when
both exceed 1.0 — fast for responsiveness, slow for confirmation.

Implementation is a coarse bucketed ring (no per-sample storage): each
``record`` lands in a time bucket of width ``resolution`` and old
buckets are pruned, so memory is O(slow_window / resolution) regardless
of request rate, and everything is exact integer counting — fully
deterministic under ``FakeClock``.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, List


class BurnRateMeter:
    __slots__ = ("budget", "fast_window", "slow_window", "resolution",
                 "_buckets", "total", "violations")

    def __init__(self, budget: float, fast_window: float = 60.0,
                 slow_window: float = 600.0, resolution: float = 0.0) -> None:
        if budget <= 0:
            raise ValueError(f"error budget must be positive, got {budget}")
        if fast_window <= 0 or slow_window < fast_window:
            raise ValueError("need 0 < fast_window <= slow_window, got "
                             f"{fast_window}/{slow_window}")
        self.budget = budget
        self.fast_window = fast_window
        self.slow_window = slow_window
        self.resolution = resolution if resolution > 0 else fast_window / 12.0
        # each bucket: [bucket_index, violations, total]
        self._buckets: Deque[List[float]] = deque()
        self.total = 0
        self.violations = 0

    @classmethod
    def for_percentile(cls, percentile: float, **kwargs) -> "BurnRateMeter":
        """Budget from an SLA percentile: p95 → 5% allowed violations.

        A p100 target has zero budget; clamp to 0.1% so the burn rate
        stays finite (it then reads "violations per 0.1% budget")."""
        return cls(max(1.0 - percentile / 100.0, 1e-3), **kwargs)

    # ------------------------------------------------------------- record
    def record(self, now: float, violated: bool) -> None:
        idx = int(now // self.resolution)
        buckets = self._buckets
        v = 1 if violated else 0
        if buckets and idx <= buckets[-1][0]:
            # same bucket, or a slightly out-of-order timestamp: fold into
            # the newest bucket rather than breaking monotonicity.
            buckets[-1][1] += v
            buckets[-1][2] += 1
        else:
            buckets.append([idx, v, 1])
            floor = idx - int(self.slow_window // self.resolution) - 1
            while buckets and buckets[0][0] < floor:
                buckets.popleft()
        self.total += 1
        self.violations += v

    # --------------------------------------------------------------- read
    def _window_rate(self, now: float, window: float) -> float:
        floor = (now - window) / self.resolution
        viol = total = 0
        for idx, v, n in reversed(self._buckets):
            if idx < floor:
                break
            viol += v
            total += n
        return viol / total if total else 0.0

    def rates(self, now: float) -> dict:
        fast = self._window_rate(now, self.fast_window) / self.budget
        slow = self._window_rate(now, self.slow_window) / self.budget
        return {
            "burn_rate_fast": fast,
            "burn_rate_slow": slow,
            "burning": fast > 1.0 and slow > 1.0,
        }

    # ------------------------------------------------------ fault tolerance
    def snapshot(self) -> dict:
        return {"buckets": [list(b) for b in self._buckets],
                "total": self.total, "violations": self.violations}

    def restore(self, state: dict) -> None:
        self._buckets = deque([list(b) for b in state.get("buckets", [])])
        self.total = state.get("total", 0)
        self.violations = state.get("violations", 0)
