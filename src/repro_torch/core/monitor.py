"""Smart Monitor — sliding-window latency statistics keyed by batch size.

Implements the paper's monitoring component (§2.2): for every batch size the
proxy has dispatched, keep a sliding window of upstream response times and
expose the windowed 95th percentile (``RT95[bs]``); additionally keep a
window of end-to-end response times (queueing + proxy + upstream) used by
the AIMD optimizer for SLO-compliance decisions.

Beyond the paper, three estimator back-ends are provided (see
``MonitorConfig.estimator``): the paper-faithful per-size windowed
percentile, a robust linear regression over the populated windows (used as
the fallback for batch sizes never observed — the paper is silent on this
cold-start case), and a P² streaming quantile with O(1) memory per size.
"""
from __future__ import annotations

import bisect
import collections
import math
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.core.config import MonitorConfig, SLAConfig
from repro_torch.obs.burnrate import BurnRateMeter
from repro_torch.obs.metrics import MetricsRegistry


class LatencyWindow:
    """Sliding window of (timestamp, latency) with lazy horizon eviction.

    Percentile queries run off a lazily-built sorted cache that is kept
    incrementally consistent: ``add`` insorts the new sample (removing the
    one the bounded deque evicts), horizon eviction removes aged samples,
    and the winsorized rank is computed with bisection on the cache — so
    the window is sorted once, not on every ``percentile`` call (the
    scheduler queries it on every arrival).
    """

    __slots__ = ("maxlen", "horizon", "_buf", "_sorted")

    def __init__(self, maxlen: int, horizon: float) -> None:
        self.maxlen = maxlen
        self.horizon = horizon
        self._buf: Deque[Tuple[float, float]] = collections.deque(maxlen=maxlen)
        self._sorted: Optional[List[float]] = None  # built on first query

    def add(self, now: float, latency: float) -> None:
        srt = self._sorted
        if srt is not None:
            if len(self._buf) == self.maxlen:  # deque evicts its oldest
                del srt[bisect.bisect_left(srt, self._buf[0][1])]
            bisect.insort(srt, latency)
        self._buf.append((now, latency))

    def _evict(self, now: float) -> None:
        cutoff = now - self.horizon
        buf = self._buf
        srt = self._sorted
        while buf and buf[0][0] < cutoff:
            _, v = buf.popleft()
            if srt is not None:
                del srt[bisect.bisect_left(srt, v)]

    def _sorted_values(self) -> List[float]:
        if self._sorted is None:
            self._sorted = sorted(v for (_, v) in self._buf)
        return self._sorted

    def __len__(self) -> int:
        return len(self._buf)

    def count(self, now: Optional[float] = None) -> int:
        """Number of in-horizon samples (no list materialization)."""
        if now is not None:
            self._evict(now)
        return len(self._buf)

    def values(self, now: Optional[float] = None) -> List[float]:
        if now is not None:
            self._evict(now)
        return [v for (_, v) in self._buf]

    def percentile(self, q: float, now: Optional[float] = None,
                   outlier_mult: float = 0.0) -> Optional[float]:
        """Empirical percentile (nearest-rank, higher interpolation).

        ``outlier_mult > 0`` winsorizes: samples above ``outlier_mult ×
        median`` are dropped before ranking (robustness to cold-start
        storms; see MonitorConfig.outlier_mult).
        """
        if now is not None:
            self._evict(now)
        vals = self._sorted_values()
        n = len(vals)
        if not n:
            return None
        if outlier_mult > 0 and n >= 4:
            # kept == vals[:k] because vals is sorted; no list rebuild
            k = bisect.bisect_right(vals, outlier_mult * vals[n // 2])
            if k > 0:
                n = k
        # Higher interpolation keeps the estimate conservative for SLOs.
        rank = min(n - 1, max(0, math.ceil(q / 100.0 * n) - 1))
        return vals[rank]

    def mean(self, now: Optional[float] = None) -> Optional[float]:
        vals = self.values(now)
        return sum(vals) / len(vals) if vals else None

    def snapshot(self) -> dict:
        return {"maxlen": self.maxlen, "horizon": self.horizon, "buf": list(self._buf)}

    @classmethod
    def restore(cls, state: dict) -> "LatencyWindow":
        w = cls(state["maxlen"], state["horizon"])
        w._buf.extend(state["buf"])
        return w


class P2Quantile:
    """P² streaming quantile estimator (Jain & Chlamtac, 1985).

    O(1) memory per tracked quantile; used as an optional back-end for
    very high-rate endpoints where keeping windows is wasteful.
    """

    __slots__ = ("p", "n", "q", "npos", "dn", "_init")

    def __init__(self, p: float) -> None:
        if not 0 < p < 1:
            raise ValueError("p must be in (0,1)")
        self.p = p
        self._init: List[float] = []
        self.n: List[int] = []
        self.q: List[float] = []
        self.npos: List[float] = []
        self.dn: List[float] = []

    def add(self, x: float) -> None:
        if len(self._init) < 5:
            bisect.insort(self._init, x)
            if len(self._init) == 5:
                self.q = list(self._init)
                self.n = [1, 2, 3, 4, 5]
                p = self.p
                self.npos = [1, 1 + 2 * p, 1 + 4 * p, 3 + 2 * p, 5]
                self.dn = [0, p / 2, p, (1 + p) / 2, 1]
            return
        q, n, npos = self.q, self.n, self.npos
        if x < q[0]:
            q[0] = x
            k = 0
        elif x >= q[4]:
            q[4] = x
            k = 3
        else:
            k = 0
            for i in range(1, 4):
                if x < q[i]:
                    k = i - 1
                    break
            else:
                k = 3
        for i in range(k + 1, 5):
            n[i] += 1
        for i in range(5):
            npos[i] += self.dn[i]
        for i in range(1, 4):
            d = npos[i] - n[i]
            if (d >= 1 and n[i + 1] - n[i] > 1) or (d <= -1 and n[i - 1] - n[i] < -1):
                d = 1 if d >= 0 else -1
                # parabolic prediction
                qi = q[i] + d / (n[i + 1] - n[i - 1]) * (
                    (n[i] - n[i - 1] + d) * (q[i + 1] - q[i]) / (n[i + 1] - n[i])
                    + (n[i + 1] - n[i] - d) * (q[i] - q[i - 1]) / (n[i] - n[i - 1])
                )
                if not (q[i - 1] < qi < q[i + 1]):
                    # linear fallback
                    qi = q[i] + d * (q[i + d] - q[i]) / (n[i + d] - n[i])
                q[i] = qi
                n[i] += d

    @property
    def count(self) -> int:
        return self.n[4] if self.n else len(self._init)

    def value(self) -> Optional[float]:
        if self.q:
            return self.q[2]
        if self._init:
            # not enough samples for markers: empirical on what we have
            k = max(0, math.ceil(self.p * len(self._init)) - 1)
            return self._init[k]
        return None

    def snapshot(self) -> dict:
        return {
            "p": self.p,
            "init": list(self._init),
            "n": list(self.n),
            "q": list(self.q),
            "npos": list(self.npos),
            "dn": list(self.dn),
        }

    @classmethod
    def restore(cls, state: dict) -> "P2Quantile":
        est = cls(state["p"])
        est._init = list(state["init"])
        est.n = list(state["n"])
        est.q = list(state["q"])
        est.npos = list(state["npos"])
        est.dn = list(state["dn"])
        return est


def _theil_sen_fit(points: List[Tuple[float, float]]) -> Tuple[float, float]:
    """Robust line fit (median of pairwise slopes). Returns (a, b): y≈a+b·x."""
    if len(points) == 1:
        return points[0][1], 0.0
    slopes = []
    for i in range(len(points)):
        for j in range(i + 1, len(points)):
            (x0, y0), (x1, y1) = points[i], points[j]
            if x1 != x0:
                slopes.append((y1 - y0) / (x1 - x0))
    if not slopes:
        ys = [y for _, y in points]
        return sorted(ys)[len(ys) // 2], 0.0
    slopes.sort()
    b = slopes[len(slopes) // 2]
    residuals = sorted(y - b * x for x, y in points)
    a = residuals[len(residuals) // 2]
    return a, b


class SmartMonitor:
    """Latency statistics provider for the scheduler and AIMD optimizer.

    Responsibilities (paper §2.2):
      * per-batch-size sliding windows of upstream response times →
        ``upstream_percentile(bs)`` (the scheduler's ``RT95[N_q+1]``);
      * sliding window of end-to-end response times → ``e2e_percentile()``;
      * dispatch-cause accounting over the current optimizer interval →
        ``timeout_ratio()``.
    """

    def __init__(self, config: MonitorConfig, sla: SLAConfig) -> None:
        self.config = config
        self.sla = sla
        self._upstream: Dict[int, LatencyWindow] = {}
        self._p2: Dict[int, P2Quantile] = {}
        self._e2e = LatencyWindow(config.window_size * 4, config.e2e_horizon)
        # dispatch-cause counters for the *current* optimizer interval
        self._timeout_dispatches = 0
        self._total_dispatches = 0
        # Lifetime counters, migrated onto typed obs Counters in an owned
        # MetricsRegistry. The `lifetime_*` read surface is preserved as
        # properties below; snapshot/restore keeps the historical tuple
        # format so old snapshots load unchanged.
        self.metrics = MetricsRegistry()
        c = self.metrics.counter
        self._c_dispatches = c("lifetime_dispatches")
        self._c_requests = c("lifetime_requests")
        self._c_violations = c("lifetime_violations")
        # retry-aware upstream accounting (platform-side crash retries and
        # hedges, reported via Batch.attempts)
        self._c_upstream_batches = c("lifetime_upstream_batches")
        self._c_upstream_attempts = c("lifetime_upstream_attempts")
        self._c_retried_batches = c("lifetime_retried_batches")
        # failed dispatch attempts (target raised / injected fault); they
        # never enter the latency windows — there is no completion latency
        # to learn from — but they feed failure_rate()
        self._c_failed_attempts = c("lifetime_failed_attempts")
        # padding accounting on bucketed backends: a dispatch of n requests
        # into a bucket of size b occupies b slots, b - n of them padding
        self._c_dispatched_slots = c("lifetime_dispatched_slots")
        self._c_padded_slots = c("lifetime_padded_slots")
        # SLO burn-rate meter fed by every end-to-end completion: the
        # windowed violation rate over the SLA's error budget, on a fast
        # and a slow window (SRE-style multi-window burn alerting).
        self.burn = BurnRateMeter.for_percentile(
            sla.percentile,
            fast_window=config.burn_fast_window,
            slow_window=config.burn_slow_window)

    # ------------------------------------------------- lifetime read surface
    @property
    def lifetime_dispatches(self) -> int:
        return self._c_dispatches.value

    @property
    def lifetime_requests(self) -> int:
        return self._c_requests.value

    @property
    def lifetime_violations(self) -> int:
        return self._c_violations.value

    @property
    def lifetime_upstream_batches(self) -> int:
        return self._c_upstream_batches.value

    @property
    def lifetime_upstream_attempts(self) -> int:
        return self._c_upstream_attempts.value

    @property
    def lifetime_retried_batches(self) -> int:
        return self._c_retried_batches.value

    @property
    def lifetime_failed_attempts(self) -> int:
        return self._c_failed_attempts.value

    @property
    def lifetime_dispatched_slots(self) -> int:
        return self._c_dispatched_slots.value

    @property
    def lifetime_padded_slots(self) -> int:
        return self._c_padded_slots.value

    def register_metrics(self, registry: MetricsRegistry,
                         prefix: str = "monitor") -> None:
        """Bind this monitor's counters into an external registry.

        Aggregators (the live server, sims) call this with a per-endpoint
        prefix so one registry exposes every endpoint's monitor."""
        for name in self.metrics.names():
            counter = self.metrics.counter(name)
            registry.bind(f"{prefix}.{name}",
                          lambda c=counter: c.value)
        registry.bind(f"{prefix}.interval_timeout_dispatches",
                      lambda: self._timeout_dispatches)
        registry.bind(f"{prefix}.interval_dispatches",
                      lambda: self._total_dispatches)
        registry.bind(f"{prefix}.burn_samples", lambda: self.burn.total)
        registry.bind(f"{prefix}.burn_violations",
                      lambda: self.burn.violations)

    # ---------------------------------------------------------------- record
    def record_upstream(self, batch_size: int, latency: float, now: float,
                        attempts: int = 1) -> None:
        """Record one upstream batch completion.

        ``attempts`` is how many platform-side dispatches (crash retries +
        hedges) the batch took; values > 1 feed the retry-aware counters
        surfaced in :meth:`stats` plumbing (``retry_rate``).
        """
        if batch_size <= 0:
            raise ValueError("batch_size must be >= 1")
        self._c_upstream_batches.inc()
        self._c_upstream_attempts.inc(max(1, attempts))
        if attempts > 1:
            self._c_retried_batches.inc()
        win = self._upstream.get(batch_size)
        if win is None:
            win = LatencyWindow(self.config.window_size, self.config.window_horizon)
            self._upstream[batch_size] = win
        win.add(now, latency)
        if self.config.estimator == "p2":
            est = self._p2.get(batch_size)
            if est is None:
                est = P2Quantile(self.sla.percentile / 100.0)
                self._p2[batch_size] = est
            est.add(latency)

    def record_failure(self, batch_size: int, now: float) -> None:
        """Record one FAILED upstream dispatch attempt.

        The attempt produced no completion latency, so nothing enters the
        per-size windows; only the failure counter moves. ``batch_size``
        and ``now`` mirror :meth:`record_upstream`'s signature for callers
        that treat the two symmetrically (and for future per-size failure
        tracking).
        """
        del batch_size, now
        self._c_failed_attempts.inc()

    def record_e2e(self, latency: float, now: float) -> None:
        """Record one end-to-end (user-observed) response time."""
        self._e2e.add(now, latency)
        self._c_requests.inc()
        violated = latency > self.sla.slo_target
        if violated:
            self._c_violations.inc()
        self.burn.record(now, violated)

    def record_dispatch(self, batch_size: int, cause: str,
                        effective_size: Optional[int] = None) -> None:
        """cause ∈ {'full', 'timeout', 'flush'}.

        ``effective_size`` is the padded bucket the batch executes as on
        fixed-shape backends (defaults to ``batch_size``: no padding);
        the gap feeds the padding-waste counters.
        """
        self._total_dispatches += 1
        self._c_dispatches.inc()
        if cause == "timeout":
            self._timeout_dispatches += 1
        eff = effective_size if effective_size is not None else batch_size
        self._c_dispatched_slots.inc(eff)
        self._c_padded_slots.inc(max(0, eff - batch_size))

    # -------------------------------------------------------------- estimate
    def upstream_percentile(self, batch_size: int, now: float) -> float:
        """Estimated upstream latency percentile for ``batch_size``.

        Paper-faithful path: the windowed empirical percentile for that
        exact batch size. Cold-start/fallback: robust regression over the
        percentiles of every populated window (so unseen sizes interpolate /
        extrapolate sensibly); before *any* observation, an optimistic
        default that makes the scheduler batch until data arrives.
        """
        cfg = self.config
        if cfg.estimator == "p2":
            est = self._p2.get(batch_size)
            if est is not None and est.count >= cfg.min_samples:
                v = est.value()
                if v is not None:
                    return v
        else:
            win = self._upstream.get(batch_size)
            if win is not None and win.count(now) >= cfg.min_samples:
                # count(now) already evicted: query without re-evicting
                v = win.percentile(self.sla.percentile,
                                   outlier_mult=cfg.outlier_mult)
                if v is not None:
                    return v
        return self._regression_estimate(batch_size, now)

    def _regression_estimate(self, batch_size: int, now: float) -> float:
        points: List[Tuple[float, float]] = []
        for bs, win in self._upstream.items():
            if win.count(now) > 0:
                p = win.percentile(self.sla.percentile, now)
                if p is not None:
                    points.append((float(bs), p))
        if not points:
            return self.config.optimistic_default
        if len(points) == 1:
            # single observed size: assume flat (sub-linear optimism); the
            # AIMD loop corrects any resulting violation.
            return points[0][1]
        a, b = _theil_sen_fit(points)
        est = a + b * batch_size
        # Extrapolation floor: never negative, and never below half the
        # cheapest observed percentile — a downhill fit extrapolated far
        # past the data must not promise near-free large batches.
        lo = min(y for _, y in points)
        return max(est, 0.5 * lo, 0.0)

    def bucket_quantile(self, batch_size: int, q: float, now: float,
                        min_samples: int = 1) -> Optional[float]:
        """Raw windowed quantile of one bucket's upstream latency.

        Unlike :meth:`upstream_percentile` this never falls back to the
        regression estimate and never winsorizes — it is the straggler
        detector behind proxy-tier hedging, where the tail *is* the
        signal. Returns None until the bucket has ``min_samples``
        in-horizon observations (hedging stays off while cold).
        """
        win = self._upstream.get(batch_size)
        if win is None or win.count(now) < max(1, min_samples):
            return None
        return win.percentile(q)

    def e2e_percentile(self, now: float) -> Optional[float]:
        return self._e2e.percentile(self.sla.percentile, now)

    def e2e_mean(self, now: float) -> Optional[float]:
        return self._e2e.mean(now)

    def timeout_ratio(self) -> float:
        if self._total_dispatches == 0:
            return 0.0
        return self._timeout_dispatches / self._total_dispatches

    def reset_interval(self) -> None:
        """Called by the optimizer at the end of each update interval."""
        self._timeout_dispatches = 0
        self._total_dispatches = 0

    # --------------------------------------------------------------- metrics
    def violation_rate(self) -> float:
        if self.lifetime_requests == 0:
            return 0.0
        return self.lifetime_violations / self.lifetime_requests

    def retry_rate(self) -> float:
        """Fraction of completed upstream batches that needed > 1 attempt."""
        if self.lifetime_upstream_batches == 0:
            return 0.0
        return self.lifetime_retried_batches / self.lifetime_upstream_batches

    def failure_rate(self) -> float:
        """Fraction of all upstream dispatch attempts that failed."""
        total = self.lifetime_upstream_attempts + self.lifetime_failed_attempts
        if total == 0:
            return 0.0
        return self.lifetime_failed_attempts / total

    def padding_waste(self) -> float:
        """Lifetime fraction of dispatched bucket slots that were padding."""
        if self.lifetime_dispatched_slots == 0:
            return 0.0
        return self.lifetime_padded_slots / self.lifetime_dispatched_slots

    def observed_batch_sizes(self) -> List[int]:
        return sorted(self._upstream)

    # ------------------------------------------------------- fault tolerance
    def snapshot(self) -> dict:
        return {
            "upstream": {bs: w.snapshot() for bs, w in self._upstream.items()},
            "p2": {bs: e.snapshot() for bs, e in self._p2.items()},
            "e2e": self._e2e.snapshot(),
            "timeout_dispatches": self._timeout_dispatches,
            "total_dispatches": self._total_dispatches,
            "lifetime": (
                self.lifetime_dispatches,
                self.lifetime_requests,
                self.lifetime_violations,
            ),
            "lifetime_upstream": (
                self.lifetime_upstream_batches,
                self.lifetime_upstream_attempts,
                self.lifetime_retried_batches,
            ),
            "lifetime_failed_attempts": self.lifetime_failed_attempts,
            "lifetime_padding": (
                self.lifetime_dispatched_slots,
                self.lifetime_padded_slots,
            ),
            "burn": self.burn.snapshot(),
        }

    def restore(self, state: dict) -> None:
        self._upstream = {
            int(bs): LatencyWindow.restore(s) for bs, s in state["upstream"].items()
        }
        self._p2 = {int(bs): P2Quantile.restore(s) for bs, s in state["p2"].items()}
        self._e2e = LatencyWindow.restore(state["e2e"])
        self._timeout_dispatches = state["timeout_dispatches"]
        self._total_dispatches = state["total_dispatches"]
        # The historical tuple formats predate the typed-counter migration;
        # they remain the canonical snapshot encoding so old snapshots load.
        (
            self._c_dispatches.value,
            self._c_requests.value,
            self._c_violations.value,
        ) = state["lifetime"]
        (
            self._c_upstream_batches.value,
            self._c_upstream_attempts.value,
            self._c_retried_batches.value,
        ) = state.get("lifetime_upstream", (0, 0, 0))
        # pre-fault-tolerance snapshots carry no failure accounting
        self._c_failed_attempts.value = state.get("lifetime_failed_attempts", 0)
        (
            self._c_dispatched_slots.value,
            self._c_padded_slots.value,
        ) = state.get("lifetime_padding", (0, 0))
        # pre-obs snapshots carry no burn-meter state (restore() with an
        # empty dict resets the meter)
        self.burn.restore(state.get("burn", {}))
