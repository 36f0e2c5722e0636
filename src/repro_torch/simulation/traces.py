"""Arrival-rate traces.

The paper modulates a Poisson process with three real traces (Fig. 5):
the FIFA World Cup '98 HTTP trace and the NLANR T4/T5 traces from the
AutoScale paper [Gandhi et al., TOCS'12], scaled so the maximum arrival
rate matches the cluster capacity.

Those traces are not redistributable here, so :func:`synthetic_trace`
generates seeded profiles with the same qualitative shapes (WC: sharp
event-driven peaks over a low base; T4/T5: smooth diurnal waves), and
:meth:`Trace.from_csv` loads the real ones when available — the benchmark
harness uses the synthetic profiles by default and real CSVs when given.
"""
from __future__ import annotations

import csv
import dataclasses
import math
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass(slots=True)
class Trace:
    """Piecewise-constant arrival-rate profile.

    ``rates[i]`` applies on ``[times[i], times[i+1])``; ``times`` has one
    more entry than ``rates``.
    """

    times: np.ndarray  # (n+1,) bin edges, seconds
    rates: np.ndarray  # (n,) requests/second
    name: str = "trace"

    def __post_init__(self) -> None:
        self.times = np.asarray(self.times, dtype=np.float64)
        self.rates = np.asarray(self.rates, dtype=np.float64)
        if self.times.ndim != 1 or self.rates.ndim != 1:
            raise ValueError("times/rates must be 1-D")
        if len(self.times) != len(self.rates) + 1:
            raise ValueError("need len(times) == len(rates) + 1")
        if np.any(np.diff(self.times) <= 0):
            raise ValueError("times must be strictly increasing")
        if np.any(self.rates < 0):
            raise ValueError("rates must be >= 0")

    @property
    def duration(self) -> float:
        return float(self.times[-1] - self.times[0])

    @property
    def max_rate(self) -> float:
        return float(self.rates.max()) if len(self.rates) else 0.0

    def rate_at(self, t: float) -> float:
        if t < self.times[0] or t >= self.times[-1]:
            return 0.0
        i = int(np.searchsorted(self.times, t, side="right")) - 1
        return float(self.rates[min(i, len(self.rates) - 1)])

    def rate_at_many(self, t: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`rate_at` (thinning acceptance hot path)."""
        t = np.asarray(t, dtype=np.float64)
        idx = np.searchsorted(self.times, t, side="right") - 1
        out = self.rates[np.clip(idx, 0, len(self.rates) - 1)]
        return np.where((t >= self.times[0]) & (t < self.times[-1]), out, 0.0)

    def scaled(self, max_rps: float) -> "Trace":
        """Scale so the peak rate equals ``max_rps`` (paper §3.5)."""
        if self.max_rate <= 0:
            raise ValueError("cannot scale an all-zero trace")
        return Trace(
            times=self.times.copy(),
            rates=self.rates * (max_rps / self.max_rate),
            name=f"{self.name}@{max_rps:g}rps",
        )

    def stretched(self, duration: float) -> "Trace":
        """Linearly re-time the trace to span ``duration`` seconds."""
        t0 = self.times[0]
        span = self.times[-1] - t0
        return Trace(
            times=(self.times - t0) * (duration / span),
            rates=self.rates.copy(),
            name=self.name,
        )

    # ------------------------------------------------------------------- io
    def to_csv(self, path: str) -> None:
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["t_start", "rate_rps"])
            for t, r in zip(self.times[:-1], self.rates):
                w.writerow([f"{t:.6f}", f"{r:.6f}"])
            w.writerow([f"{self.times[-1]:.6f}", ""])

    @classmethod
    def from_csv(cls, path: str, name: str = "csv") -> "Trace":
        times: List[float] = []
        rates: List[float] = []
        with open(path, newline="") as f:
            r = csv.reader(f)
            header = next(r)
            for row in r:
                if not row or not row[0]:
                    continue
                times.append(float(row[0]))
                if len(row) > 1 and row[1] != "":
                    rates.append(float(row[1]))
        if len(times) == len(rates):  # no explicit final edge: synthesize
            dt = times[-1] - times[-2] if len(times) >= 2 else 1.0
            times.append(times[-1] + dt)
        return cls(times=np.asarray(times), rates=np.asarray(rates), name=name)


def _add_bursts(prof: np.ndarray, rng, n: int, lo: float, hi: float) -> None:
    """Short rectangular load bursts (in place)."""
    n_bins = len(prof)
    for s0 in rng.integers(0, max(n_bins - 3, 1), size=n):
        w = int(rng.integers(1, 4))
        amp = rng.uniform(lo, hi)
        prof[s0:s0 + w] = np.maximum(prof[s0:s0 + w], amp)


def _smooth(x: np.ndarray, k: int) -> np.ndarray:
    if k <= 1:
        return x
    kernel = np.ones(k) / k
    return np.convolve(np.pad(x, (k // 2, k - 1 - k // 2), mode="edge"), kernel, "valid")


def synthetic_trace(
    kind: str,
    duration: float = 3600.0,
    n_bins: int = 360,
    seed: int = 0,
    noise: float = 0.05,
) -> Trace:
    """Seeded trace profiles shaped like the paper's Fig. 5.

    ``kind``:
      * ``"wc"`` — FIFA WC'98-like: modest base with sharp event peaks.
      * ``"t4"`` — NLANR T4-like: smooth diurnal wave, higher duty cycle.
      * ``"t5"`` — NLANR T5-like: diurnal wave with a secondary bump.
      * ``"constant"`` — flat profile (controls/tests).
    """
    rng = np.random.default_rng(seed)
    u = np.linspace(0.0, 1.0, n_bins, endpoint=False)
    if kind == "wc":
        base = 0.18 + 0.10 * np.sin(2 * math.pi * (u - 0.1))
        peaks = (
            0.55 * np.exp(-0.5 * ((u - 0.35) / 0.035) ** 2)
            + 1.00 * np.exp(-0.5 * ((u - 0.72) / 0.05) ** 2)
            + 0.30 * np.exp(-0.5 * ((u - 0.55) / 0.02) ** 2)
        )
        prof = base + peaks
        # flash crowds: the WC'98 trace spikes on goal events within
        # seconds — rectangular bursts a stable-window autoscaler cannot
        # anticipate (these, not the diurnal shape, drive the baseline's
        # SLO violations in Table 3)
        _add_bursts(prof, rng, n=max(3, n_bins // 90), lo=0.45, hi=0.75)
    elif kind == "t4":
        prof = 0.45 + 0.40 * np.sin(2 * math.pi * (u - 0.25)) ** 1
        prof = np.maximum(prof, 0.12)
        _add_bursts(prof, rng, n=max(2, n_bins // 150), lo=0.7, hi=0.95)
    elif kind == "t5":
        prof = (
            0.35
            + 0.35 * np.sin(2 * math.pi * (u - 0.3))
            + 0.18 * np.sin(4 * math.pi * (u - 0.05))
        )
        prof = np.maximum(prof, 0.10)
        _add_bursts(prof, rng, n=max(2, n_bins // 150), lo=0.6, hi=0.9)
    elif kind == "constant":
        prof = np.ones_like(u)
    else:
        raise ValueError(f"unknown trace kind {kind!r}")
    if noise > 0:
        prof = prof * (1.0 + noise * _smooth(rng.standard_normal(n_bins), 9))
    prof = np.maximum(prof, 0.01)
    prof = prof / prof.max()
    times = np.linspace(0.0, duration, n_bins + 1)
    return Trace(times=times, rates=prof, name=kind)
