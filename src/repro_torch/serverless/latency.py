"""Upstream service-time models for the simulated serverless platform.

The paper's enabling observation (Figs. 3–4) is that ML service time grows
*sub-linearly* in batch size because per-request overhead (HTTP handling,
framework dispatch, Python) amortizes while the vectorized compute scales.
The affine model ``s(b) = a + c·b`` captures exactly that: relative response
time ``s(b)/s(1)`` grows slowly when ``a ≫ c`` and time-per-inference
``s(b)/b`` collapses toward ``c``.

Models:
  * :class:`AffineLatency` — ``a + c·b`` (primary; calibrated per workload).
  * :class:`PowerLawLatency` — ``base · b^γ`` with γ < 1.
  * :class:`LinearLatency` — ``base · b``: the paper's negative control
    ("linear baseline"); batching gives no benefit and MLProxy should not
    help (Fig 3/4 linear baseline, §4.3 limitations).
  * :class:`MeasuredLatency` — interpolates a measured (batch → seconds)
    table, e.g. produced by ``benchmarks/bench_batch_scaling.py`` running
    the real JAX workload models on this host.

All models multiply a lognormal noise term with configurable coefficient of
variation, and a queuing slowdown factor for co-scheduled work.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class LatencyModel:
    """Protocol: deterministic mean + noisy sample, both in seconds."""

    name: str = "latency"

    def mean(self, batch_size: int) -> float:
        raise NotImplementedError

    def sample(self, batch_size: int, rng: np.random.Generator) -> float:
        s = self.mean(batch_size)
        cv = getattr(self, "noise_cv", 0.0)
        if cv <= 0:
            return s
        # lognormal with E=1, CV=cv
        sigma2 = math.log(1.0 + cv * cv)
        noise = rng.lognormal(mean=-sigma2 / 2.0, sigma=math.sqrt(sigma2))
        return s * noise

    # Batch-aware hooks: the platform calls these so multi-model latency
    # models (one shared container fleet serving several endpoints) can
    # route on the batch's endpoint stamp; the default ignores it.
    def mean_batch(self, batch) -> float:
        return self.mean(batch.effective_size)

    def sample_batch(self, batch, rng: np.random.Generator) -> float:
        return self.sample(batch.effective_size, rng)

    def percentile(self, batch_size: int, q: float) -> float:
        """Analytic percentile of the noisy model (for oracle baselines)."""
        s = self.mean(batch_size)
        cv = getattr(self, "noise_cv", 0.0)
        if cv <= 0:
            return s
        sigma2 = math.log(1.0 + cv * cv)
        from statistics import NormalDist

        z = NormalDist().inv_cdf(q / 100.0)
        return s * math.exp(-sigma2 / 2.0 + math.sqrt(sigma2) * z)


@dataclasses.dataclass
class AffineLatency(LatencyModel):
    """s(b) = a + c·b. ``a`` is the per-request-independent overhead."""

    a: float
    c: float
    noise_cv: float = 0.1
    name: str = "affine"

    def mean(self, batch_size: int) -> float:
        return self.a + self.c * batch_size

    @classmethod
    def fit(cls, points: Sequence[Tuple[int, float]], *,
            noise_cv: float = 0.0, name: str = "affine-fit") -> "AffineLatency":
        """Least-squares fit of ``s(b) = a + c·b`` to (batch, seconds) points.

        The calibration bridge (``repro.runtime.calibrate``) uses this to
        turn measured per-bucket batch latencies — from a live runtime run
        or ``bench_batch_scaling.py`` output — into simulator parameters.
        Both coefficients are clamped non-negative (a negative overhead or
        per-item cost is always a measurement artifact).
        """
        pts = [(float(b), float(s)) for b, s in points]
        if not pts:
            raise ValueError("AffineLatency.fit needs at least one point")
        if len(pts) == 1:
            return cls(a=max(0.0, pts[0][1]), c=0.0,
                       noise_cv=noise_cv, name=name)
        xs = np.asarray([b for b, _ in pts])
        ys = np.asarray([s for _, s in pts])
        c, a = np.polyfit(xs, ys, 1)
        return cls(a=max(0.0, float(a)), c=max(0.0, float(c)),
                   noise_cv=noise_cv, name=name)


@dataclasses.dataclass
class PowerLawLatency(LatencyModel):
    """s(b) = base · b^gamma, gamma ∈ (0, 1]."""

    base: float
    gamma: float
    noise_cv: float = 0.1
    name: str = "powerlaw"

    def mean(self, batch_size: int) -> float:
        return self.base * batch_size**self.gamma


@dataclasses.dataclass
class LinearLatency(LatencyModel):
    """s(b) = base · b — no batching benefit (negative control)."""

    base: float
    noise_cv: float = 0.1
    name: str = "linear"

    def mean(self, batch_size: int) -> float:
        return self.base * batch_size


@dataclasses.dataclass
class MeasuredLatency(LatencyModel):
    """Piecewise-linear interpolation over measured (batch_size, seconds)."""

    points: Sequence[Tuple[int, float]]
    noise_cv: float = 0.1
    name: str = "measured"

    def __post_init__(self) -> None:
        pts = sorted((int(b), float(s)) for b, s in self.points)
        if not pts:
            raise ValueError("MeasuredLatency needs at least one point")
        self._bs = [b for b, _ in pts]
        self._s = [s for _, s in pts]

    def mean(self, batch_size: int) -> float:
        xs, ys = self._bs, self._s
        if batch_size <= xs[0]:
            return ys[0]
        if batch_size >= xs[-1]:
            # extrapolate with the last segment's slope (conservative)
            if len(xs) >= 2:
                slope = (ys[-1] - ys[-2]) / (xs[-1] - xs[-2])
                return ys[-1] + slope * (batch_size - xs[-1])
            return ys[-1]
        i = bisect.bisect_right(xs, batch_size)
        x0, x1 = xs[i - 1], xs[i]
        y0, y1 = ys[i - 1], ys[i]
        t = (batch_size - x0) / (x1 - x0)
        return y0 + t * (y1 - y0)

    @classmethod
    def from_samples(cls, samples: Dict[int, Sequence[float]], *,
                     noise_cv: Optional[float] = None,
                     name: str = "measured") -> "MeasuredLatency":
        """Build from raw per-bucket latency samples (bucket → seconds list).

        Each bucket's point is the sample mean; when ``noise_cv`` is None
        it is estimated as the pooled coefficient of variation across
        buckets (0.0 when every bucket has a single sample).
        """
        pts = []
        cvs = []
        for b, vals in sorted(samples.items()):
            vals = [float(v) for v in vals]
            if not vals:
                continue
            m = sum(vals) / len(vals)
            pts.append((int(b), m))
            if len(vals) >= 2 and m > 0:
                var = sum((v - m) ** 2 for v in vals) / (len(vals) - 1)
                cvs.append(math.sqrt(var) / m)
        if not pts:
            raise ValueError("MeasuredLatency.from_samples got no samples")
        if noise_cv is None:
            noise_cv = sum(cvs) / len(cvs) if cvs else 0.0
        return cls(points=pts, noise_cv=noise_cv, name=name)


@dataclasses.dataclass
class ScaledLatency(LatencyModel):
    """Wrap another model, scaling every latency by a constant factor.

    The fleet-tier layer uses this for cheap-slow / expensive-fast tiers
    that share one calibrated workload curve: scaling the *output* (not
    re-parameterizing) keeps the wrapped model's RNG draw count identical,
    so a tiered run stays comparable draw-for-draw with its base run.
    """

    base: LatencyModel
    scale: float = 1.0
    name: str = "scaled"
    noise_cv: float = 0.0  # the wrapped model carries its own noise

    def mean(self, batch_size: int) -> float:
        return self.scale * self.base.mean(batch_size)

    def sample(self, batch_size: int, rng: np.random.Generator) -> float:
        return self.scale * self.base.sample(batch_size, rng)

    def mean_batch(self, batch) -> float:
        return self.scale * self.base.mean_batch(batch)

    def sample_batch(self, batch, rng: np.random.Generator) -> float:
        return self.scale * self.base.sample_batch(batch, rng)

    def percentile(self, batch_size: int, q: float) -> float:
        return self.scale * self.base.percentile(batch_size, q)


class EndpointRoutedLatency(LatencyModel):
    """Multi-model service times for a *shared* container fleet.

    Maps each batch's ``endpoint`` stamp (set by the
    :class:`~repro.core.frontend.ProxyFrontend`) to that endpoint's own
    latency model — one Knative service hosting several models. Size-only
    queries (``mean``/``sample``) fall back to the slowest member model,
    which keeps hedging and capacity estimates conservative.

    Keys are either plain endpoint names or ``(endpoint, tier)`` tuples.
    Lookup order for a batch stamped ``(endpoint=e, tier=t)``:

    1. ``(e, t)`` — tier-specific curve for this endpoint,
    2. ``e`` — the endpoint's tier-agnostic curve,

    and a ``KeyError`` naming both probes if neither is registered. A
    batch with no tier stamp skips step 1, so pre-tier configurations
    resolve exactly as before.
    """

    name = "endpoint-routed"
    noise_cv = 0.0  # member models carry their own noise

    def __init__(self, models: Dict[object, LatencyModel]) -> None:
        if not models:
            raise ValueError("EndpointRoutedLatency needs at least one model")
        self.models = dict(models)

    def _model_for(self, batch) -> LatencyModel:
        if batch.endpoint is None:
            raise KeyError("batch has no endpoint stamp; route it through a "
                           "ProxyFrontend before a shared platform")
        tier = getattr(batch, "tier", None)
        if tier is not None:
            m = self.models.get((batch.endpoint, tier))
            if m is not None:
                return m
        try:
            return self.models[batch.endpoint]
        except KeyError:
            probed = ([f"({batch.endpoint!r}, {tier!r})"] if tier is not None
                      else []) + [repr(batch.endpoint)]
            raise KeyError(
                f"no latency model for {' then '.join(probed)}; "
                f"registered: {sorted(map(repr, self.models))}") from None

    def mean(self, batch_size: int) -> float:
        return max(m.mean(batch_size) for m in self.models.values())

    def sample(self, batch_size: int, rng: np.random.Generator) -> float:
        worst = max(self.models.values(), key=lambda m: m.mean(batch_size))
        return worst.sample(batch_size, rng)

    def mean_batch(self, batch) -> float:
        return self._model_for(batch).mean(batch.effective_size)

    def sample_batch(self, batch, rng: np.random.Generator) -> float:
        return self._model_for(batch).sample(batch.effective_size, rng)


# --------------------------------------------------------------------------
# The paper's Table-2 workloads, calibrated so that s(1) equals the reported
# baseline response time (BRT) and the sub-linear shape matches Figs. 3–4
# (overhead-dominated: a ≈ 0.9·BRT). The "linear" entry is the negative
# control from the figures.
# --------------------------------------------------------------------------

PAPER_WORKLOADS: Dict[str, LatencyModel] = {
    # name: BRT (Table 2) split into overhead a + per-item c
    "sklearn-iris": AffineLatency(a=0.0065, c=0.0015, name="sklearn-iris"),
    "keras-toxic": AffineLatency(a=0.034, c=0.006, name="keras-toxic"),
    "onnx-resnet50": AffineLatency(a=0.110, c=0.091, name="onnx-resnet50"),
    "pytorch-fashion-mnist": AffineLatency(a=0.121, c=0.004, name="pytorch-fashion-mnist"),
    "tfserving-mobilenet": AffineLatency(a=0.055, c=0.028, name="tfserving-mobilenet"),
    "tfserving-resnet": AffineLatency(a=0.115, c=0.089, name="tfserving-resnet"),
    # negative control — linear scaling, no batching benefit (paper §4.3)
    "linear-control": LinearLatency(base=0.050, name="linear-control"),
}


def get_workload(name: str) -> LatencyModel:
    try:
        return PAPER_WORKLOADS[name]
    except KeyError:
        raise KeyError(
            f"unknown workload {name!r}; available: {sorted(PAPER_WORKLOADS)}"
        ) from None
