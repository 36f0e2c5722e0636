"""Configuration objects for the MLProxy control plane.

All times are seconds (floats). The paper expresses SLOs in milliseconds;
callers may use :func:`ms` for readability.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union


def ms(x: float) -> float:
    """Milliseconds → seconds."""
    return x / 1000.0


@dataclasses.dataclass(frozen=True)
class SLAConfig:
    """Service-level objective for one endpoint.

    Attributes:
      slo_target: response-time target in seconds (the paper's ``RT_SLO``).
      percentile: which latency percentile the SLO constrains (paper: 95).
      compliance_factor: internal threshold as a fraction of ``slo_target``
        used by the AIMD optimizer to trigger multiplicative decrease
        *before* the SLO itself is violated (paper: 0.8).
      deadline_factor: per-request completion deadline as a multiple of
        ``slo_target``. When set, every admitted request without a
        client-supplied ``Request.deadline`` gets ``arrival +
        slo_target × deadline_factor``; requests still queued past their
        deadline are evicted (``timed_out``) instead of being batched,
        dispatched and billed. ``None`` (default) disables deadlines.
    """

    slo_target: float
    percentile: float = 95.0
    compliance_factor: float = 0.8
    deadline_factor: Optional[float] = None

    def __post_init__(self) -> None:
        if self.slo_target <= 0:
            raise ValueError(f"slo_target must be > 0, got {self.slo_target}")
        if not 0 < self.percentile <= 100:
            raise ValueError(f"percentile must be in (0, 100], got {self.percentile}")
        if not 0 < self.compliance_factor <= 1:
            raise ValueError(
                f"compliance_factor must be in (0, 1], got {self.compliance_factor}"
            )
        if self.deadline_factor is not None and self.deadline_factor <= 0:
            raise ValueError(
                f"deadline_factor must be > 0 or None, got {self.deadline_factor}"
            )

    @property
    def compliance_target(self) -> float:
        """The latency threshold the optimizer actually steers to."""
        return self.slo_target * self.compliance_factor

    @property
    def deadline_budget(self) -> Optional[float]:
        """Per-request deadline budget in seconds (None = no deadline)."""
        if self.deadline_factor is None:
            return None
        return self.slo_target * self.deadline_factor


@dataclasses.dataclass(frozen=True)
class MonitorConfig:
    """Smart Monitor configuration.

    Attributes:
      window_size: max samples retained per batch-size latency window.
      window_horizon: max age (seconds) of samples used in estimates; older
        samples are dropped lazily (the paper's "sliding window").
      estimator: upstream-latency estimator for unseen batch sizes:
        ``"window"``  — paper-faithful: windowed empirical percentile for the
                        exact batch size, falling back to ``"regression"``
                        when the window for that size is empty;
        ``"regression"`` — robust linear fit ``a + b·bs`` over the percentile
                        of every populated window (beyond paper);
        ``"p2"``      — P² streaming quantile per batch size (O(1) memory,
                        beyond paper).
      min_samples: minimum samples in a window before its percentile is
        trusted (below this the fallback estimator is used).
      optimistic_default: latency (seconds) assumed for batch size 1 before
        any observation exists. A small value makes the scheduler batch
        aggressively until real data arrives; the first completions correct
        it.
      outlier_mult: beyond paper — samples greater than ``outlier_mult ×
        window median`` are excluded from the percentile estimate. Cold
        starts and platform queueing storms otherwise poison RT95 for a
        full window horizon, driving DTO ≤ 0 and disabling batching right
        when batching would absorb the burst. 0 disables (paper-faithful
        raw percentile).
      burn_fast_window / burn_slow_window: window lengths (seconds) of the
        SLO burn-rate meter fed by every end-to-end completion (see
        :mod:`repro.obs.burnrate`). The fast window catches sharp
        regressions, the slow window confirms them; ``burn_rate_fast`` /
        ``burn_rate_slow`` surface through every stats path.
    """

    window_size: int = 256
    window_horizon: float = 120.0
    # End-to-end RT window horizon: short, so that a transient platform
    # storm stops dominating the compliance signal within ~2 optimizer
    # intervals ("we use a sliding window to only use the latest response
    # time values", paper §2.2).
    e2e_horizon: float = 60.0
    estimator: str = "window"
    min_samples: int = 3
    optimistic_default: float = 0.0
    outlier_mult: float = 5.0
    burn_fast_window: float = 60.0
    burn_slow_window: float = 600.0

    def __post_init__(self) -> None:
        if self.estimator not in ("window", "regression", "p2"):
            raise ValueError(f"unknown estimator {self.estimator!r}")
        if self.window_size < 8:
            raise ValueError("window_size must be >= 8")
        if not 0 < self.burn_fast_window <= self.burn_slow_window:
            raise ValueError(
                "need 0 < burn_fast_window <= burn_slow_window, got "
                f"{self.burn_fast_window}/{self.burn_slow_window}")


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Algorithm 2 (AIMD dynamic batch optimizer) configuration.

    Paper defaults: ``inc_step = 1``, ``dec_mult = 0.8``, evaluated every
    30 seconds; a violation is (timeout-dispatch ratio > ``to_thresh``) or
    (observed RT percentile > compliance threshold).
    """

    inc_step: float = 1.0
    dec_mult: float = 0.8
    update_interval: float = 30.0
    # Fraction of timeout-dispatched batches tolerated before Max_BS is
    # considered "too large for the current arrival rate" (paper §2.4; the
    # paper does not publish its value). At moderate rates timeout dispatch
    # is the NORMAL mode — Max_BS self-regulates through the RT-compliance
    # signal instead — so the threshold must be high; 0.5 pins Max_BS at 1
    # and forfeits all batching (validated in EXPERIMENTS.md §Table-3).
    to_thresh: float = 0.9
    initial_max_bs: float = 1.0
    max_bs_cap: int = 256
    min_bs: int = 1

    def __post_init__(self) -> None:
        if not 0 < self.dec_mult < 1:
            raise ValueError("dec_mult must be in (0, 1)")
        if self.inc_step <= 0:
            raise ValueError("inc_step must be > 0")
        if self.max_bs_cap < self.min_bs:
            raise ValueError("max_bs_cap must be >= min_bs")


@dataclasses.dataclass(frozen=True)
class ProxyConfig:
    """Top-level MLProxy configuration for one endpoint."""

    sla: SLAConfig
    monitor: MonitorConfig = dataclasses.field(default_factory=MonitorConfig)
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    # Safety margin subtracted from every dispatch timeout to cover proxy
    # overhead (serialization, queue hop). The paper folds this into the
    # upstream latency estimate; we expose it explicitly.
    dispatch_overhead: float = 0.0
    # Batch-size bucketing for fixed-shape accelerators (beyond paper —
    # TPU adaptation). ``None`` disables; ``"pow2"`` rounds dispatch sizes
    # up to powers of two and keys monitor windows by bucket; an explicit
    # ascending tuple of bucket sizes (the engine's ``batch_buckets``)
    # rounds up within the tuple and clamps above its largest entry.
    bucketing: Union[None, str, Tuple[int, ...]] = None
    # Bucket-aware batch packing: when set to the engine's batch buckets,
    # the scheduler's full-trigger rounds Max_BS up to the next bucket
    # edge and dispatches exactly at it. Latency within a bucket is the
    # padded bucket's latency (the monitor keys by it), so topping a
    # forming batch up to the edge is free throughput — the extra
    # requests ride in slots that would otherwise be padding. ``None``
    # disables (dispatch at the raw Max_BS). Setting ``pack_buckets``
    # without ``bucketing`` implies ``bucketing = pack_buckets``.
    pack_buckets: Optional[Tuple[int, ...]] = None

    def __post_init__(self) -> None:
        if isinstance(self.bucketing, (tuple, list)):
            object.__setattr__(self, "bucketing",
                               validate_buckets(self.bucketing, "bucketing"))
        elif self.bucketing not in (None, "pow2"):
            raise ValueError(f"unknown bucketing {self.bucketing!r}")
        if self.pack_buckets is not None:
            object.__setattr__(
                self, "pack_buckets",
                validate_buckets(self.pack_buckets, "pack_buckets"))
            if self.bucketing is None:
                object.__setattr__(self, "bucketing", self.pack_buckets)


def validate_buckets(buckets, what: str = "buckets") -> Tuple[int, ...]:
    """Normalize an explicit bucket tuple: ints, positive, ascending."""
    out = tuple(int(b) for b in buckets)
    if not out:
        raise ValueError(f"{what} must be non-empty")
    if any(b <= 0 for b in out) or any(
            a >= b for a, b in zip(out, out[1:])):
        raise ValueError(f"{what} must be positive and ascending, got {out}")
    return out


def bucket_of(batch_size: int,
              scheme: Union[None, str, Tuple[int, ...]]) -> int:
    """Map a raw batch size to its compiled bucket under ``scheme``.

    ``scheme`` may be None (identity), ``"pow2"``, or an explicit
    ascending tuple of bucket sizes; with a tuple, sizes above the
    largest bucket clamp to it (the dispatch path chunks them).
    """
    if scheme is None or batch_size <= 1:
        return batch_size
    if isinstance(scheme, tuple):
        for b in scheme:
            if batch_size <= b:
                return b
        return scheme[-1]
    if scheme == "pow2":
        return 1 << (batch_size - 1).bit_length()
    raise ValueError(f"unknown bucketing {scheme!r}")
