"""Percentiles that count a failure."""
from __future__ import annotations

import math
from typing import Sequence

#: what a percentile that lands on a failed request reads, in ms: the
#: request never completed, so its latency is +inf; JSON has no infinity,
#: so the line carries this (11.6 days), beyond any real latency
FAILED_MS = 1e9


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100): the smallest
    value with at least q% of the values at or below it. +inf values (the
    failures) rank last, and the result is +inf where they reach q."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def as_ms(seconds: float) -> float:
    """Seconds to ms, with +inf written as :data:`FAILED_MS`."""
    return FAILED_MS if math.isinf(seconds) else 1e3 * seconds

