"""Algorithm 2 — the low-frequency AIMD dynamic batch optimizer.

Every ``update_interval`` seconds (paper: 30 s), compare the monitored
end-to-end response-time percentile and the timeout-dispatch ratio against
their thresholds; on violation apply multiplicative decrease, otherwise
additive increase:

    violation = (TO_ratio > TO_thresh) or (RT_p95 > compliance_factor · SLO)
    Max_BS    = Max_BS × dec_mult      if violation
    Max_BS    = Max_BS + inc_step      otherwise

``Max_BS`` is kept as a float internally (so repeated ×0.8 decreases
compose exactly as in the paper) and exposed as an integer ≥ 1.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from repro_torch.core.config import OptimizerConfig, SLAConfig
from repro_torch.core.monitor import SmartMonitor


class AIMDBatchOptimizer:
    """Paper-faithful AIMD controller for ``Max_BS``."""

    def __init__(
        self,
        config: OptimizerConfig,
        sla: SLAConfig,
        monitor: SmartMonitor,
    ) -> None:
        self.config = config
        self.sla = sla
        self.monitor = monitor
        self._max_bs = float(config.initial_max_bs)
        self._last_update: Optional[float] = None
        self.history: List[Tuple[float, float, bool]] = []  # (t, max_bs, violation)

    # ------------------------------------------------------------------ api
    @property
    def max_bs(self) -> int:
        return max(self.config.min_bs, min(self.config.max_bs_cap, int(self._max_bs)))

    @property
    def max_bs_raw(self) -> float:
        return self._max_bs

    def next_update_time(self, now: float) -> float:
        if self._last_update is None:
            return now + self.config.update_interval
        return self._last_update + self.config.update_interval

    def maybe_update(self, now: float) -> bool:
        """Run one AIMD step if the interval has elapsed. Returns True if run."""
        if self._last_update is None:
            self._last_update = now
            return False
        if now - self._last_update + 1e-12 < self.config.update_interval:
            return False
        self.update(now)
        return True

    def update(self, now: float) -> None:
        """One unconditional AIMD step (lines 5–15 of Algorithm 2)."""
        rt = self.monitor.e2e_percentile(now)
        to_ratio = self.monitor.timeout_ratio()
        violation = to_ratio > self.config.to_thresh or (
            rt is not None and rt > self.sla.compliance_target
        )
        if violation:
            self._max_bs = max(float(self.config.min_bs), self._max_bs * self.config.dec_mult)
        else:
            self._max_bs = min(
                float(self.config.max_bs_cap), self._max_bs + self.config.inc_step
            )
        self._last_update = now
        self.monitor.reset_interval()
        self.history.append((now, self._max_bs, violation))

    # ------------------------------------------------------ fault tolerance
    def snapshot(self) -> dict:
        return {
            "max_bs": self._max_bs,
            "last_update": self._last_update,
            "history": list(self.history),
        }

    def restore(self, state: dict) -> None:
        self._max_bs = state["max_bs"]
        self._last_update = state["last_update"]
        self.history = list(state["history"])
