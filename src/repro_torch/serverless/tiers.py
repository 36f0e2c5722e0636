"""Heterogeneous fleet tiers: TierSpec + TieredPlatform.

The single :class:`~repro.serverless.platform.ServerlessPlatform` models
one container type; real deployments mix tiers with distinct cost and
latency curves — cheap-slow vs expensive-fast instance families, and
spot-style *preemptible* capacity that the provider can reclaim
mid-batch. :class:`TierSpec` declares one such tier;
:class:`TieredPlatform` owns one ``ServerlessPlatform`` per tier behind
the same submit/conservation surface, so every driver that speaks to a
platform (simulators, benches, chaos suites) works unchanged against a
tiered fleet.

Cost is tracked per tier as a billable-seconds integral and combined
through each tier's ``cost_weight`` (relative $/container-second):
``cost_integral = Σ_tier weight × container_seconds``. The conservation
invariant — ``submitted == completed + queued + inflight`` with zero
lost and zero duplicated batches — is checkable *per tier* and in
aggregate (:meth:`TieredPlatform.assert_conserved` does both), plus one
tier-boundary identity: every batch submitted to the TieredPlatform
landed on exactly one member tier.

Determinism: a 1-tier fleet reuses the caller's RNG streams untouched
and is byte-identical to an untirered ``ServerlessPlatform`` run; an
N-tier fleet shares the service stream (draws happen in event order
regardless of tier) but spawns one fault stream per tier, so chaos on
one tier cannot shift fault draws on another.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.frontend import SpilloverRouter, TierRoute
from repro_torch.core.request import Batch
from repro_torch.serverless.latency import LatencyModel, ScaledLatency
from repro_torch.serverless.platform import PlatformConfig, ServerlessPlatform
from repro_torch.simulation.events import EventQueue


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One fleet tier: its economics, its fleet shape, its router guards.

    ``platform`` overrides the fleet-wide base :class:`PlatformConfig`
    (None = inherit); ``capacity`` caps the tier's ``max_scale`` on top
    of whichever config applies. Latency comes from ``latency`` (an
    explicit per-tier model) or ``latency_scale`` applied to the shared
    base model (1.0 = identical to base). ``preemptible`` tiers lose
    billable containers mid-batch with probability ``preempt_prob`` per
    attempt (the platform's ``preempt`` fault; requeued through the
    attempt ledger, never lost). The ``max_inflight`` /
    ``queue_depth_max`` / ``latency_threshold`` guards feed the
    :class:`~repro.core.frontend.SpilloverRouter` (0 disables each).
    """

    name: str
    cost_weight: float = 1.0
    platform: Optional[PlatformConfig] = None
    latency: Optional[LatencyModel] = None
    latency_scale: float = 1.0
    capacity: Optional[int] = None
    preemptible: bool = False
    preempt_prob: float = 0.0
    max_inflight: int = 0
    queue_depth_max: int = 0
    latency_threshold: float = 0.0

    def __post_init__(self) -> None:
        if not self.name:
            raise ValueError("TierSpec needs a non-empty name")
        if self.cost_weight <= 0:
            raise ValueError(f"tier {self.name!r}: cost_weight must be > 0")
        if self.latency_scale <= 0:
            raise ValueError(f"tier {self.name!r}: latency_scale must be > 0")
        if not 0.0 <= self.preempt_prob <= 1.0:
            raise ValueError(f"tier {self.name!r}: preempt_prob not in [0,1]")
        if self.preempt_prob > 0 and not self.preemptible:
            raise ValueError(
                f"tier {self.name!r}: preempt_prob > 0 requires preemptible")

    def as_route(self) -> TierRoute:
        """The router-facing slice of this spec."""
        return TierRoute(
            name=self.name, cost_weight=self.cost_weight,
            max_inflight=self.max_inflight,
            queue_depth_max=self.queue_depth_max,
            latency_threshold=self.latency_threshold)

    def effective_config(self, base: PlatformConfig) -> PlatformConfig:
        """Resolve the tier's PlatformConfig against the fleet base."""
        cfg = self.platform if self.platform is not None else base
        overrides: dict = {}
        if self.capacity is not None:
            overrides["max_scale"] = self.capacity
        if self.preemptible and self.preempt_prob > 0:
            overrides["preempt_prob_per_batch"] = self.preempt_prob
        return dataclasses.replace(cfg, **overrides) if overrides else cfg

    def effective_latency(self, base: LatencyModel) -> LatencyModel:
        """Resolve the tier's latency model against the fleet base."""
        if self.latency is not None:
            return self.latency
        if self.latency_scale != 1.0:
            return ScaledLatency(base=base, scale=self.latency_scale,
                                 name=f"{getattr(base, 'name', 'base')}"
                                      f"@{self.name}")
        return base


def routes_for(tiers: Sequence[TierSpec]) -> List[TierRoute]:
    """TierRoutes for a tier list (SpilloverRouter input)."""
    return [t.as_route() for t in tiers]


def make_router(tiers: Sequence[TierSpec], *,
                queue_probe: Optional[Callable[[str], int]] = None,
                tracer=None, **kwargs) -> SpilloverRouter:
    """A SpilloverRouter over ``tiers`` (cheapest-first preference)."""
    return SpilloverRouter(routes_for(tiers), queue_probe=queue_probe,
                           tracer=tracer, **kwargs)


class TieredPlatform:
    """N ServerlessPlatforms (one per tier) behind one platform surface.

    Batches arrive already stamped with ``batch.tier`` (by a
    :class:`~repro.core.frontend.SpilloverRouter` at the dispatch seam);
    unstamped batches land on the *default* tier — the cheapest by
    ``cost_weight`` — so a tier-oblivious driver degrades to a
    single-fleet run rather than erroring.
    """

    def __init__(
        self,
        tiers: Sequence[TierSpec],
        latency_model: LatencyModel,
        events: EventQueue,
        rng: np.random.Generator,
        on_batch_done: Callable[[Batch, float, float], None],
        base_config: Optional[PlatformConfig] = None,
        fault_rng: Optional[np.random.Generator] = None,
        tracer=None,
        recorder=None,
    ) -> None:
        """Mirror of ``ServerlessPlatform.__init__`` with ``tiers`` in
        place of a single config.

        RNG plumbing is the byte-identity seam: with one tier, ``rng``
        and ``fault_rng`` are handed to the member platform untouched
        (identical draw sequence to an untirered run); with N > 1 tiers
        the service ``rng`` is shared and ``fault_rng`` is spawned into
        one independent child stream per tier.
        """
        tiers = tuple(tiers)
        if not tiers:
            raise ValueError("TieredPlatform needs at least one tier")
        names = [t.name for t in tiers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tier names: {names}")
        base = base_config if base_config is not None else PlatformConfig()
        self.tiers: Tuple[TierSpec, ...] = tiers
        self.specs: Dict[str, TierSpec] = {t.name: t for t in tiers}
        # cheapest tier wins the default slot (stable on cost ties)
        self.default_tier: str = min(
            tiers, key=lambda t: t.cost_weight).name
        self.events = events
        self.on_batch_done = on_batch_done

        shared_faults = fault_rng if fault_rng is not None else rng
        if len(tiers) == 1:
            fault_streams = [shared_faults]
        else:
            fault_streams = shared_faults.spawn(len(tiers))

        self.platforms: Dict[str, ServerlessPlatform] = {}
        for t, faults in zip(tiers, fault_streams):
            self.platforms[t.name] = ServerlessPlatform(
                config=t.effective_config(base),
                latency_model=t.effective_latency(latency_model),
                events=events,
                rng=rng,
                on_batch_done=on_batch_done,
                fault_rng=faults,
                tracer=tracer,
                recorder=recorder,
            )

        # tier-boundary ledger: every submit lands on exactly one tier
        self.submitted_batches = 0
        self.default_routed = 0  # batches that arrived with no tier stamp

    # ------------------------------------------------------------------ api
    def platform(self, tier: str) -> ServerlessPlatform:
        return self.platforms[tier]

    @property
    def tier_names(self) -> Tuple[str, ...]:
        return tuple(t.name for t in self.tiers)

    def start(self, now: float) -> None:
        for p in self.platforms.values():
            p.start(now)

    def submit(self, batch: Batch, now: float) -> None:
        """Route one upstream batch to its stamped (or default) tier."""
        tier = batch.tier
        if tier is None:
            batch.tier = tier = self.default_tier
            self.default_routed += 1
        try:
            plat = self.platforms[tier]
        except KeyError:
            raise KeyError(f"batch stamped with unknown tier {tier!r}; "
                           f"fleet has {sorted(self.platforms)}") from None
        self.submitted_batches += 1
        plat.submit(batch, now)

    def tier_queue_depth(self, tier: str) -> int:
        """Router queue probe: the tier's platform-side queue depth."""
        return self.platforms[tier].queued_batches

    # ------------------------------------------------------------ aggregates
    @property
    def billable_count(self) -> int:
        return sum(p.billable_count for p in self.platforms.values())

    def ready_count(self, now: float) -> int:
        return sum(p.ready_count(now) for p in self.platforms.values())

    @property
    def queued_batches(self) -> int:
        return sum(p.queued_batches for p in self.platforms.values())

    @property
    def cold_starts(self) -> int:
        return sum(p.cold_starts for p in self.platforms.values())

    @property
    def peak_containers(self) -> int:
        # sum of per-tier peaks (an upper bound on the fleet-wide peak:
        # tier peaks need not coincide in time)
        return sum(p.peak_containers for p in self.platforms.values())

    @property
    def container_seconds(self) -> float:
        """Unweighted billable-seconds integral across tiers."""
        return sum(p.container_seconds for p in self.platforms.values())

    @property
    def cost_integral(self) -> float:
        """Weighted cost: Σ tier ``cost_weight × container_seconds``."""
        return sum(self.specs[name].cost_weight * p.container_seconds
                   for name, p in self.platforms.items())

    def cost_by_tier(self) -> Dict[str, Dict[str, float]]:
        """Per-tier billing breakdown (seconds, weight, weighted cost)."""
        return {
            name: {
                "container_seconds": p.container_seconds,
                "cost_weight": self.specs[name].cost_weight,
                "cost_integral": (self.specs[name].cost_weight
                                  * p.container_seconds),
            }
            for name, p in self.platforms.items()
        }

    # --------------------------------------------------------------- billing
    def reset_billing(self, now: float) -> None:
        for p in self.platforms.values():
            p.reset_billing(now)

    def finalize(self, now: float) -> None:
        for p in self.platforms.values():
            p.finalize(now)

    def avg_containers(self, duration: float) -> float:
        """Unweighted average fleet size over ``duration``."""
        return self.container_seconds / duration if duration > 0 else 0.0

    def weighted_cost(self, duration: float) -> float:
        """Weighted cost rate over ``duration`` — the paper's "number of
        containers" metric with per-tier $-weights applied."""
        return self.cost_integral / duration if duration > 0 else 0.0

    # --------------------------------------------------------------- metrics
    def register_metrics(self, registry, prefix: str = "platform") -> None:
        """Bind per-tier ledgers plus the tier-boundary counters."""
        b = registry.bind
        b(f"{prefix}.submitted_batches", lambda: self.submitted_batches)
        b(f"{prefix}.default_routed", lambda: self.default_routed)
        b(f"{prefix}.cost_integral", lambda: self.cost_integral)
        for name, p in self.platforms.items():
            p.register_metrics(registry, prefix=f"{prefix}.{name}")

    # --------------------------------------------------------- conservation
    def conservation(self) -> dict:
        """Aggregate conservation ledger (key-wise sum over tiers)."""
        agg: Dict[str, int] = {}
        for p in self.platforms.values():
            for k, v in p.conservation().items():
                agg[k] = agg.get(k, 0) + v
        return agg

    def conservation_by_tier(self) -> Dict[str, dict]:
        return {name: p.conservation()
                for name, p in self.platforms.items()}

    def assert_conserved(self, require_drained: bool = False) -> dict:
        """Per-tier AND aggregate conservation, plus the tier boundary.

        Raises ``AssertionError`` if any member tier violates its ledger
        invariant, or if the tier boundary leaked: the sum of per-tier
        submissions must equal the batches this TieredPlatform accepted
        (every batch landed on exactly one tier).
        """
        for name, p in self.platforms.items():
            try:
                p.assert_conserved(require_drained=require_drained)
            except AssertionError as exc:
                raise AssertionError(f"tier {name!r}: {exc}") from None
        agg = self.conservation()
        if agg["submitted_batches"] != self.submitted_batches:
            raise AssertionError(
                "tier boundary leak: platform accepted "
                f"{self.submitted_batches} batches but tiers saw "
                f"{agg['submitted_batches']}: {self.conservation_by_tier()}")
        accounted = (agg["completed_batches"] + agg["queued_batches"]
                     + agg["inflight_batches"])
        if accounted != agg["submitted_batches"]:
            raise AssertionError(
                f"aggregate conservation imbalance: {agg}")
        return agg
