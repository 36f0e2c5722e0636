"""Wall-clock asyncio serving runtime — the live mirror of the simulator.

Layer map (README "Live runtime"): the same routing/policy/queue core the
simulators drive (`ProxyFrontend` → `Policy` → `BatchQueue`) is driven
here by real timers (:mod:`repro.runtime.clock`), real dispatch execution
against pluggable targets (:mod:`repro.runtime.targets`), replayed
arrival processes (:mod:`repro.runtime.loadgen`), the sim↔real
calibration bridge (:mod:`repro.runtime.calibrate`), and the fault
tolerance layer — deterministic chaos injection
(:mod:`repro.runtime.faults`) and per-endpoint circuit breaking
(:mod:`repro.runtime.breaker`).
"""
from repro_torch.runtime.breaker import BreakerConfig, CircuitBreaker
from repro_torch.runtime.calibrate import BucketStat, Calibration, measure_engine
from repro_torch.runtime.clock import Clock, FakeClock, WallClock, run
from repro_torch.runtime.faults import (CrashFault, FaultConfig, FaultyTarget,
                                  InjectedFault, PartialBatchFault,
                                  PreemptedFault, UpstreamTimeout, fault_rng)
from repro_torch.runtime.loadgen import (LoadGenerator, ReplayResult, run_replay)
from repro_torch.runtime.server import (AsyncProxyServer, BrownoutShed,
                                  DeadlineExceeded, DrainTimeout,
                                  RequestTicket, RuntimeConfig, TargetError,
                                  clamp_policy_kwargs)
from repro_torch.runtime.targets import DispatchTarget, EngineTarget, SyntheticTarget

__all__ = [
    "AsyncProxyServer",
    "BreakerConfig",
    "BrownoutShed",
    "BucketStat",
    "Calibration",
    "CircuitBreaker",
    "Clock",
    "CrashFault",
    "DeadlineExceeded",
    "DispatchTarget",
    "DrainTimeout",
    "EngineTarget",
    "FakeClock",
    "FaultConfig",
    "FaultyTarget",
    "InjectedFault",
    "LoadGenerator",
    "PartialBatchFault",
    "PreemptedFault",
    "ReplayResult",
    "RequestTicket",
    "RuntimeConfig",
    "SyntheticTarget",
    "TargetError",
    "UpstreamTimeout",
    "WallClock",
    "clamp_policy_kwargs",
    "fault_rng",
    "measure_engine",
    "run",
    "run_replay",
]
