"""Async load generation — replay the simulator's arrival processes live.

:class:`LoadGenerator` materializes an
:class:`~repro.simulation.arrivals.ArrivalProcess` into a concrete
schedule (same vectorized window sweep the simulator's arrival pump uses)
and submits one request per instant on the runtime clock, so the *same
workload* — Poisson, MMPP2, trace-modulated, or an explicit
:class:`~repro.simulation.arrivals.Schedule` — drives both the
discrete-event simulator and the wall-clock runtime.

:func:`run_replay` is the one-call harness the parity bench and tests
build on: construct a server + synthetic target + load generator for one
endpoint, run arrivals to exhaustion, drain, and hand back the summary.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.config import SLAConfig
from repro_torch.core.request import Request
from repro_torch.runtime.clock import Clock, FakeClock, run
from repro_torch.runtime.server import AsyncProxyServer, RequestTicket, RuntimeConfig
from repro_torch.runtime.targets import DispatchTarget, SyntheticTarget
from repro_torch.serverless.latency import LatencyModel
from repro_torch.simulation.arrivals import ArrivalProcess, Schedule, sample_schedule


class LoadGenerator:
    """Replays one arrival process against one server endpoint."""

    def __init__(self, server: AsyncProxyServer, arrivals: ArrivalProcess, *,
                 duration: float, rng=0, endpoint: Optional[str] = None,
                 payload_fn=None) -> None:
        if isinstance(arrivals, Schedule):
            times = arrivals.times[arrivals.times < duration]
        else:
            times = sample_schedule(arrivals, rng, duration)
        self.times = np.asarray(times, dtype=np.float64)
        self.server = server
        self.endpoint = endpoint
        self.payload_fn = payload_fn
        self.tickets: List[RequestTicket] = []

    async def run(self) -> List[RequestTicket]:
        """Submit every scheduled arrival at its instant; returns tickets."""
        clock = self.server.clock
        submit = self.server.submit
        for t in self.times:
            dt = t - clock.now()
            if dt > 0:
                await clock.sleep(dt)
            now = clock.now()
            payload = self.payload_fn() if self.payload_fn is not None else None
            req = Request(arrival_time=now, payload=payload,
                          endpoint=self.endpoint)
            self.tickets.append(submit(req, endpoint=self.endpoint))
        return self.tickets


@dataclasses.dataclass
class ReplayResult:
    """Outcome of one :func:`run_replay`."""

    summary: dict
    e2e_latencies: np.ndarray
    dispatch_log: list
    bucket_samples: Dict[int, List[float]]
    conservation: dict


def _spawn_streams(
        seed: int) -> Tuple[np.random.Generator, np.random.Generator]:
    """(arrivals, service) generators — mirrors the simulator's split."""
    arr_ss, svc_ss = np.random.SeedSequence(seed).spawn(2)
    return np.random.default_rng(arr_ss), np.random.default_rng(svc_ss)


def run_replay(*, policy: str, sla: SLAConfig, arrivals: ArrivalProcess,
               duration: float, workload: Optional[LatencyModel] = None,
               target: Optional[DispatchTarget] = None,
               target_concurrency: int = 0,
               policy_kwargs: Optional[dict] = None,
               config: Optional[RuntimeConfig] = None,
               clock: Optional[Clock] = None, seed: int = 0,
               endpoint: str = "ep", pack: bool = False) -> ReplayResult:
    """Run one endpoint's workload through the live runtime, start to drain.

    Either pass a ready ``target`` or a ``workload`` latency model (wrapped
    in a :class:`SyntheticTarget` on the service RNG stream). ``clock``
    defaults to :class:`FakeClock` — deterministic and faster than real
    time; pass :class:`~repro.runtime.clock.WallClock` for a true
    wall-clock run (the CI smoke does).
    """
    clk = clock if clock is not None else FakeClock()
    arr_rng, svc_rng = _spawn_streams(seed)
    server = AsyncProxyServer(clock=clk, config=config)
    if target is None:
        if workload is None:
            raise ValueError("need either target= or workload=")
        target = SyntheticTarget(workload, clk, rng=svc_rng,
                                 concurrency=target_concurrency)
    server.add_endpoint(endpoint, sla=sla, target=target, policy=policy,
                        policy_kwargs=policy_kwargs, pack=pack)
    gen = LoadGenerator(server, arrivals, duration=duration, rng=arr_rng,
                        endpoint=endpoint)

    async def main() -> None:
        await server.start()
        await gen.run()
        await server.drain()

    run(clk, main())
    return ReplayResult(
        summary=server.summary(),
        e2e_latencies=server.completions[endpoint].e2e.view().copy(),
        dispatch_log=list(server.dispatch_log),
        bucket_samples={b: list(v)
                        for b, v in server.bucket_samples[endpoint].items()},
        conservation=server.conservation(),
    )
