"""One open-loop run of a cell through the port's live runtime.

The path is the program's own: ``AsyncProxyServer`` with one endpoint
under the cell's policy → ``EngineTarget`` (an executor thread) →
``ReplicaPoolTarget`` → ``ReplicaPool.generate`` → ``InferenceEngine``
(its prefill and decode-loop graphs) → the models and the CUDA kernels.
The benchmark adds only a recording subclass of ``ReplicaPoolTarget``,
which notes each batch it serves (requests, prompts, tokens, the engine's
``latency_s``) and, in a traced run, starts and stops the profiler between
two batches: from the window's last ``profile_slice_s`` until every request
due in the window is resolved (the stop holds the host for seconds, so it
waits until nothing counted is left to delay).

Traffic is an open loop on the server's clock: every request is submitted
at its due time whatever is outstanding, and its latency runs from that
due time to its completion, so a late generator shows in the latency.
Only requests due inside the window count. The schedule goes on past the
window until every counted request is resolved, or the drain limit is
reached; one still unresolved then has failed.
"""
from __future__ import annotations

import asyncio
import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from perfbench.lib import traffic


@dataclasses.dataclass
class RequestRecord:
    index: int
    due: float
    counted: bool
    submit: Optional[float] = None
    dispatch: Optional[float] = None
    complete: Optional[float] = None
    #: 'rejected', 'shed', 'timed_out', 'failed', 'unfinished' or None
    failure: Optional[str] = None
    req_id: Optional[int] = None
    tokens: Optional[np.ndarray] = None

    @property
    def latency(self) -> float:
        """Due time to completion; +inf for a request that did not complete."""
        if self.failure is not None or self.complete is None:
            return math.inf
        return self.complete - self.due


@dataclasses.dataclass
class BatchRecord:
    req_ids: List[int]
    bucket: int
    plen: int
    latency_s: float     # the engine's own measure, InferenceEngine.generate
    dispatch: float      # when the policy dispatched it (server clock)
    prompts: np.ndarray  # the rows the target built
    out: np.ndarray      # the rows the engine returned
    profiled: bool = False
    #: seconds the recording target spent starting or stopping the
    #: profiler inside this batch's dispatch (0 outside a traced slice)
    overhead_s: float = 0.0

    @property
    def size(self) -> int:
        return len(self.req_ids)


@dataclasses.dataclass
class Profile:
    """A traced slice of the window: whole batches, in the order they ran."""
    events: List[tuple]      # (name, on the device, start us, end us)
    window_s: float          # host seconds from the profiler's start to its stop
    batches: List[BatchRecord]


@dataclasses.dataclass
class RunRecord:
    """What one run leaves for the metric readers and the check."""
    model: Dict[str, Any]
    mix: Dict[str, Any]
    seed: int
    seconds: float
    window: tuple
    requests: List[RequestRecord]
    batches: List[BatchRecord]
    summary: Dict[str, Any]
    conservation: Dict[str, Any]
    profile: Optional[Profile] = None
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def counted(self) -> List[RequestRecord]:
        return [r for r in self.requests if r.counted]

    def window_batches(self) -> List[BatchRecord]:
        """Batches dispatched inside the window."""
        lo, hi = self.window
        return [b for b in self.batches if lo <= b.dispatch < hi]


def policy_kwargs(settings: Dict[str, Any]) -> Dict[str, Any]:
    """The cell's policy settings as the policy takes them: a nested group
    names a config dataclass of ``repro_torch.core.config``."""
    from repro_torch.core import config as cc

    groups = {"optimizer": cc.OptimizerConfig, "monitor": cc.MonitorConfig}
    return {k: groups[k](**v) if k in groups else v for k, v in settings.items()}


def recording_target(pool, prompt_len: int, gen_len: int, clock: Callable[[], float],
                     profile_from: Optional[float] = None, stop_when=None,
                     max_profiled: int = 0):
    """A ``ReplicaPoolTarget`` over ``pool`` that records every batch. With
    ``profile_from`` (on ``clock``) it starts the profiler before the first
    batch that begins after it, and stops it after the first batch that
    ends with ``stop_when()`` true or ``max_profiled`` batches profiled."""
    from repro_torch.serving.batcher import ReplicaPoolTarget

    class Recording(ReplicaPoolTarget):
        def _prompts(self, batch):
            self.last_prompts = super()._prompts(batch)
            return self.last_prompts

        def __call__(self, batch, deadline=None):
            start = self.clock()
            if (profile_from is not None and self.profiler is None
                    and start >= profile_from):
                self._start_profile()
            began = self.clock()
            out, timing = super().__call__(batch, deadline=deadline)
            end = self.clock()
            rec = BatchRecord(
                req_ids=[r.req_id for r in batch.requests], bucket=timing["bucket"],
                plen=timing["prompt_bucket"], latency_s=timing["latency_s"],
                dispatch=batch.dispatch_time, prompts=self.last_prompts, out=np.array(out),
                profiled=self.profiler is not None and self.profile_stop is None,
                overhead_s=began - start)
            self.log.append(rec)
            if rec.profiled and (stop_when() or sum(b.profiled for b in self.log)
                                 >= max_profiled):
                self._stop_profile()
                rec.overhead_s += self.clock() - end
            return out, timing

        def _start_profile(self):
            from torch.profiler import ProfilerActivity, profile

            t0 = time.perf_counter()
            self.profiler = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.profiler.start()
            self.profile_start = time.perf_counter()
            self.profile_costs["start_s"] = self.profile_start - t0

        def _stop_profile(self):
            self.profile_stop = time.perf_counter()
            self.profiler.stop()
            self.profile_costs["stop_s"] = time.perf_counter() - self.profile_stop

    target = Recording(pool, prompt_len=prompt_len, gen_len=gen_len, clock=clock)
    target.log = []
    target.profiler = None
    target.profile_start = target.profile_stop = None
    target.profile_costs = {}
    return target


def kineto_events(profiler) -> List[tuple]:
    """(name, on the device, start us, end us) of every event the profiler
    recorded, read from its raw results (building ``FunctionEvent``s for a
    few hundred thousand kernels takes tens of seconds)."""
    out = []
    for e in profiler.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        out.append((e.name(), e.device_type().name == "CUDA", start,
                    start + e.duration_ns() / 1e3))
    return out


def warm_profiler() -> None:
    """Start and stop the profiler once in set-up, so that its first start
    (CUPTI's initialisation) does not stall a batch of the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1).add_(1)


def serve(pool, model: Dict[str, Any], mix: Dict[str, Any], seed: int, seconds: float, *,
          trace: bool = False, arrivals: Optional[Dict[str, Any]] = None,
          on_window_open: Optional[Callable[[], None]] = None) -> RunRecord:
    """Serve one run of ``mix`` on ``pool``: lead-in, the window, then the
    tail until every counted request is resolved or the drain limit.
    ``arrivals`` overrides the mix's arrival process (the knee sweep);
    ``on_window_open`` is called as the window opens (the end of set-up)."""
    from repro_torch.core.config import SLAConfig
    from repro_torch.core.request import Request
    from repro_torch.runtime import (AsyncProxyServer, DrainTimeout, EngineTarget, WallClock,
                                     run)

    arrivals = arrivals or mix["arrivals"]
    lead_in, drain = float(mix["lead_in_s"]), float(mix["drain_limit_s"])
    sched = traffic.schedule(arrivals, lead_in, seconds, drain)
    counted = np.zeros(len(sched.due), bool)
    counted[sched.counted()] = True
    prompt_len, gen_len, vocab = mix["prompt_len"], mix["gen_len"], model["vocab_size"]

    if trace:
        t0 = time.perf_counter()
        warm_profiler()
        warm_s = time.perf_counter() - t0
    clk = WallClock()
    epoch = clk.now() + 0.05  # due times count from here
    open_, close = epoch + sched.window[0], epoch + sched.window[1]
    # the traced slice: the batches that begin in the window's last
    # profile_slice_s, then those that serve its last requests; the
    # profiler's stop holds the host for seconds, so it comes only once
    # every request due in the window is resolved
    target = recording_target(
        pool, prompt_len, gen_len, clk.now,
        profile_from=close - float(mix["profile_slice_s"]) if trace else None,
        stop_when=lambda: pending["counted"] == 0,
        max_profiled=int(mix["profile_max_batches"]) if trace else 0)
    if trace:
        target.profile_costs["warm_s"] = warm_s
    server = AsyncProxyServer(clock=clk)
    server.add_endpoint("ep", sla=SLAConfig(slo_target=float(mix["slo_ms"]) / 1e3),
                        target=EngineTarget(target, clock=clk), policy=mix["policy"],
                        policy_kwargs=policy_kwargs(mix["policy_settings"]))
    records = [RequestRecord(index=i, due=epoch + float(t), counted=bool(c))
               for i, (t, c) in enumerate(zip(sched.due, counted))]
    pending = {"counted": int(counted.sum())}
    state: Dict[str, Any] = {}  # the loop's event, made inside it

    def resolved(rec: RequestRecord, fut: asyncio.Future) -> None:
        if fut.exception() is not None:
            # cancelled by the drain at the limit: it never came
            rec.failure = ("unfinished" if isinstance(fut.exception(), DrainTimeout)
                           else "failed")
        else:
            ticket = fut.result()
            req = ticket.request
            if ticket.rejected:
                rec.failure = "rejected"
            elif ticket.shed:
                rec.failure = "shed"
            elif ticket.timed_out:
                rec.failure = "timed_out"
            else:
                rec.complete = req.completion_time
                rec.tokens = None if req.payload is None else np.asarray(req.payload)
        if rec.counted:
            pending["counted"] -= 1
            if pending["counted"] == 0:
                state["done"].set()

    async def main() -> None:
        done_event = state["done"] = asyncio.Event()
        if pending["counted"] == 0:
            done_event.set()
        await server.start()
        opened = False
        for rec in records:
            if rec.due >= close and done_event.is_set():
                break  # the window's requests are resolved: the tail ends
            if rec.due >= close + drain:
                break
            if not opened and rec.due >= open_:
                await clk.sleep(max(0.0, open_ - clk.now()))
                opened = True
                if on_window_open is not None:
                    on_window_open()
            wait = rec.due - clk.now()
            if wait > 0:
                await clk.sleep(wait)
            payload = traffic.prompt(seed, rec.index, prompt_len, vocab)
            req = Request(arrival_time=clk.now(), payload=payload)
            rec.submit, rec.req_id = req.arrival_time, req.req_id
            ticket = server.submit(req, endpoint="ep")
            ticket.future.add_done_callback(lambda f, r=rec: resolved(r, f))
        if not opened and on_window_open is not None:
            on_window_open()
        try:
            await asyncio.wait_for(done_event.wait(),
                                   timeout=max(0.0, close + drain - clk.now()))
        except asyncio.TimeoutError:
            pass
        await server.drain(timeout=max(1.0, close + drain - clk.now()))

    run(clk, main())
    for rec in records:
        if rec.counted and rec.failure is None and rec.complete is None:
            rec.failure = "unfinished"
    # the queue's dispatch stamp of each request (set on the server's clock)
    dispatch = {}
    for b in target.log:
        for rid in b.req_ids:
            dispatch[rid] = b.dispatch
    for rec in records:
        if rec.req_id in dispatch:
            rec.dispatch = dispatch[rec.req_id]
    prof = None
    if target.profiler is not None:
        if target.profile_stop is None:
            target._stop_profile()
        t0 = time.perf_counter()
        prof = Profile(events=kineto_events(target.profiler),
                       window_s=target.profile_stop - target.profile_start,
                       batches=[b for b in target.log if b.profiled])
        target.profile_costs["events_s"] = time.perf_counter() - t0
        target.profile_costs["events"] = len(prof.events)
    return RunRecord(model=model, mix=mix, seed=seed, seconds=seconds,
                     window=(open_, close), requests=records, batches=list(target.log),
                     summary=server.summary(), conservation=server.conservation(),
                     profile=prof, extra={"profile_costs": target.profile_costs})
