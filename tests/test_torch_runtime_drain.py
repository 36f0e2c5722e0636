"""``drain()`` of the port's live runtime always hands control back to the loop.

A batch task that has just finished stays in the server's set of in-flight
tasks until the event loop runs its done-callback. Since Python 3.12
``asyncio.gather`` over tasks that are all done completes without yielding,
so a drain that waits for that set to empty spins forever. These tests pin
the repair in ``repro_torch.runtime.server``:

* the hedging, resubmit and retry scenarios that hung in the JAX package's
  tests, run against the port with the same assertions;
* a direct regression: ``drain()`` and ``drain(timeout=)``, on ``FakeClock``
  and on ``WallClock``, each reached while a finished batch task still waits
  for its done-callback, return with the drained ledger conserved.

Each test runs under this module's ``TIME_LIMIT`` (``tests/conftest.py``),
so a drain that spins fails the test instead of hanging the run.
"""
import asyncio
import time

import numpy as np
import pytest

from repro_torch.core import SLAConfig, ms
from repro_torch.core.request import Request
from repro_torch.runtime import (AsyncProxyServer, FakeClock, RuntimeConfig,
                                 SyntheticTarget, TargetError, WallClock, run)
from repro_torch.serverless.latency import AffineLatency, get_workload
from time_limits import time_limit

#: seconds each test may run; every test here takes well under one
TIME_LIMIT = 20.0


def _spin(seconds):
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        pass


def test_a_caught_time_limit_fires_again():
    caught = 0
    with pytest.raises(pytest.fail.Exception, match="time limit of 0.05 s"):
        with time_limit(0.05, repeat=0.05):
            try:
                _spin(5.0)
            except pytest.fail.Exception:
                caught += 1
            _spin(5.0)
            raise AssertionError("the time limit fired only once")
    assert caught == 1


SLA = SLAConfig(slo_target=ms(500))
WL = get_workload("pytorch-fashion-mnist")
#: deterministic 50 ms upstream, so fault timing asserts are exact
DET = AffineLatency(a=0.05, c=0.0, noise_cv=0.0)


class _ScriptedTarget:
    """Deterministic target whose call latencies follow a script."""

    max_batch = None

    def __init__(self, clock, script):
        self.clock = clock
        self.script = list(script)
        self.calls = 0
        self.completed = 0
        self.cancelled = 0

    async def __call__(self, batch, deadline=None):
        delay = self.script[min(self.calls, len(self.script) - 1)]
        self.calls += 1
        try:
            await self.clock.sleep(delay)
        except asyncio.CancelledError:
            self.cancelled += 1
            raise
        self.completed += 1


class FlakyTarget(SyntheticTarget):
    """Fails the first ``fail_first`` dispatch attempts, then succeeds."""

    def __init__(self, *args, fail_first=2, **kw):
        super().__init__(*args, **kw)
        self.fail_first = fail_first
        self.attempts_seen = 0

    async def __call__(self, batch, deadline=None):
        self.attempts_seen += 1
        if self.attempts_seen <= self.fail_first:
            raise RuntimeError(f"flaky attempt {self.attempts_seen}")
        return await super().__call__(batch, deadline=deadline)


def _passthrough(clock, target, config=None, sla=SLA):
    server = AsyncProxyServer(clock=clock, config=config)
    server.add_endpoint("ep", sla=sla, target=target, policy="passthrough")
    return server


# ------------------------------------------------- scenarios that hung
def test_hedge_fires_and_winner_cancels_loser():
    clock = FakeClock()
    target = _ScriptedTarget(clock, [10.0, 0.05])  # primary stuck
    server = _passthrough(clock, target,
                          RuntimeConfig(hedge_quantile=95.0, hedge_min_samples=10))
    monitor = server.frontend.endpoint("ep").policy.monitor
    for _ in range(10):  # bucket-1 window warm: hedge threshold 0.1 s
        monitor.record_upstream(1, 0.1, 0.0)

    async def main():
        await server.start()
        ticket = server.submit(endpoint="ep")
        await ticket.future
        await server.drain()
        return ticket

    ticket = run(clock, main())
    assert not ticket.timed_out
    # hedge armed at 0.1 (p95 of primed window), wins at 0.1 + 0.05
    assert clock.now() == pytest.approx(0.15)
    assert server.hedged_batches == 1 and server.hedge_wins == 1
    assert target.calls == 2
    assert target.completed == 1 and target.cancelled == 1
    assert server.completed == 1
    server.assert_conserved(require_drained=True)


def test_resubmit_after_completion_is_allowed():
    clock = FakeClock()
    server = _passthrough(clock, SyntheticTarget(WL, clock, rng=np.random.default_rng(0)))

    async def main():
        await server.start()
        req = Request(arrival_time=clock.now())
        await server.submit(req, endpoint="ep").future
        req.completion_time = None  # recycle the id after completion
        await server.submit(req, endpoint="ep").future
        await server.drain()

    run(clock, main())
    assert server.completed == 2


def test_flaky_target_recovers_within_budget():
    clock = FakeClock()
    target = FlakyTarget(DET, clock, rng=np.random.default_rng(0), fail_first=2)
    server = _passthrough(clock, target, RuntimeConfig(max_retries=4, retry_backoff=0.02,
                                                       retry_jitter=0.0))

    async def main():
        await server.start()
        ticket = server.submit(endpoint="ep")
        await ticket.future
        await server.drain()
        return ticket

    ticket = run(clock, main())
    assert ticket.error is None and not ticket.timed_out
    c = server.conservation()
    assert c["completed"] == 1 and c["failed"] == 0
    assert c["retried_batches"] == 1
    assert c["faulted_batches"] == 1 and c["recovered_batches"] == 1
    assert len(server.retry_log) == 2
    # failed attempts feed the monitor's retry stats, not its latency
    stats = server.frontend.endpoint("ep").policy.stats(clock.now())
    assert stats["failed_attempts"] == 2
    assert 0.0 < stats["failure_rate"] < 1.0


def test_exhausted_budget_resolves_target_error():
    clock = FakeClock()
    target = FlakyTarget(DET, clock, rng=np.random.default_rng(0), fail_first=10**9)
    server = _passthrough(clock, target, RuntimeConfig(max_retries=2, retry_backoff=0.02,
                                                       retry_jitter=0.0))

    async def main():
        await server.start()
        ticket = server.submit(endpoint="ep")
        with pytest.raises(TargetError) as err:
            await ticket.future
        await server.drain()
        return err.value

    err = run(clock, main())
    assert err.attempts == 3  # first try + 2 retries
    assert isinstance(err.__cause__, RuntimeError)
    c = server.conservation()
    assert c["failed"] == 1 and c["target_failures"] == 1
    assert c["retry_exhausted"] == 1 and c["lost"] == 0


def test_backoff_never_scheduled_past_deadline():
    """Leftover deadline budget < backoff → ``timed_out``, not failed."""
    clock = FakeClock()
    target = FlakyTarget(DET, clock, rng=np.random.default_rng(0), fail_first=10**9)
    server = _passthrough(clock, target,
                          RuntimeConfig(max_retries=5, retry_backoff=0.2, retry_jitter=0.0),
                          sla=SLAConfig(slo_target=ms(100), deadline_factor=1.0))

    async def main():
        await server.start()
        ticket = server.submit(endpoint="ep")
        await ticket.future
        await server.drain()
        return ticket

    ticket = run(clock, main())
    assert ticket.timed_out and not ticket.rejected
    c = server.conservation()
    assert c["timed_out"] == 1 and c["failed"] == 0
    assert c["retry_exhausted"] == 0  # deadline won, not the budget
    assert server.retry_log == []  # the retry was never scheduled


# ------------------------------------------------------ direct regression
class _GatedTarget:
    """Target that parks every call until the test releases it."""

    max_batch = None

    def __init__(self):
        self.entered = asyncio.Event()
        self.gate = None

    async def __call__(self, batch, deadline=None):
        self.gate = asyncio.get_running_loop().create_future()
        self.entered.set()
        await self.gate


@pytest.mark.parametrize("clock_cls", [FakeClock, WallClock])
@pytest.mark.parametrize("timeout", [None, 5.0])
def test_drain_returns_while_a_finished_batch_awaits_its_callback(clock_cls, timeout):
    clock = clock_cls()
    target = _GatedTarget()
    server = _passthrough(clock, target)

    async def main():
        await server.start()
        ticket = server.submit(endpoint="ep")
        await target.entered.wait()
        target.gate.set_result(None)
        if timeout is None:
            # the resolved ticket wakes us before the loop runs the
            # finished batch task's done-callback
            await ticket.future
            assert [t.done() for t in server._batch_tasks] == [True]
            await server.drain()
        else:
            # the target returns during drain's first yield and the batch
            # task finishes one turn later, after drain has made its
            # waiter: the waiter's first look finds the finished task
            # still in the set, its done-callback queued behind it
            await server.drain(timeout=timeout)
        return ticket

    ticket = run(clock, main())
    assert ticket.error is None and not ticket.timed_out
    c = server.assert_conserved(require_drained=True)
    assert c["submitted"] == 1 and c["completed"] == 1
