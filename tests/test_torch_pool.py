"""The port's ReplicaPool concurrency, ReplicaPoolTarget deadline aborts,
EngineTarget deadline translation (the stub-engine tests of
``tests/test_pool_parallel.py`` and ``tests/test_deadlines.py``, over the
port), and exact kernel launch counts under threads.

Concurrent callers overlap on DIFFERENT replicas (each replica has its own
lock), while calls landing on the SAME replica serialize: a replica's KV
pool is not thread-safe.
"""
import asyncio
import sys
import threading
import time

import numpy as np
import pytest

import repro_torch.serving.engine as engine_mod
from repro_torch.core.request import Batch, Request
from repro_torch.kernels import ops
from repro_torch.runtime import FakeClock
from repro_torch.runtime.targets import EngineTarget
from repro_torch.serving.batcher import ReplicaPoolTarget
from repro_torch.serving.engine import ReplicaPool


class _BlockingStubEngine:
    """Stub engine whose generate() parks on an event, tracking overlap."""

    entered = 0
    peak = 0
    _mu = threading.Lock()
    release = threading.Event()

    def __init__(self, cfg, engine_cfg, params=None, seed=0, device="cpu"):
        self.cfg = cfg
        self.engine_cfg = engine_cfg
        self.params = params if params is not None else object()
        self.device = device

    def generate(self, prompts, gen_len=None):
        cls = _BlockingStubEngine
        with cls._mu:
            cls.entered += 1
            cls.peak = max(cls.peak, cls.entered)
        try:
            assert cls.release.wait(timeout=10.0), "stub never released"
        finally:
            with cls._mu:
                cls.entered -= 1
        return prompts[:, :1], {"latency_s": 0.0, "bucket": len(prompts)}


@pytest.fixture
def blocking_pool(monkeypatch):
    monkeypatch.setattr(engine_mod, "InferenceEngine", _BlockingStubEngine)
    _BlockingStubEngine.entered = 0
    _BlockingStubEngine.peak = 0
    _BlockingStubEngine.release = threading.Event()
    return lambda n: ReplicaPool(cfg=None, engine_cfg=None, n_replicas=n, device="cpu")


def _run_concurrent(pool, n_callers):
    threads = [threading.Thread(
        target=lambda: pool.generate(np.zeros((1, 4), np.int32)))
        for _ in range(n_callers)]
    for t in threads:
        t.start()
    return threads


def test_concurrent_callers_overlap_on_distinct_replicas(blocking_pool):
    pool = blocking_pool(3)
    threads = _run_concurrent(pool, 3)
    # all three callers must be INSIDE generate simultaneously — each on
    # its own replica — before anyone is released
    for _ in range(200):
        if _BlockingStubEngine.entered == 3:
            break
        threading.Event().wait(0.01)
    assert _BlockingStubEngine.entered == 3, "callers serialized"
    _BlockingStubEngine.release.set()
    for t in threads:
        t.join(timeout=10.0)
    assert _BlockingStubEngine.peak == 3


def test_same_replica_calls_serialize(blocking_pool):
    pool = blocking_pool(1)
    threads = _run_concurrent(pool, 3)
    for _ in range(500):  # up to 5 s for the first caller to get in
        if _BlockingStubEngine.entered == 1:
            break
        threading.Event().wait(0.01)
    # give the other callers a chance to (wrongly) enter
    threading.Event().wait(0.05)
    assert _BlockingStubEngine.entered == 1, "replica lock not enforced"
    _BlockingStubEngine.release.set()
    for t in threads:
        t.join(timeout=10.0)
    assert _BlockingStubEngine.peak == 1  # never more than one inside


class _CountingStubEngine:
    def __init__(self, cfg, engine_cfg, params=None, seed=0, device="cpu"):
        self.cfg = cfg
        self.engine_cfg = engine_cfg
        self.params = params if params is not None else object()
        self.device = device
        self.fail = False
        self.calls = 0

    def generate(self, prompts, gen_len=None):
        if self.fail:
            raise RuntimeError("injected replica failure")
        self.calls += 1
        return prompts[:, :1], {"latency_s": 0.001, "bucket": len(prompts)}


def test_failed_replica_lock_is_released(monkeypatch):
    monkeypatch.setattr(engine_mod, "InferenceEngine", _CountingStubEngine)
    pool = ReplicaPool(cfg=None, engine_cfg=None, n_replicas=2, device="cpu")
    pool.replicas[0].fail = True
    pool.replicas[1].fail = True
    with pytest.raises(RuntimeError, match="no healthy replicas"):
        pool.generate(np.zeros((1, 4), np.int32))
    # the failover path must not leak a held lock on the failed replicas
    assert all(not lk.locked() for lk in pool._locks)
    pool.recover(0)
    pool.replicas[0].fail = False
    _, timing = pool.generate(np.zeros((1, 4), np.int32))
    assert timing["replica"] == 0


def test_serial_calls_visit_all_replicas(monkeypatch):
    """Idle-preferring acquisition degrades to strict round-robin when
    calls are serial: every replica still serves traffic."""
    monkeypatch.setattr(engine_mod, "InferenceEngine", _CountingStubEngine)
    pool = ReplicaPool(cfg=None, engine_cfg=None, n_replicas=4, device="cpu")
    seen = [pool.generate(np.zeros((1, 4), np.int32))[1]["replica"]
            for _ in range(8)]
    assert sorted(set(seen)) == [0, 1, 2, 3]
    assert all(r.calls == 2 for r in pool.replicas)


# ------------------------------------------------------- deadline aborts
class _FakeChunkPool:
    """Stands in for ReplicaPool in the chunked target path: each
    generate() advances a fake clock by 1.0s."""

    class engine_cfg:
        batch_buckets = (1, 2, 4)

    def __init__(self):
        self.now = 0.0
        self.calls = 0

    def clock(self):
        return self.now

    def generate(self, prompts, gen_len=None):
        self.calls += 1
        self.now += 1.0
        return np.ones((len(prompts), 2), np.int32), {
            "latency_s": 1.0, "bucket": len(prompts)}


def _batch(n):
    return Batch(requests=[Request(arrival_time=0.0) for _ in range(n)],
                 dispatch_time=0.0, cause="full")


def test_deadline_aborts_remaining_chunks():
    pool = _FakeChunkPool()
    done = []
    target = ReplicaPoolTarget(pool, prompt_len=4, clock=pool.clock,
                               on_done=lambda b, lat, now: done.append(lat))
    batch = _batch(10)  # chunks of 4, 4, 2
    out, timing = target(batch, deadline=0.5)  # passes after chunk 1
    assert pool.calls == 1
    assert timing["chunks"] == 1
    assert timing["deadline_aborted"] == 6
    assert target.deadline_aborted == 6
    assert out.shape[0] == 10
    for req in batch.requests[:4]:
        assert req.payload is not None and not req.timed_out
    for req in batch.requests[4:]:
        assert req.timed_out and req.payload is None
    assert (out[4:] == 0).all()  # aborted tail rows zero-padded
    assert done == [pytest.approx(1.0)]  # on_done fired once, measured


def test_no_deadline_runs_every_chunk():
    pool = _FakeChunkPool()
    target = ReplicaPoolTarget(pool, prompt_len=4, clock=pool.clock)
    batch = _batch(10)
    _, timing = target(batch)
    assert pool.calls == 3
    assert timing["chunks"] == 3
    assert "deadline_aborted" not in timing
    assert all(r.payload is not None for r in batch.requests)


def test_first_chunk_always_runs_even_past_deadline():
    # the chunk already being formed is dispatched — only FOLLOW-UP
    # chunks are abortable (a running generate() is not interruptible)
    pool = _FakeChunkPool()
    target = ReplicaPoolTarget(pool, prompt_len=4, clock=pool.clock)
    batch = _batch(6)
    _, timing = target(batch, deadline=-1.0)
    assert pool.calls == 1
    assert timing["deadline_aborted"] == 2
    assert not batch.requests[0].timed_out


def test_unchunked_batch_ignores_deadline():
    pool = _FakeChunkPool()
    target = ReplicaPoolTarget(pool, prompt_len=4, clock=pool.clock)
    batch = _batch(4)  # fits the largest bucket: single engine call
    _, timing = target(batch, deadline=-1.0)
    assert pool.calls == 1
    assert all(not r.timed_out for r in batch.requests)


# ------------------------------------- EngineTarget deadline clock domains
class _StubPoolTarget:
    """ReplicaPoolTarget stand-in: a measurement clock on its OWN epoch
    (raw monotonic starts at machine uptime, not at server start)."""

    class _Cfg:
        batch_buckets = (1, 2, 4)

    class _Pool:
        engine_cfg = None  # set below
        replicas = [object()]

    def __init__(self, epoch=1000.0):
        self.pool = self._Pool()
        self.pool.engine_cfg = self._Cfg()
        self._epoch = epoch
        self.seen = []

    def clock(self):
        return self._epoch

    def __call__(self, batch, deadline=None):
        self.seen.append(deadline)


class TestEngineTargetDeadlineDomains:
    """Runtime-clock deadlines (small, epoch = server start) are carried
    onto the pool target's monotonic clock (huge, epoch = machine boot) as
    a remaining budget, never forwarded raw."""

    def test_deadline_translated_into_pool_clock_domain(self):
        clock = FakeClock()
        stub = _StubPoolTarget(epoch=1000.0)
        target = EngineTarget(stub, clock=clock)
        asyncio.run(target(_batch(1), deadline=0.75))
        # remaining budget 0.75s carried onto the pool's epoch
        assert stub.seen == [pytest.approx(1000.75)]

    def test_without_runtime_clock_forwards_none_not_wrong_epoch(self):
        stub = _StubPoolTarget(epoch=1000.0)
        target = EngineTarget(stub)  # no runtime clock wired
        asyncio.run(target(_batch(1), deadline=0.75))
        assert stub.seen == [None]

    def test_no_deadline_stays_none(self):
        stub = _StubPoolTarget()
        target = EngineTarget(stub, clock=FakeClock())
        asyncio.run(target(_batch(1)))
        assert stub.seen == [None]


# --------------------------------------------------- launch counts, threaded
class _YieldingCount:
    """A wrapper-like object whose ``launches`` read gives up the GIL, so
    an unguarded ``launches += 1`` from two threads loses additions."""

    def __init__(self):
        self._n = 0

    @property
    def launches(self):
        n = self._n
        time.sleep(0)
        return n

    @launches.setter
    def launches(self, n):
        self._n = n


def _bump_from_threads(wrapper, n_threads, per_thread):
    start = threading.Barrier(n_threads)

    def bump():
        start.wait()
        for _ in range(per_thread):
            ops.count_launch(wrapper)

    threads = [threading.Thread(target=bump) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    assert not any(t.is_alive() for t in threads)


def test_launch_counts_stay_exact_under_threads():
    """Eight threads add to a count through ``count_launch``, the path
    every wrapper takes after a launch: no addition is lost, neither on a
    count whose read yields the GIL nor on a wrapper's own count with the
    interpreter switching threads as often as it can."""
    yielding = _YieldingCount()
    _bump_from_threads(yielding, 8, 500)
    assert yielding.launches == 8 * 500

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    ops.reset_launches()
    try:
        _bump_from_threads(ops.decode_attention, 8, 20_000)
        counts = ops.launches()
    finally:
        sys.setswitchinterval(old)
        ops.reset_launches()
    assert counts == {"flash_attention": 0, "decode_attention": 8 * 20_000,
                      "mlstm_attention": 0, "ssd_scan": 0}
