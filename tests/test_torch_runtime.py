"""The port's live runtime against the JAX package's.

* Every runtime and exporter module the port copies equals its JAX
  original once the import statements are pointed at ``repro_torch``; the
  allowed differences are the ``wallclock`` lint suppression on the two
  ``time.monotonic`` lines of ``runtime/clock.py`` and the drain repair in
  ``runtime/server.py``.
* Under ``FakeClock``, JAX and port ``run_replay`` runs with the same
  keyword arguments, seed and ``PAPER_WORKLOADS`` latency model give equal
  summaries (NaN-aware, exact) and dispatch logs: MLProxy, a baseline, a
  ``FaultyTarget`` with retries and a breaker, and a two-endpoint server.
* One batch through the JAX ``EngineTarget`` and through the port's gives
  the same tokens, exactly.
* The port's live path on the CPU: ``run_replay`` on a ``WallClock``
  against ``EngineTarget`` over two replicas of reduced qwen2, each
  request with its own prompt; batches from both replicas, served again
  alone, give the same tokens; and ``measure_engine`` over one of them.
"""
import asyncio
import importlib
import math
import re
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core.request import Batch as JBatch
from repro.core.request import Request as JRequest
from repro.runtime.targets import EngineTarget as JEngineTarget
from repro.serving.batcher import ReplicaPoolTarget as JReplicaPoolTarget
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ReplicaPool as JReplicaPool
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.config import OptimizerConfig, SLAConfig
from repro_torch.core.request import Batch, Request
from repro_torch.launch import serve
from repro_torch.runtime import (EngineTarget, WallClock, measure_engine,
                                 run_replay)
from repro_torch.serving.batcher import ReplicaPoolTarget
from repro_torch.serving.engine import EngineConfig, ReplicaPool
from repro_torch.simulation.arrivals import PoissonProcess

ROOT = Path(__file__).resolve().parents[1]
PKGS = ("repro", "repro_torch")
COPIED = ([f"runtime/{m}.py" for m in ("__init__", "clock", "targets", "breaker", "server",
                                       "faults", "loadgen", "calibrate")]
          + ["obs/export.py", "obs/recorder.py"])
_IMPORT = re.compile(r"^(\s*(?:from|import)\s+)repro\.", re.M)
#: the lint suppression the port's clock carries: the linter's wall-clock
#: allow-list names the JAX package's clock module, not the port's
SUPPRESS = "  # reprolint: disable=wallclock"
#: the drain repair in the port's server, as (JAX text, port text) pairs: on
#: Python 3.12 the JAX original's two loops spin forever once a finished batch
#: task waits in ``_batch_tasks`` for its done-callback; the port awaits only
#: the tasks not yet done, in one coroutine both drain paths call
AWAIT_BATCHES = '''    async def _await_batches(self) -> None:
        """Await in-flight batches, gathering only tasks not yet done: a
        finished task leaves ``_batch_tasks`` only once its callback runs."""
        while True:
            running = [t for t in self._batch_tasks if not t.done()]
            if not running:
                return
            await asyncio.gather(*running, return_exceptions=True)

'''
SPIN = """            while self._batch_tasks:
                await asyncio.gather(*list(self._batch_tasks),
                                     return_exceptions=True)
"""
DRAIN_REPAIR = (
    ("        if timeout is None:\n" + SPIN,
     "        if timeout is None:\n            await self._await_batches()\n"),
    ("    async def _drain_bounded(", AWAIT_BATCHES + "    async def _drain_bounded("),
    ("\n        async def settle() -> None:\n" + SPIN
     + "\n        waiter = loop.create_task(settle())\n",
     "        waiter = loop.create_task(self._await_batches())\n"),
)


@pytest.mark.parametrize("rel", COPIED)
def test_port_module_is_a_verbatim_copy(rel):
    want = _IMPORT.sub(r"\1repro_torch.", (ROOT / "src" / "repro" / rel).read_text())
    got = (ROOT / "src" / "repro_torch" / rel).read_text()
    if rel == "runtime/clock.py":
        marked = [line for line in got.splitlines() if line.endswith(SUPPRESS)]
        assert len(marked) == 2 and all("time.monotonic()" in line for line in marked)
        got = got.replace(SUPPRESS, "")
    if rel == "runtime/server.py":
        for jax_text, port_text in DRAIN_REPAIR:
            assert want.count(jax_text) == 1, jax_text
            want = want.replace(jax_text, port_text)
    assert got == want, f"src/repro_torch/{rel} differs from its JAX original beyond imports"


def test_every_runtime_module_is_listed():
    here = {f"runtime/{p.name}" for p in (ROOT / "src" / "repro" / "runtime").glob("*.py")}
    assert here <= set(COPIED)


# ------------------------------------------------ JAX vs port under FakeClock
def _m(pkg, mod):
    return importlib.import_module(f"{pkg}.{mod}")


def _same(a, b, where="summary"):
    """Equal, with NaN equal to NaN, through nested dicts and lists."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b), (where, a, b)
    else:
        assert a == b, (where, a, b)


def _kwargs(pkg, policy):
    return {"mlproxy": {"bucketing": "pow2",
                        "optimizer": _m(pkg, "core").OptimizerConfig(update_interval=5.0,
                                                                     initial_max_bs=2)},
            "clipper": {"update_interval": 5.0}}.get(policy, {})


def _replay(pkg, policy, faulty=False):
    rt, core = _m(pkg, "runtime"), _m(pkg, "core")
    workload = _m(pkg, "serverless.latency").get_workload("keras-toxic")
    kw = {}
    target = None
    if faulty:
        clk = rt.FakeClock()
        target = rt.FaultyTarget(
            rt.SyntheticTarget(workload, clk, rng=np.random.default_rng(1)), clk,
            rt.FaultConfig(crash_prob=0.05, timeout_prob=0.02, straggler_prob=0.05,
                           partial_prob=0.05, preempt_prob=0.02, seed=0))
        kw = dict(clock=clk, config=rt.RuntimeConfig(max_retries=2,
                                                     breaker=rt.BreakerConfig()))
    res = rt.run_replay(policy=policy, sla=core.SLAConfig(slo_target=0.4),
                        workload=None if faulty else workload, target=target,
                        arrivals=_m(pkg, "simulation.arrivals").PoissonProcess(
                            rate=40.0, duration=30.0),
                        duration=30.0, seed=3, policy_kwargs=_kwargs(pkg, policy), **kw)
    return res, target


@pytest.mark.parametrize("policy,faulty", [("mlproxy", False), ("clipper", False),
                                           ("mlproxy", True)],
                         ids=["mlproxy", "clipper", "mlproxy-faulty"])
def test_run_replay_matches_jax(policy, faulty):
    (j, jt), (t, tt) = (_replay(pkg, policy, faulty) for pkg in PKGS)
    _same(j.summary, t.summary)
    _same(j.dispatch_log, t.dispatch_log, "dispatch_log")
    _same(j.conservation, t.conservation, "conservation")
    np.testing.assert_array_equal(j.e2e_latencies, t.e2e_latencies)
    assert t.conservation["lost"] == 0 and t.summary["completed"] > 500
    assert len(t.dispatch_log) > 100
    if faulty:
        assert jt.fault_log == tt.fault_log
        assert t.conservation["retried_batches"] > 0 and tt.injected["crash"] > 0


def _two_endpoints(pkg):
    rt, core = _m(pkg, "runtime"), _m(pkg, "core")
    lat, arrivals = _m(pkg, "serverless.latency"), _m(pkg, "simulation.arrivals")
    clk = rt.FakeClock()
    server = rt.AsyncProxyServer(clock=clk)
    gens = []
    for i, (name, policy, workload, rate) in enumerate(
            [("a", "mlproxy", "sklearn-iris", 40.0), ("b", "passthrough", "keras-toxic", 20.0)]):
        server.add_endpoint(name, sla=core.SLAConfig(slo_target=0.5),
                            target=rt.SyntheticTarget(lat.get_workload(workload), clk,
                                                      rng=np.random.default_rng(10 + i)),
                            policy=policy, policy_kwargs=_kwargs(pkg, policy))
        gens.append(rt.LoadGenerator(server, arrivals.PoissonProcess(rate=rate, duration=20.0),
                                     duration=20.0, rng=np.random.default_rng(20 + i),
                                     endpoint=name))

    async def main():
        await server.start()
        await asyncio.gather(*(g.run() for g in gens))
        await server.drain()

    rt.run(clk, main())
    return server


def test_two_endpoint_server_matches_jax():
    j, t = (_two_endpoints(pkg) for pkg in PKGS)
    _same(j.summary(), t.summary())
    _same(list(j.dispatch_log), list(t.dispatch_log), "dispatch_log")
    cons = t.conservation()
    assert cons["lost"] == 0 and cons["completed"] > 500
    assert {entry[1] for entry in t.dispatch_log} == {"a", "b"}


# ----------------------------------------------------- EngineTarget tokens
def test_engine_target_gives_jax_tokens():
    """The setting of tests/test_torch_engine.py's token parity (reduced
    qwen2 in f32, the same weights, prompts and buckets, whose greedy path
    that test shows has no near tie), served as one Batch of 3 requests
    through each package's EngineTarget."""
    jcfg = jget_config("qwen2-0.5b").reduced()
    tcfg = get_config("qwen2-0.5b").reduced()
    kw = dict(batch_buckets=(4,), prompt_buckets=(16,), max_len=32, gen_len=8)
    jpool = JReplicaPool(jcfg, JEngineConfig(**kw), rng=jax.random.PRNGKey(0))
    params = convert.from_jax(jax.device_get(jpool.replicas[0].params))
    tpool = ReplicaPool(tcfg, EngineConfig(**kw), params=params, device="cpu")
    prompts = np.random.default_rng(0).integers(0, jcfg.vocab_size, (3, 10)).astype(np.int32)
    out = {}
    for name, (target, batch_cls, req_cls) in {
            "jax": (JEngineTarget(JReplicaPoolTarget(jpool, prompt_len=10)), JBatch, JRequest),
            "port": (EngineTarget(ReplicaPoolTarget(tpool, prompt_len=10)), Batch, Request),
    }.items():
        batch = batch_cls(requests=[req_cls(arrival_time=0.0, payload=p) for p in prompts],
                          dispatch_time=0.0, cause="full")
        asyncio.run(target(batch))
        out[name] = np.stack([np.asarray(r.payload) for r in batch.requests])
    assert out["port"].shape == (3, 8)
    np.testing.assert_array_equal(out["port"], out["jax"])


# ------------------------------------------------- the live path on the CPU
class _RecordingTarget(ReplicaPoolTarget):
    """ReplicaPoolTarget that gives every request its own prompt (seeded by
    its id) and keeps each batch's replica, requests, prompts and tokens."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.log = []

    def _prompts(self, batch):
        return np.stack([np.random.default_rng(r.req_id).integers(
            0, self.pool.cfg.vocab_size, self.prompt_len).astype(np.int32)
            for r in batch.requests])

    def __call__(self, batch, deadline=None):
        out, timing = super().__call__(batch, deadline=deadline)
        self.log.append((timing["replica"], list(batch.requests), self._prompts(batch),
                         np.array(out)))
        return out, timing


def test_live_runtime_serves_two_cpu_replicas_on_the_wall_clock():
    gen_len = 8
    pool = ReplicaPool(get_config("qwen2-0.5b").reduced(),
                       serve.engine_config(full_size=False, gen_len=gen_len),
                       n_replicas=2, seed=0, device="cpu")
    clk = WallClock()
    pool_target = _RecordingTarget(pool, prompt_len=16, gen_len=gen_len)
    res = run_replay(policy="mlproxy", sla=SLAConfig(slo_target=1.0),
                     arrivals=PoissonProcess(rate=30.0, duration=2.0), duration=2.0,
                     target=EngineTarget(pool_target, clock=clk), clock=clk, seed=0,
                     policy_kwargs={"bucketing": "pow2",
                                    "optimizer": OptimizerConfig(update_interval=5.0,
                                                                 initial_max_bs=2)})
    cons = res.conservation
    assert cons["lost"] == 0 and cons["outstanding"] == 0
    assert cons["submitted"] == (cons["completed"] + cons["rejected"] + cons["shed"]
                                 + cons["timed_out"] + cons["failed"])
    assert cons["submitted"] > 20 and cons["completed"] == cons["submitted"]
    served = [r for _, reqs, *_ in pool_target.log for r in reqs]
    assert len(served) == cons["completed"]
    for r in served:
        toks = np.asarray(r.payload)
        assert toks.shape == (gen_len,) and toks.min() >= 0
    assert {replica for replica, *_ in pool_target.log} == {0, 1}
    # batches served on the other replica's thread give, served again alone
    # on replica 0, the same tokens
    for replica in (0, 1):
        for _, _, prompts, live in [e for e in pool_target.log if e[0] == replica][:2]:
            np.testing.assert_array_equal(pool.replicas[0].generate(prompts)[0], live)
    assert all(e.stats["batches"] > 0 for e in pool.replicas)

    calib = measure_engine(pool.replicas[0], prompt_len=16, gen_len=gen_len, repeats=1)
    assert [s.bucket for s in calib.buckets] == list(pool.engine_cfg.batch_buckets)
    assert all(s.n == 1 and s.mean_s > 0 for s in calib.buckets)
