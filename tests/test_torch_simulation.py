"""The port's simulator and serverless platform against the JAX package's.

* Every control-plane module the port copies equals its JAX original once
  the import statements are pointed at ``repro_torch``.
* The JAX and port simulators, given the same keyword arguments, seed and
  a ``PAPER_WORKLOADS`` latency model, return equal summaries (NaN-aware,
  exact: the code and the numpy streams are the same) for three policies
  and a two-tier multi-endpoint run; over a stub engine with a fixed
  latency per bucket the two ``EngineBackedLatency`` models agree, and so
  do the simulators driven by them.
* The port's driver serves reduced qwen2 on the CPU behind its
  ``EngineBackedLatency`` (the mirror of ``tests/test_e2e.py``'s
  engine-in-the-loop test), restores a snapshot, and keys its rate and
  SLO on the median of its samples. In the two runs that serve through
  the engine, the simulation's service times come from warm calls taken
  before the run and held fixed (``EngineBackedLatency(fixed=True)``,
  ``launch/serve.py --fixed-latency``), so a host loaded by other tests moves
  none of their decisions.
"""
import importlib
import json
import math
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from repro.serving.batcher import EngineBackedLatency as JEngineBackedLatency
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.serving.batcher import EngineBackedLatency as TEngineBackedLatency
from repro_torch.serving.engine import EngineConfig, InferenceEngine, next_bucket

ROOT = Path(__file__).resolve().parents[1]
PKGS = ("repro", "repro_torch")
COPIED = (
    [f"core/{m}.py" for m in ("batch_queue", "config", "monitor", "optimizer", "proxy",
                              "request", "scheduler", "policies", "frontend")]
    + [f"obs/{m}.py" for m in ("metrics", "burnrate", "trace")]
    + [f"simulation/{m}.py" for m in ("events", "traces", "arrivals", "stats", "simulator")]
    + [f"serverless/{m}.py" for m in ("latency", "platform", "tiers")]
)
_IMPORT = re.compile(r"^(\s*(?:from|import)\s+)repro\.", re.M)


@pytest.mark.parametrize("rel", COPIED)
def test_port_module_is_a_verbatim_copy(rel):
    want = _IMPORT.sub(r"\1repro_torch.", (ROOT / "src" / "repro" / rel).read_text())
    got = (ROOT / "src" / "repro_torch" / rel).read_text()
    assert got == want, f"src/repro_torch/{rel} differs from its JAX original beyond imports"


def test_every_copied_module_of_the_simulation_slice_is_listed():
    for sub in ("simulation", "serverless"):
        here = {p.name for p in (ROOT / "src" / "repro" / sub).glob("*.py")} - {"__init__.py"}
        assert {f"{sub}/{n}" for n in here} <= set(COPIED)


# ------------------------------------------------------ JAX vs port runs
def _m(pkg, mod):
    return importlib.import_module(f"{pkg}.{mod}")


def _same_summary(a, b):
    assert a.keys() == b.keys()
    diff = {k: (a[k], b[k]) for k in a
            if not (a[k] == b[k] or (math.isnan(a[k]) and math.isnan(b[k])))}
    assert not diff, diff


def _single(pkg, policy, workload=None, duration=90.0):
    core, lat = _m(pkg, "core"), _m(pkg, "serverless.latency")
    kwargs = {"clipper": {"update_interval": 5.0},
              "mlproxy": {"bucketing": "pow2",
                          "optimizer": core.OptimizerConfig(update_interval=5.0,
                                                            initial_max_bs=2)},
              }.get(policy, {})
    return _m(pkg, "simulation.simulator").run_simulation(
        policy=policy, sla=core.SLAConfig(slo_target=0.4),
        workload=workload or lat.get_workload("keras-toxic"),
        arrivals=_m(pkg, "simulation.arrivals").PoissonProcess(rate=60.0, duration=duration),
        platform_config=_m(pkg, "serverless.platform").PlatformConfig(
            initial_scale=1, cold_start=0.5),
        duration=duration, seed=3, policy_kwargs=kwargs)


@pytest.mark.parametrize("policy", ["mlproxy", "passthrough", "clipper"])
def test_simulator_matches_jax(policy):
    j, t = (_single(pkg, policy) for pkg in PKGS)
    _same_summary(j.summary, t.summary)
    np.testing.assert_array_equal(j.e2e_latencies, t.e2e_latencies)
    assert t.summary["completed"] > 1000 and t.summary["cold_starts"] >= 0


def _tiered(pkg):
    sim, core = _m(pkg, "simulation.simulator"), _m(pkg, "core")
    tiers = _m(pkg, "serverless.tiers")
    arrivals = _m(pkg, "simulation.arrivals")
    spec = sim.EndpointSpec(
        policy="mlproxy", sla=core.SLAConfig(slo_target=0.5),
        workload=_m(pkg, "serverless.latency").get_workload("sklearn-iris"),
        arrivals=arrivals.PoissonProcess(rate=40.0, duration=60.0),
        tiers=(tiers.TierSpec(name="cheap", cost_weight=1.0, latency_scale=2.0,
                              max_inflight=4),
               tiers.TierSpec(name="fast", cost_weight=3.0)))
    other = sim.EndpointSpec(
        policy="passthrough", sla=core.SLAConfig(slo_target=0.5),
        workload=_m(pkg, "serverless.latency").get_workload("keras-toxic"),
        arrivals=arrivals.PoissonProcess(rate=20.0, duration=60.0))
    return sim.MultiEndpointSimulator({"a": spec, "b": other}, duration=60.0,
                                      seed=5).run()


def test_two_tier_multi_endpoint_simulator_matches_jax():
    j, t = (_tiered(pkg) for pkg in PKGS)
    _same_summary(j.summary, t.summary)
    assert j.endpoints.keys() == t.endpoints.keys()
    for name in j.endpoints:
        _same_summary(j.endpoints[name], t.endpoints[name])
    assert json.dumps(j.tiers, sort_keys=True, default=str) == \
        json.dumps(t.tiers, sort_keys=True, default=str)
    assert t.tiers and t.summary["completed"] > 0


class StubEngine:
    """The engine surface ``EngineBackedLatency`` reads, with a fixed
    latency per batch bucket."""

    def __init__(self):
        self.ecfg = SimpleNamespace(batch_buckets=(1, 2, 4, 8, 16, 32))
        self.cfg = SimpleNamespace(vocab_size=100)
        self.calls = 0

    def generate(self, prompts, gen_len=None):
        self.calls += 1
        bucket = next_bucket(len(prompts), self.ecfg.batch_buckets)
        return (np.zeros((len(prompts), gen_len or 4), np.int32),
                {"bucket": bucket, "latency_s": 0.03 + 0.004 * bucket})


def test_engine_backed_latency_matches_jax_over_a_stub_engine():
    seed_timings = {(2, 16): 0.05, (8, 16): 0.07, (8, 64): 0.2}
    j = JEngineBackedLatency(StubEngine(), prompt_len=16, gen_len=4)
    t = TEngineBackedLatency(StubEngine(), prompt_len=16, gen_len=4)
    for m in (j, t):
        m.seed(seed_timings)
    for size in (1, 2, 3, 5, 8, 20, 32, 33, 70):
        assert t.mean(size) == j.mean(size)
    for size in (1, 3, 9, 32, 40):
        assert t.sample(size, np.random.default_rng(size)) == \
            j.sample(size, np.random.default_rng(size))
        assert t.mean(size) == j.mean(size)
    assert t.engine.calls == j.engine.calls > 0

    runs = [_single(pkg, "mlproxy", workload=cls(StubEngine(), prompt_len=16, gen_len=4),
                    duration=60.0)
            for pkg, cls in zip(PKGS, (JEngineBackedLatency, TEngineBackedLatency))]
    _same_summary(runs[0].summary, runs[1].summary)
    assert runs[1].summary["avg_batch_size"] > 1.0


def test_fixed_latency_keeps_the_fastest_warm_call_of_each_bucket():
    class Slowed(StubEngine):  # every third call 20x slower (a loaded host)
        def generate(self, prompts, gen_len=None):
            tokens, timing = super().generate(prompts, gen_len)
            if self.calls % 3 == 0:
                timing = dict(timing, latency_s=20 * timing["latency_s"])
            return tokens, timing

    lat = TEngineBackedLatency(Slowed(), prompt_len=16, gen_len=4, fixed=True)
    warm = lat.warm_timings(calls=5)
    assert warm == {(b, 16): 0.03 + 0.004 * b for b in (1, 2, 4, 8, 16, 32)}
    assert lat.engine.calls == 30
    lat.seed(warm)
    rng = np.random.default_rng(0)
    for size in (1, 3, 3, 3, 9, 32):  # each batch runs; none moves the estimate
        assert lat.sample(size, rng) == lat.mean(size)
    assert lat.sample(40, rng) == lat.mean(32) + lat.mean(8)  # two chunks
    assert lat.mean(3) == 0.03 + 0.004 * 4
    assert lat.engine.calls == 30 + 8


# ------------------------------------------------- the port's driver, CPU
def test_engine_in_the_loop_serving_on_the_cpu():
    """MLProxy driving the port's engine on the CPU (hybrid sim): batches
    grow. The mirror of ``tests/test_e2e.py::test_engine_in_the_loop_serving``,
    with the service times of warm calls taken before the run, held fixed
    (``EngineBackedLatency(fixed=True)``): a loaded host moves no decision."""
    sim_mod, core = _m("repro_torch", "simulation.simulator"), _m("repro_torch", "core")
    cfg = get_config("qwen2-0.5b").reduced()
    ecfg = EngineConfig(batch_buckets=(1, 2, 4, 8), prompt_buckets=(16,), max_len=24,
                        gen_len=2)
    eng = InferenceEngine(cfg, ecfg, seed=0, device="cpu")
    eng.warmup(plen=16)
    lat = TEngineBackedLatency(eng, prompt_len=8, gen_len=2, fixed=True)
    lat.seed(lat.warm_timings())
    batches0 = eng.stats["batches"]
    res = sim_mod.run_simulation(
        policy="mlproxy", sla=core.SLAConfig(slo_target=2.0), workload=lat,
        arrivals=_m("repro_torch", "simulation.arrivals").PoissonProcess(rate=20.0,
                                                                         duration=25.0),
        platform_config=_m("repro_torch", "serverless.platform").PlatformConfig(
            initial_scale=1, cold_start=0.2),
        duration=25.0, seed=0,
        policy_kwargs={"bucketing": "pow2",
                       "optimizer": core.OptimizerConfig(update_interval=4.0,
                                                         initial_max_bs=2)})
    s = res.summary
    assert s["completed"] > 100
    # real wall-clock engine latencies vary run to run; the claim under
    # test is that batches FORM (>1), not a specific operating point
    assert s["avg_batch_size"] > 1.2
    assert eng.stats["batches"] > batches0  # the run's batches ran on the engine


def test_driver_snapshot_restores_the_first_runs_max_bs(tmp_path, monkeypatch, capsys):
    # --fixed-latency: launch/serve.py's service times are warm calls taken
    # before each run, so the host's load during the two runs moves no AIMD
    # decision. Those warm calls are timed on the wall clock too (the fastest
    # of five, slower beside busy test workers: the p95 then nears the 2 s
    # SLO and the backlog can outlive the run), so here each bucket's time is
    # fixed: every batch still runs on the engine, and the two runs'
    # decisions no longer depend on the host
    monkeypatch.setattr(TEngineBackedLatency, "warm_timings", lambda self, calls=5: {
        (b, self.prompt_len): 0.004 + 0.001 * b
        for b in self.engine.ecfg.batch_buckets})
    snap = tmp_path / "proxy_state.json"
    argv = ["serve", "--reduced", "--device", "cpu", "--gen-len", "2", "--duration", "8",
            "--rate", "40", "--slo-ms", "2000", "--snapshot", str(snap), "--fixed-latency"]
    monkeypatch.setattr("sys.argv", argv)
    serve.main()
    first = json.loads(snap.read_text())["optimizer"]["max_bs"]
    out = capsys.readouterr().out
    assert "restored" not in out and "proxy state saved" in out
    assert first > 2  # the AIMD optimizer moved off its initial Max_BS
    serve.main()
    out = capsys.readouterr().out
    restored = re.search(r"restored proxy state \(Max_BS=([\d.]+)\)", out)
    assert restored and float(restored.group(1)) == first
    m = re.search(r"(\d+) of (\d+) requests", out)
    assert m and m.group(1) == m.group(2)


def test_offered_load_keys_on_the_median_of_the_samples():
    rate, slo = serve.offered_load([0.9, 0.2, 0.25, 0.3, 5.0])
    assert slo == pytest.approx(10 * 0.3) and rate == pytest.approx(0.8 * 2 / 0.3)
    # one slow or fast outlier moves nothing
    assert serve.offered_load([0.2, 0.25, 0.3, 0.35, 0.4]) == \
        serve.offered_load([0.01, 0.25, 0.3, 0.35, 40.0])
    assert serve.offered_load([0.1] * 6, batch=4) == pytest.approx((0.8 * 4 / 0.1, 1.0))
    with pytest.raises(ValueError):
        serve.offered_load([0.3, 0.3, 0.3, 0.3])


def test_time_samples_are_timed_generate_calls_at_the_pair():
    cfg = get_config("qwen2-0.5b").reduced()
    eng = InferenceEngine(cfg, serve.engine_config(full_size=False, gen_len=2), seed=0,
                          device="cpu")
    samples = serve.time_samples(eng, 16, batch=2, n=5)
    assert len(samples) == 5 and all(t > 0 for t in samples)
    assert eng.prefill_calls == 5 and eng.stats["requests"] == 10
