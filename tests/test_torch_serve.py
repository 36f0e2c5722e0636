"""The port's control-plane copies and serving loop.

The port's ``MLProxy`` and the JAX package's, driven by the same event
loop over one seeded request stream with a synthetic latency, make the
same dispatches and end with the same ``stats()``; and the port's serving
loop answers every request on the CPU with the reduced engine.
"""
import numpy as np
import pytest

import repro.core as jcore
import repro_torch.core as tcore
from repro_torch.launch import serve
from repro_torch.configs import get_config
from repro_torch.serving.engine import ReplicaPool


def _run(core, seed, bucketing, rate):
    rng = np.random.default_rng(seed)
    arrivals = serve.poisson_arrivals(400, rate, rng)
    cfg = core.ProxyConfig(sla=core.SLAConfig(slo_target=0.5),
                           optimizer=core.OptimizerConfig(update_interval=2.0,
                                                          initial_max_bs=2),
                           bucketing=bucketing)
    return serve.run_event_loop(
        lambda dispatch: core.MLProxy(cfg, dispatch_fn=dispatch),
        arrivals, [None] * len(arrivals),
        lambda batch: 0.02 + 0.004 * batch.effective_size)


@pytest.mark.parametrize("seed,bucketing,rate", [(0, "pow2", 60.0), (1, None, 150.0)])
def test_port_mlproxy_dispatches_like_the_jax_package(seed, bucketing, rate):
    j = _run(jcore, seed, bucketing, rate)
    t = _run(tcore, seed, bucketing, rate)
    assert [(r["dispatch"], r["size"], r["cause"]) for r in t["batches"]] == \
        [(r["dispatch"], r["size"], r["cause"]) for r in j["batches"]]
    assert t["stats"] == j["stats"]
    assert max(r["size"] for r in t["batches"]) >= 2  # batches formed


def test_serve_loop_on_cpu_answers_every_request_in_batches():
    cfg = get_config("qwen2-0.5b").reduced()
    ecfg = serve.engine_config(full_size=False, gen_len=4)
    pool = ReplicaPool(cfg, ecfg, seed=0, device="cpu")
    result = serve.run_proxy_loop(
        pool, n_requests=40, rate=200.0, prompt_len=16, seed=0,
        optimizer=tcore.OptimizerConfig(update_interval=5.0, initial_max_bs=2))
    s = serve.summarize(result)
    assert s["requests"] == s["completed"] == 40
    assert result["stats"]["dispatched_requests"] == 40
    assert s["avg_batch"] > 1.0
    for r in result["requests"]:
        toks = np.asarray(r.payload)
        assert toks.shape == (4,) and 0 <= toks.min() and toks.max() < cfg.vocab_size
    assert pool.replicas[0].stats["requests"] == 40
