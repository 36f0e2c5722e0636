"""The open loop's arithmetic: due times, what counts, and the tails."""
import math
import time

import numpy as np
import pytest

from perfbench.lib import live, stats, traffic

POISSON = {"process": "poisson", "rate": 40.0}
MMPP2 = {"process": "mmpp2", "rate": 40.0, "low_share": 0.4,
         "high_share": 1.6, "mean_dwell_low_s": 1.0, "mean_dwell_high_s": 1.0}


@pytest.mark.parametrize("arrivals", [POISSON, MMPP2], ids=["poisson", "mmpp2"])
def test_arrivals_are_the_cells_and_prompts_the_seeds(arrivals):
    a = traffic.schedule(arrivals, 2.0, 10.0, 5.0)
    assert np.array_equal(a.due, traffic.schedule(arrivals, 2.0, 10.0, 5.0).due)
    assert np.all(np.diff(a.due) >= 0)
    w = a.due[a.counted()]
    assert len(w) > 200 and w.min() >= 2.0 and w.max() < 12.0
    # each phase on a stream of its own: the window is no copy of the tail
    window, tail = (traffic.phase_arrivals(arrivals, 5.0, p) for p in ("window", "tail"))
    assert not np.array_equal(window, tail)
    p1, p2 = (traffic.prompt(s, 7, 16, 100) for s in (1, traffic.seed_key(2 ** 31 + 7)))
    assert not np.array_equal(p1, p2)
    assert np.array_equal(p1, traffic.prompt(1, 7, 16, 100))
    assert p1.dtype == np.int32 and p1.min() >= 0 and p1.max() < 100


def test_mmpp2_alternates_its_rates():
    rng = np.random.default_rng(3)
    times = traffic.mmpp2_window(5.0, 80.0, 2.0, 2.0, 400.0, rng)
    assert np.all(np.diff(times) >= 0) and times.max() < 400.0
    per_s = np.bincount(times.astype(int), minlength=400)
    # a mean near (5 + 80) / 2 with seconds near each rate
    assert 30 < len(times) / 400 < 55
    assert (per_s <= 10).mean() > 0.3 and (per_s >= 50).mean() > 0.3


def test_percentile_counts_failures_as_infinite():
    lat = [0.1] * 94 + [0.2] + [math.inf] * 5
    assert stats.percentile(lat, 95) == 0.2
    assert stats.percentile(lat + [math.inf], 95) == math.inf
    assert stats.as_ms(math.inf) == stats.FAILED_MS
    assert stats.percentile([3.0, 1.0, 2.0], 50) == 2.0
    rec = live.RequestRecord(index=0, due=1.0, counted=True, complete=1.5)
    assert rec.latency == 0.5
    rec.failure = "failed"
    assert rec.latency == math.inf


class _Engine:
    def __init__(self):
        self.ecfg = type("E", (), {"batch_buckets": (1, 2, 4)})()


class _Pool:
    """A pool of one replica that answers at once: the test is about the
    generator and the clock, not the model."""
    engine_cfg = type("E", (), {"batch_buckets": (1, 2, 4), "gen_len": 2})()
    cfg = type("C", (), {"vocab_size": 16})()

    def __init__(self):
        self.replicas = [_Engine()]

    def generate(self, prompts, gen_len=None):
        n = prompts.shape[0]
        return np.ones((n, gen_len), np.int32), {
            "latency_s": 1e-4, "bucket": 4 if n > 2 else n, "prompt_bucket": prompts.shape[1],
            "replica": 0}


MIX = {"prompt_len": 4, "gen_len": 2, "policy": "passthrough", "policy_settings": {},
       "arrivals": {"process": "poisson", "rate": 50.0},
       "slo_ms": 1000.0, "lead_in_s": 0.2, "drain_limit_s": 5.0, "profile_slice_s": 0.1}


def test_a_stall_of_the_generator_raises_every_later_latency(monkeypatch):
    model = {"vocab_size": 16}
    sched = traffic.schedule(MIX["arrivals"], MIX["lead_in_s"], 1.0, 5.0)
    stall_at = int(sched.counted()[5])
    prompt = traffic.prompt

    def slow_prompt(seed, index, n, vocab):
        if index == stall_at:
            time.sleep(0.4)  # the generator stalls before submitting this one
        return prompt(seed, index, n, vocab)

    monkeypatch.setattr(traffic, "prompt", slow_prompt)
    rec = live.serve(_Pool(), model, MIX, 9, 1.0)
    by_index = {r.index: r for r in rec.requests}
    stalled = by_index[stall_at]
    late = [r for r in rec.counted() if stalled.due <= r.due < stalled.due + 0.3]
    assert len(late) >= 3
    for r in late:  # submitted after the stall, so each waited from its due time
        assert r.submit >= stalled.due + 0.4 - 0.02
        assert r.latency >= stalled.due + 0.4 - r.due - 0.02
    early = [r for r in rec.counted() if r.due < stalled.due - 0.05]
    assert early and max(r.latency for r in early) < 0.2
    assert all(r.failure is None for r in rec.counted())
