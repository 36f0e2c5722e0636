"""The engine's compiled programs, as far as the CPU can check them.

On the card ``InferenceEngine.generate`` replays one CUDA graph per
prefill key and one per decode-loop key (``tests/test_torch_kernels_cuda.py
::TestEngineOnCard`` and ``chip_smoke.py`` hold the replays to the eager
per-token loop there). Here: the CPU runs eagerly and counts the JAX
engine's keys; the capture-and-replay bookkeeping (static inputs, graphs
bound to the pooled cache, a pool miss, launch counts) runs with a stand-in
for the graph that reruns the captured function; and the per-thread launch
recording counts a capture once and each replay exactly, beside another
thread's launches.
"""
import inspect
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import InferenceEngine as JInferenceEngine
from repro_torch import convert
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import CapturedGraph, EngineConfig, InferenceEngine

TINY = dict(name="tiny-graphs", family="dense", num_layers=1, d_model=16, num_heads=2,
            num_kv_heads=1, head_dim=16, d_ff=32, vocab_size=64, max_seq_len=64,
            param_dtype="float32", compute_dtype="float32", remat=False,
            scan_layers=False)
ENGINE = dict(batch_buckets=(1, 2, 4), prompt_buckets=(4, 8), max_len=24, gen_len=8)


@pytest.fixture(scope="module")
def params():
    return InferenceEngine(ModelConfig(**TINY), EngineConfig(**ENGINE), device="cpu").params


def _engine(params, **kw):
    return InferenceEngine(ModelConfig(**TINY), EngineConfig(**{**ENGINE, **kw}),
                           params=params, device="cpu")


# ------------------------------------------------------------- the keys
@pytest.mark.parametrize("fused", [True, False])
def test_compile_count_matches_jax_engine(fused):
    """The same calls count the same keys: (bucket, plen) prefill, (bucket,
    steps) fused loop or bucket per-token step — what the JAX engine
    compiles a program for and the port captures a graph for on the card."""
    kw = dict(ENGINE, fused_decode=fused)
    jeng = JInferenceEngine(JModelConfig(**TINY), JEngineConfig(**kw),
                            rng=jax.random.PRNGKey(0))
    teng = InferenceEngine(ModelConfig(**TINY), EngineConfig(**kw),
                           params=convert.from_jax(jax.device_get(jeng.params)), device="cpu")
    rng = np.random.default_rng(0)
    for (n, plen), gen_len in (((1, 4), 8), ((3, 5), 8), ((1, 3), 1), ((1, 4), 8)):
        prompts = rng.integers(0, TINY["vocab_size"], (n, plen)).astype(np.int32)
        want, _ = jeng.generate(prompts, gen_len=gen_len)
        got, _ = teng.generate(prompts, gen_len=gen_len)
        np.testing.assert_array_equal(got, want)
        assert teng.compile_count == jeng.compile_count
    assert teng.compile_count == (5 if fused else 4)


def test_cpu_generate_is_eager(params):
    eng = _engine(params)
    eng.generate(np.ones((3, 4), np.int32))
    eng.generate(np.ones((3, 4), np.int32))
    assert eng.graph_pool is None and eng.graphs == {} and eng.graph_replays == 0


def test_no_device_wide_synchronize_in_engine_or_ops():
    """A replica waits only for its own stream, and captures without
    ``torch.cuda.graph``, whose entry synchronises the whole device."""
    for mod in (engine_mod, kops):
        src = inspect.getsource(mod)
        assert "cuda.synchronize" not in src, mod.__name__
        assert "cuda.graph(" not in src, mod.__name__


# ------------------------------------------------------- capture and replay
class _Rerun:
    """Stands in for a CUDA graph on the CPU: a replay reruns the captured
    function on the static input into the static output."""

    def __init__(self, fn, inp, out):
        self.fn, self.inp, self.out = fn, inp, out

    def replay(self):
        self.out.copy_(self.fn(self.inp))


def _capturing(eng, monkeypatch):
    """Make ``eng`` capture as on the card, with :class:`_Rerun` graphs."""
    def capture(fn, inp, cache):
        with kops.recording() as launches:
            out = fn(inp)
        return CapturedGraph(_Rerun(fn, inp, out), inp, out, cache, dict(launches))

    eng.graph_pool = "stand-in"
    monkeypatch.setattr(eng, "_capture", capture)
    return eng


@pytest.mark.parametrize("max_len", [24, 10])
def test_replays_bound_graphs_with_the_per_token_tokens(params, monkeypatch, max_len):
    """First use of a key: an eager run, then its capture; later batches
    in the bucket replay both graphs from their static inputs and give the
    per-token loop's tokens, across batches through the pooled cache and
    (max_len 10 < plen + gen_len - 1) past the cache's end. A pool miss
    drops the bucket's graphs and captures them again on the new cache."""
    eng = _capturing(_engine(params, max_len=max_len), monkeypatch)
    ref = _engine(params, max_len=max_len, fused_decode=False)
    rng = np.random.default_rng(max_len)

    def batch(n, plen=8):
        p = rng.integers(0, TINY["vocab_size"], (n, plen)).astype(np.int32)
        np.testing.assert_array_equal(eng.generate(p)[0], ref.generate(p)[0])

    batch(4)
    assert set(eng.graphs) == {("prefill", 4, 8), ("fused", 4, 8)} and eng.graph_replays == 0
    bound = eng.graphs[("prefill", 4, 8)].cache
    batch(3)
    batch(4)
    assert eng.graph_replays == 4 and eng.graphs[("fused", 4, 8)].cache is bound
    batch(4, plen=3)  # a new prefill key: eager, then captured; the loop replays
    assert eng.graph_replays == 5 and ("prefill", 4, 4) in eng.graphs
    eng._kv_pool.clear()  # a cache lost mid-batch: the next call misses the pool
    batch(4)
    assert eng.graph_replays == 5 and eng.cache_allocs == 2
    assert set(eng.graphs) == {("prefill", 4, 8), ("fused", 4, 8)}
    assert eng.graphs[("prefill", 4, 8)].cache is not bound
    batch(3)
    assert eng.graph_replays == 7


@pytest.mark.parametrize("kw", [dict(fused_decode=False), dict(cache_pool=False)])
def test_fresh_cache_or_per_token_never_captures(params, monkeypatch, kw):
    """A fresh cache a batch, or the per-token reference: always eager."""
    eng = _capturing(_engine(params, **kw), monkeypatch)
    for _ in range(2):
        eng.generate(np.ones((2, 4), np.int32))
    assert eng.graphs == {} and eng.graph_replays == 0


def test_replay_adds_its_recorded_launches(params):
    eng = _engine(params)
    out = torch.zeros(2)
    g = CapturedGraph(_Rerun(lambda t: t + 1, torch.ones(2), out), torch.ones(2), out,
                      None, {"flash_attention": 3, "decode_attention": 7})
    kops.reset_launches()
    try:
        for _ in range(2):
            eng._replay(g)
        assert kops.launches() == {"flash_attention": 6, "decode_attention": 14,
                                   "mlstm_attention": 0, "ssd_scan": 0}
        assert eng.graph_replays == 2 and torch.equal(out, torch.full((2,), 2.0))
    finally:
        kops.reset_launches()


# ----------------------------------------------------- launch recording
def test_launch_recording_is_per_thread_and_exact(monkeypatch):
    """A capturing thread's launches go into its recording, not the
    shared counts, while another thread counts real launches at the same
    moment; each replay then adds the recording. Nothing is lost."""
    def stub():
        pass

    stub.launches = 0
    monkeypatch.setitem(kops.WRAPPERS, "stub", stub)
    both = threading.Barrier(2, timeout=30.0)
    real, recorded = 20_000, 3
    found = {}

    def capturing():
        with kops.recording() as rec:
            both.wait()
            for _ in range(recorded):
                kops.count_launch(stub)
            both.wait()
            found["rec"] = dict(rec)

    def launching():
        both.wait()
        for _ in range(real):
            kops.count_launch(stub)
        both.wait()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=capturing), threading.Thread(target=launching)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert found["rec"] == {"stub": recorded} and stub.launches == real
    for _ in range(2):  # two replays
        kops.add_launches(found["rec"])
    assert stub.launches == real + 2 * recorded
    kops.count_launch(stub)  # the recording ended with its block
    assert stub.launches == real + 2 * recorded + 1
    with kops.recording():
        with pytest.raises(RuntimeError):
            with kops.recording():
                pass
