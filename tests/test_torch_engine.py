"""The port's inference engine: token parity with the JAX engine, and the
data-plane properties of ``tests/test_engine_fast.py`` (fused == per-token,
prefix-stable gen buckets, KV-pool reuse without stale rows, warmup) on
the CPU."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import InferenceEngine as JInferenceEngine
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.request import Batch, Request
from repro_torch.models import transformer as ttransformer
from repro_torch.serving.batcher import ReplicaPoolTarget
from repro_torch.serving.engine import EngineConfig, InferenceEngine, ReplicaPool

TINY = ModelConfig(
    name="tiny-fast", family="dense", num_layers=1, d_model=16,
    num_heads=2, num_kv_heads=1, head_dim=16, d_ff=32, vocab_size=64,
    max_seq_len=64, param_dtype="float32", compute_dtype="float32",
    remat=False, scan_layers=False)
BUCKETS = (1, 2, 4)
PLENS = (4, 8)
LOGIT_TOL = 1e-4  # the model parity tolerance (tests/test_torch_model.py)


def _ecfg(**kw):
    base = dict(batch_buckets=BUCKETS, prompt_buckets=PLENS, max_len=24, gen_len=8)
    base.update(kw)
    return EngineConfig(**base)


@pytest.fixture(scope="module")
def shared_params():
    return InferenceEngine(TINY, _ecfg(), device="cpu").params


def _engine(params, **kw):
    return InferenceEngine(TINY, _ecfg(**kw), params=params, device="cpu")


# ------------------------------------------------------ parity with JAX
def test_generate_matches_jax_engine_tokens():
    jcfg = jget_config("qwen2-0.5b").reduced()
    tcfg = tget_config("qwen2-0.5b").reduced()
    kw = dict(batch_buckets=(4,), prompt_buckets=(16,), max_len=32, gen_len=8)
    jeng = JInferenceEngine(jcfg, JEngineConfig(**kw), rng=jax.random.PRNGKey(0))
    params = convert.from_jax(jax.device_get(jeng.params))
    teng = InferenceEngine(tcfg, EngineConfig(**kw), params=params, device="cpu")
    prompts = np.random.default_rng(0).integers(0, jcfg.vocab_size, (3, 10)).astype(np.int32)
    want, jt = jeng.generate(prompts)

    # the greedy path must not pass through a near tie, or float error
    # could flip an argmax: check the top-2 margin of every step's logits
    padded = np.zeros((4, 16), np.int32)
    padded[:3, 6:] = prompts
    cache = ttransformer.init_cache(tcfg, 4, 32)
    logits, cache = ttransformer.prefill(tcfg, params, torch.from_numpy(padded), cache)
    steps = [logits]
    for i in range(want.shape[1] - 1):
        tok = np.zeros((4, 1), np.int64)
        tok[:3, 0] = want[:, i]
        logits, cache = ttransformer.decode_step(tcfg, params, torch.from_numpy(tok), cache)
        steps.append(logits)
    top2 = torch.cat(steps, dim=1)[:3].topk(2, dim=-1).values
    margin = float((top2[..., 0] - top2[..., 1]).min())
    assert margin > 10 * LOGIT_TOL, f"near tie on the greedy path (margin {margin:.2e})"

    got, tt = teng.generate(prompts)
    np.testing.assert_array_equal(got, want)
    assert (tt["bucket"], tt["prompt_bucket"]) == (jt["bucket"], jt["prompt_bucket"])


@pytest.mark.parametrize("max_len", [20, 32])
def test_generate_matches_jax_engine_past_max_len(max_len):
    """plen + gen_len - 1 = 23 > max_len = 20: the JAX engine decodes past
    the cache's end (its RoPE table is max_seq_len long, its cache write
    clamps onto the last row) and gives tokens; the port gives the same.
    At max_len = 32 there is room and nothing changes."""
    jcfg = jget_config("qwen2-0.5b").reduced()
    tcfg = tget_config("qwen2-0.5b").reduced()
    kw = dict(batch_buckets=(1,), prompt_buckets=(16,), max_len=max_len, gen_len=8)
    jeng = JInferenceEngine(jcfg, JEngineConfig(**kw), rng=jax.random.PRNGKey(0))
    params = convert.from_jax(jax.device_get(jeng.params))
    teng = InferenceEngine(tcfg, EngineConfig(**kw), params=params, device="cpu")
    prompts = np.random.default_rng(0).integers(0, jcfg.vocab_size, (1, 16)).astype(np.int32)
    want, _ = jeng.generate(prompts)
    got, _ = teng.generate(prompts)
    np.testing.assert_array_equal(got, want)
    per_token = InferenceEngine(tcfg, EngineConfig(fused_decode=False, **kw), params=params,
                                device="cpu")
    np.testing.assert_array_equal(per_token.generate(prompts)[0], want)


def test_decode_past_the_cache_end_writes_the_last_row():
    """The decode write clamps onto the cache's last row, as
    ``dynamic_update_slice`` does; the length keeps counting."""
    params = ttransformer.init_params(TINY, torch.Generator().manual_seed(0))
    cache = ttransformer.init_cache(TINY, 1, 4)
    _, cache = ttransformer.prefill(TINY, params, torch.ones((1, 4), dtype=torch.long), cache)
    before = cache["k"].clone()
    _, cache = ttransformer.decode_step(TINY, params, torch.full((1, 1), 5), cache)
    assert int(cache["len"]) == 5
    torch.testing.assert_close(cache["k"][:, :, :3], before[:, :, :3], rtol=0, atol=0)
    assert not torch.equal(cache["k"][:, :, 3], before[:, :, 3])


# ------------------------------------------------------------------ streams
def test_engine_never_synchronizes_the_whole_device(shared_params, monkeypatch):
    """A replica waits only for its own stream: the engine's source names
    no device-wide synchronize, and a generate() calls none."""
    import inspect

    from repro_torch.serving import engine as engine_mod

    assert "cuda.synchronize" not in inspect.getsource(engine_mod)

    def forbidden(*a, **k):
        raise AssertionError("device-wide torch.cuda.synchronize called")

    monkeypatch.setattr(torch.cuda, "synchronize", forbidden)
    eng = _engine(shared_params)
    assert eng.stream is None  # off the card: no stream, nothing changes
    out, _ = eng.generate(np.ones((2, 4), np.int32))
    assert out.shape == (2, 8)


# ------------------------------------------------------------- fused decode
@pytest.mark.parametrize("n", [1, 3, 4])
def test_fused_equals_per_token(shared_params, n):
    prompts = np.random.default_rng(n).integers(0, TINY.vocab_size, (n, 5)).astype(np.int32)
    a, ta = _engine(shared_params).generate(prompts)
    b, tb = _engine(shared_params, fused_decode=False, cache_pool=False).generate(prompts)
    assert a.shape == b.shape == (n, 8)
    np.testing.assert_array_equal(a, b)
    assert ta["bucket"] == tb["bucket"]


def test_gen_bucket_rounding_is_prefix_stable(shared_params):
    eng = _engine(shared_params, gen_buckets=(4, 8))
    ref = _engine(shared_params, fused_decode=False)
    prompts = np.random.default_rng(7).integers(0, TINY.vocab_size, (2, 4)).astype(np.int32)
    out5, _ = eng.generate(prompts, gen_len=5)  # first use of (2, 8)
    before = eng.compile_count
    for gl in (5, 6, 8):
        out, _ = eng.generate(prompts, gen_len=gl)
        np.testing.assert_array_equal(out, ref.generate(prompts, gen_len=gl)[0])
    assert eng.compile_count == before  # all lengths share the 8-step key
    assert out5.shape == (2, 5)


# ------------------------------------------------------------ kv-cache pool
def test_cache_pool_allocs_saturate_per_bucket(shared_params):
    eng = _engine(shared_params)
    for _ in range(3):
        eng.generate(np.ones((4, 4), np.int32), gen_len=4)
    assert eng.cache_allocs == 1
    eng.generate(np.ones((2, 4), np.int32), gen_len=4)
    eng.generate(np.ones((3, 4), np.int32), gen_len=4)  # bucket 4 again
    assert eng.cache_allocs == 2
    assert _engine(shared_params, cache_pool=False).cache_allocs == 0


def test_no_stale_row_leakage_across_batches(shared_params):
    """A padded batch (n=3 in bucket 4) after a full batch through the same
    pooled cache gives the tokens of a fresh cache."""
    pooled = _engine(shared_params)
    fresh = _engine(shared_params, cache_pool=False)
    rng = np.random.default_rng(3)
    pooled.generate(rng.integers(32, 64, (4, 8)).astype(np.int32), gen_len=8)
    probe = rng.integers(0, 32, (3, 4)).astype(np.int32)
    np.testing.assert_array_equal(pooled.generate(probe, gen_len=8)[0],
                                  fresh.generate(probe, gen_len=8)[0])


# ------------------------------------------------------------------- warmup
def test_warmup_covers_all_pairs_without_stats_pollution(shared_params):
    eng = _engine(shared_params)
    timings = eng.warmup()
    assert set(timings) == {(b, p) for b in BUCKETS for p in PLENS}
    assert all(dt > 0 for dt in timings.values())
    assert eng.stats == {"batches": 0, "requests": 0, "tokens": 0}
    before = eng.compile_count
    for b in BUCKETS:
        eng.generate(np.ones((b, 4), np.int32))
    assert eng.compile_count == before
    assert eng.stats["batches"] == len(BUCKETS)
    assert eng.prefill_calls == 2 * len(timings) + len(BUCKETS)
    assert eng.decode_steps == 7 * eng.prefill_calls


# ----------------------------------------------------------- dispatch target
def test_replica_pool_target_fills_payloads(shared_params):
    pool = ReplicaPool(TINY, _ecfg(), params=shared_params, device="cpu")
    done = []
    target = ReplicaPoolTarget(pool, prompt_len=4, on_done=lambda b, lat, now: done.append(lat))
    reqs = [Request(arrival_time=0.0, payload=np.arange(i, i + 6)) for i in range(3)]
    reqs.append(Request(arrival_time=0.0))  # no payload: a zero prompt
    out, timing = target(Batch(requests=reqs, dispatch_time=0.0, cause="full"))
    assert out.shape == (4, 8) and timing["bucket"] == 4
    for r, row in zip(reqs, out):
        np.testing.assert_array_equal(r.payload, row)
    # the target keeps the last prompt_len tokens, left-padded
    eng = pool.replicas[0]
    want, _ = eng.generate(np.stack([np.arange(i + 2, i + 6) for i in range(3)]
                                    + [np.zeros(4, np.int64)]).astype(np.int32))
    np.testing.assert_array_equal(out, want)
    assert done and done[0] > 0 and target.requests == 4 and target.batches == 1
