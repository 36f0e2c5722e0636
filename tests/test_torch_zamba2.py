"""The port's Mamba-2 / Zamba2 hybrid against the JAX package's, on the CPU.

JAX params (``jax.random`` init) cross by ``repro_torch.convert`` (a pure
leaf copy); every input is drawn with numpy. Tolerances: the SSD scan to
4 × (2e-5 f32, 2e-2 bf16), as ``tests/test_kernels.py`` sets for it (long
products of decays amplify rounding); the SSD pieces in f32 to 1e-5;
blocks and logits to 1e-4. On the CPU the port's ``ops.ssd_scan`` runs its
plain version; the JAX side runs its Pallas kernel in interpret mode.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.models import hybrid as jhy
from repro.models import ssm as jssm
from repro.models.model import Model as JModel
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import InferenceEngine as JInferenceEngine
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import hybrid as thy
from repro_torch.models import ssm as tssm
from repro_torch.models.model import Model
from repro_torch.serving.engine import EngineConfig, InferenceEngine

SSD_TOL = {"float32": 4 * 2e-5, "bfloat16": 4 * 2e-2}
TOL = 1e-4


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _ssd_inputs(seed, b, s, h, p, n):
    """x, dt (softplus'd), a (negative), B, C — f32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    bb = rng.standard_normal((b, s, n)).astype(np.float32)
    cc = rng.standard_normal((b, s, n)).astype(np.float32)
    return x, dt, a, bb, cc


def _both(x, dt, a, bb, cc, dtype):
    """The same inputs as JAX arrays and torch tensors; x, B, C in ``dtype``."""
    j = (jnp.asarray(x).astype(dtype), jnp.asarray(dt), jnp.asarray(a),
         jnp.asarray(bb).astype(dtype), jnp.asarray(cc).astype(dtype))
    tdt = getattr(torch, dtype)
    t = (torch.from_numpy(x).to(tdt), torch.from_numpy(dt), torch.from_numpy(a),
         torch.from_numpy(bb).to(tdt), torch.from_numpy(cc).to(tdt))
    return j, t


@pytest.fixture(scope="module")
def reduced():
    jcfg = jget_config("zamba2-1.2b").reduced()
    tcfg = tget_config("zamba2-1.2b").reduced()
    init = jax.jit(jhy.init_params, static_argnums=0)  # one compile, not op by op
    params_np = jax.device_get(init(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, params_np


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 64, 2, 16, 16, 16),
    (2, 100, 4, 8, 32, 32),   # ragged chunks
    (1, 33, 1, 32, 8, 16),    # off-by-one
])
def test_ssd_scan_matches_jax_kernel(b, s, h, p, n, chunk, dtype):
    (jx, jdt, ja, jb, jc), (tx, tdt, ta, tb, tc) = _both(
        *_ssd_inputs(s * 10 + h, b, s, h, p, n), dtype)
    tops.reset_launches()
    got = tops.ssd_scan(tx, tdt, ta, tb, tc, chunk=chunk)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert tops.launches()["ssd_scan"] == 0  # a CPU tensor takes the plain version
    kernel = jax.jit(functools.partial(jops.ssd_scan, chunk=chunk, interpret=True))
    _close(got, kernel(jx, jdt, ja, jb, jc), SSD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_pieces_match_jax(dtype):
    """ssd_chunked (y and the final state, from a nonzero h0), the
    sequential oracle, one decode step and the prefill's final state."""
    b, s, h, p, n, chunk = 2, 40, 3, 8, 16, 16
    x, dt, a, bb, cc = _ssd_inputs(7, b, s, h, p, n)
    (jx, jdt, ja, jb, jc), (tx, tdt, ta, tb, tc) = _both(x, dt, a, bb, cc, dtype)
    h0 = np.random.default_rng(8).standard_normal((b, h, p, n)).astype(np.float32)
    tol = TOL / 10 if dtype == "float32" else SSD_TOL[dtype]

    chunked = jax.jit(jssm.ssd_chunked, static_argnames=("chunk",))
    jy, jh = chunked(jx, jdt, ja, jb, jc, chunk=chunk, h0=jnp.asarray(h0))
    ty, th = tssm.ssd_chunked(tx, tdt, ta, tb, tc, chunk=chunk, h0=torch.from_numpy(h0))
    assert ty.dtype == tx.dtype and th.dtype == torch.float32
    _close(ty, jy, tol)
    _close(th, jh, tol)

    # the sequential oracle runs eagerly: jit would unroll its loop over S
    jy, jh = jssm.ssd_reference(jx, jdt, ja, jb, jc, h0=jnp.asarray(h0))
    ty, th = tssm.ssd_reference(tx, tdt, ta, tb, tc, h0=torch.from_numpy(h0))
    _close(ty, jy, tol)
    _close(th, jh, tol)
    _close(tref.ssd_scan_sequential(tx, tdt, ta, tb, tc),
           jssm.ssd_reference(jx, jdt, ja, jb, jc)[0], tol)

    # the prefill's final state, beside the kernel, against JAX's h_last
    # from a zero state (the same compiled shapes as above)
    _, jh_last = chunked(jx, jdt, ja, jb, jc, chunk=chunk, h0=jnp.zeros_like(h0))
    _close(tssm._ssd_final_state(tx, tdt, ta, tb), jh_last, tol)

    # one decode step, in place
    jy, jh = jssm.ssd_step(jnp.asarray(h0), jx[:, 0], jdt[:, 0], ja, jb[:, 0], jc[:, 0])
    state = torch.from_numpy(h0.copy())
    ty, th = tssm.ssd_step(state, tx[:, 0], tdt[:, 0], ta, tb[:, 0], tc[:, 0])
    assert th is state and ty.dtype == torch.float32
    _close(ty, jy, tol)
    _close(th, jh, tol)


def test_mamba2_forward_prefill_then_streamed_steps_match_jax(reduced):
    jcfg, _, params_np = reduced
    layer = jax.tree_util.tree_map(lambda a: a[1], params_np["layers"]["mamba"])
    jp = jax.tree_util.tree_map(jnp.asarray, layer)
    tp = convert.from_jax(layer)
    kw = dict(d_state=jcfg.ssm_state, head_dim=jcfg.ssm_head_dim)
    rng = np.random.default_rng(1)
    b, s = 2, 20
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    steps = rng.standard_normal((3, b, 1, jcfg.d_model)).astype(np.float32)

    jfwd = jax.jit(functools.partial(jssm.mamba2_forward, chunk=jcfg.ssm_chunk, **kw))
    jstate = jssm.init_mamba2_state(b, jcfg.d_model, jcfg.ssm_state, jnp.float32,
                                    head_dim=jcfg.ssm_head_dim)
    tstate = tssm.init_mamba2_state(b, jcfg.d_model, jcfg.ssm_state, torch.float32,
                                    head_dim=jcfg.ssm_head_dim)
    jout, jstate = jfwd(jp, jnp.asarray(x), state=jstate)
    tout, tst = tssm.mamba2_forward(tp, torch.from_numpy(x), chunk=jcfg.ssm_chunk,
                                    state=tstate, **kw)
    assert tst is tstate
    _close(tout, jout)
    for xt in steps:
        jout, jstate = jfwd(jp, jnp.asarray(xt), state=jstate)
        tout, _ = tssm.mamba2_forward(tp, torch.from_numpy(xt), state=tstate, step=True,
                                      **kw)
        _close(tout, jout)
    _close(tstate["h"], jstate["h"])
    _close(tstate["conv"], jstate["conv"])


def test_forward_matches_jax(reduced):
    jcfg, tcfg, params_np = reduced
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    jlogits = jax.jit(JModel(jcfg).forward)(jax.tree_util.tree_map(jnp.asarray, params_np),
                                            jnp.asarray(tokens))
    tlogits = Model(tcfg).forward(convert.from_jax(params_np), torch.from_numpy(tokens))
    _close(tlogits, jlogits)


B, S, STEPS = 2, 24, 4  # the reduced model's chunk is 8: three chunks


@pytest.fixture(scope="module")
def jax_run(reduced):
    """JAX prefill from a fresh cache, then teacher-forced decode steps."""
    jcfg, _, params_np = reduced
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    forced = rng.integers(0, jcfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
    jmodel = JModel(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, params_np)
    jdecode = jax.jit(jmodel.decode_step)
    logits, cache = jax.jit(jmodel.prefill)(jparams, jnp.asarray(prompt),
                                            jmodel.init_cache(B, S + STEPS))
    seq = [logits]
    for tok in forced:
        logits, cache = jdecode(jparams, jnp.asarray(tok), cache)
        seq.append(logits)
    return prompt, forced, seq, cache


def _port_run(reduced, prompt, forced, cache):
    _, tcfg, params_np = reduced
    tmodel = Model(tcfg)
    tparams = convert.from_jax(params_np)
    logits, cache = tmodel.prefill(tparams, torch.from_numpy(prompt), cache)
    seq = [logits]
    for tok in forced:
        logits, cache = tmodel.decode_step(tparams, torch.from_numpy(tok), cache)
        seq.append(logits)
    return seq, cache


def test_prefill_and_decode_match_jax(reduced, jax_run):
    prompt, forced, jseq, jcache = jax_run
    tseq, tcache = _port_run(reduced, prompt, forced,
                             Model(reduced[1]).init_cache(B, S + STEPS))
    for got, want in zip(tseq, jseq):
        _close(got, want)
    for key in ("ssm_h", "ssm_conv", "attn_k", "attn_v"):
        _close(tcache[key], jcache[key])
    assert int(tcache["len"]) == int(jcache["len"]) == S + STEPS


def test_prefill_on_dirty_cache_matches_jax_fresh_prefill(reduced, jax_run):
    """Prefill reads nothing of the cache: on a cache full of another
    batch's values it gives what JAX gives on a fresh one, and so do the
    decode steps after it."""
    prompt, forced, jseq, jcache = jax_run
    dirty = Model(reduced[1]).init_cache(B, S + STEPS)
    for key, t in dirty.items():
        t.fill_(3 if key == "len" else 7.0)
    tseq, tcache = _port_run(reduced, prompt, forced, dirty)
    for got, want in zip(tseq, jseq):
        _close(got, want)
    for key in ("ssm_h", "ssm_conv", "attn_k", "attn_v"):
        _close(tcache[key], jcache[key])
    assert int(tcache["len"]) == S + STEPS


def test_pooled_engine_matches_jax_engine_across_two_batches(reduced):
    """The JAX engine's pool hands the previous batch's SSM state and conv
    prefix to the next prefill; its ``cache_pool=False`` engine is the
    reference. The port's pooled engine must give those tokens batch after
    batch."""
    jcfg, tcfg, params_np = reduced
    kw = dict(batch_buckets=(2,), prompt_buckets=(16,), max_len=32, gen_len=4)
    jeng = JInferenceEngine(jcfg, JEngineConfig(cache_pool=False, **kw),
                            params=jax.tree_util.tree_map(jnp.asarray, params_np))
    teng = InferenceEngine(tcfg, EngineConfig(**kw), params=convert.from_jax(params_np),
                           device="cpu")
    assert teng.rope is not None and not teng.model.recurrent
    rng = np.random.default_rng(5)
    for _ in range(2):
        prompts = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
        want, _ = jeng.generate(prompts)
        got, _ = teng.generate(prompts)
        np.testing.assert_array_equal(got, want)
    assert teng.cache_allocs == 1 and teng.prefill_calls == 2


@pytest.mark.parametrize("max_len", [20, 32])
def test_engine_matches_jax_engine_past_max_len(reduced, max_len):
    """plen + gen_len - 1 = 23 > max_len = 20: the shared block's decode
    runs past its cache's end; the port gives the JAX engine's tokens
    (its RoPE table at max_seq_len, the write clamped onto the last row).
    At max_len = 32 there is room and nothing changes."""
    jcfg, tcfg, params_np = reduced
    kw = dict(batch_buckets=(1,), prompt_buckets=(16,), max_len=max_len, gen_len=8)
    jeng = JInferenceEngine(jcfg, JEngineConfig(cache_pool=False, **kw),
                            params=jax.tree_util.tree_map(jnp.asarray, params_np))
    teng = InferenceEngine(tcfg, EngineConfig(**kw), params=convert.from_jax(params_np),
                           device="cpu")
    prompts = np.random.default_rng(0).integers(0, jcfg.vocab_size, (1, 16)).astype(np.int32)
    want, _ = jeng.generate(prompts)
    got, _ = teng.generate(prompts)
    np.testing.assert_array_equal(got, want)


def test_init_params_and_cache_trees_match_jax():
    cfg = tget_config("zamba2-1.2b").reduced()
    jcfg = jget_config("zamba2-1.2b").reduced()
    for dtype in ("float32", "bfloat16"):  # bf16: a_log, dt_bias, d_skip stay f32
        tc = dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)
        jc = dataclasses.replace(jcfg, param_dtype=dtype, compute_dtype=dtype)
        want = dict(jax.tree_util.tree_leaves_with_path(
            jax.eval_shape(lambda: jhy.init_params(jc, jax.random.PRNGKey(0)))))
        got = dict(jax.tree_util.tree_leaves_with_path(
            thy.init_params(tc, torch.Generator().manual_seed(0))))
        assert set(got) == set(want)
        for path, a in want.items():
            assert tuple(got[path].shape) == a.shape, path
            assert str(got[path].dtype) == f"torch.{a.dtype.name}", path
    want = dict(jax.tree_util.tree_leaves_with_path(jhy.init_cache(jcfg, 3, 20)))
    got = dict(jax.tree_util.tree_leaves_with_path(thy.init_cache(cfg, 3, 20)))
    assert set(got) == set(want)
    for path, a in want.items():
        np.testing.assert_array_equal(got[path].numpy(), np.asarray(a), err_msg=str(path))
        assert str(got[path].dtype) == f"torch.{a.dtype.name}", path
