"""The port's xLSTM against the JAX package's, on the CPU, in f32.

JAX params (``jax.random`` init) cross by ``repro_torch.convert`` (a pure
leaf copy); every input is drawn with numpy. Tolerances: the parallel
mLSTM to 4e-5 f32 / 4e-2 bf16 (twice the attention ones, as
``tests/test_kernels.py`` sets for mLSTM: the signed denominator amplifies
rounding); blocks, logits and the norm to 1e-4 / 1e-5. On the CPU the
port's ``ops.mlstm_attention`` runs its plain version; the JAX side runs
its Pallas kernel in interpret mode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.models import layers as jlayers
from repro.models import xlstm as jxl
from repro.models import xlstm_model as jxm
from repro.models.model import Model as JModel
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import InferenceEngine as JInferenceEngine
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.kernels import ops as tops
from repro_torch.models import layers as tlayers
from repro_torch.models import xlstm as txl
from repro_torch.models import xlstm_model as txm
from repro_torch.models.model import Model
from repro_torch.serving.engine import EngineConfig, InferenceEngine

MLSTM_TOL = {"float32": 4e-5, "bfloat16": 4e-2}
TOL = 1e-4


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _mlstm_inputs(seed, b, s, h, d):
    rng = np.random.default_rng(seed)
    qkv = [rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3)]
    log_i = (rng.standard_normal((b, s, h)) * 0.5).astype(np.float32)
    f_pre = (rng.standard_normal((b, s, h)) + 2.0).astype(np.float32)
    log_f = np.array(jax.nn.log_sigmoid(f_pre))  # a writable copy
    return qkv, log_i, log_f


@pytest.fixture(scope="module")
def reduced():
    jcfg = jget_config("xlstm-1.3b").reduced()
    tcfg = tget_config("xlstm-1.3b").reduced()
    init = jax.jit(jxm.init_params, static_argnums=0)  # one compile, not op by op
    params_np = jax.device_get(init(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, params_np


def test_layernorm_matches_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 32)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(32).astype(np.float32),
         "bias": rng.standard_normal(32).astype(np.float32)}
    got = tlayers.layernorm({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    _close(got, jlayers.layernorm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)),
           tol=1e-5)
    assert tlayers.make_norm("layernorm")[1] is tlayers.layernorm


@pytest.mark.parametrize("b,s,h,d,dtype,chunk", [
    (2, 40, 4, 32, "float32", 16),   # the plain version's chunked branch, ragged
    (1, 33, 2, 64, "bfloat16", 512),
])
def test_mlstm_attention_matches_jax_kernel_and_oracle(b, s, h, d, dtype, chunk):
    (q, k, v), log_i, log_f = _mlstm_inputs(s + d, b, s, h, d)
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v))
    got = tops.mlstm_attention(tq, tk, tv, torch.from_numpy(log_i), torch.from_numpy(log_f),
                               chunk=chunk)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = MLSTM_TOL[dtype]
    kernel = jops.mlstm_attention(jq, jk, jv, jnp.asarray(log_i), jnp.asarray(log_f),
                                  block_q=32, block_k=32, interpret=True)
    oracle = jxl._mlstm_parallel(jq, jk, jv, jnp.asarray(log_i), jnp.asarray(log_f),
                                 chunk=chunk)
    _close(got, kernel, tol)
    _close(got, oracle, tol)


def _block_params(params_np, key, *idx):
    return convert.from_jax(jax.tree_util.tree_map(lambda a: a[idx], params_np[key]))


def test_mlstm_block_matches_jax(reduced):
    jcfg, _, params_np = reduced
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0, 1]), params_np["m_blocks"]["mlstm"])
    tp = _block_params(params_np, "m_blocks", 0, 1)["mlstm"]
    rng = np.random.default_rng(1)
    b, s, h = 2, 20, jcfg.num_heads
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)

    jblock = jax.jit(jxl.mlstm_block, static_argnames=("num_heads", "chunk"))

    jout, _ = jblock(jp, jnp.asarray(x), num_heads=h, chunk=16)
    tout, tst = txl.mlstm_block(tp, torch.from_numpy(x), h, chunk=16)
    assert tst is None
    _close(tout, jout)

    # prefill with state, then one recurrent step from the state it left
    jst = jxl.init_mlstm_state(b, jcfg.d_model, h, jnp.float32)
    tst = txl.init_mlstm_state(b, jcfg.d_model, h, torch.float32)
    jout, jst = jblock(jp, jnp.asarray(x), num_heads=h, state=jst, chunk=16)
    tout, tst = txl.mlstm_block(tp, torch.from_numpy(x), h, state=tst, chunk=16)
    _close(tout, jout)
    jout, jst = jblock(jp, jnp.asarray(x1), num_heads=h, state=jst)
    tout, tst = txl.mlstm_block(tp, torch.from_numpy(x1), h, state=tst)
    _close(tout, jout)
    for key in ("C", "n", "m"):
        _close(tst["cell"][key], jst["cell"][key])
    _close(tst["conv"], jst["conv"])


def test_slstm_block_matches_jax(reduced):
    jcfg, _, params_np = reduced
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), params_np["s_blocks"]["slstm"])
    tp = _block_params(params_np, "s_blocks", 0)["slstm"]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    jblock = jax.jit(jxl.slstm_block, static_argnames=("num_heads",))
    jout, jst = jblock(jp, jnp.asarray(x), num_heads=jcfg.num_heads)
    tout, tst = txl.slstm_block(tp, torch.from_numpy(x), jcfg.num_heads)
    _close(tout, jout)
    # the carry continues: a second chunk from the first one's state, in place
    x2 = rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    jout, jst = jblock(jp, jnp.asarray(x2), num_heads=jcfg.num_heads, state=jst)
    state = txl.init_slstm_state(2, jcfg.d_model, jcfg.num_heads)
    for key in state:
        state[key].copy_(tst[key])
    tout, tst = txl.slstm_block(tp, torch.from_numpy(x2), jcfg.num_heads, state=state)
    assert tst is state
    _close(tout, jout)
    for key in ("c", "n", "h", "m"):
        _close(tst[key], jst[key])


def test_forward_matches_jax(reduced):
    jcfg, tcfg, params_np = reduced
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    jlogits = jax.jit(JModel(jcfg).forward)(jax.tree_util.tree_map(jnp.asarray, params_np),
                                            jnp.asarray(tokens))
    tlogits = Model(tcfg).forward(convert.from_jax(params_np), torch.from_numpy(tokens))
    _close(tlogits, jlogits)


def test_prefill_and_decode_match_jax(reduced):
    jcfg, tcfg, params_np = reduced
    jmodel, tmodel = JModel(jcfg), Model(tcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, params_np)
    tparams = convert.from_jax(params_np)
    rng = np.random.default_rng(4)
    b, s, steps = 2, 24, 8
    prompt = rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    forced = rng.integers(0, jcfg.vocab_size, (steps, b, 1)).astype(np.int32)
    jprefill, jdecode = jax.jit(jmodel.prefill), jax.jit(jmodel.decode_step)
    jlogits, jcache = jprefill(jparams, jnp.asarray(prompt), jmodel.init_cache(b, 0))
    tlogits, tcache = tmodel.prefill(tparams, torch.from_numpy(prompt), tmodel.init_cache(b, 0))
    _close(tlogits, jlogits)
    for i in range(steps):
        jlogits, jcache = jdecode(jparams, jnp.asarray(forced[i]), jcache)
        tlogits, tcache = tmodel.decode_step(tparams, torch.from_numpy(forced[i]), tcache)
        _close(tlogits, jlogits)
    _close(tcache["m"]["cell"]["C"], jcache["m"]["cell"]["C"])
    _close(tcache["s"]["h"], jcache["s"]["h"])
    assert int(tcache["len"]) == int(jcache["len"]) == s + steps


def test_init_params_and_cache_trees_match_jax():
    cfg = tget_config("xlstm-1.3b").reduced()
    jcfg = jget_config("xlstm-1.3b").reduced()
    for dtype in ("float32", "bfloat16"):  # bf16: the f32 gate leaves stay f32
        tc = dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)
        jc = dataclasses.replace(jcfg, param_dtype=dtype, compute_dtype=dtype)
        want = dict(jax.tree_util.tree_leaves_with_path(
            jax.eval_shape(lambda: jxm.init_params(jc, jax.random.PRNGKey(0)))))
        got = dict(jax.tree_util.tree_leaves_with_path(
            txm.init_params(tc, torch.Generator().manual_seed(0))))
        assert set(got) == set(want)
        for path, a in want.items():
            assert tuple(got[path].shape) == a.shape, path
            assert str(got[path].dtype) == f"torch.{a.dtype.name}", path
    jcache = jxm.init_cache(jcfg, 3)
    tcache = txm.init_cache(cfg, 3)
    want = dict(jax.tree_util.tree_leaves_with_path(jcache))
    got = dict(jax.tree_util.tree_leaves_with_path(tcache))
    assert set(got) == set(want)
    for path, a in want.items():
        np.testing.assert_array_equal(got[path].numpy(), np.asarray(a), err_msg=str(path))
    # a dirtied cache resets to exactly init_cache's values
    for t in jax.tree_util.tree_leaves(tcache):
        t.fill_(7)
    txm.reset_cache(cfg, tcache)
    for path, a in want.items():
        np.testing.assert_array_equal(got[path].numpy(), np.asarray(a), err_msg=str(path))


def test_pooled_engine_matches_jax_engine_across_two_batches(reduced):
    """The JAX engine's pool hands the previous batch's recurrent state to
    the next prefill; its ``cache_pool=False`` engine is the reference.
    The port's pooled engine must give those tokens batch after batch."""
    jcfg, tcfg, params_np = reduced
    kw = dict(batch_buckets=(2,), prompt_buckets=(16,), max_len=32, gen_len=4)
    jeng = JInferenceEngine(jcfg, JEngineConfig(cache_pool=False, **kw),
                            params=jax.tree_util.tree_map(jnp.asarray, params_np))
    teng = InferenceEngine(tcfg, EngineConfig(**kw), params=convert.from_jax(params_np),
                           device="cpu")
    assert teng.rope is None
    rng = np.random.default_rng(5)
    for n in (2, 1):
        prompts = rng.integers(0, jcfg.vocab_size, (n, 12)).astype(np.int32)
        want, _ = jeng.generate(prompts)
        got, _ = teng.generate(prompts)
        np.testing.assert_array_equal(got, want)
    assert teng.cache_allocs == 1 and teng.prefill_calls == 2
