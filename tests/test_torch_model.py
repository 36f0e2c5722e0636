"""The port's dense transformer against the JAX package's, on reduced qwen2.

JAX params (``jax.random`` init) go through ``repro_torch.convert``; the
prompt and 8 teacher-forced decode tokens are drawn with numpy. Prefill
logits and every decode step's logits agree to 1e-4 in f32 (the JAX side
on its plain-jnp path, ``use_pallas=False``; the port's attention on the
CPU runs its kernels' plain versions).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import transformer as jtransformer
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.models import transformer as ttransformer
from repro_torch.models.model import Model

TOL = 1e-4


@pytest.fixture(scope="module")
def reduced():
    jcfg = jget_config("qwen2-0.5b").reduced()
    tcfg = tget_config("qwen2-0.5b").reduced()
    params_np = jax.device_get(jtransformer.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, params_np


def test_convert_is_a_pure_copy(reduced):
    _, _, params_np = reduced
    tparams = convert.from_jax(params_np)
    assert tparams["layers"]["attn"]["wq"].shape == params_np["layers"]["attn"]["wq"].shape
    back = convert.to_numpy(tparams)
    flat_a = jax.tree_util.tree_leaves(params_np)
    flat_b = jax.tree_util.tree_leaves(back)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_prefill_and_decode_match_jax(reduced):
    jcfg, tcfg, params_np = reduced
    jparams = jax.tree_util.tree_map(jnp.asarray, params_np)
    tparams = convert.from_jax(params_np)
    rng = np.random.default_rng(0)
    b, s, steps = 2, 24, 8
    prompt = rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    forced = rng.integers(0, jcfg.vocab_size, (steps, b, 1)).astype(np.int32)

    jcache = jtransformer.init_cache(jcfg, b, s + steps)
    jlogits, jcache = jtransformer.prefill(jcfg, jparams, jnp.asarray(prompt), jcache)
    tcache = ttransformer.init_cache(tcfg, b, s + steps)
    tlogits, tcache = ttransformer.prefill(tcfg, tparams, torch.from_numpy(prompt), tcache)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=TOL, rtol=TOL)
    assert int(tcache["len"]) == int(jcache["len"]) == s
    for i in range(steps):
        jlogits, jcache = jtransformer.decode_step(jcfg, jparams, jnp.asarray(forced[i]), jcache)
        tlogits, tcache = ttransformer.decode_step(tcfg, tparams, torch.from_numpy(forced[i]),
                                                   tcache)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]), atol=TOL, rtol=TOL)
    assert int(tcache["len"]) == int(jcache["len"]) == s + steps


def test_forward_matches_jax(reduced):
    jcfg, tcfg, params_np = reduced
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    jlogits, _ = jtransformer.forward(jcfg, jax.tree_util.tree_map(jnp.asarray, params_np),
                                      jnp.asarray(tokens))
    tlogits, _ = ttransformer.forward(tcfg, convert.from_jax(params_np),
                                      torch.from_numpy(tokens))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=TOL, rtol=TOL)


def test_native_init_matches_jax_shapes_and_scales(reduced):
    _, tcfg, params_np = reduced
    tparams = Model(tcfg).init(torch.Generator().manual_seed(0))
    want = jax.tree_util.tree_leaves_with_path(params_np)
    got = dict(jax.tree_util.tree_leaves_with_path(convert.to_numpy(tparams)))
    assert set(got) == {p for p, _ in want}
    for path, a in want:
        assert got[path].shape == a.shape and got[path].dtype == a.dtype
        if a.std() > 0:  # random leaves: same scale to within sampling error
            assert abs(got[path].std() / a.std() - 1) < 0.2, path


def test_unported_families_raise():
    # every family of the JAX package is ported; an unknown one still raises
    cfg = dataclasses.replace(tget_config("qwen2-0.5b").reduced(), family="no-such-family")
    with pytest.raises(NotImplementedError, match="not ported"):
        Model(cfg)
