"""Port layers and plain attention against the JAX package, f32, to 1e-5.

Inputs and weights are drawn once with numpy and fed to both frameworks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers

TOL = 1e-5


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=tol, rtol=tol)


def test_rmsnorm():
    rng = np.random.default_rng(0)
    x, scale = _rand(rng, (2, 5, 32)), _rand(rng, (32,))
    _close(tlayers.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x)),
           jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))


def test_rope_split_half():
    rng = np.random.default_rng(1)
    x = _rand(rng, (2, 7, 3, 16))
    pos = rng.integers(0, 40, (2, 7))
    tc, ts = tlayers.rope_frequencies(16, 64, 1e6)
    jc, js = jlayers.rope_frequencies(16, 64, 1e6)
    _close(tc, jc)
    _close(tlayers.apply_rope(torch.from_numpy(x), tc, ts, torch.from_numpy(pos)),
           jlayers.apply_rope(jnp.asarray(x), jc, js, jnp.asarray(pos)))


def test_gated_mlp():
    rng = np.random.default_rng(2)
    x = _rand(rng, (2, 5, 32))
    p = {"wi": _rand(rng, (32, 2 * 48), 0.2), "wo": _rand(rng, (48, 32), 0.2)}
    _close(tlayers.mlp({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), "silu"),
           jlayers.mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), "silu"))


def test_qkv_proj_with_bias():
    rng = np.random.default_rng(3)
    x = _rand(rng, (2, 5, 32))
    p = {"wq": _rand(rng, (32, 4 * 8)), "wk": _rand(rng, (32, 2 * 8)),
         "wv": _rand(rng, (32, 2 * 8)), "bq": _rand(rng, (32,)),
         "bk": _rand(rng, (16,)), "bv": _rand(rng, (16,))}
    got = tattn.qkv_proj({k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x), 4, 2, 8)
    want = jattn.qkv_proj({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x), 4, 2, 8)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("causal", [True, False])
def test_reference_and_chunked_attention(causal):
    rng = np.random.default_rng(4)
    q, k, v = _rand(rng, (2, 40, 4, 16)), _rand(rng, (2, 40, 2, 16)), _rand(rng, (2, 40, 2, 16))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = jattn.reference_attention(jq, jk, jv, causal=causal)
    _close(tattn.reference_attention(tq, tk, tv, causal=causal), want)
    _close(tattn.chunked_attention(tq, tk, tv, causal=causal, q_chunk=16),
           jattn.chunked_attention(jq, jk, jv, causal=causal, q_chunk=16))
    _close(tattn.chunked_attention(tq, tk, tv, causal=causal, q_chunk=16), want)


@pytest.mark.parametrize("cache_len", [5, np.array([3, 11])])
def test_decode_attention_and_cache_update(cache_len):
    rng = np.random.default_rng(5)
    q = _rand(rng, (2, 1, 4, 16))
    kc, vc = _rand(rng, (2, 12, 2, 16)), _rand(rng, (2, 12, 2, 16))
    _close(tattn.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                  torch.from_numpy(vc), torch.as_tensor(cache_len)),
           jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                  jnp.asarray(cache_len)))
    k_new, v_new = _rand(rng, (2, 3, 2, 16)), _rand(rng, (2, 3, 2, 16))
    tk, tv = tattn.cache_update_layer(torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()),
                                      torch.from_numpy(k_new), torch.from_numpy(v_new),
                                      torch.tensor(4, dtype=torch.int32))
    jk, jv = jattn.cache_update_layer(jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(k_new),
                                      jnp.asarray(v_new), jnp.asarray(4, jnp.int32))
    _close(tk, jk, 0)
    _close(tv, jv, 0)
