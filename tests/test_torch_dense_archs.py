"""The six decoder archs of the dense, MoE and VLM families against the
JAX package, on their reduced configs.

JAX params (``jax.random`` init) go through ``repro_torch.convert`` after
their zero-initialised biases (q/k/v and MLP) and the norm scales and
biases are perturbed in the numpy tree, so the bias, LayerNorm and scale
paths carry weight. The prompt and 8 teacher-forced decode tokens come
from numpy. Prefill logits, every decode step's logits and the full
``forward`` (logits and MoE aux loss) agree to 1e-4 in f32, the JAX side
on its plain-jnp path; internvl2's ``forward`` also runs from float
embeddings. The plain versions behind the two attention kernels are held
to the JAX package's Pallas kernels (interpret mode) at the new head dims
112 (kimi-k2) and 192 (nemotron-4).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttransformer

TOL = 1e-4
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_torch_kernels.py's
ARCHS = ("llama4-scout-17b-a16e", "kimi-k2-1t-a32b", "starcoder2-15b", "nemotron-4-340b",
         "yi-34b", "internvl2-76b")
#: leaves initialised to 0 (biases) or 1 (norm scales)
PERTURBED = ("bq", "bk", "bv", "bi", "bo", "scale", "bias")


def _perturb(tree, rng):
    if isinstance(tree, dict):
        return {k: (_perturb(v, rng) if isinstance(v, dict) else
                    v + 0.1 * rng.standard_normal(v.shape).astype(v.dtype) if k in PERTURBED
                    else v) for k, v in tree.items()}
    return tree


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    jcfg = jget_config(request.param).reduced()
    tcfg = tget_config(request.param).reduced()
    params_np = jax.device_get(jtransformer.init_params(jcfg, jax.random.PRNGKey(0)))
    params_np = _perturb(params_np, np.random.default_rng(len(request.param)))
    return jcfg, tcfg, params_np


def test_perturbed_leaves_cover_the_arch(arch):
    """The perturbation reached every bias and norm leaf the arch has."""
    jcfg, _, params_np = arch
    layers = params_np["layers"]
    assert not np.allclose(layers["attn_norm"]["scale"], 1.0)
    if jcfg.norm == "layernorm":
        assert not np.allclose(layers["mlp_norm"]["bias"], 0.0)
    if jcfg.qkv_bias:
        assert not np.allclose(layers["attn"]["bk"], 0.0)
    if jcfg.mlp_bias:
        assert not np.allclose(layers["mlp"]["bi"], 0.0)
    assert ("moe" in layers) == (jcfg.family == "moe")


def test_prefill_and_decode_match_jax(arch):
    jcfg, tcfg, params_np = arch
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
    for i in range(steps):
        jlogits, jcache = jtransformer.decode_step(jcfg, jparams, jnp.asarray(forced[i]), jcache)
        tlogits, tcache = ttransformer.decode_step(tcfg, tparams, torch.from_numpy(forced[i]),
                                                   tcache)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=TOL, rtol=TOL,
                                   err_msg=f"decode step {i}")
    np.testing.assert_allclose(tcache["v"].numpy(), np.asarray(jcache["v"]), atol=TOL, rtol=TOL)
    assert int(tcache["len"]) == int(jcache["len"]) == s + steps


def test_forward_matches_jax(arch):
    jcfg, tcfg, params_np = arch
    jparams = jax.tree_util.tree_map(jnp.asarray, params_np)
    tparams = convert.from_jax(params_np)
    rng = np.random.default_rng(1)
    inputs = [rng.integers(0, jcfg.vocab_size, (2, 20)).astype(np.int32)]
    if jcfg.family == "vlm":  # the frontend's patch + text embeddings
        inputs.append(rng.standard_normal((2, 20, jcfg.d_model)).astype(np.float32))
    for x in inputs:
        jlogits, jaux = jtransformer.forward(jcfg, jparams, jnp.asarray(x))
        tlogits, taux = ttransformer.forward(tcfg, tparams, torch.from_numpy(x))
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(float(taux), float(jaux), atol=TOL, rtol=TOL)
        if jcfg.family == "moe":
            assert float(taux) > 0


def _inputs(seed, shapes, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs],
            [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs])


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=KERNEL_TOL[dtype], rtol=KERNEL_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,d", [(8, 1, 112), (12, 1, 192)])  # kimi-k2's, nemotron-4's G = 8, 12
def test_flash_plain_version_matches_jax_kernel_at_new_head_dims(hq, hkv, d, dtype):
    b, s = 1, 40
    (q, k, v), (jq, jk, jv) = _inputs(d + hq, [(b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)],
                                      dtype)
    want = jops.flash_attention(jq, jk, jv, causal=True, block_q=128, block_k=128,
                                interpret=True)
    _close(tops.flash_attention(q, k, v, causal=True), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,d", [(8, 1, 112), (12, 1, 192)])
def test_decode_plain_versions_match_jax_kernel_at_new_head_dims(hq, hkv, d, dtype):
    """The plain version and the split kernel's plain rendering."""
    b, s_max, valid = 2, 48, 29
    (q, kc, vc), (jq, jk, jv) = _inputs(d + valid, [(b, 1, hq, d), (b, s_max, hkv, d),
                                                    (b, s_max, hkv, d)], dtype)
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(valid), block_k=128, interpret=True)
    lens = torch.tensor(valid, dtype=torch.int32)
    _close(tops.decode_attention(q, kc, vc, lens), want, dtype)
    _close(tref.decode_attention_split(q, kc, vc, lens, split_len=16), want, dtype)


def test_kernel_launchers_refuse_other_head_dims():
    """Both kernels take the head dims their launchers list, 112 and 192
    among them, and refuse any other: nothing falls back."""
    assert {112, 192} <= set(tfa.SUPPORTED_HEAD_DIMS) == set(tdec.SUPPORTED_HEAD_DIMS)
    q, k = torch.zeros((1, 8, 4, 96)), torch.zeros((1, 8, 2, 96))
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention_fwd(q, k, k)
    with pytest.raises(ValueError, match="head dim"):
        tdec.decode_attention_fwd(q[:, :1], k, k, torch.tensor([3], dtype=torch.int32))


@pytest.mark.parametrize("name", ["silu", "gelu", "relu", "relu2"])
def test_activations_match_jax(name):
    """gelu is ``jax.nn.gelu``'s default, the tanh approximation."""
    x = (np.random.default_rng(2).standard_normal((3, 40)) * 3).astype(np.float32)
    np.testing.assert_allclose(tlayers.activation_fn(name)(torch.from_numpy(x)).numpy(),
                               np.asarray(jlayers.activation_fn(name)(jnp.asarray(x))),
                               atol=1e-6, rtol=1e-5)


def test_large_weights_are_drawn_in_row_blocks(monkeypatch):
    """Above ``DRAW_ELEMENTS`` a weight is drawn a block of rows at a time
    into a tensor already in the param dtype: every block a fresh draw, the
    shape, dtype and scale those of one draw."""
    monkeypatch.setattr(tlayers, "DRAW_ELEMENTS", 64)  # 4 rows of 16 a draw
    w = tlayers.dense_init(torch.Generator().manual_seed(0), 48, 16, torch.bfloat16,
                           lead=(3, 2))
    assert w.shape == (3, 2, 48, 16) and w.dtype == torch.bfloat16
    rows = w.float().reshape(-1, 16)
    assert torch.unique(rows, dim=0).shape[0] == rows.shape[0]
    assert abs(rows.std().item() * math.sqrt(48) - 1) < 0.1
