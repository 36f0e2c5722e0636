"""The port's MoE FFN and MoE model init against the JAX package's.

``moe_ffn`` is held to the JAX package's single-device path
(``_moe_global``) on the same numpy-made router, experts and tokens, at
reduced llama4-scout (top-1) and reduced kimi-k2 (top-2): at the reduced
``capacity_factor`` 8.0, where nothing is dropped, and at 1.0, where some
(token, choice) pairs overflow their expert and are dropped. Output and
aux loss agree to 1e-4 in f32. The reduced llama4-scout engine gives the
JAX engine's tokens, and the port's native init gives JAX's tree: shapes,
dtypes (the router f32 beside bf16 experts) and scales.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import InferenceEngine as JInferenceEngine
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttransformer
from repro_torch.models.model import Model
from repro_torch.serving.engine import EngineConfig, InferenceEngine

TOL = 1e-4
MOE_ARCHS = ("llama4-scout-17b-a16e", "kimi-k2-1t-a32b")


def _moe_inputs(cfg, seed, tokens=(4, 16)):
    """Router, experts (gated: (E, D, 2, F)) and x, f32, from numpy."""
    rng = np.random.default_rng(seed)
    d, e, f = cfg.d_model, cfg.num_experts, cfg.expert_d_ff
    p = {
        "router": rng.standard_normal((d, e)) / np.sqrt(d),
        "wi": rng.standard_normal((e, d, 2, f)) / np.sqrt(d),
        "wo": rng.standard_normal((e, f, d)) / np.sqrt(f),
    }
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((*tokens, d)).astype(np.float32)
    return p, x


def _dropped_pairs(p, x, cfg, capacity_factor):
    """(token, choice) pairs over their expert's capacity, counted from the
    routing alone."""
    logits = x.reshape(-1, x.shape[-1]) @ p["router"]
    top = np.argsort(-logits, axis=-1, kind="stable")[:, :cfg.num_experts_per_tok]
    counts = np.bincount(top.reshape(-1), minlength=cfg.num_experts)
    cap = tmoe.expert_capacity(logits.shape[0], cfg.num_experts, cfg.num_experts_per_tok,
                               capacity_factor)
    return int(np.maximum(counts - cap, 0).sum())


@pytest.mark.parametrize("capacity_factor", [8.0, 1.0])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_matches_jax_global_path(arch, capacity_factor):
    cfg = tget_config(arch).reduced()
    p, x = _moe_inputs(cfg, seed=len(arch) + int(capacity_factor))
    dropped = _dropped_pairs(p, x, cfg, capacity_factor)
    if capacity_factor == 1.0:
        assert dropped > 0, "the capacity-1.0 case must drop tokens"
    else:
        assert dropped == 0
    kw = dict(top_k=cfg.num_experts_per_tok, capacity_factor=capacity_factor,
              activation=cfg.activation)
    jy, jaux = jmoe._moe_global(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), **kw)
    ty, taux = tmoe.moe_ffn(convert.from_jax(p), torch.from_numpy(x), **kw)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(taux), float(jaux), atol=TOL, rtol=TOL)
    assert ty.shape == x.shape and tmoe.moe_ffn(
        convert.from_jax(p), torch.from_numpy(x), return_aux=False, **kw)[1] is None


def test_moe_ffn_drops_overflow_pairs_exactly():
    """Top-1 at capacity 1.0: a token whose pair is dropped gets zeros from
    the routed FFN; a kept token gets its expert's gated output."""
    cfg = tget_config("llama4-scout-17b-a16e").reduced()
    p, x = _moe_inputs(cfg, seed=1, tokens=(2, 16))
    tp = convert.from_jax(p)
    y, _ = tmoe.moe_ffn(tp, torch.from_numpy(x), top_k=1, capacity_factor=1.0)
    xf = torch.from_numpy(x.reshape(-1, cfg.d_model))
    expert = (xf @ tp["router"]).argmax(-1)
    cap = tmoe.expert_capacity(xf.shape[0], cfg.num_experts, 1, 1.0)
    seen = {}
    y = y.reshape(-1, cfg.d_model)
    for i, e in enumerate(expert.tolist()):
        seen[e] = seen.get(e, 0) + 1
        if seen[e] > cap:
            assert torch.count_nonzero(y[i]) == 0
        else:
            wi = tp["wi"][e].reshape(cfg.d_model, -1)
            g, u = torch.chunk(xf[i] @ wi, 2)
            want = (torch.nn.functional.silu(g) * u) @ tp["wo"][e]
            torch.testing.assert_close(y[i], want, atol=TOL, rtol=TOL)
    assert any(n > cap for n in seen.values())


def test_native_moe_init_matches_jax_shapes_dtypes_and_scales():
    """bf16 params: the experts are bf16 and the router f32, in both."""
    jcfg = dataclasses.replace(jget_config("kimi-k2-1t-a32b").reduced(), param_dtype="bfloat16")
    tcfg = dataclasses.replace(tget_config("kimi-k2-1t-a32b").reduced(), param_dtype="bfloat16")
    want = jax.tree_util.tree_leaves_with_path(
        jax.device_get(jtransformer.init_params(jcfg, jax.random.PRNGKey(0))))
    got = dict(jax.tree_util.tree_leaves_with_path(
        Model(tcfg).init(torch.Generator().manual_seed(0))))
    assert set(got) == {path for path, _ in want}
    for path, a in want:
        t = got[path]
        assert tuple(t.shape) == a.shape, path
        assert str(t.dtype).replace("torch.", "") == a.dtype.name, path
        a = np.asarray(a, np.float32)
        if a.std() > 0:  # random leaves: same scale to within sampling error
            assert abs(t.float().std().item() / a.std() - 1) < 0.2, path
    assert got[(jax.tree_util.DictKey("layers"), jax.tree_util.DictKey("moe"),
                jax.tree_util.DictKey("router"))].dtype == torch.float32


def test_convert_to_bf16_keeps_the_router_f32():
    cfg = jget_config("llama4-scout-17b-a16e").reduced()
    params_np = jax.device_get(jtransformer.init_params(cfg, jax.random.PRNGKey(1)))
    tparams = convert.from_jax(params_np, dtype=torch.bfloat16)
    assert tparams["layers"]["moe"]["router"].dtype == torch.float32
    np.testing.assert_array_equal(tparams["layers"]["moe"]["router"].numpy(),
                                  params_np["layers"]["moe"]["router"])
    assert tparams["layers"]["moe"]["wi"].dtype == torch.bfloat16
    assert tparams["layers"]["mlp"]["wi"].dtype == torch.bfloat16


def test_generate_matches_jax_engine_tokens_llama4():
    jcfg = jget_config("llama4-scout-17b-a16e").reduced()
    tcfg = tget_config("llama4-scout-17b-a16e").reduced()
    kw = dict(batch_buckets=(4,), prompt_buckets=(16,), max_len=32, gen_len=8)
    jeng = JInferenceEngine(jcfg, JEngineConfig(**kw), rng=jax.random.PRNGKey(0))
    params = convert.from_jax(jax.device_get(jeng.params))
    teng = InferenceEngine(tcfg, EngineConfig(**kw), params=params, device="cpu")
    prompts = np.random.default_rng(0).integers(0, jcfg.vocab_size, (3, 10)).astype(np.int32)
    want, _ = jeng.generate(prompts)

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
    assert margin > 10 * TOL, f"near tie on the greedy path (margin {margin:.2e})"

    got, _ = teng.generate(prompts)
    np.testing.assert_array_equal(got, want)
    per_token = InferenceEngine(tcfg, EngineConfig(fused_decode=False, **kw), params=params,
                                device="cpu")
    np.testing.assert_array_equal(per_token.generate(prompts)[0], want)
