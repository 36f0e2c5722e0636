"""The encoder-decoder (seamless-m4t-large-v2, reduced) against the JAX
package, and the flash kernel's plain version at Sq != Sk against the TPU
kernel.

JAX params (``jax.random`` init, the norm scales and biases perturbed in
the numpy tree so the LayerNorm paths carry weight) go through
``repro_torch.convert``; frames, prompts and forced tokens come from
numpy. ``forward`` logits, ``prefill`` logits and the whole cache (``k``,
``v``, ``len``, ``memory``), four ``decode_step`` calls and the greedy tokens
past ``max_len`` agree with the JAX model to 1e-4 in f32 (tokens exactly),
at S_enc = 8 and 40: at 40 > ``attn_q_chunk`` = 16 the JAX encoder and
cross-attention take their chunked path. The JAX side is jitted.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels.flash_attention import flash_attention_bhsd
from repro.models import encdec as jencdec
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models.model import Model

TOL = 1e-4
KERNEL_TOL = 2e-5
ARCH = "seamless-m4t-large-v2"


def _perturb(tree, rng):
    """Norm scales and biases (initialised to 1 and 0) moved off their init."""
    return {k: (_perturb(v, rng) if isinstance(v, dict) else
                v + 0.1 * rng.standard_normal(v.shape).astype(v.dtype)
                if k in ("scale", "bias") else v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def models():
    jcfg = jget_config(ARCH).reduced()
    tcfg = tget_config(ARCH).reduced()
    params_np = _perturb(jax.device_get(jencdec.init_params(jcfg, jax.random.PRNGKey(0))),
                         np.random.default_rng(7))
    jfns = {name: jax.jit(functools.partial(getattr(jencdec, name), jcfg))
            for name in ("forward", "prefill", "decode_step")}
    return (jcfg, jfns, jax.tree_util.tree_map(jnp.asarray, params_np),
            Model(tcfg), convert.from_jax(params_np))


def _inputs(cfg, seed, b, s_enc, s_dec):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((b, s_enc, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (b, s_dec)).astype(np.int32)
    return frames, tokens


def _both(frames, tokens):
    return ({"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)},
            {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(tokens)})


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL, err_msg=what)


def test_param_tree_and_counts_match_jax(models):
    """Same leaves, shapes and dtypes as the JAX tree, native init too;
    the full config's tree holds 1,632,256,000 params."""
    jcfg, _, jparams, model, tparams = models
    native = convert.to_numpy(model.init(torch.Generator().manual_seed(0)))
    want = {p: (a.shape, a.dtype) for p, a in jax.tree_util.tree_leaves_with_path(jparams)}
    got = {p: (a.shape, a.dtype) for p, a in jax.tree_util.tree_leaves_with_path(native)}
    assert got == want
    full = jax.eval_shape(lambda: jencdec.init_params(jget_config(ARCH), jax.random.PRNGKey(0)))
    assert sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(full)) == 1_632_256_000


@pytest.mark.parametrize("s_enc", [8, 40])
def test_forward_prefill_and_decode_match_jax(models, s_enc):
    jcfg, jfns, jparams, model, tparams = models
    b, plen, steps = 2, 12, 4
    frames, tokens = _inputs(jcfg, s_enc, b, s_enc, plen + 1)
    jin, tin = _both(frames, tokens)
    jlogits, _ = jfns["forward"](jparams, jin)
    _close(model.forward(tparams, tin), jlogits, "forward logits")

    jin, tin = _both(frames, tokens[:, :plen])
    jlogits, jcache = jfns["prefill"](jparams, jin, jencdec.init_cache(jcfg, b, plen + steps))
    tlogits, tcache = model.prefill(tparams, tin, model.init_cache(b, plen + steps))
    _close(tlogits, jlogits, "prefill logits")
    forced = np.random.default_rng(s_enc + 1).integers(0, jcfg.vocab_size, (steps, b, 1))
    for i in range(steps):
        for key in ("k", "v", "memory"):
            _close(tcache[key], jcache[key], f"cache {key} before step {i}")
        assert int(tcache["len"]) == int(jcache["len"]) == plen + i
        tok = forced[i].astype(np.int32)
        jlogits, jcache = jfns["decode_step"](jparams, jnp.asarray(tok), jcache)
        tlogits, tcache = model.decode_step(tparams, torch.from_numpy(tok), tcache)
        _close(tlogits, jlogits, f"decode step {i} logits")
    assert tcache["memory"].shape == (b, s_enc, jcfg.d_model)


@pytest.mark.parametrize("s_enc", [8, 40])
def test_greedy_tokens_past_max_len_match_jax(models, s_enc):
    """plen 12 + 8 greedy tokens in a 14-row cache: the last steps write the
    last row and attend every row, the RoPE positions keep counting."""
    jcfg, jfns, jparams, model, tparams = models
    b, plen, gen, max_len = 2, 12, 8, 14
    jin, tin = _both(*_inputs(jcfg, 100 + s_enc, b, s_enc, plen))
    jlogits, jcache = jfns["prefill"](jparams, jin, jencdec.init_cache(jcfg, b, max_len))
    tlogits, tcache = model.prefill(tparams, tin, model.init_cache(b, max_len))
    jtoks, ttoks = [], []
    for _ in range(gen):
        jt = jnp.argmax(jlogits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        tt = torch.argmax(tlogits[:, -1], dim=-1)[:, None]
        jtoks.append(np.asarray(jt))
        ttoks.append(tt.numpy())
        jlogits, jcache = jfns["decode_step"](jparams, jt, jcache)
        tlogits, tcache = model.decode_step(tparams, tt, tcache)
    np.testing.assert_array_equal(np.concatenate(ttoks, 1), np.concatenate(jtoks, 1))
    _close(tlogits, jlogits, "logits past max_len")
    assert int(tcache["len"]) == plen + gen > max_len


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk,hq,hkv", [(5, 40, 4, 2), (40, 8, 4, 4), (130, 70, 2, 1)])
def test_flash_plain_version_matches_jax_kernel_at_sq_ne_sk(sq, sk, hq, hkv, causal):
    """``ref.flash_attention`` (the CPU path of ``ops.flash_attention``)
    against the TPU kernel in interpret mode: Sq rows over Sk keys, keys
    past Sk masked, the causal mask top-left aligned."""
    b, d = 2, 16
    rng = np.random.default_rng(sq * sk + causal)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for s, h in ((sq, hq), (sk, hkv), (sk, hkv)))

    def bhsd(x):
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(-1, x.shape[1], d))

    want = flash_attention_bhsd(bhsd(q), bhsd(k), bhsd(v), causal=causal, interpret=True)
    want = np.asarray(want).reshape(b, hq, sq, d).transpose(0, 2, 1, 3)
    got = tops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    assert torch.equal(got, tref.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                                 causal=causal))
    np.testing.assert_allclose(got.numpy(), want, atol=KERNEL_TOL, rtol=KERNEL_TOL)
