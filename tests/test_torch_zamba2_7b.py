"""Zamba2-7B's published layout in the port, on the CPU at a reduced size,
against the benchmark's plain reference (``perfbench/reference/hybrid.py``)
and the reference against ``transformers``' ``Zamba2ForCausalLM``; the
kernel calls of one ``generate`` against the benchmark's counts; and the
JAX package's layout (every new field at its default) giving the same
outputs as before the published layout came in, bit for bit. Imports no
JAX.

Tolerances: float32 logits to 1e-4 (the repo's f32 model tolerance). The
port, the reference and ``transformers`` compute the same equations in a
different order (SSD chunks of 8, 64 and 64 rows; RoPE angles in f32 and
f64), which moves the logits by a few 1e-6 at this size.
"""
import dataclasses
import hashlib
import types

import numpy as np
import pytest
import torch

from perfbench.lib import hybrid_counts, weights
from perfbench.reference import hybrid as ref
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models.model import Model
from repro_torch.serving.engine import EngineConfig, InferenceEngine

TOL = 1e-4

#: Zamba2-7B's layout at a small size: 2 groups of B and C, 2 shared blocks
#: over 3 hybrid layers at uneven gaps, a rank-8 LoRA, head dim 32 (the
#: published 2 · d_model / heads), f32
SMALL = dataclasses.replace(
    get_config("zamba2-7b"), num_layers=7, d_model=64, num_heads=4, num_kv_heads=4,
    head_dim=32, d_ff=96, vocab_size=128, max_seq_len=64, ssm_state=16, ssm_head_dim=16,
    ssm_chunk=8, hybrid_layer_ids=(1, 3, 6), attention_hidden_size=128, adapter_rank=8,
    param_dtype="float32", compute_dtype="float32", remat=False)
MODEL = {f.name: getattr(SMALL, f.name) for f in dataclasses.fields(SMALL)}


def _params(seed=3):
    return weights.make(Model(SMALL).init_abstract(), seed, "cpu", extra=ref.WEIGHTS)


def _prompts(seed, n, plen):
    return np.random.default_rng(seed).integers(0, SMALL.vocab_size, (n, plen)).astype(np.int32)


def test_published_config_counts_its_parameters():
    cfg = get_config("zamba2-7b")
    assert 7.3e9 <= cfg.param_count() <= 7.5e9
    assert Model(cfg).init_abstract()["apps"]["linear"].shape == (13, 3584, 3584)
    total = sum(t.numel() for t in _leaves(Model(cfg).init_abstract()))
    assert abs(total - cfg.param_count()) / total < 1e-3  # norms, conv and D aside


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_engine_prefill_and_decode_match_the_reference():
    """Two batches through one engine (the second on the pooled cache the
    first left): the logits of prefill and of every decode step against
    the reference's full forward over the prompt and the served tokens."""
    params = _params()
    plen, gen = 12, 6
    eng = InferenceEngine(SMALL, EngineConfig(batch_buckets=(1, 2, 4), prompt_buckets=(plen,),
                                              max_len=plen + gen, gen_len=gen),
                          params=params, device="cpu")
    seen = []
    prefill, step = eng.model.prefill, eng.model.decode_step

    def record(fn):
        def wrapped(*args, **kw):
            logits, cache = fn(*args, **kw)
            seen.append(logits[:, -1].clone())
            return logits, cache
        return wrapped

    eng.model.prefill, eng.model.decode_step = record(prefill), record(step)
    for seed, n in ((1, 3), (2, 4)):
        seen.clear()
        prompts = _prompts(seed, n, plen)
        tokens, _ = eng.generate(prompts)
        got = torch.stack(seen, dim=1)[:n]  # (n, gen, V)
        seq = torch.from_numpy(np.concatenate([prompts, tokens[:, :-1]], axis=1)).long()
        want = ref.logits(MODEL, params, seq, plen - 1)
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
        assert np.array_equal(tokens, got.argmax(-1).numpy())


def test_reference_matches_the_forward_in_float32():
    """150 positions: the reference's SSD over three chunks of 64 with the
    state carried between them, the port's over 19 chunks of 8."""
    params = _params(5)
    tokens = torch.from_numpy(_prompts(7, 2, 150)).long()
    want = Model(SMALL).forward(params, tokens)
    torch.testing.assert_close(ref.logits(MODEL, params, tokens, 0), want, atol=TOL, rtol=TOL)
    torch.testing.assert_close(ref.logits(MODEL, params, tokens, 130), want[:, 130:], atol=TOL,
                               rtol=TOL)


def _hf_model(params):
    """``Zamba2ForCausalLM`` at SMALL's shapes with ``params`` copied in,
    leaf by leaf (the port's (in, out) matrices transposed to nn.Linear's)."""
    transformers = pytest.importorskip("transformers")
    ids = list(SMALL.hybrid_layer_ids)
    config = transformers.Zamba2Config(
        vocab_size=SMALL.vocab_size, hidden_size=SMALL.d_model,
        num_hidden_layers=SMALL.num_layers,
        layers_block_type=["hybrid" if i in ids else "mamba" for i in range(SMALL.num_layers)],
        mamba_d_state=SMALL.ssm_state, mamba_d_conv=4, mamba_expand=2,
        mamba_ngroups=SMALL.ssm_groups, n_mamba_heads=2 * SMALL.d_model // SMALL.ssm_head_dim,
        # one chunk for the whole sequence: transformers' torch_forward (its
        # path without the mamba_ssm kernels) carries the state from chunk
        # to chunk wrongly, summing decay_chunk over the target chunk where
        # the source is meant (the kernel path, and a single chunk, are right)
        chunk_size=SMALL.max_seq_len, intermediate_size=SMALL.d_ff, hidden_act="gelu",
        num_attention_heads=SMALL.num_heads, num_key_value_heads=SMALL.num_kv_heads,
        num_mem_blocks=SMALL.num_mem_blocks, adapter_rank=SMALL.adapter_rank,
        use_mem_rope=True, rope_theta=SMALL.rope_theta, rms_norm_eps=SMALL.norm_eps,
        max_position_embeddings=SMALL.max_seq_len, use_shared_attention_adapter=False,
        tie_word_embeddings=True,
        # torch_forward clamps dt below at time_step_min; the published
        # kernel path does not (``time_step_limit`` None), nor the port
        time_step_min=1e-30, time_step_floor=1e-30, attn_implementation="eager")
    assert config.attention_head_dim == SMALL.hd
    assert config.attention_hidden_size == SMALL.attention_hidden_size
    hf = transformers.Zamba2ForCausalLM(config).eval()
    state = {}

    def linear(name, w):  # (in, out) -> nn.Linear's (out, in)
        state[name] = w.T

    m = "model."
    state[m + "embed_tokens.weight"] = params["embed"]
    state[m + "final_layernorm.weight"] = params["final_norm"]["scale"]
    for i in range(SMALL.num_layers):
        pre = f"{m}layers.{i}." + ("mamba_decoder." if i in ids else "")
        mb = {k: v[i] for k, v in params["layers"]["mamba"].items()}
        state[pre + "input_layernorm.weight"] = params["layers"]["norm"]["scale"][i]
        linear(pre + "mamba.in_proj.weight", mb["in_proj"])
        linear(pre + "mamba.out_proj.weight", mb["out_proj"])
        state[pre + "mamba.conv1d.weight"] = mb["conv"].T[:, None, :]
        state[pre + "mamba.conv1d.bias"] = mb["conv_bias"]
        state[pre + "mamba.A_log"] = mb["a_log"]
        state[pre + "mamba.dt_bias"] = mb["dt_bias"]
        state[pre + "mamba.D"] = mb["d_skip"]
        state[pre + "mamba.norm.weight"] = mb["norm_scale"]
    for j, i in enumerate(ids):
        k = j % SMALL.num_mem_blocks
        blk = f"{m}layers.{i}.shared_transformer."
        sh = params["shared"]
        state[blk + "input_layernorm.weight"] = sh["attn_norm"]["scale"][k]
        state[blk + "pre_ff_layernorm.weight"] = sh["mlp_norm"]["scale"][k]
        for w, name in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"), ("wo", "o_proj")):
            linear(f"{blk}self_attn.{name}.weight", sh["attn"][w][k])
        linear(blk + "feed_forward.gate_up_proj.weight", sh["mlp"]["wi"][k])
        linear(blk + "feed_forward.down_proj.weight", sh["mlp"]["wo"][k])
        # block k is one module under each of its layers, holding the LoRA
        # of every application it serves
        for a in range(k, len(ids), SMALL.num_mem_blocks):
            ad = f"{blk}feed_forward.gate_up_proj_adapter_list.{a}."
            linear(ad + "0.weight", params["apps"]["adapter_in"][a])
            linear(ad + "1.weight", params["apps"]["adapter_out"][a])
        linear(f"{m}layers.{i}.linear.weight", params["apps"]["linear"][j])
    missing, unexpected = hf.load_state_dict(state, strict=False)
    # lm_head is tied to the embedding; every other weight was copied
    assert set(missing) <= {"lm_head.weight"} and not unexpected, (missing, unexpected)
    assert torch.equal(hf.lm_head.weight, params["embed"])
    return hf


def test_reference_matches_transformers():
    """The reference holds to the published equations: ``transformers``'
    ``Zamba2ForCausalLM`` (its plain torch path) on the same weights."""
    params = _params(11)
    hf = _hf_model(params)
    tokens = torch.from_numpy(_prompts(13, 2, 20)).long()
    with torch.no_grad():
        want = hf(input_ids=tokens, use_cache=False).logits.float()
    torch.testing.assert_close(ref.logits(MODEL, params, tokens, 0), want, atol=TOL, rtol=TOL)


def test_kernel_calls_of_a_generate_are_what_the_benchmark_counts(monkeypatch):
    """Each call of ``ops.ssd_scan``, ``ops.flash_attention`` and
    ``ops.decode_attention`` in one CPU ``generate``, at the shapes and
    cache lengths it is called with, against
    ``hybrid_counts.expected_launches`` for that batch (on the card each
    call is one launch)."""
    plen, gen, n = 12, 5, 3
    eng = InferenceEngine(SMALL, EngineConfig(batch_buckets=(1, 2, 4), prompt_buckets=(plen,),
                                              max_len=plen + gen, gen_len=gen),
                          params=_params(), device="cpu")
    seen = {"ssd_scan": [], "flash_attention": [], "decode_attention": []}
    ssd, flash, decode = ops.ssd_scan, ops.flash_attention, ops.decode_attention

    def ssd_counted(x, dt, a, b, c, *, chunk=128):
        bs, s, h, p = x.shape
        seen["ssd_scan"].append(hybrid_counts.ssd_cost(
            bs, s, h, p, b.shape[-1], b.shape[2], min(chunk, max(s, 8))))
        return ssd(x, dt, a, b, c, chunk=chunk)

    def flash_counted(q, k, v, *, causal=True):
        from perfbench.lib import roofline

        seen["flash_attention"].append(roofline.flash_cost(
            q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3]))
        return flash(q, k, v, causal=causal)

    def decode_counted(q, k_cache, v_cache, cache_len):
        from perfbench.lib import roofline

        seen["decode_attention"].append(roofline.decode_cost(
            q.shape[0], int(torch.as_tensor(cache_len).max()), q.shape[2], k_cache.shape[2],
            q.shape[3]))
        return decode(q, k_cache, v_cache, cache_len)

    monkeypatch.setattr(ops, "ssd_scan", ssd_counted)
    monkeypatch.setattr(ops, "flash_attention", flash_counted)
    monkeypatch.setattr(ops, "decode_attention", decode_counted)
    _, timing = eng.generate(_prompts(4, n, plen))
    batch = types.SimpleNamespace(bucket=timing["bucket"], plen=timing["prompt_bucket"])
    want = hybrid_counts.expected_launches(MODEL, batch, gen)
    assert (len(want["ssd_scan"]), len(want["flash_attention"]),
            len(want["decode_attention"])) == (7, 3, 3 * (gen - 1))
    assert seen == want


#: sha256 of the JAX layout's outputs below, as computed before the
#: published layout's fields existed
TODAYS_DIGEST = "f9105782aea667cf70aa00338e5ff3af19f76668957aa05fb34a6d5e6cdba556"


def test_the_jax_layout_gives_todays_outputs_bit_for_bit():
    """zamba2-1.2b reduced (every new field at its default), f32 and bf16:
    the forward's logits, prefill and four decode steps, and the cache they
    leave, on one thread, hash to what they did before."""
    h = hashlib.sha256()
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(get_config("zamba2-1.2b").reduced(), param_dtype=dtype,
                                      compute_dtype=dtype)
            model = Model(cfg)
            params = model.init(torch.Generator().manual_seed(0))
            tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                                        (2, 20)))
            with torch.no_grad():
                outs = [model.forward(params, tokens)]
                cache = model.init_cache(2, 24)
                logits, cache = model.prefill(params, tokens[:, :16], cache)
                outs.append(logits)
                for t in range(16, 20):
                    logits, cache = model.decode_step(params, tokens[:, t:t + 1], cache)
                    outs.append(logits)
                outs += [cache["ssm_h"], cache["ssm_conv"].float(), cache["attn_k"].float()]
            for o in outs:
                h.update(o.float().contiguous().numpy().tobytes())
    finally:
        torch.set_num_threads(before)
    assert h.hexdigest() == TODAYS_DIGEST
