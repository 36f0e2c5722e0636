"""The port's attention kernels' entry points against the JAX package's.

On the CPU the port's ``ops`` wrappers run their plain PyTorch versions;
they are held to the JAX package's Pallas kernels run in interpret mode,
on the same numpy inputs (f32 to 2e-5, bf16 to 2e-2, the tolerances of
``tests/test_kernels.py``). ``tests/test_torch_kernels_cuda.py`` holds
the hand-written kernels to their plain versions on the card.
"""
import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.configs import get_config as tget_config
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import mlstm_attention as tml
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models.model import Model

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, shapes, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    j = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    return t, j


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("b,s,hq,hkv,d,dtype,causal", [
    (2, 200, 8, 2, 64, "float32", True),     # GQA 4:1, ragged block
    (2, 257, 4, 1, 32, "bfloat16", True),    # MQA, off-by-one length
    (1, 128, 14, 2, 64, "float32", False),   # qwen2 geometry (G = 7), full
])
def test_flash_attention_matches_jax_kernel(b, s, hq, hkv, d, dtype, causal):
    (q, k, v), (jq, jk, jv) = _inputs(
        s + hq, [(b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)], dtype)
    want = jops.flash_attention(jq, jk, jv, causal=causal, block_q=128, block_k=128,
                                interpret=True)
    _close(tops.flash_attention(q, k, v, causal=causal), want, dtype)


@pytest.mark.parametrize("b,s,hq,hkv,d,valid,dtype", [
    (2, 144, 14, 2, 64, 129, "bfloat16"),  # qwen2 geometry, serving cache
    (2, 128, 8, 2, 64, 77, "float32"),     # partial cache
])
def test_decode_attention_matches_jax_kernel(b, s, hq, hkv, d, valid, dtype):
    (q, kc, vc), (jq, jk, jv) = _inputs(
        s + valid, [(b, 1, hq, d), (b, s, hkv, d), (b, s, hkv, d)], dtype)
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(valid), block_k=128,
                                 interpret=True)
    got = tops.decode_attention(q, kc, vc, torch.tensor(valid, dtype=torch.int32))
    _close(got, want, dtype)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    (q, k, v), _ = _inputs(0, [(1, 16, 4, 16), (1, 16, 2, 16), (1, 16, 2, 16)], "float32")
    tops.reset_launches()
    out = tops.flash_attention(q, k, v)
    torch.testing.assert_close(out, tref.flash_attention(q, k, v), rtol=0, atol=0)
    dec = tops.decode_attention(q[:, :1], k, v, 9)
    torch.testing.assert_close(dec, tref.decode_attention(q[:, :1], k, v, 9), rtol=0, atol=0)
    (mq, mk, mv), _ = _inputs(1, [(1, 16, 2, 32)] * 3, "float32")
    gi, gf = torch.zeros((1, 16, 2)), torch.full((1, 16, 2), -0.1)
    ml = tops.mlstm_attention(mq, mk, mv, gi, gf)
    torch.testing.assert_close(ml, tref.mlstm_attention(mq, mk, mv, gi, gf), rtol=0, atol=0)
    sx, sb = torch.randn((1, 16, 2, 8)), torch.randn((1, 16, 8))
    sdt, sa = torch.full((1, 16, 2), 0.5), torch.tensor([-1.0, -2.0])
    ssd = tops.ssd_scan(sx, sdt, sa, sb, sb, chunk=8)
    torch.testing.assert_close(ssd, tref.ssd_scan(sx, sdt, sa, sb, sb, chunk=8),
                               rtol=0, atol=0)
    assert tops.launches() == {"flash_attention": 0, "decode_attention": 0,
                               "mlstm_attention": 0, "ssd_scan": 0}


def test_other_devices_raise_instead_of_falling_back():
    q = torch.empty((1, 8, 4, 16), device="meta")
    k = torch.empty((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tops.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="no kernel"):
        tops.decode_attention(q[:, :1], k, k, 3)
    g = torch.empty((1, 8, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tops.mlstm_attention(q, q, q, g, g)
    with pytest.raises(ValueError, match="no kernel"):
        tops.ssd_scan(q, g, g[0, 0], q[:, :, 0], q[:, :, 0])


def test_kernel_launchers_refuse_what_the_kernels_do_not_take():
    q, k = torch.zeros((1, 8, 4, 16)), torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_fwd(q, k, k)  # CPU tensors never reach the kernel
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention_fwd(torch.zeros((1, 8, 4, 48)), torch.zeros((1, 8, 2, 48)),
                                torch.zeros((1, 8, 2, 48)))
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_attention_fwd(torch.zeros((1, 8, 3, 16)), k, k)
    with pytest.raises(TypeError):
        tfa.flash_attention_fwd(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="int32"):
        tdec.decode_attention_fwd(q[:, :1], k, k, torch.tensor([3]))
    with pytest.raises(ValueError, match="at most"):
        tdec.decode_attention_fwd(torch.zeros((1, 1, 66, 16)), k, k,
                                  torch.tensor([3], dtype=torch.int32))
    mq, g = torch.zeros((1, 8, 4, 32)), torch.zeros((1, 8, 4))
    with pytest.raises(ValueError, match="CUDA"):
        tml.mlstm_attention_fwd(mq, mq, mq, g, g)  # CPU tensors never reach the kernel
    with pytest.raises(ValueError, match="head dim"):
        m48 = torch.zeros((1, 8, 4, 48))
        tml.mlstm_attention_fwd(m48, m48, m48, g, g)
    with pytest.raises(ValueError, match="gates"):
        tml.mlstm_attention_fwd(mq, mq, mq, g[:, :, :2], g)
    with pytest.raises(TypeError):
        tml.mlstm_attention_fwd(mq.half(), mq.half(), mq.half(), g, g)
    with pytest.raises(TypeError, match="gate"):
        tml.mlstm_attention_fwd(mq, mq, mq, g.double(), g)
    sx, sdt, sa, sb = (torch.zeros((1, 8, 2, 16)), torch.zeros((1, 8, 2)), torch.zeros(2),
                       torch.zeros((1, 8, 16)))
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_scan_fwd(sx, sdt, sa, sb, sb)  # CPU tensors never reach the kernel
    with pytest.raises(ValueError, match="head dim"):
        tssd.ssd_scan_fwd(torch.zeros((1, 8, 2, 24)), sdt, sa, sb, sb)
    with pytest.raises(ValueError, match="dt"):
        tssd.ssd_scan_fwd(sx, sdt[:, :4], sa, sb, sb)
    with pytest.raises(ValueError, match="chunk"):
        tssd.ssd_scan_fwd(sx, sdt, sa, sb, sb, chunk=0)
    with pytest.raises(TypeError):
        tssd.ssd_scan_fwd(sx.half(), sdt, sa, sb.half(), sb.half())
    with pytest.raises(TypeError, match="dt"):
        tssd.ssd_scan_fwd(sx, sdt.double(), sa, sb, sb)


@pytest.mark.parametrize("batch,kv_heads,s_max", [
    (32, 2, 144), (1, 2, 144),      # qwen2-0.5b's decode: buckets 32 and 1
    (32, 32, 144), (1, 32, 144),    # Zamba2's shared block
    (4, 4, 640), (3, 1, 1), (2, 8, 17), (64, 16, 4096), (1, 1, 100_000),
])
def test_decode_split_plan_covers_every_row_and_leaves_no_split_empty(batch, kv_heads, s_max):
    assert list(inspect.signature(tdec.split_plan).parameters) == ["batch", "kv_heads", "s_max"]
    n, split_len = tdec.split_plan(batch, kv_heads, s_max)
    assert n >= 1
    assert n * split_len >= s_max            # every row lies in a split
    assert (n - 1) * split_len < s_max       # at length S_max the last split has rows
    assert n <= tdec.MAX_SPLITS              # one thread-block cluster a (batch, kv head)
    if n > 1:                                # the blocks fit the target; no split is tiny
        assert batch * kv_heads * n <= tdec.TARGET_BLOCKS
        assert split_len >= tdec.MIN_SPLIT_ROWS
    assert tdec.split_plan(batch, kv_heads, s_max) == (n, split_len)


def test_decode_split_plan_splits_long_caches_not_the_serving_one():
    for batch, kv_heads in ((1, 2), (32, 2), (1, 32), (32, 32)):  # qwen2's and Zamba2's
        assert tdec.split_plan(batch, kv_heads, 144) == (1, 144)
    assert tdec.split_plan(1, 2, 4096) == (tdec.MAX_SPLITS, 512)
    assert tdec.split_plan(32, 2, 4096) == (2, 2048)  # 128 blocks: one wave
    assert tdec.split_plan(1, 2, 300) == (2, 150)


@pytest.mark.parametrize("b,s,hq,hkv,d,lens,dtype", [
    (2, 144, 14, 2, 64, [0, 1], "float32"),          # lengths 0 and 1: most splits lie past them
    (3, 144, 4, 2, 16, [31, 33, 144], "float32"),   # a 32-row split's boundary ± 1, and S_max
    (2, 40, 4, 4, 32, [17], "bfloat16"),            # one length for the batch
])
def test_decode_split_and_merge_matches_plain_and_jax_kernel(b, s, hq, hkv, d, lens, dtype):
    (q, kc, vc), (jq, jk, jv) = _inputs(
        s + d, [(b, 1, hq, d), (b, s, hkv, d), (b, s, hkv, d)], dtype)
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(lens, jnp.int32), block_k=128,
                                 interpret=True)
    lengths = torch.tensor(lens, dtype=torch.int32)
    for split_len in (16, 32, 48, s, s + 16):
        got = tref.decode_attention_split(q, kc, vc, lengths, split_len)
        _close(got, want, dtype)
        if min(lens) > 0:  # at length 0 the plain version averages every row
            _close(got, tref.decode_attention(q, kc, vc, lengths).float(), dtype)


def test_launchers_refuse_misaligned_vector_layouts():
    bf = torch.bfloat16
    k = torch.zeros((1, 8, 2, 16), dtype=bf)
    shifted = torch.zeros(1 * 8 * 4 * 16 + 1, dtype=bf)[1:].view(1, 8, 4, 16)
    with pytest.raises(ValueError, match="base pointer"):
        tfa.flash_attention_fwd(shifted, k, k)
    odd_heads = torch.zeros((1, 8, 4, 17), dtype=bf)[..., :16]  # head stride 34 bytes
    with pytest.raises(ValueError, match="16 bytes"):
        tfa.flash_attention_fwd(odd_heads, k, k)
    odd_rows = torch.zeros((1, 8, 2 * 16 + 4), dtype=bf)[..., :32].view(1, 8, 2, 16)
    with pytest.raises(ValueError, match="16 bytes"):
        tfa.flash_attention_fwd(torch.zeros((1, 8, 4, 16), dtype=bf), odd_rows, k)
    # float32 flash reads scalars: any layout reaches the device check
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_fwd(odd_heads.float(), k.float(), k.float())
    lens = torch.tensor([3], dtype=torch.int32)
    q1 = torch.zeros((1, 1, 4, 16), dtype=bf)
    with pytest.raises(ValueError, match="base pointer"):
        tdec.decode_attention_fwd(shifted[:, :1], k, k, lens)
    with pytest.raises(ValueError, match="16 bytes"):
        tdec.decode_attention_fwd(q1, odd_rows, odd_rows, lens)
    f32_cache = torch.zeros((1, 8, 2, 18))[..., :16]  # head stride 72 bytes
    with pytest.raises(ValueError, match="16 bytes"):
        tdec.decode_attention_fwd(q1.float(), f32_cache, f32_cache, lens)
    with pytest.raises(ValueError, match="split_len"):
        tdec.decode_attention_fwd(q1, k, k, lens, split_len=0)
    with pytest.raises(ValueError, match="at most"):  # more splits than a cluster holds
        k16 = torch.zeros((1, 16, 2, 16), dtype=bf)
        tdec.decode_attention_fwd(q1, k16, k16, lens, split_len=1)
    with pytest.raises(ValueError, match="CUDA"):  # aligned: only the device is wrong
        tdec.decode_attention_fwd(q1, k, k, lens)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "zamba2-1.2b"])
def test_model_attention_inputs_meet_the_kernels_layout_rules(arch, monkeypatch):
    """The tensors the reduced models (in bf16, as served) hand to
    ``ops.flash_attention`` and ``ops.decode_attention`` pass every check
    of the kernels' launchers: on the CPU only the device check is left."""
    cfg = dataclasses.replace(tget_config(arch).reduced(), param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    flash, decode = tops.flash_attention, tops.decode_attention
    seen = {"flash": 0, "decode": 0}

    def flash_checked(q, k, v, *, causal=True):
        with pytest.raises(ValueError, match="CUDA"):
            tfa.flash_attention_fwd(q, k, v, causal=causal)
        seen["flash"] += 1
        return flash(q, k, v, causal=causal)

    def decode_checked(q, k_cache, v_cache, cache_len):
        lengths = torch.as_tensor(cache_len).to(torch.int32)
        with pytest.raises(ValueError, match="CUDA"):
            tdec.decode_attention_fwd(q, k_cache, v_cache, lengths)
        seen["decode"] += 1
        return decode(q, k_cache, v_cache, cache_len)

    monkeypatch.setattr(tops, "flash_attention", flash_checked)
    monkeypatch.setattr(tops, "decode_attention", decode_checked)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    prompt = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)))
    cache = model.init_cache(2, 16)
    logits, cache = model.prefill(params, prompt, cache)
    model.decode_step(params, logits.argmax(-1)[:, -1:], cache)
    assert seen["flash"] == seen["decode"] > 0
