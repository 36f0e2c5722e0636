"""The port's attention kernels' entry points against the JAX package's.

On the CPU the port's ``ops`` wrappers run their plain PyTorch versions;
they are held to the JAX package's Pallas kernels run in interpret mode,
on the same numpy inputs (f32 to 2e-5, bf16 to 2e-2, the tolerances of
``tests/test_kernels.py``; the mLSTM twice that, the SSD scan four times).
The plain renderings of the tensor-core kernels' arithmetic
(``ref.decode_attention_split``, ``ref.mlstm_attention_sliced``,
``ref.ssd_scan_grouped``) are held to the same Pallas kernels and to the
plain versions. ``tests/test_torch_kernels_cuda.py`` holds the
hand-written kernels to their plain versions on the card.
"""
import dataclasses
import functools
import inspect

import jax
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
MLSTM_TOL = {k: 2 * v for k, v in TOL.items()}  # the signed denominator amplifies rounding
SSD_TOL = {k: 4 * v for k, v in TOL.items()}  # long products of decays amplify rounding
#: a rendering fed f32 copies of bf16 inputs keeps its f32 result: with each
#: f32 weight as bf16 hi + lo it stays this close to the plain f32 version
#: (one bf16 rounding of the weights would be off by ~2^-9 of them)
SPLIT_TOL = 1e-4


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
    # the bf16 mLSTM kernel moves 16 bytes a lane too; float32 reads scalars
    mq = torch.zeros((1, 8, 2, 32), dtype=bf)
    mg = torch.zeros((1, 8, 2))
    m_shifted = torch.zeros(8 * 2 * 32 + 1, dtype=bf)[1:].view(1, 8, 2, 32)
    with pytest.raises(ValueError, match="base pointer"):
        tml.mlstm_attention_fwd(m_shifted, mq, mq, mg, mg)
    m_odd_heads = torch.zeros((1, 8, 2, 36), dtype=bf)[..., :32]  # head stride 72 bytes
    with pytest.raises(ValueError, match="16 bytes"):
        tml.mlstm_attention_fwd(mq, mq, m_odd_heads, mg, mg)
    m_odd_rows = torch.zeros((1, 8, 2 * 32 + 4), dtype=bf)[..., :64].view(1, 8, 2, 32)
    with pytest.raises(ValueError, match="16 bytes"):
        tml.mlstm_attention_fwd(mq, m_odd_rows, mq, mg, mg)
    with pytest.raises(ValueError, match="CUDA"):
        tml.mlstm_attention_fwd(m_odd_heads.float(), mq.float(), mq.float(), mg, mg)
    with pytest.raises(ValueError, match="CUDA"):  # aligned: only the device is wrong
        tml.mlstm_attention_fwd(mq, mq, mq, mg, mg)
    # and the bf16 SSD kernel at P, N >= 16: x, B and C as views of a conv output
    sdt, sa = torch.zeros((1, 8, 2)), torch.zeros(2)
    conv = torch.zeros((1, 8, 2 * 16 + 2 * 16), dtype=bf)
    sx, sb, sc = conv[..., :32].view(1, 8, 2, 16), conv[..., 32:48], conv[..., 48:]
    with pytest.raises(ValueError, match="CUDA"):  # aligned: only the device is wrong
        tssd.ssd_scan_fwd(sx, sdt, sa, sb, sc)
    s_shifted = torch.zeros(8 * 2 * 16 + 1, dtype=bf)[1:].view(1, 8, 2, 16)
    with pytest.raises(ValueError, match="base pointer"):
        tssd.ssd_scan_fwd(s_shifted, sdt, sa, sb, sc)
    s_odd_heads = torch.zeros((1, 8, 2, 20), dtype=bf)[..., :16]  # head stride 40 bytes
    with pytest.raises(ValueError, match="16 bytes"):
        tssd.ssd_scan_fwd(s_odd_heads, sdt, sa, sb, sc)
    odd_conv = torch.zeros((1, 8, 2 * 16 + 2 * 16 + 4), dtype=bf)  # rows of 136 bytes
    with pytest.raises(ValueError, match="16 bytes"):
        tssd.ssd_scan_fwd(sx, sdt, sa, odd_conv[..., 32:48], sc)
    with pytest.raises(ValueError, match="base pointer"):  # C starts 2 bytes into a row
        tssd.ssd_scan_fwd(sx, sdt, sa, sb, conv[..., 47:63])
    p8 = torch.zeros((1, 8, 2, 9), dtype=bf)[..., :8]  # P = 8: the CUDA-core kernel, scalars
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_scan_fwd(p8, sdt, sa, sb, sc)


#: the kernels each model's prefill and decode step launch
MODEL_KERNELS = {"qwen2-0.5b": ("flash", "decode"), "zamba2-1.2b": ("flash", "decode", "ssd"),
                 "xlstm-1.3b": ("mlstm",), "seamless-m4t-large-v2": ("flash", "decode")}


@pytest.mark.parametrize("arch", list(MODEL_KERNELS))
def test_model_attention_inputs_meet_the_kernels_layout_rules(arch, monkeypatch):
    """The tensors the reduced models (in bf16, as served) hand to
    ``ops.flash_attention``, ``ops.decode_attention``,
    ``ops.mlstm_attention`` and ``ops.ssd_scan`` pass every check of the
    kernels' launchers (the 16-byte layout rules of the tensor-core paths
    included): on the CPU only the device check is left."""
    kernels = MODEL_KERNELS[arch]
    cfg = dataclasses.replace(tget_config(arch).reduced(), param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    flash, decode = tops.flash_attention, tops.decode_attention
    mlstm, ssd = tops.mlstm_attention, tops.ssd_scan
    seen = {"flash": 0, "decode": 0, "mlstm": 0, "ssd": 0}

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

    def mlstm_checked(q, k, v, log_i, log_f, *, chunk=512):
        assert q.dtype == torch.bfloat16  # the tensor-core path
        with pytest.raises(ValueError, match="CUDA"):
            tml.mlstm_attention_fwd(q, k, v, log_i, log_f)
        seen["mlstm"] += 1
        return mlstm(q, k, v, log_i, log_f, chunk=chunk)

    def ssd_checked(x, dt, a, b, c, *, chunk=128):
        assert tssd.uses_tensor_cores(x.dtype, x.shape[-1], b.shape[-1])
        with pytest.raises(ValueError, match="CUDA"):
            tssd.ssd_scan_fwd(x, dt, a, b, c, chunk=chunk)
        seen["ssd"] += 1
        return ssd(x, dt, a, b, c, chunk=chunk)

    monkeypatch.setattr(tops, "flash_attention", flash_checked)
    monkeypatch.setattr(tops, "decode_attention", decode_checked)
    monkeypatch.setattr(tops, "mlstm_attention", mlstm_checked)
    monkeypatch.setattr(tops, "ssd_scan", ssd_checked)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12)))
    if cfg.family == "encdec":  # 40 encoder frames: the cross-attention's Sk
        frames = torch.from_numpy(rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32))
        prompt = {"frames": frames.to(cfg.dtype), "tokens": prompt}
    cache = model.init_cache(2, 16)
    logits, cache = model.prefill(params, prompt, cache)
    model.decode_step(params, logits.argmax(-1)[:, -1:], cache)
    assert all(seen[name] > 0 for name in kernels)
    assert not any(seen[name] for name in seen if name not in kernels)
    if cfg.family == "encdec":  # encoder, self and cross; self and cross
        assert (seen["flash"], seen["decode"]) == (cfg.encoder_layers + 2 * cfg.num_layers,
                                                   2 * cfg.num_layers)
    elif "decode" in kernels:
        assert seen["flash"] == seen["decode"]


def _mlstm_np(seed, b, s, h, d):
    rng = np.random.default_rng(seed)
    qkv = [rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3)]
    log_i = (rng.standard_normal((b, s, h)) * 0.5).astype(np.float32)
    log_f = np.log(1.0 / (1.0 + np.exp(-(rng.standard_normal((b, s, h)) + 2.0))))
    return qkv, log_i, log_f.astype(np.float32)


@pytest.mark.parametrize("b,s,h,d,slice_cols", [
    (1, 1, 2, 64, 128),   # one row
    (2, 70, 2, 32, 128),  # S not a multiple of the 64-row query tile; D below one slice
    (1, 40, 2, 64, 16),   # four D-slices
])
def test_mlstm_rendering_matches_jax_kernel_and_plain(b, s, h, d, slice_cols):
    """The bf16 mLSTM kernel's arithmetic (D-sliced partial scores summed,
    w as bf16 hi + lo, the exact stabiliser) against the Pallas kernel in
    interpret mode and the plain version in f32."""
    (q, k, v), log_i, log_f = _mlstm_np(s + d, b, s, h, d)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    ti, tf = torch.from_numpy(log_i), torch.from_numpy(log_f)
    got = tref.mlstm_attention_sliced(tq, tk, tv, ti, tf, slice_cols=slice_cols)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    kernel = jops.mlstm_attention(jq, jk, jv, jnp.asarray(log_i), jnp.asarray(log_f),
                                  block_q=32, block_k=32, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(kernel, np.float32),
                               atol=MLSTM_TOL["bfloat16"], rtol=MLSTM_TOL["bfloat16"])
    f32 = [t.float() for t in (tq, tk, tv)]
    plain = tref.mlstm_attention(*f32, ti, tf)
    torch.testing.assert_close(got.float(), plain, atol=MLSTM_TOL["bfloat16"],
                               rtol=MLSTM_TOL["bfloat16"])
    unrounded = tref.mlstm_attention_sliced(*f32, ti, tf, slice_cols=slice_cols)
    torch.testing.assert_close(unrounded, plain, atol=SPLIT_TOL, rtol=SPLIT_TOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 1, 2, 16, 16, 128),    # one row
    (2, 100, 3, 16, 32, 32),   # ragged S over four chunks: the carried state
    (1, 40, 2, 32, 16, 128),   # one ragged chunk: no state term at all
])
def test_ssd_rendering_matches_jax_kernel_and_plain(b, s, h, p, n, chunk):
    """The bf16 SSD kernel's arithmetic (C·Bᵀ per group, w as bf16 hi + lo,
    state terms only where read) against the Pallas kernel in interpret
    mode and the plain version in f32."""
    rng = np.random.default_rng(s * 10 + h)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    bb, cc = (rng.standard_normal((b, s, n)).astype(np.float32) for _ in range(2))
    tx, tb, tc = (torch.from_numpy(t).to(torch.bfloat16) for t in (x, bb, cc))
    tdt, ta = torch.from_numpy(dt), torch.from_numpy(a)
    got = tref.ssd_scan_grouped(tx, tdt, ta, tb, tc, chunk=chunk)
    assert got.dtype == torch.bfloat16 and got.shape == tx.shape
    jx, jb, jc = (jnp.asarray(t).astype(jnp.bfloat16) for t in (x, bb, cc))
    kernel = jax.jit(functools.partial(jops.ssd_scan, chunk=chunk, interpret=True))
    np.testing.assert_allclose(
        got.float().numpy(),
        np.asarray(kernel(jx, jnp.asarray(dt), jnp.asarray(a), jb, jc), np.float32),
        atol=SSD_TOL["bfloat16"], rtol=SSD_TOL["bfloat16"])
    f32 = [t.float() for t in (tx, tb, tc)]
    plain = tref.ssd_scan(f32[0], tdt, ta, f32[1], f32[2], chunk=chunk)
    torch.testing.assert_close(got.float(), plain, atol=SSD_TOL["bfloat16"],
                               rtol=SSD_TOL["bfloat16"])
    unrounded = tref.ssd_scan_grouped(f32[0], tdt, ta, f32[1], f32[2], chunk=chunk)
    torch.testing.assert_close(unrounded, plain, atol=SPLIT_TOL, rtol=SPLIT_TOL)


@pytest.mark.parametrize("batch,heads,p,n,s", [
    (32, 64, 64, 64, 128), (1, 64, 64, 64, 128),  # Zamba2's buckets 32 and 1
    (32, 64, 64, 64, 32), (2, 5, 64, 64, 300), (4, 8, 128, 128, 1000), (300, 3, 16, 16, 40),
])
def test_ssd_heads_a_block_fit_and_fill_the_card(batch, heads, p, n, s):
    assert list(inspect.signature(tssd.heads_per_block).parameters) == [
        "batch", "heads", "p", "n", "q", "n_chunks"]
    q = min(128, max(s, 8))
    n_chunks = -(-s // q)
    g = tssd.heads_per_block(batch, heads, p, n, q, n_chunks)
    assert g in tssd.HEADS_PER_BLOCK
    assert tssd.mma_smem_bytes(p, n, q, g, 1, n_chunks > 1) <= tssd.MAX_SMEM
    if g > 1:  # more heads a block only while every SM still gets a block
        assert batch * -(-heads // g) >= tssd.TARGET_BLOCKS
    # the largest tile with a carried state fits with one x buffer and one head
    assert tssd.mma_smem_bytes(128, 128, 128, 1, 1, True) <= tssd.MAX_SMEM


def test_ssd_heads_a_block_at_the_serving_shapes():
    assert tssd.heads_per_block(32, 64, 64, 64, 128, 1) == 8  # 256 blocks, C·Bᵀ once for 8
    assert tssd.heads_per_block(1, 64, 64, 64, 128, 1) == 1   # bucket 1: 64 blocks
    assert not tssd.uses_tensor_cores(torch.float32, 64, 64)
    assert not tssd.uses_tensor_cores(torch.bfloat16, 8, 64)
    assert tssd.uses_tensor_cores(torch.bfloat16, 16, 128)
