"""Plain PyTorch versions of every ported kernel (same signatures as ops.py).

They reuse the model library's code, as the JAX package's
``kernels/ref.py`` re-exports its own: the CPU path and the oracle the
kernels are held to on the card are the same audited functions.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.attention import (
    NEG_INF,
    decode_attention as _decode_ref,
    reference_attention as _naive,
)


def flash_attention(q, k, v, *, causal: bool = True):
    """Plain version of ops.flash_attention (full-matrix GQA attention)."""
    return _naive(q, k, v, causal=causal)


def decode_attention(q, k_cache, v_cache, cache_len):
    """Plain version of ops.decode_attention."""
    return _decode_ref(q, k_cache, v_cache, cache_len)


def decode_attention_split(q, k_cache, v_cache, cache_len, split_len: int):
    """The decode kernel's split-and-merge arithmetic, in plain PyTorch
    (tests and ``chip_smoke.py`` only; the CPU path runs
    :func:`decode_attention`).

    The cache rows go in splits of ``split_len``; each split keeps its own
    f32 max m (-1e30 where no row of it is valid), sum l and unnormalised
    accumulator over its valid rows; the splits are merged by rescaling
    with exp(m_i - m), summing and dividing by the sum clamped at 1e-30.
    """
    b, _, hq, d = q.shape
    s_max, hkv = k_cache.shape[1], k_cache.shape[2]
    n = -(-s_max // split_len)
    pad = (0, 0, 0, 0, 0, n * split_len - s_max)
    kf = F.pad(k_cache.float(), pad).reshape(b, n, split_len, hkv, d)
    vf = F.pad(v_cache.float(), pad).reshape(b, n, split_len, hkv, d)
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    s = torch.einsum("bhgd,bnkhd->bnhgk", qg, kf) / math.sqrt(d)
    pos = torch.arange(n * split_len, device=q.device).reshape(n, split_len)
    lens = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1, 1).clamp(0, s_max)
    valid = (pos < lens)[:, :, None, None, :]  # (B or 1, n, 1, 1, split_len)
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1)  # (B, n, Hkv, G)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    acc = torch.einsum("bnhgk,bnkhd->bnhgd", p, vf)
    w = torch.exp(m - m.amax(dim=1, keepdim=True))
    l = (p.sum(dim=-1) * w).sum(dim=1)
    out = (acc * w[..., None]).sum(dim=1) / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, 1, hq, d).to(q.dtype)


def mlstm_attention(q, k, v, log_i, log_f, *, chunk: int = 10**9):
    """Plain version of ops.mlstm_attention (the model's parallel mLSTM)."""
    from repro_torch.models.xlstm import _mlstm_parallel  # the model imports ops

    return _mlstm_parallel(q, k, v, log_i, log_f, chunk=chunk)


def ssd_scan(x, dt, a, b, c, *, chunk: int = 128):
    """Plain version of ops.ssd_scan (the model's chunked SSD, y only)."""
    from repro_torch.models.ssm import ssd_chunked  # the model imports ops

    y, _ = ssd_chunked(x, dt, a, b, c, chunk=chunk)
    return y


def ssd_scan_sequential(x, dt, a, b, c):
    """Slow sequential oracle (the exact per-step recurrence)."""
    from repro_torch.models.ssm import ssd_reference

    y, _ = ssd_reference(x, dt, a, b, c)
    return y
