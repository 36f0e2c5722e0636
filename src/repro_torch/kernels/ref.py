"""Plain PyTorch versions of every kernel of the port (same signatures as ops.py).

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
    """Plain version of ops.flash_attention (full-matrix GQA attention):
    q (B, Sq, Hq, D) over k, v (B, Sk, Hkv, D), the causal mask top-left
    aligned (key <= query position), as the TPU kernel masks."""
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


def _split_bf16(w: torch.Tensor):
    """f32 ``w`` as bf16 hi = bf16(w) and lo = bf16(w - hi), both returned
    in f32: the two operands the tensor-core kernels multiply for one f32
    factor (hi + lo keeps w to ~2^-16 of itself)."""
    hi = w.to(torch.bfloat16).float()
    return hi, (w - hi).to(torch.bfloat16).float()


def mlstm_attention(q, k, v, log_i, log_f, *, chunk: int = 10**9):
    """Plain version of ops.mlstm_attention (the model's parallel mLSTM)."""
    from repro_torch.models.xlstm import _mlstm_parallel  # the model imports ops

    return _mlstm_parallel(q, k, v, log_i, log_f, chunk=chunk)


def mlstm_attention_sliced(q, k, v, log_i, log_f, *, slice_cols: int):
    """The bf16 tensor-core mLSTM kernel's arithmetic, in plain PyTorch
    (tests and ``chip_smoke.py`` only; the CPU path runs
    :func:`mlstm_attention`).

    The scores are the sum, in slice order, of partial q·kᵀ products over
    D-slices of ``min(D, slice_cols)`` columns (bf16 products, f32 sums;
    the kernel's slice is ``mlstm_attention.SLICE``);
    the stabiliser m is exact from the gates; w = score / √D · exp(b − m)
    over j ≤ i, its f32 row sums are the denominator, and w goes into w·v
    as bf16 hi + lo. Returns y in q's dtype.
    """
    b, s, h, d = q.shape
    ds = min(d, slice_cols)
    fcum = torch.cumsum(log_f.float(), dim=1)  # (B,S,H)
    bmat = fcum[:, :, None, :] - fcum[:, None, :, :] + log_i.float()[:, None, :, :]
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    mask = causal[None, :, :, None]  # (1, i, j, 1)
    bmat = torch.where(mask, bmat, NEG_INF)
    m = torch.amax(bmat, dim=2)  # (B,S,H)
    scores = torch.zeros((b, s, s, h), dtype=torch.float32, device=q.device)
    for d0 in range(0, d, ds):
        scores = scores + torch.einsum("bihd,bjhd->bijh", q[..., d0:d0 + ds].float(),
                                       k[..., d0:d0 + ds].float())
    w = torch.where(mask, scores * (1.0 / math.sqrt(d)) * torch.exp(bmat - m[:, :, None, :]),
                    0.0)
    den = w.sum(dim=2)
    hi, lo = _split_bf16(w)
    vf = v.float()
    num = torch.einsum("bijh,bjhd->bihd", hi, vf) + torch.einsum("bijh,bjhd->bihd", lo, vf)
    y = num / torch.maximum(den.abs(), torch.exp(-m))[..., None]
    return y.to(q.dtype)


def by_group(scan, x, dt, a, b, c, **kw):
    """``scan`` (a function of B and C shared by every head) on each group's
    heads with that group's B and C, (B, S, G, N), joined along the heads:
    head h reads group h // (H / G). A state ``h0`` (B, H, P, N) is split
    the same way; a returned (y, h) is joined as y (dim 2) and h (dim 1)."""
    groups, h0 = b.shape[2], kw.pop("h0", None)
    per = x.shape[2] // groups
    outs = []
    for g in range(groups):
        heads = slice(g * per, (g + 1) * per)
        if h0 is not None:
            kw["h0"] = h0[:, heads]
        outs.append(scan(x[:, :, heads], dt[:, :, heads], a[heads], b[:, :, g], c[:, :, g],
                         **kw))
    if isinstance(outs[0], tuple):
        return torch.cat([o[0] for o in outs], dim=2), torch.cat([o[1] for o in outs], dim=1)
    return torch.cat(outs, dim=2)


def ssd_scan(x, dt, a, b, c, *, chunk: int = 128):
    """Plain version of ops.ssd_scan (the model's chunked SSD, y only)."""
    from repro_torch.models.ssm import ssd_chunked  # the model imports ops

    y, _ = ssd_chunked(x, dt, a, b, c, chunk=chunk)
    return y


def ssd_scan_grouped(x, dt, a, b, c, *, chunk: int = 128):
    """The bf16 tensor-core SSD kernel's arithmetic, in plain PyTorch
    (tests and ``chip_smoke.py`` only; the CPU path runs :func:`ssd_scan`).

    The kernel's chunk ``min(chunk, max(S, 8))``; C·Bᵀ once per (batch row,
    chunk), shared by the heads (bf16 products, f32 sums); per head the
    weight w = C·Bᵀ ∘ exp(cum_q − cum_k) ∘ dt_k over k ≤ q, into w·x as bf16
    hi + lo; the carried state only where it is read: exp(cum_q)·C·hᵀ from
    the second chunk on, with h as hi + lo, and the update
    h·exp(total) + xᵀ(B ∘ exp(total − cum) ∘ dt), its right factor as
    hi + lo, before every chunk but the last. B and C shared (B, S, N), or
    per group (B, S, G, N): C·Bᵀ then once per group. Returns y in x's
    dtype.
    """
    if b.dim() == 4:
        return by_group(ssd_scan_grouped, x, dt, a, b, c, chunk=chunk)
    bs, s, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, max(s, 8))
    nc = -(-s // q)
    pad = nc * q - s
    f32 = torch.float32
    xf = F.pad(x.to(f32), (0, 0, 0, 0, 0, pad)).reshape(bs, nc, q, h, p)
    dtf = F.pad(dt.to(f32), (0, 0, 0, pad)).reshape(bs, nc, q, h)
    bf = F.pad(b.to(f32), (0, 0, 0, pad)).reshape(bs, nc, q, n)
    cf = F.pad(c.to(f32), (0, 0, 0, pad)).reshape(bs, nc, q, n)
    cum = torch.cumsum(dtf * a.to(f32), dim=2)  # (B, nc, Q, H)
    cbt = torch.einsum("bzqn,bzkn->bzqk", cf, bf)  # once for every head
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    mask = causal[None, None, :, :, None]  # (1, 1, q, k, 1)
    seg = torch.where(mask, cum[:, :, :, None, :] - cum[:, :, None, :, :], 0.0)
    w = torch.where(mask, cbt[..., None] * torch.exp(seg) * dtf[:, :, None, :, :], 0.0)
    hi, lo = _split_bf16(w)  # (B, nc, q, k, H)
    y = (torch.einsum("bzqkh,bzkhp->bzqhp", hi, xf)
         + torch.einsum("bzqkh,bzkhp->bzqhp", lo, xf))
    state = None
    ys = []
    for z in range(nc):
        yz = y[:, z]
        if z > 0:  # the state entering chunk z
            s_hi, s_lo = _split_bf16(state)  # (B, H, P, N)
            off = (torch.einsum("bqn,bhpn->bqhp", cf[:, z], s_hi)
                   + torch.einsum("bqn,bhpn->bqhp", cf[:, z], s_lo))
            yz = yz + torch.exp(cum[:, z])[..., None] * off
        ys.append(yz)
        if z < nc - 1:
            total = cum[:, z, -1]  # (B, H)
            scale = torch.exp(total[:, None, :] - cum[:, z]) * dtf[:, z]  # (B, Q, H)
            r_hi, r_lo = _split_bf16(bf[:, z][:, :, None, :] * scale[..., None])  # (B,Q,H,N)
            upd = (torch.einsum("bqhp,bqhn->bhpn", xf[:, z], r_hi)
                   + torch.einsum("bqhp,bqhn->bhpn", xf[:, z], r_lo))
            state = upd if z == 0 else state * torch.exp(total)[..., None, None] + upd
    out = torch.stack(ys, dim=1).reshape(bs, nc * q, h, p)[:, :s]
    return out.to(x.dtype)


def ssd_scan_sequential(x, dt, a, b, c):
    """Slow sequential oracle (the exact per-step recurrence)."""
    from repro_torch.models.ssm import ssd_reference

    y, _ = ssd_reference(x, dt, a, b, c)
    return y


def mamba2_step(zxbcdt, conv_w, conv_b, dt_bias, a_log, d_skip, norm_scale, h, conv, *,
                groups: int = 1, eps: float = 1e-6):
    """Plain version of ops.mamba2_step (the model's mixer, one decode step)."""
    from repro_torch.models.ssm import mamba2_mix  # the model imports ops

    p = {"conv": conv_w, "conv_bias": conv_b, "dt_bias": dt_bias, "a_log": a_log,
         "d_skip": d_skip, "norm_scale": norm_scale}
    return mamba2_mix(p, zxbcdt, d_state=h.shape[-1], head_dim=h.shape[-2],
                      state={"h": h, "conv": conv}, step=True, groups=groups, norm_eps=eps)
