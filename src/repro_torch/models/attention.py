"""Attention: GQA with RoPE, chunked prefill, cached decode — plain PyTorch.

These are the plain versions behind the hand-written kernels
(``repro_torch.kernels``): on the CPU the kernel wrappers run them, and on
the card ``chip_smoke.py`` holds each kernel against them. Shapes and
numerics follow the JAX package's ``models/attention.py``: scores and
softmax in f32, masked scores set to -1e30 (not -inf).
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.models.layers import dense_init

NEG_INF = -1e30


# ----------------------------------------------------------------- parameters
def init_attention(gen: torch.Generator, d_model: int, num_heads: int,
                   num_kv_heads: int, head_dim: int, dtype,
                   qkv_bias: bool = False, lead: Sequence[int] = ()) -> dict:
    p = {
        "wq": dense_init(gen, d_model, num_heads * head_dim, dtype, lead=lead),
        "wk": dense_init(gen, d_model, num_kv_heads * head_dim, dtype, lead=lead),
        "wv": dense_init(gen, d_model, num_kv_heads * head_dim, dtype, lead=lead),
        "wo": dense_init(gen, num_heads * head_dim, d_model, dtype,
                         scale=1.0 / math.sqrt(num_heads * head_dim), lead=lead),
    }
    if qkv_bias:
        dev = gen.device
        p["bq"] = torch.zeros((*lead, num_heads * head_dim), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((*lead, num_kv_heads * head_dim), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((*lead, num_kv_heads * head_dim), dtype=dtype, device=dev)
    return p


def qkv_proj(p: dict, x: torch.Tensor, num_heads: int, num_kv_heads: int,
             head_dim: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (
        q.reshape(b, s, num_heads, head_dim),
        k.reshape(b, s, num_kv_heads, head_dim),
        v.reshape(b, s, num_kv_heads, head_dim),
    )


# ------------------------------------------------------------- full attention
def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B, Sq, Hq, D), k: (B, Sk, Hkv, D) → (B, Hkv, G, Sq, Sk)."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d)
    return torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Naive full-matrix GQA attention (oracle; used for small shapes)."""
    b, sq, hq, d = q.shape
    sk = k.shape[1]
    scores = _gqa_scores(q, k) / math.sqrt(d)  # (B, Hkv, G, Sq, Sk)
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(sk, device=q.device)[None, :]
        mask = kpos <= qpos  # (Sq, Sk)
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


# ---------------------------------------------------------- chunked (flash)
def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, q_chunk: int = 512,
                      q_offset: int = 0) -> torch.Tensor:
    """Attention over query chunks, one (chunk × Sk) score block at a time.

    Equivalent to :func:`reference_attention` up to float error; the JAX
    package's ``lax.scan`` over chunks becomes a loop.
    """
    b, sq, hq, d = q.shape
    sk = k.shape[1]
    hkv = k.shape[2]
    g = hq // hkv
    if sq <= q_chunk:
        return reference_attention(q, k, v, causal=causal, q_offset=q_offset)
    kf = k.float()
    vf = v.float()
    scale = 1.0 / math.sqrt(d)
    kpos = torch.arange(sk, device=q.device)[None, :]
    outs = []
    for start in range(0, sq, q_chunk):
        qc = q[:, start:start + q_chunk]
        c = qc.shape[1]
        qg = qc.reshape(b, c, hkv, g, d).float()
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale
        if causal:
            qpos = start + torch.arange(c, device=q.device)[:, None] + q_offset
            scores = torch.where(kpos <= qpos, scores, NEG_INF)
        m = scores.amax(dim=-1)
        w = torch.exp(scores - m[..., None])
        l = w.sum(dim=-1)
        o = torch.einsum("bhgqk,bkhd->bhgqd", w, vf)
        o = o / torch.clamp(l, min=1e-30)[..., None]
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(b, c, hq, d))
    return torch.cat(outs, dim=1).to(q.dtype)


# --------------------------------------------------------------------- decode
def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len) -> torch.Tensor:
    """Single-step attention over a (possibly padded) KV cache.

    q: (B, 1, Hq, D); k_cache/v_cache: (B, S_max, Hkv, D);
    cache_len: int or int tensor, scalar or (B,) — number of valid cache
    entries (includes the token being decoded, already written).
    """
    b, _, hq, d = q.shape
    s_max, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d).float()
    scores = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float())
    scores = scores / math.sqrt(d)
    pos = torch.arange(s_max, device=q.device)[None, :]
    lens = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    valid = pos < lens  # (B or 1, S_max)
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", w, v_cache.float())
    return out.reshape(b, 1, hq, d).to(q.dtype)


# ------------------------------------------------------------------ KV cache
def init_kv_cache(num_layers: int, batch: int, max_len: int, num_kv_heads: int,
                  head_dim: int, dtype, device=None) -> Dict[str, torch.Tensor]:
    """Zeroed ``(L, B, S_max, Hkv, D)`` k/v plus a scalar int32 ``len`` —
    all on ``device``, so the length is read and advanced without a host
    sync."""
    shape = (num_layers, batch, max_len, num_kv_heads, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


def clamp_start(start: torch.Tensor, s_max: int, s: int = 1) -> torch.Tensor:
    """``start`` clamped to ``s_max - s`` on the device, as JAX's
    ``dynamic_update_slice`` clamps its start: a write that would run past
    the cache's end lands on its last ``s`` rows instead."""
    return torch.clamp(start, max=s_max - s)


def cache_update_layer(k_cache: torch.Tensor, v_cache: torch.Tensor,
                       k: torch.Tensor, v: torch.Tensor, start):
    """Write (B, S, Hkv, D) at position ``start`` of one layer's cache.

    In place (JAX returns a new cache; here the pooled buffer is updated),
    and ``start`` may be a device tensor: the write is an ``index_copy_``
    on the device, with no host sync. ``start`` must lie in
    ``[0, S_max - S]``: a caller whose start can run past the end clamps
    it first with :func:`clamp_start`, once for all layers. Returns the
    updated caches.
    """
    s = k.shape[1]
    idx = torch.as_tensor(start, device=k_cache.device).reshape(1).long()
    if s > 1:
        idx = idx + torch.arange(s, device=k_cache.device)
    k_cache.index_copy_(1, idx, k.to(k_cache.dtype))
    v_cache.index_copy_(1, idx, v.to(v_cache.dtype))
    return k_cache, v_cache
