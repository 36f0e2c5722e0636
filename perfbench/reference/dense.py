"""The plain reference of the port's dense decoder (StarCoder2-15B's family).

Float32 throughout, written from the architecture's equations and the
port's parameter layout (``(in, out)`` matrices stacked on a leading layer
axis), with no kernel, cache or batching: the whole sequence at once,
layer by layer, each layer's weights upcast to float32 only while it runs.
It imports nothing of the program.

Per layer: x += Wo · attn(RoPE(Wq·n1(x) + bq), RoPE(Wk·n1(x) + bk),
Wv·n1(x) + bv), causal, grouped-query; then x += W2 · act(W1·n2(x) + b1) + b2
(``gelu``: the tanh approximation, ungated; ``silu``: gated, W1 = [gate|up]).
Norms are LayerNorm (biased variance) or RMSNorm, eps 1e-6 as the port
uses. RoPE rotates split halves, theta from the configuration. The head
is ``lm_head``, or the embedding's transpose where the model ties them.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F

Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
EPS = 1e-6


def _plain_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def norm(kind: str, p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    scale = p["scale"].float()
    if kind == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + EPS) * scale + p["bias"].float()
    if kind == "rmsnorm":
        return x / torch.sqrt((x * x).mean(-1, keepdim=True) + EPS) * scale
    raise ValueError(f"unknown norm {kind!r}")


def rope_tables(head_dim: int, length: int, theta: float, device):
    inv = 1.0 / theta ** (torch.arange(0, head_dim, 2, device=device,
                                       dtype=torch.float64) / head_dim)
    ang = torch.arange(length, device=device, dtype=torch.float64)[:, None] * inv[None, :]
    return torch.cos(ang).float(), torch.sin(ang).float()


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D); rotate the halves (x1, x2) by the position's angles."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal grouped-query attention. q (B, S, Hq, D); k, v (B, S, Hkv, D)."""
    b, s, hq, d = q.shape
    g = hq // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)


def ffn(model: Dict, p: Dict[str, torch.Tensor], x: torch.Tensor, mm: Matmul) -> torch.Tensor:
    h = mm(x, p["wi"].float())
    if "bi" in p:
        h = h + p["bi"].float()
    if model["activation"] == "silu":
        gate, up = h.chunk(2, dim=-1)
        h = F.silu(gate) * up
    elif model["activation"] == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(f"unknown activation {model['activation']!r}")
    out = mm(h, p["wo"].float())
    return out + p["bo"].float() if "bo" in p else out


def attention_block(model: Dict, p: Dict[str, torch.Tensor], h: torch.Tensor, cos, sin,
                    mm: Matmul) -> torch.Tensor:
    """W_o · attention of the normed input ``h``: (B, S, D) -> (B, S, D)."""
    b, s, _ = h.shape
    hq, hkv = model["num_heads"], model["num_kv_heads"]
    hd = model.get("head_dim") or model["d_model"] // hq
    q, k, v = (mm(h, p[w].float()) for w in ("wq", "wk", "wv"))
    if "bq" in p:
        q, k, v = q + p["bq"].float(), k + p["bk"].float(), v + p["bv"].float()
    q = rope(q.view(b, s, hq, hd), cos, sin)
    k = rope(k.view(b, s, hkv, hd), cos, sin)
    out = attention(q, k, v.view(b, s, hkv, hd))
    return mm(out.reshape(b, s, hq * hd), p["wo"].float())


def layer(params: Dict, i: int):
    """Layer ``i``'s view of the stacked weights."""
    def pick(tree):
        return {k: pick(v) for k, v in tree.items()} if isinstance(tree, dict) else tree[i]
    return pick(params["layers"])


def logits(model: Dict, params: Dict, tokens: torch.Tensor, first: int,
           mm: Matmul = _plain_mm) -> torch.Tensor:
    """Float32 logits (B, S - first, V) at positions ``first..S-1`` of
    ``tokens`` (B, S); ``mm`` is every weight product (the control passes
    a lower-precision one)."""
    b, s = tokens.shape
    x = params["embed"][tokens].float()
    hd = model.get("head_dim") or model["d_model"] // model["num_heads"]
    cos, sin = rope_tables(hd, s, float(model["rope_theta"]), tokens.device)
    kind = model["norm"]
    for i in range(model["num_layers"]):
        p = layer(params, i)
        x = x + attention_block(model, p["attn"], norm(kind, p["attn_norm"], x), cos, sin, mm)
        x = x + ffn(model, p["mlp"], norm(kind, p["mlp_norm"], x), mm)
    x = norm(kind, params["final_norm"], x[:, first:])
    head = params["lm_head"] if "lm_head" in params else params["embed"].T
    return mm(x, head.float())
