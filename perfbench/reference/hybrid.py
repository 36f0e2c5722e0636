"""The plain reference of the port's hybrid family in Zamba2's published
layout (Zamba2-7B-Instruct), written from ``transformers``'
``models/zamba2/modeling_zamba2.py`` and the port's parameter layout
(``(in, out)`` matrices; the Mamba layers stacked on a leading layer axis,
the shared blocks on a block axis, each application's own weights on an
application axis).

Float32 throughout, with no kernel, cache or batching: the whole sequence
at once, layer by layer, each layer's weights (and each application's
block) upcast to float32 only while it runs. It imports nothing of the
program.

Per layer i, with residual x and token embedding e:

* if i is the j-th of ``hybrid_layer_ids``, block b = j mod
  ``num_mem_blocks`` runs on h = RMSNorm(concat(x, e)) (2·d wide):
  a = Wo · attn(RoPE(Wq h), RoPE(Wk h), Wv h) (causal, scores scaled by
  1 / sqrt(head_dim / 2), RoPE over the whole head, rotate-half), then
  g = RMSNorm(a); u = g Wi + (g A_j) B_j (application j's LoRA);
  m = (GELU_erf(u_gate) * u_up) W2; t = m L_j (application j's ``linear``);
* x = x + Mamba(RMSNorm(x + t)) (t = 0 elsewhere), where Mamba is
  in_proj → [z | x B C | dt]; a depthwise causal conv of width 4 with bias
  and SiLU over [x B C]; dt = softplus(dt + dt_bias); A = -exp(a_log);
  the SSD scan per head, head h reading B and C of group h // (H / G),
  from a zero state, in chunks of 64 with an exact inter-chunk recurrence;
  y += D · x; y = RMSNorm_group(y · SiLU(z)) per group of d_inner / G
  channels; out_proj.

Then RMSNorm and the head (the embedding's transpose where tied). Every
RMSNorm takes ``norm_eps``.

Departures from ``modeling_zamba2.py``:

* ``torch_forward`` clamps dt below at ``time_step_min`` (1e-3); the
  kernel path the model is published with (``mamba_chunk_scan_combined``,
  ``time_step_limit`` None) does not, and neither does this reference;
* its norms round to the input dtype before the weight product and its
  attention runs in the model dtype; here everything is float32;
* the SSD runs in chunks of 64 (the config's ``chunk_size`` is 256):
  chunking tiles an exact scan, so only rounding differs;
* no attention mask or padding: every row is a whole sequence.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F

Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
CHUNK = 64


def _plain_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


# ---------------------------------------------------------------- weights
def _normal(scale: float, shift: float = 0.0):
    def fill(t: torch.Tensor, gen: torch.Generator) -> None:
        t.normal_(shift, scale, generator=gen)
    return fill


def _fan_in(t: torch.Tensor, gen: torch.Generator) -> None:
    t.normal_(0.0, 1.0 / math.sqrt(t.shape[-2]), generator=gen)


def _a_log(t: torch.Tensor, gen: torch.Generator) -> None:
    """log A, A uniform in [1, 16]: decays of exp(-dt A) a step."""
    t.uniform_(1.0, 16.0, generator=gen).log_()


def _dt_bias(t: torch.Tensor, gen: torch.Generator) -> None:
    """softplus⁻¹ of dt log-uniform in [1e-3, 1e-1] (Zamba2's init range):
    with A in [1, 16] a head keeps its state for 1 to 1,000 steps, so over
    320 positions it neither vanishes at once nor stays unchanged."""
    t.uniform_(math.log(1e-3), math.log(1e-1), generator=gen).exp_()
    t.add_(torch.log(-torch.expm1(-t)))


#: leaf name -> fill(tensor, generator), beside the harness's ``RULES``
WEIGHTS = {
    "in_proj": _fan_in, "out_proj": _fan_in, "conv": _normal(0.25),
    "conv_bias": _normal(0.1), "a_log": _a_log, "dt_bias": _dt_bias,
    "d_skip": _normal(0.1, 1.0), "norm_scale": _normal(0.1, 1.0),
    "adapter_in": _fan_in, "adapter_out": _fan_in, "linear": _fan_in,
}


# ------------------------------------------------------------------ pieces
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale.float()


def rope_tables(head_dim: int, length: int, theta: float, device):
    inv = 1.0 / theta ** (torch.arange(0, head_dim, 2, device=device,
                                       dtype=torch.float64) / head_dim)
    ang = torch.arange(length, device=device, dtype=torch.float64)[:, None] * inv[None, :]
    return torch.cos(ang).float(), torch.sin(ang).float()


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D): rotate-half, as ``apply_rotary_pos_emb``."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Causal grouped-query attention. q (B, S, Hq, D); k, v (B, S, Hkv, D)."""
    s = q.shape[1]
    g = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
        c: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """The SSD scan from a zero state: h_t = exp(dt_t a) h_{t-1} + dt_t x_t ⊗ B_t,
    y_t = C_t · h_t, by chunks (quadratic within a chunk, the state carried
    between chunks). x (B, S, H, P); dt (B, S, H); a (H,); b, c (B, S, G, N)."""
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    b = b.repeat_interleave(h // g, dim=2)  # (B, S, H, N)
    c = c.repeat_interleave(h // g, dim=2)
    state = x.new_zeros((bs, h, p, n))
    out = []
    for t0 in range(0, s, chunk):
        xc, dtc, bc, cc = (t[:, t0:t0 + chunk] for t in (x, dt, b, c))
        q = xc.shape[1]
        cum = torch.cumsum(dtc * a, dim=1)  # (B, Q, H)
        diff = cum[:, :, None, :] - cum[:, None, :, :]  # (B, Q, K, H)
        causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()[None, :, :, None]
        decay = torch.where(causal, torch.exp(torch.where(causal, diff, 0.0)), 0.0)
        w = torch.einsum("bqhn,bkhn->bqkh", cc, bc) * decay * dtc[:, None, :, :]
        y = torch.einsum("bqkh,bkhp->bqhp", w, xc)
        y = y + torch.einsum("bqhn,bhpn->bqhp", cc, state) * torch.exp(cum)[..., None]
        out.append(y)
        to_end = torch.exp(cum[:, -1:, :] - cum) * dtc  # (B, Q, H)
        state = (state * torch.exp(cum[:, -1])[:, :, None, None]
                 + torch.einsum("bkhp,bkhn->bhpn", xc * to_end[..., None], bc))
    return torch.cat(out, dim=1)


def mamba(model: Dict, p: Dict[str, torch.Tensor], x: torch.Tensor, mm: Matmul) -> torch.Tensor:
    """One Mamba-2 mixer on its normed input x (B, S, D)."""
    bs, s, d = x.shape
    d_inner = 2 * d
    g, n = model.get("ssm_groups", 1), model["ssm_state"]
    heads = d_inner // model["ssm_head_dim"]
    zxbcdt = mm(x, p["in_proj"].float())
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:2 * d_inner + 2 * g * n]
    dt = zxbcdt[..., 2 * d_inner + 2 * g * n:]
    w = p["conv"].float()  # (W, C): tap i reads position t - (W - 1) + i
    width = w.shape[0]
    padded = F.pad(xbc, (0, 0, width - 1, 0))
    xbc = sum(padded[:, i:i + s] * w[i] for i in range(width)) + p["conv_bias"].float()
    xbc = F.silu(xbc)
    xs = xbc[..., :d_inner].reshape(bs, s, heads, -1)
    bm = xbc[..., d_inner:d_inner + g * n].reshape(bs, s, g, n)
    cm = xbc[..., d_inner + g * n:].reshape(bs, s, g, n)
    dt = F.softplus(dt + p["dt_bias"].float())
    y = ssd(xs, dt, -torch.exp(p["a_log"].float()), bm, cm)
    y = y + xs * p["d_skip"].float()[:, None]
    y = (y.reshape(bs, s, d_inner) * F.silu(z)).reshape(bs, s, g, d_inner // g)
    y = (y * torch.rsqrt((y * y).mean(-1, keepdim=True) + model["norm_eps"])).reshape(
        bs, s, d_inner) * p["norm_scale"].float()
    return mm(y, p["out_proj"].float())


def shared_block(model: Dict, blk: Dict, app: Dict, x: torch.Tensor, emb: torch.Tensor,
                 cos, sin, mm: Matmul) -> torch.Tensor:
    """What application ``app`` of block ``blk`` adds to its Mamba layer's
    input (B, S, D)."""
    bs, s, _ = x.shape
    eps = model["norm_eps"]
    hq, hkv, hd = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    h = rmsnorm(torch.cat([x, emb], dim=-1), blk["attn_norm"]["scale"], eps)
    att = blk["attn"]
    q = rope(mm(h, att["wq"].float()).view(bs, s, hq, hd), cos, sin)
    k = rope(mm(h, att["wk"].float()).view(bs, s, hkv, hd), cos, sin)
    v = mm(h, att["wv"].float()).view(bs, s, hkv, hd)
    o = attention(q, k, v, 1.0 / math.sqrt(hd / 2)).reshape(bs, s, hq * hd)
    h = rmsnorm(mm(o, att["wo"].float()), blk["mlp_norm"]["scale"], eps)
    u = mm(h, blk["mlp"]["wi"].float()) + mm(mm(h, app["adapter_in"].float()),
                                             app["adapter_out"].float())
    gate, up = u.chunk(2, dim=-1)
    m = mm(F.gelu(gate) * up, blk["mlp"]["wo"].float())
    return mm(m, app["linear"].float())


def pick(tree, i: int):
    """Entry ``i`` of every leaf's leading axis."""
    return {k: pick(v, i) for k, v in tree.items()} if isinstance(tree, dict) else tree[i]


def logits(model: Dict, params: Dict, tokens: torch.Tensor, first: int,
           mm: Matmul = _plain_mm) -> torch.Tensor:
    """Float32 logits (B, S - first, V) at positions ``first..S-1`` of
    ``tokens`` (B, S); ``mm`` is every weight product (the control passes
    a lower-precision one). Float32 products run in float32, not TF32."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits(model, params, tokens, first, mm)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def _logits(model: Dict, params: Dict, tokens: torch.Tensor, first: int,
            mm: Matmul) -> torch.Tensor:
    ids = list(model.get("hybrid_layer_ids") or ())
    if not ids:
        raise ValueError("the reference is of the published layout: hybrid_layer_ids")
    s = tokens.shape[1]
    emb = params["embed"][tokens].float()
    x = emb
    cos, sin = rope_tables(model["head_dim"], s, float(model["rope_theta"]), tokens.device)
    eps = model["norm_eps"]
    for i in range(model["num_layers"]):
        layer = pick(params["layers"], i)
        t = 0.0
        if i in ids:
            j = ids.index(i)
            blk = pick(params["shared"], j % model["num_mem_blocks"])
            t = shared_block(model, blk, pick(params["apps"], j), x, emb, cos, sin, mm)
        x = x + mamba(model, layer["mamba"], rmsnorm(x + t, layer["norm"]["scale"], eps), mm)
    x = rmsnorm(x[:, first:], params["final_norm"]["scale"], eps)
    head = params["lm_head"] if "lm_head" in params else params["embed"].T
    return mm(x, head.float())
